"""dmlcloud_tpu_torch.serve — continuous-batching inference.

Counterpart of ``dmlcloud_tpu.serve`` but its ``Router``:

- :class:`KVBlockPool` (kv_pool.py): the paged KV cache — fixed device pages,
  per-sequence block tables, a host free list with reference counts.
- :class:`Scheduler` / :class:`Request` (scheduler.py): FIFO (or per-tenant
  deficit round-robin) continuous-batching admission with chunked prefill,
  bounded queues with shedding, deadlines and one terminal status per request.
- :class:`ServeEngine` (engine.py): the loop — admit, one prefill chunk, one
  decode batch per step — with per-request sampling and three decode modes
  (plain, speculative with a draft model and its own pool, Medusa heads);
  greedy output is token-identical to serial ``models.generate.generate``.
  Graceful drain writes the ``requeue.json`` verdict.
- :class:`PrefixCache` (prefix_cache.py): radix-tree prefix sharing over
  content-addressed, refcounted pool blocks, with copy-on-write forks and
  leaf-first LRU eviction (``prefix_cache=True``); ``prefix_keys`` gives the
  reference's content addresses.
- :class:`AdapterSet` (adapters.py): multi-tenant LoRA serving, one base model
  and per-request adapter deltas inside the decode step.
- :class:`ServeLedger` (ledger.py): TTFT, queue wait, tokens/s, goodput,
  accept rates and prefix-cache observables, with bounded retention.
- :class:`SLO` / :class:`SLOMonitor` (slo.py): declarative objectives with
  multi-window burn-rate alerts; :class:`MetricsServer` (metrics_http.py): a
  stdlib ``/metrics`` endpoint for ``ServeEngine.metrics_text``.
- :class:`ChaosMonkey` (chaos.py): seeded fault injection (step faults, pool
  squats, clock stalls, random cancels) replaying the reference's schedule.

The reference's ``Router`` (and the chaos monkey's replica events) is not
ported yet (ROADMAP Queue 1 item 10).
"""

from .adapters import AdapterSet
from .chaos import ChaosError, ChaosMonkey
from .engine import DuplicateRequest, ServeEngine
from .kv_pool import KVBlockPool, PoolExhausted
from .ledger import ServeLedger
from .metrics_http import MetricsServer
from .prefix_cache import PrefixCache, PrefixMatch, prefix_keys
from .scheduler import TERMINAL_STATUSES, Request, Scheduler
from .slo import SLO, SLOMonitor

__all__ = [
    "AdapterSet",
    "ChaosError",
    "ChaosMonkey",
    "DuplicateRequest",
    "KVBlockPool",
    "MetricsServer",
    "PoolExhausted",
    "PrefixCache",
    "PrefixMatch",
    "Request",
    "SLO",
    "SLOMonitor",
    "Scheduler",
    "ServeEngine",
    "ServeLedger",
    "TERMINAL_STATUSES",
    "prefix_keys",
]
