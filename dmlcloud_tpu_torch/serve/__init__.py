"""dmlcloud_tpu_torch.serve — continuous-batching inference.

Counterpart of the core of ``dmlcloud_tpu.serve``:

- :class:`KVBlockPool` (kv_pool.py): the paged KV cache — fixed device pages,
  per-sequence block tables, a host free list with reference counts.
- :class:`Scheduler` / :class:`Request` (scheduler.py): FIFO (or per-tenant
  deficit round-robin) continuous-batching admission with chunked prefill,
  bounded queues with shedding, deadlines and one terminal status per request.
- :class:`ServeEngine` (engine.py): the loop — admit, one prefill chunk, one
  decode batch per step — with per-request sampling; greedy output is
  token-identical to serial ``models.generate.generate``.

The reference's speculative and Medusa modes, ``PrefixCache``, adapters,
chaos, ``Router``, SLOs, the ledger and the metrics endpoint are not ported
yet (ROADMAP Queue 1 item 10).
"""

from .engine import DuplicateRequest, ServeEngine
from .kv_pool import KVBlockPool, PoolExhausted
from .scheduler import TERMINAL_STATUSES, Request, Scheduler

__all__ = [
    "DuplicateRequest",
    "KVBlockPool",
    "PoolExhausted",
    "Request",
    "Scheduler",
    "ServeEngine",
    "TERMINAL_STATUSES",
]
