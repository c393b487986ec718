"""The continuous-batching serving engine over the paged KV pool.

Counterpart of ``dmlcloud_tpu/serve/engine.py``: ``ServeEngine`` (:335) with
every decode mode, the prefix cache, adapters, the ledger, metrics, SLOs,
request traces, drain and the chaos hook points, and the device steps
``_copy_block`` (:158), ``_paged_step`` (:168), ``_spec_draft_step`` (:189),
``_spec_verify_step`` (:228) and ``_medusa_step`` (:260). One engine owns the
device page pool (``kv_pool``), the scheduler (``scheduler``) and the ledger
(``ledger``) and runs the serving loop

    admit waiting requests -> one prefill chunk -> one decode batch

per :meth:`ServeEngine.step`. The decode batch advances every running stream
however much prefill is pending; a stream that emits EOS frees its slot and
blocks before the next step and the next waiting request takes them:
continuous batching, no drain barrier. The decode math is
``models.generate.decode_step`` with ``pages=(tables, fill)`` steering it
through the pool, so greedy output is token-identical to serial ``generate``.

**Three decode modes share that loop.**

- *Plain* (``spec_k == medusa_k == 0``): each decode batch advances every row
  by one token.
- *Speculative* (``spec_k >= 1``): a draft model (the target itself unless
  ``draft_model`` names one) proposes ``k`` tokens per round against its own
  page pool. The round's first draft pass feeds the last two committed tokens
  at ``fill-1``/``fill`` (the 2-token trick of ``models/speculative.py``:
  after a fully accepted round it closes the draft pool's one-slot gap), then
  ``k-1`` one-token passes; one ``k+1``-position verify pass through the block
  tables scores them, and the batched ``models.speculative.verify_proposals``
  runs each row's accept rule. A partial accept rewinds by advancing the fill
  counters only to the accepted position: the next round's contiguous writes
  overwrite the stale tail before the causal mask can expose it.
- *Medusa* (``medusa_k >= 1``): ``k-1`` decode heads
  (``models.speculative.init_medusa_heads``) read the final hidden state of
  the round's one forward (``return_hidden=True``) at the accepted position
  and propose the next round's tokens, so a round is one ``k``-position target
  pass and there is no draft model or pool. The proposals are the heads'
  argmax picks, so the draft distributions are one-hot, and the verify rule is
  spec mode's. ``k == 1`` degenerates to a plain one-token step.

In both speculative modes the round's committed tokens, its ``n_new``/
``n_accept`` counters (and Medusa's next proposals) come to the host in ONE
copy per round, for the whole batch.

**Prefix sharing** (``prefix_cache=True``, ``serve/prefix_cache.py``):
admission maps a prompt's longest cached full-block prefix read-only into the
request's table and starts chunked prefill at the divergence point. Every
write path (prefill, decode, spec, Medusa) runs :meth:`ServeEngine._cow_guard`
first, which forks any shared block the write would touch: ``_copy_block``
copies the page in place, in every layer's K and V, before the table entry is
swapped and the old reference released. Finished prompts (and the decoded full
blocks) enter the tree.

**Adapters** (``adapters=AdapterSet``): requests pick a LoRA tenant by name
(``submit(adapter=)``); each row's delta rides every model call
(``decode_step(adapters=)``), and the prefix tree's root is keyed by the
adapter id. Under spec decoding the draft proposes with the base model and
the verify pass scores with each row's adapter; Medusa's heads read the
adapted hidden state.

**Per-request sampling.** ``temperature``/``top_k``/``top_p``/``eos_id`` ride
each request and enter the step as ``[B]`` tensors, so one batch may mix
greedy and sampled rows; a batch with no sampled row takes the argmax alone.
Draws come from the engine's ``torch.Generator``: sampled tokens are
distributed as the reference's but are not the same tokens. Greedy tokens,
and the drafted/accepted counts of greedy rows, are the reference's.

**Failure semantics.** Every request ends in exactly one terminal status
(``ok | cancelled | deadline_exceeded | shed | error``) through one exit path
(``Scheduler.terminate``, which releases both pools, the COW spare and the
prefix locks at any phase). A step that raises fails only the requests it was
advancing; a failed draft step (or Medusa round) degrades that round to a
plain decode step instead. ``fault_injector`` (``serve/chaos.py``) is called
at ``step`` and just before each device call (``prefill``/``decode``/
``draft``/``verify``), where raising injects a fault before anything is
written. Overload control bounds the queue (``max_waiting``,
``shed_policy``) and ``fairness="tenant"`` admits by deficit round-robin.
Graceful drain (:meth:`ServeEngine.drain`, or a tripped ``PreemptionGuard``,
or a ``HangWatchdog.serve_guard`` dump) stops admission, sheds the queue, lets
in-flight work finish inside ``drain_budget_s`` and writes the
``requeue.json`` verdict through ``checkpoint.write_requeue_verdict`` when
``run_dir`` (any fsspec URL) is set.

**Observability.** ``ledger`` (``ServeLedger``) records every request's
timeline; ``metrics=`` builds the reference's ``dml_serve_*`` series on a
``MetricsRegistry`` (:meth:`ServeEngine.metrics_text`); ``slos=`` judges
``SLO`` objectives each step; with a journal armed, request-scoped spans carry
the request's ``trace`` id and batch spans a ``traces`` list
(``telemetry.journal.linked_trace_report``).

Where the port differs from the reference:

- The model holds its weights, so the engine takes no ``params`` and no
  ``draft_params`` (a draft is a model): passing either is a ``TypeError``.
- Every timestamp comes from the engine's ``clock``; the reference reads
  ``time.perf_counter`` at the commit of a spec or Medusa round.
- ``batch_buckets``/``table_buckets`` pad shapes for XLA's compile cache in
  the reference; the port has no compile cache, so for a dense model they pad
  nothing but the draft's prefill. An MoE model is padded as the reference
  pads it (its routing sees padded rows): each prefill chunk runs at
  ``prefill_chunk`` tokens and each decode batch or round at its power-of-two
  bucket (``batch_buckets``), the padded rows token 0 with no blocks. The
  draft pool's prefill mirror always runs the reference's padded chunk
  (``prefill_chunk`` tokens, the table at its ``table_buckets`` width), so the
  draft pool holds the reference's pages, pad writes included: after a prefix
  hit the draft reads its skipped pages as the pool holds them, and its
  proposals (the accepted counts) follow from those pages.
- Pages are written in place; the reference donates and swaps pools.
- A plain decode step (a degraded spec round) keeps ``prev_token``, so the
  next round's 2-token rewrite writes the degraded token's draft slot with
  that token; the reference leaves ``prev_token`` two tokens back there, which
  writes a wrong draft K/V and costs accept rate (tokens are unchanged).
- ``prepare_decode_params`` runs once at construction, so an int8 model serves
  with its kernels int8.

Not ported yet, each raising ``NotImplementedError`` when given: ``verify``
and ``hbm_budget`` (the construction-time IR verify, ROADMAP Queue 1 item 13).
"""

from __future__ import annotations

import collections
import logging
import time
from typing import Any, Callable

import numpy as np
import torch

from ..compile.buckets import bucket_for, resolve_buckets
from ..models.generate import _truncate_scaled, decode_step, sample_logits_batched
from ..models.moe import MoEMLP
from ..models.quant import prepare_decode_params
from ..models.speculative import init_medusa_heads, medusa_head_logits, verify_proposals
from ..telemetry import journal
from .adapters import AdapterSet
from .kv_pool import KVBlockPool
from .ledger import ServeLedger
from .prefix_cache import PrefixCache
from .scheduler import Request, Scheduler, _Sequence

__all__ = ["DuplicateRequest", "ServeEngine"]

logger = logging.getLogger("dmlcloud_tpu_torch")


class DuplicateRequest(ValueError):
    """``submit`` rejected an idempotency token it has already accepted; the
    original admission stands. Carries the rid it mapped to, so a retrying
    caller can re-attach instead of double-admitting."""

    def __init__(self, token: str, rid: int):
        super().__init__(f"idempotency token {token!r} already admitted as request {rid}")
        self.token = token
        self.rid = int(rid)


def _pow2_buckets(limit: int) -> tuple[int, ...]:
    """1, 2, 4, ... capped at (and always including) ``limit`` (the
    reference's engine.py:325)."""
    out, b = [], 1
    while b < limit:
        out.append(b)
        b *= 2
    return tuple(sorted(set(out + [int(limit)])))


def _copy_block(pools: dict, src: int, dst: int) -> None:
    """The copy-on-write fork's device half: copy page ``src`` to page ``dst``
    in every layer's K and V, in place."""
    for layer in pools.values():
        for x in layer.values():
            x[dst].copy_(x[src])


def _pick(logits, generator, temperature, top_k, top_p, sample: bool):
    """Each row's next token from ``[B, V]`` logits: the argmax alone when no
    row samples, else ``sample_logits_batched`` with the rows' parameters."""
    if not sample:
        return logits.argmax(-1)
    return sample_logits_batched(logits.float(), temperature, top_k, top_p, generator)


def _paged_step(model, pools, tables, fill, tokens, last_idx, generator, temperature, top_k, top_p, sample: bool,
                adapters=None):
    """One engine step (a prefill chunk or a decode batch): write ``tokens``'
    K/V through the block tables, read each row's logits at ``last_idx`` and
    pick the next token with each row's parameters. Returns the tokens ``[B]``
    on the device."""
    logits, pools = decode_step(model, tokens, pools, pages=(tables, fill), adapters=adapters)
    last = logits.gather(1, last_idx[:, None, None].expand(-1, 1, logits.shape[-1]))[:, 0]  # [B, V]
    return _pick(last, generator, temperature, top_k, top_p, sample), pools


def _spec_draft_step(model, pools, tables, fill, prev_tok, last_tok, generator, temperature, top_k, top_p,
                     sample: bool, k: int):
    """The draft half of one speculative round: ``k`` proposals per row
    against the draft pool. Pass 0 feeds the last two committed tokens at
    ``fill-1``/``fill``; passes ``1..k-1`` feed each proposal at ``fill + i``.
    Returns ``(proposals [B, k], dlogits [B, k, V], pools)``, ``dlogits`` row
    ``i`` the truncated, scaled distribution proposal ``i+1`` was drawn from
    (what the verifier's rejection rule reads as ``p_d``)."""
    toks2 = torch.stack([prev_tok, last_tok], 1)  # [B, 2]
    logits, pools = decode_step(model, toks2, pools, pages=(tables, fill - 1))
    nxt = _pick(logits[:, -1], generator, temperature, top_k, top_p, sample)
    props, drows = [nxt], [logits[:, -1]]
    for i in range(1, k):
        logits, pools = decode_step(model, nxt[:, None], pools, pages=(tables, fill + i))
        nxt = _pick(logits[:, 0], generator, temperature, top_k, top_p, sample)
        props.append(nxt)
        drows.append(logits[:, 0])
    dlogits = _truncate_scaled(torch.stack(drows, 1).float(), temperature, top_k, top_p)
    return torch.stack(props, 1), dlogits, pools


def _spec_verify_step(model, pools, tables, fill, last_tok, proposals, dlogits, generator, temperature, top_k, top_p,
                      eos_id, adapters):
    """The verify half: ONE target pass scores all ``k+1`` positions per row
    (``[y_last, d_1..d_k]`` written at ``fill..fill+k``), then
    ``verify_proposals`` runs each row's accept rule. Returns ``(packed [B,
    k+3], pools)``: the ``k+1`` tokens to commit, then ``n_new`` and
    ``n_accept``, so one host copy carries tokens and counters. ``adapters``
    reaches the target pass only (the draft proposed with the base model)."""
    x = torch.cat([last_tok[:, None], proposals], 1)  # [B, k+1]
    tlogits, pools = decode_step(model, x, pools, pages=(tables, fill), adapters=adapters)
    new_tokens, n_new, n_accept = verify_proposals(tlogits, dlogits, proposals, generator, temperature, top_k, top_p,
                                                   eos_id)
    return torch.cat([new_tokens, n_new[:, None], n_accept[:, None]], 1), pools


def _medusa_step(model, pools, heads, tables, fill, last_tok, proposals, generator, temperature, top_k, top_p, eos_id,
                 adapters, sample: bool, k: int):
    """One Medusa round as ONE model forward: verify the proposals the
    previous round's heads emitted (``[y_last, q_1..q_{k-1}]`` written at
    ``fill..fill+k-1``, one-hot draft rows), then read the hidden state at
    each row's accepted position and propose the next round's tokens with the
    heads' argmax. Returns ``(packed [B, 2k+1], pools)``: committed tokens,
    ``n_new``, ``n_accept`` and the next proposals in one copy; ``k == 1`` has
    no heads and gives ``[B, 3]``, a plain one-token step."""
    x = torch.cat([last_tok[:, None], proposals], 1) if k > 1 else last_tok[:, None]  # [B, k]
    (tlogits, hidden), pools = decode_step(model, x, pools, pages=(tables, fill), adapters=adapters,
                                           return_hidden=True)
    tlogits = tlogits.float()
    if k == 1:
        tok = _pick(tlogits[:, 0], generator, temperature, top_k, top_p, sample)
        return torch.stack([tok, torch.ones_like(tok), torch.zeros_like(tok)], 1), pools
    b, _, v = tlogits.shape
    # one-hot at the argmax pick each proposal was
    dlogits = torch.full((b, k - 1, v), -1e9, dtype=torch.float32, device=tlogits.device)
    dlogits.scatter_(2, proposals[..., None].long(), 0.0)
    new_tokens, n_new, n_accept = verify_proposals(tlogits, dlogits, proposals, generator, temperature, top_k, top_p,
                                                   eos_id)
    h_acc = hidden.gather(1, n_accept[:, None, None].expand(-1, 1, hidden.shape[-1]))[:, 0]
    nxt = medusa_head_logits(heads, h_acc).argmax(-1)
    return torch.cat([new_tokens, n_new[:, None], n_accept[:, None], nxt], 1), pools


#: constructor arguments of the reference that wait for a later slice: their
#: defaults, and what they wait for
_NOT_PORTED = {
    "verify": (None, "the IR verifier (ROADMAP Queue 1 item 13c, the linter's IR tier)"),
    "hbm_budget": (None, "the IR verifier's memory check (ROADMAP Queue 1 item 13c)"),
}


def _is_moe(model) -> bool:
    return any(isinstance(m, MoEMLP) for m in model.modules())


def _default_medusa_heads(model, k: int, device) -> dict:
    """The reference's default heads: warm-started from the base ``lm_head``
    when the embeddings are not tied (the whole head, gathered over
    ``model`` under tensor parallelism), else random ``w2`` from seed 0."""
    from ..models.transformer import lm_head_kernel
    from ..parallel.tensor_parallel import gather_from_model

    kernel = None
    if not model.cfg.tie_embeddings and isinstance(model.lm_head.weight, torch.Tensor):
        with torch.no_grad():
            kernel, tp = lm_head_kernel(model)
            if tp is not None:
                kernel = gather_from_model(kernel, tp, dim=-1)
            kernel = kernel.detach()
    return init_medusa_heads(model.cfg, k, torch.Generator(device=device).manual_seed(0), lm_head_kernel=kernel)


class ServeEngine:
    """Continuous-batching inference over a ``DecoderLM`` (module docstring).

    - ``num_blocks`` / ``block_size``: the pool geometry. The default pool
      covers ``max_slots`` worst-case sequences; a deployment sizes it for the
      expected live tokens and lets admission control do the rest.
    - ``max_slots``: concurrent decode streams; ``prefill_chunk``: prompt
      tokens processed per engine step.
    - sampling (``temperature``/``top_k``/``top_p``/``eos_id``): the engine's
      defaults (greedy, ``generate`` semantics); each request may override
      them at ``submit``. Draws come from ``generator`` (default: seed 0 on
      the model's device).
    - ``spec_k``: speculative proposals per round (0: the plain engine).
      ``draft_model`` names the proposer (None: the target drafts for itself,
      accept rate exactly 1 under greedy); ``draft_num_blocks`` sizes the
      draft pool (default: the target pool's count).
    - ``medusa_k`` / ``medusa_heads``: Medusa decoding, up to ``medusa_k``
      tokens per round from ``medusa_k - 1`` decode heads (the dict of
      ``models.speculative.init_medusa_heads``, numpy or torch arrays).
      None warm-starts every head from the base ``lm_head``. Mutually
      exclusive with ``spec_k``.
    - ``adapters``: an ``AdapterSet`` (factors on the model's device) for
      multi-tenant LoRA; requests pick a tenant by name.
    - ``prefix_cache``: radix-tree prefix sharing with copy-on-write.
    - ``cache_dtype``: the pages' dtype (default the model's compute dtype).
    - ``max_waiting``/``shed_policy``/``fairness``/``drr_quantum``: overload
      control (``Scheduler``); ``clock`` is the time source of deadlines, the
      ledger, the metrics and the SLOs; ``max_done`` bounds the terminal
      records kept (None: all); ``ledger_max_records`` bounds the ledger's.
    - ``run_dir`` / ``drain_budget_s`` / ``preemption`` / ``watchdog``: the
      drain verdict's directory, the in-flight budget of a drain, a
      ``PreemptionGuard`` whose trip drains with requeue, a ``HangWatchdog``
      heartbeaten once per step (``HangWatchdog.serve_guard`` sets it).
    - ``metrics``: True for a fresh ``MetricsRegistry``, or one to share;
      ``slos``: a list of ``SLO`` (or an ``SLOMonitor``).
    """

    def __init__(
        self,
        model,
        *,
        num_blocks: int | None = None,
        block_size: int = 16,
        max_slots: int = 8,
        prefill_chunk: int = 32,
        batch_buckets=None,
        table_buckets=None,
        temperature: float = 0.0,
        top_k: int = 0,
        top_p: float = 1.0,
        eos_id: int = -1,
        spec_k: int = 0,
        draft_model=None,
        draft_num_blocks: int | None = None,
        medusa_k: int = 0,
        medusa_heads: Any = None,
        adapters: AdapterSet | None = None,
        prefix_cache: bool = False,
        generator: torch.Generator | None = None,
        cache_dtype: torch.dtype | None = None,
        max_waiting: int | None = None,
        shed_policy: str = "reject",
        fairness: str = "fifo",
        drr_quantum: int | None = None,
        clock: Callable[[], float] = time.perf_counter,
        run_dir: Any = None,
        drain_budget_s: float = 5.0,
        preemption=None,
        watchdog=None,
        max_done: int | None = None,
        ledger_max_records: int | None = None,
        metrics: Any = None,
        slos: Any = None,
        **not_ported: Any,
    ):
        for name, value in not_ported.items():
            if name not in _NOT_PORTED:
                raise TypeError(f"ServeEngine() got an unexpected keyword argument {name!r}")
            default, what = _NOT_PORTED[name]
            if value != default:
                raise NotImplementedError(f"ServeEngine({name}=...) needs {what}, which is not ported yet")
        if spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {spec_k}")
        if medusa_k < 0:
            raise ValueError(f"medusa_k must be >= 0, got {medusa_k}")
        if spec_k and medusa_k:
            raise ValueError("spec_k and medusa_k are mutually exclusive decode modes")
        if draft_model is not None and spec_k < 1:
            raise ValueError("a draft model needs spec_k >= 1")
        if medusa_heads is not None and medusa_k < 1:
            raise ValueError("medusa_heads need medusa_k >= 1")
        cfg = model.cfg
        raw = model
        #: an MoE model runs the reference's padded shapes (module docstring)
        self._moe = _is_moe(model) or (draft_model is not None and _is_moe(draft_model))
        self.batch_buckets = tuple(sorted({int(b) for b in batch_buckets})) if batch_buckets else _pow2_buckets(
            max_slots)
        # one-time preparation: int8 kernels stay int8 (models/quant.py)
        self.model = model = prepare_decode_params(model, cfg.dtype)
        self.device = model.embed.weight.device
        self.spec_k = int(spec_k)
        max_table = -(-cfg.max_seq_len // block_size)
        if num_blocks is None:
            num_blocks = max_slots * max_table
        self.table_buckets = (resolve_buckets(table_buckets) if table_buckets
                              else _pow2_buckets(min(max_table, num_blocks)))
        self.pool = KVBlockPool.for_model(model, num_blocks=num_blocks, block_size=block_size, dtype=cache_dtype,
                                          device=self.device)
        self.draft_model = None
        self.draft_pool = None
        if self.spec_k:
            # self-draft unless a draft is named; either way the draft owns
            # its own page pool: rollback is a fill counter, never shared pages
            self.draft_model = model if draft_model is None else prepare_decode_params(draft_model,
                                                                                       draft_model.cfg.dtype)
            self.draft_pool = KVBlockPool.for_model(self.draft_model, num_blocks=int(draft_num_blocks or num_blocks),
                                                    block_size=block_size, dtype=cache_dtype, device=self.device)
        self.medusa_k = int(medusa_k)
        self.medusa_heads = None
        if self.medusa_k:
            if medusa_heads is not None:
                self.medusa_heads = {
                    name: (v if isinstance(v, torch.Tensor) else torch.tensor(np.asarray(v))).to(self.device,
                                                                                             torch.float32)
                    for name, v in medusa_heads.items()}
            else:
                self.medusa_heads = _default_medusa_heads(raw, self.medusa_k, self.device)
        # the radix tree lives over the TARGET pool only
        self.prefix = PrefixCache(self.pool) if prefix_cache else None
        self.scheduler = Scheduler(self.pool, max_slots, prefill_chunk, draft_pool=self.draft_pool,
                                   lookahead=self.spec_k or self.medusa_k, prefix_cache=self.prefix,
                                   max_waiting=max_waiting, shed_policy=shed_policy, fairness=fairness,
                                   drr_quantum=drr_quantum)
        self.ledger = ServeLedger(max_records=ledger_max_records)
        self.adapters = adapters
        self.eos_id = int(eos_id)
        self._temperature = float(temperature)
        self._top_k = int(top_k)
        self._top_p = float(top_p)
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        self.generator = generator
        self._next_id = 0
        self._done: dict[int, _Sequence] = {}
        # idempotency: accepted caller tokens -> rid; they age out with the
        # terminal records (max_done)
        self._tokens: dict[str, int] = {}
        # every known sequence by id (live and retained terminal), and the
        # terminal ids in finish order (the retention bound)
        self._all: dict[int, _Sequence] = {}
        self._terminal: collections.deque[int] = collections.deque()
        self._max_done = None if max_done is None else int(max_done)
        self.clock = clock
        self.run_dir = run_dir
        self.drain_budget_s = float(drain_budget_s)
        self.preemption = preemption
        self.watchdog = watchdog
        #: chaos hook: ``fn(point, seqs)`` called at "step" (must not raise)
        #: and before each device phase ("prefill"/"decode"/"draft"/"verify";
        #: the Medusa round fires "verify"), where raising injects a fault
        self.fault_injector: Callable[[str, Any], None] | None = None
        self._drain_reason: str | None = None
        self._drain_kind = "completed"
        self._drain_requeue = False
        self._drain_started: float | None = None

        # metrics: every series handle is resolved once here; the loop only
        # touches pre-bound children
        self.metrics = None
        if metrics:
            from ..telemetry.metrics_registry import ITL_BUCKETS, QUEUE_DEPTH_BUCKETS, TTFT_BUCKETS, MetricsRegistry
            from .scheduler import TERMINAL_STATUSES

            reg = metrics if isinstance(metrics, MetricsRegistry) else MetricsRegistry()
            self.metrics = reg
            self._m_requests = reg.counter("dml_serve_requests_total", "requests submitted")
            self._m_tokens = reg.counter("dml_serve_tokens_total", "tokens emitted (all requests)")
            terminal = reg.counter("dml_serve_terminal_total", "terminal statuses", labels=("status",),
                                   max_series=len(TERMINAL_STATUSES) + 1)
            self._m_terminal = {s: terminal.labels(status=s) for s in TERMINAL_STATUSES}
            self._m_drafted = reg.counter("dml_serve_drafted_tokens_total", "speculative tokens proposed")
            self._m_accepted = reg.counter("dml_serve_accepted_tokens_total", "speculative tokens accepted")
            self._m_ttft = reg.histogram("dml_serve_ttft_seconds", "time to first token", buckets=TTFT_BUCKETS)
            self._m_itl = reg.histogram("dml_serve_itl_seconds", "inter-token latency", buckets=ITL_BUCKETS)
            self._m_depth = reg.histogram("dml_serve_queue_depth", "admission queue depth per step",
                                          buckets=QUEUE_DEPTH_BUCKETS)
            self._m_batch = reg.gauge("dml_serve_decode_batch_size", "rows in the last decode batch")
            self._m_active = reg.gauge("dml_serve_active_requests", "admitted, unfinished requests")
            self._m_free = reg.gauge("dml_serve_kv_blocks_free", "free blocks in the target pool")
            self._m_live = reg.gauge("dml_serve_kv_blocks_live", "live blocks in the target pool")
            self._m_shared = reg.gauge("dml_serve_kv_blocks_shared", "refcount>1 blocks (prefix sharing)")
            self._m_pref_lookups = reg.counter("dml_serve_prefix_lookups_total", "prefix-cache lookups at admission")
            self._m_pref_hits = reg.counter("dml_serve_prefix_hits_total", "admissions with a cached prefix")
            self._m_pref_saved = reg.counter("dml_serve_prefill_tokens_saved_total",
                                             "prefill tokens skipped via the prefix cache")
        # SLOs: declarative objectives over the same injectable clock
        self.slo = None
        if slos:
            from .slo import SLOMonitor

            self.slo = slos if isinstance(slos, SLOMonitor) else SLOMonitor(slos, clock=clock)
            # the summary's "slo" section reads the live monitor
            self.ledger.slo_monitor = self.slo

    # -- request lifecycle ---------------------------------------------------
    def submit(
        self,
        prompt,
        max_new_tokens: int = 32,
        adapter: str | None = None,
        *,
        temperature: float | None = None,
        top_k: int | None = None,
        top_p: float | None = None,
        eos_id: int | None = None,
        deadline_s: float | None = None,
        priority: int = 0,
        tenant: str | None = None,
        token: str | None = None,
        trace: str | None = None,
    ) -> int:
        """Queue one request; returns its id. ``prompt`` is a 1-D token
        sequence (no padding: paged rows sit at their own absolute positions).
        The sampling knobs override the engine's defaults for this request.
        ``adapter`` names a tenant of the engine's ``AdapterSet``.
        ``deadline_s`` is a budget from now, after which the request ends
        ``deadline_exceeded`` at whatever phase it is in; ``priority`` matters
        only to shed-victim selection; ``tenant`` keys the fairness scheduler
        (default: the adapter name). The returned id's status may already be
        ``shed`` when the bounded queue chose the arrival as its victim, or
        the engine is draining. ``token`` is an idempotency token: one already
        accepted raises :class:`DuplicateRequest`. ``trace`` is the trace id
        every span of this request links under (default ``tr-<rid>``)."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("prompt must contain at least one token")
        # spec/Medusa rounds may write up to k proposals past the last
        # committed slot (plus the bonus slot)
        lookahead = self.spec_k or self.medusa_k
        slack = lookahead + 1 if lookahead else 0
        if prompt.size + int(max_new_tokens) + slack > self.model.cfg.max_seq_len:
            knob = "spec_k" if self.spec_k else "medusa_k"
            raise ValueError(f"prompt ({prompt.size}) + max_new_tokens ({max_new_tokens})"
                             + (f" + {knob}+1 ({slack})" if slack else "")
                             + f" exceeds max_seq_len ({self.model.cfg.max_seq_len})")
        aid = 0
        if adapter is not None:
            if self.adapters is None:
                raise ValueError("request names an adapter but the engine has no AdapterSet")
            aid = self.adapters.id_of(adapter)
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError(f"deadline_s must be > 0, got {deadline_s}")
        if token is not None and token in self._tokens:
            raise DuplicateRequest(token, self._tokens[token])
        now = self.clock()
        rid = self._next_id
        self._next_id += 1
        if trace is None:
            trace = f"tr-{rid}"
        if self.metrics is not None:
            self._m_requests.inc()
        req = Request(prompt=prompt, max_new_tokens=int(max_new_tokens), adapter=adapter, temperature=temperature,
                      top_k=top_k, top_p=top_p, eos_id=eos_id, deadline_s=deadline_s, priority=int(priority),
                      tenant=tenant, id=rid)
        resolved_tenant = tenant if tenant is not None else (adapter or "")
        seq = _Sequence(
            req=req, arrival=now, adapter_id=aid, deadline=None if deadline_s is None else now + float(deadline_s),
            tenant=resolved_tenant, priority=int(priority), token=token, trace=trace,
            temperature=self._temperature if temperature is None else float(temperature),
            top_k=self._top_k if top_k is None else int(top_k),
            top_p=self._top_p if top_p is None else float(top_p),
            eos_id=self.eos_id if eos_id is None else int(eos_id),
        )
        if self.draining:
            # admission is closed: arrivals shed on sight
            self.ledger.arrived(rid, now, tenant=resolved_tenant)
            self._all[rid] = seq
            if token is not None:
                self._tokens[token] = rid
            self._finalize(seq, now, "shed")
            return rid
        shed = self.scheduler.submit(seq)  # validates; raising records nothing
        self.ledger.arrived(rid, now, tenant=resolved_tenant)
        self._all[rid] = seq
        if token is not None:
            self._tokens[token] = rid
        for victim in shed:
            # the scheduler picked the victim (possibly ``seq`` itself, never
            # enqueued); the engine owns its terminal bookkeeping
            self._finalize(victim, now, "shed")
        return rid

    def output(self, rid: int) -> np.ndarray:
        """The emitted tokens of a request that finished ``ok``."""
        return np.asarray(self._done[rid].out, np.int32)

    def results(self) -> dict[int, np.ndarray]:
        return {rid: self.output(rid) for rid in self._done}

    def cancel(self, rid: int) -> bool:
        """Cancel a live request at whatever phase it is in; its blocks (both
        pools), COW spare and prefix locks are released at once and its status
        becomes ``cancelled``. False when the request is unknown or already
        terminal."""
        seq = self._all.get(rid)
        if seq is None or seq.status is not None:
            return False
        return self._finalize(seq, self.clock(), "cancelled")

    def status(self, rid: int) -> str:
        """``queued`` / ``running`` while live, else the terminal status."""
        seq = self._all.get(rid)
        if seq is None:
            raise KeyError(f"unknown (or retention-evicted) request id {rid}")
        if seq.status is not None:
            return seq.status
        return "queued" if seq.admitted is None else "running"

    def statuses(self) -> dict[int, str]:
        """Every retained request's :meth:`status`, by id."""
        return {rid: self.status(rid) for rid in self._all}

    def sequence(self, rid: int) -> _Sequence:
        """The request's record: ``arrival``, ``admitted``, ``first_token``
        and ``finished`` on the engine's clock, ``out``, ``status``."""
        return self._all[rid]

    @property
    def idle(self) -> bool:
        return self.scheduler.idle

    def leaked_blocks(self) -> int:
        """Blocks still live beyond what the prefix tree holds (one reference
        per cached node), the draft pool's live blocks, and any lock left on a
        tree block; 0 whenever the engine is :attr:`idle`."""
        held = self.prefix.stats()["nodes"] if self.prefix is not None else 0
        leaked = self.pool.num_live - held
        if self.draft_pool is not None:
            leaked += self.draft_pool.num_live
        if self.prefix is not None:
            leaked += len(self.prefix.leaked_locks())
        return leaked

    # -- terminal bookkeeping ------------------------------------------------
    def _finalize(self, seq: _Sequence, now: float, status: str, error: str | None = None) -> bool:
        """The engine half of the one exit path: scheduler terminate (queue
        removal, every block released), then ledger, journal and retention.
        False when already terminal."""
        if not self.scheduler.terminate(seq, now, status):
            return False
        self._record_terminal(seq, now, error)
        return True

    def _record_terminal(self, seq: _Sequence, now: float, error: str | None = None) -> None:
        rid = seq.req.id
        self.ledger.finished(rid, now, status=seq.status)
        if self.metrics is not None:
            child = self._m_terminal.get(seq.status)
            if child is not None:
                child.inc()
        if self.slo is not None:
            self.slo.record_terminal(seq.tenant, seq.status, now)
        if seq.status == "error":
            journal.emit("fault", now, label=f"req{rid}", request=rid, trace=seq.trace, status=seq.status,
                         error=error or "")
        if seq.status == "ok":
            self._done[rid] = seq
        self._terminal.append(rid)
        if self._max_done is not None:
            while len(self._terminal) > self._max_done:
                old = self._terminal.popleft()
                self._done.pop(old, None)
                dropped = self._all.pop(old, None)
                if dropped is not None and dropped.token is not None:
                    self._tokens.pop(dropped.token, None)

    def _fail(self, seqs, exc: Exception) -> None:
        """Isolate a step failure to the requests it was advancing."""
        logger.error("serve step failed for requests %s", [s.req.id for s in seqs], exc_info=exc)
        now = self.clock()
        msg = f"{type(exc).__name__}: {exc}"
        for s in seqs:
            self._finalize(s, now, "error", error=msg)

    # -- the serving loop ----------------------------------------------------
    def step(self) -> bool:
        """One engine iteration: expire deadlines, admit (or drain), one
        prefill chunk, one decode batch (a speculative round under
        ``spec_k``, a Medusa round under ``medusa_k``). Returns whether any
        device work ran. A failure in either device phase fails only the
        requests it was advancing."""
        now = self.clock()
        if self.watchdog is not None:
            self.watchdog.notify()
        self._chaos("step", None)
        for seq in self.scheduler.expire(now):
            self._record_terminal(seq, now)  # the scheduler released its blocks
        if self.preemption is not None and self.preemption.triggered and not self.draining:
            self.request_drain(f"preemption:{self.preemption.signal_name}", kind="preemption", requeue=True)
        if self.draining:
            self._drain_step(now)
        else:
            for seq in self.scheduler.admit(now):
                self._admitted(seq, now)
        if self.metrics is not None:
            self._m_depth.observe(self.scheduler.depth())
            self._m_active.set(self.scheduler.active)
            self._m_free.set(self.pool.num_free)
            self._m_live.set(self.pool.num_live)
        if self.slo is not None:
            self.slo.evaluate(now)
        did = False
        seq = self.scheduler.next_prefill()
        if seq is not None:
            try:
                self._prefill_chunk(seq)
            except Exception as exc:  # noqa: BLE001 -- isolate to this request
                self._fail([seq], exc)
            did = True
        batch = self.scheduler.decode_batch()
        if batch:
            try:
                if self.spec_k:
                    self._decode_spec(batch)
                elif self.medusa_k:
                    self._decode_medusa(batch)
                else:
                    self._decode(batch)
            except Exception as exc:  # noqa: BLE001 -- isolate to these rows
                self._fail(batch, exc)
            did = True
        return did

    def _admitted(self, seq: _Sequence, now: float) -> None:
        """The ledger, journal and metrics of one admission."""
        rid = seq.req.id
        self.ledger.admitted(rid, now)
        if self.prefix is not None:
            # saved = the divergence point prefill starts at (the cached
            # tokens, less the one re-fed token of an exact full-block match)
            self.ledger.prefix_match(rid, cached=seq.cached_tokens, saved=seq.fill, prompt=seq.prompt_len)
            journal.emit("prefix_lookup", now, now, label=f"req{rid}", request=rid, trace=seq.trace,
                         cached=seq.cached_tokens, saved=seq.fill, shared=seq.shared)
            if self.metrics is not None:
                self._m_pref_lookups.inc()
                if seq.cached_tokens > 0:
                    self._m_pref_hits.inc()
                self._m_pref_saved.inc(seq.fill)
        journal.emit("queue_wait", seq.arrival, now, label=f"req{rid}", request=rid, trace=seq.trace,
                     depth=self.scheduler.depth())
        journal.emit("admission", now, now, label=f"req{rid}", request=rid, trace=seq.trace, tenant=seq.tenant,
                     blocks=len(seq.blocks), cached=seq.cached_tokens)

    def _chaos(self, point: str, seqs) -> None:
        if self.fault_injector is not None:
            self.fault_injector(point, seqs)

    def run(self, max_steps: int | None = None) -> dict[int, np.ndarray]:
        """Drive :meth:`step` until every submitted request finished (or
        ``max_steps`` elapsed); returns the finished outputs."""
        steps = 0
        while not self.idle:
            self.step()
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        return self.results()

    # -- graceful drain ------------------------------------------------------
    @property
    def draining(self) -> bool:
        return self._drain_reason is not None

    def request_drain(self, reason: str = "drain requested", *, kind: str = "completed",
                      requeue: bool = False) -> None:
        """Begin graceful drain: admission closes (arrivals shed on sight, the
        waiting queue sheds next step), in-flight requests get
        ``drain_budget_s`` from now to finish, then shed too. The first call
        wins."""
        if self._drain_reason is None:
            self._drain_reason = str(reason)
            self._drain_kind = kind
            self._drain_requeue = bool(requeue)
            self._drain_started = self.clock()

    def _drain_step(self, now: float) -> None:
        for seq in list(self.scheduler.iter_waiting()):
            self._finalize(seq, now, "shed")
        if now - self._drain_started >= self.drain_budget_s:
            # budget spent: in-flight work sheds, blocks release
            for seq in [*self.scheduler.prefilling, *self.scheduler.running]:
                self._finalize(seq, now, "shed")

    def drain(self, reason: str | None = None, *, kind: str | None = None, requeue: bool | None = None,
              max_steps: int | None = None) -> dict:
        """Drain to completion and write the ``requeue.json`` verdict: stop
        admission, shed the queue, step until in-flight work finishes (or the
        drain budget sheds it), then record the verdict under ``run_dir``
        (skipped without one). A tripped ``PreemptionGuard`` makes it
        ``kind="preemption"`` with requeue; a manual drain is
        ``kind="completed"`` without. Returns the verdict dict."""
        if not self.draining:
            preempted = self.preemption is not None and self.preemption.triggered
            if reason is None:
                reason = f"preemption:{self.preemption.signal_name}" if preempted else "drain requested"
            self.request_drain(reason, kind=kind or ("preemption" if preempted else "completed"),
                               requeue=(preempted if requeue is None else requeue))
        steps = 0
        while not self.idle:
            self.step()
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        now = self.clock()
        counts = self.ledger.status_counts()
        verdict = {
            "requeue": self._drain_requeue,
            "kind": self._drain_kind,
            "reason": self._drain_reason,
            "serve": {
                "drain_s": round(now - self._drain_started, 6),
                "statuses": counts,
                "drained_clean": self.idle,
                "slo_alerts": len(self.slo.alerts) if self.slo is not None else 0,
            },
        }
        journal.emit("drain", self._drain_started, now, label=self._drain_kind, **counts)
        if self.run_dir is not None:
            from ..checkpoint import write_requeue_verdict

            write_requeue_verdict(self.run_dir, verdict["requeue"], verdict["reason"], verdict["kind"],
                                  serve=verdict["serve"])
        return verdict

    # -- observability -------------------------------------------------------
    def metrics_text(self) -> str:
        """The metrics registry as Prometheus text (empty without
        ``metrics=``); the pool gauges are refreshed at scrape time."""
        snap = self.metrics_snapshot()
        if snap is None:
            return ""
        from ..telemetry.metrics_registry import to_prometheus_text

        return to_prometheus_text(snap)

    def metrics_snapshot(self) -> dict | None:
        """The gauge-refreshed registry snapshot (plain dicts; None when
        metrics are off)."""
        if self.metrics is None:
            return None
        self._m_free.set(self.pool.num_free)
        self._m_live.set(self.pool.num_live)
        self._m_shared.set(self.pool.stats()["shared"])
        self._m_active.set(self.scheduler.active)
        return self.metrics.snapshot()

    def serve_trace(self, trace, clock=None, sleep=time.sleep) -> dict:
        """Replay a timed request trace in real time: ``trace`` is a list of
        ``(offset_s, prompt, max_new_tokens[, adapter_or_kwargs])`` tuples
        (offsets from the replay's start; the optional last element is an
        adapter name or a dict of :meth:`submit` keywords). Requests are
        submitted when ``clock`` (default the engine's) reaches their offset,
        and the engine steps in between. Returns the ledger summary."""
        if clock is None:
            clock = self.clock
        pending = sorted(trace, key=lambda e: e[0])
        t0 = clock()
        i = 0
        while i < len(pending) or not self.idle:
            now = clock() - t0
            while i < len(pending) and pending[i][0] <= now:
                off, prompt, max_new, *rest = pending[i]
                kw = {}
                if rest:
                    kw = dict(rest[0]) if isinstance(rest[0], dict) else {"adapter": rest[0]}
                self.submit(prompt, max_new, **kw)
                i += 1
            if self.draining:
                i = len(pending)  # admission is closed: drop the unsubmitted tail
            if not self.step() and i < len(pending):
                # idle with future arrivals: nap until the next
                sleep(min(max(pending[i][0] - (clock() - t0), 0.0), 0.001))
        return self.ledger.summary()

    # -- device calls --------------------------------------------------------
    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device, non_blocking=True)

    def _rows(self, n: int) -> int:
        """Rows of a decode call for ``n`` sequences: ``n``, or an MoE model's
        batch bucket."""
        if self._moe:
            return next((b for b in self.batch_buckets if b >= n), n)
        return n

    def _row_params(self, seqs, rows: int):
        """The per-row sampling tensors (``temperature``, ``top_k``,
        ``top_p``, ``eos_id``) of a batch padded to ``rows`` (pad rows
        greedy), and whether any row samples."""
        pad = rows - len(seqs)
        dev = self.device
        return (torch.tensor([s.temperature for s in seqs] + [0.0] * pad, dtype=torch.float32, device=dev),
                torch.tensor([s.top_k for s in seqs] + [0] * pad, dtype=torch.long, device=dev),
                torch.tensor([s.top_p for s in seqs] + [1.0] * pad, dtype=torch.float32, device=dev),
                torch.tensor([s.eos_id for s in seqs] + [-1] * pad, dtype=torch.long, device=dev),
                any(s.temperature > 0 for s in seqs))

    def _adapter_args(self, seqs, rows: int):
        """``decode_step``'s ``adapters=`` for the batch (pad rows the null
        adapter), or None without an ``AdapterSet``."""
        if self.adapters is None:
            return None
        return self.adapters.pack([s.adapter_id for s in seqs] + [0] * (rows - len(seqs)))

    def _call(self, seqs, tables: np.ndarray, fill: np.ndarray, tokens: np.ndarray, last_idx: np.ndarray):
        """One ``_paged_step`` on the batch ``seqs`` (and any padded rows past
        them); the new tokens come back to the host in one copy."""
        rows = tables.shape[0]
        temps, topks, topps, _, sample = self._row_params(seqs, rows)
        tok, pools = _paged_step(self.model, self.pool.pools, self._dev(tables), self._dev(fill), self._dev(tokens),
                                 self._dev(last_idx), self.generator, temps, topks, topps, sample,
                                 adapters=self._adapter_args(seqs, rows))
        self.pool.swap(pools)
        return tok.cpu().numpy()  # the per-call host sync: the tokens ARE the output

    def _cow_guard(self, seq: _Sequence, lo: int, hi: int) -> None:
        """The copy-on-write rule: before a write to positions ``[lo, hi)`` of
        ``seq``, fork every covered block with more than one holder. The fork
        takes the COW spare reserved at admission (else a fresh block), copies
        the page in place, swaps the table entry and releases this sequence's
        reference to the shared original. A no-op without a prefix cache."""
        if self.prefix is None:
            return
        bs = self.pool.block_size
        for bi in range(lo // bs, (max(hi, lo + 1) - 1) // bs + 1):
            if bi >= len(seq.blocks) or not self.pool.is_shared(seq.blocks[bi]):
                continue
            old = seq.blocks[bi]
            if seq.cow_spare > 0:
                new = seq.blocks.pop()  # the spare reserved at admission
                seq.cow_spare -= 1
            else:
                [new] = self.pool.alloc(1)
            _copy_block(self.pool.pools, old, new)
            seq.blocks[bi] = new
            self.pool.release([old])
            seq.shared = min(seq.shared, bi)
            journal.emit("cow_fork", journal.now(), label=f"req{seq.req.id}:cow", request=seq.req.id,
                         trace=seq.trace, cow_block=bi)

    def _tables(self, seqs, rows: int, nb: int, draft: bool = False) -> np.ndarray:
        """The ``[rows, nb]`` block tables of ``seqs`` (their target or draft
        blocks), padded rows all sentinel."""
        pool = self.draft_pool if draft else self.pool
        tables = np.full((rows, nb), pool.sentinel, np.int64)
        for i, s in enumerate(seqs):
            blocks = (s.draft_blocks if draft else s.blocks)[:nb]
            tables[i, : len(blocks)] = blocks
        return tables

    def _prefill_chunk(self, seq: _Sequence) -> None:
        self._chaos("prefill", [seq])
        c = self.scheduler.prefill_chunk
        n = min(c, seq.prompt_len - seq.fill)
        # an exact full-block prefix match re-feeds the last prompt token,
        # whose write lands in the last shared block: fork it first
        self._cow_guard(seq, seq.fill, seq.fill + n)
        tokens = np.zeros((1, c if self._moe else n), np.int64)
        tokens[0, :n] = seq.req.prompt[seq.fill : seq.fill + n]
        nb = self.pool.blocks_for(seq.fill + n)
        final = seq.fill + n >= seq.prompt_len
        fill = np.asarray([seq.fill], np.int64)
        rid = seq.req.id
        t0 = journal.now()
        tok = self._call([seq], self._tables([seq], 1, nb), fill, tokens, np.asarray([n - 1], np.int64))
        journal.emit("prefill", t0, label=f"req{rid}", request=rid, trace=seq.trace, chunk=n, fill=seq.fill + n,
                     blocks=nb)
        if self.spec_k:
            # the draft pool needs the same prompt K/V: one mirrored chunk
            # through the draft model (the base model: no adapters), padded
            # as the reference pads it (module docstring)
            dtokens = np.zeros((1, c), np.int64)
            dtokens[0, :n] = tokens[0, :n]
            dnb = bucket_for(nb, self.table_buckets)
            t1 = journal.now()
            decode_step(self.draft_model, self._dev(dtokens), self.draft_pool.pools,
                        pages=(self._dev(self._tables([seq], 1, dnb, draft=True)), self._dev(fill)))
            journal.emit("draft", t1, label=f"req{rid}:prefill", request=rid, traces=[seq.trace], chunk=n,
                         blocks=dnb)
        seq.fill += n
        if final:
            # the last prompt position's logits ARE the first token:
            # time-to-first-token ends here, before any decode step
            now = self.clock()
            seq.first_token = now
            self.ledger.first_token(rid, now)
            if self.metrics is not None:
                self._m_ttft.observe(now - seq.arrival)
            if self.slo is not None:
                self.slo.record_ttft(seq.tenant, now - seq.arrival, now)
            self.scheduler.prefill_done(seq)
            seq.prev_token = int(seq.req.prompt[-1])
            if self.prefix is not None:
                # the prompt's full blocks now hold its K/V: publish them
                self.prefix.insert(seq.req.prompt, seq.blocks, adapter=seq.adapter_id)
            self._emit(seq, int(tok[0]), now)

    def _decode(self, batch) -> None:
        self._chaos("decode", batch)
        for s in batch:
            # decode writes at fill, past the shared prefix by construction
            self._cow_guard(s, s.fill, s.fill + 1)
        nb = max(s.needed_blocks(self.pool.block_size) for s in batch)
        rows = self._rows(len(batch))
        fill = np.zeros(rows, np.int64)
        tokens = np.zeros((rows, 1), np.int64)
        for i, s in enumerate(batch):
            fill[i], tokens[i, 0] = s.fill, s.last_token
        t0 = journal.now()
        tok = self._call(batch, self._tables(batch, rows, nb), fill, tokens, np.zeros(rows, np.int64))
        now = self.clock()
        self._batch_done("decode_batch", t0, batch, rows, nb)
        for i, s in enumerate(batch):
            s.fill += 1  # the fed token's K/V landed at its position
            s.prev_token = s.last_token  # a spec round after a degraded one feeds it
            self._emit(s, int(tok[i]), now)

    def _batch_done(self, kind: str, t0: float, batch, rows: int, nb: int, **attrs) -> None:
        """A decode batch's span, ledger sample and batch-size gauge."""
        journal.emit(kind, t0, label=f"b{rows}", active=len(batch), bucket=rows, blocks=nb, **attrs,
                     traces=[s.trace for s in batch])
        self.ledger.step_sample(self.scheduler.depth(), len(batch))
        if self.metrics is not None:
            self._m_batch.set(len(batch))

    def _round_inputs(self, batch, lookahead: int):
        """The padded inputs of a speculative or Medusa round: rows, table
        width, tables, fill (pad rows 1, so every position stays >= 0) and
        the last committed token per row."""
        nb = max(s.needed_blocks(self.pool.block_size, lookahead=lookahead) for s in batch)
        rows = self._rows(len(batch))
        fill = np.ones(rows, np.int64)
        last = np.zeros(rows, np.int64)
        for i, s in enumerate(batch):
            fill[i], last[i] = s.fill, s.last_token
        return rows, nb, self._tables(batch, rows, nb), fill, last

    def _commit(self, s: _Sequence, tokens, now: float) -> None:
        """Commit one row's accepted tokens: the fill counter rolls forward
        only to the accepted position (the partial-accept rewind)."""
        for tok in tokens:
            prev_last = s.last_token
            s.fill += 1  # this token's K/V was written by the round
            self._emit(s, int(tok), now)
            if s.finished is not None:
                break
            s.prev_token = prev_last

    def _decode_spec(self, batch) -> None:
        """One speculative round for the whole decode batch: ``k`` draft
        passes, one ``k+1``-position verify, then the host commits each row's
        accepted prefix from the round's one copy."""
        k = self.spec_k
        for s in batch:
            self._cow_guard(s, s.fill, s.fill + k + 1)  # the verify writes fill..fill+k
        rows, nb, tables, fill, last = self._round_inputs(batch, k)
        prev = np.zeros(rows, np.int64)
        for i, s in enumerate(batch):
            prev[i] = s.prev_token
        temps, topks, topps, eos, sample = self._row_params(batch, rows)
        fill_d, last_d = self._dev(fill), self._dev(last)
        t0 = journal.now()
        try:
            self._chaos("draft", batch)
            proposals, dlogits, dpools = _spec_draft_step(
                self.draft_model, self.draft_pool.pools, self._dev(self._tables(batch, rows, nb, draft=True)),
                fill_d, self._dev(prev), last_d, self.generator, temps, topks, topps, sample, k)
        except Exception as exc:  # noqa: BLE001 -- the draft is an optimization
            self._degrade_round(batch, t0, rows, exc)
            return
        self.draft_pool.swap(dpools)
        journal.emit("draft", t0, label=f"b{rows}", active=len(batch), bucket=rows, blocks=nb, k=k,
                     traces=[s.trace for s in batch])
        t1 = journal.now()
        self._chaos("verify", batch)
        # spec x LoRA: the verify pass scores with each row's adapter
        packed, tpools = _spec_verify_step(self.model, self.pool.pools, self._dev(tables), fill_d, last_d, proposals,
                                           dlogits, self.generator, temps, topks, topps, eos,
                                           self._adapter_args(batch, rows))
        self.pool.swap(tpools)
        out = packed.cpu().numpy()  # ONE copy: tokens and the n_new/n_accept counters
        now = self.clock()
        self._batch_done("verify", t1, batch, rows, nb, k=k)
        for i, s in enumerate(batch):
            accepted = int(out[i, k + 2])
            self.ledger.spec_round(s.req.id, drafted=k, accepted=accepted)
            if self.metrics is not None:
                self._m_drafted.inc(k)
                self._m_accepted.inc(accepted)
            self._commit(s, out[i, : int(out[i, k + 1])], now)

    def _decode_medusa(self, batch) -> None:
        """One Medusa round for the whole decode batch: ONE model forward
        verifies the proposals the previous round's heads emitted (a row's
        first round after prefill has none yet and runs on token 0, which the
        verify rule rejects) and emits the next ones, in the round's one
        copy."""
        k = self.medusa_k
        for s in batch:
            self._cow_guard(s, s.fill, s.fill + k)  # the round writes fill..fill+k-1
        rows, nb, tables, fill, last = self._round_inputs(batch, k)
        prop = np.zeros((rows, max(k - 1, 0)), np.int64)
        for i, s in enumerate(batch):
            pending = getattr(s, "medusa_pending", None)
            if pending is not None and k > 1:
                prop[i] = pending
        temps, topks, topps, eos, sample = self._row_params(batch, rows)
        t0 = journal.now()
        try:
            self._chaos("verify", batch)
            packed, tpools = _medusa_step(self.model, self.pool.pools, self.medusa_heads, self._dev(tables),
                                          self._dev(fill), self._dev(last), self._dev(prop), self.generator, temps,
                                          topks, topps, eos, self._adapter_args(batch, rows), sample, k)
        except Exception as exc:  # noqa: BLE001 -- the heads are an optimization
            for s in batch:
                # the degraded plain step shifts every row one position, so
                # carried proposals would be stale by one: drop them
                s.medusa_pending = None
            self._degrade_round(batch, t0, rows, exc, label="medusa_degrade")
            return
        self.pool.swap(tpools)
        out = packed.cpu().numpy()  # ONE copy: tokens, counters and the next proposals
        now = self.clock()
        self._batch_done("medusa", t0, batch, rows, nb, k=k)
        for i, s in enumerate(batch):
            if k > 1:
                accepted = int(out[i, k + 1])
                self.ledger.spec_round(s.req.id, drafted=k - 1, accepted=accepted)
                if self.metrics is not None:
                    self._m_drafted.inc(k - 1)
                    self._m_accepted.inc(accepted)
                s.medusa_pending = out[i, k + 2 : 2 * k + 1].copy()
            self._commit(s, out[i, : int(out[i, k])], now)

    def _degrade_round(self, batch, t0: float, rows: int, exc: Exception, label: str = "draft_degrade") -> None:
        """A failed propose step (the spec draft or the Medusa round) degrades
        the round to plain decode: no ``spec_round`` events this round, the
        tokens unchanged. The draft pool misses the degraded token's slot; the
        next round's 2-token rewrite closes one slot. A failure inside the
        fallback decode propagates to ``step``, which fails the batch."""
        journal.emit("fault", t0, label=f"b{rows}:{label}", active=rows, error=f"{type(exc).__name__}: {exc}",
                     traces=[s.trace for s in batch])
        self._decode(batch)

    def _emit(self, seq: _Sequence, tok: int, now: float) -> None:
        seq.out.append(tok)
        self.ledger.token(seq.req.id)
        if self.metrics is not None:
            self._m_tokens.inc()
            t_prev = getattr(seq, "_last_tok_t", None)
            if t_prev is not None:
                self._m_itl.observe(now - t_prev)
            seq._last_tok_t = now
        if tok == seq.eos_id or len(seq.out) >= seq.req.max_new_tokens:
            if self.prefix is not None and seq.fill > seq.prompt_len:
                # multi-turn sharing: publish the full blocks the decode
                # extended (K/V written through position fill-1; a round's
                # stale tail lives past fill, in blocks this never reaches)
                written = np.concatenate([np.asarray(seq.req.prompt, np.int32),
                                          np.asarray(seq.out, np.int32)])[: seq.fill]
                self.prefix.insert(written, seq.blocks, adapter=seq.adapter_id)
            self.scheduler.finish(seq, now)
            self._record_terminal(seq, now)
        else:
            seq.last_token = tok
