"""The continuous-batching serving engine over the paged KV pool.

Counterpart of the core of ``dmlcloud_tpu/serve/engine.py``: ``ServeEngine``
(:335) in its plain decode mode, with ``_paged_step`` (:168), ``submit``
(:798), ``step`` (:1009), ``run`` (:1096), the request lifecycle (``cancel``,
``status``, ``statuses``, ``output``, ``results``, ``idle``,
``leaked_blocks``), ``_prefill_chunk`` (:1339), ``_decode`` (:1393) and
``_emit`` (:1629). One engine owns the device page pool (``kv_pool``) and the
scheduler (``scheduler``) and runs the serving loop

    admit waiting requests -> one prefill chunk -> one decode batch

per :meth:`ServeEngine.step`. The decode batch advances every running stream
however much prefill is pending, so a long prompt never stalls running
generations; a stream that emits EOS frees its slot and blocks before the
next step and the next waiting request takes them: continuous batching, no
drain barrier. The decode math is ``models.generate.decode_step`` with
``pages=(tables, fill)`` steering it through the pool, so greedy output is
token-identical to serial ``generate``.

Per-request sampling: ``temperature``/``top_k``/``top_p``/``eos_id`` ride each
request and enter the step as ``[B]`` tensors
(``models.generate.sample_logits_batched``), so one batch may mix greedy and
sampled rows; a batch with no sampled row takes the argmax alone. The batch's
new tokens come to the host once per device call, never once per row.

Every request ends in exactly one terminal status (``ok | cancelled |
deadline_exceeded | shed | error``) through one exit path
(``Scheduler.terminate``, which releases its blocks at any phase). A step that
raises fails only the requests it was advancing (status ``error``, logged with
its traceback) and the engine keeps serving the others.

``prepare_decode_params`` runs once at construction, so an int8 model
(``models.quant.quantize_tree``) serves with its kernels int8.

Not ported yet, each raising ``NotImplementedError`` when given: speculative
and Medusa decoding, LoRA adapters and the prefix cache (ROADMAP Queue 1
item 10), the ledger, metrics, SLOs, watchdog, preemption and drain
(the serve telemetry and drain), the construction-time IR verify (item 13)
and ``hbm_budget``. ``batch_buckets``/``table_buckets`` pad shapes for
XLA's compile cache in the reference; the port has no compile cache, so for
a dense model they pad nothing: each call runs at its batch's own shape, and
the tokens are the same. An MoE model is padded as the reference pads it:
its routing sees every row, padding too (the capacity grows with the token
count), so each prefill chunk runs at ``prefill_chunk`` tokens and each
decode batch at its power-of-two bucket (``batch_buckets``), the padded rows
token 0 with no blocks.
"""

from __future__ import annotations

import collections
import logging
import time
from typing import Any, Callable

import numpy as np
import torch

from ..models.generate import decode_step, sample_logits_batched
from ..models.moe import MoEMLP
from ..models.quant import prepare_decode_params
from .kv_pool import KVBlockPool
from .scheduler import Scheduler, Request, _Sequence

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


def _paged_step(model, pools, tables, fill, tokens, last_idx, generator, temperature, top_k, top_p, sample: bool):
    """One engine step (a prefill chunk or a decode batch): write ``tokens``'
    K/V through the block tables, read each row's logits at ``last_idx`` and
    pick the next token with each row's parameters (the argmax alone when no
    row samples). Returns the tokens ``[B]`` on the device."""
    logits, pools = decode_step(model, tokens, pools, pages=(tables, fill))
    last = logits.gather(1, last_idx[:, None, None].expand(-1, 1, logits.shape[-1]))[:, 0]  # [B, V]
    if not sample:
        return last.argmax(-1), pools
    return sample_logits_batched(last, temperature, top_k, top_p, generator), pools


#: constructor arguments of the reference that wait for a later slice: their
#: defaults, and what they wait for
_NOT_PORTED = {
    "spec_k": (0, "speculative decoding (ROADMAP Queue 1 item 10)"),
    "draft_model": (None, "speculative decoding (ROADMAP Queue 1 item 10)"),
    "draft_params": (None, "speculative decoding (ROADMAP Queue 1 item 10)"),
    "draft_num_blocks": (None, "speculative decoding (ROADMAP Queue 1 item 10)"),
    "medusa_k": (0, "Medusa decoding (ROADMAP Queue 1 item 10)"),
    "medusa_heads": (None, "Medusa decoding (ROADMAP Queue 1 item 10)"),
    "adapters": (None, "multi-tenant LoRA adapters (ROADMAP Queue 1 item 10)"),
    "prefix_cache": (False, "prefix sharing (ROADMAP Queue 1 item 10)"),
    "run_dir": (None, "the serve telemetry and drain (ROADMAP Queue 1 item 10)"),
    "drain_budget_s": (5.0, "the serve telemetry and drain (ROADMAP Queue 1 item 10)"),
    "preemption": (None, "the serve telemetry and drain (ROADMAP Queue 1 item 10)"),
    "watchdog": (None, "the serve telemetry and drain (ROADMAP Queue 1 item 10)"),
    "slos": (None, "the serve telemetry and drain (ROADMAP Queue 1 item 10)"),
    "metrics": (None, "the serve telemetry and drain (ROADMAP Queue 1 item 10)"),
    "ledger_max_records": (None, "the serve telemetry and drain (ROADMAP Queue 1 item 10)"),
    "verify": (None, "the IR verifier (ROADMAP Queue 1 item 13)"),
    "hbm_budget": (None, "the IR verifier's memory check (ROADMAP Queue 1 item 13)"),
}


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
    - ``cache_dtype``: the pages' dtype (default the model's compute dtype).
    - ``max_waiting``/``shed_policy``/``fairness``/``drr_quantum``: overload
      control (``Scheduler``); ``clock`` is the time source of deadlines and
      the per-request timestamps; ``max_done`` bounds the terminal records
      kept (None: all).
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
        generator: torch.Generator | None = None,
        cache_dtype: torch.dtype | None = None,
        max_waiting: int | None = None,
        shed_policy: str = "reject",
        fairness: str = "fifo",
        drr_quantum: int | None = None,
        clock: Callable[[], float] = time.perf_counter,
        max_done: int | None = None,
        **not_ported: Any,
    ):
        for name, value in not_ported.items():
            if name not in _NOT_PORTED:
                raise TypeError(f"ServeEngine() got an unexpected keyword argument {name!r}")
            default, what = _NOT_PORTED[name]
            if value != default:
                raise NotImplementedError(f"ServeEngine({name}=...) needs {what}, which is not ported yet")
        del table_buckets  # XLA compile-cache buckets: nothing to pad here
        cfg = model.cfg
        #: an MoE model runs the reference's padded shapes (module docstring)
        self._moe = any(isinstance(m, MoEMLP) for m in model.modules())
        self.batch_buckets = tuple(sorted({int(b) for b in batch_buckets})) if batch_buckets else _pow2_buckets(
            max_slots)
        # one-time preparation: int8 kernels stay int8 (models/quant.py)
        self.model = model = prepare_decode_params(model, cfg.dtype)
        self.device = model.embed.weight.device
        max_table = -(-cfg.max_seq_len // block_size)
        if num_blocks is None:
            num_blocks = max_slots * max_table
        self.pool = KVBlockPool.for_model(model, num_blocks=num_blocks, block_size=block_size, dtype=cache_dtype,
                                          device=self.device)
        self.scheduler = Scheduler(self.pool, max_slots, prefill_chunk, max_waiting=max_waiting,
                                   shed_policy=shed_policy, fairness=fairness, drr_quantum=drr_quantum)
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
        ``deadline_s`` is a budget from now, after which the request ends
        ``deadline_exceeded`` at whatever phase it is in; ``priority`` matters
        only to shed-victim selection; ``tenant`` keys the fairness scheduler.
        The returned id's status may already be ``shed`` when the bounded
        queue chose the arrival as its victim. ``token`` is an idempotency
        token: one already accepted raises :class:`DuplicateRequest`.
        ``adapter`` (a LoRA tenant) and ``trace`` (a request-trace id) wait for
        adapters and the serve telemetry and raise when given."""
        if adapter is not None:
            raise NotImplementedError("submit(adapter=...) needs multi-tenant LoRA adapters in the engine (ROADMAP "
                                      "Queue 1 item 10), which are not ported yet")
        if trace is not None:
            raise NotImplementedError("submit(trace=...) needs the serve telemetry (ROADMAP Queue 1 item 10), which "
                                      "is not ported yet")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("prompt must contain at least one token")
        if prompt.size + int(max_new_tokens) > self.model.cfg.max_seq_len:
            raise ValueError(f"prompt ({prompt.size}) + max_new_tokens ({max_new_tokens}) exceeds max_seq_len "
                             f"({self.model.cfg.max_seq_len})")
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError(f"deadline_s must be > 0, got {deadline_s}")
        if token is not None and token in self._tokens:
            raise DuplicateRequest(token, self._tokens[token])
        now = self.clock()
        rid = self._next_id
        self._next_id += 1
        req = Request(prompt=prompt, max_new_tokens=int(max_new_tokens), temperature=temperature, top_k=top_k,
                      top_p=top_p, eos_id=eos_id, deadline_s=deadline_s, priority=int(priority), tenant=tenant,
                      id=rid)
        seq = _Sequence(
            req=req, arrival=now, deadline=None if deadline_s is None else now + float(deadline_s),
            tenant=tenant if tenant is not None else "", priority=int(priority), token=token,
            temperature=self._temperature if temperature is None else float(temperature),
            top_k=self._top_k if top_k is None else int(top_k),
            top_p=self._top_p if top_p is None else float(top_p),
            eos_id=self.eos_id if eos_id is None else int(eos_id),
        )
        shed = self.scheduler.submit(seq)  # validates; raising records nothing
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
        """Cancel a live request at whatever phase it is in; its blocks are
        released at once and its status becomes ``cancelled``. False when the
        request is unknown or already terminal."""
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
        """Blocks still live; 0 whenever the engine is :attr:`idle`."""
        return self.pool.num_live

    # -- terminal bookkeeping ------------------------------------------------
    def _finalize(self, seq: _Sequence, now: float, status: str) -> bool:
        """The engine half of the one exit path: scheduler terminate (queue
        removal, every block released), then retention. False when already
        terminal."""
        if not self.scheduler.terminate(seq, now, status):
            return False
        self._record_terminal(seq)
        return True

    def _record_terminal(self, seq: _Sequence) -> None:
        rid = seq.req.id
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
        for s in seqs:
            self._finalize(s, now, "error")

    # -- the serving loop ----------------------------------------------------
    def step(self) -> bool:
        """One engine iteration: expire deadlines, admit, one prefill chunk,
        one decode batch. Returns whether any device work ran. A failure in
        either device phase fails only the requests it was advancing."""
        now = self.clock()
        for seq in self.scheduler.expire(now):
            self._record_terminal(seq)  # the scheduler released its blocks
        self.scheduler.admit(now)
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
                self._decode(batch)
            except Exception as exc:  # noqa: BLE001 -- isolate to these rows
                self._fail(batch, exc)
            did = True
        return did

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

    # -- device calls --------------------------------------------------------
    def _call(self, seqs, tables: np.ndarray, fill: np.ndarray, tokens: np.ndarray, last_idx: np.ndarray):
        """One ``_paged_step`` on the batch ``seqs`` (and any padded rows past
        them, greedy); the new tokens come back to the host in one copy."""
        dev = self.device
        as_dev = lambda a: torch.from_numpy(a).to(dev, non_blocking=True)
        pad = tables.shape[0] - len(seqs)
        tok, pools = _paged_step(
            self.model, self.pool.pools, as_dev(tables), as_dev(fill), as_dev(tokens), as_dev(last_idx),
            self.generator,
            torch.tensor([s.temperature for s in seqs] + [0.0] * pad, dtype=torch.float32, device=dev),
            torch.tensor([s.top_k for s in seqs] + [0] * pad, dtype=torch.long, device=dev),
            torch.tensor([s.top_p for s in seqs] + [1.0] * pad, dtype=torch.float32, device=dev),
            sample=any(s.temperature > 0 for s in seqs),
        )
        self.pool.swap(pools)
        return tok.cpu().numpy()  # the per-call host sync: the tokens ARE the output

    def _table_rows(self, seqs, nb: int) -> np.ndarray:
        rows = np.full((len(seqs), nb), self.pool.sentinel, np.int64)
        for i, s in enumerate(seqs):
            blocks = s.blocks[:nb]
            rows[i, : len(blocks)] = blocks
        return rows

    def _prefill_chunk(self, seq: _Sequence) -> None:
        c = self.scheduler.prefill_chunk
        n = min(c, seq.prompt_len - seq.fill)
        tokens = np.zeros((1, c if self._moe else n), np.int64)
        tokens[0, :n] = seq.req.prompt[seq.fill : seq.fill + n]
        nb = self.pool.blocks_for(seq.fill + n)
        tok = self._call([seq], self._table_rows([seq], nb), np.asarray([seq.fill], np.int64), tokens,
                         np.asarray([n - 1], np.int64))
        seq.fill += n
        if seq.fill >= seq.prompt_len:
            # the last prompt position's logits ARE the first token:
            # time-to-first-token ends here, before any decode step
            now = self.clock()
            seq.first_token = now
            self.scheduler.prefill_done(seq)
            seq.prev_token = int(seq.req.prompt[-1])
            self._emit(seq, int(tok[0]), now)

    def _decode(self, batch) -> None:
        nb = max(s.needed_blocks(self.pool.block_size) for s in batch)
        rows = len(batch)
        if self._moe:
            rows = next((b for b in self.batch_buckets if b >= rows), rows)
        tables = np.full((rows, nb), self.pool.sentinel, np.int64)
        tables[: len(batch)] = self._table_rows(batch, nb)
        fill = np.zeros(rows, np.int64)
        tokens = np.zeros((rows, 1), np.int64)
        for i, s in enumerate(batch):
            fill[i], tokens[i, 0] = s.fill, s.last_token
        tok = self._call(batch, tables, fill, tokens, np.zeros(rows, np.int64))
        now = self.clock()
        for i, s in enumerate(batch):
            s.fill += 1  # the fed token's K/V landed at its position
            self._emit(s, int(tok[i]), now)

    def _emit(self, seq: _Sequence, tok: int, now: float) -> None:
        seq.out.append(tok)
        if tok == seq.eos_id or len(seq.out) >= seq.req.max_new_tokens:
            self.scheduler.finish(seq, now)
            self._record_terminal(seq)
        else:
            seq.last_token = tok
