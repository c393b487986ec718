"""The continuous-batching scheduler: FIFO admission, no drain barrier.

Counterpart of ``dmlcloud_tpu/serve/scheduler.py``: ``Request``,
``_Sequence`` and ``Scheduler`` (:110-516), whole and host-only; the
arithmetic and every decision are the reference's. The contract, in order of
importance:

1. **No starvation.** Admission is STRICT FIFO with full reservation: the
   head of the waiting queue is admitted the moment a decode slot opens AND
   the pool can cover its worst case (``ceil((prompt + max_new + lookahead)
   / block_size)`` blocks); nobody behind it may jump the queue. Every
   admitted request holds all the blocks it can ever need, so it cannot
   deadlock mid-decode, and the head always eventually admits.
2. **No drain barrier.** A sequence that emits EOS (or hits its token
   budget) releases its slot and blocks at once; the next waiting request
   joins the running batch at the next step.
3. **Prefill never stalls decode.** A newly admitted prompt is processed in
   ``prefill_chunk``-token chunks, at most one chunk per engine step,
   interleaved with the decode batch of the running streams.

Overload control: every request ends in exactly one of
:data:`TERMINAL_STATUSES` through ONE exit path (:meth:`Scheduler.terminate`,
which releases every block it owns); ``max_waiting`` bounds the waiting queue
and ``shed_policy`` picks the victim on overflow (``"reject"`` the arrival,
``"oldest-deadline"`` the lowest priority, then the earliest deadline);
``fairness="tenant"`` admits by deficit round-robin over per-tenant FIFO
queues with ``drr_quantum`` block-credits per ring visit (a head that fits
its deficit but not the pool is sticky, so starvation-freedom survives).

The hooks for a second (draft) pool, a speculative ``lookahead`` and a prefix
cache are the reference's too; the port's engine passes none of them yet
(speculative decoding and prefix sharing wait for ROADMAP Queue 1 items 9
and 10). The scheduler is pure host-side bookkeeping; the engine owns every
device interaction.
"""

from __future__ import annotations

import collections
import itertools
import math
from dataclasses import dataclass, field
from typing import Any, Iterator

import numpy as np

from .kv_pool import KVBlockPool

__all__ = ["Request", "Scheduler", "TERMINAL_STATUSES"]

#: Every request ends in exactly one of these (engine ``status(rid)``).
TERMINAL_STATUSES = ("ok", "cancelled", "deadline_exceeded", "shed", "error")


@dataclass(eq=False)  # identity comparison: prompt arrays don't define ==
class Request:
    """One generation request. ``prompt`` is a 1-D int32 token array;
    ``adapter`` names a tenant adapter in the engine's ``AdapterSet``
    (None = base model). The sampling knobs (``temperature``/``top_k``/
    ``top_p``/``eos_id``) are PER REQUEST — they ride the decode step as
    traced per-row arrays, so one compiled engine serves mixed
    greedy/sampled tenants in a single batch; None inherits the engine's
    default. ``deadline_s`` is a relative budget from arrival (None =
    none); ``priority`` orders SHED-VICTIM selection only (lower sheds
    first); ``tenant`` keys the fairness scheduler (None = the adapter
    name, or the shared default tenant)."""

    prompt: Any
    max_new_tokens: int = 32
    adapter: str | None = None
    temperature: float | None = None
    top_k: int | None = None
    top_p: float | None = None
    eos_id: int | None = None
    deadline_s: float | None = None
    priority: int = 0
    tenant: str | None = None
    id: int = -1  # assigned by the engine at submit


@dataclass(eq=False)  # identity comparison (deque/list membership tests)
class _Sequence:
    """Runtime state of one admitted request (engine-internal)."""

    req: Request
    arrival: float
    blocks: list[int] = field(default_factory=list)
    draft_blocks: list[int] = field(default_factory=list)  # spec mode only
    fill: int = 0  # cache slots written (prefill progress, then decode)
    out: list[int] = field(default_factory=list)  # emitted tokens
    last_token: int = 0  # next decode step's input
    prev_token: int = 0  # the token before it (spec rounds feed two)
    admitted: float | None = None
    first_token: float | None = None
    finished: float | None = None
    adapter_id: int = 0
    # lifecycle: absolute deadline (arrival + deadline_s), fairness tenant,
    # shed priority, and the terminal status (None while live)
    deadline: float | None = None
    tenant: str = ""
    priority: int = 0
    status: str | None = None
    # caller-supplied idempotency token (engine dedups on it — a router
    # retry after an ambiguous failure can never double-admit)
    token: str | None = None
    # trace id stamped on every span this request touches; the router
    # mints one per logical request and REUSES it across failover retries
    # so the whole causal chain links into a single trace
    trace: str | None = None
    # prefix-cache state: leading table entries mapped READ-ONLY from the
    # radix tree (refcount > 1 is the ground truth; this count is the
    # observable), matched tokens, and spare blocks reserved for COW forks
    shared: int = 0
    cached_tokens: int = 0
    cow_spare: int = 0
    # resolved per-row sampling params (request value or engine default)
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    eos_id: int = -1

    @property
    def prompt_len(self) -> int:
        return int(np.shape(self.req.prompt)[0])

    @property
    def prefilled(self) -> bool:
        return self.fill >= self.prompt_len

    def needed_blocks(self, block_size: int, lookahead: int = 0) -> int:
        """Blocks covering the next step's reads AND writes: position
        ``fill`` for plain decode, through ``fill + lookahead`` when a
        speculative round writes ``lookahead`` proposals past the pending
        token — the live prefix plus this round's worst case, which is
        what the decode batch actually gathers (the full reservation is
        admission's concern)."""
        return -(-(self.fill + 1 + int(lookahead)) // block_size)


class Scheduler:
    """FIFO continuous-batching admission over one :class:`KVBlockPool`
    (plus the draft model's pool in speculative mode). ``lookahead`` is
    the per-round speculative overshoot reserved per request (``spec_k``
    for a spec engine, 0 otherwise); ``prefix_cache`` is the engine's
    prefix cache (the reference's ``PrefixCache`` interface: ``match``,
    ``lock``, ``evict``; None = no sharing). ``max_waiting`` bounds the
    admission queue (None = unbounded), ``shed_policy`` picks the victim
    on overflow, ``fairness="tenant"`` switches admission to deficit
    round-robin over per-tenant FIFO queues with ``drr_quantum``
    block-credits per ring visit."""

    def __init__(
        self,
        pool: KVBlockPool,
        max_slots: int,
        prefill_chunk: int,
        *,
        draft_pool: KVBlockPool | None = None,
        lookahead: int = 0,
        prefix_cache: Any = None,
        max_waiting: int | None = None,
        shed_policy: str = "reject",
        fairness: str = "fifo",
        drr_quantum: int | None = None,
    ):
        if max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {max_slots}")
        if prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got {prefill_chunk}")
        if lookahead < 0:
            raise ValueError(f"lookahead must be >= 0, got {lookahead}")
        if max_waiting is not None and max_waiting < 1:
            raise ValueError(f"max_waiting must be >= 1, got {max_waiting}")
        if shed_policy not in ("reject", "oldest-deadline"):
            raise ValueError(f"unknown shed_policy {shed_policy!r}")
        if fairness not in ("fifo", "tenant"):
            raise ValueError(f"unknown fairness {fairness!r}")
        self.pool = pool
        self.draft_pool = draft_pool
        self.prefix = prefix_cache
        self.lookahead = int(lookahead)
        self.max_slots = int(max_slots)
        self.prefill_chunk = int(prefill_chunk)
        self.max_waiting = None if max_waiting is None else int(max_waiting)
        self.shed_policy = shed_policy
        self.fairness = fairness
        self.drr_quantum = int(
            drr_quantum
            if drr_quantum is not None
            else max(1, pool.blocks_for(prefill_chunk))
        )
        if self.drr_quantum < 1:
            raise ValueError(f"drr_quantum must be >= 1, got {drr_quantum}")
        self.waiting: collections.deque[_Sequence] = collections.deque()
        self.prefilling: collections.deque[_Sequence] = collections.deque()
        self.running: list[_Sequence] = []
        # tenant-fairness state: per-tenant FIFO queues, the DRR ring of
        # tenants with queued work, and their block-credit deficits
        self._queues: dict[str, collections.deque[_Sequence]] = {}
        self._ring: collections.deque[str] = collections.deque()
        self._deficit: dict[str, float] = {}

    # -- queue state ---------------------------------------------------------
    @property
    def active(self) -> int:
        """Admitted-but-unfinished sequences (holding a decode slot)."""
        return len(self.prefilling) + len(self.running)

    @property
    def num_waiting(self) -> int:
        """Requests queued for admission, across every tenant queue."""
        if self.fairness == "fifo":
            return len(self.waiting)
        return sum(len(q) for q in self._queues.values())

    @property
    def idle(self) -> bool:
        return not (self.num_waiting or self.prefilling or self.running)

    def depth(self) -> int:
        """Requests waiting for admission (the queue-depth observable)."""
        return self.num_waiting

    def iter_waiting(self) -> Iterator[_Sequence]:
        """Every waiting sequence (ring order across tenant queues)."""
        if self.fairness == "fifo":
            return iter(self.waiting)
        return itertools.chain.from_iterable(
            self._queues[t] for t in self._ring if t in self._queues
        )

    # -- lifecycle -----------------------------------------------------------
    def reservation(self, seq: _Sequence) -> int:
        """The full worst-case block reservation of one request: every
        slot its committed tokens can occupy PLUS the ``lookahead``
        speculative positions the final round may write past them."""
        return self.pool.blocks_for(
            seq.prompt_len + seq.req.max_new_tokens + self.lookahead
        )

    def submit(self, seq: _Sequence) -> list[_Sequence]:
        """Queue a request. Rejects one that could NEVER be admitted —
        a worst case larger than the whole pool would starve the queue
        behind it forever under strict FIFO.

        Returns the sequences SHED by overload control: empty when the
        queue has room, else the victim ``shed_policy`` chose — possibly
        ``seq`` itself, which is then never enqueued. The caller owns
        stamping each victim terminal (:meth:`terminate`)."""
        need = self.reservation(seq)
        pools = [self.pool] + ([self.draft_pool] if self.draft_pool else [])
        for pool in pools:
            if need > pool.num_blocks:
                raise ValueError(
                    f"request needs {need} blocks worst-case but the pool only has "
                    f"{pool.num_blocks}; raise num_blocks or lower max_new_tokens"
                )
        if seq.req.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        shed: list[_Sequence] = []
        if self.max_waiting is not None and self.num_waiting >= self.max_waiting:
            shed.append(self._shed_victim(seq))
        if seq not in shed:
            self._enqueue(seq)
        return shed

    def _shed_victim(self, incoming: _Sequence) -> _Sequence:
        """Pick the overflow victim. ``reject``: the arrival. ``oldest-
        deadline``: lowest priority first, then earliest deadline (no
        deadline = latest); the arrival breaks ties — it holds nothing."""
        if self.shed_policy == "reject":
            return incoming
        return min(
            [*self.iter_waiting(), incoming],
            key=lambda s: (
                s.priority,
                s.deadline if s.deadline is not None else math.inf,
                0 if s is incoming else 1,
            ),
        )

    def _enqueue(self, seq: _Sequence) -> None:
        if self.fairness == "fifo":
            self.waiting.append(seq)
            return
        q = self._queues.get(seq.tenant)
        if q is None:
            q = self._queues[seq.tenant] = collections.deque()
        if not q and seq.tenant not in self._ring:
            self._ring.append(seq.tenant)
            self._deficit.setdefault(seq.tenant, 0.0)
        q.append(seq)

    def _discard_waiting(self, seq: _Sequence) -> None:
        """Forgiving removal from the waiting structures (no-op when the
        sequence is not queued — e.g. a rejected arrival)."""
        if self.fairness == "fifo":
            if seq in self.waiting:
                self.waiting.remove(seq)
            return
        q = self._queues.get(seq.tenant)
        if q is not None and seq in q:
            q.remove(seq)
            if not q:
                self._retire_tenant(seq.tenant)

    def _retire_tenant(self, tenant: str) -> None:
        """Drop an emptied tenant queue from the ring; its deficit resets
        (classic DRR: credit does not accumulate while idle)."""
        self._queues.pop(tenant, None)
        self._deficit.pop(tenant, None)
        if tenant in self._ring:
            self._ring.remove(tenant)

    def _select_head(self) -> _Sequence | None:
        """The ONE request admission may consider this step. FIFO: the
        queue head. Tenant mode: deficit round-robin — visit the ring
        head; serve it while its deficit covers its head request's full
        reservation, else grant a quantum and rotate. Terminates because
        every full ring pass grows every deficit by a quantum."""
        if self.fairness == "fifo":
            return self.waiting[0] if self.waiting else None
        while self._ring:
            tenant = self._ring[0]
            q = self._queues.get(tenant)
            if not q:
                self._retire_tenant(tenant)
                continue
            head = q[0]
            if self._deficit[tenant] >= self.reservation(head):
                return head
            self._deficit[tenant] += self.drr_quantum
            self._ring.rotate(-1)
        return None

    def _pop_admitted(self, head: _Sequence) -> None:
        """Dequeue an admitted head and charge its tenant's deficit."""
        if self.fairness == "fifo":
            self.waiting.popleft()
            return
        q = self._queues[head.tenant]
        q.popleft()
        self._deficit[head.tenant] -= self.reservation(head)
        if not q:
            self._retire_tenant(head.tenant)

    def admit(self, now: float) -> list[_Sequence]:
        """Admit from the head of the waiting queue while a slot AND the
        head's full reservation fit — in EVERY pool, checked before
        either allocation so a partial admit can never leak blocks.
        Returns the newly admitted sequences (blocks already allocated,
        prefill pending).

        With a prefix cache: the head's cached prefix is matched and
        LOCKED first (lock pins the shared blocks, so the eviction that
        follows can never reclaim what the head is about to map — the
        match→admit race the property tests exercise), shared blocks are
        discounted from the reservation, and an exact full-block match
        adds one COW spare (divergence rolls back one token, so the final
        shared block WILL be forked). When the discounted need still
        exceeds the free list, LRU leaves are evicted; if that is not
        enough, the locked prefix is released and the head waits — strict
        FIFO (sticky DRR head in tenant mode), no leaked references."""
        admitted = []
        while self.active < self.max_slots:
            head = self._select_head()
            if head is None:
                break
            need = self.reservation(head)
            shared_blocks: list[int] = []
            cached = 0
            if self.prefix is not None:
                shared_blocks, cached = self.prefix.lock(
                    self.prefix.match(head.req.prompt, adapter=head.adapter_id),
                    )
            spare = 1 if cached >= head.prompt_len else 0  # guaranteed COW fork
            need_new = need - len(shared_blocks) + spare
            if self.prefix is not None and need_new > self.pool.num_free:
                self.prefix.evict(need_new)  # leaf-first LRU; pinned blocks safe
            short = need_new > self.pool.num_free or (
                self.draft_pool is not None and need > self.draft_pool.num_free
            )
            if short:
                if shared_blocks:
                    self.pool.release(shared_blocks)  # unlock: no leaked refs
                break  # strict FIFO: nobody may overtake the head
            self._pop_admitted(head)
            head.blocks = shared_blocks + self.pool.alloc(need_new)
            head.shared = len(shared_blocks)
            head.cached_tokens = cached
            head.cow_spare = spare
            # chunked prefill starts at the divergence point; at least the
            # final prompt token must run for its logits (first token)
            head.fill = min(cached, head.prompt_len - 1)
            if self.draft_pool is not None:
                head.draft_blocks = self.draft_pool.alloc(need)
            head.admitted = now
            self.prefilling.append(head)
            admitted.append(head)
        return admitted

    def next_prefill(self) -> _Sequence | None:
        """The sequence owed the next prefill chunk (oldest first)."""
        return self.prefilling[0] if self.prefilling else None

    def prefill_done(self, seq: _Sequence) -> None:
        """Move a fully-prefilled sequence into the decode batch."""
        self.prefilling.remove(seq)
        self.running.append(seq)

    def terminate(self, seq: _Sequence, now: float, status: str) -> bool:
        """The ONE exit path: remove ``seq`` from whichever queue holds
        it and release EVERY resource it owns — target blocks (shared
        prefix references and unused COW spares live in ``seq.blocks``,
        so one release covers them) and draft blocks — then stamp the
        terminal ``status``. Idempotent: a second terminate is a no-op
        returning False, so a cancel racing a deadline (or a fault
        racing either) can never double-free."""
        if status not in TERMINAL_STATUSES:
            raise ValueError(f"unknown terminal status {status!r}")
        if seq.status is not None:
            return False
        if seq in self.running:
            self.running.remove(seq)
        elif seq in self.prefilling:
            self.prefilling.remove(seq)
        else:
            self._discard_waiting(seq)
        if seq.blocks:
            self.pool.free(seq.blocks)
        seq.blocks = []
        seq.shared = 0
        seq.cow_spare = 0
        if self.draft_pool is not None and seq.draft_blocks:
            self.draft_pool.free(seq.draft_blocks)
        seq.draft_blocks = []
        seq.finished = now
        seq.status = status
        return True

    def expire(self, now: float) -> list[_Sequence]:
        """Terminate every request whose deadline has passed — at ANY
        phase (queued, mid-prefill, mid-decode); returns the casualties
        so the engine can record them."""
        expired = [
            s
            for s in [*self.iter_waiting(), *self.prefilling, *self.running]
            if s.deadline is not None and now >= s.deadline
        ]
        for s in expired:
            self.terminate(s, now, "deadline_exceeded")
        return expired

    def finish(self, seq: _Sequence, now: float) -> None:
        """Release a finished sequence's slot and blocks IMMEDIATELY —
        the no-drain-barrier property lives here (both pools in spec
        mode: the draft pages recycle with the target's)."""
        self.terminate(seq, now, "ok")

    def decode_batch(self) -> list[_Sequence]:
        """The sequences decoding this step (stable submission order)."""
        return list(self.running)
