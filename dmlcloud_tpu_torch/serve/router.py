"""The multi-replica front door: health-checked routing, failover, drain.

Counterpart of ``dmlcloud_tpu/serve/router.py``, with the same names,
arguments, validation messages and decisions: ``_Replica`` (:85),
``_Record`` (:111), ``Router`` (:140) with ``submit`` (:203), the per-tenant
DRR placement (``_place_pending`` :525, ``_choose_replica`` :485, ``_place``
:504), heartbeats and the circuit breaker (``_fail_replica`` :383,
``_placeable`` :465), the operator controls (``kill_replica``,
``stall_replica``, ``drain_replica`` :329-381), ``_finish_drains`` (:629),
``step``/``run``/``serve_trace`` and the observability surface
(``ttfts`` :694, ``summary``, ``metrics_text`` :738).

One ``ServeEngine`` drives one card; traffic needs N of them behind a
single submit/step surface that keeps the engine's promises (one terminal
status per request, zero leaked blocks, tenant fairness) when a whole
replica dies, stalls, or drains mid-request. :class:`Router` is that
surface over in-process engine replicas (the process boundary is
simulated), written against observable engine behaviour rather than shared
Python state.

**Health.** Each replica carries a heartbeat: its ``last_beat`` advances
every time ``step()`` returns. A replica that raises out of ``step()`` or
goes ``heartbeat_timeout_s`` without beating is marked unhealthy and its
live requests are re-routed. Everything reads ONE injectable ``clock=``, so
the failure detector is unit-testable with a fake clock. The replicas must
run on the router's clock too: :meth:`Router.ttfts` subtracts the router's
arrival from an engine ledger's ``first_token``.

**Failover, at-most-once.** The router owns the request of record: the
prompt and submit kwargs stay with the router record, so an incomplete
request on a dead replica is re-submitted to a healthy sibling from scratch
(re-prefill, no cross-replica KV handoff). Each record carries a router-side
idempotency token forwarded to ``ServeEngine.submit(token=)``; if a "dead"
replica actually admitted the original, the retry raises
:class:`~dmlcloud_tpu_torch.serve.engine.DuplicateRequest` and the router
re-attaches to the existing admission instead of double-admitting. Retries
are bounded (``max_retries``) with exponential backoff (``backoff_base_s``
doubling per attempt); a request that exhausts them ends terminal
``error``. One trace id, ``tr-<rid>``, follows the request through every
placement (``submit(trace=)``), while the token rotates (``.fN`` after a
transient failure, ``.m`` after a drain migration).

**Placement.** Per-tenant deficit round-robin across replicas: tenants with
pending work sit on a ring, each visit grants a quantum of block-credits,
and a tenant places its FIFO head only when its deficit covers the
request's full block reservation. Within a placement the replica is chosen
by (1) prefix affinity, the deepest stable content address of the prompt
(:func:`~dmlcloud_tpu_torch.serve.prefix_cache.prefix_keys`, the reference's
integers) naming the replica that served that template last, then (2)
least outstanding load, ties broken by replica order. A per-replica circuit
breaker guards both: ``breaker_threshold`` consecutive failures trip it
open, after ``breaker_cooldown_s`` it goes half-open and risks ONE probe,
only a probe that terminates ``ok`` closes it, and a failed probe doubles
the cooldown.

**Replica chaos and drain.** ``ChaosMonkey.attach_router`` injects
``replica_kill`` (permanent death: the router reaps the in-process engine,
cancelling every live request so its pages come back) and
``replica_stall`` (missed steps; the heartbeat detector decides) into the
monkey's replayable event log. :meth:`Router.drain_replica` is the graceful
exit: admission to that replica closes, its queued requests migrate to
siblings, its running requests finish in place, and when it empties the
replica is removed and a ``requeue.json`` verdict records the drain.

On the card a replica's ``step()`` raising is handled as the reference
handles it, a replica failure; a CUDA error, though, is sticky and poisons
every replica of the process, so a caller that drives replicas on one card
should treat an unplanted failure as fatal (``chip_smoke.py`` phase 20
does).
"""

from __future__ import annotations

import collections
import time
from typing import Any, Callable, Iterable

import numpy as np

from ..telemetry import journal
from .engine import DuplicateRequest, ServeEngine
from .prefix_cache import prefix_keys
from .scheduler import TERMINAL_STATUSES

__all__ = ["Router"]


class _Replica:
    """Router-side state of one engine replica."""

    __slots__ = (
        "name", "engine", "alive", "removed", "draining", "last_beat",
        "stall_steps", "consec_failures", "breaker", "breaker_until",
        "cooldown", "probe_rid", "drain_started", "migrated",
    )

    def __init__(self, name: str, engine: ServeEngine, now: float, cooldown: float):
        self.name = name
        self.engine = engine
        self.alive = True  # False once killed or drain-removed
        self.removed = False  # drained out (vs died)
        self.draining = False
        self.last_beat = now
        self.stall_steps = 0  # injected: skip this many step() calls
        self.consec_failures = 0
        self.breaker = "closed"  # closed | open | half_open
        self.breaker_until = 0.0
        self.cooldown = cooldown
        self.probe_rid: int | None = None  # the half-open probe request
        self.drain_started: float | None = None
        self.migrated = 0  # queued requests moved off during drain


class _Record:
    """The router's request of record — survives its replica."""

    __slots__ = (
        "rid", "prompt", "max_new", "kwargs", "tenant", "token", "trace",
        "status", "replica", "engine_rid", "retries", "not_before",
        "affinity", "arrival",
    )

    def __init__(self, rid, prompt, max_new, kwargs, tenant, token, affinity, now):
        self.rid = rid
        self.prompt = prompt
        self.max_new = int(max_new)
        self.kwargs = kwargs  # submit passthrough (deadline_s, priority, ...)
        self.tenant = tenant
        self.token = token
        # one trace id for the request's WHOLE life: the token rotates on
        # failover (.fN suffixes) but the trace never does, so every
        # placement attempt links into a single causal trace
        self.trace = f"tr-{rid}"
        self.status: str | None = None  # router-terminal, else None
        self.replica: str | None = None  # current assignment
        self.engine_rid: int | None = None
        self.retries = 0  # failure-driven resubmits (bounded; migrations free)
        self.not_before = now  # backoff gate for the next placement
        self.affinity = affinity  # deepest stable prefix key, or None
        self.arrival = now


class Router:
    """Front door over N in-process ``ServeEngine`` replicas (module
    docstring). Replicas must be homogeneous enough to serve any request
    (same model/tokenizer); block geometry is read from the first."""

    def __init__(
        self,
        replicas: Iterable[ServeEngine],
        *,
        clock: Callable[[], float] = time.perf_counter,
        heartbeat_timeout_s: float = 1.0,
        max_retries: int = 2,
        backoff_base_s: float = 0.05,
        breaker_threshold: int = 3,
        breaker_cooldown_s: float = 1.0,
        drr_quantum: int | None = None,
        run_dir: Any = None,
    ):
        engines = list(replicas)
        if not engines:
            raise ValueError("a router needs at least one replica")
        if heartbeat_timeout_s <= 0:
            raise ValueError(f"heartbeat_timeout_s must be > 0, got {heartbeat_timeout_s}")
        if max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {max_retries}")
        if breaker_threshold < 1:
            raise ValueError(f"breaker_threshold must be >= 1, got {breaker_threshold}")
        self.clock = clock
        now = clock()
        self.replicas: dict[str, _Replica] = {}
        for i, eng in enumerate(engines):
            self.replicas[f"r{i}"] = _Replica(f"r{i}", eng, now, float(breaker_cooldown_s))
        self.heartbeat_timeout_s = float(heartbeat_timeout_s)
        self.max_retries = int(max_retries)
        self.backoff_base_s = float(backoff_base_s)
        self.breaker_threshold = int(breaker_threshold)
        self.run_dir = run_dir
        pool = engines[0].pool
        self.drr_quantum = int(
            drr_quantum if drr_quantum is not None
            else max(1, pool.blocks_for(engines[0].scheduler.prefill_chunk))
        )
        self._block_size = pool.block_size
        self._blocks_for = pool.blocks_for
        self._next_id = 0
        self._records: dict[int, _Record] = {}
        # placement state: per-tenant FIFO queues of unplaced records, the
        # DRR ring of tenants with pending work, their block-credit
        # deficits, and the affinity hint table (stable prefix key -> the
        # replica that served that template last)
        self._queues: dict[str, collections.deque[_Record]] = {}
        self._ring: collections.deque[str] = collections.deque()
        self._deficit: dict[str, float] = {}
        self._affinity: dict[tuple[int, int], str] = {}
        #: chaos hook: ``fn("router_step", None)`` each step — may kill or
        #: stall replicas (serve/chaos.py attach_router)
        self.fault_injector: Callable[[str, Any], None] | None = None
        self.steps = 0
        #: failure-handling counters (the drill's observables)
        self.failovers = 0
        self.kills = 0

    # -- submission -----------------------------------------------------------
    def submit(
        self,
        prompt,
        max_new_tokens: int = 32,
        *,
        tenant: str | None = None,
        token: str | None = None,
        **kwargs: Any,
    ) -> int:
        """Queue one request router-wide; returns its ROUTER id (replica
        ids are an implementation detail). Placement happens in
        :meth:`step` under the per-tenant DRR. ``token`` is an optional
        caller idempotency token (defaults to a router-generated one);
        the rest of the kwargs pass through to ``ServeEngine.submit``."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        now = self.clock()
        rid = self._next_id
        self._next_id += 1
        resolved_tenant = tenant if tenant is not None else (kwargs.get("adapter") or "")
        keys = prefix_keys(prompt, self._block_size)
        rec = _Record(
            rid, prompt, max_new_tokens,
            dict(kwargs, tenant=resolved_tenant),
            resolved_tenant, token if token is not None else f"rt-{rid}",
            keys[-1] if keys else None, now,
        )
        self._records[rid] = rec
        self._enqueue(rec)
        return rid

    def _enqueue(self, rec: _Record) -> None:
        q = self._queues.get(rec.tenant)
        if q is None:
            q = self._queues[rec.tenant] = collections.deque()
        if not q and rec.tenant not in self._ring:
            self._ring.append(rec.tenant)
            self._deficit.setdefault(rec.tenant, 0.0)
        q.append(rec)

    def _requeue_front(self, recs: list[_Record]) -> None:
        """Put failed-over records back at the FRONT of their tenant
        queues, oldest last-in — per-tenant FIFO by arrival survives the
        round trip through a dead replica."""
        for rec in sorted(recs, key=lambda r: r.rid, reverse=True):
            q = self._queues.get(rec.tenant)
            if q is None:
                q = self._queues[rec.tenant] = collections.deque()
            if not q and rec.tenant not in self._ring:
                self._ring.append(rec.tenant)
                self._deficit.setdefault(rec.tenant, 0.0)
            q.appendleft(rec)

    # -- status surface -------------------------------------------------------
    def status(self, rid: int) -> str:
        """``queued`` / ``running`` while live (backoff and re-placement
        included), else the ONE router-wide terminal status."""
        rec = self._records.get(rid)
        if rec is None:
            raise KeyError(f"unknown router request id {rid}")
        if rec.status is not None:
            return rec.status
        if rec.replica is not None:
            rep = self.replicas[rec.replica]
            try:
                return rep.engine.status(rec.engine_rid)
            except KeyError:
                return "queued"
        return "queued"

    def statuses(self) -> dict[int, str]:
        return {rid: self.status(rid) for rid in self._records}

    def output(self, rid: int) -> np.ndarray:
        """The emitted tokens of a request that finished ``ok`` — read
        from whichever replica completed it."""
        rec = self._records[rid]
        if rec.replica is None or rec.engine_rid is None:
            raise KeyError(f"request {rid} has no completed output")
        return self.replicas[rec.replica].engine.output(rec.engine_rid)

    def cancel(self, rid: int) -> bool:
        """Cancel router-wide: forwarded to the owning replica when
        placed, locally terminal when still queued."""
        rec = self._records.get(rid)
        if rec is None or rec.status is not None:
            return False
        if rec.replica is not None:
            rep = self.replicas[rec.replica]
            if rep.alive and rep.engine.cancel(rec.engine_rid):
                rec.status = "cancelled"
                return True
            return False
        self._discard_queued(rec)
        rec.status = "cancelled"
        return True

    def _discard_queued(self, rec: _Record) -> None:
        q = self._queues.get(rec.tenant)
        if q is not None and rec in q:
            q.remove(rec)
            if not q:
                self._queues.pop(rec.tenant, None)
                self._deficit.pop(rec.tenant, None)
                if rec.tenant in self._ring:
                    self._ring.remove(rec.tenant)

    @property
    def idle(self) -> bool:
        """Every submitted request terminal and nothing pending."""
        return all(rec.status is not None for rec in self._records.values())

    def healthy(self) -> dict[str, bool]:
        """Per-replica health as the failure detector currently sees it."""
        now = self.clock()
        return {
            name: rep.alive and not rep.removed
            and (now - rep.last_beat) <= self.heartbeat_timeout_s
            for name, rep in self.replicas.items()
        }

    def leaked_blocks(self) -> int:
        """Sum of every replica's leak observable (killed replicas were
        reaped at kill time, so they audit too)."""
        return sum(rep.engine.leaked_blocks() for rep in self.replicas.values())

    # -- chaos / operator controls -------------------------------------------
    def kill_replica(self, name: str, reason: str = "killed") -> None:
        """Simulate replica death: never stepped again, live requests
        failed over, the in-process engine reaped (its live sequences
        cancelled so the pool audit stays meaningful — the stand-in for
        the OS reclaiming a dead process's memory)."""
        rep = self.replicas[name]
        if not rep.alive:
            return
        self._fail_replica(rep, f"killed: {reason}", fatal=True)

    def stall_replica(self, name: str, steps: int) -> None:
        """Simulate a stalled replica: it misses the next ``steps`` step
        calls. Whether that is a blip or a death is the heartbeat
        detector's call, exactly as in production."""
        rep = self.replicas[name]
        if rep.alive:
            rep.stall_steps = max(rep.stall_steps, int(steps))

    def drain_replica(self, name: str, reason: str = "drain requested") -> None:
        """Begin the graceful exit of one replica: no new placements,
        queued requests migrate to siblings now (they hold nothing),
        running requests finish in place; :meth:`step` removes the
        replica once it empties and writes the requeue verdict."""
        rep = self.replicas[name]
        if not rep.alive or rep.draining:
            return
        rep.draining = True
        rep.drain_started = self.clock()
        migrated = []
        for rec in self._records.values():
            if rec.status is not None or rec.replica != name:
                continue
            try:
                st = rep.engine.status(rec.engine_rid)
            except KeyError:
                st = None
            if st == "queued":
                # a queued request holds nothing: cancel it out of the
                # draining replica's queue and re-place it on a sibling.
                # Detach FIRST so the terminal sync never mistakes the
                # migration cancel for a real terminal status. A
                # migration is not a failure retry: no backoff, no
                # budget spent, but a fresh token (the old one stays
                # burned in the draining engine's dedup map).
                erid = rec.engine_rid
                rec.replica = None
                rec.engine_rid = None
                rec.token = f"{rec.token}.m"
                rep.engine.cancel(erid)
                migrated.append(rec)
        self._requeue_front(migrated)
        rep.migrated = len(migrated)

    # -- failure handling -----------------------------------------------------
    def _fail_replica(self, rep: _Replica, reason: str, *, fatal: bool) -> None:
        """Handle one replica failure. ``fatal`` (a kill): the replica is
        never stepped again and its engine is reaped — every live
        sequence cancelled so the pool audit stays meaningful (the
        stand-in for the OS reclaiming a dead process). Transient (a
        ``step()`` raise, a missed heartbeat): the replica stays in the
        pool under circuit-breaker control. Either way its live requests
        re-route with bounded retries and exponential backoff."""
        now = self.clock()
        rep.consec_failures += 1
        if fatal:
            rep.alive = False
            self.kills += 1
        elif rep.breaker == "half_open":
            rep.cooldown *= 2.0  # failed its probe: back off harder
            rep.breaker = "open"
            rep.breaker_until = now + rep.cooldown
            rep.probe_rid = None
        elif rep.breaker == "closed" and rep.consec_failures >= self.breaker_threshold:
            rep.breaker = "open"
            rep.breaker_until = now + rep.cooldown
        failed: list[_Record] = []
        for rec in self._records.values():
            if rec.status is not None or rec.replica != rep.name:
                continue
            try:
                st = rep.engine.status(rec.engine_rid)
            except KeyError:
                st = None
            if st in TERMINAL_STATUSES:
                rec.status = st  # finished before the failure: keep it
                continue
            failed.append(rec)
        retry: list[_Record] = []
        for rec in failed:
            erid = rec.engine_rid
            rec.replica = None
            rec.engine_rid = None
            if not fatal:
                # the replica survives: pull the re-routed request out of
                # it so it cannot burn slots on (or double-complete) work
                # that now belongs to a sibling. The old admission is now
                # DEFINITIVELY cancelled, so the retry gets a fresh token;
                # after a fatal kill the token stays — if the "dead"
                # replica ever sees the retry, dedup re-attaches instead
                # of double-admitting (the at-most-once guard).
                rep.engine.cancel(erid)
                rec.token = f"{rec.token}.f{rec.retries + 1}"
            rec.retries += 1
            if rec.retries > self.max_retries:
                rec.status = "error"
                journal.emit(
                    "failover", now, label=f"req{rec.rid}", request=rec.rid,
                    trace=rec.trace, replica=rep.name,
                    outcome="retries_exhausted",
                )
                # the router-side terminal: stamp the trace the same way
                # the engine's fault path does, so linked_trace_report
                # surfaces the status even when no engine ever erred
                journal.emit(
                    "fault", now, label=f"req{rec.rid}", request=rec.rid,
                    trace=rec.trace, status="error",
                    reason="retries_exhausted",
                )
                continue
            rec.not_before = now + self.backoff_base_s * (2.0 ** (rec.retries - 1))
            self.failovers += 1
            journal.emit(
                "failover", now, label=f"req{rec.rid}", request=rec.rid,
                trace=rec.trace, replica=rep.name, retry=rec.retries,
                reason=reason,
            )
            retry.append(rec)
        self._requeue_front(retry)
        if fatal:
            # reap the in-process engine: cancel everything still live so
            # its pools release (otherwise "dead" pages leak forever)
            for erid, st in list(rep.engine.statuses().items()):
                if st in ("queued", "running"):
                    rep.engine.cancel(erid)

    # -- placement ------------------------------------------------------------
    def _placeable(self, rep: _Replica, now: float) -> bool:
        if not rep.alive or rep.removed or rep.draining or rep.stall_steps > 0:
            return False
        if (now - rep.last_beat) > self.heartbeat_timeout_s:
            return False
        if rep.breaker == "open":
            if now < rep.breaker_until:
                return False
            rep.breaker = "half_open"  # cooldown over: risk one probe
            rep.probe_rid = None
        if rep.breaker == "half_open" and rep.probe_rid is not None:
            return False  # one probe at a time
        return True

    def _outstanding(self, name: str) -> int:
        return sum(
            1 for rec in self._records.values()
            if rec.status is None and rec.replica == name
        )

    def _choose_replica(self, rec: _Record, now: float) -> _Replica | None:
        """Affinity first, then least-outstanding among placeable
        replicas (ties: replica order — deterministic)."""
        if rec.affinity is not None:
            hint = self._affinity.get((rec.kwargs.get("adapter") or "", rec.affinity))
            if hint is not None:
                rep = self.replicas.get(hint)
                if rep is not None and self._placeable(rep, now):
                    return rep
        best = None
        best_load = None
        for rep in self.replicas.values():
            if not self._placeable(rep, now):
                continue
            load = self._outstanding(rep.name)
            if best_load is None or load < best_load:
                best, best_load = rep, load
        return best

    def _place(self, rec: _Record, rep: _Replica, now: float) -> None:
        try:
            rec.engine_rid = rep.engine.submit(
                rec.prompt, rec.max_new, token=rec.token, trace=rec.trace,
                **rec.kwargs
            )
        except DuplicateRequest as dup:
            # the ambiguous-failure window: the "failed" submit actually
            # landed — re-attach, never double-admit
            rec.engine_rid = dup.rid
        rec.replica = rep.name
        if rec.affinity is not None:
            self._affinity[(rec.kwargs.get("adapter") or "", rec.affinity)] = rep.name
        if rep.breaker == "half_open" and rep.probe_rid is None:
            rep.probe_rid = rec.rid
        journal.emit(
            "route", now, label=f"req{rec.rid}", request=rec.rid,
            trace=rec.trace, replica=rep.name, tenant=rec.tenant,
            retry=rec.retries,
        )

    def _place_pending(self, now: float) -> None:
        """Per-tenant DRR over the pending queues: visit the ring head,
        place its FIFO head while its deficit covers the request's block
        reservation, else grant a quantum and rotate. Stops when no
        replica is placeable or every queue is empty/backing off."""
        if not any(self._placeable(rep, now) for rep in self.replicas.values()):
            return
        rotations = 0
        while self._ring and rotations <= len(self._ring):
            tenant = self._ring[0]
            q = self._queues.get(tenant)
            if not q:
                self._queues.pop(tenant, None)
                self._deficit.pop(tenant, None)
                self._ring.popleft()
                rotations = 0
                continue
            head = q[0]
            if head.status is not None:  # cancelled while queued
                q.popleft()
                continue
            if head.not_before > now:  # backoff: sticky head, try later
                self._ring.rotate(-1)
                rotations += 1
                continue
            need = self._blocks_for(len(head.prompt) + head.max_new)
            if self._deficit[tenant] >= need:
                rep = self._choose_replica(head, now)
                if rep is None:
                    return  # nowhere to place anything right now
                q.popleft()
                self._deficit[tenant] -= need
                if not q:
                    self._queues.pop(tenant, None)
                    self._deficit.pop(tenant, None)
                    self._ring.remove(tenant)
                self._place(head, rep, now)
                rotations = 0
                continue
            self._deficit[tenant] += self.drr_quantum
            self._ring.rotate(-1)
            rotations += 1

    # -- the routing loop -----------------------------------------------------
    def step(self) -> bool:
        """One router iteration: chaos hook, step every live replica
        (heartbeats advance on success; raises and missed beats fail the
        replica over), sync terminal statuses, finish drains, place
        pending work. Returns whether any replica did device work."""
        self.steps += 1
        now = self.clock()
        if self.fault_injector is not None:
            self.fault_injector("router_step", None)
        did = False
        for rep in self.replicas.values():
            if not rep.alive or rep.removed:
                continue
            if rep.stall_steps > 0:
                rep.stall_steps -= 1  # stalled: no step, no heartbeat
                continue
            try:
                did = rep.engine.step() or did
                rep.last_beat = self.clock()
            except Exception as exc:  # noqa: BLE001 — a replica crash is survivable
                # unhealthy, not (necessarily) dead: requests re-route,
                # the breaker decides when to trust it with work again
                self._fail_replica(
                    rep, f"step raised {type(exc).__name__}: {exc}", fatal=False
                )
                rep.last_beat = self.clock()  # re-arm the detector
        now = self.clock()
        for rep in self.replicas.values():
            if not rep.alive or rep.removed:
                continue
            if (now - rep.last_beat) > self.heartbeat_timeout_s:
                # missed its heartbeat deadline: mark unhealthy, re-route
                # its live requests, re-arm — if it revives, the breaker
                # gates its way back; if not, it just stays empty
                self._fail_replica(rep, "missed heartbeat", fatal=False)
                rep.last_beat = now
        self._sync_terminals()
        self._finish_drains(now)
        self._place_pending(now)
        return did

    def _sync_terminals(self) -> None:
        for rec in self._records.values():
            if rec.status is not None or rec.replica is None:
                continue
            rep = self.replicas[rec.replica]
            try:
                st = rep.engine.status(rec.engine_rid)
            except KeyError:
                continue
            if st in TERMINAL_STATUSES:
                rec.status = st
                if rep.probe_rid == rec.rid:
                    rep.probe_rid = None
                    if st == "ok":  # the probe survived: close the breaker
                        rep.breaker = "closed"
                        rep.consec_failures = 0
                elif st == "ok" and rep.breaker == "closed":
                    rep.consec_failures = 0

    def _finish_drains(self, now: float) -> None:
        for rep in self.replicas.values():
            if not rep.draining or rep.removed or not rep.alive:
                continue
            live = self._outstanding(rep.name)
            if live == 0 and rep.engine.idle:
                rep.removed = True
                rep.alive = False
                journal.emit(
                    "replica_drain", rep.drain_started, now, label=rep.name,
                    replica=rep.name, migrated=rep.migrated,
                )
                if self.run_dir is not None:
                    from ..checkpoint import write_requeue_verdict

                    write_requeue_verdict(
                        self.run_dir, False, f"replica {rep.name} drained",
                        "completed",
                        serve={
                            "replica": rep.name,
                            "drain_s": round(now - rep.drain_started, 6),
                            "migrated": rep.migrated,
                            "statuses": rep.engine.ledger.status_counts(),
                            "drained_clean": True,
                        },
                    )

    def run(self, max_steps: int | None = None) -> dict[int, np.ndarray]:
        """Drive :meth:`step` until every request is terminal (or
        ``max_steps``); returns the ``ok`` outputs by router id."""
        steps = 0
        while not self.idle:
            self.step()
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        return {
            rid: self.output(rid)
            for rid, rec in self._records.items()
            if rec.status == "ok"
        }

    def serve_trace(self, trace, clock=None, sleep=time.sleep) -> dict:
        """Replay a timed trace against the whole pool (same shape as
        ``ServeEngine.serve_trace``: ``(offset_s, prompt, max_new[,
        kwargs])``); returns :meth:`summary`."""
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
            if not self.step() and i < len(pending):
                sleep(min(max(pending[i][0] - (clock() - t0), 0.0), 0.001))
        return self.summary()

    # -- observability --------------------------------------------------------
    def ttfts(self, tenant: str | None = None) -> list[float]:
        """ROUTER-level TTFT samples: router arrival -> first token on
        whichever replica finally produced it, so a failover's re-prefill
        and backoff are inside the number (an engine's own ledger restarts
        the clock at resubmission — honest for the replica, not for the
        client). Requires the replicas to share the router's clock, which
        is how :class:`Router` is meant to be wired."""
        out: list[float] = []
        for rec in self._records.values():
            if rec.replica is None or rec.engine_rid is None:
                continue
            if tenant is not None and rec.tenant != tenant:
                continue
            erec = self.replicas[rec.replica].engine.ledger.records.get(rec.engine_rid)
            if erec is not None and "first_token" in erec:
                out.append(erec["first_token"] - rec.arrival)
        return out

    def summary(self) -> dict:
        """The router scorecard: terminal census router-wide, failure
        handling counters, and per-replica health/breaker state."""
        census: dict[str, int] = {}
        for rec in self._records.values():
            key = rec.status if rec.status is not None else "live"
            census[key] = census.get(key, 0) + 1
        return {
            "requests": len(self._records),
            "statuses": census,
            "failovers": self.failovers,
            "kills": self.kills,
            "steps": self.steps,
            "replicas": {
                name: {
                    "alive": rep.alive,
                    "removed": rep.removed,
                    "draining": rep.draining,
                    "breaker": rep.breaker,
                    "consec_failures": rep.consec_failures,
                    "outstanding": self._outstanding(name),
                }
                for name, rep in self.replicas.items()
            },
        }

    def metrics_text(self) -> str:
        """One Prometheus page for the whole pool: every replica's
        registry snapshot (gauges refreshed) merged under a ``replica``
        label, plus the router's own failure-handling series
        (``dml_router_failovers_total`` / ``dml_router_kills_total`` /
        ``dml_router_pending_requests`` and a per-replica
        ``dml_router_breaker_state`` gauge: 0=closed, 1=half_open,
        2=open). Families keep ONE ``# HELP``/``# TYPE`` header across
        replicas — the page parses as a single valid exposition. Replicas
        constructed without ``metrics=`` simply contribute nothing."""
        from ..telemetry.metrics_registry import MetricsRegistry, to_prometheus_text

        reg = MetricsRegistry()
        reg.counter("dml_router_failovers_total",
                    "failure-driven resubmissions").inc(self.failovers)
        reg.counter("dml_router_kills_total",
                    "replicas declared dead").inc(self.kills)
        reg.gauge("dml_router_pending_requests",
                  "records awaiting placement").set(
            sum(len(q) for q in self._queues.values()))
        breaker = reg.gauge(
            "dml_router_breaker_state",
            "per-replica circuit breaker (0=closed, 1=half_open, 2=open)",
            labels=("replica",), max_series=len(self.replicas) + 1)
        state_code = {"closed": 0, "half_open": 1, "open": 2}
        for name, rep in self.replicas.items():
            breaker.labels(replica=name).set(state_code[rep.breaker])
        pages: list = [reg.snapshot()]
        for name, rep in self.replicas.items():
            snap = rep.engine.metrics_snapshot()
            if snap is not None:
                pages.append((snap, {"replica": name}))
        return to_prometheus_text(*pages)
