"""Deterministic fault injection for the serving engine.

Counterpart of ``dmlcloud_tpu/serve/chaos.py``: ``ChaosError`` and
``ChaosMonkey``. :class:`ChaosMonkey` attaches to a live
:class:`~dmlcloud_tpu_torch.serve.engine.ServeEngine` and, from ONE seeded
``numpy.random.RandomState``, injects the four failures the engine promises
to survive:

- **step-function exceptions**: a :class:`ChaosError` raised at the
  device-phase hook points (``prefill`` / ``decode`` / ``draft`` /
  ``verify``) just before the device call. The affected request(s) end
  ``status="error"`` with every block released; a draft fault degrades the
  round to plain decode instead.
- **pool exhaustion**: the monkey allocates ("squats") free blocks for a few
  steps through the pool's own ``alloc``/``release``, so ``free + unique-live
  == capacity`` holds during the outage. Admission stalls, and a COW fork
  that needs a fresh block sees ``PoolExhausted``, which fails only that
  request.
- **slow-clock stalls**: the engine's injectable clock jumps forward, firing
  deadline expiries as a paused host would.
- **random cancels**: ``cancel(rid)`` against a random live request.

Attached to a :class:`~dmlcloud_tpu_torch.serve.router.Router` instead
(:meth:`ChaosMonkey.attach_router`, reference chaos.py:150-253), the monkey
injects replica-level events from the same seeded RNG into the same log:

- **replica kills** (``p_replica_kill``, capped by ``max_replica_kills``):
  permanent death of a random standing replica; never the last one standing.
- **replica stalls** (``p_replica_stall``): a replica misses
  ``replica_stall_steps`` step calls; the heartbeat detector decides.

Neither targets a draining replica. The draws come in the reference's fixed
per-step order, so the same seed over the same trace injects the reference's
faults at the same points: a drill is replayable, and replays the
reference's schedule, event log ``(step, kind, detail)`` included.

Usage::

    monkey = ChaosMonkey(seed=7, p_fault=0.05, p_exhaust=0.1, p_cancel=0.02)
    monkey.attach(engine)
    engine.run()
    monkey.detach()         # releases any squatted blocks
    assert engine.leaked_blocks() == 0
"""

from __future__ import annotations

import numpy as np

from .kv_pool import PoolExhausted

__all__ = ["ChaosError", "ChaosMonkey"]


class ChaosError(RuntimeError):
    """An injected step failure (distinguishable from real bugs in logs)."""


class ChaosMonkey:
    """Seeded fault injector over one engine (module docstring).

    Probabilities are per opportunity: ``p_fault`` per device-phase call
    (limited to ``fault_points``), ``p_exhaust`` / ``p_stall`` /
    ``p_cancel`` per engine step. ``max_faults`` caps injected
    exceptions so a drill can guarantee survivors exist. ``verify_pools``
    audits every pool's host accounting each step (cheap at test scale,
    and exactly the audit that would catch a corrupted free list the
    moment the fault lands)."""

    def __init__(
        self,
        seed: int = 0,
        *,
        p_fault: float = 0.0,
        fault_points: tuple[str, ...] = ("prefill", "decode", "draft", "verify"),
        max_faults: int | None = None,
        p_exhaust: float = 0.0,
        exhaust_blocks: int = 4,
        exhaust_steps: int = 3,
        p_stall: float = 0.0,
        stall_s: float = 0.25,
        p_cancel: float = 0.0,
        verify_pools: bool = True,
        p_replica_kill: float = 0.0,
        max_replica_kills: int | None = None,
        p_replica_stall: float = 0.0,
        replica_stall_steps: int = 2,
    ):
        self._rng = np.random.RandomState(int(seed))
        self.p_fault = float(p_fault)
        self.fault_points = tuple(fault_points)
        self.max_faults = max_faults
        self.p_exhaust = float(p_exhaust)
        self.exhaust_blocks = int(exhaust_blocks)
        self.exhaust_steps = int(exhaust_steps)
        self.p_stall = float(p_stall)
        self.stall_s = float(stall_s)
        self.p_cancel = float(p_cancel)
        self.verify_pools = bool(verify_pools)
        self.p_replica_kill = float(p_replica_kill)
        self.max_replica_kills = max_replica_kills
        self.p_replica_stall = float(p_replica_stall)
        self.replica_stall_steps = int(replica_stall_steps)
        self.engine = None
        self.router = None
        self.faults = 0
        self.replica_kills = 0
        self.steps = 0
        #: replayable event log: (step, kind, detail) — the drill's record
        self.log: list[tuple[int, str, str]] = []
        self._squat: list[int] = []
        self._squat_left = 0
        self._offset = 0.0
        self._base_clock = None

    # -- wiring --------------------------------------------------------------
    def attach(self, engine) -> "ChaosMonkey":
        """Install on ``engine``: becomes its ``fault_injector`` and wraps
        its clock (stall injection). One engine per monkey."""
        if self.engine is not None or self.router is not None:
            raise RuntimeError("monkey already attached")
        self.engine = engine
        engine.fault_injector = self
        self._base_clock = engine.clock
        engine.clock = self._clock
        return self

    def detach(self) -> None:
        """Restore the engine and release every squatted block — after
        this the pools owe nothing to the chaos harness."""
        if self.engine is None:
            return
        self._release_squat()
        self.engine.fault_injector = None
        self.engine.clock = self._base_clock
        self.engine = None

    def attach_router(self, router) -> "ChaosMonkey":
        """Install on a :class:`~dmlcloud_tpu_torch.serve.router.Router` for
        the replica-level events (``p_replica_kill`` / ``p_replica_stall``):
        one seeded draw order per router step, logged into the same
        replayable event log as the engine-level faults. One router per
        monkey; a monkey drives either an engine or a router, not both (two
        injectors sharing one RNG would entangle their draw sequences)."""
        if self.router is not None or self.engine is not None:
            raise RuntimeError("monkey already attached")
        self.router = router
        router.fault_injector = self
        return self

    def detach_router(self) -> None:
        if self.router is None:
            return
        self.router.fault_injector = None
        self.router = None

    def _clock(self) -> float:
        return self._base_clock() + self._offset

    # -- injection -----------------------------------------------------------
    def __call__(self, point: str, seqs) -> None:
        """The engine's chaos hook. ``step`` acts (never raises); device
        points flip one seeded coin and may raise :class:`ChaosError`."""
        if point == "step":
            self._on_step()
            return
        if point == "router_step":
            self._on_router_step()
            return
        if (
            self.p_fault
            and point in self.fault_points
            and self._rng.random_sample() < self.p_fault
            and (self.max_faults is None or self.faults < self.max_faults)
        ):
            self.faults += 1
            who = ",".join(str(s.req.id) for s in seqs or [])
            self.log.append((self.steps, "fault", f"{point}:{who}"))
            raise ChaosError(f"injected {point} fault #{self.faults}")

    def _on_step(self) -> None:
        self.steps += 1
        eng = self.engine
        if self._squat:
            self._squat_left -= 1
            if self._squat_left <= 0:
                self._release_squat()
        elif self.p_exhaust and self._rng.random_sample() < self.p_exhaust:
            self._grab_squat()
        if self.p_stall and self._rng.random_sample() < self.p_stall:
            self._offset += self.stall_s
            self.log.append((self.steps, "stall", f"+{self.stall_s}s"))
        if self.p_cancel and self._rng.random_sample() < self.p_cancel:
            live = [rid for rid, s in eng._all.items() if s.status is None]
            if live:
                rid = live[int(self._rng.randint(len(live)))]
                if eng.cancel(rid):
                    self.log.append((self.steps, "cancel", str(rid)))
        if self.verify_pools:
            eng.pool.assert_consistent()
            if eng.draft_pool is not None:
                eng.draft_pool.assert_consistent()

    def _on_router_step(self) -> None:
        """Replica-level events, fixed draw order (kill, then stall), as
        :meth:`_on_step`'s. A kill always leaves at least one replica
        standing, and chaos never targets a draining replica (the drain path
        has its own verdict to keep clean)."""
        self.steps += 1
        r = self.router
        candidates = [
            name for name, rep in r.replicas.items()
            if rep.alive and not rep.removed and not rep.draining
        ]
        if (
            self.p_replica_kill
            and self._rng.random_sample() < self.p_replica_kill
            and (self.max_replica_kills is None
                 or self.replica_kills < self.max_replica_kills)
        ):
            if len(candidates) > 1:
                name = candidates[int(self._rng.randint(len(candidates)))]
                self.replica_kills += 1
                self.log.append((self.steps, "replica_kill", name))
                r.kill_replica(name, reason="chaos")
                candidates.remove(name)
        if self.p_replica_stall and self._rng.random_sample() < self.p_replica_stall:
            if candidates:
                name = candidates[int(self._rng.randint(len(candidates)))]
                self.log.append(
                    (self.steps, "replica_stall", f"{name}:{self.replica_stall_steps}")
                )
                r.stall_replica(name, self.replica_stall_steps)
        if self.verify_pools:
            for rep in r.replicas.values():
                rep.engine.pool.assert_consistent()
                if rep.engine.draft_pool is not None:
                    rep.engine.draft_pool.assert_consistent()

    def _grab_squat(self) -> None:
        """Steal free blocks through the pool's own alloc — a legitimate
        (accounted) allocation, so exhaustion looks to the engine exactly
        like a competing admission burst."""
        pool = self.engine.pool
        n = min(self.exhaust_blocks, pool.num_free)
        if n < 1:
            return
        try:
            self._squat = pool.alloc(n)
        except PoolExhausted:  # raced our own num_free read: inject nothing
            return
        self._squat_left = self.exhaust_steps
        self.log.append((self.steps, "exhaust", f"{n} blocks"))

    def _release_squat(self) -> None:
        if self._squat:
            self.engine.pool.release(self._squat)
            self._squat = []
        self._squat_left = 0
