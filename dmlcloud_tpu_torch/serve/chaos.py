"""Deterministic fault injection for the serving engine.

Counterpart of ``dmlcloud_tpu/serve/chaos.py``: ``ChaosError`` and
``ChaosMonkey``, the engine half. :class:`ChaosMonkey` attaches to a live
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

The draws come in the reference's fixed per-step order, so the same seed over
the same trace injects the reference's faults at the same points: a drill is
replayable, and replays the reference's schedule.

The replica-level events of the reference (``attach_router``,
``p_replica_kill``, ``p_replica_stall``) belong to the ``Router``, which is
not ported yet (ROADMAP Queue 1 item 10, the Router line): they raise
``NotImplementedError``.

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


#: what the reference's replica events wait for
_ROUTER = ("replica-level chaos (attach_router, p_replica_kill, p_replica_stall) needs the Router (ROADMAP Queue 1 "
           "item 10, the Router line), which is not ported yet")


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
        if p_replica_kill or p_replica_stall or max_replica_kills is not None:
            raise NotImplementedError(_ROUTER)
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
        self.engine = None
        self.faults = 0
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
        if self.engine is not None:
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
        """The reference's replica-level events need the ``Router``."""
        raise NotImplementedError(_ROUTER)

    def _clock(self) -> float:
        return self._base_clock() + self._offset

    # -- injection -----------------------------------------------------------
    def __call__(self, point: str, seqs) -> None:
        """The engine's chaos hook. ``step`` acts (never raises); device
        points flip one seeded coin and may raise :class:`ChaosError`."""
        if point == "step":
            self._on_step()
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
