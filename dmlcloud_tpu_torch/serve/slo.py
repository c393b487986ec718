"""Declarative serving SLOs with multi-window burn-rate alerting.

Counterpart of ``dmlcloud_tpu/serve/slo.py`` (``SLO``, ``SLOMonitor``), whole
and host-only. An :class:`SLO` declares per-tenant objectives in plain
numbers::

    SLO("gold-latency", tenant="gold", ttft_p99_s=0.25)
    SLO("fleet-availability", availability=0.999)

and :class:`SLOMonitor` evaluates them over sliding windows off the same
injectable ``clock=`` the engine reads, so the alerting path is testable with
a fake clock.

**Burn-rate semantics** (the multi-window rule): each objective implies an
error budget — ``1 - good_fraction`` of requests may miss a latency target,
``1 - availability`` may fail. A window's burn rate is ``bad_fraction /
budget``. An alert fires only when both the fast and the slow window burn at
``burn_threshold`` or more: the slow window proves it is sustained, the fast
window that it is still happening. Each firing is journaled as an
``slo_alert`` span and kept in ``monitor.alerts``; the alert re-arms only after
the fast window drops back under the threshold.

The monitor surfaces in the ledger summary (its ``"slo"`` section when an
engine is built with ``slos=``) and in the drain verdict
(``serve.slo_alerts``).
"""

from __future__ import annotations

import collections
import time
from dataclasses import dataclass
from typing import Callable

import numpy as np

from ..telemetry import journal

__all__ = ["SLO", "SLOMonitor"]

#: terminal statuses that count against an availability objective; a
#: client cancel is neither good nor bad — it spends no error budget
_BAD_STATUSES = ("error", "shed", "deadline_exceeded")


@dataclass(frozen=True)
class SLO:
    """One declarative objective. At least one of ``ttft_p99_s`` (the
    latency target: ``good_fraction`` of requests must see first token
    within it) and ``availability`` (fraction of non-cancelled requests
    that must end ``ok``) must be set. ``tenant=None`` spans all
    traffic. Windows: ``window_s`` is the slow (sustained) window,
    ``fast_window_s`` the still-happening one."""

    name: str
    tenant: str | None = None
    ttft_p99_s: float | None = None
    availability: float | None = None
    good_fraction: float = 0.99
    window_s: float = 60.0
    fast_window_s: float = 5.0
    burn_threshold: float = 2.0

    def __post_init__(self):
        if self.ttft_p99_s is None and self.availability is None:
            raise ValueError(f"SLO {self.name!r} declares no objective")
        if self.ttft_p99_s is not None and self.ttft_p99_s <= 0:
            raise ValueError(f"ttft_p99_s must be > 0, got {self.ttft_p99_s}")
        if self.availability is not None and not 0.0 < self.availability < 1.0:
            raise ValueError(f"availability must be in (0, 1), got {self.availability}")
        if not 0.0 < self.good_fraction < 1.0:
            raise ValueError(f"good_fraction must be in (0, 1), got {self.good_fraction}")
        if self.fast_window_s <= 0 or self.window_s <= self.fast_window_s:
            raise ValueError(
                f"need 0 < fast_window_s < window_s, got "
                f"{self.fast_window_s} / {self.window_s}"
            )
        if self.burn_threshold <= 0:
            raise ValueError(f"burn_threshold must be > 0, got {self.burn_threshold}")


class _Part:
    """Sliding-window state of one objective part (latency or
    availability): a deque of ``(t, good, value)`` events bounded by the
    slow window, plus the alert re-arm latch."""

    __slots__ = ("kind", "budget", "events", "alerting")

    def __init__(self, kind: str, budget: float):
        self.kind = kind
        self.budget = budget
        self.events: collections.deque = collections.deque()
        self.alerting = False

    def record(self, now: float, good: bool, value: float) -> None:
        self.events.append((now, good, value))

    def prune(self, now: float, window_s: float) -> None:
        ev = self.events
        while ev and ev[0][0] < now - window_s:
            ev.popleft()

    def burn(self, now: float, window_s: float) -> float | None:
        """``bad_fraction / budget`` over the trailing window; None with
        no events (no traffic spends no budget)."""
        n = bad = 0
        for t, good, _ in self.events:
            if t >= now - window_s:
                n += 1
                bad += 0 if good else 1
        if n == 0:
            return None
        return (bad / n) / self.budget


class SLOMonitor:
    """Evaluates a set of :class:`SLO` objectives over events the engine
    feeds it (module docstring). ``clock`` must be the same injectable
    clock the event timestamps come from."""

    def __init__(self, objectives, clock: Callable[[], float] = time.perf_counter):
        objectives = list(objectives)
        names = [o.name for o in objectives]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO names: {names}")
        self.objectives: list[SLO] = objectives
        self.clock = clock
        self.alerts: list[dict] = []
        self._parts: dict[tuple[str, str], _Part] = {}
        for o in objectives:
            if o.ttft_p99_s is not None:
                self._parts[(o.name, "ttft")] = _Part("ttft", 1.0 - o.good_fraction)
            if o.availability is not None:
                self._parts[(o.name, "availability")] = _Part(
                    "availability", 1.0 - o.availability
                )

    def _matching(self, tenant: str | None):
        for o in self.objectives:
            if o.tenant is None or o.tenant == tenant:
                yield o

    # -- event feeds ----------------------------------------------------------
    def record_ttft(self, tenant: str | None, ttft_s: float, now: float) -> None:
        for o in self._matching(tenant):
            part = self._parts.get((o.name, "ttft"))
            if part is not None:
                part.record(now, ttft_s <= o.ttft_p99_s, float(ttft_s))

    def record_terminal(self, tenant: str | None, status: str, now: float) -> None:
        if status == "cancelled":
            return  # a client cancel spends no error budget
        for o in self._matching(tenant):
            part = self._parts.get((o.name, "availability"))
            if part is not None:
                part.record(now, status not in _BAD_STATUSES, 0.0)

    # -- evaluation -----------------------------------------------------------
    def evaluate(self, now: float | None = None) -> list[dict]:
        """Check every objective's multi-window burn; returns (and
        retains, and journals as ``slo_alert`` spans) the alerts that
        FIRED on this call. Cheap enough for once per engine step:
        O(events in the slow window) per objective."""
        if now is None:
            now = self.clock()
        fired: list[dict] = []
        for o in self.objectives:
            for part_name in ("ttft", "availability"):
                part = self._parts.get((o.name, part_name))
                if part is None:
                    continue
                part.prune(now, o.window_s)
                fast = part.burn(now, o.fast_window_s)
                slow = part.burn(now, o.window_s)
                burning = (
                    fast is not None and slow is not None
                    and fast >= o.burn_threshold and slow >= o.burn_threshold
                )
                if burning and not part.alerting:
                    part.alerting = True
                    alert = {
                        "slo": o.name, "part": part_name, "tenant": o.tenant,
                        "burn_fast": round(fast, 3), "burn_slow": round(slow, 3),
                        "threshold": o.burn_threshold, "t": now,
                    }
                    self.alerts.append(alert)
                    fired.append(alert)
                    journal.emit(
                        "slo_alert", now - o.fast_window_s, now, label=o.name,
                        slo=o.name, part=part_name, tenant=o.tenant or "",
                        burn_fast=alert["burn_fast"], burn_slow=alert["burn_slow"],
                    )
                elif not burning and fast is not None and fast < o.burn_threshold:
                    part.alerting = False  # re-arm only after the fast window recovers
        return fired

    def status(self, now: float | None = None) -> dict:
        """Plain-dict scorecard per objective (the ledger summary's
        ``"slo"`` section): observed p99 / availability over the slow
        window, burn rates, alert latch and total alert count."""
        if now is None:
            now = self.clock()
        out: dict[str, dict] = {}
        for o in self.objectives:
            entry: dict = {"tenant": o.tenant}
            part = self._parts.get((o.name, "ttft"))
            if part is not None:
                part.prune(now, o.window_s)
                vals = [v for _, _, v in part.events]
                entry["ttft"] = {
                    "target_p99_s": o.ttft_p99_s,
                    "observed_p99_s": (
                        round(float(np.percentile(vals, 100 * o.good_fraction)), 6)
                        if vals else None
                    ),
                    "n": len(vals),
                    "burn_fast": part.burn(now, o.fast_window_s),
                    "burn_slow": part.burn(now, o.window_s),
                    "alerting": part.alerting,
                }
            part = self._parts.get((o.name, "availability"))
            if part is not None:
                part.prune(now, o.window_s)
                n = len(part.events)
                good = sum(1 for _, g, _ in part.events if g)
                entry["availability"] = {
                    "target": o.availability,
                    "observed": round(good / n, 6) if n else None,
                    "n": n,
                    "burn_fast": part.burn(now, o.fast_window_s),
                    "burn_slow": part.burn(now, o.window_s),
                    "alerting": part.alerting,
                }
            out[o.name] = entry
        return {"objectives": out, "alerts": len(self.alerts)}
