"""Hang watchdog and flight recorder: a silent wedge becomes a post-mortem.

Counterpart of ``dmlcloud_tpu/telemetry/watchdog.py`` (:47-241; the serving
``serve_guard`` comes with the port of ``serve/``). A per-process daemon thread
tracks progress (any journal span, or an explicit ``notify()``) and, when
none is seen for ``threshold_s`` seconds, writes a forensics dump::

    <dump_dir>/rank<k>.json
    {"v": 1, "reason", "rank", "world_size", "written_at",
     "last_progress_age_s", "threshold_s",
     "barrier": {..., "stragglers": [ranks that never arrived]},
     "spans":  [last-N schema-v1 spans from the journal ring],
     "threads": [{"name", "daemon", "alive", "stack": [...frames...]}]}

The barrier block is ``parallel.runtime.barrier_state()``, where a timed-out
barrier records the ranks that never arrived. The spans come from the
journal's in-memory ring, not its file. The pipeline also calls ``dump()``
on an uncaught exception, and ``start()`` arms ``faulthandler`` on a sidecar
file, so that a fatal signal leaves C-level stacks behind too.

``check()`` takes an injectable monotonic clock, so tests drive it without
sleeping.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import threading
import time
import traceback
from datetime import datetime
from typing import Any, Callable

__all__ = ["HangWatchdog", "collect_thread_stacks"]

logger = logging.getLogger("dmlcloud_tpu_torch")


def collect_thread_stacks() -> list[dict]:
    """Every live thread's Python stack, outermost frame first."""
    frames = sys._current_frames()
    by_ident = {t.ident: t for t in threading.enumerate()}
    out = []
    for ident, frame in frames.items():
        t = by_ident.get(ident)
        stack = [
            f"{fs.filename}:{fs.lineno} in {fs.name}: {fs.line or ''}".rstrip(": ")
            for fs in traceback.extract_stack(frame)
        ]
        out.append(
            {
                "name": t.name if t else f"<ident {ident}>",
                "daemon": bool(t.daemon) if t else None,
                "alive": bool(t.is_alive()) if t else None,
                "stack": stack,
            }
        )
    return sorted(out, key=lambda d: d["name"])


class HangWatchdog:
    """Per-process heartbeat: no progress for ``threshold_s`` -> forensics dump.

    ``journal`` (optional) supplies the last-N spans of the dump; its emits
    count as progress once the pipeline wires ``journal.on_emit`` to
    ``notify``. ``clock`` must be monotonic.
    """

    def __init__(
        self,
        dump_dir: str | os.PathLike,
        rank: int = 0,
        world_size: int = 1,
        threshold_s: float = 600.0,
        interval_s: float = 10.0,
        journal: Any = None,
        last_n_spans: int = 64,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.dump_dir = os.fspath(dump_dir)
        self.rank = int(rank)
        self.world_size = int(world_size)
        self.threshold_s = float(threshold_s)
        self.interval_s = float(interval_s)
        self.journal = journal
        self.last_n_spans = int(last_n_spans)
        #: optional ``fn(reason)`` called after every dump; the pipeline wires
        #: the requeue-verdict writer here, so a hang also leaves a verdict
        self.on_dump: Callable[[str], None] | None = None
        self._clock = clock
        self._last = clock()
        self._dumped_this_stall = False
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._fault_file = None

    # -- progress ------------------------------------------------------------
    def notify(self) -> None:
        """Mark progress (every journal emit); re-arms the dump after a
        survived stall."""
        self._last = self._clock()
        self._dumped_this_stall = False

    def check(self, now: float | None = None) -> str | None:
        """One poll: dump forensics if the stall threshold is crossed. Returns
        the dump's path when one was written, else None. At most one dump per
        stall; progress re-arms it."""
        if now is None:
            now = self._clock()
        age = now - self._last
        if age <= self.threshold_s or self._dumped_this_stall:
            return None
        self._dumped_this_stall = True
        path = self.dump(
            f"no span/step progress for {age:.1f}s (threshold {self.threshold_s:.1f}s)", last_progress_age_s=age
        )
        logger.error("HANG WATCHDOG: rank %d observed no progress for %.1fs; forensics dumped to %s",
                     self.rank, age, path)
        return path

    # -- the flight-recorder dump --------------------------------------------
    def dump(self, reason: str, last_progress_age_s: float | None = None) -> str:
        """Write ``rank<k>.json`` with stacks, the last spans and the barrier
        state. Never raises: a broken dump path must not mask the failure it
        records."""
        from ..parallel import runtime

        if last_progress_age_s is None:
            last_progress_age_s = self._clock() - self._last
        record = {
            "v": 1,
            "reason": reason,
            "rank": self.rank,
            "world_size": self.world_size,
            "written_at": datetime.now().isoformat(timespec="seconds"),
            "threshold_s": self.threshold_s,
            "last_progress_age_s": round(last_progress_age_s, 3),
            "barrier": runtime.barrier_state(),
            "spans": self.journal.tail(self.last_n_spans) if self.journal is not None else [],
            "threads": collect_thread_stacks(),
        }
        path = os.path.join(self.dump_dir, f"rank{self.rank}.json")
        try:
            os.makedirs(self.dump_dir, exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(record, f, indent=1)
            os.replace(tmp, path)
        except OSError:
            logger.exception("forensics dump to %s failed", path)
        if self.journal is not None:
            try:
                t = self.journal.now()
                self.journal.emit("watchdog", t, t, label="forensics_dump", reason=reason)
                self.journal.flush()
            except Exception:
                logger.warning("could not journal the forensics dump", exc_info=True)
        if self.on_dump is not None:
            try:
                self.on_dump(reason)
            except Exception:
                logger.exception("watchdog on_dump hook failed")
        return path

    # -- thread lifecycle ----------------------------------------------------
    def start(self) -> "HangWatchdog":
        """Start the heartbeat thread and arm faulthandler (idempotent)."""
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self.notify()
            self._thread = threading.Thread(target=self._loop, name=f"dml-watchdog-r{self.rank}", daemon=True)
            self._thread.start()
        if self._fault_file is None:
            try:
                import faulthandler

                os.makedirs(self.dump_dir, exist_ok=True)
                self._fault_file = open(os.path.join(self.dump_dir, f"faulthandler-rank{self.rank}.log"), "w")
                faulthandler.enable(file=self._fault_file)
            except (OSError, ValueError):
                self._fault_file = None
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.check()
            except Exception:
                logger.exception("hang watchdog poll failed")

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        if self._fault_file is not None:
            try:
                import faulthandler

                faulthandler.disable()
                self._fault_file.close()
            except (OSError, ValueError):
                pass
            self._fault_file = None
