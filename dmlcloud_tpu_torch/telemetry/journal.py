"""The span journal: typed, timestamped spans in a ring and an off-thread JSONL file.

Counterpart of ``dmlcloud_tpu/telemetry/journal.py`` (training part, :1-346),
stdlib only. The record format is the reference's schema v1, so journals of
both packages load, merge and convert with either package's tools:

    {"v": 1, "kind": <SPAN_KINDS>, "label": str|null, "ts": float (s, epoch),
     "dur": float (s), "rank": int, "tid": str, ...attrs}

- **Hot-loop cost is one dict build and two appends.** ``emit`` never touches
  the filesystem; a daemon thread drains the pending list to
  ``journal-rank<k>.jsonl`` every ``flush_interval`` seconds and at close.
- **Durations are monotonic, timestamps are mergeable.** Span boundaries come
  from ``time.perf_counter``; each journal records one wall-clock anchor at
  creation and reports ``ts = wall_anchor + (perf_t - perf_anchor)``.
- **The ring outlives the file.** The last ``ring_size`` spans stay in memory
  for the hang watchdog's forensics dump, which reads the ring, not the file.

Extra keys are attributes (``step``, ``prefetch``, ...); consumers ignore
unknown keys. The serving stack's request traces (``to_request_trace``,
``linked_trace_report``) come with the port of ``serve/``.
"""

from __future__ import annotations

import atexit
import collections
import io
import json
import os
import threading
import time
from contextlib import contextmanager, nullcontext
from typing import Any, Iterable

__all__ = [
    "SCHEMA_VERSION",
    "SPAN_KINDS",
    "SpanJournal",
    "activate",
    "deactivate",
    "active_journal",
    "span",
    "emit",
    "now",
    "load_journals",
    "to_chrome_trace",
]

SCHEMA_VERSION = 1

#: The typed span vocabulary of schema v1, the reference's set: ``emit``
#: accepts other kinds (user spans), but everything the framework emits is in
#: it. The serving kinds are reserved for the port of ``serve/``.
SPAN_KINDS = frozenset(
    {
        "run",  # whole pipeline run
        "stage",  # one Stage.run()
        "epoch",  # one epoch (train+val)
        "step_dispatch",  # host enqueue of one train step
        "data_wait",  # host blocked waiting for the next batch
        "h2d",  # host->device copy dispatch of one batch
        "metric_readback",  # host blocked fetching device values
        "checkpoint",  # save dispatch / commit wait
        "barrier",  # control-plane barrier
        "compile",  # ahead-of-time compile of one signature
        "preflight",  # IR-level verify of one program
        "host_stall",  # any other accounted host block (StallTimer)
        "watchdog",  # forensics dump events
        "sanitizer",  # runtime sanitizer violations
        "queue_wait",  # serving: request arrival -> admission
        "prefill",  # serving: one chunked-prefill device call
        "decode_batch",  # serving: one continuous-batching decode step
        "draft",  # serving: draft-model device call
        "verify",  # serving: one k+1-position spec verification pass
        "fault",  # serving: a step failure isolated to its request(s)
        "drain",  # serving: graceful-drain window
        "route",  # serving: router placement of one request
        "failover",  # serving: resubmission off a dead replica
        "replica_drain",  # serving: router-coordinated drain of one replica
        "medusa",  # serving: one fused Medusa propose+verify round
        "admission",  # serving: scheduler admission of one request
        "prefix_lookup",  # serving: radix-tree prefix match at admission
        "cow_fork",  # serving: one copy-on-write block fork
        "slo_alert",  # serving: an SLO burn-rate alert fired
    }
)

_JOURNAL_GLOB_PREFIX = "journal-rank"


class SpanJournal:
    """Per-process append-only span recorder (see the module docstring)."""

    def __init__(
        self,
        directory: str | os.PathLike,
        rank: int = 0,
        ring_size: int = 1024,
        flush_interval: float = 2.0,
    ):
        self.directory = os.fspath(directory)
        self.rank = int(rank)
        self.path = os.path.join(self.directory, f"{_JOURNAL_GLOB_PREFIX}{self.rank}.jsonl")
        self._ring: collections.deque = collections.deque(maxlen=int(ring_size))
        self._pending: list[dict] = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._atexit = None
        self._flush_interval = float(flush_interval)
        self._wall0 = time.time()
        self._perf0 = time.perf_counter()
        #: perf_counter of the most recent emit
        self.last_emit = self._perf0
        #: called (with no args) after every emit when set; the pipeline wires
        #: it to ``HangWatchdog.notify``, so any span counts as progress
        self.on_emit = None
        os.makedirs(self.directory, exist_ok=True)
        # truncate a journal a previous run left in the same directory
        with open(self.path, "w", encoding="utf-8"):
            pass

    # -- clock ---------------------------------------------------------------
    @staticmethod
    def now() -> float:
        """Monotonic seconds: the only clock span boundaries may come from."""
        return time.perf_counter()

    def _wall(self, perf_t: float) -> float:
        return self._wall0 + (perf_t - self._perf0)

    # -- recording -----------------------------------------------------------
    def emit(self, kind: str, start: float, end: float | None = None, label: str | None = None, **attrs: Any) -> dict:
        """Record one span. ``start``/``end`` are ``SpanJournal.now()``
        readings (``end`` defaults to now). Returns the schema-v1 record."""
        if end is None:
            end = time.perf_counter()
        rec = {
            "v": SCHEMA_VERSION,
            "kind": kind,
            "label": label,
            "ts": round(self._wall(start), 6),
            "dur": round(max(end - start, 0.0), 9),
            "rank": self.rank,
            "tid": threading.current_thread().name,
        }
        if attrs:
            rec.update(attrs)
        with self._lock:
            self._pending.append(rec)
            self._ring.append(rec)
        self.last_emit = end
        cb = self.on_emit
        if cb is not None:
            cb()
        return rec

    @contextmanager
    def span(self, kind: str, label: str | None = None, **attrs: Any):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.emit(kind, t0, label=label, **attrs)

    def tail(self, n: int = 64) -> list[dict]:
        """The most recent ``n`` spans of the in-memory ring, newest last."""
        with self._lock:
            items = list(self._ring)
        return items[-int(n):]

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    # -- flushing ------------------------------------------------------------
    def flush(self) -> int:
        """Append the pending spans to the JSONL file; returns lines written."""
        with self._lock:
            batch, self._pending = self._pending, []
        if not batch:
            return 0
        buf = io.StringIO()
        for rec in batch:
            buf.write(json.dumps(rec, separators=(",", ":")))
            buf.write("\n")
        with open(self.path, "a", encoding="utf-8") as f:
            f.write(buf.getvalue())
        return len(batch)

    def start(self) -> "SpanJournal":
        """Start the off-thread flusher (idempotent) and register an
        ``atexit`` flush, so spans emitted after the flusher's last wakeup
        survive a process that exits without ``close()``."""
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(target=self._flush_loop, name=f"dml-journal-r{self.rank}", daemon=True)
            self._thread.start()
        if self._atexit is None:
            self._atexit = self.flush
            atexit.register(self._atexit)
        return self

    def _flush_loop(self) -> None:
        while not self._stop.wait(self._flush_interval):
            try:
                self.flush()
            except OSError:  # a full or unmounted disk must never kill training
                pass

    def close(self) -> None:
        """Stop the flusher, drop the atexit hook and write what is pending."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        if self._atexit is not None:
            atexit.unregister(self._atexit)
            self._atexit = None
        try:
            self.flush()
        except OSError:
            pass


# --------------------------------------------------------------- active hook
#
# The instrumentation points (stage, data/device, utils/profiling,
# parallel/runtime) call the module-level ``span``/``emit`` below. With no
# journal armed they are one attribute read and a None check.

_active: SpanJournal | None = None


def activate(journal: SpanJournal) -> SpanJournal:
    global _active
    _active = journal
    return journal


def deactivate() -> None:
    global _active
    _active = None


def active_journal() -> SpanJournal | None:
    return _active


def span(kind: str, label: str | None = None, **attrs: Any):
    """Context manager recording a span on the active journal; a no-op when
    telemetry is not armed."""
    j = _active
    if j is None:
        return nullcontext()
    return j.span(kind, label=label, **attrs)


def emit(kind: str, start: float, end: float | None = None, label: str | None = None, **attrs: Any):
    """Record a span on the active journal (a no-op when not armed)."""
    j = _active
    if j is None:
        return None
    return j.emit(kind, start, end, label=label, **attrs)


def now() -> float:
    return time.perf_counter()


# ------------------------------------------------------------ merge / export


def _telemetry_dir(run_dir: str | os.PathLike) -> str:
    """Accept a run directory (holding ``telemetry/``) or a telemetry directory."""
    run_dir = os.fspath(run_dir)
    sub = os.path.join(run_dir, "telemetry")
    if os.path.isdir(sub):
        return sub
    return run_dir


def load_journals(run_dir: str | os.PathLike) -> list[dict]:
    """Every rank's ``journal-rank*.jsonl`` under ``run_dir`` (or its
    ``telemetry/``) as one record list sorted by timestamp. A truncated last
    line (a writer killed mid-line) is skipped."""
    tdir = _telemetry_dir(run_dir)
    records: list[dict] = []
    try:
        names = sorted(os.listdir(tdir))
    except OSError:
        raise FileNotFoundError(f"no telemetry journal directory at {tdir}") from None
    found = False
    for name in names:
        if not (name.startswith(_JOURNAL_GLOB_PREFIX) and name.endswith(".jsonl")):
            continue
        found = True
        with open(os.path.join(tdir, name), "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    records.append(json.loads(line))
                except ValueError:
                    continue  # half-written final line of a killed run
    if not found:
        raise FileNotFoundError(
            f"no {_JOURNAL_GLOB_PREFIX}*.jsonl under {tdir}: was the run launched with "
            "TrainingPipeline(telemetry=True)?"
        )
    records.sort(key=lambda r: r.get("ts", 0.0))
    return records


def to_chrome_trace(records: Iterable[dict]) -> dict:
    """Merge schema-v1 records into Chrome-trace JSON (the ``traceEvents``
    format Perfetto and ``chrome://tracing`` load): one trace process per
    rank, one track per originating thread, complete ('X') events with
    microsecond timestamps rebased to the earliest span. The output is the
    reference converter's, byte for byte."""
    records = [r for r in records if "ts" in r and "dur" in r]
    t0 = min((r["ts"] for r in records), default=0.0)
    events: list[dict] = []
    # pid/tid must be integers for chrome://tracing; thread names ride the
    # 'M' metadata events instead
    tids: dict[int, dict[str, int]] = {}
    for r in records:
        rank = int(r.get("rank", 0))
        tname = str(r.get("tid", "main"))
        if rank not in tids:
            tids[rank] = {}
            events.append({"name": "process_name", "ph": "M", "pid": rank, "args": {"name": f"rank {rank}"}})
        if tname not in tids[rank]:
            tid = tids[rank][tname] = len(tids[rank])
            events.append({"name": "thread_name", "ph": "M", "pid": rank, "tid": tid, "args": {"name": tname}})
        kind = str(r.get("kind", "?"))
        label = r.get("label")
        args = {k: v for k, v in r.items() if k not in ("v", "kind", "label", "ts", "dur", "rank", "tid")}
        events.append(
            {
                "name": f"{kind}:{label}" if label else kind,
                "cat": kind,
                "ph": "X",
                "ts": round((r["ts"] - t0) * 1e6, 3),
                "dur": round(r["dur"] * 1e6, 3),
                "pid": rank,
                "tid": tids[rank][tname],
                "args": args,
            }
        )
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        # the reference's source tag: one format, whichever package wrote it
        "metadata": {"source": "dmlcloud_tpu telemetry journal", "schema": SCHEMA_VERSION},
    }
