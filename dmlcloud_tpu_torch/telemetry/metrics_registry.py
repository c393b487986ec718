"""Typed metrics registry with bounded cardinality + Prometheus exposition.

Counterpart of ``dmlcloud_tpu/telemetry/metrics_registry.py``, host-only
stdlib code kept as the reference has it, so that the two packages' snapshots,
saved files and Prometheus pages are byte-identical for the same operations.
The span journal answers "what happened to request 17", this answers "what
is the engine doing right now" — counters, gauges and fixed-bucket
histograms cheap enough to live inside a serving hot loop
(``ServeEngine(metrics=True)`` builds its ``dml_serve_*`` series here).

Design constraints:

- **Hot-path cost is one attribute add.** Callers resolve a series handle
  ONCE (``registry.counter(...).labels(...)`` at construction) and the
  per-event call is ``child.inc()`` / ``child.observe()``: a float add, or a
  bisect into a fixed bucket list. No locks — series values are monotone
  floats updated under the GIL, and a snapshot racing an update misreads one
  sample by at most one event.
- **Bounded label cardinality, by construction.** Every family caps its
  series count (``max_series``); past the cap, new label combinations
  collapse into ONE overflow series (every label = ``"__overflow__"``)
  and the family counts the collapses — a per-request-id label is a
  bounded memory bug here, not an OOM three weeks into a deployment.
- **Snapshots are plain dicts.** ``Registry.snapshot()`` returns nothing
  but dicts/lists/str/float — JSON-safe and diffable, the input format of
  :func:`to_prometheus_text`.

Exposition is the Prometheus text format (``# HELP`` / ``# TYPE`` once
per family, ``name{label="v"} value`` samples, histograms as cumulative
``_bucket{le=...}`` + ``_sum`` + ``_count``). :func:`to_prometheus_text`
merges MULTIPLE snapshots into one page (e.g. each replica's snapshot tagged
with a ``replica`` label and a router's own on top: one scrape surface for a
pool). :func:`parse_prometheus_text` is the strict round-trip validator.
"""

from __future__ import annotations

import atexit
import bisect
import json
import math
import os
import re
from typing import Any, Iterable, Mapping

__all__ = [
    "MetricsRegistry",
    "TTFT_BUCKETS",
    "ITL_BUCKETS",
    "QUEUE_DEPTH_BUCKETS",
    "OVERFLOW_LABEL",
    "to_prometheus_text",
    "parse_prometheus_text",
]

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

#: Fixed bucket sets for the serving latency histograms. Fixed (not
#: adaptive) so dashboards and receipts compare across runs and hosts.
TTFT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)
ITL_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 1.0)
QUEUE_DEPTH_BUCKETS = (0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0)

#: The label value every series past a family's ``max_series`` collapses
#: into — bounded cardinality's pressure-relief valve.
OVERFLOW_LABEL = "__overflow__"


class _Counter:
    """One counter series. Monotone; ``inc`` rejects negative deltas."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counters only go up (inc by {amount})")
        self.value += amount


class _Gauge:
    """One gauge series: set/inc/dec to any float."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.value -= amount


class _Histogram:
    """One histogram series over a FIXED upper-bound list (``+Inf``
    implicit). ``observe`` is one bisect + two adds."""

    __slots__ = ("bounds", "counts", "sum", "count")

    def __init__(self, bounds: tuple[float, ...]):
        self.bounds = bounds
        self.counts = [0] * (len(bounds) + 1)  # last slot = +Inf
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        self.counts[bisect.bisect_left(self.bounds, value)] += 1
        self.sum += value
        self.count += 1


class _Family:
    """One metric family: a name, a kind, fixed label names, and a
    bounded dict of series children keyed by label-value tuples."""

    __slots__ = ("name", "help", "kind", "label_names", "max_series",
                 "buckets", "_series", "overflows")

    def __init__(self, name, help, kind, label_names, max_series, buckets=None):
        self.name = name
        self.help = help
        self.kind = kind
        self.label_names = tuple(label_names)
        self.max_series = int(max_series)
        self.buckets = buckets
        self._series: dict[tuple[str, ...], Any] = {}
        self.overflows = 0  # label combinations collapsed past the cap
        if not self.label_names:
            self._series[()] = self._new()  # the single unlabelled series

    def _new(self):
        if self.kind == "counter":
            return _Counter()
        if self.kind == "gauge":
            return _Gauge()
        return _Histogram(self.buckets)

    def labels(self, **values: Any):
        """The series for one label-value combination (created on first
        use). Resolve ONCE and hold the handle — a ``labels()`` call per
        request is the hot-path anti-pattern, and a combination past
        ``max_series`` silently collapses into the overflow series."""
        if set(values) != set(self.label_names):
            raise ValueError(
                f"{self.name} expects labels {self.label_names}, got {tuple(values)}"
            )
        key = tuple(str(values[n]) for n in self.label_names)
        child = self._series.get(key)
        if child is None:
            if len(self._series) >= self.max_series:
                self.overflows += 1
                key = (OVERFLOW_LABEL,) * len(self.label_names)
                child = self._series.get(key)
                if child is None:
                    child = self._series[key] = self._new()
            else:
                child = self._series[key] = self._new()
        return child

    # unlabelled-family conveniences: family IS the single series
    def inc(self, amount: float = 1.0) -> None:
        self._series[()].inc(amount)

    def set(self, value: float) -> None:
        self._series[()].set(value)

    def dec(self, amount: float = 1.0) -> None:
        self._series[()].dec(amount)

    def observe(self, value: float) -> None:
        self._series[()].observe(value)

    def snapshot(self) -> dict:
        series = []
        for key in sorted(self._series):
            child = self._series[key]
            entry: dict[str, Any] = {"labels": dict(zip(self.label_names, key))}
            if self.kind == "histogram":
                cum, acc = [], 0
                for le, c in zip((*child.bounds, math.inf), child.counts):
                    acc += c
                    cum.append(["+Inf" if le == math.inf else float(le), acc])
                entry.update(buckets=cum, sum=child.sum, count=child.count)
            else:
                entry["value"] = child.value
            series.append(entry)
        out = {"kind": self.kind, "help": self.help,
               "labels": list(self.label_names), "series": series}
        if self.overflows:
            out["overflows"] = self.overflows
        return out


class MetricsRegistry:
    """A process-local collection of metric families (module docstring).

    ``save_path`` arms flush-on-exit: the registry registers an
    ``atexit`` hook that writes the final snapshot as JSON, so counters
    incremented after the last explicit ``save()`` survive a process
    that exits without tearing the engine down (the journal ring gets
    the same hardening — doc/observability.md)."""

    def __init__(self, save_path: str | os.PathLike | None = None):
        self._families: dict[str, _Family] = {}
        self.save_path = None if save_path is None else os.fspath(save_path)
        self._atexit = None
        if self.save_path is not None:
            self._atexit = self.save
            atexit.register(self._atexit)

    def _register(self, name, help, kind, labels, max_series, buckets=None):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for ln in labels:
            if not _LABEL_RE.match(ln) or ln.startswith("__"):
                raise ValueError(f"invalid label name {ln!r} on {name}")
        fam = self._families.get(name)
        if fam is not None:
            if fam.kind != kind or fam.label_names != tuple(labels):
                raise ValueError(
                    f"metric {name} already registered as {fam.kind}"
                    f"{fam.label_names}, not {kind}{tuple(labels)}"
                )
            return fam
        fam = _Family(name, help, kind, labels, max_series, buckets)
        self._families[name] = fam
        return fam

    def counter(self, name: str, help: str = "", *, labels: Iterable[str] = (),
                max_series: int = 64) -> _Family:
        return self._register(name, help, "counter", tuple(labels), max_series)

    def gauge(self, name: str, help: str = "", *, labels: Iterable[str] = (),
              max_series: int = 64) -> _Family:
        return self._register(name, help, "gauge", tuple(labels), max_series)

    def histogram(self, name: str, help: str = "", *,
                  buckets: Iterable[float] = TTFT_BUCKETS,
                  labels: Iterable[str] = (), max_series: int = 64) -> _Family:
        bounds = tuple(float(b) for b in buckets)
        if not bounds or list(bounds) != sorted(set(bounds)):
            raise ValueError(f"histogram buckets must be sorted and unique: {bounds}")
        return self._register(name, help, "histogram", tuple(labels),
                              max_series, bounds)

    def snapshot(self) -> dict:
        """Every family's state as PLAIN dicts (JSON-safe; the actuator
        and :func:`to_prometheus_text` both consume exactly this)."""
        return {name: fam.snapshot() for name, fam in sorted(self._families.items())}

    def save(self, path: str | os.PathLike | None = None) -> str | None:
        """Write the snapshot as JSON to ``path`` (default: the
        registry's ``save_path``); returns the path written, or None
        when there is nowhere to write. Never raises on a full disk —
        metrics must not kill serving."""
        path = self.save_path if path is None else os.fspath(path)
        if path is None:
            return None
        try:
            tmp = f"{path}.tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(self.snapshot(), f, separators=(",", ":"))
            os.replace(tmp, path)
        except OSError:
            return None
        return path

    def close(self) -> None:
        """Final save + drop the atexit hook (idempotent)."""
        if self._atexit is not None:
            atexit.unregister(self._atexit)
            self._atexit = None
        self.save()


# ------------------------------------------------------------- exposition


def _escape(value: str) -> str:
    return value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_labels(labels: Mapping[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape(str(v))}"' for k, v in labels.items())
    return "{" + inner + "}"


def _fmt_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    f = float(v)
    return repr(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def to_prometheus_text(*snapshots) -> str:
    """Render registry snapshot(s) as one Prometheus text page. Each
    argument is either a ``Registry.snapshot()`` dict or a
    ``(snapshot, extra_labels)`` pair — the extra labels are injected
    into every series of that snapshot (the router tags each replica's
    snapshot ``{"replica": name}``). Families sharing a name across
    snapshots merge under ONE ``# HELP``/``# TYPE`` header; a kind
    mismatch raises."""
    merged: dict[str, dict] = {}
    for snap in snapshots:
        extra: Mapping[str, str] = {}
        if isinstance(snap, tuple):
            snap, extra = snap
        for name, fam in snap.items():
            dst = merged.get(name)
            if dst is None:
                dst = merged[name] = {"kind": fam["kind"], "help": fam.get("help", ""),
                                      "series": []}
            elif dst["kind"] != fam["kind"]:
                raise ValueError(
                    f"family {name} is {dst['kind']} in one snapshot and "
                    f"{fam['kind']} in another"
                )
            for s in fam["series"]:
                labels = {**extra, **s["labels"]}
                dst["series"].append({**s, "labels": labels})
    lines: list[str] = []
    for name in sorted(merged):
        fam = merged[name]
        if fam["help"]:
            lines.append(f"# HELP {name} {_escape(fam['help'])}")
        lines.append(f"# TYPE {name} {fam['kind']}")
        for s in fam["series"]:
            labels = s["labels"]
            if fam["kind"] == "histogram":
                for le, cum in s["buckets"]:
                    ll = {**labels, "le": le if le == "+Inf" else _fmt_value(le)}
                    lines.append(f"{name}_bucket{_fmt_labels(ll)} {int(cum)}")
                lines.append(f"{name}_sum{_fmt_labels(labels)} {_fmt_value(s['sum'])}")
                lines.append(f"{name}_count{_fmt_labels(labels)} {int(s['count'])}")
            else:
                lines.append(f"{name}{_fmt_labels(labels)} {_fmt_value(s['value'])}")
    return "\n".join(lines) + "\n" if lines else ""


_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^{}]*)\})?"
    r" (?P<value>[0-9eE+.\-]+|\+Inf|-Inf|NaN)$"
)
_LABEL_PAIR_RE = re.compile(r'^[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*"$')


def parse_prometheus_text(text: str) -> dict:
    """Strictly parse a Prometheus text page back into
    ``{family: {"type": kind, "samples": [(name, labels, value), ...]}}``.
    Raises ``ValueError`` on any malformed line, a sample without a
    preceding ``# TYPE``, a duplicate ``# TYPE``, or a histogram missing
    its ``_sum``/``_count``/``+Inf`` bucket — the strict round-trip
    validator."""
    families: dict[str, dict] = {}
    current: str | None = None

    def family_of(sample_name: str) -> str | None:
        for suffix in ("_bucket", "_sum", "_count"):
            base = sample_name.removesuffix(suffix)
            if base != sample_name and base in families and \
                    families[base]["type"] == "histogram":
                return base
        return sample_name if sample_name in families else None

    for i, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("# TYPE "):
            parts = line.split(" ")
            if len(parts) != 4 or parts[3] not in ("counter", "gauge", "histogram"):
                raise ValueError(f"line {i}: malformed TYPE line: {line!r}")
            name = parts[2]
            if name in families:
                raise ValueError(f"line {i}: duplicate TYPE for {name}")
            families[name] = {"type": parts[3], "samples": []}
            current = name
            continue
        if line.startswith("# HELP "):
            if len(line.split(" ", 3)) < 4:
                raise ValueError(f"line {i}: malformed HELP line: {line!r}")
            continue
        if line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"line {i}: malformed sample line: {line!r}")
        fam = family_of(m.group("name"))
        if fam is None or fam != current:
            raise ValueError(
                f"line {i}: sample {m.group('name')} outside its family's "
                f"TYPE block"
            )
        labels = {}
        raw = m.group("labels")
        if raw:
            for pair in re.split(r',(?=[a-zA-Z_])', raw):
                if not _LABEL_PAIR_RE.match(pair):
                    raise ValueError(f"line {i}: malformed label pair {pair!r}")
                k, v = pair.split("=", 1)
                labels[k] = v[1:-1]
        families[fam]["samples"].append(
            (m.group("name"), labels, m.group("value"))
        )
    for name, fam in families.items():
        if not fam["samples"]:
            raise ValueError(f"family {name} declared but has no samples")
        if fam["type"] == "histogram":
            kinds = {s[0].removeprefix(name) for s in fam["samples"]}
            if not {"_bucket", "_sum", "_count"} <= kinds:
                raise ValueError(f"histogram {name} missing _bucket/_sum/_count")
            if not any(
                s[1].get("le") == "+Inf" for s in fam["samples"]
                if s[0] == f"{name}_bucket"
            ):
                raise ValueError(f"histogram {name} missing the +Inf bucket")
    return families
