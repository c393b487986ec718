"""Host stall timing, step timing and the chip peak table for MFU.

Counterpart of ``dmlcloud_tpu/utils/profiling.py`` (``StallTimer`` :33,
``PEAK_BF16_FLOPS`` / ``peak_flops_for_kind`` / ``chip_peak_flops`` :152-182,
``StepTimer`` :285).

- ``StallTimer``: CUDA work is asynchronous, so the host blocks only where it
  reads a value (``.item()``, ``.cpu()``) or synchronises. Every such block in
  the loop runs under ``measure()``, and the epoch's total is published as
  ``misc/host_stall_ms``. A ``label`` attributes a block to a named bucket
  (``label_ms``; the goodput ledger splits ``checkpoint`` out of the total)
  and, with the telemetry journal armed, records it as a span.
- ``PEAK_BF16_FLOPS``: dense bf16 peaks keyed by ``torch.cuda.get_device_name()``
  substrings, the denominator of ``misc/mfu``.
- ``StepTimer``: dispatch-to-dispatch wall timer with percentile summaries.
- ``trace``/``profile_steps`` (reference :119-145, over ``jax.profiler``):
  ``torch.profiler`` with the card's kernel activity, written into ``logdir``
  as a Chrome trace (``trace.json``) whose operator events carry the FLOPs the
  profiler counted.
- ``roofline``/``format_roofline`` (reference :202-282, over the TPU's xplane
  op counters): the trace's device kernels grouped by category, against the
  card's peaks (``PEAK_BF16_FLOPS``, ``PEAK_HBM_BYTES``).
"""

from __future__ import annotations

import collections
import glob
import json
import os
import re
import time
from contextlib import contextmanager
from typing import Any

import numpy as np
import torch

from ..telemetry import journal as _journal

__all__ = ["StallTimer", "StepTimer", "PEAK_BF16_FLOPS", "PEAK_HBM_BYTES", "peak_flops_for_kind", "chip_peak_flops",
           "device_kind", "trace", "profile_steps", "roofline", "format_roofline", "TRACE_FILE"]


def _to_host(value: Any) -> Any:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu()
    if isinstance(value, dict):
        return {k: _to_host(v) for k, v in value.items()}
    return value


class StallTimer:
    """Accumulates the wall-clock the host spends blocked on the device or on
    checkpoint commits. Nesting-safe: only the outermost ``measure()``
    accumulates, so nested blocks are never counted twice."""

    def __init__(self):
        self._ns = 0
        self._depth = 0
        self._outer_t0 = 0
        self._outer_label: str | None = None
        #: label -> accumulated ns of outermost spans measured with that label
        self._label_ns: dict[str, int] = {}

    @contextmanager
    def measure(self, label: str | None = None):
        """Time a host-blocked span. ``label`` attributes the outermost span
        to a named bucket (``label_ms``) and, when the telemetry journal is
        armed, emits it as a span: of that kind if the label is one of
        ``SPAN_KINDS``, else as ``host_stall`` labelled with it."""
        self._depth += 1
        if self._depth == 1:
            self._outer_t0 = time.perf_counter_ns()
            self._outer_label = label
        try:
            yield
        finally:
            self._depth -= 1
            if self._depth == 0:
                t1 = time.perf_counter_ns()
                dt = t1 - self._outer_t0
                self._ns += dt
                label = self._outer_label
                if label is not None:
                    self._label_ns[label] = self._label_ns.get(label, 0) + dt
                    if _journal.active_journal() is not None:
                        kind = label if label in _journal.SPAN_KINDS else "host_stall"
                        _journal.emit(kind, self._outer_t0 / 1e9, t1 / 1e9, label=None if kind == label else label)

    def block(self, device: torch.device, label: str | None = "metric_readback") -> None:
        """Wait for all queued work on ``device`` (the epoch-end sync)."""
        with self.measure(label=label):
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize(device)

    def fetch(self, value: Any, label: str | None = "metric_readback") -> Any:
        """Read ``value`` to the host under the timer: a tensor comes back as
        a CPU tensor, a dict of values as a dict of them, anything else as
        it is."""
        with self.measure(label=label):
            return _to_host(value)

    @property
    def ms(self) -> float:
        return self._ns / 1e6

    def label_ms(self, label: str) -> float:
        """Accumulated ms of outermost spans measured under ``label``."""
        return self._label_ns.get(label, 0) / 1e6

    def reset(self) -> None:
        self._ns = 0
        self._label_ns.clear()


#: Dense bf16 tensor-core peaks in FLOP/s by device-name substring, from
#: NVIDIA's H100 Tensor Core GPU datasheet (the sparse figures halved): SXM
#: 989.4 TFLOP/s (``torch.cuda.get_device_name()`` reads "NVIDIA H100 80GB
#: HBM3"), NVL 835 and PCIe 756. The longest matching key wins, so the
#: specific parts are matched before the plain "h100".
PEAK_BF16_FLOPS = {
    "h100 pcie": 756e12,
    "h100 nvl": 835e12,
    "h100": 989.4e12,
}


#: HBM bandwidth in bytes/s by device-name substring, from the same datasheet:
#: SXM 3.35 TB/s, NVL 3.9, PCIe 2.0.
PEAK_HBM_BYTES = {
    "h100 pcie": 2.0e12,
    "h100 nvl": 3.9e12,
    "h100": 3.35e12,
}


def _by_longest_key(table: dict[str, float], kind: str) -> float | None:
    kind = kind.lower()
    for key in sorted(table, key=len, reverse=True):
        if key in kind:
            return table[key]
    return None


def peak_flops_for_kind(kind: str) -> float | None:
    """Peak bf16 FLOP/s for a device name, or None if the table has no entry
    for it (a CPU, an unknown card): MFU against a made-up peak would be
    fiction, so callers skip the metric instead."""
    return _by_longest_key(PEAK_BF16_FLOPS, kind)


def device_kind(device: str | torch.device | None = None) -> str:
    """The name the peak table is keyed by: ``torch.cuda.get_device_name`` for
    a CUDA device, the device type (``"cpu"``) otherwise. ``None`` means the
    first card, or the CPU without one."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def chip_peak_flops(device: str | torch.device | None = None) -> float | None:
    """Peak bf16 FLOP/s of ``device`` (default: the first card), or None for
    a device the table does not know."""
    return peak_flops_for_kind(device_kind(device))


#: the Chrome trace ``trace`` writes into its ``logdir``
TRACE_FILE = "trace.json"


@contextmanager
def trace(logdir: str):
    """Record a ``torch.profiler`` trace of the body into ``logdir``/``TRACE_FILE``:
    host operators, and the card's kernels, copies and memsets when a card is
    present. Every operator event's ``args`` carry ``"flops"``, the FLOPs the
    profiler's formulas count for it (matmuls, convolutions; 0 elsewhere),
    which ``roofline`` credits to the kernels the operator launched."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, TRACE_FILE)
    with profile(activities=activities, record_shapes=True, with_flops=True) as prof:
        yield prof
    prof.export_chrome_trace(path)
    flops = {e.id: int(e.flops) for e in prof.events() if getattr(e, "flops", 0)}
    with open(path) as f:
        doc = json.load(f)
    for ev in doc.get("traceEvents", []):
        if ev.get("cat") == "cpu_op":
            args = ev.setdefault("args", {})
            args["flops"] = flops.get(args.get("External id"), 0)
    with open(path, "w") as f:
        json.dump(doc, f)


def profile_steps(fn, n: int, logdir: str, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` ``n`` times under ``trace(logdir)``; returns
    the last result (the card synchronised before the trace closes, so the
    trace covers the device work, not just its launches)."""
    result = None
    with trace(logdir):
        for _ in range(n):
            result = fn(*args, **kwargs)
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
    return result


#: ``roofline``'s categories of device kernels, by name, in the order tried
#: (the flash kernels by the names ``ops.flash_attention.LAUNCHES`` counts)
_KERNEL_CATEGORIES = (
    (re.compile(r"\b(flash_(?:fwd|bwd_dq|bwd_dkv)(?:_tc)?)_kernel"), None),
    (re.compile(r"nccl", re.I), "nccl"),
    (re.compile(r"gemm|cutlass|xmma|nvjet|cublas|matmul|sm90_", re.I), "gemm"),
    (re.compile(r"^triton_"), "triton fused"),
    (re.compile(r"reduce|reduction|norm|softmax", re.I), "reduction"),
    (re.compile(r"copy|memcpy|memset|cast|convert", re.I), "copy/cast"),
)
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _kernel_category(ev: dict) -> str:
    if ev.get("cat") in ("gpu_memcpy", "gpu_memset"):
        return "copy/cast"
    name = ev.get("name", "")
    for pattern, category in _KERNEL_CATEGORIES:
        m = pattern.search(name)
        if m:
            return category or m.group(1)
    return "elementwise/other"


def roofline(trace_dir: str, steps: int = 1) -> tuple[dict, list[dict]]:
    """Aggregate a ``trace`` of the card by kernel category. Returns
    ``(peaks, rows)``: ``peaks`` has the device name and its peaks (bf16
    TFLOP/s, HBM GB/s, from ``PEAK_BF16_FLOPS``/``PEAK_HBM_BYTES``; 0 for a
    device the tables do not know); each row has ``category``, ``time_frac``,
    ``ms_per_step``, ``tflops`` (achieved), ``gbps`` (achieved),
    ``n_per_step``, the reference's keys. ``steps`` = timed steps inside the
    trace.

    Categories: ``gemm`` (cuBLAS/CUTLASS), one row per flash kernel
    (``flash_fwd_tc``, ``flash_bwd_dq_tc``, ...), ``triton fused`` (Inductor's
    kernels), ``reduction``, ``copy/cast`` (memcpy/memset and conversion
    kernels), ``nccl``, and ``elementwise/other``.

    Counter conventions: ``tflops`` comes from the FLOPs the profiler counted
    for the operator that launched a kernel (a multiply-add is TWO ops;
    shared by that operator's kernels in proportion to their time, by its
    GEMM kernels alone when it launched any), and is 0 for kernels whose
    operator has no formula: Inductor's fused kernels and the flash kernels'
    custom ops. The profiler records no bytes, so
    ``gbps`` is 0 in every row (the TPU's op counters give both)."""
    paths = sorted(glob.glob(os.path.join(trace_dir, "*.json")), key=os.path.getmtime)
    if not paths:
        raise FileNotFoundError(f"no Chrome trace (*.json) under {trace_dir} (not a profiling.trace dir?)")
    with open(paths[-1]) as f:
        doc = json.load(f)
    events = doc.get("traceEvents", [])
    kernels = [e for e in events if e.get("ph") == "X" and e.get("cat") in _DEVICE_CATS]
    if not kernels:
        raise ValueError("no device kernel events in this trace (was it recorded on a card?)")
    props = doc.get("deviceProperties") or [{}]
    name = props[0].get("name", "?")
    peaks = {
        "device": name,
        "peak_tflops": (peak_flops_for_kind(name) or 0.0) / 1e12,
        "peak_hbm_gbps": (_by_longest_key(PEAK_HBM_BYTES, name) or 0.0) / 1e9,
    }
    op_flops = {e["args"]["External id"]: float(e["args"].get("flops", 0) or 0) for e in events
                if e.get("cat") == "cpu_op" and "External id" in e.get("args", {})}
    # an operator's FLOPs are shared by the kernels it launched, in proportion
    # to their time: by its GEMM kernels alone when it launched any (a matmul's
    # casts and copies do none of its arithmetic)
    cats = [_kernel_category(ev) for ev in kernels]
    op_us: dict = collections.defaultdict(lambda: [0.0, 0.0])  # all kernels' us, GEMM kernels' us
    for ev, cat in zip(kernels, cats):
        us = op_us[ev.get("args", {}).get("External id")]
        us[0] += float(ev.get("dur", 0.0))
        us[1] += float(ev.get("dur", 0.0)) if cat == "gemm" else 0.0
    agg = collections.defaultdict(lambda: [0.0, 0.0, 0])  # us, flops, n
    for ev, cat in zip(kernels, cats):
        row = agg[cat]
        us = float(ev.get("dur", 0.0))
        row[0] += us
        ext = ev.get("args", {}).get("External id")
        total, gemm = op_us[ext]
        if op_flops.get(ext) and (cat == "gemm" or not gemm) and (gemm or total) > 0:
            row[1] += op_flops[ext] * us / (gemm or total)
        row[2] += 1
    total_us = sum(v[0] for v in agg.values()) or 1.0
    rows = [
        {
            "category": cat,
            "time_frac": us / total_us,
            "ms_per_step": us / 1e3 / steps,
            "tflops": fl / us / 1e6 if us else 0.0,
            "gbps": 0.0,
            "n_per_step": n // steps,
        }
        for cat, (us, fl, n) in sorted(agg.items(), key=lambda kv: -kv[1][0])
    ]
    return peaks, rows


def format_roofline(peaks: dict, rows: list[dict], min_frac: float = 0.001) -> str:
    """Human-readable roofline table, the reference's text."""
    out = [
        f"device: {peaks['device']}  peak {peaks['peak_tflops']:.0f} TF/s, "
        f"HBM {peaks['peak_hbm_gbps']:.0f} GB/s",
        f"{'category':<28}{'time%':>7}{'ms/step':>9}{'TFLOP/s':>9}{'GB/s':>8}{'n/step':>8}",
    ]
    for r in rows:
        if r["time_frac"] < min_frac:
            continue
        out.append(
            f"{r['category']:<28}{r['time_frac'] * 100:>6.1f}%{r['ms_per_step']:>8.2f}"
            f"{r['tflops']:>9.1f}{r['gbps']:>8.0f}{r['n_per_step']:>8}"
        )
    total_ms = sum(r["ms_per_step"] for r in rows)
    tf = sum(r["tflops"] * r["ms_per_step"] for r in rows) / total_ms if total_ms else 0.0
    pct = f" ({tf / peaks['peak_tflops'] * 100:.0f}% of peak)" if peaks["peak_tflops"] else ""
    out.append(f"total: {total_ms:.2f} ms/step on device; aggregate {tf:.1f} TFLOP/s{pct}")
    return "\n".join(out)


class StepTimer:
    """Dispatch-to-dispatch step timer with percentile summaries."""

    def __init__(self):
        self._t: list[float] = []
        self._last: int | None = None

    def tick(self) -> None:
        now = time.perf_counter_ns()
        if self._last is not None:
            self._t.append((now - self._last) / 1e6)
        self._last = now

    @property
    def count(self) -> int:
        return len(self._t)

    def summary(self) -> dict[str, float]:
        if not self._t:
            return {}
        arr = np.asarray(self._t)
        return {
            "mean_ms": float(arr.mean()),
            "p50_ms": float(np.percentile(arr, 50)),
            "p95_ms": float(np.percentile(arr, 95)),
            "p99_ms": float(np.percentile(arr, 99)),
            "max_ms": float(arr.max()),
            "total_ms": float(arr.sum()),
        }

    def reset(self) -> None:
        """Forget all intervals and the last tick, so the next ``tick()``
        starts a fresh sequence (no interval spans the reset)."""
        self._t.clear()
        self._last = None
