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

The reference's ``trace``/``profile_steps`` (``jax.profiler``) and its xplane
``roofline``/``format_roofline`` readers have no counterpart here yet.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Any

import numpy as np
import torch

from ..telemetry import journal as _journal

__all__ = ["StallTimer", "StepTimer", "PEAK_BF16_FLOPS", "peak_flops_for_kind", "chip_peak_flops", "device_kind"]


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


def peak_flops_for_kind(kind: str) -> float | None:
    """Peak bf16 FLOP/s for a device name, or None if the table has no entry
    for it (a CPU, an unknown card): MFU against a made-up peak would be
    fiction, so callers skip the metric instead."""
    kind = kind.lower()
    for key in sorted(PEAK_BF16_FLOPS, key=len, reverse=True):
        if key in kind:
            return PEAK_BF16_FLOPS[key]
    return None


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
