"""Host stall timing around the places where the training loop reads from the device.

Counterpart of ``StallTimer`` in ``dmlcloud_tpu/utils/profiling.py``. CUDA work
is asynchronous: the host blocks only where it reads a value (``.item()``,
``.cpu()``) or synchronises. Every such block in the loop runs under
``measure()``, and the epoch's total is published as ``misc/host_stall_ms``.
"""

from __future__ import annotations

import time
from contextlib import contextmanager

import torch

__all__ = ["StallTimer"]


class StallTimer:
    """Accumulates the wall-clock the host spends blocked on the device.
    Nesting-safe: only the outermost ``measure()`` accumulates."""

    def __init__(self):
        self._ns = 0
        self._depth = 0
        self._outer_t0 = 0

    @contextmanager
    def measure(self):
        self._depth += 1
        if self._depth == 1:
            self._outer_t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            self._depth -= 1
            if self._depth == 0:
                self._ns += time.perf_counter_ns() - self._outer_t0

    def block(self, device: torch.device) -> None:
        """Wait for all queued work on ``device`` (the epoch-end sync)."""
        with self.measure():
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize(device)

    def fetch(self, value) -> float:
        """Read a scalar tensor to the host under the timer."""
        with self.measure():
            return float(value.item()) if isinstance(value, torch.Tensor) else float(value)

    @property
    def ms(self) -> float:
        return self._ns / 1e6

    def reset(self) -> None:
        self._ns = 0
