"""TraceGuard — the runtime companion of the linter's retrace rule.

Counterpart of ``dmlcloud_tpu/lint/traceguard.py``. Static analysis catches
the *lexical* retrace hazards; it cannot see a batch whose shape drifts. The
guard catches those at runtime: it wraps a compiled callable and reads its
signature count (``fn._cache_size()``, which ``compile.PrecompiledStep``
reports) after every call — the count growing past ``max_traces`` means the
step compiled again, i.e. something in the call signature was not stable.

Usage::

    step = TraceGuard(PrecompiledStep(step_fn), max_traces=1)
    for batch in ds:
        metrics = step(batch)   # raises RetraceError on a new signature

``action="warn"`` logs instead of raising (one message per growth event) —
the right mode for production loops where a recompile is a perf bug, not a
correctness bug. The guard costs one int comparison per call and never
touches device values.
"""

from __future__ import annotations

import logging

__all__ = ["TraceGuard", "RetraceError"]

_logger = logging.getLogger(__name__)


class RetraceError(RuntimeError):
    """A guarded compiled function compiled more distinct signatures than allowed."""


class TraceGuard:
    """Wrap a compiled callable and watch its signature count across calls.

    Parameters:
        fn: the compiled callable (anything exposing ``_cache_size``;
            callables without it pass through unguarded).
        max_traces: how many distinct compilations are legitimate (1 for a
            fixed-shape train step; N for N intentional shape buckets).
        action: ``"raise"`` (default) raises :class:`RetraceError`;
            ``"warn"`` logs a warning once per growth event.
        name: label used in messages (default: the wrapped fn's ``__name__``).
    """

    def __init__(self, fn, *, max_traces: int = 1, action: str = "raise", name: str | None = None):
        if action not in ("raise", "warn"):
            raise ValueError(f"action must be 'raise' or 'warn', got {action!r}")
        if max_traces < 1:
            raise ValueError(f"max_traces must be >= 1, got {max_traces}")
        self._fn = fn
        self.max_traces = int(max_traces)
        self.action = action
        self.name = name or getattr(fn, "__name__", None) or type(fn).__name__
        self.calls = 0
        self._last_reported = 0

    def cache_size(self) -> int | None:
        """Current number of distinct compilations, or None if the wrapped
        callable does not expose a cache."""
        probe = getattr(self._fn, "_cache_size", None)
        if callable(probe):
            try:
                return int(probe())
            except Exception:
                return None
        return None

    def __call__(self, *args, **kwargs):
        out = self._fn(*args, **kwargs)
        self.calls += 1
        n = self.cache_size()
        if n is not None and n > self.max_traces and n > self._last_reported:
            self._last_reported = n
            msg = (
                f"TraceGuard[{self.name}]: {n} distinct traces after "
                f"{self.calls} calls (allowed {self.max_traces}) — the call "
                "signature is not stable (drifting shapes/dtypes, or "
                "data-dependent structure); each retrace is a full compilation"
            )
            if self.action == "raise":
                raise RetraceError(msg)
            _logger.warning(msg)
        return out
