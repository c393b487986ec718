"""Minimal live console table for per-epoch progress.

A copy of ``dmlcloud_tpu/utils/table.py`` (host Python). A self-contained
stand-in for the ``progress_table`` package with the subset of the API the
Stage layer needs: named columns, cell assignment, one printed row per
epoch, live in-place updates of the in-progress row DURING the epoch, and a
close that draws the bottom border.

Live updates are carriage-return rewrites sent ONLY to a real terminal: when
stdout is the IORedirector tee, the rewrite targets the underlying console
stream so ``log.txt`` stays a clean one-row-per-epoch plain-ASCII record,
and when output is not a TTY at all (Slurm files, CI) live rendering is
disabled entirely.
"""

from __future__ import annotations

import logging
import sys
from typing import Any, Callable

_logger = logging.getLogger(__name__)

#: ANSI foreground codes for the ``color`` column option (progress_table
#: API parity). Colors are applied ONLY to live console rewrites — final
#: rows go through the IORedirector tee and must keep log.txt plain-ASCII.
_ANSI = {
    "black": "30", "red": "31", "green": "32", "yellow": "33",
    "blue": "34", "magenta": "35", "cyan": "36", "white": "37",
}

_ALIGN = {"left": "<", "center": "^", "right": ">"}

_AGGREGATES: dict[str, Callable[[Any, Any, int], Any]] = {
    "sum": lambda acc, v, n: acc + v,
    "mean": lambda acc, v, n: acc + (v - acc) / n,
    "min": lambda acc, v, n: min(acc, v),
    "max": lambda acc, v, n: max(acc, v),
}


class ProgressTable:
    def __init__(self, file=None, min_width: int = 10):
        self.file = file or sys.stdout
        self.min_width = min_width
        self.columns: list[str] = []
        self.widths: dict[str, int] = {}
        self.formatters: dict[str, Callable[[Any], str]] = {}
        self.colors: dict[str, str] = {}
        self.aligns: dict[str, str] = {}
        self.aggregates: dict[str, str] = {}
        self._agg_counts: dict[str, int] = {}
        self.row: dict[str, Any] = {}
        self._live_values: dict[str, Any] = {}  # display overlay, never committed
        self._header_printed = False
        self._closed = False
        self._live_pending = False

    def add_column(
        self,
        name: str,
        width: int | None = None,
        formatter: Callable[[Any], str] | None = None,
        color: str | None = None,
        alignment: str | None = None,
        aggregate: str | None = None,
        **extra: Any,
    ) -> None:
        """Register a column. ``color``/``alignment``/``aggregate`` follow
        the third-party ``progress_table`` API the reference forwards its
        ``table_columns`` dicts to (reference stage.py:113-130,188-205):
        aggregate in {sum, mean, min, max} folds repeated assignments within
        an epoch; unknown extras are ignored with a debug note instead of
        breaking a ``table_columns`` override written for that package."""
        if self._header_printed:
            raise RuntimeError("cannot add columns after the first row")
        if name in self.columns:
            return
        self.columns.append(name)
        self.widths[name] = max(width or 0, len(name), self.min_width)
        if formatter:
            self.formatters[name] = formatter
        if color is not None:
            if str(color).lower() in _ANSI:
                self.colors[name] = _ANSI[str(color).lower()]
            else:
                _logger.debug("ProgressTable: unknown color %r for column %r ignored", color, name)
        if alignment is not None:
            if str(alignment).lower() in _ALIGN:
                self.aligns[name] = _ALIGN[str(alignment).lower()]
            else:
                _logger.debug("ProgressTable: unknown alignment %r for column %r ignored", alignment, name)
        if aggregate is not None:
            if str(aggregate).lower() in _AGGREGATES:
                self.aggregates[name] = str(aggregate).lower()
            else:
                _logger.debug("ProgressTable: unknown aggregate %r for column %r ignored", aggregate, name)
        if extra:
            _logger.debug("ProgressTable: ignoring unsupported column options %s for %r", sorted(extra), name)

    def __setitem__(self, name: str, value: Any) -> None:
        if name not in self.columns:
            self.add_column(name)
        agg = self.aggregates.get(name)
        if agg is not None and name in self.row and self.row[name] is not None and value is not None:
            n = self._agg_counts.get(name, 1) + 1
            self._agg_counts[name] = n
            self.row[name] = _AGGREGATES[agg](self.row[name], value, n)
        else:
            self._agg_counts[name] = 1
            self.row[name] = value

    def update(self, name: str, value: Any) -> None:
        self[name] = value

    def _fmt(self, name: str, value: Any) -> str:
        if value is None:
            return ""
        if name in self.formatters:
            return self.formatters[name](value)
        if isinstance(value, float):
            return f"{value:.5g}"
        try:
            import numpy as np

            if isinstance(value, np.floating) or (isinstance(value, np.ndarray) and value.ndim == 0):
                return f"{float(value):.5g}"
        except Exception:
            pass
        return str(value)

    def _border(self, left: str, mid: str, right: str) -> str:
        return left + mid.join("─" * (self.widths[c] + 2) for c in self.columns) + right

    def _print(self, s: str) -> None:
        print(s, file=self.file, flush=True)

    def _print_header(self) -> None:
        self._print(self._border("┌", "┬", "┐"))
        cells = " │ ".join(f"{c:^{self.widths[c]}}" for c in self.columns)
        self._print(f"│ {cells} │")
        self._print(self._border("├", "┼", "┤"))
        self._header_printed = True

    def live_target(self):
        """The raw console stream for in-place rewrites, or None when live
        rendering is off (not a TTY / non-root DevNullIO). Unwraps the
        IORedirector tee so the rewrites never reach log.txt."""
        stream = self.file
        inner = getattr(stream, "stream", None)  # IORedirector._Tee wraps the console
        if inner is not None and hasattr(inner, "write"):
            stream = inner
        try:
            return stream if stream.isatty() else None
        except Exception:
            return None

    def live(self, values: dict[str, Any]) -> None:
        """Rewrite the in-progress row in place with ``values`` (unknown
        column names ignored). No-op without a live console."""
        target = self.live_target()
        if target is None or self._closed or not self.columns:
            return
        for name, value in values.items():
            if name in self.columns:
                self._live_values[name] = value
        if not self._header_printed:
            self._print_header()
        cells = " │ ".join(self._cell(c, live=True) for c in self.columns)
        target.write(f"\r│ {cells} │")
        target.flush()
        self._live_pending = True

    def _finish_live(self) -> None:
        if not self._live_pending:
            return
        target = self.live_target()
        if target is not None:
            target.write("\r")  # final row overwrites the live one (same width)
            target.flush()
        self._live_pending = False

    def _cell(self, name: str, live: bool = False) -> str:
        # live rewrites read the display overlay first; committed rows use
        # only real assignments, so live() can never pollute an aggregate
        value = self._live_values.get(name, self.row.get(name)) if live else self.row.get(name)
        text = f"{self._fmt(name, value):{self.aligns.get(name, '>')}{self.widths[name]}}"
        # color only the live console rewrite — final rows ride the tee and
        # log.txt must stay plain-ASCII
        code = self.colors.get(name) if live else None
        return f"\x1b[{code}m{text}\x1b[0m" if code else text

    def next_row(self) -> None:
        if not self.columns:
            return
        if not self._header_printed:
            self._print_header()
        self._finish_live()
        cells = " │ ".join(self._cell(c) for c in self.columns)
        self._print(f"│ {cells} │")
        self.row = {}
        self._agg_counts = {}
        self._live_values = {}

    def close(self) -> None:
        if self._closed:
            return
        self._finish_live()
        if self._header_printed:
            self._print(self._border("└", "┴", "┘"))
        self._closed = True
