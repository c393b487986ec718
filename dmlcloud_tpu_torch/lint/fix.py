"""Mechanical autofixes for ``python -m dmlcloud_tpu_torch lint --fix``.

Counterpart of ``dmlcloud_tpu/lint/fix.py``. Two fix classes, both
IDEMPOTENT (a second run over fixed sources changes nothing):

- **rewrites** — findings whose repair is a pure token substitution on the
  finding line. Today that is DML108: ``time.time()`` → ``time.perf_counter()``
  (same call shape, monotonic clock, exactly the fix the rule's message
  prescribes). Only the literal ``time.time()`` spelling is rewritten; a
  ``from time import time`` alias is left for a human — a blind rename
  there would shadow other uses.
- **suppressions** — ``--fix-suppress`` appends a ``# dmllint:
  disable=<ids> -- TODO: justify`` directive to every remaining finding
  line, freezing the current findings so a gate can be turned on before
  every legacy hazard is repaired. Lines that already carry a ``dmllint:``
  directive are never touched (the human wrote something there).

Fixes are computed FROM findings, so suppression comments and ``--select``
scoping apply before anything is rewritten.
"""

from __future__ import annotations

import re

from .engine import Finding

__all__ = ["FIXABLE_RULES", "apply_fixes", "apply_suppressions"]

#: rules --fix can mechanically rewrite
FIXABLE_RULES = frozenset({"DML108"})

_TIME_TIME = re.compile(r"\btime\s*\.\s*time\(\)")


def _rewrite_dml108(line: str) -> str:
    return _TIME_TIME.sub("time.perf_counter()", line)


_REWRITERS = {"DML108": _rewrite_dml108}


def apply_fixes(findings: list[Finding]) -> dict[str, int]:
    """Apply the mechanical rewrites for every fixable finding, grouped by
    file. Returns ``{path: lines_changed}`` (paths untouched are absent).
    Callers re-lint afterwards — the fixed findings disappear, anything
    non-mechanical remains."""
    by_path: dict[str, list[Finding]] = {}
    for f in findings:
        if f.rule in _REWRITERS:
            by_path.setdefault(f.path, []).append(f)
    changed: dict[str, int] = {}
    for path, file_findings in sorted(by_path.items()):
        try:
            with open(path, "r", encoding="utf-8") as fh:
                lines = fh.readlines()
        except OSError:
            continue
        n = 0
        for f in file_findings:
            i = f.line - 1
            if not 0 <= i < len(lines):
                continue
            new = _REWRITERS[f.rule](lines[i])
            if new != lines[i]:
                lines[i] = new
                n += 1
        if n:
            with open(path, "w", encoding="utf-8") as fh:
                fh.writelines(lines)
            changed[path] = n
    return changed


def apply_suppressions(findings: list[Finding], justification: str = "TODO: justify") -> dict[str, int]:
    """Append a ``# dmllint: disable=<ids> -- <justification>`` directive
    to every finding line (ids on the same line are merged into one
    directive). Lines already carrying a ``dmllint:`` directive are left
    alone. Returns ``{path: lines_annotated}``."""
    by_line: dict[tuple[str, int], set[str]] = {}
    for f in findings:
        by_line.setdefault((f.path, f.line), set()).add(f.rule)
    by_path: dict[str, dict[int, set[str]]] = {}
    for (path, line), ids in by_line.items():
        by_path.setdefault(path, {})[line] = ids
    changed: dict[str, int] = {}
    for path, line_ids in sorted(by_path.items()):
        try:
            with open(path, "r", encoding="utf-8") as fh:
                lines = fh.readlines()
        except OSError:
            continue
        n = 0
        for lineno, ids in sorted(line_ids.items()):
            i = lineno - 1
            if not 0 <= i < len(lines) or "dmllint:" in lines[i]:
                continue
            stripped = lines[i].rstrip("\n")
            directive = f"  # dmllint: disable={','.join(sorted(ids))} -- {justification}"
            lines[i] = stripped + directive + "\n"
            n += 1
        if n:
            with open(path, "w", encoding="utf-8") as fh:
                fh.writelines(lines)
            changed[path] = n
    return changed
