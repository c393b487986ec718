"""``python -m dmlcloud_tpu_torch lint`` — the CLI front end.

Counterpart of ``dmlcloud_tpu/lint/cli.py``, with the same flags, output
and exit codes.

Human output is one ``path:line:col: RULE message`` per finding (clickable
in editors/CI logs); ``--format=json`` (or the ``--json`` shorthand) emits
one stable machine-readable object (schema v2)::

    {
      "version": 2,
      "status": "clean" | "findings" | "parse_error",
      "files_scanned": 12,
      "findings": [{"rule", "path", "line", "col", "message", "context"}...],
      "counts": {"DML101": 2}
    }

``status`` distinguishes a DML999 parse failure (exit 2) from ordinary
findings (exit 1) — in v1 both looked like findings, so a crashed parse
was indistinguishable from a hazard in machine output. Every v1 key is
still present with the same meaning (the v2 compatibility contract).

``--format=github`` emits GitHub Actions workflow commands
(``::error file=...,line=...::``) so findings annotate the diff inline. ``--jobs N`` fans the
scan over a process pool (findings stay in deterministic path order; on a
single-core host the pool collapses to serial). ``--select``/``--ignore``
take exact ids and ``DML2xx``/``DML5xx`` family wildcards.

Whole-program / workflow flags:

- ``--no-callgraph`` skips the interprocedural DML5xx pass (module-local
  rules only).
- ``--cache [PATH]`` enables the incremental cache (lint/cache.py);
  unchanged files and everything they can't affect are reused.
- ``--changed`` (implies ``--cache``) additionally trusts git metadata:
  a file clean in ``git status`` now, clean when its entry was stored,
  under the same ``HEAD``, is reused without re-hashing its content.
  Any condition failing falls back to the content-hash check, so output
  stays identical to a cold run; without git metadata it degrades to
  plain ``--cache``.
- ``--baseline PATH`` filters findings recorded in a baseline file;
  ``--write-baseline PATH`` freezes the current findings into one.
- ``--fix`` applies the mechanical autofixes (lint/fix.py) and re-lints;
  ``--fix-suppress`` appends suppression directives to whatever remains.
- ``--ir`` asks for the DML6xx IR pass, the IR tier: ROADMAP Queue 1
  item 13c (after item 14). It raises ``NotImplementedError`` until then.

Exit codes: 0 clean, 1 findings, 2 parse/usage error. Pure stdlib — no
torch import, safe to run anywhere (pre-commit hooks, CPU-only CI).
"""

from __future__ import annotations

import argparse
import json
import sys

from .cache import DEFAULT_CACHE_PATH
from .engine import (
    IR_RULES, PARSE_ERROR_RULE, PROJECT_RULES, RULES, expand_rule_ids,
    iter_python_files, lint_paths,
)


def _parse_ids(spec: str) -> list[str]:
    ids = [p.strip() for p in spec.split(",") if p.strip()]
    expanded, unknown = expand_rule_ids(ids)
    if unknown:
        known = ", ".join(sorted(set(RULES) | set(PROJECT_RULES) | set(IR_RULES)))
        raise argparse.ArgumentTypeError(
            f"unknown rule id(s)/family wildcard(s) {', '.join(unknown)}; "
            f"known: {known} (families like DML2xx work too)"
        )
    return expanded


def _git_state() -> "tuple[str, frozenset[str]] | None":
    """``(HEAD sha, absolute dirty paths)`` for ``--changed``, or None
    when git metadata is unavailable (not a checkout, no git binary) —
    the cache then degrades to plain content hashing."""
    import os
    import subprocess

    try:
        head = subprocess.run(
            ["git", "rev-parse", "HEAD"],
            capture_output=True, text=True, timeout=10, check=True,
        ).stdout.strip()
        top = subprocess.run(
            ["git", "rev-parse", "--show-toplevel"],
            capture_output=True, text=True, timeout=10, check=True,
        ).stdout.strip()
        status = subprocess.run(
            ["git", "status", "--porcelain", "--no-renames"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    dirty = frozenset(
        os.path.abspath(os.path.join(top, line[3:].strip().strip('"')))
        for line in status.splitlines()
        if len(line) > 3
    )
    return head, dirty


def _github_escape(msg: str) -> str:
    """GitHub workflow commands are line-oriented; data is %-escaped."""
    return msg.replace("%", "%25").replace("\r", "%0D").replace("\n", "%0A")


def _baseline_keys(path: str) -> set[tuple] | None:
    """(rule, path, line) triples recorded in a baseline file, or None if
    it cannot be read/parsed (the caller reports and exits 2)."""
    try:
        with open(path, "r", encoding="utf-8") as f:
            data = json.load(f)
        return {(e["rule"], e["path"], int(e["line"])) for e in data["findings"]}
    except (OSError, ValueError, KeyError, TypeError):
        return None


def _write_baseline(path: str, findings) -> bool:
    payload = {
        "version": 1,
        "findings": [{"rule": f.rule, "path": f.path, "line": f.line} for f in findings],
    }
    try:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(payload, f, indent=2, sort_keys=True)
            f.write("\n")
    except OSError as e:
        print(f"lint: cannot write baseline {path}: {e}", file=sys.stderr)
        return False
    return True


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m dmlcloud_tpu_torch lint",
        description="Flow-aware hazard linter enforcing the training loop's "
        "sync-point contract, the concurrency contracts, and the "
        "interprocedural serving lifecycle contracts.",
    )
    parser.add_argument(
        "paths", nargs="*", default=["."],
        help="files and/or directories to lint recursively (default: .)",
    )
    parser.add_argument(
        "--format", choices=("text", "json", "github"), default=None,
        help="output format: text (default), json (stable schema v2), or "
        "github (GitHub Actions ::error annotations)",
    )
    parser.add_argument(
        "--json", action="store_true", help="shorthand for --format=json"
    )
    parser.add_argument(
        "--select", type=_parse_ids, default=None, metavar="IDS",
        help="comma-separated rule ids or families (DML2xx, DML5xx) to run (default: all)",
    )
    parser.add_argument(
        "--ignore", type=_parse_ids, default=None, metavar="IDS",
        help="comma-separated rule ids or families (DML2xx, DML5xx) to skip",
    )
    parser.add_argument(
        "--jobs", type=int, default=1, metavar="N",
        help="lint files on N worker processes (default 1; auto-collapses to "
        "serial on a single-core host — deterministic output either way)",
    )
    parser.add_argument(
        "--no-callgraph", action="store_true",
        help="skip the whole-program DML5xx pass (module-local rules only)",
    )
    parser.add_argument(
        "--ir", action="store_true",
        help="add the DML6xx IR pass (the IR tier: ROADMAP Queue 1 item 13c, "
        "not ported yet)",
    )
    parser.add_argument(
        "--cache", nargs="?", const=DEFAULT_CACHE_PATH, default=None, metavar="PATH",
        help=f"incremental cache file (default when given bare: {DEFAULT_CACHE_PATH}); "
        "unchanged files and their unaffected importers are reused",
    )
    parser.add_argument(
        "--changed", action="store_true",
        help="with --cache (implied if absent): trust git metadata — at the "
        "same HEAD the cache was written, files 'git status' reports clean "
        "skip even the content re-hash; findings stay identical to a cold "
        "run (no-op outside a git checkout)",
    )
    parser.add_argument(
        "--baseline", default=None, metavar="PATH",
        help="suppress findings recorded in this baseline file (see --write-baseline)",
    )
    parser.add_argument(
        "--write-baseline", default=None, metavar="PATH",
        help="freeze the current findings into a baseline file and exit 0",
    )
    parser.add_argument(
        "--fix", action="store_true",
        help="apply the mechanical autofixes (e.g. DML108 time.time -> "
        "time.perf_counter) in place, then re-lint and report what remains",
    )
    parser.add_argument(
        "--fix-suppress", action="store_true",
        help="append '# dmllint: disable=...' directives to every remaining "
        "finding line (use to bootstrap a gate over legacy code)",
    )
    parser.add_argument(
        "--list-rules", action="store_true", help="print the rule catalog and exit"
    )
    try:
        args = parser.parse_args(argv)
    except SystemExit as e:
        # argparse exits 2 on usage errors already; normalize --help's 0
        return int(e.code or 0)

    if args.format is not None and args.json and args.format != "json":
        print("lint: --json conflicts with --format", file=sys.stderr)
        return 2
    fmt = args.format or ("json" if args.json else "text")
    if args.jobs < 1:
        print(f"lint: --jobs must be >= 1, got {args.jobs}", file=sys.stderr)
        return 2

    if args.list_rules:
        for rid in sorted(set(RULES) | set(PROJECT_RULES) | set(IR_RULES)):
            info = RULES.get(rid) or PROJECT_RULES.get(rid) or IR_RULES[rid]
            scope = " [project]" if rid in PROJECT_RULES else (" [ir]" if rid in IR_RULES else "")
            print(f"{rid}  {info.title}{scope}")
        return 0

    baseline = None
    if args.baseline is not None:
        baseline = _baseline_keys(args.baseline)
        if baseline is None:
            print(f"lint: cannot read baseline {args.baseline}", file=sys.stderr)
            return 2

    if args.ir:
        raise NotImplementedError(
            "lint --ir (the DML6xx IR pass) is ROADMAP Queue 1 item 13c: the IR tier, after item 14"
        )

    git_state = None
    if args.changed:
        if args.cache is None:
            args.cache = DEFAULT_CACHE_PATH
        git_state = _git_state()

    def run():
        return lint_paths(
            args.paths,
            select=args.select,
            ignore=args.ignore,
            jobs=args.jobs,
            callgraph=not args.no_callgraph,
            cache=args.cache,
            ir=args.ir,
            git_state=git_state,
        )

    files_scanned = sum(1 for _ in iter_python_files(args.paths))
    findings = run()
    if baseline is not None:
        findings = [f for f in findings if (f.rule, f.path, f.line) not in baseline]

    if args.write_baseline is not None:
        if not _write_baseline(args.write_baseline, findings):
            return 2
        print(
            f"lint: baseline {args.write_baseline} written "
            f"({len(findings)} finding(s) frozen)",
            file=sys.stderr,
        )
        return 0

    if args.fix or args.fix_suppress:
        from .fix import apply_fixes, apply_suppressions

        if args.fix:
            changed = apply_fixes(findings)
            if changed:
                print(
                    f"lint: fixed {sum(changed.values())} finding(s) in "
                    f"{len(changed)} file(s)",
                    file=sys.stderr,
                )
                findings = run()
                if baseline is not None:
                    findings = [f for f in findings if (f.rule, f.path, f.line) not in baseline]
        if args.fix_suppress:
            remaining = [f for f in findings if f.rule != PARSE_ERROR_RULE]
            annotated = apply_suppressions(remaining)
            if annotated:
                print(
                    f"lint: suppressed {sum(annotated.values())} line(s) in "
                    f"{len(annotated)} file(s)",
                    file=sys.stderr,
                )
                findings = run()
                if baseline is not None:
                    findings = [f for f in findings if (f.rule, f.path, f.line) not in baseline]

    parse_error = any(f.rule == PARSE_ERROR_RULE for f in findings)
    status = "parse_error" if parse_error else ("findings" if findings else "clean")
    try:
        _emit(fmt, findings, files_scanned, status)
    except BrokenPipeError:
        # `lint ... | head` closed the pipe: still exit with the real status
        # (stdout redirected to devnull so the interpreter's exit flush
        # doesn't raise again)
        import os

        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
    if parse_error:
        return 2
    return 1 if findings else 0


def _emit(fmt: str, findings, files_scanned: int, status: str) -> None:
    if fmt == "json":
        counts: dict[str, int] = {}
        for f in findings:
            counts[f.rule] = counts.get(f.rule, 0) + 1
        print(
            json.dumps(
                {
                    "version": 2,
                    "status": status,
                    "files_scanned": files_scanned,
                    "findings": [f.to_dict() for f in findings],
                    "counts": {k: counts[k] for k in sorted(counts)},
                },
                sort_keys=True,
            )
        )
    elif fmt == "github":
        for f in findings:
            print(
                f"::error file={f.path},line={f.line},col={f.col},"
                f"title={f.rule}::{_github_escape(f.message)}"
            )
        noun = "file" if files_scanned == 1 else "files"
        print(
            f"::notice::dmlcloud_tpu_torch lint: {len(findings)} finding(s) in "
            f"{files_scanned} {noun} scanned"
        )
    else:
        for f in findings:
            print(f.format())
        noun = "file" if files_scanned == 1 else "files"
        if findings:
            print(f"{len(findings)} finding(s) in {files_scanned} {noun} scanned")
        else:
            print(f"clean: {files_scanned} {noun} scanned, 0 findings")


if __name__ == "__main__":
    sys.exit(main())
