"""Git capture for reproducibility diagnostics.

A copy of ``dmlcloud_tpu/utils/git.py``: hash + uncontextualised diff of the
*user project* (see utils/project.py), recorded into the experiment header so
every run is attributable to an exact source state.
"""

from __future__ import annotations

from .project import run_in_project


def git_hash(short: bool = False) -> str | None:
    cmd = ["git", "rev-parse", "--short" if short else "--verify", "HEAD"]
    if short:
        cmd = ["git", "rev-parse", "--short", "HEAD"]
    proc = run_in_project(cmd)
    if proc is None or proc.returncode != 0:
        return None
    return proc.stdout.strip() or None


def git_diff() -> str | None:
    """``git diff -U0 --no-color HEAD`` in the user project — the minimal diff
    that, with the hash, exactly reconstructs the launched source."""
    proc = run_in_project(["git", "diff", "-U0", "--no-color", "HEAD"])
    if proc is None or proc.returncode != 0:
        return None
    return proc.stdout
