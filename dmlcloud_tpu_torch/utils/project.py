"""User-project introspection: where is the script that launched this run?

A copy of ``dmlcloud_tpu/utils/project.py``: resolves the
entry-point script, the enclosing project directory (walking up past package
``__init__.py`` files), and runs subprocesses rooted there. Used by the git
capture in diagnostics so the recorded hash/diff is the *user's* project, not
the framework's install dir.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path


def script_path() -> Path | None:
    """Absolute path of the ``__main__`` script, or None in REPL/embedded use."""
    main = sys.modules.get("__main__")
    path = getattr(main, "__file__", None)
    if path is None:
        # setuptools console-script entry point: argv[0] is the shim.
        if sys.argv and sys.argv[0] not in ("", "-c"):
            p = Path(sys.argv[0])
            if p.exists():
                return p.resolve()
        return None
    return Path(path).resolve()


def script_dir() -> Path | None:
    p = script_path()
    return p.parent if p is not None else None


def project_dir() -> Path | None:
    """Walk upwards from the script dir past any package ``__init__.py`` files,
    returning the first non-package ancestor (the project root)."""
    d = script_dir()
    if d is None:
        return None
    while (d / "__init__.py").exists() and d.parent != d:
        d = d.parent
    return d


def run_in_project(cmd: list[str], **kwargs) -> subprocess.CompletedProcess | None:
    """Run ``cmd`` with cwd=the user's project dir (None-safe)."""
    d = project_dir()
    if d is None:
        return None
    kwargs.setdefault("capture_output", True)
    kwargs.setdefault("text", True)
    try:
        return subprocess.run(cmd, cwd=str(d), **kwargs)
    except OSError:
        return None
