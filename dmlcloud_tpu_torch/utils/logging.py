"""Logging handlers, the ``log.txt`` tee, the experiment header and the
run-start diagnostics.

Counterpart of ``dmlcloud_tpu/utils/logging.py``: rank-aware log handlers,
``IORedirector`` (stdout/stderr teed into the checkpoint directory's
``log.txt``), the banner, and the reproducibility block, whose accelerator
section reports the CUDA device (``torch.cuda.get_device_name``, the CUDA and
torch versions, and ``nvidia-smi --query-gpu=name,power.limit``) in place of the
TPU topology. The tee writes local paths only: the reference's remote
(``gs://``) log file has no counterpart here yet.
"""

from __future__ import annotations

import io
import logging
import os
import subprocess
import sys
from pathlib import Path

import torch

from .git import git_hash

logger = logging.getLogger("dmlcloud_tpu_torch")

BANNER = r"""
     _           _                 _      _
  __| |_ __ ___ | | ___ | ___  _  _| | __ | |_ _ __  _  _
 / _` | '_ ` _ \| |/ __|/ / _ \| || | |/ _` | __| '_ \| || |
| (_| | | | | | | | (__| | (_) | || | | (_) | |_| |_) | || |
 \__,_|_| |_| |_|_|\___|\_\___/ \_,_|_|\__,_|\__| .__/ \_,_|
                                                |_|   PyTorch / CUDA
"""

#: modules whose versions the diagnostics report when they are imported
ML_MODULES = ["torch", "numpy", "triton", "einops", "scipy"]


class IORedirector:
    """Tee ``sys.stdout``/``sys.stderr`` into a log file while still writing
    to the original streams. Installed root-only once the checkpoint dir
    exists; ``uninstall`` restores the originals."""

    class _Tee(io.TextIOBase):
        def __init__(self, parent: "IORedirector", stream):
            self.parent = parent
            self.stream = stream

        def write(self, s) -> int:
            n = self.stream.write(s)
            if self.parent.file is not None:
                try:
                    self.parent.file.write(s)
                except ValueError:  # file already closed
                    pass
            return n

        def flush(self) -> None:
            self.stream.flush()
            if self.parent.file is not None:
                try:
                    self.parent.file.flush()
                except ValueError:
                    pass

        @property
        def encoding(self):
            return getattr(self.stream, "encoding", "utf-8")

        def isatty(self) -> bool:
            return self.stream.isatty()

        def fileno(self) -> int:
            return self.stream.fileno()

    def __init__(self, log_file: str | Path):
        self.log_path = Path(log_file)
        self.file = None
        self._orig_stdout = None
        self._orig_stderr = None

    def install(self) -> None:
        if self.file is not None:
            return
        self.file = open(self.log_path, "a", buffering=1)
        self._orig_stdout = sys.stdout
        self._orig_stderr = sys.stderr
        sys.stdout = IORedirector._Tee(self, self._orig_stdout)
        sys.stderr = IORedirector._Tee(self, self._orig_stderr)

    def uninstall(self) -> None:
        if self.file is None:
            return
        sys.stdout = self._orig_stdout
        sys.stderr = self._orig_stderr
        self.file.close()
        self.file = None


class DevNullIO(io.TextIOBase):
    """A sink that swallows writes (the non-root progress table)."""

    def write(self, s) -> int:
        return len(s)

    def flush(self) -> None:
        pass


def add_log_handlers(logger_: logging.Logger | None = None, is_root: bool | None = None) -> None:
    """Root logs at INFO, other ranks at WARNING; records below WARNING go to
    stdout, WARNING and above to stderr."""
    logger_ = logger_ or logger
    for h in list(logger_.handlers):
        logger_.removeHandler(h)
    if is_root is None:
        from ..parallel.runtime import is_root as _is_root

        is_root = _is_root()
    logger_.setLevel(logging.INFO if is_root else logging.WARNING)

    stdout_handler = logging.StreamHandler(sys.stdout)
    stdout_handler.setLevel(logging.DEBUG)
    stdout_handler.addFilter(lambda rec: rec.levelno < logging.WARNING)
    stdout_handler.setFormatter(logging.Formatter("%(message)s"))
    logger_.addHandler(stdout_handler)

    stderr_handler = logging.StreamHandler(sys.stderr)
    stderr_handler.setLevel(logging.WARNING)
    stderr_handler.setFormatter(logging.Formatter("%(levelname)s: %(message)s"))
    logger_.addHandler(stderr_handler)


def flush_log_handlers(logger_: logging.Logger | None = None) -> None:
    for h in (logger_ or logger).handlers:
        h.flush()


def experiment_header(name: str | None, checkpoint_path: str | None, start_time) -> str:
    lines = [BANNER]
    lines.append(f"Experiment: {name if name else '[unnamed]'}")
    lines.append(f"Checkpoint: {checkpoint_path if checkpoint_path else '[disabled]'}")
    lines.append(f"Start time: {start_time}")
    return "\n".join(lines)


def _run(cmd: list[str]) -> str | None:
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return proc.stdout.strip() if proc.returncode == 0 else None


def accelerator_info() -> dict:
    """The CUDA device as torch and ``nvidia-smi`` see it; ``{"cuda": False}``
    without one."""
    if not torch.cuda.is_available():
        return {"cuda": False, "torch": torch.__version__}
    return {
        "cuda": True,
        "torch": torch.__version__,
        "cuda_version": torch.version.cuda,
        "device_count": torch.cuda.device_count(),
        "device_name": torch.cuda.get_device_name(0),
        "nvidia_smi": _run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]),
    }


def general_diagnostics() -> str:
    """The reproducibility block logged at run start: argv, cwd, host, git
    state, Python, the CUDA device, and imported ML module versions."""
    import getpass
    import socket

    lines = ["* GENERAL:"]
    lines.append(f"    - argv: {sys.argv}")
    lines.append(f"    - cwd: {os.getcwd()}")
    try:
        lines.append(f"    - host: {socket.gethostname()}")
        lines.append(f"    - user: {getpass.getuser()}")
    except (OSError, KeyError):
        pass
    h = git_hash()
    if h:
        lines.append(f"    - git-hash: {h}")
    lines.append(f"    - python: {sys.version.split()[0]}")

    lines.append("* ACCELERATORS:")
    acc = accelerator_info()
    if not acc["cuda"]:
        lines.append("    - no CUDA device")
    else:
        lines.append(f"    - {acc['device_count']}x {acc['device_name']}")
        lines.append(f"    - CUDA {acc['cuda_version']}, torch {acc['torch']}")
        if acc["nvidia_smi"]:
            for row in acc["nvidia_smi"].splitlines():
                lines.append(f"    - nvidia-smi: {row}")

    lines.append("* VERSIONS:")
    for mod in ML_MODULES:
        m = sys.modules.get(mod)
        version = getattr(m, "__version__", None) if m is not None else None
        if version:
            lines.append(f"    - {mod}: {version}")
    return "\n".join(lines)
