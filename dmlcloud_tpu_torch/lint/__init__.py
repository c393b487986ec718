"""``dmlcloud_tpu_torch.lint`` — the runtime retrace guard.

Counterpart of the part of ``dmlcloud_tpu/lint/`` that the compiled step uses:
:class:`TraceGuard` and :class:`RetraceError` (``lint/traceguard.py``). The
linter itself (rules, engine, CLI, the IR tier) is ROADMAP Queue 1 item 13.
"""

from .traceguard import RetraceError, TraceGuard

__all__ = ["TraceGuard", "RetraceError"]
