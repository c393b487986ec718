"""``dmlcloud_tpu_torch.lint`` — the AST-based hazard linter and the runtime
retrace guard.

Counterpart of ``dmlcloud_tpu/lint/``: its source tier and its whole-program
tier. A pure-stdlib AST pass detects, at review time and on the CPU, the
hazard patterns the training loop exists to avoid — the things that silently
claw the overlap back when the next ``Stage`` subclass reintroduces them:

==========  ============================================================
DML101      host sync inside step/epoch code (``.item()``, ``.tolist()``,
            ``.cpu()``, ``.numpy()``, ``float()`` of a tensor, an
            unaccounted ``torch.cuda.synchronize()``, ``print`` in a step)
DML102      Python/NumPy RNG inside a step fn — a constant under
            ``torch.compile``, outside the seeded torch generators
DML104      data-dependent ``if``/``while``/iteration on tensor values in
            a step fn (runtime companion: :class:`TraceGuard`)
DML105      blocking ``checkpoint.save``/``wandb`` calls inside the epoch
            loop — serialization/network on the training thread
DML106      wall-clock timing of CUDA launches without a device sync —
            benchmarks that measure launch cost, not execution
DML107      ``torch.compile`` call inside a loop body — re-captures and
            re-compiles every iteration
DML108      ``time.time()`` for step timing — NTP steps corrupt durations
DML209      a packed pipeline whose model call or loss drops segment_ids
DML214      blocking file I/O inside step/epoch code
DML301      shared attribute locked on one side of a thread boundary only
DML302      ``time.sleep`` polling loop where an Event/Condition exists
DML501      ``KVBlockPool.alloc``/``PrefixCache.lock`` reference leaked on
            some path out of the owning scope (whole-program)
DML502      paged ``scatter_tokens`` write reachable without a preceding
            COW guard/fork, across modules and import renames
DML503      terminate/finalize-family path exiting with zero or 2+
            ``TERMINAL_STATUSES`` stamps — the single-exit contract
DML504      DML301's lockset check across module boundaries
==========  ============================================================

DML103 (an undonated jitted train step) has no torch counterpart:
``torch.compile`` takes no donation and the optimizer updates in place. The
sharding and donation families (``rules_sharding.py``, ``rules_perf.py``) and
the runtime sanitizer are ROADMAP Queue 1 item 13b; the IR tier
(``verify``, DML6xx) is item 13c, after item 14.

DML5xx run in the whole-program pass of ``lint_paths`` (lint/callgraph.py
summaries + lint/lifecycle.py rules; ``--no-callgraph`` disables). The
incremental cache (lint/cache.py, ``--cache``) re-lints only changed
files and their reverse importers; ``--fix`` applies the mechanical
repairs in lint/fix.py.

Entry points: ``lint_source``/``lint_file``/``lint_paths`` (library),
``python -m dmlcloud_tpu_torch lint`` (CLI; ``--format=github``, ``--jobs
N``), and ``TrainingPipeline(lint="warn"|"error")`` (lints registered Stage
subclasses before any device work). Suppress a finding with ``# dmllint:
disable=DML101 -- justification`` (family wildcards like ``DML1xx`` work).
"""

from .engine import (  # noqa: F401
    Finding,
    IR_RULES,
    LintError,
    PROJECT_RULES,
    RULES,
    build_project_context,
    lint_file,
    lint_paths,
    lint_source,
)
from . import rules  # noqa: F401  — importing registers the rules
from . import rules_data  # noqa: F401  — DML209/DML214 data-plane family
from . import rules_concurrency  # noqa: F401  — DML3xx concurrency family
from . import lifecycle  # noqa: F401  — DML5xx whole-program lifecycle family
from .cache import DEFAULT_CACHE_PATH, LintCache  # noqa: F401
from .callgraph import ProjectGraph, summarize_module  # noqa: F401
from .fix import FIXABLE_RULES, apply_fixes, apply_suppressions  # noqa: F401
from .traceguard import RetraceError, TraceGuard  # noqa: F401

__all__ = [
    "DEFAULT_CACHE_PATH",
    "FIXABLE_RULES",
    "Finding",
    "IR_RULES",
    "LintCache",
    "LintError",
    "PROJECT_RULES",
    "ProjectGraph",
    "RULES",
    "RetraceError",
    "TraceGuard",
    "apply_fixes",
    "apply_suppressions",
    "build_project_context",
    "lint_file",
    "lint_paths",
    "lint_source",
    "summarize_module",
]
