"""Core of ``dmlcloud_tpu_torch.lint``: AST contexts, suppression comments,
the rule registry, and the lint entry points.

Counterpart of ``dmlcloud_tpu/lint/engine.py``. The linter is pure stdlib
(``ast`` + ``tokenize``): it imports neither torch nor anything it lints, so
it runs on any CPU box where review happens. Rules fire only inside the
*hazard contexts* the training loop cares about, so a data-loading helper
full of ``np.random`` and ``float()`` lints clean:

- **step context** — code that runs once per step on the device, possibly
  under ``torch.compile``: ``step`` / ``train_step`` / ``val_step`` methods
  of ``*Stage`` classes, any function decorated with ``torch.compile``
  (bare, called with options, or as ``functools.partial(torch.compile,
  ...)``), and local functions passed to a ``torch.compile(...)`` call.
  Their parameters (but ``self``/``cls``) carry tensors.
- **epoch context** — the host-side hot loop: ``run_epoch`` /
  ``train_epoch`` / ``val_epoch`` methods of ``*Stage`` classes.

Host blocks that the training loop *accounts for* are sanctioned: anything
lexically inside a ``with <x>.measure():`` block, and ``fetch``/``block``
calls on a stall-timer receiver (``utils.profiling.StallTimer``), never
fire DML101/DML105.

Suppression comments (all forms take a comma list of rule ids or ``all``)::

    x = loss.item()  # dmllint: disable=DML101 -- eager bisection path
    # dmllint: disable-next-line=DML101,DML104
    # dmllint: disable-file=DML106

Everything after the id list is free-form justification.
"""

from __future__ import annotations

import ast
import io
import os
import re
import tokenize
from dataclasses import dataclass, field
from typing import Callable, Iterable, Iterator

from . import dataflow

__all__ = [
    "Finding",
    "LintError",
    "RULES",
    "PROJECT_RULES",
    "rule",
    "project_rule",
    "expand_rule_ids",
    "lint_source",
    "lint_file",
    "lint_paths",
    "build_project_context",
    "ModuleCtx",
    "FnCtx",
]

#: methods of *Stage classes whose bodies run once per step (compiled or not)
STEP_METHODS = frozenset({"step", "train_step", "val_step"})
#: methods of *Stage classes that form the host-side epoch hot loop
EPOCH_METHODS = frozenset({"run_epoch", "train_epoch", "val_epoch"})

#: the compile entry point: ``torch.compile`` (or an imported ``compile`` of torch)
_COMPILE_NAMES = frozenset({"torch.compile"})
_PARTIAL_NAMES = frozenset({"functools.partial", "partial"})

#: id of the pseudo-rule emitted for files the linter cannot parse
PARSE_ERROR_RULE = "DML999"


class LintError(Exception):
    """Raised by ``TrainingPipeline(lint="error")`` when a registered stage
    has findings; carries them on ``.findings``."""

    def __init__(self, message: str, findings: list["Finding"] | None = None):
        super().__init__(message)
        self.findings = findings or []


@dataclass(frozen=True)
class Finding:
    """One lint hit. ``context`` is the dotted function/method the finding
    is inside ('' for module level)."""

    rule: str
    path: str
    line: int
    col: int
    message: str
    context: str = ""

    def format(self) -> str:
        where = f" [{self.context}]" if self.context else ""
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}{where}"

    def to_dict(self) -> dict:
        return {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "message": self.message,
            "context": self.context,
        }

    def sort_key(self):
        return (self.path, self.line, self.col, self.rule, self.message)


@dataclass
class RuleInfo:
    id: str
    title: str
    check: Callable[["ModuleCtx"], Iterator[Finding]]


#: rule id -> RuleInfo; populated by the ``@rule`` decorator (rules.py)
RULES: dict[str, RuleInfo] = {}


def rule(rule_id: str, title: str):
    """Register a rule function ``check(ctx) -> Iterator[Finding]``."""

    def deco(fn):
        RULES[rule_id] = RuleInfo(rule_id, title, fn)
        return fn

    return deco


#: project-pass rule id -> RuleInfo; populated by ``@project_rule``
#: (lifecycle.py). These run once per ``lint_paths`` call over the whole
#: :class:`~dmlcloud_tpu_torch.lint.callgraph.ProjectGraph`, never per file —
#: ``lint_source``/``lint_file`` cannot see them by construction.
PROJECT_RULES: dict[str, RuleInfo] = {}


def project_rule(rule_id: str, title: str):
    """Register a whole-program rule ``check(graph) -> Iterator[Finding]``
    taking a :class:`~dmlcloud_tpu_torch.lint.callgraph.ProjectGraph`."""

    def deco(fn):
        PROJECT_RULES[rule_id] = RuleInfo(rule_id, title, fn)
        return fn

    return deco


#: IR-pass rule id -> RuleInfo: rules over captured programs, never over
#: source. The IR tier (its tracer and its DML6xx rules) is ROADMAP Queue 1
#: item 13c, so the registry stays empty until then.
IR_RULES: dict[str, RuleInfo] = {}


def _id_matches(rule_id: str, spec: str) -> bool:
    """Whether ``spec`` selects ``rule_id``: exact id, ``all``, or a family
    wildcard like ``DML2xx`` (trailing ``xx`` matches any digits)."""
    if spec == "all" or spec == rule_id:
        return True
    if spec.endswith("xx") and len(spec) > 2:
        return rule_id.startswith(spec[:-2])
    return False


def expand_rule_ids(ids: Iterable[str]) -> tuple[list[str], list[str]]:
    """Expand exact ids and ``DML2xx`` family wildcards against the
    registry. Returns ``(expanded, unknown)`` — a wildcard matching nothing
    and an unregistered exact id both land in ``unknown``."""
    expanded: list[str] = []
    unknown: list[str] = []
    all_ids = sorted(set(RULES) | set(PROJECT_RULES) | set(IR_RULES))
    for spec in ids:
        matched = [rid for rid in all_ids if _id_matches(rid, spec)]
        if matched:
            expanded.extend(m for m in matched if m not in expanded)
        else:
            unknown.append(spec)
    return expanded, unknown


# --------------------------------------------------------------- suppressions

_DIRECTIVE = re.compile(
    r"#\s*dmllint:\s*(disable|disable-next-line|disable-file)\s*=\s*"
    r"([A-Za-z0-9_]+(?:\s*,\s*[A-Za-z0-9_]+)*)"
)


class Suppressions:
    """Per-line and file-wide suppression sets parsed from comments."""

    def __init__(self):
        self.by_line: dict[int, set[str]] = {}
        self.file_wide: set[str] = set()

    def is_suppressed(self, finding: Finding) -> bool:
        ids = self.by_line.get(finding.line, set()) | self.file_wide
        # family wildcards (``disable=DML2xx``) suppress the whole family
        return any(_id_matches(finding.rule, spec) for spec in ids)

    @classmethod
    def parse(cls, source: str) -> "Suppressions":
        sup = cls()
        try:
            tokens = tokenize.generate_tokens(io.StringIO(source).readline)
            for tok in tokens:
                if tok.type != tokenize.COMMENT:
                    continue
                m = _DIRECTIVE.search(tok.string)
                if not m:
                    continue
                kind = m.group(1)
                ids = {p.strip() for p in m.group(2).split(",") if p.strip()}
                line = tok.start[0]
                if kind == "disable":
                    sup.by_line.setdefault(line, set()).update(ids)
                elif kind == "disable-next-line":
                    sup.by_line.setdefault(line + 1, set()).update(ids)
                else:  # disable-file
                    sup.file_wide.update(ids)
        except tokenize.TokenError:
            pass  # the ast parse reports the real syntax problem
        return sup


# ------------------------------------------------------------------ contexts


@dataclass
class FnCtx:
    """One function in a hazard context."""

    node: ast.AST  # FunctionDef | AsyncFunctionDef
    kind: str  # "step" | "epoch"
    qualname: str
    #: names carrying tensors (step contexts only): the parameters but
    #: ``self``/``cls``, plus everything assigned from them
    tainted: set[str] = field(default_factory=set)


class ModuleCtx:
    """Everything the rules need about one parsed module. ``project`` is the
    optional cross-file :class:`dataflow.ProjectContext` a ``lint_paths``
    run shares between modules (mesh axes declared anywhere legitimise
    collectives everywhere)."""

    def __init__(
        self,
        path: str,
        source: str,
        tree: ast.Module,
        project: "dataflow.ProjectContext | None" = None,
        axes_only: bool = False,
    ):
        """``axes_only`` builds just what the project axis pass needs
        (aliases, bindings, parents) and skips hazard-context discovery —
        pass 1 of ``lint_paths`` runs over every file, so its cost is the
        serial fraction of a ``--jobs`` scan."""
        self.path = path
        self.source = source
        self.tree = tree
        self.project = project
        self.aliases = _collect_aliases(tree)
        self.step_fns: list[FnCtx] = []
        self.epoch_fns: list[FnCtx] = []
        #: names bound to compiled callables (``f = torch.compile(...)``,
        #: ``self._train_step = torch.compile(...)``, decorated defs) —
        #: DML106's notion of "this call dispatches device work"
        self.compiled_names: set[str] = set()
        #: child -> parent for every node (scope lookups for the dataflow
        #: rules; built once, O(module size))
        self.parents: dict[ast.AST, ast.AST] = {
            child: parent for parent in ast.walk(tree) for child in ast.iter_child_nodes(parent)
        }
        #: module-scope bindings (dataflow.Bindings); per-function bindings
        #: are computed lazily and cached in _fn_bindings
        self.bindings = dataflow.module_bindings(tree)
        self._fn_bindings: dict[ast.AST, dataflow.Bindings] = {}
        if not axes_only:
            self._collect()
        #: axis names this module provably declares (needs bindings+parents)
        self.declared_axes: set[str] = dataflow.collect_declared_axes(tree, self)

    # -- scopes (dataflow) --------------------------------------------------
    def enclosing_function(self, node: ast.AST) -> ast.AST | None:
        """The nearest enclosing FunctionDef/AsyncFunctionDef, or None."""
        cur = self.parents.get(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return cur
            cur = self.parents.get(cur)
        return None

    def enclosing_functions(self, node: ast.AST) -> list[ast.AST]:
        """All enclosing function defs, innermost first."""
        out = []
        fn = self.enclosing_function(node)
        while fn is not None:
            out.append(fn)
            fn = self.enclosing_function(fn)
        return out

    def fn_bindings(self, fn: ast.AST) -> "dataflow.Bindings":
        if fn not in self._fn_bindings:
            self._fn_bindings[fn] = dataflow.function_bindings(fn)
        return self._fn_bindings[fn]

    def scopes_at(self, node: ast.AST) -> list["dataflow.Bindings"]:
        """The binding-scope chain at ``node``: enclosing functions
        innermost-first, then the module scope."""
        return [self.fn_bindings(fn) for fn in self.enclosing_functions(node)] + [self.bindings]

    def known_axes(self) -> set[str]:
        """Every mesh axis name considered declared for this module: the
        framework vocabulary, this module's declarations, and (when linting
        a whole tree) every other scanned module's."""
        axes = set(dataflow.BUILTIN_AXES) | self.declared_axes
        if self.project is not None:
            axes |= self.project.declared_axes
        return axes

    # -- name resolution ----------------------------------------------------
    def resolve(self, node: ast.AST) -> str | None:
        """Dotted name of an expression with import aliases expanded
        (``np.random.rand`` -> ``numpy.random.rand``), or None."""
        parts: list[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if isinstance(node, ast.Name):
            parts.append(self.aliases.get(node.id, node.id))
            return ".".join(reversed(parts))
        return None

    # -- discovery ----------------------------------------------------------
    def _collect(self) -> None:
        compiled_defs: list[ast.AST] = []
        defs_by_name: dict[str, list[ast.AST]] = {}
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                defs_by_name.setdefault(node.name, []).append(node)

        # compile decorators and calls
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if any(self.is_compile(dec) for dec in node.decorator_list):
                    compiled_defs.append(node)
                    self.compiled_names.add(node.name)
            elif isinstance(node, ast.Call) and self.is_compile_call(node):
                if node.args and isinstance(node.args[0], ast.Name):
                    compiled_defs.extend(defs_by_name.get(node.args[0].id, []))

        # names bound to compile(...) results: f = torch.compile(...), self.f = torch.compile(...)
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
                if not self.is_compile_call(node.value):
                    continue
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        self.compiled_names.add(tgt.id)
                    elif isinstance(tgt, ast.Attribute):
                        self.compiled_names.add(tgt.attr)

        # Stage-class step/epoch methods
        for node in ast.walk(self.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            if not _is_stage_like(node, self):
                continue
            for item in node.body:
                if not isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue
                qual = f"{node.name}.{item.name}"
                if item.name in STEP_METHODS:
                    self.step_fns.append(self._make_step_ctx(item, qual))
                elif item.name in EPOCH_METHODS:
                    self.epoch_fns.append(FnCtx(item, "epoch", qual))

        # compiled functions (skip ones already collected as Stage methods);
        # torch.compile has no static arguments: every parameter carries tensors
        seen = {fc.node for fc in self.step_fns}
        for node in compiled_defs:
            if node in seen:
                continue
            seen.add(node)
            self.step_fns.append(self._make_step_ctx(node, getattr(node, "name", "<fn>")))

    def _make_step_ctx(self, node, qualname: str) -> FnCtx:
        seeds = set()
        for fn in _own_and_nested_defs(node):
            for p in _param_names(fn):
                if p not in ("self", "cls"):
                    seeds.add(p)
        return FnCtx(node, "step", qualname, tainted=_compute_taint(node, seeds))

    def is_compile(self, dec: ast.AST) -> bool:
        """Whether a decorator compiles (``@torch.compile``,
        ``@torch.compile(fullgraph=True)``, ``@partial(torch.compile, ...)``)."""
        if self.resolve(dec) in _COMPILE_NAMES:
            return True
        return isinstance(dec, ast.Call) and self.is_compile_call(dec)

    def is_compile_call(self, call: ast.Call) -> bool:
        """Whether a call node is ``torch.compile(...)`` or
        ``partial(torch.compile, ...)``."""
        fname = self.resolve(call.func)
        if fname in _COMPILE_NAMES:
            return True
        return fname in _PARTIAL_NAMES and bool(call.args) and self.resolve(call.args[0]) in _COMPILE_NAMES


def _collect_aliases(tree: ast.Module) -> dict[str, str]:
    aliases: dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                aliases[a.asname or a.name.split(".")[0]] = (
                    a.name if a.asname else a.name.split(".")[0]
                )
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            for a in node.names:
                aliases[a.asname or a.name] = f"{node.module}.{a.name}"
    return aliases


def _is_stage_like(cls: ast.ClassDef, ctx: ModuleCtx) -> bool:
    """A class is stage-like if its own name or any base's terminal segment
    ends with 'Stage' (``dml.TrainValStage``, ``Stage``, ``MyBaseStage``)."""
    if cls.name.endswith("Stage"):
        return True
    for base in cls.bases:
        name = ctx.resolve(base)
        if name and name.split(".")[-1].endswith("Stage"):
            return True
    return False


def _param_names(fn) -> list[str]:
    args = fn.args
    names = [a.arg for a in args.posonlyargs + args.args + args.kwonlyargs]
    if args.vararg:
        names.append(args.vararg.arg)
    if args.kwarg:
        names.append(args.kwarg.arg)
    return names


def _own_and_nested_defs(node) -> Iterator[ast.AST]:
    yield node
    for sub in ast.walk(node):
        if sub is not node and isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield sub


def _compute_taint(fn, seeds: set[str]) -> set[str]:
    """Forward taint: ``seeds`` plus every name assigned from an expression
    referencing a tainted name, to a fixpoint. Coarse by design — the rules
    that consume it (DML104) additionally prune statically-safe accesses
    (``.shape``, ``isinstance``, ``is None``...)."""
    tainted = set(seeds)
    for _ in range(10):  # fixpoint cap; real functions converge in 1-2 passes
        changed = False
        for node in ast.walk(fn):
            value = None
            targets: list[ast.AST] = []
            if isinstance(node, ast.Assign):
                value, targets = node.value, node.targets
            elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
                value, targets = node.value, [node.target]
            elif isinstance(node, (ast.For, ast.AsyncFor)):
                value, targets = node.iter, [node.target]
            elif isinstance(node, ast.withitem) and node.optional_vars is not None:
                value, targets = node.context_expr, [node.optional_vars]
            if value is None or not expr_tainted(value, tainted):
                continue
            for tgt in targets:
                for n in ast.walk(tgt):
                    if isinstance(n, ast.Name) and n.id not in tainted:
                        tainted.add(n.id)
                        changed = True
        if not changed:
            break
    return tainted


def expr_tainted(expr: ast.AST, tainted: set[str]) -> bool:
    """Whether any Name in the expression subtree is tainted."""
    return any(
        isinstance(n, ast.Name) and n.id in tainted for n in ast.walk(expr)
    )


# ------------------------------------------------- sanctioned-sync detection


def _is_measure_call(expr: ast.AST) -> bool:
    """``<anything>.measure(...)`` — a StallTimer-accounted block."""
    return (
        isinstance(expr, ast.Call)
        and isinstance(expr.func, ast.Attribute)
        and expr.func.attr == "measure"
    )


def attr_chain(node: ast.AST) -> list[str]:
    """['self', '_stall', 'fetch'] for ``self._stall.fetch``."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return list(reversed(parts))


def is_stall_accounted(call: ast.Call) -> bool:
    """``fetch``/``block`` on a stall-timer receiver: the framework's
    sanctioned, *accounted* host block (utils.profiling.StallTimer)."""
    if not isinstance(call.func, ast.Attribute):
        return False
    if call.func.attr not in ("fetch", "block", "measure"):
        return False
    return any("stall" in seg.lower() for seg in attr_chain(call.func)[:-1])


def walk_fn(fn_node) -> Iterator[tuple[ast.AST, bool]]:
    """Yield ``(descendant, in_measure)`` for every node under ``fn_node``,
    where ``in_measure`` is True inside a ``with <x>.measure():`` body."""

    def rec(node: ast.AST, in_measure: bool) -> Iterator[tuple[ast.AST, bool]]:
        for child in ast.iter_child_nodes(node):
            yield child, in_measure
            if isinstance(child, ast.With) and any(
                _is_measure_call(i.context_expr) for i in child.items
            ):
                for item in child.items:
                    yield from rec(item, in_measure)
                for stmt in child.body:
                    yield stmt, True
                    yield from rec(stmt, True)
            else:
                yield from rec(child, in_measure)

    yield from rec(fn_node, False)


# -------------------------------------------------------------- entry points


def lint_source(
    source: str,
    path: str = "<string>",
    select: Iterable[str] | None = None,
    ignore: Iterable[str] | None = None,
    project: "dataflow.ProjectContext | None" = None,
) -> list[Finding]:
    """Lint one module's source. Returns findings sorted by location, with
    suppression comments already applied. ``select``/``ignore`` accept exact
    rule ids and ``DML2xx`` family wildcards."""
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        return [
            Finding(
                PARSE_ERROR_RULE,
                path,
                int(e.lineno or 1),
                int(e.offset or 0),
                f"could not parse file: {e.msg}",
            )
        ]
    ctx = ModuleCtx(path, source, tree, project=project)
    sup = Suppressions.parse(source)
    return _run_module_rules(ctx, sup, select, ignore)


def _run_module_rules(
    ctx: ModuleCtx,
    sup: Suppressions,
    select: Iterable[str] | None,
    ignore: Iterable[str] | None,
) -> list[Finding]:
    """Run the per-module RULES over one context, suppressions applied."""
    selected = set(expand_rule_ids(select)[0]) if select else set(RULES)
    ignored = set(expand_rule_ids(ignore)[0]) if ignore else set()
    out: set[Finding] = set()
    for info in RULES.values():
        if info.id not in selected or info.id in ignored:
            continue
        for f in info.check(ctx):
            if not sup.is_suppressed(f):
                out.add(f)
    return sorted(out, key=Finding.sort_key)


def lint_file(
    path: str | os.PathLike,
    select: Iterable[str] | None = None,
    ignore: Iterable[str] | None = None,
    project: "dataflow.ProjectContext | None" = None,
) -> list[Finding]:
    path = os.fspath(path)
    try:
        with open(path, "r", encoding="utf-8", errors="replace") as f:
            source = f.read()
    except OSError as e:
        return [Finding(PARSE_ERROR_RULE, path, 1, 0, f"could not read file: {e}")]
    return lint_source(source, path=path, select=select, ignore=ignore, project=project)


_SKIP_DIRS = frozenset({"__pycache__", ".git", ".hg", ".venv", "venv", "node_modules", "build", "dist", ".eggs"})


def iter_python_files(paths: Iterable[str | os.PathLike]) -> Iterator[str]:
    """Expand files/directories into a sorted stream of ``*.py`` paths."""
    for p in paths:
        p = os.fspath(p)
        if os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(d for d in dirs if d not in _SKIP_DIRS and not d.startswith("."))
                for fname in sorted(files):
                    if fname.endswith(".py"):
                        yield os.path.join(root, fname)
        else:
            yield p


def build_project_context(files: Iterable[str | os.PathLike]) -> "dataflow.ProjectContext":
    """Pass 1 of a multi-file lint: parse every file and union its declared
    mesh axes into one :class:`dataflow.ProjectContext`. Unreadable or
    unparseable files contribute nothing here — pass 2 reports them."""
    project = dataflow.ProjectContext()
    for fpath in files:
        try:
            with open(os.fspath(fpath), "r", encoding="utf-8", errors="replace") as f:
                source = f.read()
            tree = ast.parse(source)
        except (OSError, SyntaxError):
            continue
        ctx = ModuleCtx(os.fspath(fpath), source, tree, axes_only=True)
        project.merge_module(ctx.declared_axes)
    return project


_EMPTY_SUP = {"by_line": {}, "file_wide": []}


def _sup_to_data(sup: Suppressions) -> dict:
    """JSON form of a Suppressions (the incremental cache persists it so
    the project pass can honor directives in files it never re-parses)."""
    return {
        "by_line": {str(k): sorted(v) for k, v in sup.by_line.items()},
        "file_wide": sorted(sup.file_wide),
    }


def _sup_from_data(data: dict | None) -> Suppressions:
    sup = Suppressions()
    if data:
        sup.by_line = {int(k): set(v) for k, v in data.get("by_line", {}).items()}
        sup.file_wide = set(data.get("file_wide", ()))
    return sup


def _error_result(path: str, finding: Finding) -> dict:
    return {"path": path, "findings": [finding], "summary": None, "axes": [], "sup": _EMPTY_SUP}


def _module_result(
    ctx: ModuleCtx,
    select: Iterable[str] | None,
    ignore: Iterable[str] | None,
    want_summary: bool,
) -> dict:
    """Per-file analysis product: module-rule findings, the (optional)
    call-graph summary, declared axes, and serialized suppressions — one
    parse feeds all four (pass 1 and pass 2 share the ModuleCtx)."""
    sup = Suppressions.parse(ctx.source)
    findings = _run_module_rules(ctx, sup, select, ignore)
    summary = None
    if want_summary:
        from .callgraph import summarize_module

        summary = summarize_module(ctx)
    return {
        "path": ctx.path,
        "findings": findings,
        "summary": summary,
        "axes": sorted(ctx.declared_axes),
        "sup": _sup_to_data(sup),
    }


def _analyze_file(
    path: str | os.PathLike,
    select: Iterable[str] | None,
    ignore: Iterable[str] | None,
    project: "dataflow.ProjectContext",
    want_summary: bool,
) -> dict:
    path = os.fspath(path)
    try:
        with open(path, "r", encoding="utf-8", errors="replace") as f:
            source = f.read()
    except OSError as e:
        return _error_result(path, Finding(PARSE_ERROR_RULE, path, 1, 0, f"could not read file: {e}"))
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        return _error_result(
            path,
            Finding(
                PARSE_ERROR_RULE,
                path,
                int(e.lineno or 1),
                int(e.offset or 0),
                f"could not parse file: {e.msg}",
            ),
        )
    ctx = ModuleCtx(path, source, tree, project=project)
    return _module_result(ctx, select, ignore, want_summary)


#: per-worker state installed once by the pool initializer — the pass-1
#: axis registry and the run config are shared via fork/initargs instead
#: of being rebuilt (or re-shipped) for every task
_WORKER_STATE: dict = {}


def _pool_init(select, ignore, axes, want_summary) -> None:
    from . import lifecycle, rules, rules_concurrency, rules_data  # noqa: F401 — register rules

    _WORKER_STATE["select"] = select
    _WORKER_STATE["ignore"] = ignore
    _WORKER_STATE["project"] = dataflow.ProjectContext(declared_axes=set(axes))
    _WORKER_STATE["want_summary"] = want_summary


def _analyze_task(path: str) -> dict:
    st = _WORKER_STATE
    return _analyze_file(path, st["select"], st["ignore"], st["project"], st["want_summary"])


def lint_paths(
    paths: Iterable[str | os.PathLike],
    select: Iterable[str] | None = None,
    ignore: Iterable[str] | None = None,
    jobs: int = 1,
    project: "dataflow.ProjectContext | None" = None,
    callgraph: bool = True,
    cache: str | os.PathLike | None = None,
    stats: dict | None = None,
    ir: bool = False,
    git_state: "tuple[str, frozenset[str]] | None" = None,
) -> list[Finding]:
    """Lint files and/or directories (recursive); returns sorted findings.

    Two passes share one parse per file: pass 1 runs the per-module RULES
    and extracts a call-graph summary; pass 2 folds every summary into a
    :class:`~dmlcloud_tpu_torch.lint.callgraph.ProjectGraph` and runs the
    interprocedural PROJECT_RULES (DML5xx) over it — disable with
    ``callgraph=False`` to fall back to the module-local rules only.

    ``cache`` names an incremental cache file (lint/cache.py): unchanged
    files reuse their cached findings/summaries; a changed file re-lints
    itself plus its transitive reverse importers. ``stats`` (a dict, filled
    in place) reports ``files``/``linted``/``reused`` for callers that need
    to see the plan.

    ``jobs > 1`` fans the per-file pass out over a ``ProcessPoolExecutor``
    whose initializer installs the shared pass-1 registries once per
    worker; on a single-core host the pool is a pure loss, so ``jobs``
    silently collapses to 1 there. Findings
    merge in path order either way, so output is deterministic.

    ``ir=True`` asks for the DML6xx IR pass, which is ROADMAP Queue 1
    item 13c (after item 14) and raises ``NotImplementedError`` until then.
    ``git_state`` is ``(HEAD sha, dirty paths)`` for the cache's git-trust
    fast path (``--changed``)."""
    if ir:
        raise NotImplementedError(
            "the IR pass (lint --ir, DML6xx) is ROADMAP Queue 1 item 13c: the IR tier, after item 14"
        )
    files = list(iter_python_files(paths))
    if jobs > 1 and (os.cpu_count() or 1) == 1:
        jobs = 1

    want_summary = callgraph or cache is not None
    cache_obj = None
    reused: dict[str, dict] = {}
    to_lint: list[str] = list(files)
    if cache is not None:
        from .cache import LintCache

        cache_obj = LintCache(cache, select=select, ignore=ignore, git_state=git_state)
        to_lint, reused = cache_obj.plan(files)

    if project is None:
        project = dataflow.ProjectContext()
    for entry in reused.values():
        project.merge_module(set(entry.get("axes", ())))

    results: list[dict] = []
    if jobs > 1 and len(to_lint) > 1:
        from concurrent.futures import ProcessPoolExecutor

        # the axis registry must be complete before any worker lints, so
        # the (cheap, axes-only) discovery pass stays in the parent
        project.merge_module(build_project_context(to_lint).declared_axes)
        initargs = (
            tuple(select) if select else None,
            tuple(ignore) if ignore else None,
            frozenset(project.declared_axes),
            want_summary,
        )
        with ProcessPoolExecutor(max_workers=jobs, initializer=_pool_init, initargs=initargs) as pool:
            results.extend(pool.map(_analyze_task, to_lint))
    else:
        # serial path parses once: contexts are built (and their axes
        # merged) first, rules run after the registry is complete
        pending: list[ModuleCtx] = []
        for fpath in to_lint:
            fpath = os.fspath(fpath)
            try:
                with open(fpath, "r", encoding="utf-8", errors="replace") as f:
                    source = f.read()
            except OSError as e:
                results.append(
                    _error_result(fpath, Finding(PARSE_ERROR_RULE, fpath, 1, 0, f"could not read file: {e}"))
                )
                continue
            try:
                tree = ast.parse(source)
            except SyntaxError as e:
                results.append(
                    _error_result(
                        fpath,
                        Finding(
                            PARSE_ERROR_RULE,
                            fpath,
                            int(e.lineno or 1),
                            int(e.offset or 0),
                            f"could not parse file: {e.msg}",
                        ),
                    )
                )
                continue
            ctx = ModuleCtx(fpath, source, tree, project=project)
            project.merge_module(ctx.declared_axes)
            pending.append(ctx)
        for ctx in pending:
            results.append(_module_result(ctx, select, ignore, want_summary))

    findings: list[Finding] = []
    for entry in reused.values():
        findings.extend(Finding(**d) for d in entry.get("findings", ()))
    for r in results:
        findings.extend(r["findings"])

    if callgraph:
        from . import lifecycle  # noqa: F401 — register the DML5xx rules
        from .callgraph import ProjectGraph

        summaries = [r["summary"] for r in results if r.get("summary")]
        summaries += [e["summary"] for e in reused.values() if e.get("summary")]
        graph = ProjectGraph(summaries)
        sups = {r["path"]: _sup_from_data(r.get("sup")) for r in results}
        for p, e in reused.items():
            sups[p] = _sup_from_data(e.get("sup"))
        selected = set(expand_rule_ids(select)[0]) if select else set(RULES) | set(PROJECT_RULES)
        ignored = set(expand_rule_ids(ignore)[0]) if ignore else set()
        for info in PROJECT_RULES.values():
            if info.id not in selected or info.id in ignored:
                continue
            for f in info.check(graph):
                sup = sups.get(f.path)
                if sup is None or not sup.is_suppressed(f):
                    findings.append(f)

    if cache_obj is not None:
        cache_obj.store(results, reused)

    if stats is not None:
        stats["files"] = len(files)
        stats["linted"] = sorted(os.fspath(p) for p in to_lint)
        stats["reused"] = sorted(reused)

    return sorted(set(findings), key=Finding.sort_key)
