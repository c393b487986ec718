"""Project-wide call-graph summaries for the interprocedural DML5xx pass.

Counterpart of ``dmlcloud_tpu/lint/callgraph.py``. ``lint_paths`` builds one
:func:`summarize_module` dict per scanned file (pass 1, from the very same
parse the module rules use) and folds them into a :class:`ProjectGraph`
(pass 2). The graph resolves method calls through ``self``-attribute types,
import aliases (absolute AND relative — ``from .kv_pool import KVBlockPool``
— the blind spot that lets renamed serve machinery escape an identifier
vocabulary), re-exports, and parameter annotations, all bounded-depth, so
``lint/lifecycle.py`` can check the serving contracts *across* module
boundaries:

- who owns a ``KVBlockPool.alloc`` / ``PrefixCache.lock`` result on each
  path out of the acquiring scope (DML501),
- which functions expose an unguarded paged scatter to their callers
  (DML502),
- which paths through a terminal-stamping function miss (or double-stamp)
  the ``TERMINAL_STATUSES`` exit (DML503),
- which threads reach which attribute mutations, including through
  helper functions in other modules (DML504).

Everything in a summary is a plain JSON value (strings, ints, lists,
dicts) on purpose: the incremental cache (lint/cache.py) persists
summaries verbatim and rebuilds the graph for unchanged files without
re-parsing them. The path facts are computed here, at extraction time,
by a small statement-level interpreter (`_acquire_paths` /
`_terminal_exits`) — branch-sensitive, loop-approximate, raise-exempt —
so the project pass itself never needs an AST.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Iterable

from .engine import ModuleCtx, attr_chain

__all__ = [
    "ProjectGraph",
    "module_name",
    "summarize_module",
]

#: resource classes whose factory methods hand the CALLER a reference it
#: must drop (serve/kv_pool.py, serve/prefix_cache.py contracts)
RESOURCE_ACQUIRES = {
    "KVBlockPool": frozenset({"alloc"}),
    "PrefixCache": frozenset({"lock"}),
}
#: terminal method names that drop a reference, on any receiver
RELEASE_METHODS = frozenset({"release", "free", "unlock"})

#: the request state machine's terminal statuses (serve/scheduler.py
#: TERMINAL_STATUSES — mirrored, not imported: the linter imports nothing it lints)
TERMINAL_STATUS_VALUES = frozenset({"ok", "cancelled", "deadline_exceeded", "shed", "error"})

#: snake-case name segments that put a function in DML503's single-exit
#: scope (it *claims* to be a terminal path)
TERMINAL_FN_SEGMENTS = frozenset({"terminate", "finalize", "finish", "complete", "abort"})

#: a call whose terminal name matches this counts as the COW fork /
#: refcount check sanctioning a paged write (the paged-write contract)
_GUARD = re.compile(r"(?i)(cow|refcount|is_shared|writable|fork|guard)")

_LOCKISH = ("lock", "mutex", "cond", "cv")
_LOCK_FACTORIES = frozenset({"threading.Lock", "threading.RLock", "threading.Condition"})

#: bounded-depth knobs: import/re-export chains, call-graph walks
MAX_RESOLVE_DEPTH = 5
#: branch fan-out cap for the path interpreters; past it the function is
#: treated as unanalyzable (silent) rather than slow or wrong
MAX_PATH_STATES = 32


# ----------------------------------------------------------- module naming


def module_name(path: str) -> str:
    """Dotted module name of ``path``, walking up while ``__init__.py``
    marks a package (``.../dmlcloud_tpu_torch/serve/kv_pool.py`` →
    ``dmlcloud_tpu_torch.serve.kv_pool``). Scripts and loose files get their
    stem (``bench.py`` → ``bench``)."""
    path = os.path.abspath(os.fspath(path))
    parts = [os.path.splitext(os.path.basename(path))[0]]
    d = os.path.dirname(path)
    while os.path.isfile(os.path.join(d, "__init__.py")):
        parts.append(os.path.basename(d))
        d = os.path.dirname(d)
    if parts[0] == "__init__":
        parts = parts[1:] or [os.path.basename(os.path.dirname(path))]
    return ".".join(reversed(parts))


def _collect_imports(tree: ast.Module, modname: str) -> dict[str, str]:
    """local name -> fully dotted target, including RELATIVE imports
    resolved against ``modname`` (the gap in engine._collect_aliases that
    made serve-internal imports invisible to the vocab rules)."""
    out: dict[str, str] = {}
    pkg = modname.split(".")
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                out[a.asname or a.name.split(".")[0]] = a.name if a.asname else a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0:
                base = node.module or ""
            else:
                # from .x import y in package a.b.c → base a.b[.x]
                anchor = pkg[: len(pkg) - node.level]
                base = ".".join(anchor + ([node.module] if node.module else []))
            for a in node.names:
                target = f"{base}.{a.name}" if base else a.name
                out[a.asname or a.name] = target
    return out


def _classname_of(dotted: str | None) -> str | None:
    """Terminal class-like segment of a dotted ref: the LAST segment that
    starts uppercase (``pkg.kv_pool.KVBlockPool.for_model`` →
    ``KVBlockPool``)."""
    if not dotted:
        return None
    for seg in reversed(dotted.split(".")):
        if seg[:1].isupper():
            return seg
    return None


def _annotation_classname(ann: ast.AST | None) -> str | None:
    """Class name of a parameter annotation: ``KVBlockPool``,
    ``m.KVBlockPool``, ``KVBlockPool | None``, ``Optional[KVBlockPool]``,
    and the string forms of each."""
    if ann is None:
        return None
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        try:
            ann = ast.parse(ann.value, mode="eval").body
        except SyntaxError:
            return None
    if isinstance(ann, ast.BinOp) and isinstance(ann.op, ast.BitOr):
        return _annotation_classname(ann.left) or _annotation_classname(ann.right)
    if isinstance(ann, ast.Subscript):  # Optional[X] / Union[X, None]
        return _annotation_classname(ann.slice)
    if isinstance(ann, ast.Tuple):
        for elt in ann.elts:
            name = _annotation_classname(elt)
            if name:
                return name
    chain = attr_chain(ann)
    if chain:
        return _classname_of(".".join(chain))
    return None


def _call_target(func: ast.AST) -> str | None:
    """Dotted source text of a callee (``self.pool.alloc``, ``helper``) —
    resolved against imports later, at project-pass time."""
    chain = attr_chain(func)
    return ".".join(chain) if chain else None


def _name_segments(name: str) -> set[str]:
    return {s for s in name.lower().strip("_").split("_") if s}


def _is_lockish_expr(expr: ast.AST) -> bool:
    node = expr.func if isinstance(expr, ast.Call) else expr
    return any(any(t in seg.lower() for t in _LOCKISH) for seg in attr_chain(node))


def _is_locked(parents: dict, node: ast.AST) -> bool:
    cur = parents.get(node)
    while cur is not None:
        if isinstance(cur, ast.With) and any(_is_lockish_expr(i.context_expr) for i in cur.items):
            return True
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return False
        cur = parents.get(cur)
    return False


# ------------------------------------------------------ acquire path facts

#: in the acquire interpreter a state is (released: bool, handoffs:
#: tuple[(target, argpos)]) — the fate of one tracked reference so far
_ESCAPED = "escaped"


class _AcquireWalk:
    """Statement-level interpreter for ONE acquired reference: activates
    at the acquire statement, follows branches, and records the state at
    every normal exit (returns + function fallthrough). Raise exits are
    exempt (exception cleanup is not a leak path), back-edges are cut
    (a leak via loop re-binding is out of scope), and ANY use of the
    variable outside a release/handoff position aborts tracking — an
    escaped reference has a new owner and is silent by design."""

    def __init__(self, fn: ast.AST, acquire_stmt: ast.stmt, var: str):
        self.fn = fn
        self.acquire_stmt = acquire_stmt
        self.var = var
        self.escaped = False
        self.exits: list[dict] = []

    def run(self) -> list[dict] | None:
        states, _breaks, _continues = self._walk(self.fn.body, {None})
        if self.escaped:
            return None
        for st in states:
            if st is not None:  # tracking active at fallthrough
                self._record_exit(self.fn.body[-1], st)
        return self.exits

    # states: set of (released, handoffs) tuples; a None entry means
    # "not yet acquired" — the single pre-acquire state
    def _walk(self, stmts, states):
        states = set(states)
        breaks: set = set()
        continues: set = set()
        for stmt in stmts:
            if self.escaped:
                return set(), set(), set()
            states, b, c = self._stmt(stmt, states)
            breaks |= b
            continues |= c
            if not states:
                break
            if len(states) > MAX_PATH_STATES:
                self.escaped = True
                return set(), set(), set()
        return states, breaks, continues

    def _stmt(self, stmt, states):
        if stmt is self.acquire_stmt:
            return {(False, ())}, set(), set()
        if isinstance(stmt, ast.If):
            return self._if(stmt, states)
        if isinstance(stmt, (ast.While, ast.For, ast.AsyncFor)):
            return self._loop(stmt, states)
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            states = self._events(stmt.items, states)
            s, b, c = self._walk(stmt.body, states)
            return s, b, c
        if isinstance(stmt, ast.Try):
            return self._try(stmt, states)
        if isinstance(stmt, ast.Return):
            if stmt.value is not None:
                states = self._events([stmt.value], states)
            for st in states:
                if st is not None:
                    self._record_exit(stmt, st)
            return set(), set(), set()
        if isinstance(stmt, ast.Raise):
            return set(), set(), set()  # exception exits are exempt
        if isinstance(stmt, ast.Break):
            return set(), set(states), set()
        if isinstance(stmt, ast.Continue):
            return set(), set(), set(states)
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            # a nested def capturing the var is an escape
            if any(isinstance(n, ast.Name) and n.id == self.var for n in ast.walk(stmt)):
                self.escaped = True
            return states, set(), set()
        return self._events([stmt], states), set(), set()

    def _if(self, stmt, states):
        states = self._events([stmt.test], states)
        body_in, else_in = states, states
        # truthiness guard on the resource itself: `if v: v.release()` —
        # the branch where v is empty/None has nothing to release
        test = stmt.test
        if isinstance(test, ast.Name) and test.id == self.var:
            else_in = {(True, st[1]) if st is not None else None for st in states}
            body_in = states
        elif (
            isinstance(test, ast.UnaryOp)
            and isinstance(test.op, ast.Not)
            and isinstance(test.operand, ast.Name)
            and test.operand.id == self.var
        ):
            body_in = {(True, st[1]) if st is not None else None for st in states}
            else_in = states
        s1, b1, c1 = self._walk(stmt.body, body_in)
        s2, b2, c2 = self._walk(stmt.orelse, else_in) if stmt.orelse else (else_in, set(), set())
        return s1 | s2, b1 | b2, c1 | c2

    def _loop(self, stmt, states):
        head = [stmt.test] if isinstance(stmt, ast.While) else [stmt.iter]
        states = self._events(head, states)
        body_out, breaks, _ = self._walk(stmt.body, states)
        after = set(states) | breaks
        # pragmatic: a release anywhere in the body counts for the loop —
        # `for b in blocks: pool.release([b])` is the repo's idiom
        if any(st is not None and st[0] for st in body_out):
            after = {(True, st[1]) if st is not None else None for st in after | body_out}
        if stmt.orelse:
            after, b2, c2 = self._walk(stmt.orelse, after)
            return after, b2, c2
        return after, set(), set()

    def _try(self, stmt, states):
        s, b, c = self._walk(stmt.body, states)
        mid = set(states) | s
        for handler in stmt.handlers:
            hs, hb, hc = self._walk(handler.body, mid)
            s |= hs
            b |= hb
            c |= hc
        if stmt.finalbody:
            s, fb, fc = self._walk(stmt.finalbody, s or mid)
            b |= fb
            c |= fc
        return s, b, c

    def _record_exit(self, node, st):
        released, handoffs = st
        self.exits.append(
            {
                "line": getattr(node, "lineno", self.fn.lineno),
                "released": bool(released),
                "handoffs": [list(h) for h in handoffs],
            }
        )

    # -- event extraction over one statement/expression group ---------------
    def _events(self, nodes, states):
        released = False
        handoffs: list[tuple[str, int]] = []
        sanctioned: set[int] = set()  # id() of var Names used as release/handoff args
        for root in nodes:
            if root is None:
                continue
            for node in ast.walk(root):
                if not isinstance(node, ast.Call):
                    continue
                term = node.func.attr if isinstance(node.func, ast.Attribute) else (
                    node.func.id if isinstance(node.func, ast.Name) else None
                )
                var_args = self._var_arg_positions(node)
                if not var_args:
                    continue
                if term in RELEASE_METHODS:
                    released = True
                    sanctioned.update(i for i, _ in var_args)
                else:
                    target = _call_target(node.func)
                    if target is None:
                        self.escaped = True
                        return states
                    for nid, pos in var_args:
                        if pos is None:  # only bare positional args hand off
                            self.escaped = True
                            return states
                        handoffs.append((target, pos))
                        sanctioned.add(nid)
        # any OTHER use of the var (assignment target, expression operand,
        # return value, subscript...) escapes the reference
        for root in nodes:
            if root is None:
                continue
            for node in ast.walk(root):
                if isinstance(node, ast.Name) and node.id == self.var and id(node) not in sanctioned:
                    self.escaped = True
                    return states
        if not released and not handoffs:
            return states
        out = set()
        for st in states:
            if st is None:
                out.add(None)
                continue
            r, h = st
            out.add((r or released, h + tuple(handoffs) if not released else h))
        return out

    def _var_arg_positions(self, call: ast.Call):
        """[(id(name_node), argpos|None)] for uses of the var in this
        call's arguments: bare positional Name (pos = index), or inside a
        one-element list/tuple literal (``release([v])``, pos=None for
        non-release targets → escape)."""
        out = []
        for i, arg in enumerate(call.args):
            if isinstance(arg, ast.Name) and arg.id == self.var:
                out.append((id(arg), i))
            elif isinstance(arg, (ast.List, ast.Tuple)):
                for elt in arg.elts:
                    if isinstance(elt, ast.Name) and elt.id == self.var:
                        term = call.func.attr if isinstance(call.func, ast.Attribute) else None
                        out.append((id(elt), i if term in RELEASE_METHODS else None))
        for kw in call.keywords:
            if isinstance(kw.value, ast.Name) and kw.value.id == self.var:
                out.append((id(kw.value), None))
        return out


# ------------------------------------------------------ terminal path facts


class _TerminalWalk:
    """Path interpreter for DML503: counts terminal-stamp events
    (``x.status = <terminal literal>`` assignments and candidate stamper
    CALLS, resolved later) along every normal exit of a function. Exits
    lexically inside an ``if`` that tests ``.status`` /
    ``TERMINAL_STATUSES`` are flagged ``guarded`` — the idempotence
    early-return of the single-exit contract, exempt by design."""

    def __init__(self, fn: ast.AST):
        self.fn = fn
        self.exits: list[dict] = []
        self.stamp_in_loop = False
        self.has_stamps = False
        self.aborted = False

    def run(self):
        states = self._walk(self.fn.body, {(0, ())}, guarded=False, in_loop=False)
        for st in states:
            self._record_exit(self.fn.body[-1], st, guarded=False)
        return None if self.aborted else self.exits

    def _walk(self, stmts, states, guarded, in_loop):
        states = set(states)
        for stmt in stmts:
            if self.aborted:
                return set()
            states = self._stmt(stmt, states, guarded, in_loop)
            if not states:
                break
            if len(states) > MAX_PATH_STATES:
                self.aborted = True
                return set()
        return states

    def _stmt(self, stmt, states, guarded, in_loop):
        if isinstance(stmt, ast.If):
            states = self._events([stmt.test], states, in_loop)
            g = guarded or _mentions_status(stmt.test)
            s1 = self._walk(stmt.body, states, g, in_loop)
            s2 = self._walk(stmt.orelse, states, g, in_loop) if stmt.orelse else states
            return s1 | s2
        if isinstance(stmt, (ast.While, ast.For, ast.AsyncFor)):
            head = [stmt.test] if isinstance(stmt, ast.While) else [stmt.iter]
            states = self._events(head, states, in_loop)
            body_out = self._walk(stmt.body, states, guarded, in_loop=True)
            after = states | body_out
            if stmt.orelse:
                after = self._walk(stmt.orelse, after, guarded, in_loop)
            return after
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            states = self._events(stmt.items, states, in_loop)
            return self._walk(stmt.body, states, guarded, in_loop)
        if isinstance(stmt, ast.Try):
            s = self._walk(stmt.body, states, guarded, in_loop)
            mid = states | s
            for handler in stmt.handlers:
                s |= self._walk(handler.body, mid, guarded, in_loop)
            if stmt.finalbody:
                s = self._walk(stmt.finalbody, s or mid, guarded, in_loop)
            return s
        if isinstance(stmt, ast.Return):
            if stmt.value is not None:
                states = self._events([stmt.value], states, in_loop)
            for st in states:
                self._record_exit(stmt, st, guarded)
            return set()
        if isinstance(stmt, (ast.Raise, ast.Break, ast.Continue)):
            return set()  # raise exempt; loop edges cut (loop stamps flagged)
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            return states
        return self._events([stmt], states, in_loop)

    def _events(self, nodes, states, in_loop):
        stamps = 0
        calls: list[str] = []
        for root in nodes:
            if root is None:
                continue
            for node in ast.walk(root):
                if _is_terminal_stamp(node):
                    stamps += 1
                elif isinstance(node, ast.Call):
                    target = _call_target(node.func)
                    if target and _name_segments(target.split(".")[-1]) & {"terminate"}:
                        calls.append(target)
        if not stamps and not calls:
            return states
        self.has_stamps = True
        if in_loop:
            self.stamp_in_loop = True
        return {(n + stamps, c + tuple(calls)) for n, c in states}

    def _record_exit(self, node, st, guarded):
        n, calls = st
        self.exits.append(
            {
                "line": getattr(node, "lineno", self.fn.lineno),
                "stamps": int(n),
                "calls": list(calls),
                "guarded": bool(guarded),
            }
        )


def _is_terminal_stamp(node: ast.AST) -> bool:
    return (
        isinstance(node, ast.Assign)
        and len(node.targets) == 1
        and isinstance(node.targets[0], ast.Attribute)
        and node.targets[0].attr == "status"
        and isinstance(node.value, ast.Constant)
        and node.value.value in TERMINAL_STATUS_VALUES
    )


def _mentions_status(test: ast.AST) -> bool:
    for node in ast.walk(test):
        if isinstance(node, ast.Attribute) and node.attr == "status":
            return True
        if isinstance(node, ast.Name) and node.id == "TERMINAL_STATUSES":
            return True
    return False


# ----------------------------------------------------------- summarization


def summarize_module(ctx: ModuleCtx, modname: str | None = None) -> dict:
    """The JSON-serializable project-pass summary of one parsed module."""
    modname = modname or module_name(ctx.path)
    imports = _collect_imports(ctx.tree, modname)
    classes: dict[str, dict] = {}
    functions: dict[str, dict] = {}
    step_nodes = {fc.node for fc in ctx.step_fns}

    class_defs = [n for n in ctx.tree.body if isinstance(n, ast.ClassDef)]
    for cls in class_defs:
        classes[cls.name] = _summarize_class(ctx, cls, imports)

    for owner, fn in _top_level_functions(ctx.tree):
        qual = f"{owner.name}.{fn.name}" if owner is not None else fn.name
        functions[qual] = _summarize_function(
            ctx, fn, owner, qual, imports,
            classes.get(owner.name) if owner is not None else None,
            is_step=fn in step_nodes,
        )

    serve_relevant = _serve_relevant(ctx, imports, classes)
    return {
        "path": ctx.path,
        "modname": modname,
        "imports": imports,
        "serve_relevant": serve_relevant,
        "functions": functions,
        "classes": classes,
    }


def _top_level_functions(tree: ast.Module):
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield None, node
        elif isinstance(node, ast.ClassDef):
            for item in node.body:
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    yield node, item


def _summarize_class(ctx: ModuleCtx, cls: ast.ClassDef, imports: dict) -> dict:
    methods = {
        item.name: item
        for item in cls.body
        if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef))
    }
    attr_types: dict[str, str] = {}
    lock_attrs: set[str] = set()
    event_attrs: set[str] = set()
    thread_targets: set[str] = set()
    for name, method in methods.items():
        param_types = _param_annotations(method)
        for node in ast.walk(method):
            if isinstance(node, ast.Assign):
                for tgt in node.targets:
                    chain = attr_chain(tgt)
                    if len(chain) == 2 and chain[0] == "self":
                        tname = _value_classname(ctx, node.value, param_types)
                        if tname:
                            attr_types.setdefault(chain[1], tname)
                        resolved = (
                            ctx.resolve(node.value.func)
                            if isinstance(node.value, ast.Call)
                            else None
                        )
                        if resolved in _LOCK_FACTORIES:
                            lock_attrs.add(chain[1])
                        if resolved in ("threading.Event", "threading.Condition"):
                            event_attrs.add(chain[1])
            if isinstance(node, ast.Call) and (ctx.resolve(node.func) or "") == "threading.Thread":
                for kw in node.keywords:
                    if kw.arg != "target":
                        continue
                    chain = attr_chain(kw.value)
                    if len(chain) == 2 and chain[0] == "self":
                        thread_targets.add(chain[1])
                    elif isinstance(kw.value, ast.Name):
                        thread_targets.add(kw.value.id)
    return {
        "name": cls.name,
        "line": cls.lineno,
        "bases": [b for b in (_call_target(base) for base in cls.bases) if b],
        "methods": sorted(methods),
        "attr_types": attr_types,
        "lock_attrs": sorted(lock_attrs),
        "event_attrs": sorted(event_attrs),
        "thread_targets": sorted(thread_targets),
    }


def _param_annotations(fn) -> dict[str, str]:
    out: dict[str, str] = {}
    args = fn.args
    for a in args.posonlyargs + args.args + args.kwonlyargs:
        name = _annotation_classname(a.annotation)
        if name:
            out[a.arg] = name
    return out


def _value_classname(ctx: ModuleCtx, value: ast.AST, param_types: dict[str, str]) -> str | None:
    """Class name a ``self.x = <value>`` assignment gives the attribute:
    a constructor/classmethod call, an annotated parameter, or either arm
    of a conditional expression."""
    if isinstance(value, ast.IfExp):
        return _value_classname(ctx, value.body, param_types) or _value_classname(
            ctx, value.orelse, param_types
        )
    if isinstance(value, ast.Call):
        return _classname_of(ctx.resolve(value.func) or _call_target(value.func))
    if isinstance(value, ast.Name):
        return param_types.get(value.id)
    return None


def _summarize_function(
    ctx: ModuleCtx,
    fn: ast.AST,
    owner: ast.ClassDef | None,
    qual: str,
    imports: dict,
    cls_summary: dict | None,
    is_step: bool,
) -> dict:
    param_types = _param_annotations(fn)
    params = [a.arg for a in fn.args.posonlyargs + fn.args.args]
    attr_types = (cls_summary or {}).get("attr_types", {})

    guard_lines: list[int] = []
    calls: list[dict] = []
    scatters: list[dict] = []
    self_calls: set[str] = set()
    releases_params: set[str] = set()
    escapes_params: set[str] = set()
    param_set = set(params)

    own_nodes = [n for n in ast.walk(fn) if ctx.enclosing_function(n) is fn]
    for node in own_nodes:
        if isinstance(node, ast.Call):
            target = _call_target(node.func)
            if target is None:
                continue
            term = target.split(".")[-1]
            resolved_first = imports.get(target.split(".")[0], target.split(".")[0])
            resolved = ".".join([resolved_first] + target.split(".")[1:])
            if _GUARD.search(term):
                guard_lines.append(node.lineno)
            if resolved.split(".")[-1] == "scatter_tokens":
                scatters.append({"line": node.lineno, "guarded": False})
                continue
            args = [a.id if isinstance(a, ast.Name) else None for a in node.args]
            calls.append(
                {
                    "t": target,
                    "line": node.lineno,
                    "guarded": False,
                    "args": args,
                    "locked": _is_locked(ctx.parents, node),
                }
            )
            chain = target.split(".")
            if len(chain) == 2 and chain[0] == "self":
                self_calls.add(chain[1])
            if term in RELEASE_METHODS:
                for a in node.args:
                    if isinstance(a, ast.Name) and a.id in param_set:
                        releases_params.add(a.id)
                    elif isinstance(a, (ast.List, ast.Tuple)):
                        for elt in a.elts:
                            if isinstance(elt, ast.Name) and elt.id in param_set:
                                releases_params.add(elt.id)
        elif isinstance(node, ast.If):
            for sub in ast.walk(node.test):
                chain = attr_chain(sub)
                if chain and _GUARD.search(chain[-1]):
                    guard_lines.append(node.lineno)
                    break
        elif isinstance(node, ast.Return) and node.value is not None:
            for sub in ast.walk(node.value):
                if isinstance(sub, ast.Name) and sub.id in param_set:
                    escapes_params.add(sub.id)
        elif isinstance(node, ast.Assign):
            for tgt in node.targets:
                if isinstance(tgt, (ast.Attribute, ast.Subscript)):
                    for sub in ast.walk(node.value):
                        if isinstance(sub, ast.Name) and sub.id in param_set:
                            escapes_params.add(sub.id)

    guard_lines.sort()

    def _guarded(line: int) -> bool:
        return any(gl < line for gl in guard_lines)

    for site in scatters:
        site["guarded"] = _guarded(site["line"])
    for site in calls:
        site["guarded"] = _guarded(site["line"])

    # mutations of self attributes / parameter attributes (DML504 facts)
    mutations: list[dict] = []
    param_muts: list[dict] = []
    param_pos = {p: i for i, p in enumerate(params)}
    for node in own_nodes:
        for root, line in _mutation_roots(node):
            chain = attr_chain(root)
            if len(chain) < 2:
                continue
            locked = _is_locked(ctx.parents, node)
            if chain[0] == "self":
                mutations.append({"attr": chain[1], "line": line, "locked": locked})
            elif chain[0] in param_pos and owner is None:
                param_muts.append(
                    {"arg": param_pos[chain[0]], "attr": chain[1], "line": line, "locked": locked}
                )

    # acquire ownership paths (DML501 facts)
    acquires = _collect_acquires(ctx, fn, param_types, attr_types, imports)

    # terminal exit paths (DML503 facts) — only for functions whose NAME
    # claims terminal duty; everyone else skips the interpreter
    exits: list[dict] | None = None
    stamp_in_loop = False
    if _name_segments(fn.name) & TERMINAL_FN_SEGMENTS:
        tw = _TerminalWalk(fn)
        exits = tw.run()
        stamp_in_loop = tw.stamp_in_loop
        if exits is not None and not tw.has_stamps:
            exits = None

    return {
        "name": fn.name,
        "qualname": qual,
        "cls": owner.name if owner is not None else None,
        "line": fn.lineno,
        "params": params,
        "param_types": param_types,
        "calls": calls,
        "scatters": scatters,
        "self_calls": sorted(self_calls),
        "releases_params": sorted(releases_params),
        "escapes_params": sorted(escapes_params),
        "acquires": acquires,
        "mutations": mutations,
        "param_muts": param_muts,
        "exits": exits,
        "stamp_in_loop": stamp_in_loop,
        "is_step": is_step,
    }


def _mutation_roots(node: ast.AST):
    """(receiver-expression, line) pairs for attribute mutations: plain
    attribute/subscript stores and in-place mutating method calls."""
    _MUTATING = {
        "append", "appendleft", "extend", "add", "insert", "remove",
        "discard", "pop", "popleft", "clear", "update", "setdefault",
    }
    if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
        targets = node.targets if isinstance(node, ast.Assign) else [node.target]
        for tgt in targets:
            root = tgt
            while isinstance(root, ast.Subscript):
                root = root.value
            if isinstance(root, ast.Attribute):
                yield root, node.lineno
    elif isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
        if node.func.attr in _MUTATING:
            yield node.func.value, node.lineno


def _collect_acquires(ctx, fn, param_types, attr_types, imports) -> list[dict]:
    out: list[dict] = []
    for stmt in ast.walk(fn):
        if not isinstance(stmt, ast.Assign) or not isinstance(stmt.value, ast.Call):
            continue
        if ctx.enclosing_function(stmt) is not fn:
            continue
        call = stmt.value
        if not isinstance(call.func, ast.Attribute):
            continue
        method = call.func.attr
        rtype = _receiver_type(ctx, fn, call.func.value, param_types, attr_types, imports)
        if rtype not in RESOURCE_ACQUIRES or method not in RESOURCE_ACQUIRES[rtype]:
            continue
        var = _acquire_var(stmt.targets)
        if var is None:
            continue  # bound to an attribute/expression — new owner, silent
        walk = _AcquireWalk(fn, stmt, var)
        paths = walk.run()
        if paths is None:
            continue  # escaped somewhere: ownership handed off
        out.append(
            {
                "var": var,
                "line": stmt.lineno,
                "col": stmt.col_offset,
                "rtype": rtype,
                "method": method,
                "paths": paths,
            }
        )
    return out


def _acquire_var(targets: list[ast.AST]) -> str | None:
    """The simple Name the acquired reference lands in: ``x = ...``,
    ``[x] = ...``, or the FIRST element of ``x, meta = ...`` (the
    ``PrefixCache.lock`` shape — blocks first, tokens second)."""
    if len(targets) != 1:
        return None
    tgt = targets[0]
    if isinstance(tgt, ast.Name):
        return tgt.id
    if isinstance(tgt, (ast.Tuple, ast.List)) and tgt.elts:
        first = tgt.elts[0]
        if isinstance(first, ast.Name):
            return first.id
    return None


def _receiver_type(ctx, fn, recv, param_types, attr_types, imports) -> str | None:
    chain = attr_chain(recv)
    if not chain:
        return None
    if chain[0] == "self" and len(chain) == 2:
        return attr_types.get(chain[1])
    if len(chain) == 1:
        name = chain[0]
        if name in param_types:
            return param_types[name]
        # local / module single-assignment binding: pool = KVBlockPool(...)
        for scope in ctx.scopes_at(recv):
            value = scope.get(name)
            if value is None:
                continue
            if isinstance(value, ast.Call):
                return _classname_of(ctx.resolve(value.func) or _call_target(value.func))
            break
        resolved = imports.get(name)
        if resolved:
            return _classname_of(resolved)
    return None


def _serve_relevant(ctx: ModuleCtx, imports: dict, classes: dict) -> bool:
    """Whether the module handles the serve block machinery: it imports or
    names a ``KVBlockPool``/``PrefixCache`` (under ANY alias — resolution
    is by class, not identifier vocabulary), or defines one."""
    targets = set(RESOURCE_ACQUIRES)
    if set(classes) & targets:
        return True
    for dotted in imports.values():
        if _classname_of(dotted) in targets:
            return True
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Name) and node.id in targets:
            return True
        if isinstance(node, ast.Attribute) and node.attr in targets:
            return True
    return False


# ------------------------------------------------------------ project graph


class ProjectGraph:
    """All module summaries of one ``lint_paths`` run, with bounded-depth
    reference resolution across them. Built fresh every run — from cached
    summaries for unchanged files, freshly extracted ones for the rest."""

    def __init__(self, summaries: Iterable[dict]):
        self.modules: dict[str, dict] = {}
        self.by_modname: dict[str, dict] = {}
        for s in summaries:
            self.modules[s["path"]] = s
            self.by_modname[s["modname"]] = s

    # -- reference resolution ----------------------------------------------
    def resolve_ref(self, mod: dict, dotted: str, depth: int = MAX_RESOLVE_DEPTH):
        """Resolve a dotted reference FROM ``mod`` to ``("function"|"class",
        module_summary, object_summary)`` or None. Follows this module's
        imports, then re-export chains in the target module."""
        if depth <= 0 or not dotted:
            return None
        parts = dotted.split(".")
        head = parts[0]
        target = mod["imports"].get(head)
        if target is not None:
            return self._resolve_abs(target + ("." + ".".join(parts[1:]) if parts[1:] else ""), depth)
        # same-module reference
        found = self._find_in_module(mod, parts)
        if found is not None:
            return found
        return self._resolve_abs(dotted, depth)

    def _resolve_abs(self, dotted: str, depth: int):
        parts = dotted.split(".")
        # longest module-name prefix wins
        for cut in range(len(parts), 0, -1):
            modname = ".".join(parts[:cut])
            target_mod = self.by_modname.get(modname)
            if target_mod is None:
                continue
            rest = parts[cut:]
            if not rest:
                return ("module", target_mod, None)
            found = self._find_in_module(target_mod, rest)
            if found is not None:
                return found
            # re-export: the target module imports the name itself
            reexport = target_mod["imports"].get(rest[0])
            if reexport is not None and depth > 1:
                return self._resolve_abs(
                    ".".join([reexport] + rest[1:]), depth - 1
                )
            return None
        return None

    def _find_in_module(self, mod: dict, parts: list[str]):
        name = parts[0]
        if name in mod["classes"]:
            if len(parts) >= 2 and f"{name}.{parts[1]}" in mod["functions"]:
                return ("function", mod, mod["functions"][f"{name}.{parts[1]}"])
            return ("class", mod, mod["classes"][name])
        if name in mod["functions"]:
            return ("function", mod, mod["functions"][name])
        return None

    def resolve_call(self, mod: dict, fn: dict, target: str, depth: int = MAX_RESOLVE_DEPTH):
        """Resolve a call-site target string recorded by
        :func:`summarize_module` to ``(module_summary, function_summary)``
        or None. Handles ``helper``, ``mod.helper``, ``self.m``,
        ``self.attr.m`` (via attribute types), and ``param.m`` (via
        parameter annotations)."""
        if depth <= 0:
            return None
        parts = target.split(".")
        if parts[0] == "self" and fn.get("cls"):
            cls = mod["classes"].get(fn["cls"])
            if cls is None:
                return None
            if len(parts) == 2:
                return self._resolve_method(mod, cls, parts[1], depth)
            if len(parts) == 3:
                tname = cls["attr_types"].get(parts[1])
                if tname is None:
                    return None
                hit = self._find_class(mod, tname, depth)
                if hit is None:
                    return None
                tmod, tcls = hit
                return self._resolve_method(tmod, tcls, parts[2], depth)
            return None
        if len(parts) == 2 and parts[0] in fn.get("param_types", {}):
            hit = self._find_class(mod, fn["param_types"][parts[0]], depth)
            if hit is None:
                return None
            tmod, tcls = hit
            return self._resolve_method(tmod, tcls, parts[1], depth)
        hit = self.resolve_ref(mod, target, depth)
        if hit is not None and hit[0] == "function":
            return hit[1], hit[2]
        return None

    def _resolve_method(self, mod: dict, cls: dict, method: str, depth: int):
        qual = f"{cls['name']}.{method}"
        if qual in mod["functions"]:
            return mod, mod["functions"][qual]
        for base in cls.get("bases", []):
            hit = self.resolve_ref(mod, base, depth - 1)
            if hit is not None and hit[0] == "class":
                found = self._resolve_method(hit[1], hit[2], method, depth - 1)
                if found is not None:
                    return found
        return None

    def _find_class(self, mod: dict, classname: str, depth: int):
        """A class by bare name: this module's own, then via its imports,
        then anywhere in the project (class names like ``KVBlockPool`` are
        project-unique by convention)."""
        if classname in mod["classes"]:
            return mod, mod["classes"][classname]
        for local, dotted in mod["imports"].items():
            if local == classname or dotted.split(".")[-1] == classname:
                hit = self._resolve_abs(dotted, depth - 1)
                if hit is not None and hit[0] == "class":
                    return hit[1], hit[2]
        for other in self.modules.values():
            if classname in other["classes"]:
                return other, other["classes"][classname]
        return None

    # -- dependency edges (incremental cache invalidation) ------------------
    def dependencies(self, mod: dict) -> set[str]:
        """Paths of scanned modules this module's imports reach."""
        out: set[str] = set()
        for dotted in mod["imports"].values():
            parts = dotted.split(".")
            for cut in range(len(parts), 0, -1):
                hit = self.by_modname.get(".".join(parts[:cut]))
                if hit is not None and hit["path"] != mod["path"]:
                    out.add(hit["path"])
                    break
        return out
