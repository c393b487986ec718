"""The dataflow core of ``dmlcloud_tpu_torch.lint``: scoped bindings,
expression resolution through assignments, and the mesh-axis registry.

Counterpart of ``dmlcloud_tpu/lint/dataflow.py``, which is stdlib only; this
is the port's own copy. The per-node rules need no more than one AST node at
a time; the mesh-axis rules need to know which axes some *other* expression
(often another file) declared, e.g. ``create_mesh({"rows": 2, ...})``. Three
pieces close that gap:

- :class:`Bindings` — a best-effort single-assignment symbol table for one
  scope (module body or function body). A name assigned exactly once maps to
  its value expression; reassigned names resolve to nothing (ambiguous — the
  rules then stay silent rather than guess).
- :func:`resolve_expr` / :func:`string_values` — follow ``Name`` references
  through bindings (function scope first, then module scope) a bounded
  number of steps, and extract literal string sets from the result. This is
  what lets ``axes = {"rows": -1}; mesh = create_mesh(axes)`` declare the
  ``rows`` axis even though no string literal appears at the call site.
- the mesh-axis registry — :func:`collect_declared_axes` scans one module
  for axis declarations (``create_mesh``/``auto_mesh``/``set_mesh`` axes
  dicts, ``parse_mesh_axes`` spec strings, ``Mesh(grid, names)`` tuples) and
  :class:`ProjectContext` unions them across every file of a ``lint_paths``
  run, so a mesh built in ``main.py`` declares the axes a collective in
  ``model.py`` names (the axis rules come with item 13b).

The framework's own axis vocabulary (``parallel/mesh.py``'s ``DATA``/
``FSDP``/``MODEL``/``SEQ``/``EXPERT``/``PIPE`` constants) is always part of
the registry: library code is *written against* those names before any
concrete mesh exists, and an axis-name typo is exactly a name outside this
vocabulary that no mesh declares either.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Iterable

__all__ = [
    "BUILTIN_AXES",
    "MESH_CONSTANTS",
    "Bindings",
    "ProjectContext",
    "collect_declared_axes",
    "function_bindings",
    "module_bindings",
    "resolve_expr",
    "string_values",
]

#: the axis vocabulary parallel/mesh.py exports as DATA/FSDP/MODEL/SEQ/
#: EXPERT/PIPE — always considered declared (see module docstring)
BUILTIN_AXES = frozenset({"data", "fsdp", "model", "seq", "expert", "pipe"})

#: uppercase constant name -> axis string (``from dmlcloud_tpu_torch.parallel.mesh
#: import DATA`` and friends resolve through this without reading mesh.py)
MESH_CONSTANTS = {
    "DATA": "data",
    "FSDP": "fsdp",
    "MODEL": "model",
    "SEQ": "seq",
    "EXPERT": "expert",
    "PIPE": "pipe",
}

#: call names (terminal segment) that declare mesh axes, and how
_MESH_BUILDERS = frozenset({"create_mesh", "auto_mesh", "set_mesh", "Mesh", "parse_mesh_axes"})

_RESOLVE_DEPTH = 5  # bounded Name-chasing: a = b; b = c; c = {"data": -1}


class Bindings:
    """Best-effort single-assignment map: name -> value expression.

    A name assigned more than once (or through tuple unpacking, augmented
    assignment, ...) is recorded as ambiguous and resolves to None — the
    consumers of this table must *prove* a value to act, so ambiguity means
    silence, never a guess."""

    def __init__(self):
        self._map: dict[str, ast.expr | None] = {}

    def record(self, name: str, value: ast.expr | None) -> None:
        if name in self._map:
            self._map[name] = None  # reassigned: ambiguous
        else:
            self._map[name] = value

    def get(self, name: str) -> ast.expr | None:
        return self._map.get(name)

    def __contains__(self, name: str) -> bool:
        return name in self._map


def _record_assignments(body_walker: Iterable[ast.AST], bindings: Bindings) -> None:
    for node in body_walker:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and isinstance(node.targets[0], ast.Name):
            bindings.record(node.targets[0].id, node.value)
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            bindings.record(node.target.id, node.value)
        elif isinstance(node, ast.AugAssign) and isinstance(node.target, ast.Name):
            bindings.record(node.target.id, None)  # x += ...: not a literal value
        elif isinstance(node, (ast.For, ast.AsyncFor)):
            for n in ast.walk(node.target):
                if isinstance(n, ast.Name):
                    bindings.record(n.id, None)  # loop variable: varies


def module_bindings(tree: ast.Module) -> Bindings:
    """Bindings of the module scope (top-level statements only — a name
    assigned inside a function must not leak into module resolution)."""
    b = Bindings()
    _record_assignments(_shallow_walk(tree), b)
    return b


def function_bindings(fn: ast.AST) -> Bindings:
    """Bindings of one function scope: parameters (no value) plus every
    assignment anywhere in the body, nested defs excluded."""
    b = Bindings()
    args = fn.args
    for a in args.posonlyargs + args.args + args.kwonlyargs:
        b.record(a.arg, None)
    defaults = list(args.defaults)
    # positional defaults align with the TAIL of posonly+args: a parameter
    # with a literal default (axis_name="seq") resolves to it — sound for
    # the default call path, and the only call path a module-local view has
    pos = args.posonlyargs + args.args
    for param, default in zip(pos[len(pos) - len(defaults):], defaults):
        b._map[param.arg] = default
    for param, default in zip(args.kwonlyargs, args.kw_defaults):
        if default is not None:
            b._map[param.arg] = default
    if args.vararg:
        b.record(args.vararg.arg, None)
    if args.kwarg:
        b.record(args.kwarg.arg, None)
    _record_assignments(_body_walk(fn), b)
    return b


def _shallow_walk(tree: ast.Module):
    """Top-level statements plus the bodies of top-level if/try blocks —
    NOT class or function bodies."""
    stack = list(tree.body)
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.If, ast.Try, ast.With)):
            for child in ast.iter_child_nodes(node):
                stack.append(child)


def _body_walk(fn: ast.AST):
    """Every node under ``fn`` excluding nested function/class scopes."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        yield node
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef, ast.Lambda)):
            stack.extend(ast.iter_child_nodes(node))


def resolve_expr(node: ast.AST, scopes: list[Bindings], depth: int = _RESOLVE_DEPTH) -> ast.AST:
    """Chase ``Name`` references through ``scopes`` (innermost first) up to
    ``depth`` hops; returns the most-resolved expression (possibly the
    input). Attribute references to the mesh axis constants resolve to a
    synthetic string Constant."""
    for _ in range(depth):
        if isinstance(node, ast.Name):
            if node.id in MESH_CONSTANTS and not any(node.id in s for s in scopes):
                return ast.Constant(MESH_CONSTANTS[node.id])
            for scope in scopes:
                if node.id in scope:
                    value = scope.get(node.id)
                    if value is None or value is node:
                        return node  # ambiguous or self-referential
                    node = value
                    break
            else:
                return node
        elif isinstance(node, ast.Attribute) and node.attr in MESH_CONSTANTS:
            # mesh.DATA / mesh_lib.FSDP ... — the well-known constants
            return ast.Constant(MESH_CONSTANTS[node.attr])
        else:
            return node
    return node


def string_values(node: ast.AST, scopes: list[Bindings], depth: int = _RESOLVE_DEPTH) -> set[str] | None:
    """The set of literal strings an expression can denote, or None when it
    cannot be proven (function parameters, call results, f-strings...).
    Handles string constants, tuples/lists of resolvables, names bound to
    them, and the mesh axis constants."""
    node = resolve_expr(node, scopes, depth)
    if isinstance(node, ast.Constant):
        if isinstance(node.value, str):
            return {node.value}
        if node.value is None:
            return set()  # PartitionSpec(None, 'data'): None names no axis
        return None
    if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        out: set[str] = set()
        for elt in node.elts:
            sub = string_values(elt, scopes, depth)
            if sub is None:
                return None
            out |= sub
        return out
    return None


# ----------------------------------------------------------- axis collection


def _axes_from_dict(node: ast.AST, scopes: list[Bindings]) -> set[str] | None:
    node = resolve_expr(node, scopes)
    if not isinstance(node, ast.Dict):
        return None
    axes: set[str] = set()
    for key in node.keys:
        if key is None:
            continue  # {**base}: unknown keys, but the literal ones still count
        vals = string_values(key, scopes)
        if vals:
            axes |= vals
    return axes or None


def _axes_from_spec_string(node: ast.AST, scopes: list[Bindings]) -> set[str] | None:
    """Axis names out of a ``parse_mesh_axes``-style spec: 'data=2,fsdp=-1'."""
    vals = string_values(node, scopes)
    if not vals:
        return None
    axes: set[str] = set()
    for spec in vals:
        for part in spec.split(","):
            name = part.partition("=")[0].strip()
            if name:
                axes.add(name)
    return axes or None


def axes_from_call(call: ast.Call, ctx, scopes: list[Bindings]) -> set[str] | None:
    """Axis names a mesh-declaring call introduces, or None if this call
    does not (provably) declare axes. ``ctx`` is the ModuleCtx (for import
    alias resolution)."""
    resolved = ctx.resolve(call.func) or ""
    last = resolved.split(".")[-1] if resolved else ""
    if not last and isinstance(call.func, ast.Attribute):
        last = call.func.attr
    if last not in _MESH_BUILDERS:
        return None
    if last == "parse_mesh_axes":
        return _axes_from_spec_string(call.args[0], scopes) if call.args else None
    if last == "Mesh":
        # Mesh(grid, ("data", "model")) / Mesh(grid, axis_names=...)
        name_arg = None
        if len(call.args) >= 2:
            name_arg = call.args[1]
        for kw in call.keywords:
            if kw.arg == "axis_names":
                name_arg = kw.value
        return string_values(name_arg, scopes) if name_arg is not None else None
    # create_mesh/auto_mesh/set_mesh: axes dict (positional or kw), or
    # auto_mesh's axis_names tuple
    cand = call.args[0] if call.args else None
    for kw in call.keywords:
        if kw.arg in ("axes", "mesh_or_axes"):
            cand = kw.value
        elif kw.arg == "axis_names":
            return string_values(kw.value, scopes)
    if cand is None:
        return None
    return _axes_from_dict(cand, scopes)


def collect_declared_axes(tree: ast.Module, ctx) -> set[str]:
    """Every axis name this module provably declares (see module docstring).
    Resolution runs with the scope chain of each call site: enclosing
    function bindings first, then module bindings."""
    axes: set[str] = set()
    mod_scope = [ctx.bindings]
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        scopes = mod_scope
        fn = ctx.enclosing_function(node)
        if fn is not None:
            scopes = [ctx.fn_bindings(fn), ctx.bindings]
        found = axes_from_call(node, ctx, scopes)
        if found:
            axes |= found
    return axes


@dataclass
class ProjectContext:
    """Cross-file state shared by one ``lint_paths`` run: the union of every
    scanned module's declared axes. Picklable (plain strings) so the
    parallel path can ship it to worker processes."""

    declared_axes: set[str] = field(default_factory=set)

    def merge_module(self, axes: set[str]) -> None:
        self.declared_axes |= axes
