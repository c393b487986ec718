"""The interprocedural lifecycle & lockset family (DML501-DML504).

Counterpart of ``dmlcloud_tpu/lint/lifecycle.py``; the port's serving code
keeps the names the rules look for (``KVBlockPool.alloc``,
``PrefixCache.lock``, ``scatter_tokens``, ``TERMINAL_STATUSES``). These rules
run in the PROJECT pass of ``lint_paths`` — they see the whole
:class:`~dmlcloud_tpu_torch.lint.callgraph.ProjectGraph`, not one module, and
statically prove the serving contracts the runtime property tests check
dynamically:

- DML501  a ``KVBlockPool.alloc`` / ``PrefixCache.lock`` result that some
          path lets fall out of the owning scope without a matching
          ``release``/``free`` — including through helper calls (a helper
          whose summary provably releases the parameter discharges the
          obligation; an unresolvable or escaping helper gets the benefit
          of the doubt), with real path tracking.
- DML502  a paged ``scatter_tokens`` write reachable on a path with no
          preceding COW guard/fork — across function and module
          boundaries, scoped by RESOLVED references to the block
          machinery rather than identifier vocabulary, so ``from ...
          import KVBlockPool as BP`` renames cannot hide it.
- DML503  a function that claims terminal duty (terminate/finalize/
          finish/...) with a normal-exit path stamping zero or two+
          ``TERMINAL_STATUSES`` terminals — the serving engine's
          single-exit contract, checked on the extracted CFG paths. Idempotence
          early-returns behind a ``.status`` test are exempt; functions
          stamping inside loops (batch reapers) are skipped.
- DML504  DML301's lockset inconsistency extended across module
          boundaries: the thread-target closure follows inherited methods
          and module-level helpers called with ``self``, so a flusher
          thread mutating shared state through a helper in another file
          is held to the same lock protocol as in-class code. Only fires
          when a mutation OUTSIDE the class body is involved — in-class
          inconsistency stays DML301's.

The module-local fallback (DML301) stays registered and active: when the
call-graph pass is disabled (``callgraph=False`` / ``--no-callgraph``) it is
the only line of defense, and it still catches what a single file can show.
"""

from __future__ import annotations

from .callgraph import MAX_RESOLVE_DEPTH, RESOURCE_ACQUIRES, ProjectGraph
from .engine import Finding, project_rule

__all__: list[str] = []


# ------------------------------------------------------------------- DML501


def _callee_param(callee: dict, target: str, argpos: int) -> str | None:
    """Parameter name of ``callee`` receiving positional arg ``argpos`` of
    a call spelled ``target`` — bound-method calls shift by the implicit
    ``self``/``cls`` receiver."""
    params = callee.get("params", [])
    idx = argpos
    if callee.get("cls") and "." in target:
        idx += 1
    if 0 <= idx < len(params):
        return params[idx]
    return None


def _param_discharged(graph: ProjectGraph, mod: dict, fn: dict, param: str, depth: int) -> bool:
    """Whether ``fn`` provably releases ``param``, escapes it (stores or
    returns it — a new owner), or hands it to a helper that does. Bounded
    recursion; an unresolvable hop returns False (the CALLER treats an
    unresolvable direct handoff as an escape already)."""
    if param in fn.get("releases_params", ()) or param in fn.get("escapes_params", ()):
        return True
    if depth <= 0:
        return False
    for call in fn.get("calls", ()):
        for pos, arg in enumerate(call.get("args", ())):
            if arg != param:
                continue
            hit = graph.resolve_call(mod, fn, call["t"])
            if hit is None:
                continue
            cmod, callee = hit
            p = _callee_param(callee, call["t"], pos)
            if p is not None and _param_discharged(graph, cmod, callee, p, depth - 1):
                return True
    return False


def _path_leaks(graph: ProjectGraph, mod: dict, fn: dict, path: dict) -> bool:
    if path["released"]:
        return False
    handoffs = path.get("handoffs", ())
    if not handoffs:
        return True
    for target, argpos in handoffs:
        hit = graph.resolve_call(mod, fn, target)
        if hit is None:
            return False  # unknown custody: benefit of the doubt
        cmod, callee = hit
        param = _callee_param(callee, target, argpos)
        if param is None:
            return False
        if _param_discharged(graph, cmod, callee, param, MAX_RESOLVE_DEPTH - 2):
            return False
    return True


@project_rule("DML501", "alloc/retain without a matching release on every path out of the owning scope")
def check_block_leak(graph: ProjectGraph):
    """Every reference ``KVBlockPool.alloc`` / ``PrefixCache.lock`` hands
    out must be dropped (``release``/``free``) or handed to a new owner on
    EVERY normal path out of the acquiring scope — a serving engine that
    leaks one block per failed admission dies at capacity, slowly
    (serve/kv_pool.py's ``free + live == capacity`` invariant)."""
    for mod in sorted(graph.modules.values(), key=lambda m: m["path"]):
        for fn in mod["functions"].values():
            for acq in fn.get("acquires", ()):
                leaky = [p for p in acq["paths"] if _path_leaks(graph, mod, fn, p)]
                if not leaky:
                    continue
                lines = ", ".join(str(p["line"]) for p in leaky[:4])
                yield Finding(
                    "DML501",
                    mod["path"],
                    acq["line"],
                    acq["col"],
                    f"'{acq['var']}' holds blocks from {acq['rtype']}.{acq['method']}() "
                    f"but the path exiting at line {lines} neither releases them nor "
                    "hands them to an owner — a leaked reference never returns to the "
                    "free list (free + live == capacity breaks)",
                    fn["qualname"],
                )


# ------------------------------------------------------------------- DML502


def _module_relevant(graph: ProjectGraph, mod: dict, memo: dict) -> bool:
    """Whether a module handles the block machinery, by RESOLUTION: its
    own summary says so, or any of its imports resolves (through re-export
    chains) to ``KVBlockPool``/``PrefixCache`` — so ``from ._alias import
    BlockStore`` puts the module in scope even though its text never
    spells a pool name (a rename a vocabulary check would miss)."""
    key = mod["path"]
    if key in memo:
        return memo[key]
    rel = bool(mod.get("serve_relevant"))
    if not rel:
        for local in mod.get("imports", {}):
            hit = graph.resolve_ref(mod, local, MAX_RESOLVE_DEPTH - 1)
            if hit is not None and hit[0] == "class" and hit[2].get("name") in RESOURCE_ACQUIRES:
                rel = True
                break
    memo[key] = rel
    return rel


def _is_exposed(
    graph: ProjectGraph,
    mod: dict,
    fn: dict,
    memo: dict,
    depth: int = MAX_RESOLVE_DEPTH,
) -> bool:
    """Whether calling ``fn`` can reach an unguarded paged scatter — a
    direct unguarded ``scatter_tokens`` in a serve-relevant module, or
    transitively through an unguarded call site."""
    key = (mod["path"], fn["qualname"])
    if key in memo:
        return memo[key]
    memo[key] = False  # cycle guard
    exposed = False
    if mod.get("serve_relevant") and any(not s["guarded"] for s in fn.get("scatters", ())):
        exposed = True
    elif depth > 0:
        for call in fn.get("calls", ()):
            if call["guarded"]:
                continue
            hit = graph.resolve_call(mod, fn, call["t"])
            if hit is not None and _is_exposed(graph, hit[0], hit[1], memo, depth - 1):
                exposed = True
                break
    memo[key] = exposed
    return exposed


@project_rule("DML502", "paged scatter reachable without a preceding COW guard on the same path")
def check_unguarded_scatter_reach(graph: ProjectGraph):
    """A block with ``refcount > 1`` is read-only; the scatter that writes
    through a table must be dominated by the COW guard/fork. This rule
    checks it over RESOLVED references — through import renames and helper
    calls — in every module that provably touches the block machinery.
    Traced step functions are exempt (the guard is a host-side contract
    applied before dispatch)."""
    memo: dict = {}
    relevant: dict = {}
    for mod in sorted(graph.modules.values(), key=lambda m: m["path"]):
        if not _module_relevant(graph, mod, relevant):
            continue
        for fn in mod["functions"].values():
            if fn.get("is_step"):
                continue
            for site in fn.get("scatters", ()):
                if not site["guarded"]:
                    yield Finding(
                        "DML502",
                        mod["path"],
                        site["line"],
                        0,
                        "paged scatter_tokens(...) write with no copy-on-write "
                        "guard/fork on this path — a shared (refcount > 1) block "
                        "is read-only and must be forked before any write",
                        fn["qualname"],
                    )
            for call in fn.get("calls", ()):
                if call["guarded"]:
                    continue
                hit = graph.resolve_call(mod, fn, call["t"])
                if hit is None:
                    continue
                if hit[1].get("name") == "scatter_tokens":
                    # the call IS the scatter, reached through an import
                    # rename/re-export the module-local summary can't see
                    yield Finding(
                        "DML502",
                        mod["path"],
                        call["line"],
                        0,
                        "paged scatter_tokens(...) write (reached through an "
                        "import rename) with no copy-on-write guard/fork on "
                        "this path — a shared (refcount > 1) block is "
                        "read-only and must be forked before any write",
                        fn["qualname"],
                    )
                elif _is_exposed(graph, hit[0], hit[1], memo):
                    yield Finding(
                        "DML502",
                        mod["path"],
                        call["line"],
                        0,
                        f"this call reaches a paged scatter_tokens(...) write via "
                        f"{hit[1]['qualname']} with no copy-on-write guard/fork on "
                        "the path — fork shared blocks before entering the write "
                        "helper",
                        fn["qualname"],
                    )


# ------------------------------------------------------------------- DML503


@project_rule("DML503", "terminal path exits without exactly one TERMINAL_STATUSES stamp")
def check_single_terminal_exit(graph: ProjectGraph):
    """The single-exit contract: a request leaves the system
    through exactly one terminal transition. A terminate/finalize-family
    function with a normal-exit path that stamps NO terminal strands the
    request (pages allocated, ledger forever in-flight); a path stamping
    twice corrupts the idempotence accounting. Early returns behind a
    ``.status``/``TERMINAL_STATUSES`` test are the sanctioned idempotent
    re-entry and stay silent."""
    for mod in sorted(graph.modules.values(), key=lambda m: m["path"]):
        for fn in mod["functions"].values():
            exits = fn.get("exits")
            if exits is None or fn.get("stamp_in_loop"):
                continue
            totals = [(e, e["stamps"] + len(e.get("calls", ()))) for e in exits]
            if not any(n > 0 for _, n in totals):
                continue
            for e, n in totals:
                if n == 0 and not e["guarded"]:
                    yield Finding(
                        "DML503",
                        mod["path"],
                        e["line"],
                        0,
                        f"{fn['qualname']} is a terminal path but this exit stamps "
                        "no TERMINAL_STATUSES terminal — the request leaves the "
                        "system still in flight (single-exit contract)",
                        fn["qualname"],
                    )
                elif n >= 2:
                    yield Finding(
                        "DML503",
                        mod["path"],
                        e["line"],
                        0,
                        f"{fn['qualname']} stamps a terminal status {n} times on "
                        "one path — the second transition overwrites the first "
                        "and double-counts the exit (single-exit contract)",
                        fn["qualname"],
                    )


# ------------------------------------------------------------------- DML504


def _class_method_map(graph: ProjectGraph, mod: dict, cls: dict) -> dict[str, tuple]:
    """name -> (defining module, function summary, external) for a class,
    own methods shadowing inherited ones. ``external`` marks methods
    defined outside this class body (inherited)."""
    out: dict[str, tuple] = {}
    for base in cls.get("bases", ()):
        hit = graph.resolve_ref(mod, base, MAX_RESOLVE_DEPTH - 1)
        if hit is None or hit[0] != "class":
            continue
        bmod, bcls = hit[1], hit[2]
        for name, entry in _class_method_map(graph, bmod, bcls).items():
            out[name] = (entry[0], entry[1], True)
    for name in cls.get("methods", ()):
        fsum = mod["functions"].get(f"{cls['name']}.{name}")
        if fsum is not None:
            out[name] = (mod, fsum, False)
    return out


def _thread_closure(methods: dict[str, tuple], targets) -> set[str]:
    side = {t for t in targets if t in methods}
    for _ in range(len(methods) + 1):
        grew = False
        for name in list(side):
            for callee in methods[name][1].get("self_calls", ()):
                if callee in methods and callee not in side:
                    side.add(callee)
                    grew = True
        if not grew:
            break
    return side


def _method_sites(graph: ProjectGraph, dmod: dict, fsum: dict, external: bool):
    """(attr, path, line, locked, external, context) mutation sites a
    method contributes: its own ``self`` mutations plus, through the call
    graph, mutations a module-level helper performs on a ``self`` passed
    to it (one hop — the shape the repo's flusher/watchdog helpers use)."""
    for m in fsum.get("mutations", ()):
        yield (m["attr"], dmod["path"], m["line"], m["locked"], external, fsum["qualname"])
    for call in fsum.get("calls", ()):
        positions = [i for i, a in enumerate(call.get("args", ())) if a == "self"]
        if not positions:
            continue
        hit = graph.resolve_call(dmod, fsum, call["t"])
        if hit is None:
            continue
        hmod, helper = hit
        if helper.get("cls"):
            continue  # method targets are covered by the closure itself
        for pm in helper.get("param_muts", ()):
            if pm["arg"] in positions:
                locked = pm["locked"] or call.get("locked", False)
                yield (pm["attr"], hmod["path"], pm["line"], locked, True, helper["qualname"])


@project_rule("DML504", "shared attribute locked on one side of a thread boundary (cross-module)")
def check_cross_module_lockset(graph: ProjectGraph):
    """DML301's inconsistent-lockset rule, computed over the call-graph's
    thread-target closure instead of one class body: inherited methods and
    module-level helpers receiving ``self`` join the protocol. Fires only
    when a mutation OUTSIDE the class body is involved; purely in-class
    inconsistency remains DML301's finding."""
    for mod in sorted(graph.modules.values(), key=lambda m: m["path"]):
        for cls in mod["classes"].values():
            targets = cls.get("thread_targets")
            if not targets:
                continue
            methods = _class_method_map(graph, mod, cls)
            thread_side = _thread_closure(methods, targets)
            if not thread_side:
                continue
            thread_muts: dict[str, list] = {}
            fg_muts: dict[str, list] = {}
            for name, (dmod, fsum, external) in methods.items():
                if name == "__init__":
                    continue
                bucket = thread_muts if name in thread_side else fg_muts
                for site in _method_sites(graph, dmod, fsum, external):
                    bucket.setdefault(site[0], []).append(site)
            for attr in sorted(set(thread_muts) & set(fg_muts)):
                sites = thread_muts[attr] + fg_muts[attr]
                if not any(s[4] for s in sites):
                    continue  # wholly in-class: DML301's jurisdiction
                t_locked = {s[3] for s in thread_muts[attr]}
                f_locked = {s[3] for s in fg_muts[attr]}
                if not ((True in t_locked and False in f_locked)
                        or (True in f_locked and False in t_locked)):
                    continue
                for s in sites:
                    _attr, path, line, locked, _external, context = s
                    if locked:
                        continue
                    side = "background-thread" if s in [tuple(x) for x in thread_muts[attr]] else "foreground"
                    yield Finding(
                        "DML504",
                        path,
                        line,
                        0,
                        f"self.{attr} of {cls['name']} is mutated here ({side} "
                        "code, no lock) but accesses on the other side of the "
                        "thread boundary hold a Lock/Condition — the lock "
                        "excludes nobody unless every mutator (including "
                        "helpers and inherited methods) takes it",
                        context,
                    )
