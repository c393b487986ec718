"""The concurrency contract rules (DML301-DML302).

Counterpart of ``dmlcloud_tpu/lint/rules_concurrency.py``; it names no
framework API, so the rules are the reference's. The overlap engine runs on background threads — the journal flusher
(telemetry/journal.py), host prefetch (data/datasets.py), async checkpoint
commits (checkpoint.py), the hang watchdog (telemetry/watchdog.py). Every
one of them shares state with the foreground training loop, and Python's
GIL hides torn protocol (not torn bytes) races until a slow CI box or a
preemption widens the window. Two statically-checkable contracts:

- DML301  an attribute mutated both from a thread-target function and from
          foreground code where one side holds a ``Lock``/``Condition``
          and the other doesn't — the lock is then a fiction: it excludes
          nobody
- DML302  a ``time.sleep()`` polling loop testing state that an
          ``Event``/``Condition`` on the same object already models —
          busy-waiting burns a core and adds up to one full sleep interval
          of latency vs ``event.wait(timeout)``

Both rules are class-scoped (shared state == ``self`` attributes; that is
where every one of this codebase's thread protocols lives) and flag only
*inconsistency*, never lock-free designs: a monotonic heartbeat written
without a lock from both sides (watchdog ``notify``) is a deliberate
benign race and stays silent because neither side locks.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field

from .engine import Finding, ModuleCtx, attr_chain, rule

_LOCK_FACTORIES = frozenset({"threading.Lock", "threading.RLock", "threading.Condition"})
_EVENT_FACTORIES = frozenset({"threading.Event", "threading.Condition"})
_LOCKISH = ("lock", "mutex", "cond", "cv")

#: receiver-method calls that mutate the receiver in place
_MUTATING_METHODS = frozenset(
    {"append", "appendleft", "extend", "add", "insert", "remove", "discard",
     "pop", "popleft", "clear", "update", "setdefault", "__setitem__"}
)


def _f(ctx: ModuleCtx, rule_id: str, node: ast.AST, message: str, context: str) -> Finding:
    return Finding(rule_id, ctx.path, node.lineno, node.col_offset, message, context)


@dataclass
class _Mutation:
    attr: str
    node: ast.AST
    locked: bool
    method: str


@dataclass
class _ClassModel:
    node: ast.ClassDef
    methods: dict[str, ast.AST] = field(default_factory=dict)
    lock_attrs: set[str] = field(default_factory=set)
    event_attrs: set[str] = field(default_factory=set)
    thread_targets: set[str] = field(default_factory=set)


def _self_attr(node: ast.AST) -> str | None:
    """'x' for an expression rooted at ``self.x`` (any depth below)."""
    chain = attr_chain(node)
    if len(chain) >= 2 and chain[0] == "self":
        return chain[1]
    return None


def _build_class_model(ctx: ModuleCtx, cls: ast.ClassDef) -> _ClassModel:
    model = _ClassModel(cls)
    for item in cls.body:
        if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
            model.methods[item.name] = item
    for method in model.methods.values():
        for node in ast.walk(method):
            # self._lock = threading.Lock() / self._stop = threading.Event()
            if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
                resolved = ctx.resolve(node.value.func) or ""
                for tgt in node.targets:
                    attr = _self_attr(tgt) if isinstance(tgt, ast.Attribute) else None
                    if attr is None:
                        continue
                    if resolved in _LOCK_FACTORIES:
                        model.lock_attrs.add(attr)
                    if resolved in _EVENT_FACTORIES:
                        model.event_attrs.add(attr)
            # threading.Thread(target=self.m) — the thread entry point
            if isinstance(node, ast.Call):
                resolved = ctx.resolve(node.func) or ""
                if resolved == "threading.Thread":
                    for kw in node.keywords:
                        if kw.arg != "target":
                            continue
                        attr = _self_attr(kw.value)
                        if attr is not None:
                            model.thread_targets.add(attr)
                        elif isinstance(kw.value, ast.Name):
                            model.thread_targets.add(kw.value.id)
    return model


def _is_lockish(ctx: ModuleCtx, expr: ast.AST, lock_attrs: set[str]) -> bool:
    """Whether a ``with`` context expression is (or acquires) a lock: a
    known lock attribute, or any chain segment with a lock-ish name."""
    node = expr
    if isinstance(node, ast.Call):  # with self._lock.acquire_timeout(...) etc.
        node = node.func
    chain = attr_chain(node)
    for seg in chain:
        low = seg.lower()
        if seg in lock_attrs or any(t in low for t in _LOCKISH):
            return True
    return False


def _is_locked(ctx: ModuleCtx, node: ast.AST, lock_attrs: set[str]) -> bool:
    cur = ctx.parents.get(node)
    while cur is not None:
        if isinstance(cur, ast.With) and any(
            _is_lockish(ctx, item.context_expr, lock_attrs) for item in cur.items
        ):
            return True
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return False
        cur = ctx.parents.get(cur)
    return False


def _method_mutations(ctx: ModuleCtx, name: str, method: ast.AST, lock_attrs: set[str]):
    for node in ast.walk(method):
        attr = None
        where: ast.AST = node
        if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for tgt in targets:
                # covers plain attributes, tuple unpacking, and subscript
                # stores (`a, self.x = ...`, `self.x[k] = ...`)
                for sub in ast.walk(tgt):
                    if isinstance(sub, ast.Attribute):
                        attr = _self_attr(sub)
                        if attr is not None:
                            yield _Mutation(attr, node, _is_locked(ctx, node, lock_attrs), name)
                            break
            continue
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            if node.func.attr in _MUTATING_METHODS:
                attr = _self_attr(node.func.value)
                if attr is not None:
                    yield _Mutation(attr, where, _is_locked(ctx, node, lock_attrs), name)


def _thread_side_methods(model: _ClassModel) -> set[str]:
    """The thread-entry targets plus every ``self.m()`` they transitively
    call (bounded fixpoint inside the class)."""
    side = {t for t in model.thread_targets if t in model.methods}
    for _ in range(len(model.methods) + 1):
        grew = False
        for name in list(side):
            for node in ast.walk(model.methods[name]):
                if (
                    isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id == "self"
                    and node.func.attr in model.methods
                    and node.func.attr not in side
                ):
                    side.add(node.func.attr)
                    grew = True
        if not grew:
            break
    return side


# ------------------------------------------------------------------- DML301


@rule("DML301", "shared attribute locked on one side of a thread boundary only")
def check_inconsistent_locking(ctx: ModuleCtx):
    """A lock only excludes code that also takes it. When ``self.x`` is
    mutated under ``with self._lock:`` on one side of a thread boundary and
    bare on the other, every locked access is paying for protection the
    bare side silently bypasses. ``__init__`` mutations are exempt (they
    happen-before ``Thread.start``), and attributes mutated lock-free on
    BOTH sides are exempt too — that is a (possibly deliberate) lock-free
    design, not an inconsistent protocol."""
    for cls in ast.walk(ctx.tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        model = _build_class_model(ctx, cls)
        if not model.thread_targets:
            continue
        thread_side = _thread_side_methods(model)
        if not thread_side:
            continue
        thread_muts: dict[str, list[_Mutation]] = {}
        fg_muts: dict[str, list[_Mutation]] = {}
        for name, method in model.methods.items():
            if name == "__init__":
                continue  # happens-before thread start
            bucket = thread_muts if name in thread_side else fg_muts
            for m in _method_mutations(ctx, name, method, model.lock_attrs):
                bucket.setdefault(m.attr, []).append(m)
        for attr in sorted(set(thread_muts) & set(fg_muts)):
            t_locked = {m.locked for m in thread_muts[attr]}
            f_locked = {m.locked for m in fg_muts[attr]}
            # inconsistent: one side has a locked mutation, the other an
            # unlocked one — flag every unlocked site of the pair
            if (True in t_locked and False in f_locked) or (True in f_locked and False in t_locked):
                for m in thread_muts[attr] + fg_muts[attr]:
                    if m.locked:
                        continue
                    side = "background-thread" if m.method in thread_side else "foreground"
                    yield _f(
                        ctx, "DML301", m.node,
                        f"self.{attr} is mutated here ({side} code, no lock) but "
                        "other accesses across the thread boundary hold a "
                        "Lock/Condition — take the same lock here, or make the "
                        "whole protocol lock-free on purpose",
                        f"{cls.name}.{m.method}",
                    )


# ------------------------------------------------------------------- DML302


@rule("DML302", "time.sleep polling loop where an Event/Condition exists")
def check_sleep_polling(ctx: ModuleCtx):
    """``while not self._stop_flag: time.sleep(0.2)`` burns a core and
    reacts up to a full interval late; the same object already owns a
    ``threading.Event``/``Condition`` that models exactly this — use
    ``self._stop.wait(0.2)`` (wakes immediately on ``set()``) or
    ``Condition.wait_for``. Flagged only when BOTH halves are present: a
    sleep inside a while loop, on a class that owns an Event/Condition."""
    for cls in ast.walk(ctx.tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        model = _build_class_model(ctx, cls)
        if not model.event_attrs:
            continue
        for name, method in model.methods.items():
            for loop in ast.walk(method):
                if not isinstance(loop, ast.While):
                    continue
                for node in ast.walk(loop):
                    if (
                        isinstance(node, ast.Call)
                        and (ctx.resolve(node.func) or "") == "time.sleep"
                        and ctx.enclosing_function(node) is method
                    ):
                        evt = sorted(model.event_attrs)[0]
                        yield _f(
                            ctx, "DML302", node,
                            f"time.sleep polling inside a while loop, but "
                            f"{cls.name} owns threading Event/Condition "
                            f"'self.{evt}' — use self.{evt}.wait(timeout) so the "
                            "loop wakes immediately instead of busy-polling",
                            f"{cls.name}.{name}",
                        )
