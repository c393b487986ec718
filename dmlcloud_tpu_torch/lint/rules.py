"""The step-loop hazard rules (DML101, DML102, DML104-DML108).

Counterpart of ``dmlcloud_tpu/lint/rules.py``, each rule retargeted to the
torch hazard of the same name. Each enforces one clause of the training
loop's sync-point contract:

- DML101  host sync inside step/epoch code (defeats the deferred metrics)
- DML102  Python/NumPy RNG inside a step fn (a constant under torch.compile)
- DML104  data-dependent control flow on tensor values in a step fn
- DML105  blocking checkpoint/wandb calls inside the epoch loop
- DML106  wall-clock timing of CUDA launches without a device sync
- DML107  torch.compile call inside a loop body (defeats the compile cache)
- DML108  time.time() for step timing in step/epoch code (not monotonic)

DML103 (a jitted train step that does not donate its state) has no torch
counterpart and is not registered: ``torch.compile`` takes no buffer
donation, and the optimizer updates the parameters in place, so nothing is
held twice.

Rules yield raw findings; the engine applies suppressions and sorting.
"""

from __future__ import annotations

import ast

from .engine import (
    Finding,
    ModuleCtx,
    attr_chain,
    expr_tainted,
    is_stall_accounted,
    rule,
    walk_fn,
)

_NUMPY_SYNC_FNS = frozenset({"numpy.asarray", "numpy.array"})

#: zero-argument tensor methods that copy the value to the host and wait for
#: every kernel that produces it
_HOST_READ_METHODS = frozenset({"item", "tolist", "cpu", "numpy"})

#: the explicit device wait: every queued kernel of the device
_DEVICE_SYNC_FNS = frozenset({"torch.cuda.synchronize"})

#: calls whose result is static across steps — branching through them is safe
_TRACE_SAFE_CALLS = frozenset(
    {"isinstance", "issubclass", "len", "hasattr", "callable", "getattr", "type", "is_tensor"}
)
#: attributes (and zero-argument methods) that read tensor metadata, not values
_TRACE_SAFE_ATTRS = frozenset(
    {"shape", "ndim", "dtype", "size", "dim", "device", "is_cuda", "requires_grad", "is_floating_point"}
)

_WALL_CLOCK_FNS = frozenset(
    {
        "time.time",
        "time.time_ns",
        "time.perf_counter",
        "time.perf_counter_ns",
        "time.monotonic",
        "time.monotonic_ns",
    }
)
#: call attr names that prove the timed region was closed with a device
#: sync: ``torch.cuda.synchronize()``, ``Event.synchronize()``, a stall
#: timer's ``block``, or a value read
_SYNC_MARKERS = frozenset({"synchronize", "block", "item", "tolist", "cpu", "numpy"})

_SAVE_ATTRS = frozenset({"save", "save_state", "save_checkpoint", "save_pytree"})


def _f(ctx: ModuleCtx, rule_id: str, node: ast.AST, message: str, context: str) -> Finding:
    return Finding(rule_id, ctx.path, node.lineno, node.col_offset, message, context)


# ------------------------------------------------------------------- DML101


@rule("DML101", "host sync inside step/epoch code")
def check_host_sync(ctx: ModuleCtx):
    """``.item()``/``.tolist()``/``.cpu()``/``.numpy()``, an unaccounted
    ``torch.cuda.synchronize()``, ``float()``/``int()``/``bool()`` or
    ``np.asarray()`` of a tensor, and ``print`` inside step/epoch code. Each
    makes the host wait for every queued kernel. Exempt: anything under
    ``with <x>.measure():`` (a StallTimer-accounted block) and stall-timer
    ``fetch``/``block`` calls — accounted syncs are the framework's
    sanctioned pattern, unaccounted ones defeat the deferred metrics."""
    for fn in ctx.step_fns + ctx.epoch_fns:
        is_step = fn.kind == "step"
        for node, in_measure in walk_fn(fn.node):
            if in_measure or not isinstance(node, ast.Call):
                continue
            if is_stall_accounted(node):
                continue
            func = node.func
            arg = node.args[0] if node.args else None

            if isinstance(func, ast.Attribute) and func.attr in _HOST_READ_METHODS and not node.args:
                yield _f(
                    ctx, "DML101", node,
                    f".{func.attr}() copies a tensor to the host and waits for the "
                    "kernels that produce it; keep the value on the device and "
                    "track it (the tracker reduces once per epoch)",
                    fn.qualname,
                )
                continue

            resolved = ctx.resolve(func) or ""
            if resolved in _DEVICE_SYNC_FNS:
                yield _f(
                    ctx, "DML101", node,
                    "torch.cuda.synchronize() waits for every queued kernel; sync "
                    "once at the epoch boundary or time it under StallTimer.measure()",
                    fn.qualname,
                )
                continue
            if resolved in _NUMPY_SYNC_FNS and arg is not None:
                hazard = (
                    expr_tainted(arg, fn.tainted)
                    if is_step
                    else isinstance(arg, (ast.Name, ast.Attribute, ast.Subscript))
                )
                if hazard:
                    yield _f(
                        ctx, "DML101", node,
                        f"{resolved.split('.')[-1]}() on a tensor copies it to the "
                        "host synchronously; use StallTimer.fetch() or defer to "
                        "the epoch-end reduce",
                        fn.qualname,
                    )
                continue
            if isinstance(func, ast.Name) and func.id not in ctx.aliases:
                if is_step and func.id in ("float", "int", "bool") and arg is not None:
                    # metadata (``int(x.shape[0])``, ``x.size(1)``) is not a read
                    if _hazardous_test(arg, fn.tainted, ctx):
                        yield _f(
                            ctx, "DML101", node,
                            f"{func.id}() of a tensor reads its value on the host "
                            "(a sync, and a graph break under torch.compile); "
                            "return it and track it on the device",
                            fn.qualname,
                        )
                    continue
                if not is_step and func.id == "float" and isinstance(
                    arg, (ast.Name, ast.Subscript)
                ):
                    yield _f(
                        ctx, "DML101", node,
                        "float() on a per-step metric blocks the epoch loop; "
                        "fetch at a log_every() boundary via StallTimer.fetch() "
                        "or track the device value",
                        fn.qualname,
                    )
                    continue
                if is_step and func.id == "print":
                    yield _f(
                        ctx, "DML101", node,
                        "print inside a step reads tensors on the host (and "
                        "breaks the graph under torch.compile); log at a sync "
                        "point instead",
                        fn.qualname,
                    )


# ------------------------------------------------------------------- DML102


@rule("DML102", "Python/NumPy RNG inside a step fn")
def check_host_rng(ctx: ModuleCtx):
    """``random.*`` / ``np.random.*`` in step code draws on the host: under
    ``torch.compile`` the draw is a constant of the captured graph (every
    step reuses it), and eagerly it sits outside the seeded torch generators
    that checkpoints restore — reproducibility and randomness break at once.
    Use torch's RNG (``torch.rand(..., generator=g)``, ``torch.bernoulli``,
    dropout) on the device."""
    for fn in ctx.step_fns:
        for node, _ in walk_fn(fn.node):
            if not isinstance(node, ast.Call):
                continue
            resolved = ctx.resolve(node.func) or ""
            if resolved.startswith("numpy.random."):
                yield _f(
                    ctx, "DML102", node,
                    f"{resolved} inside a step draws on the host (a constant "
                    "under torch.compile, outside the seeded torch generators); "
                    "use torch's RNG on the device",
                    fn.qualname,
                )
            elif resolved.startswith("random."):
                yield _f(
                    ctx, "DML102", node,
                    f"stdlib {resolved} inside a step draws on the host (a "
                    "constant under torch.compile); use torch's RNG on the device",
                    fn.qualname,
                )


# ------------------------------------------------------------------- DML104


def _hazardous_test(node: ast.AST, tainted: set[str], ctx: ModuleCtx) -> bool:
    """A tensor reference in a branch condition that is NOT statically safe.
    Pruned as safe: ``x is None`` checks, ``isinstance``/``len``/... calls,
    string-key membership, and metadata (``.shape``/``.ndim``/``.dtype``/
    ``.size()``/``.dim()``/``.device``/...)."""
    if isinstance(node, ast.Compare) and all(
        isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops
    ):
        operands = [node.left, *node.comparators]
        if any(isinstance(o, ast.Constant) and o.value is None for o in operands):
            return False
    if isinstance(node, ast.Compare) and all(
        isinstance(op, (ast.In, ast.NotIn)) for op in node.ops
    ):
        # '"mask" in batch': the batch's structure is fixed per signature,
        # so key membership is not a tensor value (compile/buckets.py)
        if isinstance(node.left, ast.Constant) and isinstance(node.left.value, str):
            return False
    if isinstance(node, ast.Call):
        fname = (ctx.resolve(node.func) or "").split(".")[-1]
        if fname in _TRACE_SAFE_CALLS:
            return False
    if isinstance(node, ast.Attribute) and node.attr in _TRACE_SAFE_ATTRS:
        return False
    if isinstance(node, ast.Name):
        return node.id in tainted
    return any(_hazardous_test(c, tainted, ctx) for c in ast.iter_child_nodes(node))


@rule("DML104", "data-dependent control flow on tensor values in a step fn")
def check_retrace(ctx: ModuleCtx):
    """Python control flow on a tensor's value reads it on the host: eagerly
    a sync per step, under ``torch.compile`` a graph break (an error with
    ``fullgraph=True``) or a recompile per value. Use ``torch.where`` /
    masks / ``torch.cond``. Runtime companion: ``lint.TraceGuard`` reads the
    compiled step's signature count across calls and catches what static
    analysis can't."""
    for fn in ctx.step_fns:
        for node, _ in walk_fn(fn.node):
            if isinstance(node, (ast.If, ast.While)) and _hazardous_test(
                node.test, fn.tainted, ctx
            ):
                kind = "if" if isinstance(node, ast.If) else "while"
                yield _f(
                    ctx, "DML104", node,
                    f"data-dependent `{kind}` on a tensor value inside a step (a "
                    "host sync; a graph break or recompile under torch.compile); "
                    "use torch.where / torch.cond",
                    fn.qualname,
                )
            elif isinstance(node, ast.IfExp) and _hazardous_test(
                node.test, fn.tainted, ctx
            ):
                yield _f(
                    ctx, "DML104", node,
                    "data-dependent conditional expression on a tensor value "
                    "inside a step; use torch.where",
                    fn.qualname,
                )
            elif isinstance(node, (ast.For, ast.AsyncFor)) and _hazardous_test(
                node.iter, fn.tainted, ctx
            ):
                yield _f(
                    ctx, "DML104", node,
                    "iterating a tensor inside a step launches one set of kernels "
                    "per element (and unrolls the graph under torch.compile); "
                    "use a batched op",
                    fn.qualname,
                )


# ------------------------------------------------------------------- DML105


@rule("DML105", "blocking checkpoint/wandb call inside the epoch loop")
def check_blocking_io(ctx: ModuleCtx):
    """Checkpoint saves and wandb calls on the training thread stall the
    launch queue for the full serialization/HTTP round trip. Route saves
    through the stage's async single-flight path (``checkpoint_every*``,
    committed under ``StallTimer.measure()``) and log metrics via the
    tracker (wandb publishes once per epoch in ``_post_epoch``)."""
    for fn in ctx.epoch_fns:
        for node, in_measure in walk_fn(fn.node):
            if in_measure or not isinstance(node, ast.Call):
                continue
            resolved = ctx.resolve(node.func) or ""
            if resolved == "wandb" or resolved.startswith("wandb."):
                yield _f(
                    ctx, "DML105", node,
                    f"{resolved}() inside the epoch loop blocks training on "
                    "network I/O; track metrics instead (the pipeline publishes "
                    "to wandb once per epoch)",
                    fn.qualname,
                )
                continue
            func = node.func
            if (
                isinstance(func, ast.Attribute)
                and func.attr in _SAVE_ATTRS
                and any(
                    "ckpt" in seg.lower() or "checkpoint" in seg.lower()
                    for seg in attr_chain(func)[:-1]
                )
            ):
                yield _f(
                    ctx, "DML105", node,
                    f"blocking {func.attr}() inside the epoch loop; use the "
                    "stage's async checkpoint path (checkpoint_every_steps / "
                    "async_checkpoint) or account it under StallTimer.measure()",
                    fn.qualname,
                )


# ------------------------------------------------------------------- DML106


@rule("DML106", "wall-clock timing of CUDA launches without a device sync")
def check_dishonest_timing(ctx: ModuleCtx):
    """A CUDA launch returns as soon as the kernel is *queued*; wall-clocking
    a step without ``torch.cuda.synchronize()`` (or ``Event.synchronize()``,
    or a value read) measures host launch cost, not device time — the
    classic mis-benchmark. Applies to any function that reads the clock
    twice around dispatchy calls."""
    for node in ast.walk(ctx.tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        clock_reads: list[ast.Call] = []
        dispatchy = False
        synced = False
        for sub in ast.walk(node):
            # nested defs are analyzed on their own walk(ctx.tree) visit,
            # but their bodies still belong to this timing region too, so
            # they are NOT excluded here.
            if not isinstance(sub, ast.Call):
                continue
            resolved = ctx.resolve(sub.func) or ""
            if resolved in _WALL_CLOCK_FNS:
                clock_reads.append(sub)
                continue
            last = resolved.split(".")[-1] if resolved else ""
            if isinstance(sub.func, ast.Attribute):
                last = sub.func.attr
            elif isinstance(sub.func, ast.Name):
                last = sub.func.id
            if last in _SYNC_MARKERS:
                synced = True
            elif (
                isinstance(sub.func, ast.Name)
                and sub.func.id == "float"
                and len(sub.args) == 1
            ):
                # a value read (`float(loss)`) waits for the whole chain of
                # kernels that produce it
                synced = True
            elif "step" in last.lower() or last in ctx.compiled_names:
                dispatchy = True
        if len(clock_reads) >= 2 and dispatchy and not synced:
            yield _f(
                ctx, "DML106", clock_reads[1],
                "wall-clock timing around queued CUDA work without a device "
                "sync measures launch cost, not execution; call "
                "torch.cuda.synchronize() (or time with CUDA events) before "
                "reading the clock",
                node.name,
            )


# ------------------------------------------------------------------- DML108


@rule("DML108", "time.time() used for step timing in step/epoch code")
def check_wall_clock_step_timing(ctx: ModuleCtx):
    """``time.time()`` reads the WALL clock, which NTP slews and steps —
    a few-ms jump is routine, a leap-second or chrony correction can move
    it by seconds in either direction, and every span/step duration derived
    from it is then silently wrong (negative durations crash trace viewers;
    inflated ones send you hunting a stall that never happened). Step and
    epoch code must time with ``time.perf_counter()`` /
    ``time.perf_counter_ns()`` — monotonic, and what the telemetry journal's
    own span durations use (wall clock appears only as the journal's one
    mergeable anchor per run). Outside the hazard contexts (logging a
    human-readable start time, naming a checkpoint dir) ``time.time()`` is
    fine and not flagged."""
    for fn in ctx.step_fns + ctx.epoch_fns:
        for node, _ in walk_fn(fn.node):
            if not isinstance(node, ast.Call):
                continue
            resolved = ctx.resolve(node.func) or ""
            if resolved in ("time.time", "time.time_ns"):
                yield _f(
                    ctx, "DML108", node,
                    f"{resolved}() is wall-clock (NTP can step it mid-run, corrupting "
                    "step/span durations); time step and epoch code with the monotonic "
                    "time.perf_counter()/perf_counter_ns()",
                    fn.qualname,
                )


# ------------------------------------------------------------------- DML107


@rule("DML107", "torch.compile call inside a loop body")
def check_jit_in_loop(ctx: ModuleCtx):
    """``torch.compile(...)`` (or ``partial(torch.compile, ...)`` / a
    ``@torch.compile``-decorated ``def``) executed inside a ``for``/``while``
    body creates a FRESH compiled callable every iteration — each one starts
    with an empty Dynamo cache, so every iteration re-captures and
    re-compiles work the previous iteration already paid for (Inductor's
    persistent cache can soften the codegen half, never the capture half).
    Hoist the ``torch.compile`` out of the loop (or precompile it:
    compile/aot.py). Bodies of functions *defined* inside the loop run at
    call time, not per iteration, and are skipped."""

    def visit(node: ast.AST, in_loop: bool):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if in_loop:
                    for dec in child.decorator_list:
                        if ctx.is_compile(dec):
                            yield _f(
                                ctx, "DML107", dec,
                                f"@torch.compile-decorated def {child.name!r} inside "
                                "a loop body re-compiles every iteration; define it "
                                "once before the loop",
                                child.name,
                            )
                # the nested body executes when called, not per iteration
                yield from visit(child, False)
                continue
            if isinstance(child, ast.Lambda):
                yield from visit(child, False)
                continue
            if in_loop and isinstance(child, ast.Call) and ctx.is_compile_call(child):
                yield _f(
                    ctx, "DML107", child,
                    "torch.compile call inside a loop body builds a fresh compiled "
                    "function (empty cache) every iteration — every step re-captures "
                    "and re-compiles; hoist the torch.compile out of the loop",
                    "",
                )
            yield from visit(
                child, in_loop or isinstance(child, (ast.For, ast.AsyncFor, ast.While))
            )

    yield from visit(ctx.tree, False)
