"""Ahead-of-time compilation of step functions.

Counterpart of ``dmlcloud_tpu/compile/aot.py``. The reference lowers and
compiles its jitted step against abstract ``ShapeDtypeStruct`` inputs before
the data loop. Here the compiler is ``torch.compile(fn, fullgraph=True,
dynamic=False)`` with Inductor (``BACKEND``):

- static shapes, as XLA's: one graph per call signature, so a shape bucket
  set bounds the graphs (automatic dynamic shapes would merge the buckets into
  one symbolic graph);
- ``fullgraph=True``: a graph break is an error, never a silent split;
- Dynamo's recompile limit is set to cover the expected signatures, and
  hitting it raises instead of dropping the function to eager;
- each compiled region gets a copy of its function's code object, so its
  graphs, and the recompile limit, belong to it alone and not to every
  stage that shares the source.

``PrecompiledStep`` wraps one step function in a registry of call signatures
(pytree structure + per-leaf shape/dtype/DTensor placements):

- ``precompile(*specs)`` warms one signature ahead of time. Torch has no
  compilation from abstract specs, so it runs the step on zeros of the spec,
  forward and backward, timed, inside a ``journal.span("compile")``, and
  accounted against the persistent cache as a hit or a miss (Inductor's
  counters, compile/cache.py). ``preserve`` makes the warm-up leave the
  training state as it found it: parameters, gradients, buffers, optimizer
  state, counters and generators, bit for bit (``preserving``);
- calling it runs the compiled function; a signature it has not seen compiles
  there, and counts once: the ``misc/recompiles`` metric;
- ``_cache_size()`` reports the distinct signatures seen, the probe
  ``lint.TraceGuard`` reads.

Abstract specs come from ``abstract_spec`` (any pytree of tensors or arrays ->
``TensorSpec`` skeleton) and ``global_batch_spec`` (the batch all
data-parallel processes feed together); ``validate_global_batch_spec`` keeps
the reference's stage-start check that a batch dim divides over the mesh's
data-parallel axes. On a mesh each process feeds its own rows as a plain
tensor (``parallel.mesh.make_global_batch``), so the spec it precompiles is
that of its rows, with no placements; a DTensor input's spec keeps its mesh
and placements, and its zeros are a DTensor of the same layout.

``compile_blocks`` moves the boundary of a region to a model's blocks: the
step of a model whose parameters are DTensors (FSDP2, ``model``, ``expert``)
compiles each block's forward, one graph shared by like blocks, with the
module hooks (FSDP2's all-gather and reshard) running eagerly around it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
import types
from typing import Any, Callable

import numpy as np
import torch
import torch.utils._pytree as pytree

from ..parallel import mesh as mesh_lib
from ..parallel.tensor_parallel import local_tensor
from . import cache as cache_lib

__all__ = [
    "BACKEND",
    "RECOMPILE_LIMIT",
    "TensorSpec",
    "PrecompiledStep",
    "abstract_spec",
    "compile_blocks",
    "compile_region",
    "global_batch_spec",
    "preserving",
    "signature_of",
    "validate_global_batch_spec",
]

#: the ``torch.compile`` backend of every compiled region (Inductor; the CPU
#: tests set ``"aot_eager"``, which skips code generation)
BACKEND = "inductor"
#: Dynamo's recompile limit per compiled region, raised to the expected
#: signature count where that is larger
RECOMPILE_LIMIT = 8


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """Shape, dtype and (for a DTensor) placements of one tensor: the
    counterpart of ``jax.ShapeDtypeStruct``. A DTensor's spec also keeps its
    ``DeviceMesh`` (outside the signature), which its zeros are laid out on."""

    shape: tuple[int, ...]
    dtype: torch.dtype
    placements: tuple | None = None
    mesh: Any = dataclasses.field(default=None, compare=False, repr=False)


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, dtype=np.dtype(dtype))).dtype


def abstract_spec(tree: Any) -> Any:
    """``TensorSpec`` skeleton of a pytree: tensors keep their DTensor
    placements, numpy arrays and numbers contribute shape and dtype, existing
    ``TensorSpec`` leaves pass through; other leaves stay as they are."""

    def leaf(x):
        if isinstance(x, TensorSpec):
            return x
        if isinstance(x, torch.Tensor):
            if hasattr(x, "placements"):
                return TensorSpec(tuple(x.shape), x.dtype, tuple(x.placements), x.device_mesh)
            return TensorSpec(tuple(x.shape), x.dtype)
        if isinstance(x, (np.ndarray, np.generic, bool, int, float)):
            arr = np.asarray(x)
            return TensorSpec(tuple(arr.shape), _torch_dtype(arr.dtype))
        return x

    return pytree.tree_map(leaf, tree)


def global_batch_spec(batch_or_spec: Any, mesh: Any) -> Any:
    """The abstract batch that all data-parallel processes of ``mesh`` feed
    together, each leaf sharded along dim 0 over the data axes: one process
    feeds ``batch_or_spec`` (its own rows), so the global leading dim is that
    times the data-parallel size. ``mesh`` is a ``DeviceMesh`` or an
    ``{axis: size}`` dict."""
    from torch.distributed.tensor import Replicate, Shard

    axes = mesh_lib.mesh_axes(mesh)
    dp, data = mesh_lib.data_parallel_size(axes), mesh_lib.data_axes(axes)
    placements = tuple(Shard(0) if a in data else Replicate() for a in axes)

    def leaf(s):
        if not isinstance(s, TensorSpec):
            return s
        shape = (s.shape[0] * dp, *s.shape[1:]) if s.shape else s.shape
        return TensorSpec(shape, s.dtype, placements)

    return pytree.tree_map(leaf, abstract_spec(batch_or_spec))


def validate_global_batch_spec(spec: Any, mesh: Any) -> None:
    """Raise the step-1 sharding crash at stage start instead: every leaf's
    leading (batch) dim must divide over the mesh's data-parallel axes."""
    axes = mesh_lib.mesh_axes(mesh)
    dp = mesh_lib.data_parallel_size(axes)
    if dp <= 1:
        return
    leaves, _ = pytree.tree_flatten_with_path(abstract_spec(spec))
    for path, leaf in leaves:
        shape = getattr(leaf, "shape", ())
        if len(shape) >= 1 and shape[0] % dp != 0:
            where = "".join(f"/{getattr(k, 'key', getattr(k, 'idx', k))}" for k in path).lstrip("/")
            raise ValueError(
                f"batch leaf {where or '<root>'} has leading dim "
                f"{shape[0]}, not divisible by the mesh's data-parallel size {dp} "
                f"(axes {mesh_lib.data_axes(axes)}); this would crash at step 1 — fix "
                "the batch size, the bucket set, or the mesh"
            )


def _leaf_signature(x: Any) -> tuple:
    if isinstance(x, (torch.Tensor, TensorSpec)):
        placements = getattr(x, "placements", None)
        return (tuple(x.shape), str(x.dtype), None if placements is None else tuple(placements))
    if isinstance(x, (np.ndarray, np.generic)):
        return (tuple(x.shape), str(_torch_dtype(x.dtype)), None)
    return ((), type(x).__name__, None)


def signature_of(args: tuple) -> tuple:
    """Hashable call signature: pytree structure + per-leaf shape, dtype and
    DTensor placements (None for a plain tensor). Two calls with equal
    signatures run the same compiled graphs."""
    leaves, treedef = pytree.tree_flatten(args)
    return (str(treedef), tuple(_leaf_signature(x) for x in leaves))


def compile_region(fn: Callable, name: str | None = None) -> Callable:
    """``torch.compile(fn, fullgraph=True, dynamic=False)`` with ``BACKEND``,
    over a copy of ``fn``'s code object (named ``name``): Dynamo keeps the
    compiled graphs, and counts recompilations, per code object."""
    inner = fn.__func__ if isinstance(fn, types.MethodType) else fn
    code = inner.__code__.replace(co_name=name or inner.__name__)
    copy = types.FunctionType(code, inner.__globals__, code.co_name, inner.__defaults__, inner.__closure__)
    copy.__kwdefaults__ = inner.__kwdefaults__
    if isinstance(fn, types.MethodType):
        copy = types.MethodType(copy, fn.__self__)
    return torch.compile(copy, fullgraph=True, dynamic=False, backend=BACKEND)


def compile_blocks(modules, name: str):
    """Compile the ``forward`` of each of ``modules`` as a region
    (``compile_region``), one region per forward function, shared by every
    module that has it: Dynamo takes the module as an input and guards on its
    parameters' shapes, not its identity, so like blocks run one graph. The
    hooks around a module's call (FSDP2's all-gather before, its reshard and
    gradient reduce-scatter after) run eagerly, outside the region. Returns
    the function that puts the plain forwards back."""
    regions: dict[Any, Callable] = {}
    for m in modules:
        fn = type(m).forward
        if fn not in regions:
            regions[fn] = compile_region(fn, f"{name}_{fn.__qualname__.replace('.', '_')}")
        m.forward = types.MethodType(regions[fn], m)

    def restore() -> None:
        for m in modules:
            m.__dict__.pop("forward", None)

    return restore


def _zeros(specs: Any, device) -> Any:
    def leaf(x):
        if isinstance(x, TensorSpec):
            if x.placements is not None:
                if x.mesh is None:
                    raise ValueError(f"a TensorSpec with placements {x.placements} needs its DeviceMesh (mesh=) to "
                                     "make its zeros; a process's batch rows are a plain tensor (no placements)")
                from torch.distributed.tensor import zeros as dtensor_zeros

                return dtensor_zeros(x.shape, dtype=x.dtype, device_mesh=x.mesh, placements=x.placements)
            return torch.zeros(x.shape, dtype=x.dtype, device=device)
        if isinstance(x, torch.Tensor):
            return torch.zeros_like(x)
        if isinstance(x, (np.ndarray, np.generic)):
            return torch.zeros(x.shape, dtype=_torch_dtype(x.dtype), device=device)
        return x

    return pytree.tree_map(leaf, specs)


@contextlib.contextmanager
def preserving(modules=(), optimizers=(), tensors=(), holders=()):
    """Run the body, then put back bit for bit what it changed: the
    parameters, gradients (None included; the gradient tensors themselves,
    their values restored), buffers and ``torch.Generator``
    attributes of ``modules``; every tensor and number in the state of
    ``optimizers`` (slots the body created are dropped) and their int/float
    attributes (a step count); ``tensors`` (an EMA shadow); the int/float
    attributes of ``holders`` (a ``TrainState``'s step); and the default CPU
    and CUDA generators. Tensors are copied to host memory, so the snapshot
    costs no device memory. A DTensor (an FSDP2 shard, a tensor-parallel
    slice, its optimizer slots and EMA) is restored through its local
    tensor, on every process."""
    saved: list[tuple[torch.Tensor, torch.Tensor]] = []
    grads: list[tuple[torch.Tensor, torch.Tensor | None]] = []
    attrs: list[tuple[Any, str, Any]] = []
    gens: list[tuple[torch.Generator, torch.Tensor]] = []
    slots: list[tuple[dict, dict]] = []

    def keep(t):
        if isinstance(t, torch.Tensor):
            saved.append((t, local_tensor(t).detach().to("cpu", copy=True)))

    def keep_numbers(obj):
        for k, v in vars(obj).items():
            if isinstance(v, (bool, int, float)):
                attrs.append((obj, k, v))

    for m in modules:
        for p in m.parameters():
            keep(p)
            grads.append((p, p.grad))
            keep(p.grad)
        for b in m.buffers():
            keep(b)
        for sub in m.modules():
            gens.extend((g, g.get_state()) for g in vars(sub).values() if isinstance(g, torch.Generator))
    for opt in optimizers:
        keep_numbers(opt)
        for pstate in opt.state.values():
            slots.append((pstate, dict(pstate)))
            for v in pstate.values():
                keep(v)
        slots.append((opt.state, dict(opt.state)))
    for t in tensors:
        keep(t)
    for h in holders:
        keep_numbers(h)
    cpu_rng = torch.get_rng_state()
    cuda_rng = torch.cuda.get_rng_state_all() if torch.cuda.is_initialized() else None
    try:
        yield
    finally:
        with torch.no_grad():
            for t, host in saved:
                local_tensor(t).copy_(host)
            for p, g in grads:
                p.grad = g
        for d, before in slots:
            d.clear()
            d.update(before)
        for obj, k, v in attrs:
            setattr(obj, k, v)
        for g, state in gens:
            g.set_state(state)
        torch.set_rng_state(cpu_rng)
        if cuda_rng is not None:
            torch.cuda.set_rng_state_all(cuda_rng)


@dataclasses.dataclass
class CompiledSignature:
    """One precompiled signature: what it cost and, when counted, the FLOPs
    of one call (``torch.utils.flop_counter``), read by
    ``telemetry.goodput.flops_from_compiled``."""

    signature: tuple
    compile_ms: float
    hit: bool
    flops: float | None = None


class PrecompiledStep:
    """Signature registry over one compiled step function (see the module
    docstring). Thread-compatible with the single training thread; not
    locked.

    ``compile=False`` takes ``fn`` as it is: a function that calls compiled
    regions of its own (``compile_region``), as the stage's step does, with
    eager code between them. ``preserve`` is a context-manager factory
    (``preserving``) that ``precompile`` and ``count_flops`` run the function
    in. ``recompile_limit`` is Dynamo's limit per region while the function
    runs; hitting it raises."""

    def __init__(self, fn: Callable, name: str = "step", *, compile: bool = True, preserve: Callable | None = None,
                 recompile_limit: int | None = None):
        self._fn = compile_region(fn, name.replace(".", "_")) if compile else fn
        self.name = name
        self._preserve = preserve or contextlib.nullcontext
        self.recompile_limit = max(RECOMPILE_LIMIT, int(recompile_limit or 0))
        self._compiled: dict[tuple, CompiledSignature] = {}
        self._seen: set[tuple] = set()
        self._recompiles = 0
        self.compile_ms = 0.0

    def _run(self, *args: Any):
        import torch._dynamo.config as dynamo_config

        with dynamo_config.patch(recompile_limit=self.recompile_limit, fail_on_recompile_limit_hit=True):
            return self._fn(*args)

    def precompile(self, *specs: Any, device: Any = None) -> float:
        """Compile one signature ahead of the data loop by running the
        function on zeros of ``specs`` (``TensorSpec`` trees, or example
        tensors) on ``device``; returns the wall-clock ms it took (0.0 if
        already registered). A hit is a compilation that Inductor's caches
        served entirely (hits, no misses)."""
        sig = signature_of(specs)
        if sig in self._compiled:
            return 0.0
        from ..telemetry import journal as _journal

        args = _zeros(specs, device)
        before = cache_lib.compile_counters()
        t0 = time.perf_counter()
        with _journal.span("compile", label=self.name, signature=len(self._compiled) + 1):
            with self._preserve():
                self._run(*args)
                _sync(args)
        elapsed_ms = (time.perf_counter() - t0) * 1e3
        after = cache_lib.compile_counters()
        hits = after["fxgraph_hit"] + after["autograd_hit"] - before["fxgraph_hit"] - before["autograd_hit"]
        misses = after["fxgraph_miss"] + after["autograd_miss"] - before["fxgraph_miss"] - before["autograd_miss"]
        hit = hits > 0 and misses == 0
        cache_lib.record_compile(hit=hit, elapsed_ms=elapsed_ms)
        self._compiled[sig] = CompiledSignature(sig, elapsed_ms, hit)
        self._seen.add(sig)
        self.compile_ms += elapsed_ms
        return elapsed_ms

    def count_flops(self, *specs: Any, device: Any = None) -> float | None:
        """FLOPs of one call on zeros of ``specs``, counted by running the
        function once with compilation off under ``FlopCounterMode`` (every
        aten op with a FLOP formula: matmuls, convolutions, SDPA; not the
        flash kernels' custom ops, whose cost XLA's analysis does not count in
        the reference either), inside ``preserve``; None when nothing was
        counted. Kept on the signature's record when it was precompiled. The
        call costs one eager step's time and memory."""
        from torch.utils.flop_counter import FlopCounterMode

        with self._preserve(), torch.compiler.set_stance("force_eager"):
            with FlopCounterMode(display=False) as counter:
                self._fn(*_zeros(specs, device))
        total = counter.get_total_flops()
        flops = float(total) if total > 0 else None
        record = self._compiled.get(signature_of(specs))
        if record is not None:
            record.flops = flops
        return flops

    def __call__(self, *args: Any):
        sig = signature_of(args)
        if sig not in self._compiled and sig not in self._seen:
            self._seen.add(sig)
            self._recompiles += 1
        return self._run(*args)

    # -- introspection ------------------------------------------------------
    def any_compiled(self) -> CompiledSignature | None:
        """One precompiled signature's record (arbitrary signature), or None:
        enough for per-step cost analysis (telemetry/goodput.py), which is
        signature-independent to first order."""
        return next(iter(self._compiled.values()), None)

    @property
    def signatures(self) -> int:
        """Distinct signatures precompiled (the bounded set buckets target)."""
        return len(self._compiled)

    @property
    def recompiles(self) -> int:
        """Signatures that arrived at call time without a precompiled graph
        (counted once each) since the last ``pop_recompiles``."""
        return self._recompiles

    def pop_recompiles(self) -> int:
        n = self._recompiles
        self._recompiles = 0
        return n

    def _cache_size(self) -> int:
        """Distinct signatures seen (precompiled + compiled at call time): the
        probe ``lint.TraceGuard`` reads across calls."""
        return len(self._seen)


def _sync(tree: Any) -> None:
    """Wait for the device work of the warm-up, so its time is counted."""
    for x in pytree.tree_leaves(tree):
        if isinstance(x, torch.Tensor) and x.is_cuda:
            torch.cuda.synchronize(x.device)
            return
