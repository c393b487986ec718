"""Named device meshes and parameter sharding policies.

Counterpart of ``dmlcloud_tpu/parallel/mesh.py``: the axis names (:37),
``parse_mesh_axes`` (:43), ``create_mesh`` (:69), ``auto_mesh`` (:106),
``data_axes``/``batch_pspec``/``data_parallel_size`` (:135, :141, :154),
``respec_for_mesh`` and its JSON form (:175-225), ``path_str`` (:231),
``_fsdp_spec`` (:248), ``make_param_policy`` (:265), ``sharding_for`` (:332)
and ``make_global_batch`` (:347, this process's rows of the global batch),
with ``shard_module`` in the place of ``shard_pytree`` (:341). The reference's
``NamedSharding`` helpers (``batch_sharding``, ``replicated``) and
``shard_map_compat`` have no counterpart: a DTensor's placements and the
stage's collectives do their work.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named dims, one
process per device. Policies speak the reference's language: a spec is a tuple
of axis names (``P``, this module's own small PartitionSpec) per dim of the
parameter in the JAX model's (flax) layout, and rules match the flax path
(``layer_0/attn/q_proj/kernel``). So a rule list written for the reference
gives the same specs here, parameter by parameter. Every function that only
reads a mesh's shape also takes a plain ``{axis: size}`` dict.

``shard_module`` lays a module out on the mesh under a policy:

- the ``model`` axis (tensor parallelism) keeps, on each rank, the slice of a
  parameter its spec names, as a DTensor on the ``model`` sub-mesh (the rest
  as replicated DTensors there), and switches the model's forward to the
  local shards and the collectives of ``parallel.tensor_parallel``. Only
  placements the model can execute are accepted (``DecoderLM``: heads and the
  MLP hidden dim, the embedding's features, the LM head's vocab); any other
  raises a ``ValueError`` naming the parameter. The reference relocates an
  indivisible head split onto ``head_dim``; the port raises instead;
- the ``fsdp`` axis (with ``data``, as HSDP) goes to FSDP2: ``fully_shard``
  on each block the model lists (``fsdp_blocks()``) and on the root, each
  parameter's shard on the dim its spec gives. FSDP2 shards every parameter,
  also those the reference's ``_fsdp_spec`` leaves replicated (under
  ``min_size``): the numbers are the same, the memory layout differs;
- without a sharded parameter on ``fsdp``, the gradients are averaged over
  the data-parallel ranks (``data`` x ``fsdp``) by the stage, as in the
  replicated case;
- the ``expert`` axis keeps, on each rank, its ``E / expert`` experts of an
  MoE block (the expert dim, dim 0 of ``moe/gate_proj`` ...) as a DTensor
  ``Shard(0)`` on the ``expert`` sub-mesh (the rest replicated there), and
  switches the MoE blocks to their local experts
  (``DecoderLM.apply_expert_parallel``). The batch is split over ``data``
  and ``fsdp`` only, as the reference's is, so ``expert`` peers see the same
  rows. ``expert`` and ``model`` both above 1 raise ``NotImplementedError``
  (ROADMAP Queue 1 item 15);
- the ``seq`` axis shards no parameter: a model with ``attn_impl="ring"``
  runs its attention over the axis's group (``apply_sequence_parallel``),
  and ``seq`` peers, like ``model`` and ``expert`` peers, feed the same rows
  and count once in the metrics.

``sharding_record`` is what a checkpoint's sharding sidecar records: the
policy's spec of every parameter (by flax path, as the reference records
them) and how it maps onto the stored torch tensor, which
``respec_for_mesh`` re-targets onto another mesh at an elastic restore.
"""

from __future__ import annotations

import logging
import math
import re
from dataclasses import dataclass, field
from typing import Any, Callable, Mapping, Sequence

import torch
import torch.distributed as dist

from . import runtime
from .tensor_parallel import ModelGroup, local_tensor

_logger = logging.getLogger("dmlcloud_tpu_torch")

DATA, FSDP, MODEL, SEQ, EXPERT, PIPE = "data", "fsdp", "model", "seq", "expert", "pipe"

__all__ = ["DATA", "FSDP", "MODEL", "SEQ", "EXPERT", "PIPE", "P", "MeshPlan", "parse_mesh_axes", "mesh_shape",
           "create_mesh", "auto_mesh_axes", "auto_mesh", "mesh_axes", "data_axes", "data_parallel_size",
           "data_parallel_rank", "batch_pspec", "make_global_batch", "respec_for_mesh", "spec_to_jsonable", "spec_from_jsonable", "path_str",
           "make_param_policy", "sharding_for", "sharding_record", "placements", "expert_placements", "shard_module",
           "grad_sq_norm",
           "data_parallel_group"]


class P(tuple):
    """A partition spec: per dim of the parameter (flax layout), None, an axis
    name, or a tuple of axis names. Compares equal to the tuple of its entries,
    as JAX's ``PartitionSpec`` does."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


#: rule list: (regex over the '/'-joined flax path, spec)
PartitionRules = Sequence[tuple[str, P]]


def parse_mesh_axes(spec: str) -> dict[str, int]:
    """Parse a CLI mesh spec like ``'data=2,fsdp=4'`` into an axes dict for
    :func:`create_mesh` / ``TrainingPipeline.set_mesh`` (``-1`` absorbs the
    remaining devices)."""
    axes: dict[str, int] = {}
    for part in spec.split(","):
        name, eq, size = part.partition("=")
        name = name.strip()
        try:
            if not (name and eq):
                raise ValueError
            parsed = int(size)
        except ValueError:
            raise ValueError(
                f"malformed mesh spec {spec!r}: expected comma-separated name=int "
                f"pairs like 'data=2,fsdp=4' (bad part: {part!r})"
            ) from None
        if name in axes:
            raise ValueError(f"malformed mesh spec {spec!r}: axis {name!r} given more than once")
        axes[name] = parsed
    return axes


def mesh_shape(axes: Mapping[str, int] | None, n: int) -> dict[str, int]:
    """``axes`` with its ``-1`` resolved against ``n`` devices, checked as
    ``create_mesh`` checks it (same errors as the reference)."""
    if axes is None:
        axes = {DATA: -1}
    names = list(axes.keys())
    sizes = list(axes.values())
    if sizes.count(-1) > 1:
        raise ValueError("at most one mesh axis may be -1")
    if -1 in sizes:
        known = math.prod(s for s in sizes if s != -1)
        if n % known != 0:
            raise ValueError(f"{n} devices not divisible by fixed axes product {known}")
        sizes[sizes.index(-1)] = n // known
    if math.prod(sizes) != n:
        raise ValueError(f"mesh {dict(zip(names, sizes))} needs {math.prod(sizes)} devices, have {n}")
    return dict(zip(names, sizes))


def create_mesh(axes: Mapping[str, int] | None = None, device: str | torch.device | None = None):
    """A named ``DeviceMesh`` over every process (one device each), from
    ``axes`` (name -> size; one axis may be ``-1``; default ``{'data': -1}``).
    Creates a one-rank process group first when a single process has none.
    ``device`` defaults to ``cuda`` (raises without a card)."""
    from torch.distributed.device_mesh import init_device_mesh

    device = runtime.resolve_device(device)
    if not runtime.is_initialized():
        runtime.init_auto(device)
    shape = mesh_shape(axes, runtime.world_size())
    runtime.ensure_process_group(device)
    return init_device_mesh(device.type, tuple(shape.values()), mesh_dim_names=tuple(shape))


def auto_mesh_axes(n: int, axis_names: Sequence[str] = (DATA, FSDP, MODEL)) -> dict[str, int]:
    """The reference's factorisation of ``n`` devices over ``axis_names``:
    the smallest prime factors are dealt out round-robin."""
    sizes = [1] * len(axis_names)
    rem, i = n, 0
    while rem > 1:
        for p in (2, 3, 5, 7, 11, 13):
            if rem % p == 0:
                sizes[i % len(sizes)] *= p
                rem //= p
                break
        else:
            sizes[i % len(sizes)] *= rem
            rem = 1
        i += 1
    return dict(zip(axis_names, sizes))


def auto_mesh(axis_names: Sequence[str] = (DATA, FSDP, MODEL), device: str | torch.device | None = None):
    """``create_mesh`` over every process with ``auto_mesh_axes``' sizes."""
    device = runtime.resolve_device(device)
    if not runtime.is_initialized():
        runtime.init_auto(device)
    return create_mesh(auto_mesh_axes(runtime.world_size(), axis_names), device=device)


def mesh_axes(mesh: Any) -> dict[str, int]:
    """``{axis: size}`` of a ``DeviceMesh`` (or of such a dict itself)."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def data_axes(mesh: Any) -> tuple[str, ...]:
    """The axes the batch dimension is sharded over: ``data`` plus ``fsdp``
    when present."""
    names = mesh_axes(mesh)
    return tuple(a for a in (DATA, FSDP) if a in names)


def data_parallel_size(mesh: Any) -> int:
    axes = mesh_axes(mesh)
    return int(math.prod(axes[a] for a in data_axes(axes)) or 1)


def data_parallel_rank(mesh) -> int:
    """This process's coordinate over ``data`` x ``fsdp`` (row-major, in the
    mesh's order): which slice of the global batch it feeds. Processes that
    differ only along ``model`` or ``seq`` (tensor- and sequence-parallel
    peers) share it."""
    names = list(mesh.mesh_dim_names)
    coord = mesh.get_coordinate()
    rank = 0
    for a in data_axes(mesh):
        i = names.index(a)
        rank = rank * mesh.shape[i] + coord[i]
    return rank


def batch_pspec(mesh: Any) -> P:
    """The spec of a batch's leading dim: over ``data`` and ``fsdp`` (one
    axis name, the tuple of both, or None)."""
    ax = data_axes(mesh)
    return P(ax if len(ax) > 1 else (ax[0] if ax else None))


def make_global_batch(batch: Any, mesh, pspec: Sequence | None = None) -> Any:
    """This process's rows of the global ``batch`` (a tensor, an array, or
    nested dicts, lists and tuples of them): the slice of dim 0 that its
    coordinate over the axes of ``pspec``'s first entry (default
    ``batch_pspec(mesh)``: ``data`` x ``fsdp``, row-major in the mesh's order)
    selects, the same rows as its tensor- and sequence-parallel peers.

    The reference stitches per-process host data into one global
    ``jax.Array``; in the port each process holds its own rows, so the
    counterpart takes the global batch, the same on every process (one seeded
    stream), and keeps this coordinate's share of it."""
    spec = batch_pspec(mesh) if pspec is None else P(*pspec)
    axes = spec[0] if spec else None
    axes = () if axes is None else ((axes,) if isinstance(axes, str) else tuple(axes))
    names = list(mesh.mesh_dim_names)
    coord = mesh.get_coordinate()
    size, rank = 1, 0
    for a in axes:
        i = names.index(a)
        size, rank = size * mesh.shape[i], rank * mesh.shape[i] + coord[i]

    def mine(x):
        if isinstance(x, dict):
            return {k: mine(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(mine(v) for v in x)
        n = x.shape[0]
        if n % size:
            raise ValueError(f"a batch of {n} rows does not split over {size} data-parallel coordinates {axes}")
        return x[rank * (n // size):(rank + 1) * (n // size)]

    return mine(batch)


def respec_for_mesh(spec: Sequence | None, shape: Sequence[int], mesh: Any) -> P:
    """Re-target a spec recorded on one mesh onto ``mesh`` (a ``DeviceMesh``
    or an axes dict): the elastic-restore primitive. Axes the new mesh lacks
    are dropped (replicated); an axis that no longer divides its dim moves to
    the largest other dim it divides (at least twice its size), else it is
    dropped with a warning. Always returns a spec valid on ``mesh``."""
    axes_of = mesh_axes(mesh)
    entries = list(spec) if spec is not None else []
    shape = tuple(shape)
    cleaned: list = [None] * len(shape)
    displaced: list = []
    for i, a in enumerate(entries[: len(shape)]):
        axes = (a,) if isinstance(a, str) else (a or ())
        if a is None or not axes or not all(x in axes_of for x in axes):
            continue
        n = math.prod(axes_of[x] for x in axes)
        if shape[i] % n == 0:
            cleaned[i] = a
        else:
            displaced.append((a, n))
    for a, n in displaced:
        for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
            if cleaned[i] is None and shape[i] % n == 0 and shape[i] >= 2 * n:
                cleaned[i] = a
                break
        else:
            _logger.warning("restore respec: no dim of shape %s divisible by saved axis %r (size %d on the new mesh); "
                            "restoring that axis replicated", shape, a, n)
    return P(*cleaned)


def spec_to_jsonable(spec: Sequence | None) -> list:
    """A spec as a JSON list (None, an axis name or a list of names per dim):
    the sharding sidecar's wire format (``checkpoint.py``)."""
    return [a if a is None or isinstance(a, str) else list(a) for a in (spec or ())]


def spec_from_jsonable(entries: Sequence | None) -> P:
    """Inverse of :func:`spec_to_jsonable`."""
    return P(*[tuple(a) if isinstance(a, list) else a for a in (entries or ())])


# ---------------------------------------------------------------------------
# parameter sharding policies
# ---------------------------------------------------------------------------

def path_str(path) -> str:
    """'/'-joined key path (strings, ints, or JAX key entries)."""
    parts = []
    for p in path:
        if hasattr(p, "key"):
            parts.append(str(p.key))
        elif hasattr(p, "name"):
            parts.append(str(p.name))
        elif hasattr(p, "idx"):
            parts.append(str(p.idx))
        else:
            parts.append(str(p))
    return "/".join(parts)


def _fsdp_spec(x: Any, mesh: Any, axis: str = FSDP, min_size: int = 2**14) -> P:
    """Shard the largest divisible dim of ``x`` over the fsdp axis; tiny or
    indivisible params stay replicated."""
    shape = tuple(getattr(x, "shape", ()))
    size = math.prod(shape) if shape else 0
    n = mesh_axes(mesh).get(axis, 1)
    if n <= 1 or size < min_size:
        return P()
    order = sorted(range(len(shape)), key=lambda i: -shape[i])
    for i in order:
        if shape[i] % n == 0:
            spec = [None] * len(shape)
            spec[i] = axis
            return P(*spec)
    return P()


def make_param_policy(policy: str | PartitionRules | Callable[[str, Any], Any]) -> Callable[[str, Any, Any], P]:
    """Normalise a sharding policy to ``(path, leaf, mesh) -> P``.

    - ``'replicate'``: every param replicated (data parallelism).
    - ``'fsdp'``: largest divisible dim sharded over the ``fsdp`` axis.
    - rule list ``[(regex, spec), ...]``: first match wins; axes the mesh
      lacks are dropped, axes that do not divide their dim are relocated to
      another divisible dim (else dropped with a warning); unmatched params
      fall back to fsdp-or-replicate.
    - callable ``(path, leaf) -> spec``.

    ``leaf`` has the parameter's flax-layout ``shape`` (``shard_module``
    passes a meta tensor of that shape)."""
    if callable(policy):
        def call(path, leaf, mesh):
            spec = policy(path, leaf)
            return P() if spec is None else P(*spec)

        return call
    if policy == "replicate":
        return lambda path, leaf, mesh: P()
    if policy == "fsdp":
        return lambda path, leaf, mesh: _fsdp_spec(leaf, mesh)
    if isinstance(policy, (list, tuple)):
        rules = [(re.compile(pat), spec) for pat, spec in policy]

        def apply_rules(path: str, leaf: Any, mesh: Any) -> P:
            axes_of = mesh_axes(mesh)
            for pat, spec in rules:
                if pat.search(path):
                    shape = tuple(getattr(leaf, "shape", ()))
                    cleaned: list = []
                    displaced: list = []
                    for i, a in enumerate(spec):
                        axes = (a,) if isinstance(a, str) else a
                        if a is None or not all(x in axes_of for x in axes):
                            cleaned.append(None)
                            continue
                        n = math.prod(axes_of[x] for x in axes)
                        if i < len(shape) and shape[i] % n == 0:
                            cleaned.append(a)
                        else:
                            cleaned.append(None)
                            displaced.append((a, n))
                    if displaced:
                        cleaned += [None] * (len(shape) - len(cleaned))
                    for a, n in displaced:
                        for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
                            if cleaned[i] is None and shape[i] % n == 0 and shape[i] >= 2 * n:
                                cleaned[i] = a
                                _logger.info("param %s: axis %r (size %d) does not divide its rule dim; "
                                             "relocated to dim %d of shape %s", path, a, n, i, shape)
                                break
                        else:
                            _logger.warning("param %s: no dim of shape %s divisible by axis %r (size %d); "
                                            "leaving that axis unsharded (replicated)", path, shape, a, n)
                    return P(*cleaned)
            return _fsdp_spec(leaf, mesh) if FSDP in axes_of else P()

        return apply_rules
    raise ValueError(f"unknown sharding policy: {policy!r}")


@dataclass(frozen=True)
class _Row:
    """One parameter: its name in the module, its flax path and shape, and
    for each flax dim the torch dim it is (None: no contiguous torch dim)."""

    name: str
    path: str
    shape: tuple[int, ...]
    dims: tuple[int | None, ...]


def _layout(model: torch.nn.Module) -> list[_Row]:
    """Every parameter of ``model`` in the flax layout its ``flax_layout()``
    declares (the transforms of ``models.bridge.flax_view``); parameters it
    does not declare keep their torch name (``/``-joined) and shape."""
    from ..models.bridge import flax_view  # models import this module

    params = dict(model.named_parameters())
    rows = []
    for path, name, how in (model.flax_layout() if hasattr(model, "flax_layout") else []):
        _, shape, dims = flax_view(params.pop(name).shape, how)
        rows.append(_Row(name, path_str(path), shape, dims))
    for name, p in params.items():
        rows.append(_Row(name, name.replace(".", "/"), tuple(p.shape), tuple(range(p.dim()))))
    return rows


def sharding_for(model: torch.nn.Module, mesh: Any, policy: Any = "replicate") -> dict[str, P]:
    """The spec of every parameter of ``model`` under ``policy`` on ``mesh``
    (a ``DeviceMesh`` or an axes dict), by flax path."""
    fn = make_param_policy(policy)
    return {r.path: fn(r.path, torch.empty(r.shape, device="meta"), mesh) for r in _layout(model)}


def sharding_record(model: torch.nn.Module, mesh: Any, policy: Any = "replicate") -> dict:
    """What a checkpoint's sharding sidecar records of ``model`` under
    ``policy`` on ``mesh`` (a ``DeviceMesh`` or an axes dict), JSON-ready:
    ``{"mesh": {axis: size}, "params": {parameter name: {"path": flax path,
    "spec": the policy's spec (flax layout), "shape": the flax shape, "dims":
    the torch dim of each flax dim (None: folded into the fused heads dim)}}}``."""
    axes = mesh_axes(mesh)
    fn = make_param_policy(policy)
    params = {}
    for r in _layout(model):
        spec = fn(r.path, torch.empty(r.shape, device="meta"), axes)
        params[r.name] = {"path": r.path, "spec": spec_to_jsonable(spec), "shape": list(r.shape), "dims": list(r.dims)}
    return {"mesh": axes, "params": params}


@dataclass
class MeshPlan:
    """How ``shard_module`` laid a module out, for the stage that trains it."""

    axes: dict[str, int]
    #: FSDP2 (``fully_shard``) reduces the gradients over ``data`` x ``fsdp``
    fsdp: bool
    #: the ``model`` axis in use by the forward (None: no tensor parallelism)
    tp: ModelGroup | None
    #: the ``expert`` axis the MoE blocks' experts are split over (None: none)
    ep: ModelGroup | None = None
    #: processes over ``data`` x ``fsdp``, and the group the stage averages
    #: gradients over when FSDP2 does not (None: the default group)
    dp_size: int = 1
    grad_group: Any = None
    #: the data-parallel processes (``data`` x ``fsdp``) when they are not
    #: all processes (None: the default group, or one process)
    dp_group: Any = None
    #: processes that differ only along ``model``, ``seq`` and ``expert``
    #: (they feed the same batch); None: no such peers
    peer_group: Any = None
    peer_size: int = 1
    #: one process per data-parallel coordinate: the metric exchange counts
    #: these (tensor-, sequence- and expert-parallel peers count once); None:
    #: every process
    metric_ranks: list[int] | None = field(default=None)
    #: the sharding sidecar's record of the model (``sharding_record``)
    record: dict | None = None


def _rank_groups(mesh, dims: Sequence[str]) -> list[list[int]]:
    """Global ranks grouped by ``dims``: one list per coordinate of the other
    dims, ordered along ``dims`` (row-major in the mesh's order)."""
    names = list(mesh.mesh_dim_names)
    idx = [names.index(d) for d in names if d in dims]
    rest = [i for i in range(len(names)) if i not in idx]
    grid = mesh.mesh.permute(*rest, *idx)
    return grid.reshape(-1, math.prod(mesh.shape[i] for i in idx) if idx else 1).tolist()


def _subgroup(mesh, dims: Sequence[str]):
    """The process group of this rank over ``dims`` (created on every rank)."""
    groups = _rank_groups(mesh, dims)
    if len(groups) == 1 and len(groups[0]) == dist.get_world_size():
        return None  # the default group
    mine, _ = dist.new_subgroups_by_enumeration(groups)
    return mine


def placements(model: torch.nn.Module, mesh: Any, policy: Any) -> tuple[dict[str, P], dict[str, int], dict[str, int]]:
    """Each parameter's spec under ``policy`` on ``mesh`` (a ``DeviceMesh`` or
    an axes dict), and the torch dims the ``fsdp`` and a ``model`` axis of
    size > 1 shard, by parameter name. Raises ``ValueError`` for a placement
    the port cannot lay out (a ``head_dim`` split over ``model``, a parameter
    split over another axis than ``fsdp``, ``model`` and ``expert``, ``fsdp``
    and ``model`` or ``expert`` on one dim)."""
    specs, fsdp_dim, model_dim, _ = expert_placements(model, mesh, policy)
    return specs, fsdp_dim, model_dim


def expert_placements(model: torch.nn.Module, mesh: Any,
                      policy: Any) -> tuple[dict[str, P], dict[str, int], dict[str, int], dict[str, int]]:
    """``placements``, and the torch dims an ``expert`` axis of size > 1
    shards, by parameter name."""
    axes = mesh_axes(mesh)
    fn = make_param_policy(policy)
    specs, fsdp_dim, model_dim, expert_dim = {}, {}, {}, {}
    for r in _layout(model):
        spec = fn(r.path, torch.empty(r.shape, device="meta"), axes)
        specs[r.name] = spec
        for i, entry in enumerate(spec):
            for ax in (() if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)):
                if ax not in axes:
                    raise ValueError(f"{r.name} ({r.path}): spec {spec} names axis {ax!r}, not in the mesh {axes}")
                if ax == FSDP:
                    # a head_dim shard has no contiguous torch dim; FSDP2 only
                    # stores the shard, so the fused heads dim holds it
                    fsdp_dim[r.name] = 0 if r.dims[i] is None else r.dims[i]
                elif ax == MODEL and axes[MODEL] > 1:
                    if r.dims[i] is None:
                        raise ValueError(
                            f"{r.name} ({r.path}): spec {spec} splits flax dim {i} of {r.shape} over {MODEL!r}, "
                            "which the torch model cannot execute (a head_dim split)")
                    model_dim[r.name] = r.dims[i]
                elif ax == EXPERT and axes[EXPERT] > 1:
                    expert_dim[r.name] = r.dims[i]
                elif ax not in (FSDP, MODEL, EXPERT) and axes[ax] > 1:
                    raise ValueError(f"{r.name} ({r.path}): sharding a parameter over {ax!r} (spec {spec}) is not "
                                     "supported by the port")
        for ax, split in ((MODEL, model_dim), (EXPERT, expert_dim)):
            if r.name in fsdp_dim and fsdp_dim[r.name] == split.get(r.name):
                raise ValueError(f"{r.name} ({r.path}): spec {spec} puts {FSDP!r} and {ax!r} on one dim")
    return specs, fsdp_dim, model_dim, expert_dim


def shard_module(model: torch.nn.Module, mesh, policy: Any = "replicate") -> MeshPlan:
    """Lay ``model``'s parameters out on ``mesh`` under ``policy`` (see the
    module docstring) and return the plan the stage trains it by. Call it on
    every process, after the parameters are equal on all of them."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    axes = mesh_axes(mesh)
    names = list(mesh.mesh_dim_names)
    _, fsdp_dim, model_dim, expert_dim = expert_placements(model, axes, policy)
    if model_dim and expert_dim:
        raise NotImplementedError(f"mesh {axes}: experts split over both {EXPERT!r} and {MODEL!r} are not ported yet "
                                  "(ROADMAP Queue 1 item 15)")
    record = sharding_record(model, axes, policy)
    params = dict(model.named_parameters())
    tp = ep = None
    for axis, split, how, verb in ((MODEL, model_dim, "apply_tensor_parallel", "tensor parallel"),
                                   (EXPERT, expert_dim, "apply_expert_parallel", "expert parallel")):
        if not split:
            continue
        if fsdp_dim and names.index(axis) < max(names.index(a) for a in data_axes(axes)):
            raise ValueError(f"mesh {axes}: with FSDP the {axis!r} axis must come after {data_axes(axes)}")
        apply = getattr(model, how, None)
        if apply is None:
            first = next(iter(split))
            raise ValueError(f"{first}: {type(model).__name__} cannot run {verb} (a {axis!r} placement)")
        group = ModelGroup(mesh.get_group(axis), mesh.get_local_rank(axis), axes[axis])
        apply(group, dict(split))
        if axis == MODEL:
            tp = group
        else:
            ep = group
        sub = mesh[axis]
        with torch.no_grad():
            for name, p in params.items():
                owner, attr = _owner(model, name)
                if name in split:
                    local = p.detach().chunk(group.size, dim=split[name])[group.rank].contiguous()
                    dt = DTensor.from_local(local, sub, [Shard(split[name])], run_check=False)
                else:
                    dt = DTensor.from_local(p.detach(), sub, [Replicate()], run_check=False)
                owner.register_parameter(attr, torch.nn.Parameter(dt, requires_grad=p.requires_grad))
        params = dict(model.named_parameters())

    if fsdp_dim:
        from torch.distributed.fsdp import fully_shard

        dp_names = tuple(a for a in names if a in (DATA, FSDP))
        if dp_names[0] != DATA and DATA in dp_names:
            raise ValueError(f"mesh {axes}: HSDP needs {DATA!r} before {FSDP!r}")
        dp_mesh = mesh[dp_names] if len(dp_names) > 1 else mesh[dp_names[0]]
        placement = {p: Shard(fsdp_dim[n]) for n, p in params.items() if n in fsdp_dim}
        blocks = list(model.fsdp_blocks()) if hasattr(model, "fsdp_blocks") else []
        for module in blocks + [model]:
            fully_shard(module, mesh=dp_mesh, shard_placement_fn=placement.get)

    seq_axis = getattr(getattr(model, "cfg", None), "seq_axis", SEQ)
    if hasattr(model, "apply_sequence_parallel") and seq_axis in axes:
        model.apply_sequence_parallel(mesh)
    elif getattr(getattr(model, "cfg", None), "attn_impl", None) == "ring":
        raise ValueError(f"attn_impl='ring' needs a {seq_axis!r} axis in the mesh {axes}")

    plan = MeshPlan(axes=axes, fsdp=bool(fsdp_dim), tp=tp, ep=ep, dp_size=data_parallel_size(axes),
                    record=record)
    if plan.dp_size > 1:
        plan.dp_group = _subgroup(mesh, data_axes(axes))
        if not plan.fsdp:
            plan.grad_group = plan.dp_group
    peers = [a for a in (MODEL, seq_axis, EXPERT) if axes.get(a, 1) > 1]
    if peers:
        plan.peer_size = math.prod(axes[a] for a in peers)
        plan.peer_group = mesh.get_group(peers[0]) if len(peers) == 1 else _subgroup(mesh, peers)
        plan.metric_ranks = sorted(g[0] for g in _rank_groups(mesh, peers))
    return plan


def data_parallel_group(plan: MeshPlan | None):
    """The process group a model's cross-batch computations run over (global
    BatchNorm statistics, the contrastive loss's gather): the data-parallel
    processes of ``plan`` (None: the model is replicated over every process),
    as a group object, or None when that is one process."""
    if runtime.world_size() == 1 or (plan is not None and plan.dp_size == 1):
        return None
    return dist.group.WORLD if plan is None or plan.dp_group is None else plan.dp_group


def _owner(model: torch.nn.Module, name: str) -> tuple[torch.nn.Module, str]:
    mod, _, attr = name.rpartition(".")
    return (model.get_submodule(mod) if mod else model), attr


def grad_sq_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """The sum of squares of ``tensors`` as whole tensors, in fp32, on every
    rank: each DTensor's local shard counts once per mesh dim it is sharded
    over (summed over that dim's group) and once for the dims it is
    replicated over. Tensors of one sharding are summed in their order, as
    one stack, so one group of plain tensors gives the unsharded sum bitwise."""
    from torch.distributed.tensor import DTensor, Replicate

    groups: dict[tuple, list[torch.Tensor]] = {}
    for t in tensors:
        key: tuple = ()
        if isinstance(t, DTensor):
            if not all(isinstance(p, Replicate) or p.is_shard() for p in t.placements):
                raise ValueError(f"grad_sq_norm: unreduced placements {t.placements}")
            key = (t.device_mesh, tuple(p.is_shard() for p in t.placements))
        norm = torch.linalg.vector_norm(local_tensor(t), dtype=torch.float32)
        groups.setdefault(key, []).append(norm)
    total = None
    for key, norms in groups.items():
        sq = torch.stack(norms).square().sum()
        if key:
            dmesh, sharded = key
            for dim, is_shard in enumerate(sharded):
                if is_shard:
                    dist.all_reduce(sq, group=dmesh.get_group(dim))
        total = sq if total is None else total + sq
    return total
