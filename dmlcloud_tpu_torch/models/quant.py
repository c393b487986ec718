"""Weight-only int8 quantization, for decode and for training.

Counterpart of ``dmlcloud_tpu/models/quant.py``: ``QUANT_AMAX_KEY`` (:75),
``QuantizedTensor`` (:78), ``_fused_quant_dot`` (:99), ``QuantTrainTensor``
(:137), ``quant_train_dot`` (:157, a ``torch.autograd.Function`` here),
``amax_tree`` (:216), ``wrap_train_tree`` (:239), ``_fusible`` (:261),
``widen_quant_tree`` (:269), ``prepare_decode_params`` (:293), ``QuantDense``
and ``QuantDenseGeneral`` (:315/:342), ``quantize`` (:380), ``quantize_tree``
(:400), ``dequant_tree`` (:413) and ``quantized_size`` (:439).

Weight-only: activations stay in the compute dtype. ``w ~= q * scale`` with
int8 ``q`` and per-output-channel fp32 ``scale``, both in the reference's
layout over the FLAX kernel: ``q`` ``[in, *out]`` and ``scale`` keepdims
``[1, *out]`` (``[1, out]`` for ``o_proj``, the MLP and ``lm_head``, ``[1, H,
hd]`` for q/k/v). A model's weights are seen through its layout rows
(``models/lora.py`` ``_paths``, ``bridge.torch_to_flax``), so the port
quantizes the same leaves as the reference with the same bytes, and a
reference quantized tree loads into the port and dumps back unchanged
(``transformer.load_flax_params``/``to_flax_params``).

The tree functions take a model and return one: ``quantize_tree`` returns a
copy whose matched weights are ``QuantizedTensor`` modules (its other tensors
shared with the original), which ``generate``, ``beam_search``,
``decode_step`` and ``ServeEngine`` run as the reference runs an int8 tree.

The int8 dot (``_fused_quant_dot``) widens ``q`` exactly (int8 is exact in
bf16 and fp32) and multiplies in an fp32 accumulator; the per-channel scale
multiplies the fp32 result, then it is cast to the compute dtype. The operand
dtype follows the reference's rule by backend: on the accelerator (CUDA
here) the compute dtype, through cuBLAS's bf16 x bf16 -> fp32 GEMM
(``aten::mm.dtype``, which raises if missing: no silent fallback to a bf16
result rounded before the scale); elsewhere fp32 operands, as the
reference's off-TPU branch, which keeps the CPU bit-close to it. fp32 GEMMs
run without TF32 (torch's default, which the port keeps).

**Quantized training**: ``TrainValStage(precision="int8")`` seeds a delayed
per-channel amax from the initial weights (``amax_tree``), keeps it as a
persistent ``quant_amax`` buffer of each matched ``QuantDense`` (so it rides
the checkpoint's ``"extras"``), quantizes inside the train forward with
``scale = amax / 127`` (1.0 for a zero channel) through ``quant_train_dot``
(int8 forward and input-gradient GEMMs, straight-through fp32 weight
gradient), and refreshes the amax from the post-update weights. The
optimizer, the EMA and checkpoints see plain fp32 parameters; validation runs
at full precision.

**On a mesh** the weights are DTensors (``parallel.mesh.shard_module``: FSDP2
over ``fsdp``, tensor parallelism over ``model``). A per-channel amax reduces
over the flax kernel's input axis, which ``fsdp`` splits, and ``model`` splits
for the row-parallel layers (``o_proj``, ``down_proj``): a shard's own amax
would be the wrong scale. So each rank's amax goes into the full vector of
output channels, max-reduced over every mesh dim that splits the weight
(``_weight_amax``): every rank holds the reference's full per-channel amax.
``quantize_tree`` quantizes each rank's shard with it and keeps ``q`` and
``scale`` as DTensors laid out as the weight (in flax dims), so the tree dumps
to the reference's bytes and a reference tree loads into a sharded model. The
int8 dot multiplies a tensor-parallel layer's shard and gathers any other
split first. The delayed amax of quantized training is the full vector, a
replicated buffer; a tensor-parallel layer scales by its own channels' part.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..parallel.tensor_parallel import local_tensor
from .bridge import flax_to_torch, flax_view, torch_shape, torch_to_flax
from .lora import _as_matcher, _paths, _weight, default_match

__all__ = [
    "QuantizedTensor",
    "QuantTrainTensor",
    "QuantDense",
    "QuantDenseGeneral",
    "quantize",
    "quantize_tree",
    "dequant_tree",
    "widen_quant_tree",
    "prepare_decode_params",
    "quantized_size",
    "quant_train_dot",
    "amax_tree",
    "wrap_train_tree",
    "QUANT_AMAX_KEY",
]

#: the buffer of each quantized-training layer that holds its delayed amax
#: (``TrainValStage(precision="int8")``; the reference's extras key)
QUANT_AMAX_KEY = "quant_amax"


class QuantizedTensor(nn.Module):
    """``w ~= q * scale`` with int8 ``q`` and broadcast-ready fp32 ``scale``,
    in the flax kernel's layout. A module holding the two as buffers, so a
    quantized model moves, saves and counts its memory as usual; it takes the
    place of the weight it quantizes (``layer.weight``)."""

    def __init__(self, q: torch.Tensor, scale: torch.Tensor):
        super().__init__()
        self.register_buffer("q", q)
        self.register_buffer("scale", scale)

    @property
    def shape(self) -> torch.Size:
        return self.q.shape

    @property
    def ndim(self) -> int:
        return self.q.dim()

    @property
    def device(self) -> torch.device:
        return self.q.device

    def dequant(self, dtype=torch.bfloat16) -> torch.Tensor:
        # the fp32 multiply keeps the scale exact; the cast comes last
        return (self.q.float() * self.scale).to(dtype)


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (2-D, one operand dtype) accumulated in fp32 with an fp32
    result: an fp32 GEMM, or on CUDA the bf16/fp16 GEMM with fp32 output.
    Raises rather than round the result to the operand dtype."""
    if a.dtype == torch.float32:
        return a @ b
    if a.device.type != "cuda":
        raise RuntimeError(f"an int8 GEMM with {a.dtype} operands runs on CUDA only (on {a.device}: fp32 operands)")
    try:
        return torch.mm(a, b, out_dtype=torch.float32)
    except (TypeError, NotImplementedError, RuntimeError) as exc:
        raise RuntimeError(f"the {a.dtype} x {b.dtype} -> float32 GEMM (aten::mm.dtype) is unavailable; the int8 path "
                           "needs its fp32 result before the scale") from exc


def _operand_dtype(q_dtype: torch.dtype, dtype: torch.dtype, device: torch.device) -> torch.dtype:
    """The reference's operand rule: a pre-widened ``q``'s own dtype; else the
    compute dtype on the accelerator and fp32 elsewhere."""
    if q_dtype.is_floating_point:
        return q_dtype
    return dtype if device.type == "cuda" else torch.promote_types(torch.float32, dtype)


def _forward_local(t: torch.Tensor) -> torch.Tensor:
    """What a layer multiplies by of a ``QuantizedTensor`` buffer: a plain
    tensor as it is; of a DTensor, this rank's ``model`` shard with every
    other split gathered."""
    if not isinstance(t, DTensor):
        return t
    names = t.device_mesh.mesh_dim_names or ()
    keep = [p if i < len(names) and names[i] == "model" else Replicate() for i, p in enumerate(t.placements)]
    if keep != list(t.placements):
        t = t.redistribute(t.device_mesh, keep)
    return t.to_local()


def _fused_quant_dot(x: torch.Tensor, qt: QuantizedTensor, dtype: torch.dtype) -> torch.Tensor:
    """``x @ dequant(qt)`` without a dequantized weight: ``q`` widened to the
    operand dtype, an fp32 accumulator, the per-channel scale on the fp32
    result. Contracts ``x``'s last axis with ``q``'s first and returns
    ``[..., *out]`` in ``dtype``; needs ``_fusible(qt)``."""
    q, scale = _forward_local(qt.q), _forward_local(qt.scale)
    op = _operand_dtype(q.dtype, dtype, x.device)
    acc = _mm_f32(x.reshape(-1, x.shape[-1]).to(op), q.reshape(q.shape[0], -1).to(op))
    return (acc * scale.reshape(1, -1)).to(dtype).reshape(*x.shape[:-1], *q.shape[1:])


def _dequant_dot(x: torch.Tensor, qt: QuantizedTensor, dtype: torch.dtype) -> torch.Tensor:
    """The unfusible layouts' path: a local dequantization, then the dot."""
    w = (_forward_local(qt.q).float() * _forward_local(qt.scale)).to(dtype)
    return (x.to(dtype) @ w.reshape(w.shape[0], -1)).reshape(*x.shape[:-1], *w.shape[1:])


@dataclass
class QuantTrainTensor:
    """Quantized-training view of one weight: the fp32 master ``w`` (flax
    layout) and its delayed per-output-channel ``scale`` (keepdims, as
    ``QuantizedTensor``'s)."""

    w: torch.Tensor
    scale: torch.Tensor


def _train_op_dtype(x: torch.Tensor) -> torch.dtype:
    return x.dtype if x.device.type == "cuda" else torch.promote_types(torch.float32, x.dtype)


class _QuantTrainDot(torch.autograd.Function):
    """``quant_train_dot``'s forward and backward (its docstring)."""

    @staticmethod
    def forward(ctx, x, w, scale):
        q = torch.clamp(torch.round(w.float() / scale), -127, 127).to(torch.int8)
        op = _train_op_dtype(x)
        acc = _mm_f32(x.reshape(-1, x.shape[-1]).to(op), q.reshape(q.shape[0], -1).to(op))
        y = (acc * scale.reshape(1, -1)).to(x.dtype).reshape(*x.shape[:-1], *q.shape[1:])
        # the backward keeps q at 1 byte per element, not a second fp32 weight
        ctx.save_for_backward(x, q, scale)
        ctx.w_dtype = w.dtype
        return y

    @staticmethod
    def backward(ctx, g):
        x, q, scale = ctx.saved_tensors
        op = _train_op_dtype(x)
        g2 = g.reshape(-1, math.prod(q.shape[1:])).float()
        q2 = q.reshape(q.shape[0], -1)
        dx = _mm_f32((g2 * scale.reshape(1, -1)).to(op), q2.t().to(op)).to(x.dtype).reshape(x.shape)
        # dw = x^T g, computed as (g^T x)^T: the transpose is a view whose
        # strides are the torch weight's [out, in], so the gradient lands in
        # the parameter without a copy
        dw = (g2.t() @ x.reshape(-1, x.shape[-1]).float()).t().reshape(q.shape).to(ctx.w_dtype)
        return dx, dw, torch.zeros_like(scale)


def quant_train_dot(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``x @ fake_quant(w)`` with int8 GEMMs on the forward and the
    input-gradient path and a straight-through fp32 weight gradient.

    - forward: ``q = clip(round(w / scale))`` int8 feeds the dot
      (``_fused_quant_dot``'s operand rule), ``scale`` multiplies the fp32
      accumulator;
    - ``dx = (g * scale) @ q^T`` on the same int8 kernel;
    - ``dw = x^T @ g`` in fp32 (the quantizer differentiates as identity) and
      ``dscale = 0``: the scale is training state, not a parameter.

    ``w`` is the flax kernel ``[in, *out]`` (a view of the port's weight),
    ``scale`` ``[1, *out]``; contracts ``x``'s last axis with ``w``'s first."""
    return _QuantTrainDot.apply(x, w, scale)


def _delayed_scale(amax: torch.Tensor) -> torch.Tensor:
    return torch.where(amax > 0, amax / 127.0, 1.0)


@torch.no_grad()
def _amax(w: torch.Tensor) -> torch.Tensor:
    """Per-output-channel ``max|w|`` over the flax kernel's first axis, keepdims."""
    return w.float().abs().amax(dim=tuple(range(min(1, w.dim() - 1))), keepdim=True)


def _local_rows(w: DTensor) -> tuple[int, int]:
    """(first row, rows) of this rank's shard of a 2-D DTensor weight."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    shape, offset = compute_local_shape_and_global_offset(w.shape, w.device_mesh, w.placements)
    return int(offset[0]), int(shape[0])


def _check_linear(how) -> None:
    """A sharded weight is quantized as an ``nn.Linear`` (``[out, in]``) kernel."""
    if (how[0] if isinstance(how, tuple) else how) not in ("t", "heads"):
        raise ValueError(f"a sharded weight is quantized as an [out, in] dense kernel, not under {how!r}")


@torch.no_grad()
def _weight_amax(w: torch.Tensor, how) -> torch.Tensor:
    """``_amax`` of the whole weight ``w`` (flax keepdims layout), also when
    ``w`` is a DTensor: the shard's per-row amax, placed in the full vector of
    output rows and max-reduced over each mesh dim that splits ``w``."""
    if not isinstance(w, DTensor):
        return _amax(torch_to_flax(w, how))
    import torch.distributed as dist

    _check_linear(how)
    first, rows = _local_rows(w)
    full = torch.zeros(w.shape[0], dtype=torch.float32, device=w.device)
    local = w.to_local()
    if local.numel():
        full[first:first + rows] = local.float().abs().amax(dim=1)
    for i, p in enumerate(w.placements):
        if p.is_shard():
            dist.all_reduce(full, op=dist.ReduceOp.MAX, group=w.device_mesh.get_group(i))
    return full.reshape(1, *flax_view(w.shape, how)[1][1:])


def _local_channels(full: torch.Tensor, w: torch.Tensor, how) -> torch.Tensor:
    """The part of a full flax-keepdims amax or scale that goes with this
    rank's shard of the weight ``w``: its output rows when ``w`` is a DTensor
    split on its rows (dim 0), else all of it."""
    if not isinstance(w, DTensor) or not any(p.is_shard(0) for p in w.placements):
        return full
    first, rows = _local_rows(w)
    local_shape = flax_view((rows, w.shape[1]), how)[1]
    return full.reshape(-1)[first:first + rows].reshape(1, *local_shape[1:])


def _flax_placements(w: DTensor, how, scale: bool = False) -> list:
    """The placements of ``w``'s mesh over the flax view of ``w`` (or over
    its keepdims scale, which only a split of the output rows splits)."""
    dims = flax_view(w.shape, how)[2]
    out = []
    for p in w.placements:
        if not p.is_shard() or (scale and p.dim != 0):
            out.append(Replicate())
        else:
            out.append(Shard(dims.index(p.dim)))
    return out


def _sharded_quant(q: torch.Tensor, scale: torch.Tensor, w: DTensor, how) -> QuantizedTensor:
    """A ``QuantizedTensor`` of this rank's ``q`` and ``scale`` (flax layout)
    as DTensors laid out as the weight ``w``."""
    flax_shape = flax_view(w.shape, how)[1]
    as_dt = lambda t, pl, shape: DTensor.from_local(t, w.device_mesh, pl, run_check=False, shape=torch.Size(shape),
                                                    stride=torch.empty(shape, device="meta").stride())
    return QuantizedTensor(as_dt(q, _flax_placements(w, how), flax_shape),
                           as_dt(scale, _flax_placements(w, how, scale=True), (1, *flax_shape[1:])))


def amax_tree(model: nn.Module, match: Callable[[str, Any], bool] | None = None) -> dict[str, torch.Tensor]:
    """Per-output-channel ``max|w|`` of every matched weight, by flax path, in
    the flax keepdims layout: the delayed-scale state of
    ``TrainValStage(precision="int8")``. Unmatched weights are left out (the
    reference keeps 0-d placeholders to hold its tree's structure). Default
    match: ``lora.default_match`` (matrix-shaped kernels)."""
    matcher = match or default_match
    out = {}
    for path, (name, how) in _paths(model).items():
        w = _weight(model, name)
        if matcher(path, torch_to_flax(local_tensor(w), how)):
            out[path] = _weight_amax(w, how)
    return out


def wrap_train_tree(model: nn.Module, amax: dict[str, torch.Tensor],
                    match: Callable[[str, Any], bool] | None = None) -> dict[str, QuantTrainTensor]:
    """Every matched weight as a ``QuantTrainTensor`` (by flax path): the
    weight's flax view, through which gradients reach it, and the delayed
    scale ``amax / 127`` (1.0 for all-zero channels, as ``quantize``). The
    stage's layers build the same pair inside the forward (``QuantDense``)."""
    matcher = match or default_match
    out = {}
    for path, (name, how) in _paths(model).items():
        leaf = torch_to_flax(local_tensor(_weight(model, name)), how)
        if matcher(path, leaf):
            out[path] = QuantTrainTensor(w=leaf, scale=_delayed_scale(amax[path]).detach())
    return out


def _fusible(qt: QuantizedTensor) -> bool:
    """Whether the fused path applies: per-output-channel scales reduced over
    exactly the first (contracted) axis."""
    return qt.scale.shape[0] == 1 and qt.scale.numel() == math.prod(qt.q.shape[1:])


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------

def _structural_copy(module: nn.Module) -> nn.Module:
    """A copy of ``module``'s tree of submodules that shares every tensor, so
    that replacing a weight of the copy leaves the original as it was."""
    new = object.__new__(module.__class__)  # past FSDP2's __new__, which would construct one
    new.__dict__.update(module.__dict__)
    new._parameters = dict(module._parameters)
    new._buffers = dict(module._buffers)
    new._non_persistent_buffers_set = set(module._non_persistent_buffers_set)
    new._modules = {k: None if m is None else _structural_copy(m) for k, m in module._modules.items()}
    return new


def _put(model: nn.Module, name: str, value) -> None:
    """Set the module attribute ``name`` (dotted) of ``model`` to ``value``:
    a ``QuantizedTensor`` (a submodule) or a tensor (a parameter)."""
    owner, _, attr = name.rpartition(".")
    module = model.get_submodule(owner)
    for table in (module._parameters, module._buffers, module._modules):
        table.pop(attr, None)
    if isinstance(value, nn.Module):
        module.add_module(attr, value)
    else:
        module.register_parameter(attr, value if isinstance(value, nn.Parameter)
                                  else nn.Parameter(value, requires_grad=False))


def _map_weights(model: nn.Module, fn) -> nn.Module:
    """``model`` with each weight ``w`` at flax path ``path`` replaced by
    ``fn(path, name, how, w)`` where that returns something other than None:
    a structural copy, or ``model`` itself when nothing changes."""
    changes = {}
    for path, (name, how) in _paths(model).items():
        new = fn(path, name, how, _weight(model, name))
        if new is not None:
            changes[name] = new
    if not changes:
        return model
    out = _structural_copy(model)
    for name, value in changes.items():
        _put(out, name, value)
    return out


def quantize(w: torch.Tensor, *, num_input_axes: int = 1) -> QuantizedTensor:
    """Symmetric per-output-channel int8 quantization of ``w`` (a flax-layout
    kernel): the amax is reduced over the leading ``num_input_axes`` axes, so
    every trailing output coordinate keeps its own scale; ``round`` is
    half-to-even, as ``jnp.round``."""
    w32 = torch.as_tensor(w).float()
    reduce_axes = tuple(range(min(num_input_axes, w32.dim() - 1)))
    amax = w32.abs().amax(dim=reduce_axes, keepdim=True) if reduce_axes else w32.abs()
    scale = torch.where(amax > 0, amax / 127.0, 1.0)
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return QuantizedTensor(q=q, scale=scale)


@torch.no_grad()
def quantize_tree(model: nn.Module, match: Callable[[str, Any], bool] | str | None = None) -> nn.Module:
    """A copy of ``model`` with every matched weight quantized (``quantize``
    of its flax view) in place of the weight; it drops into ``generate`` /
    ``beam_search`` directly. Default match: matrix-shaped kernels
    (``lora.default_match``: embeddings, biases and norm scales stay full
    precision)."""
    matcher = _as_matcher(match)

    def quant(path, name, how, w):
        if isinstance(w, QuantizedTensor):
            return None
        if not isinstance(w, DTensor):
            leaf = torch_to_flax(w, how)
            return quantize(leaf) if matcher(path, leaf) else None
        # each rank's shard, with the full per-channel scale (module docstring)
        leaf = torch_to_flax(w.to_local(), how)
        if not matcher(path, leaf):
            return None
        amax = _weight_amax(w, how)
        scale = _local_channels(torch.where(amax > 0, amax / 127.0, 1.0), w, how)
        q = torch.clamp(torch.round(leaf.float() / scale), -127, 127).to(torch.int8)
        return _sharded_quant(q, scale, w, how)

    return _map_weights(model, quant)


@torch.no_grad()
def dequant_tree(model: nn.Module, dtype=torch.bfloat16, keep: Callable[[str], bool] | None = None) -> nn.Module:
    """``model`` with its quantized weights rehydrated to ``dtype`` (frozen
    parameters in the port's layout); ``keep`` (flax path -> bool) leaves the
    matching ones quantized: the decode paths keep the ``kernel``s for the
    int8 dense layers and rehydrate any other quantized leaf (an embedding a
    custom matcher quantized) for its quant-unaware consumer. ``model``
    itself when nothing is quantized."""

    def rehydrate(path, name, how, w):
        if not isinstance(w, QuantizedTensor) or (keep is not None and keep(path)):
            return None
        return flax_to_torch(w.dequant(dtype), how, torch_shape(w.shape, how)).contiguous()

    return _map_weights(model, rehydrate)


@torch.no_grad()
def widen_quant_tree(model: nn.Module, dtype=torch.float32) -> nn.Module:
    """``model`` with each fusible quantized weight's ``q`` widened to
    ``dtype`` (exact: int8 -> fp32 is lossless; the scales stay apart and
    still multiply the accumulator, so the arithmetic is the int8 path's bit
    for bit). The reference calls this inside its compiled decode program to
    hoist the per-step widen out of the loop; eager torch has no loop to
    hoist out of, so here it is the one-time widen ``prepare_decode_params``
    applies off the accelerator."""

    def widen(path, name, how, w):
        if isinstance(w, QuantizedTensor) and _fusible(w) and w.q.dtype != dtype:
            return QuantizedTensor(w.q.to(dtype), w.scale)
        return None

    return _map_weights(model, widen)


def _device(model: nn.Module) -> torch.device:
    for t in model.buffers():
        return t.device
    return next(model.parameters()).device


def prepare_decode_params(model: nn.Module, dtype=torch.bfloat16) -> nn.Module:
    """One-time preparation of a (possibly int8) model for repeated decode
    calls: non-kernel quantized weights rehydrate to ``dtype``; off the
    accelerator the fusible int8 kernels pre-widen to fp32, the GEMM's operand
    dtype there. On CUDA the kernels stay int8 (widened per call): fp32 copies
    would make the int8 weights larger than bf16 ones. ``model`` itself when
    it holds nothing quantized."""
    model = dequant_tree(model, dtype, keep=lambda p: p.endswith("kernel"))
    if _device(model).type == "cuda":
        return model
    return widen_quant_tree(model)


def quantized_size(model: nn.Module) -> tuple[int, int]:
    """(bytes_quantized, bytes_unquantized) of a bf16-deployed model: the
    per-token HBM weight traffic decode pays. Unquantized float weights count
    as bf16 (2 bytes) on both sides, whatever dtype they are stored in."""
    q_bytes = full_bytes = 0
    for name, _ in _paths(model).values():
        w = _weight(model, name)
        if isinstance(w, QuantizedTensor):
            q_bytes += w.q.numel() + w.scale.numel() * 4
            full_bytes += w.q.numel() * 2
        else:
            n = 2 if w.is_floating_point() else w.element_size()
            q_bytes += w.numel() * n
            full_bytes += w.numel() * n
    return q_bytes, full_bytes


# ---------------------------------------------------------------------------
# the dense layers
# ---------------------------------------------------------------------------

class QuantDense(nn.Linear):
    """A bias-free ``nn.Linear`` (fp32 weight ``[out, in]``, flax kernel
    ``[in, out]``: bridge transform ``"t"``) whose forward dispatches on its
    weight as the reference's ``QuantDense``:

    - a plain weight: ``F.linear`` on operands cast to ``dtype``, the result
      in ``dtype`` (flax ``Dense(dtype=...)``);
    - a ``QuantizedTensor``: ``_fused_quant_dot``, or a local dequantization
      when its scales are not per output channel (``_fusible``);
    - while ``quant_train`` is set (``TrainValStage(precision="int8")``):
      ``quant_train_dot`` on the weight's flax view with the delayed scale of
      the ``quant_amax`` buffer.

    The result is ``[..., out]``; under tensor parallelism the weight is a
    DTensor and the layer multiplies by its local shard."""

    def __init__(self, in_features: int, out_features: int, dtype: torch.dtype = torch.float32, device=None):
        super().__init__(in_features, out_features, bias=False, device=device, dtype=torch.float32)
        self.compute_dtype = dtype
        self.quant_train = False

    def _flax_how(self):
        return "t"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, dt = self.weight, self.compute_dtype
        if isinstance(w, QuantizedTensor):
            y = _fused_quant_dot(x, w, dt) if _fusible(w) else _dequant_dot(x, w, dt)
        elif self.quant_train:
            how = self._flax_how()
            amax = _local_channels(getattr(self, QUANT_AMAX_KEY), w, how)
            y = quant_train_dot(x.to(dt), torch_to_flax(local_tensor(w), how), _delayed_scale(amax))
        else:
            return F.linear(x.to(dt), local_tensor(w).to(dt))
        return y.reshape(*x.shape[:-1], -1)


class QuantDenseGeneral(QuantDense):
    """``QuantDense`` whose flax kernel splits its output as ``[in, heads,
    head_dim]`` (bridge transform ``("heads", head_dim)``): the q/k/v
    projections. Its output is ``[..., heads, head_dim]``, the local heads
    under tensor parallelism."""

    def __init__(self, in_features: int, features: tuple[int, int], dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__(in_features, features[0] * features[1], dtype=dtype, device=device)
        self.head_dim = int(features[1])

    def _flax_how(self):
        return ("heads", self.head_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x).reshape(*x.shape[:-1], -1, self.head_dim)


# ---------------------------------------------------------------------------
# reference trees in and out (transformer.load_flax_params / to_flax_params)
# ---------------------------------------------------------------------------

def _quant_leaf(leaf) -> tuple[np.ndarray, np.ndarray] | None:
    """``(q, scale)`` of a reference quantized leaf (an object with ``q`` and
    ``scale``, or a dict with those keys), else None."""
    if isinstance(leaf, dict):
        return (leaf["q"], leaf["scale"]) if set(leaf) == {"q", "scale"} else None
    if hasattr(leaf, "q") and hasattr(leaf, "scale"):
        return leaf.q, leaf.scale
    return None


@torch.no_grad()
def _load_quantized(model: nn.Module, tree: dict, rows: list) -> list:
    """Install the quantized leaves of ``tree`` into ``model`` (byte for
    byte, in the flax layout they came in), give a quantized weight whose leaf
    is a plain array back its parameter, and return the rows ``load_tree``
    fills."""
    plain = []
    for path, name, how in rows:
        node = tree
        for key in path:
            node = node[key]
        current = _weight(model, name)
        qs = _quant_leaf(node)
        if qs is not None:
            device = current.device
            q = torch.from_numpy(np.array(qs[0], np.int8)).to(device)
            scale = torch.from_numpy(np.array(qs[1], np.float32)).to(device)
            if isinstance(current, DTensor):
                # a sharded model: this rank's slice of q and of the scale
                from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

                _check_linear(how)
                local = []
                for t, pl in ((q, _flax_placements(current, how)), (scale, _flax_placements(current, how, True))):
                    shape, offset = compute_local_shape_and_global_offset(t.shape, current.device_mesh, pl)
                    local.append(t[tuple(slice(o, o + n) for o, n in zip(offset, shape))].contiguous())
                _put(model, name, _sharded_quant(*local, current, how))
            else:
                _put(model, name, QuantizedTensor(q, scale))
            continue
        if isinstance(current, QuantizedTensor):
            _put(model, name, nn.Parameter(torch.zeros(torch_shape(current.shape, how), device=current.device)))
        plain.append((path, name, how))
    return plain


def _dump_quantized(model: nn.Module, rows: list) -> tuple[dict, list]:
    """The quantized weights of ``model`` as ``{"q", "scale"}`` numpy leaves
    of a flax tree, and the rows ``dump_tree`` writes."""
    tree: dict = {}
    plain = []
    for path, name, how in rows:
        w = _weight(model, name)
        if not isinstance(w, QuantizedTensor):
            plain.append((path, name, how))
            continue
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        full = lambda t: t.full_tensor() if isinstance(t, DTensor) else t
        node[path[-1]] = {"q": full(w.q).to(torch.int8).cpu().numpy(), "scale": full(w.scale).float().cpu().numpy()}
    return tree, plain


# ---------------------------------------------------------------------------
# the stage's quantized training (TrainValStage(precision="int8"))
# ---------------------------------------------------------------------------

@torch.no_grad()
def _seed_quant_training(model: nn.Module, match: Callable[[str, Any], bool] | None = None) -> list[QuantDense]:
    """Give every matched weight's layer its delayed amax (``amax_tree`` of
    the current weights) as the persistent buffer ``quant_amax``, and return
    the layers. Each must be a ``QuantDense``: the layers that quantize."""
    paths = _paths(model)
    layers = []
    for path, amax in amax_tree(model, match).items():
        name, how = paths[path]
        owner, _, attr = name.rpartition(".")
        layer = model.get_submodule(owner)
        if attr != "weight" or not isinstance(layer, QuantDense) or layer._flax_how() != how:
            raise ValueError(f'precision="int8" quantizes dense layers: {path} ({name}) is not the weight of a '
                             "QuantDense (models/quant.py)")
        if hasattr(layer, QUANT_AMAX_KEY):
            getattr(layer, QUANT_AMAX_KEY).copy_(amax)
        else:
            layer.register_buffer(QUANT_AMAX_KEY, amax)
        layers.append(layer)
    return layers


@torch.no_grad()
def _refresh_amax(layers: list[QuantDense]) -> None:
    """Each layer's amax from its current (updated) weight."""
    for layer in layers:
        getattr(layer, QUANT_AMAX_KEY).copy_(_weight_amax(layer.weight, layer._flax_how()))
