"""Tensor parallelism over a mesh's ``model`` axis: the collectives a sharded
forward needs, written as autograd functions (Megatron's ``f`` and ``g``).

The reference states tensor parallelism as data (partition rules) and lets
XLA insert the collectives. Here the model runs its projections on local
weight shards (``DecoderLM`` under ``mesh.shard_module``) and calls these
around them, so the same code path and the same attention kernels run on
``H / model`` heads:

- ``copy_to_model``: identity forward; the backward sums the gradient over
  the group (the input of a column-parallel projection, whose per-rank
  gradients are partial);
- ``reduce_from_model``: the forward sums the per-rank partial outputs of a
  row-parallel projection (in fp32, cast back); identity backward;
- ``gather_from_model``: the forward concatenates the per-rank slices along
  a dim (a feature-sharded embedding, vocab-parallel logits); the backward
  keeps this rank's slice of the gradient;
- ``scatter_to_model``: the forward keeps this rank's slice along a dim, the
  backward concatenates the per-rank gradients (the adjoint of the gather).

The last two also serve the ``seq`` axis: ring attention
(``ops.ring_attention``) slices each rank's block of the sequence out of
replicated activations and gathers its output back, so every ``seq`` peer
ends with the same activations and the same parameter gradients.

Each rank of the group ends a forward with the same replicated activations,
so every rank computes the same loss, and each backward rule above gives the
gradient of that one loss (not of the sum of the ranks' copies).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

__all__ = ["ModelGroup", "copy_to_model", "reduce_from_model", "gather_from_model", "scatter_to_model",
           "local_tensor"]


def local_tensor(t: torch.Tensor) -> torch.Tensor:
    """This rank's shard of a DTensor (autograd-aware), any other tensor as it is."""
    return t.to_local() if isinstance(t, DTensor) else t


@dataclass(frozen=True)
class ModelGroup:
    """The process group of a mesh's ``model`` axis (or of its ``seq`` axis,
    for ring attention), with this rank's place in it."""

    group: Any
    rank: int
    size: int


def _all_reduce_sum(x: torch.Tensor, tp: ModelGroup) -> torch.Tensor:
    out = x.float().contiguous() if x.dtype != torch.float32 else x.contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=tp.group)
    return out.to(x.dtype)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce_sum(grad, ctx.tp), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return _all_reduce_sum(x, tp)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim, ctx.width = tp, dim, x.shape[dim]
        parts = [torch.empty_like(x, memory_format=torch.contiguous_format) for _ in range(tp.size)]
        dist.all_gather(parts, x.contiguous(), group=tp.group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.tp.rank * ctx.width, ctx.width).contiguous(), None, None


class _ScatterToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim = tp, dim
        width = x.shape[dim] // tp.size
        return x.narrow(dim, tp.rank * width, width).contiguous()

    @staticmethod
    def backward(ctx, grad):
        return _GatherFromModel.apply(grad, ctx.tp, ctx.dim), None, None


def copy_to_model(x: torch.Tensor, tp: ModelGroup) -> torch.Tensor:
    return _CopyToModel.apply(x, tp)


def reduce_from_model(x: torch.Tensor, tp: ModelGroup) -> torch.Tensor:
    return _ReduceFromModel.apply(x, tp)


def gather_from_model(x: torch.Tensor, tp: ModelGroup, dim: int = -1) -> torch.Tensor:
    return _GatherFromModel.apply(x, tp, dim % x.dim())


def scatter_to_model(x: torch.Tensor, tp: ModelGroup, dim: int = -1) -> torch.Tensor:
    """This rank's slice of ``x`` along ``dim`` (which the group's size must
    divide); the backward gathers the slices' gradients."""
    dim = dim % x.dim()
    if x.shape[dim] % tp.size:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} is not divisible by the group's size {tp.size}")
    return _ScatterToModel.apply(x, tp, dim)
