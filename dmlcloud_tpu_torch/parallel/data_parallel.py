"""Data parallelism over the process group: the reference's
``register_model(..., sharding="replicate")``.

In the JAX package a replicated model's parameters live on every device of
the mesh's ``data`` axis, the batch is the global batch assembled from every
process's local data, and XLA averages the gradients with a psum. Here each
process holds the whole model and feeds its own per-rank batch; two
collectives keep the replicas equal:

- ``broadcast_parameters(module)``, once at registration: rank 0's parameters
  and buffers overwrite every other rank's, so all ranks start equal whatever
  their local initialisation;
- ``all_reduce_gradients(params)``, once per optimizer step, after the
  backward (and the microbatch divide) and before the clip: every gradient
  becomes the mean over the ranks. With equal per-rank batches that is the
  gradient of the mean loss over the global batch, the reference's gradient.

Both pack their tensors into fixed-size buckets (one collective per bucket),
so the number of collectives per step does not grow with the number of
parameters and no bucket buffer is larger than ``BUCKET_BYTES``.

Why not ``torch.nn.parallel.DistributedDataParallel``: it renames every
parameter to ``module.*``, which breaks the checkpoint keys, the EMA shadow's
names and the weight bridges; its ``no_sync`` accumulation does not fit the
stage's fp32 accumulators for low-precision parameters (which set
``p.grad = None`` after each microbatch); and its overlap of the reduction
with the backward (bucket hooks) is left for later, for the 1b model across
cards.
"""

from __future__ import annotations

from typing import Callable, Iterable, Iterator

import torch
import torch.distributed as dist

from .tensor_parallel import local_tensor

__all__ = ["BUCKET_BYTES", "all_reduce_gradients", "broadcast_parameters", "reduce_gradient_buckets",
           "broadcast_buckets"]

#: bytes of one bucket buffer: one collective per bucket
BUCKET_BYTES = 64 * 2**20


def _group_world(group) -> int:
    return dist.get_world_size(group) if dist.is_available() and dist.is_initialized() else 1


def _spans(sizes: list[int], bucket_numel: int) -> Iterator[list[tuple[int, int, int]]]:
    """Consecutive ``bucket_numel``-element slices of the tensors' flattened
    concatenation, as lists of ``(tensor index, start, stop)``; a tensor may
    straddle buckets."""
    bucket, room = [], bucket_numel
    for i, n in enumerate(sizes):
        start = 0
        while start < n:
            take = min(n - start, room)
            bucket.append((i, start, start + take))
            start, room = start + take, room - take
            if room == 0:
                yield bucket
                bucket, room = [], bucket_numel
    if bucket:
        yield bucket


@torch.no_grad()
def _bucketed(tensors: list[torch.Tensor], dtype: torch.dtype, collective: Callable[[torch.Tensor], None],
              bucket_bytes: int) -> None:
    """Run ``collective`` in place on ``tensors`` (contiguous, on one device),
    bucket by bucket: each bucket is packed into one buffer of ``dtype``,
    reduced or broadcast, and unpacked back, cast to each tensor's dtype."""
    if not tensors:
        return
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("data-parallel collectives need contiguous parameters and gradients")
    numel = max(bucket_bytes // torch.empty((), dtype=dtype).element_size(), 1)
    flat = [t.view(-1) for t in tensors]
    buf = torch.empty(min(numel, sum(t.numel() for t in flat)), dtype=dtype, device=flat[0].device)
    for spans in _spans([t.numel() for t in flat], numel):
        offsets, used = [], 0
        for i, start, stop in spans:
            buf[used : used + stop - start].copy_(flat[i][start:stop])
            offsets.append(used)
            used += stop - start
        collective(buf[:used])
        for (i, start, stop), off in zip(spans, offsets):
            flat[i][start:stop].copy_(buf[off : off + stop - start])


def reduce_gradient_buckets(grads: list[torch.Tensor], world: int, group=None) -> None:
    """The bucket path of ``all_reduce_gradients``: each gradient replaced in
    place by its mean over the ``world`` ranks of ``group``, summed in fp32
    buckets (``all_reduce(SUM)``, then a divide: gloo has no ``AVG``)."""

    def mean(buf: torch.Tensor) -> None:
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
        buf.div_(world)

    _bucketed(grads, torch.float32, mean, BUCKET_BYTES)


@torch.no_grad()
def all_reduce_gradients(params: Iterable[torch.nn.Parameter], group=None) -> None:
    """Average the gradients of ``params`` over the ranks of ``group`` (the
    default process group), in place, without a host sync. A parameter whose
    ``grad`` is None contributes zeros and gets the mean, so every rank packs
    the same layout and ends with the same gradients; parameters that need no
    gradient are left out on every rank. At world size 1 it does nothing.

    On a mesh whose ``model`` axis splits the parameters (``parallel.mesh``),
    ``group`` is the data-parallel sub-group and the gradients are DTensors:
    each rank averages its local shards with the ranks that hold the same
    shards."""
    world = _group_world(group)
    if world <= 1:
        return
    params = [p for p in params if p.requires_grad]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    reduce_gradient_buckets([local_tensor(p.grad) for p in params], world, group)


def broadcast_buckets(tensors: list[torch.Tensor], src: int = 0, group=None) -> None:
    """The bucket path of ``broadcast_parameters``: ``tensors`` overwritten in
    place by rank ``src``'s, one ``broadcast`` per bucket of each dtype."""
    by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for dtype, same in by_dtype.items():
        _bucketed(same, dtype, lambda buf: dist.broadcast(buf, src=src, group=group), BUCKET_BYTES)


def broadcast_parameters(module: torch.nn.Module, src: int = 0, group=None) -> None:
    """Overwrite ``module``'s parameters and buffers with rank ``src``'s, so
    every replica starts equal. At world size 1 it does nothing."""
    if _group_world(group) <= 1:
        return
    tensors = [t.data for t in module.parameters()] + [b for b in module.buffers()]
    broadcast_buckets(tensors, src, group)
