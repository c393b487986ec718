"""Shape bucketing: bound the compiled-signature set under ragged batches.

Counterpart of ``dmlcloud_tpu/compile/buckets.py``. Every distinct batch shape
that reaches a compiled step is a full compilation (static shapes, one graph
per signature). Real data is ragged — a partial last batch every epoch,
variable sequence lengths — so without intervention the signature count grows
with the data, and each growth event is a mid-run compile stall. Bucketing
prevents it: pad the ragged dim up to the smallest member of a small, fixed
bucket set, so the step only ever sees ``len(buckets)`` signatures — all of
which the precompiler can compile before the loop.

Padding must not change the math. For mapping batches ``pad_to_bucket``
injects a ``sample_mask`` leaf (1.0 for real rows, 0.0 for padding); a step
that reduces its per-sample loss with :func:`masked_mean` (or counts with
:func:`masked_sum`) produces losses, metrics, AND gradients identical to the
unpadded batch — padded rows multiply everything they touch by zero.
Non-mapping batches are padded without a mask (there is nowhere to put one);
masking is then the step's own responsibility, and a one-time warning says so.

Leaves may be numpy arrays (host batches, before the device copy) or tensors;
the mask is a numpy array for a host batch and a tensor on the batch's device
for a batch of tensors.

On a mesh every process pads its own rows (``make_global_batch``'s local
batch): a bucket is a row count per process, so the global batch of a bucket
is that times the data-parallel size and divides over the data axes by
construction, which ``aot.validate_global_batch_spec`` checks at stage start
as the reference does. ``model``/``seq``/``expert`` peers feed the same rows,
so they pad to the same bucket and their collectives meet equal shapes.
"""

from __future__ import annotations

import dataclasses
import logging
import math
from typing import Any, Iterable, Iterator, Mapping, Sequence

import numpy as np
import torch
import torch.utils._pytree as pytree

from .aot import TensorSpec, abstract_spec

__all__ = [
    "DEFAULT_MASK_KEY",
    "bucket_for",
    "bucket_iterator",
    "bucket_spec",
    "masked_mean",
    "masked_sum",
    "pad_to_bucket",
    "resolve_buckets",
]

_logger = logging.getLogger("dmlcloud_tpu_torch")

DEFAULT_MASK_KEY = "sample_mask"


def resolve_buckets(buckets: Iterable[int]) -> tuple[int, ...]:
    """Normalise a bucket set: ints, deduplicated, ascending, all positive.
    Include your full batch size as the largest bucket — batches above it
    are an error, not a silent extra signature."""
    sizes = sorted({int(b) for b in buckets})
    if not sizes:
        raise ValueError("buckets must contain at least one size")
    if sizes[0] <= 0:
        raise ValueError(f"bucket sizes must be positive, got {sizes[0]}")
    return tuple(sizes)


def bucket_for(size: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= ``size``."""
    for b in buckets:
        if b >= size:
            return int(b)
    raise ValueError(
        f"batch size {size} exceeds the largest bucket {buckets[-1]}; include the "
        "full batch size in the bucket set"
    )


def _pad_leaf(x: Any, pad: int, axis: int):
    if pad == 0:
        return x
    ndim = getattr(x, "ndim", 0)
    if ndim <= axis:
        return x  # scalars / low-rank leaves carry no batch dim to pad
    if isinstance(x, torch.Tensor):
        shape = list(x.shape)
        shape[axis] = pad
        return torch.cat([x, x.new_zeros(shape)], dim=axis)
    widths = [(0, 0)] * ndim
    widths[axis] = (0, pad)
    return np.pad(np.asarray(x), widths)


def pad_to_bucket(
    batch: Any,
    buckets: Sequence[int],
    axis: int = 0,
    mask_key: str = DEFAULT_MASK_KEY,
) -> Any:
    """Pad ``batch``'s ``axis`` dim (zeros at the end) up to its bucket.

    Mapping batches come back as a dict with a float32 ``mask_key`` leaf of
    length ``bucket`` (1.0 real / 0.0 padded); a pre-existing ``mask_key``
    leaf is respected — padded with zeros like any other leaf, never
    overwritten (its padding rows are zero-weight either way). Other batch
    pytrees are padded in place with no mask."""
    leaves = pytree.tree_leaves(batch)
    sizes = {leaf.shape[axis] for leaf in leaves if getattr(leaf, "ndim", 0) > axis}
    if not sizes:
        return batch
    if len(sizes) > 1:
        raise ValueError(
            f"batch leaves disagree on the size of dim {axis} ({sorted(sizes)}); "
            "bucketing pads one consistent batch dim"
        )
    size = sizes.pop()
    bucket = bucket_for(size, buckets)
    pad = bucket - size
    padded = pytree.tree_map(lambda x: _pad_leaf(x, pad, axis), batch)
    if isinstance(batch, Mapping):
        padded = dict(padded)
        if mask_key not in padded:
            mask = np.zeros(bucket, np.float32)
            mask[:size] = 1.0
            tensor = next((x for x in leaves if isinstance(x, torch.Tensor)), None)
            padded[mask_key] = mask if tensor is None else torch.from_numpy(mask).to(tensor.device)
    return padded


def bucket_spec(spec: Any, bucket: int, axis: int = 0, mask_key: str = DEFAULT_MASK_KEY) -> Any:
    """The abstract (``TensorSpec``) batch a bucket produces: every batched
    leaf's ``axis`` dim set to ``bucket``, plus the mask leaf for mapping
    specs — what the precompiler warms, one per bucket."""

    def leaf(s):
        if not isinstance(s, TensorSpec):
            return s
        shape = list(s.shape)
        if len(shape) > axis:
            shape[axis] = int(bucket)
        return dataclasses.replace(s, shape=tuple(shape))

    out = pytree.tree_map(leaf, abstract_spec(spec))
    if isinstance(spec, Mapping):
        out = dict(out)
        if mask_key not in out:
            out[mask_key] = TensorSpec((int(bucket),), torch.float32)
    return out


def bucket_iterator(
    it: Iterable[Any],
    buckets: Iterable[int],
    axis: int = 0,
    mask_key: str = DEFAULT_MASK_KEY,
) -> Iterator[Any]:
    """Wrap a host-batch iterator so every yielded batch is bucket-padded
    (mapping batches gain the mask leaf). Sits BEFORE the device transfer in
    the feeding path, so the device only ever sees bucket shapes."""
    buckets = resolve_buckets(buckets)
    warned = False
    for batch in it:
        if not warned and not isinstance(batch, Mapping):
            warned = True
            _logger.warning(
                "bucketing a non-mapping batch (%s): rows are padded but no mask "
                "leaf can be injected — the step must zero-weight padded rows "
                "itself or the loss is diluted",
                type(batch).__name__,
            )
        yield pad_to_bucket(batch, buckets, axis=axis, mask_key=mask_key)


def _masked(values: Any, mask: Any) -> tuple[torch.Tensor, torch.Tensor, int]:
    """``values`` as a tensor, ``mask`` in its dtype broadcast over its
    trailing dims, and the mask's rank."""
    values = torch.as_tensor(values)
    mask = torch.as_tensor(mask, dtype=values.dtype, device=values.device)
    return values, mask.reshape(mask.shape + (1,) * (values.ndim - mask.ndim)), mask.ndim


def masked_mean(values: Any, mask: Any) -> torch.Tensor:
    """Mean of ``values`` over REAL rows only: ``values`` is ``[B, ...]``,
    ``mask`` is ``[B]`` (1.0 real / 0.0 padded). Padded rows contribute
    exactly zero to the value and to its gradients; the divisor is the real
    element count, so the result equals the plain mean of the unpadded
    batch."""
    values, mb, rank = _masked(values, mask)
    per_row = math.prod(values.shape[rank:]) if values.ndim > rank else 1
    denom = torch.clamp(mb.sum(), min=1.0) * per_row
    return torch.sum(values * mb) / denom


def masked_sum(values: Any, mask: Any) -> torch.Tensor:
    """Sum of ``values`` over real rows only (counters, token totals)."""
    values, mb, _ = _masked(values, mask)
    return torch.sum(values * mb)
