"""Carrying weights between the JAX package's flax trees and the port's modules.

A model family declares its layout as rows ``(flax path, torch name,
transform)``; ``load_tree`` and ``dump_tree`` move numpy arrays across by
those rows, and ``parallel.mesh`` reads the same rows to match sharding rules
against the flax paths. The transforms, flax layout -> torch layout:

- ``"same"``: as is;
- ``"t"``: a dense kernel ``[in, out]`` -> a ``Linear`` weight ``[out, in]``;
- ``("heads", hd)``: a ``DenseGeneral`` kernel ``[D, H, hd]`` -> a ``Linear``
  weight ``[H*hd, D]``;
- ``("heads_bias", hd)``: its bias ``[H, hd]`` -> ``[H*hd]``;
- ``("heads_out", hd)``: an output projection's kernel ``[H, hd, D]`` -> a
  ``Linear`` weight ``[D, H*hd]``;
- ``"conv"``: a conv kernel HWIO -> OIHW;
- ``"scalar"``: a 0-dim parameter -> ``[1]`` (FSDP2 shards no 0-dim tensor).
"""

from __future__ import annotations

from typing import Iterable

import numpy as np
import torch
from torch.distributed.tensor import DTensor

Row = tuple[tuple[str, ...], str, object]


#: kind -> (the torch dims in the order the flax layout reads them, the place
#: in that order of the fused heads dim that flax splits as [H, hd], or None)
_KINDS = {"t": ((1, 0), None), "conv": ((2, 3, 1, 0), None), "heads": ((1, 0), 1), "heads_bias": ((0,), 0),
          "heads_out": ((1, 0), 0)}


def flax_view(shape, how) -> tuple[tuple[int, ...], tuple[int, ...], tuple[int | None, ...]]:
    """How a torch tensor of ``shape`` lies in the flax layout under the
    transform ``how``: the permutation of its dims the flax layout reads them
    in, the flax shape, and for each flax dim the torch dim it is (None: the
    ``hd`` half of a split heads dim). The one definition of the transforms:
    ``flax_to_torch``, ``torch_to_flax`` and ``parallel.mesh`` read it."""
    kind, hd = (how[0], int(how[1])) if isinstance(how, tuple) else (how, None)
    shape = tuple(int(n) for n in shape)
    if kind == "scalar":
        return (0,), (), ()
    if kind == "same":
        perm, split = tuple(range(len(shape))), None
    elif kind in _KINDS:
        perm, split = _KINDS[kind]
    else:
        raise ValueError(f"unknown layout transform {how!r}")
    flax, dims = [shape[p] for p in perm], list(perm)
    if split is not None:
        flax[split:split + 1] = [flax[split] // hd, hd]
        dims[split:split + 1] = [perm[split], None]
    return perm, tuple(flax), tuple(dims)


def torch_shape(flax_shape, how) -> tuple[int, ...]:
    """The torch shape whose flax view under ``how`` has ``flax_shape``: the
    inverse of ``flax_view``'s shape."""
    kind = how[0] if isinstance(how, tuple) else how
    if kind == "scalar":
        return (1,)
    perm, split = ((tuple(range(len(flax_shape))), None) if kind == "same" else _KINDS[kind])
    shape = [int(n) for n in flax_shape]
    if split is not None:
        shape[split:split + 2] = [shape[split] * shape[split + 1]]
    out = [0] * len(perm)
    for i, p in enumerate(perm):
        out[p] = shape[i]
    return tuple(out)


def _permute(arr, perm):
    return arr.permute(*perm) if isinstance(arr, torch.Tensor) else arr.transpose(perm)


def flax_to_torch(arr, how, shape):
    """``arr`` (a numpy array or a tensor) in the flax layout as the torch
    tensor of ``shape``; for a tensor a view where torch can make one."""
    perm, flax, _ = flax_view(shape, how)
    if tuple(arr.shape) != flax:
        raise ValueError(f"flax shape {tuple(arr.shape)} does not fit torch {tuple(shape)} under {how!r}")
    return _permute(arr.reshape([shape[p] for p in perm]), tuple(int(i) for i in np.argsort(perm)))


def torch_to_flax(arr, how):
    """``arr`` (a numpy array or a tensor) in the flax layout under ``how``;
    for a tensor a view where torch can make one, through which autograd
    reaches ``arr``."""
    perm, flax, _ = flax_view(arr.shape, how)
    return _permute(arr, perm).reshape(flax)


@torch.no_grad()
def load_tree(tree: dict, rows: Iterable[Row], tensors: dict[str, torch.Tensor]) -> None:
    """Copy the leaves of ``tree`` (nested dicts of arrays) at the rows' flax
    paths into ``tensors`` by torch name; every tensor must be set. A DTensor
    (a sharded model) takes this rank's slice of its leaf."""
    left = dict(tensors)
    for path, name, how in rows:
        node = tree
        for key in path:
            node = node[key]
        dst = left.pop(name)
        try:
            arr = flax_to_torch(np.asarray(node, np.float32), how, dst.shape)
        except ValueError as exc:
            raise ValueError(f"{'/'.join(path)} -> {name}: {exc}") from None
        if isinstance(dst, DTensor):
            from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

            shape, offset = compute_local_shape_and_global_offset(dst.shape, dst.device_mesh, dst.placements)
            arr = arr[tuple(slice(o, o + n) for o, n in zip(offset, shape))]
            dst = dst.to_local()
        dst.copy_(torch.from_numpy(np.array(arr, np.float32, order="C")))
    if left:
        raise ValueError(f"flax tree left tensors unset: {sorted(left)}")


@torch.no_grad()
def dump_tree(rows: Iterable[Row], tensors: dict[str, torch.Tensor]) -> dict:
    """The inverse of ``load_tree``: a nested dict of float32 numpy arrays
    (copies) in the flax layout. DTensors are gathered to full tensors, a
    collective: every rank takes them in the same order."""
    tree: dict = {}
    for path, name, how in rows:
        t = tensors[name].detach()
        if isinstance(t, DTensor):
            t = t.full_tensor()
        arr = torch_to_flax(t.float().cpu().numpy(), how)
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.array(arr, np.float32, order="C")
    return tree
