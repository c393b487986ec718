"""Ring attention: sequence parallelism over a ``seq`` process group.

Counterpart of ``dmlcloud_tpu/ops/ring_attention.py``: ``_merge_partials``
(:53), ``ring_attention`` (:65), ``_ring_attention_windowed`` (:154) and
``ring_attention_sharded`` (:227). The reference runs inside ``shard_map``
over a ``seq`` mesh axis and rotates K/V with ``ppermute``; here each process
holds one block of the sequence and the rotation is point-to-point
(``batch_isend_irecv``) over the axis's process group, one process per device.

Each hop attends the local queries to the K/V block visiting this rank with
``ops.flash_attention.flash_lse`` (the hand-written kernels on a CUDA tensor,
their plain versions on a CPU tensor) and merges the normalized partials with
the fp32 blockwise combination of ``_merge_partials``. Under causal masking a
block strictly behind this rank runs with ``causal=False``, the diagonal block
causal, and a block ahead is skipped (its merge weight would be exp(-inf)):
plain Python control flow on this rank's index. With ``window`` the hop count
is static, ``min(n, max(1, (W-2)//Tl + 2))``, and hop ``s`` runs the kernels
with the shifted cutoff ``W - s*Tl`` (possibly zero or negative, which leaves
dead rows: output 0, lse about -1e30, merge weight 0).

The rotation moves K and V as ONE packed buffer, so every rank's backward
posts its sends and receives in the same order (NCCL ignores tags). The next
hop's exchange is posted before the current hop's kernels run and waited on
after them. A rank whose block is ahead still joins every exchange, forward
and backward: the blocks no kernel reads are tied into the output with a zero
gradient (``_Join``), so their rotations' backward runs on every rank.

``ring_attention_sharded`` takes q/k/v replicated over ``seq`` (full length,
as the reference's ``shard_map`` boundary gives them): each rank slices its
block with ``tensor_parallel.scatter_to_model`` (backward: an all-gather) and
gathers the output with ``gather_from_model`` (backward: a slice). So every
``seq`` peer ends with the same activations and the same gradients, and ``seq``
is not an axis the gradients are reduced over. The batch dim is not split:
each process already feeds its data-parallel rows.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.distributed as dist

from ..parallel.tensor_parallel import ModelGroup, gather_from_model, scatter_to_model
from .flash_attention import flash_lse

__all__ = ["ring_attention", "ring_attention_sharded", "seq_group"]

_NEG_INF = -1e30


def seq_group(mesh, axis_name: str = "seq") -> ModelGroup:
    """The ``axis_name`` process group of a ``DeviceMesh``, with this rank's
    place in it (the group ``ring_attention`` rotates over)."""
    if axis_name not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))} has no axis {axis_name!r}")
    return ModelGroup(mesh.get_group(axis_name), mesh.get_local_rank(axis_name), mesh.size(mesh.mesh_dim_names.index(
        axis_name)))


def _merge_partials(m, w, acc, out_b, lse_b):
    """Blockwise combination of normalized attention partials:
    out = sum_b exp(lse_b) out_b / sum_b exp(lse_b), carried with a running
    max for stability (the reference's one merge, in fp32)."""
    new_m = torch.maximum(m, lse_b)
    c_prev = torch.exp(m - new_m)
    c_new = torch.exp(lse_b - new_m)
    acc = acc * c_prev[..., None] + out_b.float() * c_new[..., None]
    return new_m, w * c_prev + c_new, acc


def _post(x: torch.Tensor, group: ModelGroup, backward: bool) -> tuple[list, torch.Tensor]:
    """Post one ring exchange of ``x``: forward sends to rank i+1 and receives
    from i-1, backward the other way. Returns the requests and the buffer."""
    n, i = group.size, group.rank
    to, frm = ((i - 1) % n, (i + 1) % n) if backward else ((i + 1) % n, (i - 1) % n)
    recv = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, dist.get_global_rank(group.group, to), group.group),
           dist.P2POp(dist.irecv, recv, dist.get_global_rank(group.group, frm), group.group)]
    return dist.batch_isend_irecv(ops), recv


class _Rotate(torch.autograd.Function):
    """The K/V block of the next hop: waits on the exchange ``_post`` started
    before this hop's kernels; the backward sends the gradient the other way
    round the ring."""

    @staticmethod
    def forward(ctx, x, group, pending):
        ctx.group = group
        reqs, recv = pending
        for req in reqs:
            req.wait()
        return recv

    @staticmethod
    def backward(ctx, grad):
        reqs, recv = _post(grad.contiguous(), ctx.group, backward=True)
        for req in reqs:
            req.wait()
        return recv, None, None


class _Join(torch.autograd.Function):
    """Identity on ``out``; gives the K/V blocks no kernel read on this rank a
    zero gradient, so that the rotations that brought them run their backward
    (and its exchange) on this rank as on every other."""

    @staticmethod
    def forward(ctx, out, *unread):
        ctx.shapes = [(u.shape, u.dtype, u.device) for u in unread]
        return out.view_as(out)

    @staticmethod
    def backward(ctx, grad):
        return (grad, *(torch.zeros(s, dtype=d, device=dev) for s, d, dev in ctx.shapes))


def _bth(lse: torch.Tensor, b: int, h: int, tl: int) -> torch.Tensor:
    """The kernels' lse ``[B*H, Tl]`` as ``[B, Tl, H]`` (the reference's ``to_bth``)."""
    return lse.reshape(b, h, tl).permute(0, 2, 1)


def _ring(q, k, v, group: ModelGroup | None, causal: bool, sm_scale: float | None, window: int | None):
    b, tl, h, d = q.shape
    n, idx = (1, 0) if group is None else (group.size, group.rank)
    scale = 1.0 / math.sqrt(d) if sm_scale is None else float(sm_scale)
    if window is None:
        hops = n
    else:
        # hop s >= 1 takes part iff its closest pair distance (s-1)*Tl + 1 is
        # still inside the window
        hops = min(n, max(1, (window - 2) // tl + 2))
    m = torch.full((b, tl, h), _NEG_INF, dtype=torch.float32, device=q.device)
    w = torch.zeros((b, tl, h), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, tl, h, d), dtype=torch.float32, device=q.device)
    kv = torch.stack([k, v])  # one buffer: one exchange per hop
    unread = []
    for step in range(hops):
        pending = _post(kv, group, backward=False) if step < hops - 1 else None
        src = (idx - step) % n  # the sequence block kv holds
        if window is not None:
            # hop 0: the diagonal (causal + window); hop s: the block s behind,
            # with the cutoff shifted into its local coordinates
            live = step == 0 or idx >= step
            kw = dict(causal=step == 0, window=window - step * tl)
        else:
            live = not causal or src <= idx
            kw = dict(causal=causal and src == idx, window=None)
        if live:
            out_b, lse_b = flash_lse(q, kv[0], kv[1], sm_scale=scale, **kw)
            m, w, acc = _merge_partials(m, w, acc, out_b, _bth(lse_b, b, h, tl))
        else:
            # a block ahead: the reference merges zeros at lse -1e30, which
            # leaves m, w and acc bit for bit as they are
            unread.append(kv)
        if pending is not None:
            kv = _Rotate.apply(kv, group, pending)
    out = (acc / w[..., None]).to(q.dtype)
    return _Join.apply(out, *unread) if unread else out


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    group: ModelGroup | None = None,
    causal: bool = True,
    sm_scale: float | None = None,
    window: int | None = None,
) -> torch.Tensor:
    """Exact attention over a sequence split into blocks over ``group``.

    q ``[B, Tl, H, D]``, k/v ``[B, Tl, KH, D]``: this rank's block of the
    sequence (rank i holds positions ``[i*Tl, (i+1)*Tl)``). ``group`` is the
    ``seq`` axis's group (``seq_group(mesh)``); None is a ring of one.
    Returns ``[B, Tl, H, D]``. ``window`` = W (requires ``causal``) keeps
    ``q_pos - k_pos < W`` over global positions, and the ring visits only the
    blocks that window reaches."""
    if window is not None:
        if not causal:
            raise ValueError("window (sliding-window ring attention) requires causal=True")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        window = int(window)
    return _ring(q, k, v, group, causal, sm_scale, window)


def ring_attention_sharded(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh: Any,
    axis_name: str = "seq",
    causal: bool = True,
    sm_scale: float | None = None,
    window: int | None = None,
) -> torch.Tensor:
    """Ring attention on q ``[B, T, H, D]`` and k/v ``[B, T, KH, D]`` that are
    replicated over the ``axis_name`` axis of ``mesh`` (a ``DeviceMesh``, or
    the axis's ``ModelGroup``): each rank takes its block of the sequence and
    every rank returns the whole ``[B, T, H, D]`` output."""
    group = mesh if isinstance(mesh, ModelGroup) else seq_group(mesh, axis_name)
    if q.shape[1] % group.size:
        raise ValueError(f"sequence length {q.shape[1]} is not divisible by mesh axis {axis_name!r} of size "
                         f"{group.size}")
    if group.size == 1:
        return ring_attention(q, k, v, None, causal=causal, sm_scale=sm_scale, window=window)
    q, k, v = (scatter_to_model(x, group, dim=1) for x in (q, k, v))
    out = ring_attention(q, k, v, group, causal=causal, sm_scale=sm_scale, window=window)
    return gather_from_model(out, group, dim=1)
