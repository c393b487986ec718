"""Pipeline parallelism: GPipe microbatch scheduling over a ``pipe`` mesh axis.

Counterpart of ``dmlcloud_tpu/parallel/pipeline_parallel.py``:
``stack_pytrees`` (:41), ``microbatch``/``unmicrobatch`` (:47/:55),
``stage_sharding`` (:60) and ``pipeline_apply`` (:69). The reference compiles
the GPipe tick loop into one XLA program (``lax.scan`` over ticks, ``ppermute``
between stages) and lets ``jax.grad`` transpose it. Here each process is one
stage of the ``pipe`` axis, and the loop is a hand schedule over the axis's
process group, run by one autograd function:

- forward: ``n_micro + n_stages - 1`` ticks; at tick t stage i runs
  ``stage_fn`` on microbatch ``t - i`` (stage 0 takes it from ``x``, the
  others from stage i-1's output of the tick before), and every tick ends with
  one exchange in which each stage sends its output to stage i+1 and receives
  from stage i-1. The bubble's ticks, where the reference runs ``stage_fn`` on
  zeros whose outputs are never committed, exchange zeros and run nothing;
- the last stage commits microbatch ``t - (n_stages - 1)``; at the end its
  outputs are broadcast over ``pipe`` and gathered over the data axes, so
  every process returns the whole ``[n_micro, micro_b, ...]`` output, as the
  reference's ``psum`` over ``pipe`` replicates it;
- backward: the ticks in reverse, each ending with the transposed exchange
  (the gradient of a stage's input goes to stage i-1). The order is explicit,
  so every rank posts its sends and receives in the same order. The adjoint
  of the final replication is this process's slice of the output's gradient
  on the last stage and nothing elsewhere: the gradients equal the sequential
  program's, not ``n_stages`` times them (an ``all_reduce`` whose backward
  sums the replicated cotangents would give that).

``stacked_params`` is a dict (nested dicts allowed) of tensors with a leading
``n_stages`` dim, the same on every process; each process runs its ``pipe``
row, and its gradient is non-zero in that row only. The microbatch dim of
``x`` is split over the data axes (``data`` x ``fsdp``), as the reference's
``act_spec`` splits it: each process's parameter gradients are its rows'
contribution, and summing them over the processes gives the gradient of the
whole batch.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from . import mesh as mesh_lib

__all__ = ["pipeline_apply", "stack_pytrees", "microbatch", "unmicrobatch", "stage_sharding"]


def stack_pytrees(trees: list[Any]) -> Any:
    """Stack per-stage parameter trees into one tree whose tensors gain a
    leading ``n_stages`` dim (the dim ``pipe`` splits)."""
    return pytree.tree_map(lambda *xs: torch.stack(xs), trees[0], *trees[1:])


def microbatch(batch: torch.Tensor, n_micro: int) -> torch.Tensor:
    """[B, ...] -> [n_micro, B/n_micro, ...] (B must divide evenly)."""
    b = batch.shape[0]
    if b % n_micro:
        raise ValueError(f"batch size {b} not divisible into {n_micro} microbatches")
    return batch.reshape(n_micro, b // n_micro, *batch.shape[1:])


def unmicrobatch(x: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`microbatch`."""
    return x.reshape(x.shape[0] * x.shape[1], *x.shape[2:])


def stage_sharding(mesh: Any, axis: str = mesh_lib.PIPE) -> mesh_lib.P:
    """The spec of stacked stage parameters: the leading (stage) dim over ``axis``."""
    return mesh_lib.P(axis)


@dataclass
class _Schedule:
    stage_fn: Callable
    spec: Any  # the treespec of stacked_params
    stage: int
    n_stages: int
    n_micro: int
    group: Any  # the pipe group
    prev: int | None  # global ranks of the neighbouring stages
    next: int | None
    rows: slice  # this process's rows of the microbatch dim
    data_groups: list  # (group, size) of each data axis, minor first


def _exchange(send: torch.Tensor | None, to: int | None, frm: int | None, like: torch.Tensor,
              group) -> torch.Tensor | None:
    """One tick's point-to-point exchange: ``send`` to ``to``, and a buffer
    like ``like`` received from ``frm`` (either may be None)."""
    ops, recv = [], None
    if to is not None:
        ops.append(dist.P2POp(dist.isend, send.contiguous(), to, group))
    if frm is not None:
        recv = torch.empty_like(like)
        ops.append(dist.P2POp(dist.irecv, recv, frm, group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return recv


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sched: _Schedule, x, *leaves):
        s = sched
        first, last = s.stage == 0, s.stage == s.n_stages - 1
        x_local = x[:, s.rows]
        rows = [leaf.detach()[s.stage].requires_grad_(leaf.requires_grad) for leaf in leaves]
        params = pytree.tree_unflatten(rows, s.spec)
        want_x = first and ctx.needs_input_grad[1]
        zeros = torch.zeros_like(x_local[0])
        saved: dict[int, tuple[torch.Tensor, torch.Tensor]] = {}
        outs: list[torch.Tensor] = []
        recv = None
        ticks = s.n_micro + s.n_stages - 1
        for t in range(ticks):
            m = t - s.stage  # the microbatch this stage works on at tick t
            send = zeros
            if 0 <= m < s.n_micro:
                act = (x_local[m] if first else recv).detach().requires_grad_(want_x or not first)
                with torch.enable_grad():
                    out = s.stage_fn(params, act)
                if out.shape != act.shape or out.dtype != act.dtype:
                    raise ValueError(f"stage_fn must keep the activation's shape and dtype (a homogeneous pipeline): "
                                     f"{tuple(act.shape)} {act.dtype} -> {tuple(out.shape)} {out.dtype}")
                saved[m] = (act, out)
                send = out.detach()
                if last:
                    outs.append(send)
            if t < ticks - 1:
                recv = _exchange(send, s.next, s.prev, zeros, s.group)
        y = torch.stack(outs) if last else torch.zeros_like(x_local)
        if s.n_stages > 1:
            dist.broadcast(y, src=dist.get_global_rank(s.group, s.n_stages - 1), group=s.group)
        for group, size in s.data_groups:
            parts = [torch.empty_like(y) for _ in range(size)]
            dist.all_gather(parts, y.contiguous(), group=group)
            y = torch.cat(parts, dim=1)
        ctx.sched, ctx.saved, ctx.rows = sched, saved, rows
        ctx.x_meta = (x.shape, x.dtype, x.device)
        ctx.leaf_meta = [(leaf.shape, leaf.dtype, leaf.device) for leaf in leaves]
        return y

    @staticmethod
    def backward(ctx, grad_y):
        s, saved, rows = ctx.sched, ctx.saved, ctx.rows
        first, last = s.stage == 0, s.stage == s.n_stages - 1
        shape, dtype, device = ctx.x_meta
        zeros = torch.zeros((s.rows.stop - s.rows.start, *shape[2:]), dtype=dtype, device=device)
        g_local = grad_y[:, s.rows] if last else None
        targets = [i for i, r in enumerate(rows) if r.requires_grad]
        row_grads = {i: torch.zeros_like(rows[i]) for i in targets}
        # zeros on every stage but the first: the computation upstream of x
        # runs its backward (and its collectives) on every rank alike
        grad_x = torch.zeros(shape, dtype=dtype, device=device) if ctx.needs_input_grad[1] else None
        g_next = None
        for t in reversed(range(s.n_micro + s.n_stages - 1)):
            m = t - s.stage
            send = None
            if 0 <= m < s.n_micro:
                act, out = saved.pop(m)
                inputs = ([act] if act.requires_grad else []) + [rows[i] for i in targets]
                grads = list(torch.autograd.grad(out, inputs, g_local[m] if last else g_next, allow_unused=True))
                if act.requires_grad:
                    send = grads.pop(0)
                for i, g in zip(targets, grads):
                    if g is not None:
                        row_grads[i] += g
                if first and grad_x is not None and send is not None:
                    grad_x[m, s.rows] = send
            if t > 0:
                # the transposed exchange: this tick's input gradient to stage
                # i-1, the gradient of the previous tick's output from stage i+1
                g_next = _exchange(zeros if send is None else send, s.prev, s.next, zeros, s.group)
        leaf_grads = []
        for i, (lshape, ldtype, ldevice) in enumerate(ctx.leaf_meta):
            if i not in row_grads:
                leaf_grads.append(None)
                continue
            full = torch.zeros(lshape, dtype=ldtype, device=ldevice)
            full[s.stage] = row_grads[i]
            leaf_grads.append(full)
        return (None, grad_x, *leaf_grads)


def pipeline_apply(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    stacked_params: Any,
    x: torch.Tensor,
    mesh: Any,
    axis: str = mesh_lib.PIPE,
) -> torch.Tensor:
    """Run ``x`` through ``n_stages`` pipeline stages with GPipe microbatching.

    Args:
      stage_fn: ``(params_slice, act) -> act``, one stage's computation; it must
        keep the activation's shape and dtype (a homogeneous pipeline). It runs
        on every stage with that stage's row of ``stacked_params``.
      stacked_params: a dict (or nested dicts) of tensors with leading dim
        ``n_stages`` (:func:`stack_pytrees`), the same on every process.
      x: ``[n_micro, micro_b, ...]`` microbatched activations
        (:func:`microbatch`), the same on every process; ``micro_b`` is split
        over the data axes.
      mesh: a ``DeviceMesh`` with ``axis``; its other axes pass through.
      axis: the pipeline axis's name.

    Returns the last stage's ``[n_micro, micro_b, ...]`` outputs on every process.
    """
    names = list(mesh.mesh_dim_names or ())
    if axis not in names:
        raise ValueError(f"mesh {dict(zip(names, mesh.shape))} has no pipeline axis {axis!r}")
    axes = mesh_lib.mesh_axes(mesh)
    n_stages, n_micro = axes[axis], x.shape[0]
    # leaves in the reference's order (JAX sorts dict keys)
    flat = pytree.tree_flatten_with_path(stacked_params)[0]
    for path, leaf in sorted(flat, key=lambda kv: [str(getattr(k, "key", getattr(k, "idx", k))) for k in kv[0]]):
        if tuple(leaf.shape[:1]) != (n_stages,):
            raise ValueError(
                f"stacked_params leaf {pytree.keystr(path)} has leading dim {tuple(leaf.shape[:1])}, expected "
                f"({n_stages},) == mesh.shape[{axis!r}] (a mismatch would silently drop stages)"
            )
    leaves, spec = pytree.tree_flatten(stacked_params)
    dp, dp_rank = mesh_lib.data_parallel_size(axes), mesh_lib.data_parallel_rank(mesh)
    if x.shape[1] % dp:
        raise ValueError(f"microbatch size {x.shape[1]} is not divisible by the data-parallel size {dp}")
    width = x.shape[1] // dp
    group = mesh.get_group(axis)
    stage = mesh.get_local_rank(axis)
    sched = _Schedule(
        stage_fn=stage_fn, spec=spec, stage=stage, n_stages=n_stages, n_micro=n_micro, group=group,
        prev=dist.get_global_rank(group, stage - 1) if stage > 0 else None,
        next=dist.get_global_rank(group, stage + 1) if stage < n_stages - 1 else None,
        rows=slice(dp_rank * width, (dp_rank + 1) * width),
        data_groups=[(mesh.get_group(a), axes[a]) for a in reversed(mesh_lib.data_axes(axes)) if axes[a] > 1],
    )
    return _GPipe.apply(sched, x, *leaves)
