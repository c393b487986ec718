"""Mixture-of-Experts: a top-k routed SwiGLU block with a fixed per-expert
capacity, and its expert parallelism over the ``expert`` mesh axis.

Counterpart of ``dmlcloud_tpu/models/moe.py``: ``moe_partition_rules`` (:34),
``MoEConfig`` (:45), ``_round_up`` (:57), ``MoEMLP`` (:61) and
``total_aux_loss`` (:146). It computes what the reference computes:

- the router is a bias-free fp32 ``QuantDense`` (flax kernel ``[D, E]``) on
  fp32 tokens, then a softmax; the top ``k = min(top_k, E)`` gates are
  renormalised with a ``1e-9`` floor;
- each (token, choice) queues in its expert's buffer by a cumsum over the
  token-major, choice-minor flattening, so a token's second pick queues behind
  every earlier token's picks; the capacity is
  ``min(_round_up(max(int(n_tok / E * cf), 1), 8), n_tok)`` and a choice at a
  position past it is dropped (its combine weight is zero);
- the experts are SwiGLU on ``cfg.dtype`` operands cast per call from fp32
  parameters ``[E, D, M]`` (gate, up) and ``[E, M, D]`` (down);
- the auxiliary loss is ``balance_coef * balance + router_z_coef * z``, with
  the Switch balance ``E * sum(token_frac * prob_frac) / k`` (``token_frac``
  counted before capacity drops) and the z-loss ``mean(logsumexp(logits)^2)``.

Dispatch and combine go by index, not by the reference's one-hot einsums:
each slot of the ``[E, C, D]`` buffer holds at most one token and each token
sums at most ``k`` weighted rows, so a gather and a ``k``-term sum give the
values of ``einsum("nec,nd->ecd")`` and ``einsum("nec,ecd->nd")`` without the
``2*N*E*C*D`` multiply-adds of the one-hot form. The combine weights are
formed in fp32 and cast to the activation dtype before the sum, as the
reference's ``combine`` is. ``MoEMLP.forward_onehot`` keeps the one-hot form
as the plain version the index form is held against.

The auxiliary loss: the reference sows it into flax's ``losses`` collection
and the caller folds it in (``mutable=["losses"]``, then
``total_aux_loss(variables)``). Here each ``MoEMLP`` keeps the value of its
last forward (``aux``, autograd-live) and ``total_aux_loss(model)`` sums them;
a training step returns ``lm_loss(...) + total_aux_loss(model)``.

Across processes:

- **expert parallelism** (``apply_shard``, from ``DecoderLM``'s
  ``apply_expert_parallel``): a rank holds ``E / expert`` experts. ``expert``
  peers see the same rows (the batch is split over ``data`` and ``fsdp``
  only), each runs the router and the whole routing, runs its experts on their
  slots, and the combined outputs are summed over the group in fp32. The
  router and the aux loss are replicated, so the gradient they give is whole
  on every peer; only the tokens fed to the local experts and the gates fed to
  the combine get ``copy_to_model``'s summing backward. Under the ``model``
  axis the same layer runs each expert's hidden dim ``M`` split
  (column-parallel gate/up, row-parallel down) with the same two rules;
- **data parallelism** (``apply_data_parallel``, which ``register_model``
  calls): the reference's step is one program over the global batch, so its
  capacity and queue positions count every data-parallel rank's tokens. Here
  the capacity comes from the global token count, each rank's positions are
  offset by the earlier ranks' per-expert choice counts (one ``all_gather`` of
  an ``[E]`` vector, in ``data_parallel_rank`` order), and the balance loss is
  the product of the two global means, its sums all-reduced with a summing
  backward (as ``clip_loss``'s gather), so the stage's gradient average gives
  the gradient of the reference's loss. With no group (or one rank) this is
  the local computation.

Every collective here is a functional one (``parallel.tensor_parallel``'s
``all_reduce_sum``/``all_gather_dim``), so a compiled step traces the routing
on a data-parallel group and the sums over the ``expert`` or ``model`` group
under ``fullgraph=True``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..parallel.tensor_parallel import (ModelGroup, all_gather_dim, all_reduce_sum, copy_to_model, local_tensor,
                                        reduce_from_model)
from .quant import QuantDense

__all__ = ["moe_partition_rules", "MoEConfig", "MoEMLP", "total_aux_loss"]


def moe_partition_rules() -> list[tuple[str, tuple]]:
    """Sharding rules for MoE layers: the expert dim over ``expert``, each
    expert's matrices over ``fsdp``/``model`` like their dense counterparts.
    Compose with the base model's rules (earlier rules win)."""
    from ..parallel.mesh import P

    return [
        ("moe/(gate|up)_proj", P("expert", "fsdp", "model")),
        ("moe/down_proj", P("expert", "model", "fsdp")),
        ("moe/router/kernel", P()),
    ]


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    hidden_dim: int = 512
    mlp_dim: int = 1408
    dtype: torch.dtype = torch.bfloat16
    router_z_coef: float = 1e-3
    balance_coef: float = 1e-2


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def capacity(n_tok: int, cfg: MoEConfig) -> int:
    """Slots per expert for ``n_tok`` tokens (the reference's Python float
    arithmetic and ``int`` truncation, rounded up to a multiple of 8, at most
    ``n_tok``)."""
    return min(_round_up(max(int(n_tok / cfg.num_experts * cfg.capacity_factor), 1), 8), n_tok)


class _SumOverGroup(torch.autograd.Function):
    """All-reduce sum whose backward is an all-reduce sum too: the gradient
    of a value every rank computes from the same global sum reaches each
    rank's own summands (``clip_loss``'s gather rule)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.group), None


@dataclass
class _Route:
    """One forward's routing: the kept gates and experts ``[N, k]``, each
    choice's queue position among this rank's tokens (``pos``), whether it
    fits (``keep``, by its global position), and the capacity."""

    gates: torch.Tensor
    experts: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    capacity: int


class MoEMLP(nn.Module):
    """Expert-parallel SwiGLU block ``[B, T, D] -> [B, T, D]`` (module
    docstring). Parameters: ``router`` (a ``QuantDense``, flax
    ``router/kernel`` ``[D, E]``) and ``gate_proj``/``up_proj`` ``[E, D, M]``,
    ``down_proj`` ``[E, M, D]`` in the flax layout (flax names
    ``moe/gate_proj`` ...). ``aux`` is the auxiliary loss of the last
    forward."""

    def __init__(self, cfg: MoEConfig, device=None):
        super().__init__()
        self.cfg = cfg
        e, d, m = cfg.num_experts, cfg.hidden_dim, cfg.mlp_dim
        self.router = QuantDense(d, e, torch.float32, device)
        self.gate_proj = nn.Parameter(torch.empty(e, d, m, dtype=torch.float32, device=device))
        self.up_proj = nn.Parameter(torch.empty(e, d, m, dtype=torch.float32, device=device))
        self.down_proj = nn.Parameter(torch.empty(e, m, d, dtype=torch.float32, device=device))
        #: the group the partial outputs are summed over (``expert`` or
        #: ``model``), and the first of this rank's experts
        self.shard: ModelGroup | None = None
        self.first_expert = 0
        #: the data-parallel processes whose tokens share the capacity
        self.dp_group = None
        self.aux: torch.Tensor | None = None

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's ``variance_scaling(1.0, "fan_in", "truncated_normal")`` on
        the expert weights (fan-in ``E * in``); the router as a dense layer."""
        for w in (self.gate_proj, self.up_proj, self.down_proj):
            std = math.sqrt(1.0 / (w.shape[0] * w.shape[1])) / 0.87962566103423978
            nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)

    def apply_shard(self, group: ModelGroup, first_expert: int = 0) -> None:
        """Run on this rank's shard of the experts (``first_expert`` onwards,
        as many as its local ``gate_proj`` holds) or of their hidden dim,
        summing the partial outputs over ``group``."""
        self.shard, self.first_expert = group, int(first_expert)

    def apply_data_parallel(self, group) -> None:
        """Count the capacity and the queue positions over the tokens of the
        data-parallel ``group`` (None: this process's only)."""
        self.dp_group = group

    def _dp(self, across_data: bool):
        group = self.dp_group if across_data else None
        return None if group is None or dist.get_world_size(group) == 1 else group

    def route(self, tokens: torch.Tensor, across_data: bool = True) -> _Route:
        """The router, the top-k choice and each choice's queue position;
        sets ``aux``."""
        cfg = self.cfg
        n, e = tokens.shape[0], cfg.num_experts
        k = min(cfg.top_k, e)
        logits = self.router(tokens.float())  # [N, E] fp32
        probs = torch.softmax(logits, dim=-1)
        gates, experts = probs.topk(k, dim=-1)
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
        onehot = F.one_hot(experts, e)  # [N, k, E]
        flat = onehot.reshape(n * k, e)
        # the cumsum runs along each expert's row of the transpose: a scan over
        # the inner dim (along dim 0 of [N*k, E] it is a slow outer-dim scan)
        pos = ((flat.t().contiguous().cumsum(1).t() - 1) * flat).sum(-1).reshape(n, k)
        group = self._dp(across_data)
        n_tok = n
        if group is None:
            token_frac = onehot.sum(1).float().mean(0)
            prob_frac = probs.mean(0)
        else:
            world, rank = dist.get_world_size(group), dist.get_rank(group)
            n_tok = n * world
            counts = flat.sum(0)
            every = all_gather_dim(counts[None], 0, group)  # [world, E]
            offset = every[:rank].sum(0) if rank else torch.zeros_like(counts)
            token_frac = _SumOverGroup.apply(counts.float(), group) / n_tok
            prob_frac = _SumOverGroup.apply(probs.sum(0), group) / n_tok
        cap = capacity(n_tok, cfg)
        balance = e * (token_frac * prob_frac).sum() / k
        z_loss = torch.logsumexp(logits, dim=-1).square().mean()
        self.aux = cfg.balance_coef * balance + cfg.router_z_coef * z_loss
        # a choice fits by its global queue position; this rank's buffer holds
        # its own tokens only, at their local positions
        keep = (pos if group is None else pos + offset[experts]) < cap
        return _Route(gates, experts, pos, keep, cap)

    def _experts(self, h: torch.Tensor) -> torch.Tensor:
        """SwiGLU of this rank's experts on ``h`` ``[E_local, C, D]``."""
        dt = self.cfg.dtype
        h = h.to(dt)
        gate = torch.bmm(h, local_tensor(self.gate_proj).to(dt))
        up = torch.bmm(h, local_tensor(self.up_proj).to(dt))
        return torch.bmm(F.silu(gate) * up, local_tensor(self.down_proj).to(dt))

    def forward(self, x: torch.Tensor, across_data: bool = True) -> torch.Tensor:
        """``across_data=False`` keeps the routing to this process's tokens
        (decode: each process generates on its own rows)."""
        return self._forward(x, across_data, onehot=False)

    def forward_onehot(self, x: torch.Tensor, across_data: bool = True) -> torch.Tensor:
        """The plain version: dispatch and combine as the reference's one-hot
        einsums over an ``[N, E, C]`` mask."""
        return self._forward(x, across_data, onehot=True)

    def _forward(self, x: torch.Tensor, across_data: bool, onehot: bool) -> torch.Tensor:
        cfg = self.cfg
        b, t, d = x.shape
        if d != cfg.hidden_dim:
            raise ValueError(f"MoEMLP input dim {d} != cfg.hidden_dim {cfg.hidden_dim}")
        tokens = x.reshape(b * t, d)
        r = self.route(tokens, across_data)
        e_loc = local_tensor(self.gate_proj).shape[0]
        mine = r.keep & (r.experts >= self.first_expert) & (r.experts < self.first_expert + e_loc)
        feed, gates = tokens, r.gates
        if self.shard is not None:
            # the local experts see part of the combine: the gradient of what
            # feeds them sums over the group (the router's is whole already)
            feed, gates = copy_to_model(tokens, self.shard), copy_to_model(gates, self.shard)
        # combine weights in fp32, cast to the activation dtype (moe.py:108-113)
        w = (gates * mine).to(x.dtype)
        if onehot:
            out = self._combine_onehot(feed, w, r, mine, e_loc)
        else:
            out = self._combine_index(feed, w, r, mine, e_loc)
        if self.shard is not None:
            out = reduce_from_model(out, self.shard)
        return out.to(x.dtype).reshape(b, t, d)

    def _combine_index(self, tokens, w, r: _Route, mine, e_loc: int) -> torch.Tensor:
        """Gather each slot's token, run the experts, and sum each token's
        ``k`` weighted rows (fp32). The slot past the buffer's end is where
        dropped and other ranks' choices point: a zero row."""
        n, d = tokens.shape
        c = r.capacity
        dump = e_loc * c
        slot = torch.where(mine, (r.experts - self.first_expert) * c + r.pos, dump)  # [N, k]
        owner = torch.full((dump + 1,), n, dtype=torch.long, device=tokens.device)
        owner.scatter_(0, slot.reshape(-1), torch.arange(n, device=tokens.device).repeat_interleave(slot.shape[1]))
        padded = torch.cat([tokens, tokens.new_zeros(1, d)])
        # index_select, whose backward is an index_add: each row gathers at most
        # k nonzero gradients, so their order cannot change the sum
        expert_out = self._experts(padded.index_select(0, owner[:dump]).reshape(e_loc, c, d))
        rows = torch.cat([expert_out.reshape(dump, d), expert_out.new_zeros(1, d)]).index_select(0, slot.reshape(-1))
        return torch.einsum("nk,nkd->nd", w.float(), rows.reshape(n, -1, d).float())

    def _combine_onehot(self, tokens, w, r: _Route, mine, e_loc: int) -> torch.Tensor:
        c, dt = r.capacity, tokens.dtype
        onehot = F.one_hot(torch.where(mine, r.experts - self.first_expert, 0), e_loc)  # [N, k, E_local]
        slots = F.one_hot(r.pos.clamp(0, c - 1), c) * mine[..., None]  # [N, k, C]
        dispatch = torch.einsum("nke,nkc->nec", onehot.to(dt), slots.to(dt))
        combine = torch.einsum("nke,nkc,nk->nec", onehot.float(), slots.float(), w.float())
        expert_out = self._experts(torch.einsum("nec,nd->ecd", dispatch, tokens))
        return torch.einsum("nec,ecd->nd", combine, expert_out.float())


def total_aux_loss(model: nn.Module) -> torch.Tensor:
    """The sum of every ``MoEMLP``'s auxiliary loss from its last forward
    (autograd-live), in the reference's leaf order; a zero tensor for a model
    without MoE. The counterpart of ``apply(..., mutable=["losses"])``
    followed by ``total_aux_loss(variables)``: call it after the forward whose
    loss it joins."""
    layers = {name: m for name, m in model.named_modules() if isinstance(m, MoEMLP) and m.aux is not None}
    if not layers:
        return torch.zeros((), device=next(iter(model.parameters()), torch.zeros(())).device)
    total = 0
    for name in sorted(layers):
        total = total + layers[name].aux
    return total
