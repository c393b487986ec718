"""LoRA: low-rank adapters (arXiv:2106.09685).

Counterpart of ``dmlcloud_tpu/models/lora.py``: ``LoraPair`` (:58),
``default_match`` (:69), ``_paths`` (:75), ``_as_matcher`` (:82), ``lora_init``
(:91), ``lora_merge`` (:144), ``batched_lora_delta`` (:164), ``lora_size``
(:178) and ``lora_partition_rules`` (:183).

The reference works on flax param trees; the port's models hold their weights.
Every function here sees a model's weights as the reference sees its tree:
by the ``/``-joined flax path of the model's layout rows (``flax_layout()``,
``models/bridge.py``; a parameter the layout does not declare keeps its torch
name, ``/``-joined) and in the flax layout (``bridge.torch_to_flax``). So a
matcher, the default one or a regex, selects the same leaves in both
packages, and ``a``/``b`` have the reference's shapes, ``[d_in, r]`` and ``[r,
d_out]`` over the flax kernel's axes: a ``q_proj`` kernel is ``[D, H, hd]`` in
flax and ``[H*hd, D]`` here, and its delta lands in the port's rows through
the bridge's own transform. An adapter tree is the reference's: nested dicts
by flax path, ``LoraPair`` leaves of tensors where the matcher matched, None
elsewhere.

``lora_init`` draws ``a`` from a ``torch.Generator``: the factors are not
``jax.random``'s. The bridges carry the reference's adapter trees (numpy) in
and out, so tests feed both packages the same factors.

Canonical stage (the port's form of the reference's, lora.py:20-33)::

    class LoraStage(dml.TrainValStage):
        def pre_stage(self):
            adapters = lora_init(torch.Generator("cuda").manual_seed(0), base, rank=16)
            self.pipeline.register_model("lm", LoraModel(base, adapters))
            self.pipeline.register_optimizer("adamw", optim.adamw(1e-4))

        def step(self, state, batch):
            return lm_loss(state.model(batch), batch)

``LoraModel`` is the reference's ``params={"params": adapters, "lora_base":
base}``: the adapters are its parameters (what the optimizer and the EMA
see), the base's weights its persistent buffers (frozen, never
differentiated, carried in the checkpoint's ``"extras"``), and its forward is
the base's on ``lora_merge(base, adapters)``. ``lora_merge`` again at the end
exports a plain model (``load_state_dict``).
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Any, Callable

import torch
from torch import nn

from .bridge import flax_to_torch, flax_view, torch_to_flax

__all__ = [
    "LoraPair",
    "lora_init",
    "lora_merge",
    "lora_size",
    "default_match",
    "batched_lora_delta",
]


@dataclass
class LoraPair:
    """One adapted kernel's factor pair: ``delta = (a @ b) * alpha/rank``."""

    a: torch.Tensor
    b: torch.Tensor

    def replace(self, **changes) -> "LoraPair":
        return LoraPair(**{"a": self.a, "b": self.b, **changes})


def default_match(path: str, leaf: Any) -> bool:
    """Adapt every matrix-shaped ``kernel`` (dense/attention/conv); biases,
    norms, and embeddings stay frozen-only."""
    return path.endswith("kernel") and getattr(leaf, "ndim", 0) >= 2


def _paths(model: nn.Module) -> dict[str, tuple[str, Any]]:
    """``/``-joined flax path -> (the port's tensor name, its bridge
    transform) for every weight of ``model``: its layout rows, then any
    parameter they do not declare under its ``/``-joined torch name."""
    from ..parallel.mesh import path_str

    out = {path_str(p): (name, how) for p, name, how in (model.flax_layout() if hasattr(model, "flax_layout") else [])}
    declared = {name for name, _ in out.values()}
    for name, _ in model.named_parameters():
        if name not in declared:
            out[name.replace(".", "/")] = (name, "same")
    return out


def _weight(model: nn.Module, name: str):
    """The module attribute ``name`` (dotted) of ``model``: a parameter, a
    buffer, or a ``QuantizedTensor``."""
    owner, _, attr = name.rpartition(".")
    return getattr(model.get_submodule(owner), attr)


def _flax_leaf(model: nn.Module, name: str, how):
    """What the reference's tree holds at that weight: the weight in the flax
    layout (a view), or a ``QuantizedTensor``, which keeps that layout."""
    w = _weight(model, name)
    return w if isinstance(w, nn.Module) else torch_to_flax(w, how)


def _lookup(tree: Any, path: str):
    node = tree
    for key in path.split("/"):
        if not isinstance(node, dict) or key not in node:
            return None
        node = node[key]
    return node


def _insert(tree: dict, path: str, value) -> None:
    *parents, last = path.split("/")
    node = tree
    for key in parents:
        node = node.setdefault(key, {})
    node[last] = value


def _as_matcher(match: Any) -> Callable[[str, Any], bool]:
    if match is None:
        return default_match
    if isinstance(match, str):
        pattern = re.compile(match)
        return lambda path, leaf: pattern.search(path) is not None and getattr(leaf, "ndim", 0) >= 2
    return match


def lora_init(
    generator: torch.Generator | None,
    model: nn.Module,
    rank: int = 8,
    match: str | Callable[[str, Any], bool] | None = None,
    in_axes: int | None = None,
) -> dict:
    """Adapter tree for ``model``: matched leaves become ``LoraPair`` factor
    pairs, everything else None (module docstring).

    ``a`` is ``[in, rank]`` Gaussian (1/sqrt(in) scale, the LoRA paper's
    init), drawn from ``generator`` (None: seed 0 on the model's device),
    ``b`` is ``[rank, out]`` zeros: the merged model starts exactly at the
    base. ``match`` is the ``default_match`` kernel predicate, a regex over
    the flax paths, or a ``(path, leaf) -> bool`` callable.

    ``in_axes`` splits a rank-``n`` flax kernel's axes between the LoRA "in"
    and "out" dims: the leading ``in_axes`` axes collapse into "in", the rest
    into "out"; None keeps the all-but-last split. Per-row adapters
    (``DecoderLM(adapters=)``) need ``in_axes=1``: ``(x @ a) @ b`` only works
    when ``a`` contracts against the layer's input."""
    matcher = _as_matcher(match)
    tree: dict = {}
    for path, (name, how) in _paths(model).items():
        leaf = _flax_leaf(model, name, how)
        if not matcher(path, leaf):
            _insert(tree, path, None)
            continue
        n_in = leaf.ndim - 1 if in_axes is None else int(in_axes)
        if not 1 <= n_in < leaf.ndim:
            raise ValueError(f"in_axes must be in [1, ndim) for {path!r} (ndim {leaf.ndim}), got {n_in}")
        d_in, d_out = math.prod(leaf.shape[:n_in]), math.prod(leaf.shape[n_in:])
        device = leaf.device
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        a = torch.randn(d_in, rank, generator=generator, device=generator.device, dtype=torch.float32)
        _insert(tree, path, LoraPair(a=(a / math.sqrt(d_in)).to(device),
                                     b=torch.zeros(rank, d_out, dtype=torch.float32, device=device)))
    return tree


def lora_merge(base: nn.Module, adapters: dict, alpha: float = 16.0) -> dict[str, torch.Tensor]:
    """``base + (a @ b) * alpha/rank`` on every adapted weight of the model
    ``base``: its weights by tensor name (what ``torch.func.functional_call``
    and ``load_state_dict`` take), differentiable in ``a`` and ``b``.
    Non-adapted weights pass through untouched. The delta computes in fp32,
    lands in the port's layout through the bridge's transform, and the sum is
    cast to the weight's dtype."""
    out = {}
    for path, (name, how) in _paths(base).items():
        p = _weight(base, name)
        ad = _lookup(adapters, path)
        if ad is None:
            out[name] = p
            continue
        rank = ad.a.shape[-1]
        delta = (ad.a @ ad.b) * (alpha / rank)
        delta = flax_to_torch(delta.reshape(flax_view(p.shape, how)[1]), how, p.shape)
        out[name] = (p.float() + delta).to(p.dtype)
    return out


def batched_lora_delta(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """Per-row LoRA delta for multi-tenant batched serving: each batch row
    applies its own adapter, gathered by request id before the call.

    ``x`` is the layer input ``[B, T, d_in]``; ``a``/``b`` are the gathered
    per-row factors ``[B, d_in, r]`` / ``[B, r, d_out]``. Returns the fp32
    delta ``[B, T, d_out]`` = ``(x @ a_row) @ b_row * scale``: rank-r work per
    token, no per-row ``d_in x d_out`` weight."""
    h = torch.einsum("btd,bdr->btr", x.float(), a.float())
    return torch.einsum("btr,bro->bto", h, b.float()) * scale


def lora_size(adapters: Any) -> int:
    """Trainable adapter parameter count (what the optimizer actually sees)."""
    if isinstance(adapters, LoraPair):
        return adapters.a.numel() + adapters.b.numel()
    if isinstance(adapters, dict):
        return sum(lora_size(v) for v in adapters.values())
    return 0


def lora_partition_rules(base_rules: list) -> list:
    """Sharding rules for a LoRA setup: replicate the adapter factors, keep
    ``base_rules`` for everything else. A base rule for ``attn/q_proj/kernel``
    also matches the adapter path ``attn/q_proj/kernel/a`` (rules match with
    ``re.search``), so the adapter rule goes first: first match wins."""
    from ..parallel.mesh import P

    return [(r"kernel/(a|b)$", P()), *base_rules]


class LoraModel(nn.Module):
    """A model finetuned through its adapters only (module docstring): the
    adapters of ``adapters`` are this module's parameters, under their flax
    paths (``factors.layer_0.attn.q_proj.kernel.a``); ``base``'s parameters
    become its persistent buffers, in place. ``forward`` runs ``base`` on
    ``lora_merge(base, self.adapters(), alpha)``."""

    def __init__(self, base: nn.Module, adapters: dict, alpha: float = 16.0):
        super().__init__()
        for module in base.modules():
            for name, p in list(module._parameters.items()):
                if p is not None:
                    del module._parameters[name]
                    module.register_buffer(name, p.detach())
        self.base = base
        self.alpha = float(alpha)
        self.factors = nn.ModuleDict()
        self._paths = []
        for path in _pair_paths(adapters):
            pair = _lookup(adapters, path)
            *parents, last = path.split("/")
            node = self.factors
            for key in parents:
                if key not in node:
                    node[key] = nn.ModuleDict()
                node = node[key]
            node[last] = nn.ParameterDict({"a": nn.Parameter(pair.a.detach().clone()),
                                           "b": nn.Parameter(pair.b.detach().clone())})
            self._paths.append(path)

    def adapters(self) -> dict:
        """The adapter tree over this module's parameters (no copies)."""
        tree: dict = {}
        for path in self._paths:
            node = self.factors
            for key in path.split("/"):
                node = node[key]
            _insert(tree, path, LoraPair(a=node["a"], b=node["b"]))
        return tree

    def forward(self, *args, **kwargs):
        return torch.func.functional_call(self.base, lora_merge(self.base, self.adapters(), self.alpha), args, kwargs)


def _pair_paths(tree: Any, prefix: str = "") -> list[str]:
    if isinstance(tree, LoraPair):
        return [prefix]
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in _pair_paths(v, f"{prefix}/{k}" if prefix else str(k))]
    return []
