"""Multi-tenant LoRA serving: stacked adapters, gathered by request id.

Counterpart of ``dmlcloud_tpu/serve/adapters.py`` (``AdapterSet``).
``lora_merge`` folds one adapter into the base weights, which serves one
tenant; a batch that mixes tenants has no single set of weights to run.
:class:`AdapterSet` stacks every tenant's LoRA factors along a new leading
axis (``a: [N, d_in, r]``, ``b: [N, r, d_out]`` per adapted kernel), the
decode batch carries a per-row adapter id, and each dense layer adds its
row's own delta ``(x @ a[id]) @ b[id]`` inside the step
(``models.transformer._adapter_add``). The base weights stream once for the
whole mixed batch.

Index 0 is the null adapter (zero factors, an exact zero delta), so requests
without an adapter ride the same gather. Adapters are the port's
``lora_init(generator, model, rank, in_axes=1)`` trees (nested dicts by flax
path, ``LoraPair`` leaves of tensors, None elsewhere): the factored
application contracts ``a`` against the layer input, so ``a`` must carry the
flax kernel's first axis. Given ``base`` (the model), ``AdapterSet`` rejects
an all-but-last split with the reference's message.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch

from ..models.lora import LoraPair, _flax_leaf, _paths

__all__ = ["AdapterSet"]


def _structure(tree: Any):
    """The tree's nesting, pairs and Nones alike as leaves (what the
    reference's ``jax.tree_util.tree_structure`` compares)."""
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in tree.items()}
    return None


def _map(fn, *trees):
    """``fn`` over the trees' leaves (pairs and Nones), keeping the dicts."""
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


class AdapterSet:
    """Stacked per-tenant LoRA adapters for batched serving.

    ``adapters`` maps tenant name -> adapter tree from ``lora_init(generator,
    model, rank, in_axes=1)``; every tenant must adapt the same kernels at the
    same rank. ``alpha`` is the LoRA scale; ``b`` is pre-scaled by
    ``alpha/rank`` at stacking time, so the delta in the step is two einsums.
    ``base`` (optional, the model the adapters were made for) enables the
    factorization check. The stacked factors are fp32 on the adapters'
    device."""

    def __init__(self, adapters: Mapping[str, Any], alpha: float = 16.0, base: Any = None):
        if not adapters:
            raise ValueError("AdapterSet needs at least one adapter")
        self.names: list[str | None] = [None] + list(adapters)
        self._ids = {name: i for i, name in enumerate(self.names)}
        trees = list(adapters.values())
        ref = _structure(trees[0])
        for name, tree in adapters.items():
            if _structure(tree) != ref:
                raise ValueError(
                    f"adapter {name!r} adapts a different kernel set than the others; "
                    "all tenants must come from the same lora_init match"
                )
        if base is not None:
            self._check_factorization(trees[0], base)

        def stack_leaf(*pairs):
            if pairs[0] is None:
                return None
            ranks = {p.a.shape[-1] for p in pairs}
            if len(ranks) != 1:
                raise ValueError(f"adapters disagree on rank for one kernel: {sorted(ranks)}")
            a = torch.stack([torch.zeros_like(pairs[0].a)] + [p.a for p in pairs]).float()
            # pre-scale b by alpha/rank: the delta in the step is then just
            # (x @ a[id]) @ b[id], no runtime scale
            b = torch.stack([torch.zeros_like(pairs[0].b)] + [p.b * (alpha / p.a.shape[-1]) for p in pairs]).float()
            return LoraPair(a=a, b=b)

        self.stacked = _map(stack_leaf, *trees)
        self.alpha = float(alpha)

    @staticmethod
    def _check_factorization(tree: Any, base: Any) -> None:
        """``a`` must carry each base kernel's FIRST axis (in_axes=1); the
        all-but-last factorization cannot be applied per row. ``base`` is the
        model; its kernels are read in the flax layout, in the reference's
        (sorted) order."""
        paths = _paths(base)

        def check(node, prefix):
            if isinstance(node, dict):
                for k in sorted(node):
                    check(node[k], f"{prefix}/{k}" if prefix else str(k))
                return
            if not isinstance(node, LoraPair) or prefix not in paths:
                return
            name, how = paths[prefix]
            first = _flax_leaf(base, name, how).shape[0]
            if node.a.shape[0] != first:
                raise ValueError(
                    f"adapter a-factor has in-dim {node.a.shape[0]} but the base kernel's "
                    f"first axis is {first}: batched serving needs adapters built "
                    "with lora_init(..., in_axes=1)"
                )

        check(tree, "")

    def __len__(self) -> int:
        return len(self.names)

    def id_of(self, name: str | None) -> int:
        """The stacked index of a tenant (None -> 0, the null adapter)."""
        try:
            return self._ids[name]
        except KeyError:
            raise KeyError(f"unknown adapter {name!r}; known: {[n for n in self.names if n]}") from None

    def _device(self) -> torch.device | None:
        """Where the stacked factors live (None when no kernel is adapted)."""
        found = []
        _map(lambda p: found.append(p.a.device) if p is not None else None, self.stacked)
        return found[0] if found else None

    def pack(self, ids) -> tuple[Any, torch.Tensor]:
        """The ``adapters=`` argument for a decode step: the stacked tree plus
        the per-row ids as an int64 tensor on the factors' device."""
        return self.stacked, torch.as_tensor(ids, dtype=torch.long, device=self._device())
