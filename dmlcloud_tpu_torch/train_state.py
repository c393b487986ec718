"""TrainState: what the train step reads and updates.

Counterpart of ``dmlcloud_tpu/train_state.py`` (``TrainState`` :25,
``apply_gradients`` :109, ``update_ema`` :118, ``ema_like`` :143). The JAX
state is an immutable pytree threaded through a pure step; in PyTorch the
module and the optimizer hold their tensors and update them in place, so the
state holds the module, the optimizer bound to its parameters, the
learning-rate schedule, the step count and the optional fp32 EMA shadow of the
parameters.

``state_dict()`` is the checkpoint's view of it: a nested dict of the LIVE
tensors (no copies), ``{"step", "params", "opt_state": {"count", <slot>:
{name: tensor}}, "ema", "extras"}``, with parameters and optimizer slots keyed
by parameter name. ``"extras"`` holds the module's persistent buffers by name
(BatchNorm's running statistics), the counterpart of the reference's
``TrainState.extras`` (flax ``batch_stats``); a model without one (the
``DecoderLM``: its rotary tables are not persistent) has no such key. The EMA
shadow covers the parameters only, as the reference's ``update_ema`` does.
``torch.distributed.checkpoint.load`` fills such a dict in place, and
``load_state_dict`` then reads the two counters back.

A sharded model (``parallel.mesh.shard_module``: FSDP2, tensor parallelism)
has DTensor parameters, and its optimizer slots and EMA shadow are DTensors of
the same placements, under the same names: DCP saves and loads each rank's
shards in place through the same view. (``torch.distributed.checkpoint.
state_dict``'s ``get_optimizer_state_dict`` would also write the param groups,
whose learning rate is a schedule function, which DCP cannot store.)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterable

import numpy as np
import torch

from .parallel.tensor_parallel import local_tensor


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float] | None = None
    #: optimizer updates applied so far
    step: int = 0
    #: optional exponential moving average of the parameters, by parameter
    #: name: fp32 for floating parameters (a low-precision shadow quantises
    #: away the ``(1-d)*p`` increments), as-is otherwise
    ema: dict[str, torch.Tensor] | None = None

    @classmethod
    def create(
        cls,
        *,
        model: torch.nn.Module,
        tx: Callable[[Iterable[torch.nn.Parameter]], torch.optim.Optimizer],
        schedule: Callable[[int], float] | None = None,
        ema: bool = False,
    ) -> "TrainState":
        """Bind the optimizer factory ``tx`` (e.g. ``optim.adamw(schedule)``,
        the counterpart of an optax transformation) to the model's
        parameters; ``ema=True`` starts the shadow as an fp32 copy of them."""
        return cls(model=model, optimizer=tx(model.parameters()), schedule=schedule,
                   ema=ema_like(model) if ema else None)

    def apply_gradients(self) -> None:
        """One optimizer update from the gradients on the parameters."""
        self.optimizer.step()
        self.step += 1

    @torch.no_grad()
    def update_ema(self, decay: float, skip: set | frozenset = frozenset()) -> None:
        """Fold the current parameters into the EMA: ``ema += (1-d) * (p - ema)``,
        one fused ``torch._foreach_lerp_`` over the fp32 shadow (the
        reference's ``d*ema + (1-d)*p`` rounds differently, by about one fp32
        ulp). Non-float leaves cannot average: they track the parameters.
        Names in ``skip`` are left alone (a compiled step folded them already).
        No-op without a shadow."""
        if self.ema is None:
            return
        params = dict(self.model.named_parameters())
        emas, targets = [], []
        for name, e in self.ema.items():
            if name in skip:
                continue
            p = params[name]
            if not e.is_floating_point():
                e.copy_(p)
                continue
            emas.append(local_tensor(e))
            p = local_tensor(p)
            targets.append(p if p.dtype == e.dtype else p.to(e.dtype))
        if emas:
            torch._foreach_lerp_(emas, targets, ema_weight(decay))

    # -- checkpoint view ----------------------------------------------------
    def state_dict(self) -> dict:
        """The live tensors by name (see the module docstring). Optimizer
        slots that are created lazily (AdamW's moments) are materialised
        first, so that a restore before the first step has tensors to fill."""
        names = {p: n for n, p in self.model.named_parameters()}
        opt = self.optimizer
        init_state = getattr(opt, "init_state", None)
        if init_state is not None:
            init_state()
        slots: dict[str, dict[str, torch.Tensor]] = {}
        for p, pstate in opt.state.items():
            for slot, value in pstate.items():
                if isinstance(value, torch.Tensor):
                    slots.setdefault(slot, {})[names[p]] = value
        opt_state = {"count": torch.tensor(int(getattr(opt, "count", 0)), dtype=torch.int64), **slots}
        sd = {
            "step": torch.tensor(int(self.step), dtype=torch.int64),
            "params": {n: p.detach() for n, p in self.model.named_parameters()},
            "opt_state": opt_state,
        }
        if self.ema is not None:
            sd["ema"] = self.ema
        extras = persistent_buffers(self.model)
        if extras:
            sd["extras"] = extras
        return sd

    @torch.no_grad()
    def load_state_dict(self, sd: dict) -> None:
        """Take ``sd`` (the layout of ``state_dict()``) into the live state:
        tensors are copied unless they already are the live ones (a dict that
        DCP filled in place), the counters are read back."""
        live = self.state_dict()

        def take(dst: dict, src: dict) -> None:
            for key, value in src.items():
                if isinstance(value, dict):
                    take(dst[key], value)
                elif local_tensor(dst[key]).data_ptr() != local_tensor(value).data_ptr():
                    dst[key].copy_(value)

        take(live["params"], sd["params"])
        take(live["opt_state"], {k: v for k, v in sd["opt_state"].items() if k != "count"})
        if self.ema is not None and "ema" in sd:
            take(self.ema, sd["ema"])
        if "extras" in sd:
            take(live["extras"], sd["extras"])
        self.step = int(sd["step"])
        if hasattr(self.optimizer, "count"):
            self.optimizer.count = int(sd["opt_state"]["count"])


@torch.compiler.assume_constant_result
def ema_weight(decay: float) -> float:
    """The EMA's weight ``1 - d`` in fp32, as the reference computes it (a
    constant of a compiled step: ``decay`` is fixed for the stage)."""
    return float(np.float32(1.0) - np.float32(decay))


@torch.no_grad()
def ema_like(model: torch.nn.Module) -> dict[str, torch.Tensor]:
    """A fresh EMA shadow of ``model``'s parameters: fp32 copies of floating
    parameters, plain copies of the rest. Always copies."""
    return {
        n: p.detach().to(torch.float32, copy=True) if p.is_floating_point() else p.detach().clone()
        for n, p in model.named_parameters()
    }


def persistent_buffers(model: torch.nn.Module) -> dict[str, torch.Tensor]:
    """The buffers of ``model`` that its ``state_dict`` would save, by name:
    the live tensors. Buffers registered with ``persistent=False`` stay out."""
    out = {}
    for prefix, module in model.named_modules():
        for name, buf in module.named_buffers(recurse=False):
            if buf is not None and name not in module._non_persistent_buffers_set:
                out[f"{prefix}.{name}" if prefix else name] = buf
    return out
