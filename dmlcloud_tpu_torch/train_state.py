"""TrainState: what the train step reads and updates.

Counterpart of ``dmlcloud_tpu/train_state.py`` (``TrainState`` :25,
``apply_gradients`` :109). The JAX state is an immutable pytree threaded
through a pure step; in PyTorch the module and the optimizer hold their
tensors and update them in place, so the state holds the module, the
optimizer bound to its parameters, the learning-rate schedule and the step
count.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterable

import torch


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float] | None = None
    #: optimizer updates applied so far
    step: int = 0

    @classmethod
    def create(
        cls,
        *,
        model: torch.nn.Module,
        tx: Callable[[Iterable[torch.nn.Parameter]], torch.optim.Optimizer],
        schedule: Callable[[int], float] | None = None,
    ) -> "TrainState":
        """Bind the optimizer factory ``tx`` (e.g. ``optim.adamw(schedule)``,
        the counterpart of an optax transformation) to the model's parameters."""
        return cls(model=model, optimizer=tx(model.parameters()), schedule=schedule)

    def apply_gradients(self) -> None:
        """One optimizer update from the gradients on the parameters."""
        self.optimizer.step()
        self.step += 1
