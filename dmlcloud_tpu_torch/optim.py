"""The optimizers and learning-rate schedules the examples take from optax.

``examples/train_lm.py`` trains with ``optax.adamw(schedule)`` and
``optax.warmup_cosine_decay_schedule(0.0, lr, 20, 2000)``, the ResNet recipe
(``bench.py``) with ``optax.sgd(0.1, momentum=0.9)``. Their counterparts here
keep optax's conventions, which differ from ``torch.optim``'s:

- ``adamw`` defaults to b1 0.9, b2 0.999, eps 1e-8 and **weight_decay 1e-4 on
  every parameter** (``torch.optim.AdamW`` defaults to 0.01), and computes
  ``p <- p - lr(count) * (mu_hat / (sqrt(nu_hat) + eps) + wd * p)``;
- ``sgd`` keeps optax's trace ``t <- g + momentum * t`` (no dampening, no
  weight decay) and steps ``p <- p - lr(count) * t`` (Nesterov: ``g + momentum
  * t``);
- the schedule is evaluated at the step count BEFORE the update, so the
  first update of the warmup schedule is taken at lr = 0.

A compiled step (``TrainValStage.precompile()``) updates each parameter
through ``update_param``, the same arithmetic per tensor, with the numbers of
``step_scalars()`` as tensors.

Like an optax transformation, ``adamw(...)`` and ``sgd(...)`` are not yet bound
to parameters: each returns a factory that ``TrainState.create`` calls with the
model's parameters. Optax's ``count`` is the attribute ``count``, outside
``torch.optim.Optimizer.state_dict()``; checkpoints carry it through
``TrainState.state_dict()``, so that a resumed run keeps its bias correction
and its place in the schedule.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Iterable

import torch

from .parallel.tensor_parallel import local_tensor

Schedule = Callable[[int], float]


def linear_schedule(init_value: float, end_value: float, transition_steps: int) -> Schedule:
    """optax.linear_schedule: ``init -> end`` over ``transition_steps``, then held."""

    def schedule(count: int) -> float:
        if transition_steps <= 0:
            return end_value
        frac = 1.0 - min(max(count, 0), transition_steps) / transition_steps
        return (init_value - end_value) * frac + end_value

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0, exponent: float = 1.0) -> Schedule:
    """optax.cosine_decay_schedule."""
    if not decay_steps > 0:
        raise ValueError(f"The cosine_decay_schedule requires positive decay_steps, got decay_steps={decay_steps}.")

    def schedule(count: int) -> float:
        count = min(count, decay_steps)
        cosine = 0.5 * (1 + math.cos(math.pi * count / decay_steps))
        return init_value * ((1 - alpha) * cosine**exponent + alpha)

    return schedule


def warmup_cosine_decay_schedule(
    init_value: float, peak_value: float, warmup_steps: int, decay_steps: int,
    end_value: float = 0.0, exponent: float = 1.0,
) -> Schedule:
    """optax.warmup_cosine_decay_schedule: linear warmup to ``peak_value``,
    then cosine decay to ``end_value`` at ``decay_steps`` (warmup included)."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    warmup = linear_schedule(init_value, peak_value, warmup_steps)
    decay = cosine_decay_schedule(peak_value, decay_steps - warmup_steps, alpha, exponent)

    def schedule(count: int) -> float:
        return warmup(count) if count < warmup_steps else decay(count - warmup_steps)

    return schedule


class AdamW(torch.optim.Optimizer):
    """AdamW with optax's arithmetic (``scale_by_adam`` ->
    ``add_decayed_weights`` -> ``scale_by_learning_rate``). ``lr`` is a float
    or a schedule of the step count. The moments are fp32 tensors beside each
    parameter; the update runs as ``torch._foreach`` ops over all of them."""

    def __init__(
        self, params: Iterable[torch.nn.Parameter], lr: float | Schedule, b1: float = 0.9, b2: float = 0.999,
        eps: float = 1e-8, weight_decay: float = 1e-4,
    ):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay))
        #: optax's ScaleByAdamState.count: updates applied so far
        self.count = 0

    @torch.no_grad()
    def init_state(self) -> None:
        """Create the zero moments of every parameter that has none yet: at
        the first step, or before a checkpoint restore that fills them."""
        for group in self.param_groups:
            for p in group["params"]:
                if not self.state.get(p):
                    self.state[p] = {"mu": torch.zeros_like(p), "nu": torch.zeros_like(p)}

    def current_lr(self, group: dict | None = None) -> float:
        lr = (group or self.param_groups[0])["lr"]
        return float(lr(self.count)) if callable(lr) else float(lr)

    def step_scalars(self) -> list[list[float]]:
        """The numbers of the next update that change from step to step, per
        param group: ``[lr(count), 1 - b1**(count+1), 1 - b2**(count+1)]``."""
        c = self.count + 1
        return [[self.current_lr(g), 1 - g["b1"] ** c, 1 - g["b2"] ** c] for g in self.param_groups]

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("AdamW.step takes no closure")
        count_inc = self.count + 1
        self.init_state()
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            b1, b2, eps, wd = group["b1"], group["b2"], group["eps"], group["weight_decay"]
            lr = self.current_lr(group)
            # a sharded model's parameters, gradients and moments are DTensors:
            # the update is elementwise, so it runs on the local shards
            grads = [local_tensor(p.grad) for p in params]
            mus = [local_tensor(self.state[p]["mu"]) for p in params]
            nus = [local_tensor(self.state[p]["nu"]) for p in params]
            params = [local_tensor(p) for p in params]
            # mu = (1 - b1) g + b1 mu ; nu = (1 - b2) g^2 + b2 nu
            torch._foreach_mul_(mus, b1)
            torch._foreach_add_(mus, grads, alpha=1 - b1)
            torch._foreach_mul_(nus, b2)
            torch._foreach_addcmul_(nus, grads, grads, value=1 - b2)
            # bias-corrected update mu_hat / (sqrt(nu_hat) + eps)
            update = torch._foreach_div(mus, 1 - b1**count_inc)
            denom = torch._foreach_div(nus, 1 - b2**count_inc)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, eps)
            torch._foreach_div_(update, denom)
            del denom
            if wd:
                torch._foreach_add_(update, params, alpha=wd)
            torch._foreach_add_(params, update, alpha=-lr)
        self.count = count_inc

    @staticmethod
    @torch.no_grad()
    def update_param(p: torch.Tensor, g: torch.Tensor, slots: dict, group: dict, scalars) -> None:
        """``step`` for one parameter ``p`` of param group ``group``, with
        gradient ``g`` and its ``slots`` (``state[p]``); ``scalars`` is the
        group's row of ``step_scalars()`` as a tensor. The form a compiled step
        calls once per parameter, compiled once per parameter shape (the
        numbers that change every step are graph inputs, not constants); a
        static method, so that the compiled graph reads no optimizer object."""
        b1, b2, eps, wd = group["b1"], group["b2"], group["eps"], group["weight_decay"]
        p, g = local_tensor(p), local_tensor(g)
        mu, nu = local_tensor(slots["mu"]), local_tensor(slots["nu"])
        mu.mul_(b1).add_(g, alpha=1 - b1)
        nu.mul_(b2).addcmul_(g, g, value=1 - b2)
        update = (mu / scalars[1]) / ((nu / scalars[2]).sqrt() + eps)
        if wd:
            update = update + wd * p
        p.sub_(update * scalars[0])


def adamw(
    learning_rate: float | Schedule, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
    weight_decay: float = 1e-4,
) -> Callable[[Iterable[torch.nn.Parameter]], AdamW]:
    """optax.adamw's signature and defaults; returns a factory of ``AdamW``
    over the parameters it is given."""
    return functools.partial(AdamW, lr=learning_rate, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)


class SGD(torch.optim.Optimizer):
    """SGD with optax's arithmetic (``trace`` -> ``scale_by_learning_rate``).
    ``lr`` is a float or a schedule of the step count. With ``momentum`` each
    parameter has a ``trace`` slot of its own dtype beside it; the update runs
    as ``torch._foreach`` ops over all of them."""

    def __init__(self, params: Iterable[torch.nn.Parameter], lr: float | Schedule, momentum: float | None = None,
                 nesterov: bool = False):
        super().__init__(params, dict(lr=lr, momentum=momentum, nesterov=nesterov))
        #: updates applied so far (optax's schedule count)
        self.count = 0

    @torch.no_grad()
    def init_state(self) -> None:
        """Create the zero trace of every parameter that has none yet (only
        with momentum): at the first step, or before a restore that fills it."""
        for group in self.param_groups:
            if group["momentum"] is None:
                continue
            for p in group["params"]:
                if not self.state.get(p):
                    self.state[p] = {"trace": torch.zeros_like(p)}

    def current_lr(self, group: dict | None = None) -> float:
        lr = (group or self.param_groups[0])["lr"]
        return float(lr(self.count)) if callable(lr) else float(lr)

    def step_scalars(self) -> list[list[float]]:
        """The learning rate of the next update, per param group: ``[lr(count)]``."""
        return [[self.current_lr(g)] for g in self.param_groups]

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("SGD.step takes no closure")
        self.init_state()
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            updates = [local_tensor(p.grad) for p in params]
            momentum = group["momentum"]
            if momentum is not None:
                # t = g + momentum * t; Nesterov steps along g + momentum * t
                traces = [local_tensor(self.state[p]["trace"]) for p in params]
                torch._foreach_mul_(traces, momentum)
                torch._foreach_add_(traces, updates)
                if group["nesterov"]:
                    updates = torch._foreach_mul(traces, momentum)
                    torch._foreach_add_(updates, [local_tensor(p.grad) for p in params])
                else:
                    updates = traces
            torch._foreach_add_([local_tensor(p) for p in params], updates, alpha=-self.current_lr(group))
        self.count += 1

    @staticmethod
    @torch.no_grad()
    def update_param(p: torch.Tensor, g: torch.Tensor, slots: dict, group: dict, scalars) -> None:
        """``step`` for one parameter, as ``AdamW.update_param``."""
        p, g = local_tensor(p), local_tensor(g)
        momentum = group["momentum"]
        update = g
        if momentum is not None:
            trace = local_tensor(slots["trace"])
            trace.mul_(momentum).add_(g)
            update = g + momentum * trace if group["nesterov"] else trace
        p.sub_(update * scalars[0])


def sgd(learning_rate: float | Schedule, momentum: float | None = None,
        nesterov: bool = False) -> Callable[[Iterable[torch.nn.Parameter]], SGD]:
    """optax.sgd's signature and defaults; returns a factory of ``SGD`` over
    the parameters it is given."""
    return functools.partial(SGD, lr=learning_rate, momentum=momentum, nesterov=nesterov)
