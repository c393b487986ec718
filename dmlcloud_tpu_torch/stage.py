"""Stage: one phase of an experiment; TrainValStage: the train loop.

Counterpart of ``dmlcloud_tpu/stage.py`` (``Stage`` :75 with its
``pre_stage``/``run_epoch``/``run`` hooks, ``TrainValStage`` :302). The JAX
stage compiles one pure, donated step; here the step runs eagerly:
``zero_grad`` -> the user's ``step(state, batch)`` -> ``backward`` -> global-norm
clip -> optimizer update, with the tensors updated in place.

What carries over unchanged:

- the gradient clip formula of the reference (stage.py:704-709):
  ``scale = min(1, clip * rsqrt(max(sum g^2, 1e-12)))`` — not
  ``clip_grad_norm_``'s ``clip / (norm + 1e-6)``;
- deferred loss readback: losses stay device tensors; the host reads one
  (two steps behind, already computed) only every ``log_every()`` steps, where
  the NaN/inf guard runs, and the epoch's values reach the host once, in the
  epoch-end reduction — no ``.item()`` per step;
- the tracked metric names: ``{train,val}/loss``,
  ``misc/total_{train,val}_batches``, ``misc/worker_{train,val}_batches``,
  ``misc/step_dispatch_ms``, ``misc/train_step_avg_ms``, ``misc/host_stall_ms``
  and ``misc/lr_<name>``;
- validation under ``torch.no_grad()``.

EMA, gradient accumulation, int8 training, precompile/verify/lint, the
telemetry journal, checkpointing and preemption come in later slices.
"""

from __future__ import annotations

import sys
import time
from datetime import datetime
from typing import Any

import numpy as np
import torch

from .metrics import MetricTracker, Reduction
from .parallel.runtime import is_root
from .train_state import TrainState
from .utils.logging import DevNullIO, flush_log_handlers
from .utils.profiling import StallTimer
from .utils.table import ProgressTable

__all__ = ["Stage", "TrainValStage", "DatasetNotFoundError"]


class DatasetNotFoundError(ValueError):
    """A stage asked for a dataset that was never registered (validation is
    optional; any other ``ValueError`` propagates)."""


class Stage:
    """One phase of training, run sequentially by the pipeline. Hook points:
    ``pre_stage``, ``post_stage``, ``pre_epoch``, ``post_epoch``."""

    def __init__(self):
        self.pipeline = None  # set by the pipeline
        self.max_epochs = None  # set by the pipeline
        self.name = None  # set by the pipeline
        self.start_time = None
        self.stop_time = None
        self.epoch_start_time = None
        self.epoch_stop_time = None
        self.current_epoch = 1
        self._stop_requested = False
        self.metric_prefix = None
        self.table = None

    @property
    def tracker(self) -> MetricTracker:
        return self.pipeline.tracker

    @property
    def logger(self):
        return self.pipeline.logger

    @property
    def config(self):
        return self.pipeline.config

    @property
    def device(self) -> torch.device:
        return self.pipeline.device

    def track_reduce(
        self,
        name: str,
        value: Any,
        step: int | None = None,
        reduction: Reduction = Reduction.MEAN,
        dim: list[int] | None = None,
        reduce_globally: bool = True,
        prefixed: bool = True,
    ):
        if prefixed and self.metric_prefix:
            name = f"{self.metric_prefix}/{name}"
        self.pipeline.track_reduce(name, value, step, reduction, dim, reduce_globally)

    def track(self, name: str, value: Any, step: int | None = None, prefixed: bool = True):
        if prefixed and self.metric_prefix:
            name = f"{self.metric_prefix}/{name}"
        self.pipeline.track(name, value, step)

    def stop_stage(self):
        """Request the epoch loop to stop after the current epoch."""
        self._stop_requested = True

    # -- hooks --------------------------------------------------------------
    def pre_stage(self):
        """Executed before the stage starts. Register models and datasets here."""

    def post_stage(self):
        """Executed after the stage finishes."""

    def pre_epoch(self):
        """Executed before each epoch."""

    def post_epoch(self):
        """Executed after each epoch, after metrics have been reduced."""

    def run_epoch(self):
        """Run one epoch. Must be implemented by subclasses."""
        raise NotImplementedError()

    def table_columns(self) -> list[str | dict[str, Any]]:
        """Progress-table columns: strings, or dicts with 'name' and 'metric'
        keys ('metric': None => updated manually)."""
        columns = [
            {"name": "Epoch", "metric": "misc/epoch"},
            {"name": "Time/Epoch", "metric": None},
        ]
        if self.max_epochs is not None:
            columns.append({"name": "ETA", "metric": None})
        return columns

    # -- lifecycle ----------------------------------------------------------
    def run(self):
        """Run until ``max_epochs`` or ``stop_stage()``."""
        self._pre_stage()
        while not self._stop_requested and (self.max_epochs is None or self.current_epoch <= self.max_epochs):
            self._pre_epoch()
            self.run_epoch()
            self._post_epoch()
        self._post_stage()

    def _pre_stage(self):
        self.start_time = datetime.now()
        self.table = ProgressTable(file=sys.stdout if is_root() else DevNullIO())
        self._setup_table()
        if len(self.pipeline.stages) > 1:
            self.logger.info(f"\n========== STAGE: {self.name} ==========")
        self.pre_stage()
        flush_log_handlers(self.logger)
        self.pipeline.barrier()

    def _post_stage(self):
        self.table.close()
        self.post_stage()
        self.pipeline.barrier()
        self.stop_time = datetime.now()
        if len(self.pipeline.stages) > 1:
            self.logger.info(f"Finished stage in {self.stop_time - self.start_time}")

    def _pre_epoch(self):
        self.epoch_start_time = datetime.now()
        self.table["Epoch"] = self.current_epoch
        self.pre_epoch()

    def _post_epoch(self):
        self.epoch_stop_time = datetime.now()
        self._reduce_metrics()
        self.post_epoch()
        self._update_table()
        self.current_epoch += 1

    def _reduce_metrics(self):
        self.track(name="misc/epoch", value=self.current_epoch, prefixed=False)
        self.track(
            name="misc/epoch_time",
            value=(self.epoch_stop_time - self.epoch_start_time).total_seconds(),
            prefixed=False,
        )
        self.tracker.next_epoch()

    def _setup_table(self):
        for column_dct in self._metrics():
            column_dct = dict(column_dct)
            display_name = column_dct.pop("name")
            column_dct.pop("metric")
            self.table.add_column(display_name, **column_dct)

    def _update_table(self):
        self.table.update("Epoch", self.current_epoch)
        self.table.update("Time/Epoch", str((datetime.now() - self.start_time) / self.current_epoch).split(".")[0])
        if self.max_epochs is not None:
            eta = (datetime.now() - self.start_time) / self.current_epoch * (self.max_epochs - self.current_epoch)
            self.table.update("ETA", str(eta).split(".")[0])
        for column_dct in self._metrics():
            metric_name = column_dct["metric"]
            if metric_name is not None and metric_name in self.tracker:
                history = self.tracker[metric_name]
                if history:
                    self.table.update(column_dct["name"], history[-1])
        self.table.next_row()

    def _metrics(self):
        metrics = []
        for column in self.table_columns():
            if isinstance(column, str):
                metrics.append({"name": column, "metric": column})
            elif isinstance(column, dict):
                if "name" not in column:
                    raise ValueError('Column dict must contain a "name" key')
                if "metric" not in column:
                    raise ValueError('Column dict must contain a "metric" key')
                metrics.append(column)
            else:
                raise ValueError(f"Invalid column: {column}. Must be a string or a dict.")
        return metrics


def _to_device(batch: Any, device: torch.device) -> Any:
    """Move a host batch (numpy arrays or tensors, possibly in a dict, list
    or tuple) onto ``device``."""
    if isinstance(batch, np.ndarray):
        return torch.from_numpy(batch).to(device, non_blocking=True)
    if isinstance(batch, torch.Tensor):
        return batch.to(device, non_blocking=True)
    if isinstance(batch, dict):
        return {k: _to_device(v, device) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(_to_device(v, device) for v in batch)
    return batch


class TrainValStage(Stage):
    """Train + validation stage around one eager step.

    Subclasses implement ``step(state, batch) -> loss`` or
    ``-> (loss, metrics_dict)``, where ``state.model`` is the registered
    module and ``batch`` is already on the pipeline's device. The stage owns
    a ``TrainState`` built from the pipeline's registered model and optimizer
    in ``_pre_stage`` (override ``make_state`` to customise).
    """

    def __init__(self):
        super().__init__()
        self.is_train = True
        self.state: TrainState | None = None
        #: accumulates the wall-clock the host spends blocked on the device;
        #: reset per epoch, published as ``misc/host_stall_ms``
        self._stall = StallTimer()
        #: the current (or last) train epoch's per-step losses, as device
        #: tensors; the loop reads one only every ``log_every()`` steps
        self.train_losses: list[torch.Tensor] = []

    # -- overridables -------------------------------------------------------
    def train_dataset(self):
        ds = self.pipeline.datasets.get("train")
        if ds is None:
            raise DatasetNotFoundError(
                'No "train" dataset found in pipeline. Use register_dataset("train", ...) to register a dataset.'
            )
        return ds

    def val_dataset(self):
        ds = self.pipeline.datasets.get("val")
        if ds is None:
            raise DatasetNotFoundError(
                'No "val" dataset found in pipeline. Use register_dataset("val", ...) to register a dataset.'
            )
        return ds

    def loss_metric_name(self) -> str:
        return "loss"

    def train_metric_prefix(self) -> str:
        return "train"

    def val_metric_prefix(self) -> str:
        return "val"

    def gradient_clip(self) -> float:
        """Global-norm clip threshold; 0 disables."""
        return 0.0

    def log_every(self) -> int:
        """Steps between host reads of a (trailing) loss inside the training
        loop; each read feeds the NaN/inf guard and the live table. 0
        disables the periodic read."""
        return 50

    def nan_guard(self) -> bool:
        """Whether the periodic read raises ``FloatingPointError`` on a
        non-finite loss."""
        return True

    def model_name(self) -> str | None:
        """Which registered model this stage trains (None = the only one)."""
        return None

    def make_state(self) -> TrainState:
        """Build the TrainState from the pipeline registries."""
        entry = self.pipeline._model_entry(self.model_name())
        opt_name = self.pipeline._optimizer_for(entry.name)
        return TrainState.create(
            model=entry.module,
            tx=self.pipeline.optimizers[opt_name],
            schedule=self.pipeline.schedulers.get(opt_name),
        )

    def step(self, state: TrainState, batch) -> Any:
        """Return ``loss`` or ``(loss, metrics_dict)`` for one batch."""
        raise NotImplementedError()

    def train_step(self, state, batch):
        return self.step(state, batch)

    def val_step(self, state, batch):
        return self.step(state, batch)

    # -- the steps ----------------------------------------------------------
    @staticmethod
    def _unpack(out) -> tuple[torch.Tensor, dict]:
        if isinstance(out, tuple):
            return out[0], dict(out[1])
        return out, {}

    def _clip_gradients(self, grads: list[torch.Tensor], clip: float) -> None:
        """Scale ``grads`` in place by ``min(1, clip * rsqrt(max(sum g^2, 1e-12)))``,
        without a host sync."""
        sq = torch.stack([torch.linalg.vector_norm(g, dtype=torch.float32) for g in grads]).square().sum()
        scale = torch.clamp(clip * torch.rsqrt(torch.clamp(sq, min=1e-12)), max=1.0)
        torch._foreach_mul_(grads, scale)

    def _train_step(self, batch) -> dict:
        state = self.state
        state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        loss, metrics = self._unpack(self.train_step(state, batch))
        loss.backward()
        clip = float(self.gradient_clip())
        if clip > 0.0:
            grads = [p.grad for p in state.model.parameters() if p.grad is not None]
            self._clip_gradients(grads, clip)
        state.apply_gradients()
        metrics[self.loss_metric_name()] = loss.detach()
        return metrics

    @torch.no_grad()
    def _val_step(self, batch) -> dict:
        self.state.model.eval()
        loss, metrics = self._unpack(self.val_step(self.state, batch))
        metrics[self.loss_metric_name()] = loss
        return metrics

    # -- lifecycle ----------------------------------------------------------
    def _pre_stage(self):
        super()._pre_stage()
        if self.state is None:
            self.state = self.make_state()

    def _pre_epoch(self):
        self._stall.reset()  # misc/host_stall_ms is a per-epoch total
        super()._pre_epoch()

    def _reduce_metrics(self):
        self.track("misc/host_stall_ms", round(self._stall.ms, 3), prefixed=False)
        super()._reduce_metrics()

    def run_epoch(self):
        self.train_epoch()
        self.val_epoch()

    def _feed(self, ds):
        device = self.device
        return (_to_device(batch, device) for batch in ds)

    def train_epoch(self):
        self.is_train = True
        self.metric_prefix = self.train_metric_prefix()
        train_ds = self.train_dataset()
        if hasattr(train_ds, "set_epoch"):
            train_ds.set_epoch(self.current_epoch)

        live = self.table.live_target() is not None
        log_every = int(self.log_every())
        guard = bool(self.nan_guard())
        loss_name = self.loss_metric_name()
        self.train_losses = []
        loss_ema = None
        steps_done = 0
        epoch_t0 = time.perf_counter()
        last_render = 0.0

        for batch in self._feed(train_ds):
            step_start = time.perf_counter_ns()
            metrics = self._train_step(batch)
            step_end = time.perf_counter_ns()
            for mname, mval in metrics.items():
                self.track_reduce(mname, mval)
            self.track_reduce("misc/total_train_batches", 1, reduction=Reduction.SUM, prefixed=False)
            self.track_reduce(
                "misc/worker_train_batches", 1, reduction=Reduction.SUM, reduce_globally=False, prefixed=False
            )
            # host enqueue time of the step, not device time (see
            # misc/train_step_avg_ms for the synchronised per-step average)
            self.track_reduce("misc/step_dispatch_ms", (step_end - step_start) / 1e6, prefixed=False)
            steps_done += 1

            loss_val = metrics.get(loss_name)
            if loss_val is not None:
                self.train_losses.append(loss_val)
            if log_every > 0 and steps_done % log_every == 0 and self.train_losses:
                # two steps behind: already computed, so the read barely waits
                v = self._stall.fetch(self.train_losses[max(0, len(self.train_losses) - 3)])
                loss_ema = v if loss_ema is None else 0.98 * loss_ema + 0.02 * v
                if guard and not np.isfinite(v):
                    raise FloatingPointError(
                        f"non-finite loss ({v}) detected at step {steps_done} of epoch "
                        f"{self.current_epoch} (stage {self.name!r})"
                    )
            if live:
                now = time.perf_counter()
                if now - last_render > 0.25:
                    self.table.live(
                        {"Epoch": self.current_epoch, "[Train] Loss": loss_ema,
                         "it/s": steps_done / max(now - epoch_t0, 1e-9)}
                    )
                    last_render = now

        # the epoch's one sync point: every queued step has run past this line
        self._stall.block(self.device)
        train_elapsed = time.perf_counter() - epoch_t0
        if steps_done:
            self.track("misc/train_step_avg_ms", train_elapsed / steps_done * 1e3, prefixed=False)
        self.table["it/s"] = steps_done / max(train_elapsed, 1e-9)
        step_count = self.state.step if self.state is not None else 0
        for name, schedule in self.pipeline.schedulers.items():
            self.track(f"misc/lr_{name}", float(schedule(step_count)), prefixed=False)

    def val_epoch(self):
        self.is_train = False
        self.metric_prefix = self.val_metric_prefix()
        try:
            val_ds = self.val_dataset()
        except DatasetNotFoundError:
            return  # validation is optional
        batches = 0
        for batch in self._feed(val_ds):
            metrics = self._val_step(batch)
            for mname, mval in metrics.items():
                self.track_reduce(mname, mval)
            self.track_reduce("misc/total_val_batches", 1, reduction=Reduction.SUM, prefixed=False)
            self.track_reduce(
                "misc/worker_val_batches", 1, reduction=Reduction.SUM, reduce_globally=False, prefixed=False
            )
            batches += 1
        if batches:
            self._stall.block(self.device)

    def table_columns(self):
        columns = super().table_columns()
        columns.insert(1, {"name": "[Train] Loss", "metric": f"{self.train_metric_prefix()}/{self.loss_metric_name()}"})
        columns.insert(2, {"name": "[Val] Loss", "metric": f"{self.val_metric_prefix()}/{self.loss_metric_name()}"})
        columns.insert(3, {"name": "it/s", "metric": None})
        return columns
