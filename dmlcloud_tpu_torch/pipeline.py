"""TrainingPipeline: the experiment orchestrator.

Counterpart of ``dmlcloud_tpu/pipeline.py`` (``TrainingPipeline`` :53):
config container, registries for models, optimizers, schedules, datasets and
stages (``register_model`` :210, ``register_optimizer`` :268,
``register_dataset`` :278, ``append_stage`` :296) and the run lifecycle
(``run`` :561) with its run-start diagnostics. Where the JAX pipeline owns a
device mesh, this one owns one ``torch.device`` (``cuda`` unless the caller
passes another; no card and no explicit CPU request raises).

Checkpointing, wandb, tensorboard, preemption handling and meshes over many
GPUs come in later slices.
"""

from __future__ import annotations

import logging
import re
from contextlib import contextmanager
from dataclasses import dataclass
from datetime import datetime
from typing import Any, Callable, Optional

import torch

from .metrics import MetricTracker, Reduction
from .parallel import runtime
from .stage import Stage
from .utils.config import Config, as_config
from .utils.logging import add_log_handlers, experiment_header, general_diagnostics


@dataclass
class ModelEntry:
    name: str
    module: torch.nn.Module


class TrainingPipeline:
    def __init__(self, config: Any = None, name: Optional[str] = None, device: str | torch.device | None = None):
        self.config: Config = as_config(config)
        self.name = name
        self.device = runtime.resolve_device(device)
        self.logger = logging.getLogger("dmlcloud_tpu_torch")
        self.tracker = MetricTracker()
        self.start_time = None
        self.stop_time = None
        self.current_stage = None

        self.stages: list[Stage] = []
        self.datasets: dict[str, Any] = {}
        self.models: dict[str, ModelEntry] = {}
        self.optimizers: dict[str, Callable] = {}
        self.schedulers: dict[str, Callable[[int], float]] = {}
        self._optimizer_model: dict[str, str | None] = {}

    # ----------------------------------------------------------- registries
    def register_model(self, name: str, model: torch.nn.Module, verbose: bool = True):
        """Register a module; its parameters are moved to the pipeline's device."""
        if name in self.models:
            raise ValueError(f"Model with name {name} already exists")
        if not isinstance(model, torch.nn.Module):
            raise ValueError("register_model needs a torch.nn.Module")
        model.to(self.device)
        self.models[name] = ModelEntry(name=name, module=model)
        if verbose:
            n_params = sum(p.numel() for p in model.parameters())
            self.logger.info(f'Model "{name}":\n    - Parameters: {n_params / 1e6:.1f} M\n    - Device: {self.device}')

    def register_optimizer(self, name: str, optimizer: Callable, scheduler=None, model: str | None = None):
        """Register an optimizer factory (``optim.adamw(...)``, bound to the
        model's parameters when the stage builds its state) and optionally
        its schedule, for ``misc/lr_<name>`` tracking."""
        if name in self.optimizers:
            raise ValueError(f"Optimizer with name {name} already exists")
        self.optimizers[name] = optimizer
        self._optimizer_model[name] = model
        if scheduler is not None:
            self.schedulers[name] = scheduler

    def register_dataset(self, name: str, dataset: Any, verbose: bool = True):
        """Register a per-process dataset under ``name`` ('train'/'val' are
        the names TrainValStage looks up). Any iterable of batches works."""
        if name in self.datasets:
            raise ValueError(f"Dataset with name {name} already exists")
        self.datasets[name] = dataset
        if verbose:
            try:
                per_worker: Any = len(dataset)
                total: Any = f"~{per_worker * runtime.world_size()}"
            except TypeError:
                per_worker = total = "unknown"
            self.logger.info(
                'Dataset "%s": %s batches/worker, %s total across %d processes',
                name, per_worker, total, runtime.world_size(),
            )

    def append_stage(self, stage: Stage, max_epochs: Optional[int] = None, name: Optional[str] = None):
        if not isinstance(stage, Stage):
            raise ValueError("stage must be a Stage object")
        stage.pipeline = self
        stage.max_epochs = max_epochs
        existing = {s.name for s in self.stages}
        if name is not None:
            if not re.fullmatch(r"[A-Za-z0-9._-]+", name) or name in (".", ".."):
                raise ValueError(f"Stage name {name!r} is invalid: must match [A-Za-z0-9._-]+")
            if name in existing:
                raise ValueError(f"Stage with name {name!r} already exists")
            stage.name = name
        else:
            base = type(stage).__name__
            unique, i = base, 2
            while unique in existing:
                unique, i = f"{base}_{i}", i + 1
            stage.name = unique
        self.stages.append(stage)

    def _model_entry(self, name: str | None = None) -> ModelEntry:
        if name is not None:
            if name not in self.models:
                raise ValueError(f"No model named {name!r} registered")
            return self.models[name]
        if len(self.models) == 1:
            return next(iter(self.models.values()))
        if not self.models:
            raise ValueError("No model registered. Call register_model() (e.g. in pre_stage).")
        raise ValueError("Multiple models registered; override Stage.model_name() to pick one.")

    def _optimizer_for(self, model_name: str) -> str:
        """Name of the optimizer that trains ``model_name``."""
        if not self.optimizers:
            raise ValueError("No optimizer registered. Call register_optimizer() (e.g. in pre_stage).")
        explicit = [n for n, m in self._optimizer_model.items() if m == model_name]
        if len(explicit) > 1:
            raise ValueError(
                f"Multiple optimizers ({explicit}) registered for model {model_name!r}; "
                "a model can only be trained by one optimizer per stage."
            )
        if explicit:
            return explicit[0]
        unbound = [n for n, m in self._optimizer_model.items() if m is None]
        if len(unbound) > 1 and len(self.models) > 1:
            raise ValueError(
                f"Multiple unbound optimizers ({unbound}) and multiple models registered; "
                "pass model=... to register_optimizer() to bind each optimizer to its model."
            )
        if unbound:
            return unbound[0]
        raise ValueError(f"No optimizer registered for model {model_name!r} and no unbound optimizer to fall back on.")

    # -------------------------------------------------------------- metrics
    def track_reduce(
        self,
        name: str,
        value: Any,
        step: int | None = None,
        reduction: Reduction = Reduction.MEAN,
        dim: list[int] | None = None,
        reduce_globally: bool = True,
    ):
        """Buffer ``value`` under an epoch-end reduction (registered on first use)."""
        if name not in self.tracker:
            self.tracker.register_metric(name, reduction, dim, reduce_globally)
        self.tracker.track(name, value)

    def track(self, name: str, value: Any, step: int | None = None):
        """Record an already-final, process-local value for the current epoch."""
        if name not in self.tracker:
            self.tracker.register_metric(name)
        self.tracker.track(name, value)

    def barrier(self):
        runtime.barrier()

    # ------------------------------------------------------------ lifecycle
    def run(self):
        """Run all registered stages sequentially."""
        with _run_guard(self):
            self._pre_run()
            for stage in self.stages:
                self.current_stage = stage
                stage.run()
            self._post_run()

    def pre_run(self):
        pass

    def post_run(self):
        pass

    def _pre_run(self):
        if len(self.stages) == 0:
            raise ValueError("No stages defined. Use append_stage() to add stages to the pipeline.")
        if not runtime.is_initialized():
            runtime.init_auto(self.device)
        self.barrier()
        self.start_time = datetime.now()
        add_log_handlers(self.logger)
        self.logger.info("\n" + experiment_header(self.name, None, self.start_time))
        diagnostics = general_diagnostics()
        diagnostics += "\n* RUNTIME:\n"
        diagnostics += f"    - device: {self.device}\n"
        diagnostics += f"    - processes: {runtime.world_size()} (rank {runtime.rank()})"
        diagnostics += "\n* CONFIG:\n"
        diagnostics += "\n".join(f"    {line}" for line in self.config.to_yaml(resolve=True).splitlines())
        self.logger.info(diagnostics)
        self.pre_run()

    def _post_run(self):
        self.stop_time = datetime.now()
        self.logger.info(f"Finished training in {self.stop_time - self.start_time} ({self.stop_time})")
        self.post_run()

    def _teardown(self, exc: BaseException | None) -> None:
        if isinstance(exc, KeyboardInterrupt):
            self.logger.info("=== run aborted by user (KeyboardInterrupt) ===")
        elif exc is not None:
            self.logger.error("=== run failed; traceback follows ===", exc_info=exc)


@contextmanager
def _run_guard(pipeline: TrainingPipeline):
    try:
        yield
    except BaseException as exc:
        pipeline._teardown(exc)
        raise
    else:
        pipeline._teardown(None)
