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
  ``misc/step_dispatch_ms``, ``misc/train_step_avg_ms``, ``misc/host_stall_ms``,
  ``misc/lr_<name>`` and, with ``step_flops()``, ``misc/mfu``;
- ``deferred_metrics()``: ``False`` reads every step's metrics to the host
  (the eager path the reference keeps for bisection) and runs the NaN guard
  every step;
- gradient accumulation (stage.py:419, :733-780 of the reference): the batch
  is split along dim 0 into ``gradient_accumulation()`` microbatches run one
  after another, each mean loss backpropagated unscaled, the gradients summed
  in fp32 and divided once at the end, then one clip, one optimizer update
  and one EMA update;
- the feed: ``data.device_iterator`` with ``prefetch_depth()`` pinned copies
  in flight on a copy stream and optionally ``host_prefetch()`` batches read
  on a background thread (a pipeline that ends in ``to_device`` feeds itself);
- data parallelism (the reference's ``sharding="replicate"``): at world
  size > 1 every process runs the step on its own per-rank batch and the
  gradients are averaged over the processes after the backward (and the
  microbatch divide), before the clip;
- sharded models (``register_model`` on a mesh, ``parallel.mesh``): FSDP2
  reduces the gradients itself (with no sync on the microbatches before the
  last), a ``data`` x ``model`` mesh averages the local shards over the data
  sub-group, the clip takes the global norm over the shards (replicas once),
  the EMA and validation on it run on the shards, and the first batch is
  checked to be the same on tensor- and sequence-parallel peers (``model``,
  ``seq``);
- validation under ``torch.no_grad()``;
- the EMA shadow (``ema_decay``), updated after each optimizer step and used
  by validation (``val_with_ema``) through ``torch.func.functional_call``,
  without a copy of the weights;
- checkpointing (stage.py:809-1459 of the reference): epoch saves under the
  stage's scope, step saves every ``checkpoint_every_steps()`` steps under
  ``<name>.steps`` with the coordinated preemption poll, JSON resume sidecars
  under ``meta/<scope>/``, and restore at stage start of a resumed pipeline,
  mid-epoch included: a train dataset with an iterator state
  (``DataPipeline.state_dict``, saved in the step sidecar as ``"data"``)
  fast-forwards from it, any other skips the consumed batches (neither is run
  nor copied to the device);
- the flight recorder's side (``TrainingPipeline(telemetry=...)``):
  ``stage``, ``epoch``, ``step_dispatch`` and ``data_wait`` spans, and the
  goodput buckets ``misc/data_wait_ms``, ``misc/ckpt_ms``, ``misc/goodput``,
  ``misc/pad_fraction`` and ``misc/shard_reader``.

- the compiled step (stage.py:497-534, :887-1003, :1105-1115 of the
  reference; ``compile/``), armed by ``precompile()`` or ``buckets()``: the
  step runs as ``torch.compile`` regions (Inductor, static shapes, no graph
  breaks) — the user's forward and loss, whose backward AOTAutograd
  compiles, and the clip, the optimizer update and the EMA, one fused call
  per parameter (one graph per parameter shape) — with the data-parallel
  gradient average between them, eager; the validation step is a third. ``precompile()`` warms them in a timed phase at stage start
  (``misc/compile_ms``) on zeros of the batch spec, leaving the state as it
  was; ``buckets()`` pads ragged batches to a fixed set of sizes;
  ``misc/recompiles`` counts signatures that compiled mid-run. Without either
  the step is the eager one above. On a mesh whose parameters are DTensors
  (``fsdp``, ``model``, ``expert``) the region's boundary is the model's block
  (``fsdp_blocks()``, else the whole module): FSDP2's per-block all-gather and
  reshard hooks run eagerly between the compiled blocks, the blocks run their
  ``model``/``expert`` collectives as functional ones inside the region, the
  clip's global norm sums its per-shard norms over the mesh between the
  regions, and the update region runs on each parameter's local shard.

- quantized training (stage.py:318-333, :409-416, :638-645, :674-716 of the
  reference): ``TrainValStage(precision="int8")`` (or a ``precision()``
  override) runs the train forward's matched dense layers through
  ``models.quant.quant_train_dot`` with a per-channel scale delayed by one
  step. ``make_state`` seeds the amax from the initial weights into a
  persistent ``quant_amax`` buffer of each layer (so it rides the
  checkpoint's ``"extras"``); after every update it is refreshed from the
  updated weights, once per step whatever the microbatch count. The
  optimizer, the EMA and checkpoints see plain fp32 parameters, and
  validation runs at full precision. On a mesh (``fsdp``, ``model``, ``seq``)
  the amax is the whole weight's, max-reduced over the shards
  (``models/quant.py``).

Compiled steps on a ``seq`` or ``pipe`` axis, int8 training on a ``pipe``
axis, and the lint/verify/sanitize arms come in later slices.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import sys
import time
from datetime import datetime
from typing import Any

import numpy as np
import torch

from . import checkpoint as ckpt_lib
from .data import store as _shard_store
from .data.datasets import DataPipeline
from .data.device import device_iterator
from .metrics import MetricTracker, Reduction
from .parallel import runtime
from .parallel.data_parallel import all_reduce_gradients
from .parallel.mesh import DATA, PIPE, SEQ, grad_sq_norm, sharding_record
from .parallel.runtime import is_root
from .parallel.tensor_parallel import local_tensor
from .telemetry import journal as _journal
from .train_state import TrainState, ema_like, ema_weight
from .utils.logging import DevNullIO, flush_log_handlers
from .utils.profiling import StallTimer, device_kind, peak_flops_for_kind
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
        self._preempt_exit = False
        self.metric_prefix = None
        self.table = None
        #: seconds the stage-start and stage-end barriers wait (None: the
        #: pipeline's default)
        self.barrier_timeout = None
        self._stage_span_t0 = 0.0
        self._epoch_span_t0 = 0.0

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

    @property
    def mesh(self):
        """The pipeline's ``DeviceMesh`` (None without ``set_mesh`` or a
        registered model on more than one process)."""
        return self.pipeline.mesh

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
        """Run until ``max_epochs`` or ``stop_stage()``. A restored
        ``_stop_requested`` (the stage had stopped before the interruption)
        skips the loop entirely; a coordinated preemption exits early without
        marking the stage stopped, so a resumed run continues it."""
        self._pre_stage()
        while not self._stop_requested and (self.max_epochs is None or self.current_epoch <= self.max_epochs):
            self._pre_epoch()
            self.run_epoch()
            if getattr(self, "_mid_epoch_exit", False):
                # a step save persisted the state and a coordinated preemption
                # cut the epoch short: exit WITHOUT _post_epoch, so the partial
                # epoch neither reduces metrics nor counts as complete
                self._preempt_exit = True
                self.logger.info(
                    f"preemption requested; stage {self.name!r} exiting cleanly mid-epoch "
                    f"{self.current_epoch} (state saved at the last step boundary; resumable)"
                )
                break
            # decided BEFORE _post_epoch, so its save treats this epoch as final
            self._preempt_exit = self.pipeline._preemption_coordinated()
            self._post_epoch()
            if self._preempt_exit:
                self.logger.info(
                    f"preemption requested; stage {self.name!r} exiting cleanly after epoch "
                    f"{self.current_epoch - 1} (resumable)"
                )
                break
        self._post_stage()

    def _pre_stage(self):
        self.start_time = datetime.now()
        self._stage_span_t0 = _journal.now()
        self.table = ProgressTable(file=sys.stdout if is_root() else DevNullIO())
        self._setup_table()
        if len(self.pipeline.stages) > 1:
            self.logger.info(f"\n========== STAGE: {self.name} ==========")
        self.pre_stage()
        flush_log_handlers(self.logger)
        self.pipeline.barrier(self.barrier_timeout)

    def _post_stage(self):
        self.table.close()
        self.post_stage()
        self.pipeline.barrier(self.barrier_timeout)
        self.stop_time = datetime.now()
        _journal.emit("stage", self._stage_span_t0, label=self.name, epochs=self.current_epoch - 1)
        if len(self.pipeline.stages) > 1:
            self.logger.info(f"Finished stage in {self.stop_time - self.start_time}")

    def _pre_epoch(self):
        self.epoch_start_time = datetime.now()
        self._epoch_span_t0 = _journal.now()
        self.table["Epoch"] = self.current_epoch
        self.pre_epoch()

    def _post_epoch(self):
        self.epoch_stop_time = datetime.now()
        _journal.emit("epoch", self._epoch_span_t0, label=self.name, epoch=self.current_epoch)
        self._reduce_metrics()
        self.post_epoch()
        self.pipeline._post_epoch()
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


def _split_batch(batch: Any, accum: int) -> list:
    """``batch`` as ``accum`` microbatches: every tensor leaf (in a dict, tuple
    or list) split along dim 0 into equal views, other leaves shared. Raises
    ``ValueError`` before anything runs when a leaf's dim 0 is not divisible."""

    def check(x):
        if isinstance(x, torch.Tensor):
            if x.dim() == 0 or x.shape[0] % accum:
                n = x.shape[0] if x.dim() else "a scalar"
                raise ValueError(f"gradient_accumulation()={accum} must divide the batch dimension, got {n}")
        elif isinstance(x, dict):
            for v in x.values():
                check(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                check(v)

    def part(x, i):
        if isinstance(x, torch.Tensor):
            return x.chunk(accum)[i]
        if isinstance(x, dict):
            return {k: part(v, i) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(part(v, i) for v in x)
        return x

    check(batch)
    return [part(batch, i) for i in range(accum)]


class _Reparametrized:
    """``module`` called with ``tensors`` in place of its parameters
    (``torch.func.functional_call``), neither side copied; a submodule reads
    its parameters from ``tensors`` too (``model.lm_head.weight``), any other
    attribute is the module's."""

    def __init__(self, module: torch.nn.Module, tensors: dict[str, torch.Tensor]):
        self.module = module
        self.tensors = tensors

    def __call__(self, *args, **kwargs):
        return torch.func.functional_call(self.module, self.tensors, args, kwargs)

    def __getattr__(self, name):
        if name in self.tensors:
            return self.tensors[name]
        attr = getattr(self.module, name)
        if isinstance(attr, torch.nn.Module):
            prefix = name + "."
            return _Reparametrized(attr, {k[len(prefix):]: v for k, v in self.tensors.items() if k.startswith(prefix)})
        return attr


@torch.no_grad()
def _swap_in(params: list[torch.Tensor], values: list[torch.Tensor]) -> list[torch.Tensor]:
    """Copy ``values`` into the local shards of ``params`` (cast to their
    dtypes) and return what the shards held before."""
    saved = []
    for p, v in zip(params, values):
        p = local_tensor(p)
        saved.append(p.clone())
        p.copy_(local_tensor(v))
    return saved


def _reshard(module: torch.nn.Module) -> None:
    """Free FSDP2's gathered parameters: the root keeps them from a forward to
    its backward, which a forward under ``no_grad`` never runs."""
    from torch.distributed.fsdp import FSDPModule

    for m in module.modules():
        if isinstance(m, FSDPModule):
            m.reshard()


class TrainValStage(Stage):
    """Train + validation stage around one eager step.

    Subclasses implement ``step(state, batch) -> loss`` or
    ``-> (loss, metrics_dict)``, where ``state.model`` is the registered
    module and ``batch`` is already on the pipeline's device. The stage owns
    a ``TrainState`` built from the pipeline's registered model and optimizer
    in ``_pre_stage`` (override ``make_state`` to customise).
    """

    def __init__(self, precision: str = "full"):
        super().__init__()
        if precision not in ("full", "int8"):
            raise ValueError(f'precision must be "full" or "int8", got {precision!r}')
        self._precision = str(precision)
        #: the dense layers the train forward quantizes (``precision() == "int8"``)
        self._quant_layers: list = []
        self.is_train = True
        self.state: TrainState | None = None
        #: accumulates the wall-clock the host spends blocked on the device
        #: or on checkpoint saves; reset per epoch, published as
        #: ``misc/host_stall_ms``
        self._stall = StallTimer()
        #: the current (or last) train epoch's per-step losses, as device
        #: tensors; the loop reads one only every ``log_every()`` steps
        self.train_losses: list[torch.Tensor] = []
        #: batches of the CURRENT epoch to skip on a mid-epoch resume
        #: (one-shot, set by _restore_state from a step-save sidecar, already
        #: scaled to this run's data-parallel layout)
        self._resume_skip_steps = 0
        #: the train dataset's iterator state from that sidecar (one-shot):
        #: preferred to the batch skip when the dataset can load it
        self._resume_data_state: dict | None = None
        #: wall-clock of the most recent state save: the preemption verdict's
        #: save-on-preempt latency
        self._last_save_latency_s: float | None = None
        #: set when a preemption poll at a step save cut the epoch short:
        #: run_epoch skips validation and Stage.run exits without treating the
        #: partial epoch as complete
        self._mid_epoch_exit = False
        #: True exactly while the step loop of train_epoch runs: the window in
        #: which no metric is read to the host under ``deferred_metrics()``
        self._in_step_loop = False
        #: goodput accounting (telemetry armed only): ns the host spent in the
        #: feed's next() this epoch, and the padding and token slots of its
        #: host batches (``misc/pad_fraction``)
        self._gp_data_wait_ns = 0
        self._gp_pad_slots = 0
        self._gp_token_slots = 0
        #: ``data.store.reader_activity()`` at the epoch's start (``misc/shard_reader``)
        self._gp_reader_mark = 0
        self._warned_mfu_peak = False
        #: how the trained model is laid out on the mesh (``MeshPlan``; None:
        #: replicated over the default mesh)
        self._plan = None
        #: what a save's sharding sidecar records of the model (``mesh.sharding_record``)
        self._sharding = None
        self._batch_checked = False
        #: the compiled step (compile/): signature registries over the train
        #: and val steps, and the ``torch.compile`` regions they run, when
        #: precompile()/buckets() are armed; else None, and the step is eager
        self._train_compiled = None
        self._val_compiled = None
        self._train_guard = None
        self._train_fwd = None
        self._update_fn = None
        self._val_fwd = None
        self._sq_norm_fn = None
        self._opt_update = None
        #: puts back the plain forwards of a mesh plan's compiled blocks
        self._restore_blocks = None
        self._buckets_resolved: tuple[int, ...] | None = None
        #: gradient_clip() and ema_decay(), read once for the compiled update
        self._clip = 0.0
        self._decay = 0.0
        #: FLOPs of one step counted during precompile (the MFU fallback)
        self._cost_flops: float | None = None

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

    def precision(self) -> str:
        """Matmul precision of the train step: ``"full"`` (the model's own
        dtype) or ``"int8"`` (quantized training, ``models/quant.py``). A knob
        method like its neighbours: a subclass may override it instead of
        passing the constructor's argument."""
        return self._precision

    def gradient_accumulation(self) -> int:
        """Microbatches per optimizer step (1 disables). Each batch is split
        along dim 0 into that many equal microbatches (tensors in a dict,
        tuple or list are split alike; other leaves go to every microbatch),
        which run one after another: each microbatch's mean loss is
        backpropagated unscaled, the gradients are summed in fp32 and divided
        by the count once at the end, as the reference does. Losses and step
        metrics are averaged in fp32, so ``step`` should return mean-reduced
        values. In-place module buffers see the microbatches in order. Clip,
        the optimizer update and the EMA update then run once, and
        ``state.step`` and ``misc/total_train_batches`` count one step."""
        return 1

    def step_flops(self) -> float:
        """FLOPs of one optimizer step over all processes (forward and
        backward of the global batch; a multiply-add counts as 2). A positive
        value makes the stage track ``misc/mfu`` each epoch, ``flops * steps /
        train_elapsed / (peak * world_size)``, against the card's dense bf16
        peak (``utils.profiling.PEAK_BF16_FLOPS``); a device without an entry
        there (the CPU) gets a warning and no metric. 0 (default) disables.
        Rule of thumb for a transformer: ``6 * params * tokens per batch``."""
        return 0.0

    def precompile(self) -> bool:
        """Whether to compile the train/val steps and warm them at stage start
        (``compile/aot.py``): the step runs under ``torch.compile`` (Inductor,
        ``fullgraph=True``, static shapes), and the compile cost lands in a
        timed precompile phase BEFORE the data loop (``misc/compile_ms``), so
        shape mismatches error at stage start instead of step 1. The batch
        signature comes from ``batch_spec()`` or, by default, from peeking the
        first batch's shapes/dtypes (one signature per bucket when
        ``buckets()`` is set). Default: the pipeline's ``precompile=`` flag
        (False)."""
        return bool(getattr(self.pipeline, "_precompile", False))

    def buckets(self):
        """Batch-dim bucket sizes for ragged batches, ascending (e.g.
        ``(8, 32, 128)`` with 128 the full batch size), or None to disable.
        Every host batch is padded up to the smallest fitting bucket before
        the device transfer — mapping batches gain a zero-weight
        ``bucket_mask_key()`` leaf (reduce per-sample losses with
        ``compile.masked_mean`` to keep the math identical) — so the
        compiled-signature count is bounded by ``len(buckets)`` instead of
        growing with the data (``misc/recompiles`` tracks growth events per
        epoch). Arming it compiles the step as ``precompile()`` does, without
        the warm-up phase. Default: the pipeline's ``buckets=`` flag (None)."""
        return getattr(self.pipeline, "_buckets", None)

    def bucket_mask_key(self) -> str:
        """Key under which bucketing injects the padding mask into mapping
        batches (1.0 real row / 0.0 padded row)."""
        from .compile.buckets import DEFAULT_MASK_KEY

        return DEFAULT_MASK_KEY

    def batch_spec(self):
        """Declared abstract spec of one HOST train batch of this process (a
        pytree of ``compile.aot.TensorSpec`` — or of example arrays —
        matching what the train dataset yields). None (default) peeks the
        first batch instead; declare it when the dataset is a one-shot
        iterator or when you want stage-start validation against an explicit
        contract."""
        return None

    def device_prefetch(self) -> int:
        """Batches whose host-to-device copies are in flight ahead of the step
        (``data.device_iterator``): 2 (default) overlaps the copy of batch
        N+1 with step N; 0 copies each batch when the step asks for it."""
        return 2

    def prefetch_depth(self) -> int:
        """The reference's name for the device prefetch depth; defaults to
        ``device_prefetch()``, so overrides of either work."""
        return int(self.device_prefetch())

    def host_prefetch(self) -> int:
        """Host batches read ahead on a background thread before the copies
        (0, the default, reads them on the training thread)."""
        return 0

    def deferred_metrics(self) -> bool:
        """Whether per-step metrics stay on the device until the epoch-end
        reduction (default True; the loop then reads a trailing loss only
        every ``log_every()`` steps). False reads every step's metrics to the
        host under ``StallTimer`` (``metric_readback``) and runs the NaN guard
        every step: the same epoch values, more host stalls."""
        return True

    def ema_decay(self) -> float:
        """Per-step decay of an exponential moving average of the parameters,
        kept as an fp32 shadow on the state and updated after every optimizer
        step; 0 disables, typical values are 0.999-0.9999. Validation runs on
        the average (``val_with_ema``), and the shadow rides checkpoints and
        resume like the rest of the state."""
        return 0.0

    def val_with_ema(self) -> bool:
        """Whether validation sees the EMA parameters instead of the raw ones
        (only meaningful when ``ema_decay() > 0``)."""
        return True

    def log_every(self) -> int:
        """Steps between host reads of a (trailing) loss inside the training
        loop when ``deferred_metrics()`` is on; each read feeds the NaN/inf
        guard and the live table. 0 disables the periodic read."""
        return 50

    def nan_guard(self) -> bool:
        """Whether a non-finite loss raises ``FloatingPointError``: at the
        periodic read under deferred metrics, at every step under eager ones."""
        return True

    def segment_ids_of(self, batch) -> np.ndarray | None:
        """The segment ids of a HOST batch (0 marks padding), for
        ``misc/pad_fraction`` when telemetry is armed: by default the
        ``"segment_ids"`` entry of a dict batch, the reference's contract.
        Override for other layouts; None counts nothing."""
        return batch.get("segment_ids") if isinstance(batch, dict) else None

    def async_checkpoint(self) -> bool:
        """Whether this stage's saves commit on a background writer (the call
        costs one copy of the state to host memory; default True). At most
        one save per scope is in flight, and the waits at stage end, run end
        and preemption exit make every save durable before the process goes
        away, so resume behaves as with synchronous saves."""
        return True

    def checkpoint_every(self) -> int:
        """Epochs between automatic state saves (0 disables). Active only
        when ``pipeline.enable_checkpointing()`` was called. A resumed
        pipeline continues bit-for-bit: parameters, optimizer state, step,
        EMA, metric histories and the epoch counter are restored."""
        return 1

    def checkpoint_every_steps(self) -> int:
        """Steps between mid-epoch state saves (0 disables, the default).
        Every N steps the full state is saved under the ``<name>.steps`` scope
        (newest only), the preemption flag is polled, so a preempted run exits
        within N steps, and a resume whose step save is fresher than the last
        completed epoch continues MID-epoch by skipping the consumed batches
        of the train dataset, whose per-epoch order must be deterministic.
        The resumed epoch's metrics cover only the steps after the resume."""
        return 0

    def checkpoint_keep(self) -> int:
        """How many epoch saves the stage keeps."""
        return 3

    def checkpoint_best_metric(self) -> str | None:
        """Tracker metric (e.g. ``'val/loss'``) ranking which epoch saves to
        KEEP: the best ``checkpoint_keep()`` by this metric, plus always the
        newest. None (default) keeps the most recent."""
        return None

    def checkpoint_best_mode(self) -> str:
        """'min' (e.g. losses) or 'max' (e.g. accuracies)."""
        return "min"

    def model_name(self) -> str | None:
        """Which registered model this stage trains (None = the only one)."""
        return None

    def make_state(self) -> TrainState:
        """Build the TrainState from the pipeline registries. At
        ``precision() == "int8"`` it seeds the delayed amax from the initial
        weights (step 1 quantizes with them, every later step with the
        previous step's updated ones)."""
        entry = self.pipeline._model_entry(self.model_name())
        opt_name = self.pipeline._optimizer_for(entry.name)
        if self.precision() == "int8":
            from .models.quant import _seed_quant_training

            self._quant_layers = _seed_quant_training(entry.module)
        return TrainState.create(
            model=entry.module,
            tx=self.pipeline.optimizers[opt_name],
            schedule=self.pipeline.schedulers.get(opt_name),
            ema=float(self.ema_decay()) > 0.0,
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
        if not isinstance(out, tuple):
            return out, {}
        if len(out) == 3:
            raise TypeError(
                "step() returned a 3-tuple (loss, metrics, new_extras): the reference threads auxiliary state "
                "through the step's return value, but here the auxiliary state is the module's in-place buffers "
                "(e.g. BatchNorm running stats), which step() updates as it runs; return (loss, metrics)"
            )
        if len(out) != 2:
            raise TypeError(f"step() must return loss or (loss, metrics), got a {len(out)}-tuple")
        return out[0], dict(out[1])

    def _clip_gradients(self, grads: list[torch.Tensor], clip: float) -> None:
        """Scale ``grads`` in place by ``min(1, clip * rsqrt(max(sum g^2, 1e-12)))``,
        without a host sync. The fp32 scale is rounded to each gradient's dtype
        before the multiply, as the reference's ``scale.astype(g.dtype)``. On a
        sharded model ``sum g^2`` is the global one over the shards, replicas
        counted once (``parallel.mesh.grad_sq_norm``)."""
        sq = grad_sq_norm(grads)
        scale = torch.clamp(clip * torch.rsqrt(torch.clamp(sq, min=1e-12)), max=1.0)
        by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
        for g in grads:
            by_dtype.setdefault(g.dtype, []).append(local_tensor(g))
        for dtype, group in by_dtype.items():
            torch._foreach_mul_(group, scale.to(dtype))

    def _backward(self, batch, accum: int) -> tuple[torch.Tensor, dict]:
        """Leave the step's gradients on the parameters (``p.grad``) and return
        its loss and metrics: one forward and backward, or ``accum``
        microbatches whose gradients are summed in fp32 and divided by
        ``accum`` once at the end (the reference's ``_accumulate``). An fp32
        parameter's ``p.grad`` is that fp32 sum itself (autograd adds into
        it); any other dtype gets an fp32 accumulator and is cast back after
        the division. At world size > 1 the gradients are then averaged over
        the data-parallel processes (FSDP2 has done so in the backward), before
        the clip sees them, as the reference's global mean gradient is."""
        state = self.state
        if accum == 1:
            loss, metrics = self._forward(batch)
            loss.backward()
        else:
            loss, metrics = self._accumulate(batch, accum)
        plan = self._plan
        if plan is None:
            all_reduce_gradients(state.model.parameters())
        elif not plan.fsdp and plan.dp_size > 1:
            all_reduce_gradients(state.model.parameters(), group=plan.grad_group)
        return loss, metrics

    def _forward(self, batch) -> tuple[torch.Tensor, dict]:
        """The user's forward and loss: the compiled region when armed; the
        quantized layers quantize inside it (``precision() == "int8"``)."""
        with self._quant_training():
            if self._train_fwd is not None:
                return self._train_fwd(batch)
            return self._forward_loss(batch)

    @contextlib.contextmanager
    def _quant_training(self):
        layers = self._quant_layers
        for m in layers:
            m.quant_train = True
        try:
            yield
        finally:
            for m in layers:
                m.quant_train = False

    def _forward_loss(self, batch) -> tuple[torch.Tensor, dict]:
        return self._unpack(self.train_step(self.state, batch))

    def _accumulate(self, batch, accum: int) -> tuple[torch.Tensor, dict]:
        state = self.state
        micro = _split_batch(batch, accum)
        low = [p for p in state.model.parameters() if p.requires_grad and p.dtype != torch.float32]
        acc: dict[torch.nn.Parameter, torch.Tensor] = {}
        loss_sum, metric_sums = None, {}
        fsdp = self._plan is not None and self._plan.fsdp
        for i, mb in enumerate(micro):
            if fsdp:
                # FSDP2 keeps the unsharded gradients summing until the last
                # microbatch, whose backward reduce-scatters the sum once
                state.model.set_requires_gradient_sync(i == accum - 1)
            loss, metrics = self._forward(mb)
            loss.backward()
            for p in low:
                if p.grad is not None:
                    g = p.grad.float()
                    acc[p] = g if p not in acc else acc[p].add_(g)
                    p.grad = None
            # fp32 sums, as the reference's scan carries them
            loss = loss.detach().float()
            loss_sum = loss if loss_sum is None else loss_sum + loss
            for name, value in metrics.items():
                value = torch.as_tensor(value).detach().float()
                metric_sums[name] = value if name not in metric_sums else metric_sums[name] + value
        with torch.no_grad():
            for p in state.model.parameters():
                if p in acc:
                    p.grad = acc[p].div_(accum).to(p.dtype)
                elif p.grad is not None:
                    local_tensor(p.grad).div_(accum)
        return loss_sum / accum, {name: v / accum for name, v in metric_sums.items()}

    def _check_peer_batches(self, batch) -> None:
        """Tensor- and sequence-parallel peers must feed the same batch: their
        collectives would mix different batches silently. Compares a checksum
        of the first batch over the ``model`` x ``seq`` group (one host sync,
        once per stage)."""
        self._batch_checked = True
        plan = self._plan
        if plan is None or plan.peer_group is None:
            return
        leaves = []

        def collect(x):
            if isinstance(x, torch.Tensor):
                leaves.append(x.detach().reshape(-1).double())
            elif isinstance(x, dict):
                for v in x.values():
                    collect(v)
            elif isinstance(x, (list, tuple)):
                for v in x:
                    collect(v)

        collect(batch)
        flat = torch.cat(leaves) if leaves else torch.zeros(1, dtype=torch.float64, device=self.device)
        pos = torch.arange(1, flat.numel() + 1, dtype=torch.float64, device=flat.device)
        mine = torch.stack([flat.sum(), (flat * pos).sum(), torch.tensor(float(flat.numel()), device=flat.device,
                                                                          dtype=torch.float64)])
        peers = [torch.empty_like(mine) for _ in range(plan.peer_size)]
        torch.distributed.all_gather(peers, mine, group=plan.peer_group)
        if not all(torch.equal(peers[0], p) for p in peers[1:]):
            raise ValueError("tensor-parallel peers (the 'model' axis) or sequence-parallel peers (the 'seq' axis) "
                             "were fed different batches; each process must feed the batch of its data-parallel "
                             "coordinate (parallel.mesh.data_parallel_rank)")

    def _train_step(self, batch) -> dict:
        if self._train_guard is not None:
            return self._train_guard(batch)
        return self._run_train_step(batch)

    def _run_train_step(self, batch) -> dict:
        state = self.state
        state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        if not self._batch_checked:
            self._check_peer_batches(batch)
        loss, metrics = self._backward(batch, int(self.gradient_accumulation()))
        if self._update_fn is not None:
            self._compiled_update()
        else:
            clip = float(self.gradient_clip())
            if clip > 0.0:
                grads = [p.grad for p in state.model.parameters() if p.grad is not None]
                self._clip_gradients(grads, clip)
            state.apply_gradients()
            decay = float(self.ema_decay())
            if decay > 0.0:
                state.update_ema(decay)
        if self._quant_layers:
            # delayed scaling: the next step quantizes with this step's updated weights
            from .models.quant import _refresh_amax

            _refresh_amax(self._quant_layers)
        metrics[self.loss_metric_name()] = loss.detach()
        return metrics

    def _compiled_update(self) -> None:
        """Clip, optimizer update and EMA through the compiled per-parameter
        region, one call per parameter: every parameter's gradient scale, its
        optimizer step and its EMA fold in one fused pass. One region over all
        parameters at once would be one graph with every tensor in it, which
        Inductor takes minutes to compile; per parameter, a model compiles one
        graph per distinct parameter shape. The numbers that change every
        step (learning rate, bias corrections) go in as a small tensor copied
        from pinned memory without a host sync; the counters advance here."""
        state = self.state
        opt = state.optimizer
        opt.init_state()
        rows = torch.tensor(opt.step_scalars(), dtype=torch.float64)
        if self.device.type == "cuda":
            rows = rows.pin_memory().to(self.device, non_blocking=True)
        scale = None
        if self._clip > 0.0:
            # the global norm over the shards, replicas counted once: the
            # per-gradient norms are compiled, their sums over the mesh eager
            grads = [p.grad for p in state.model.parameters() if p.grad is not None]
            sq = grad_sq_norm(grads, norm=self._sq_norm_fn)
            scale = torch.clamp(self._clip * torch.rsqrt(torch.clamp(sq, min=1e-12)), max=1.0)
        names = {p: n for n, p in state.model.named_parameters()}
        ema, done = state.ema if self._decay > 0.0 else None, set()
        for i, group in enumerate(opt.param_groups):
            for p in group["params"]:
                if p.grad is None:
                    continue
                shadow = None if ema is None else ema.get(names[p])
                if shadow is not None and shadow.is_floating_point():
                    done.add(names[p])
                    shadow = local_tensor(shadow)
                else:
                    shadow = None
                # a sharded parameter updates its local shard (DTensor slots too)
                slots = {k: local_tensor(v) for k, v in opt.state[p].items()}
                self._update_fn(local_tensor(p), local_tensor(p.grad), slots, group, rows[i], scale, shadow)
        if ema is not None:
            state.update_ema(self._decay, skip=done)  # parameters without a gradient
        opt.count += 1
        state.step += 1

    def _update_param(self, p, g, slots: dict, group: dict, scalars, scale, shadow) -> None:
        """One parameter's update (the compiled region) on plain tensors (a
        sharded parameter's local shard, its gradient's and its slots'): the
        clip's scale rounded to the gradient's dtype, the optimizer's
        ``update_param`` (a static method: the graph reads no optimizer
        object, whose every parameter Dynamo would guard on), and the EMA fold
        of the updated parameter into its fp32 ``shadow``."""
        with torch.no_grad():
            if scale is not None:
                g.mul_(scale.to(g.dtype))
            self._opt_update(p, g, slots, group, scalars)
            if shadow is not None:
                shadow.lerp_(p if p.dtype == shadow.dtype else p.to(shadow.dtype), ema_weight(self._decay))

    @staticmethod
    def _sq_norm(g: torch.Tensor) -> torch.Tensor:
        """The clip's per-gradient norm in fp32, as ``parallel.mesh.grad_sq_norm`` takes it."""
        return torch.linalg.vector_norm(g, dtype=torch.float32)

    def _validates_on_ema(self) -> bool:
        return self.state.ema is not None and float(self.ema_decay()) > 0.0 and bool(self.val_with_ema())

    def _val_step(self, batch) -> dict:
        if self._val_compiled is not None:
            return self._val_compiled(batch)
        return self._run_val_step(batch)

    @torch.no_grad()
    def _run_val_step(self, batch) -> dict:
        state = self.state
        state.model.eval()
        if self._plan is None and self._val_fwd is None and self._validates_on_ema():
            # the user's val_step reads state.model as usual and runs on the
            # average, cast to the parameters' dtypes (an fp32 shadow must not
            # promote a bf16 model's forward to fp32); a sharded model, and a
            # compiled step, have the average in the parameters already
            # (val_epoch)
            params = dict(state.model.named_parameters())
            ema = {n: e if e.dtype == params[n].dtype else e.to(params[n].dtype) for n, e in state.ema.items()}
            state = dataclasses.replace(state, model=_Reparametrized(state.model, ema))
        try:
            if self._val_fwd is not None:
                loss, metrics = self._val_fwd(batch)
            else:
                loss, metrics = self._unpack(self.val_step(state, batch))
        finally:
            if self._plan is not None and self._plan.fsdp:
                _reshard(self.state.model)
        metrics[self.loss_metric_name()] = loss
        return metrics

    def _val_forward(self, batch) -> tuple[torch.Tensor, dict]:
        return self._unpack(self.val_step(self.state, batch))

    # -- the compiled step (compile/) -----------------------------------------
    def _setup_compiled_steps(self) -> None:
        """Arm the compiled regions, the signature registries and (optionally)
        the precompile phase. Inactive (the eager step, no wrapper) unless
        ``precompile()`` or ``buckets()`` says otherwise."""
        raw_buckets = self.buckets()
        if raw_buckets:
            from .compile.buckets import resolve_buckets

            self._buckets_resolved = resolve_buckets(raw_buckets)
        else:
            self._buckets_resolved = None
        if not self.precompile() and self._buckets_resolved is None:
            return
        plan = self._plan
        if plan is not None and any(a in plan.axes for a in (SEQ, PIPE)):
            raise NotImplementedError(
                f"precompile()/buckets() on a mesh with axes {sorted(plan.axes)}: compiled steps on a 'seq' or "
                "'pipe' axis (the ring's and the pipeline's point-to-point hops) are not ported yet (ROADMAP "
                "Queue 1 item 14b); 'data', 'fsdp', 'model' and 'expert' are")
        from .compile.aot import PrecompiledStep, compile_blocks, compile_region, preserving
        from .lint import TraceGuard

        state = self.state
        opt = state.optimizer
        name = self.name
        n_buckets = len(self._buckets_resolved or ())
        self._clip = float(self.gradient_clip())
        self._decay = float(self.ema_decay())
        per_block = plan is not None and (plan.fsdp or plan.tp is not None or plan.ep is not None)
        if per_block:
            # FSDP2's hooks sit on the blocks' calls and Dynamo does not trace
            # them: the forward and loss stay eager around compiled blocks
            model = state.model
            blocks = list(model.fsdp_blocks()) if hasattr(model, "fsdp_blocks") else [model]
            self._restore_blocks = compile_blocks(blocks, name)
        else:
            self._train_fwd = compile_region(self._forward_loss, f"{name}_train_forward")
            self._val_fwd = compile_region(self._val_forward, f"{name}_val_forward")
        if hasattr(opt, "update_param") and hasattr(opt, "step_scalars"):
            opt.init_state()  # the moments exist before the warm-up snapshots them
            self._opt_update = type(opt).update_param
            self._update_fn = compile_region(self._update_param, f"{name}_update")
            self._sq_norm_fn = compile_region(self._sq_norm, f"{name}_grad_norm")
            n_shapes = len({(tuple(local_tensor(p).shape), p.dtype) for p in state.model.parameters()})
        else:
            n_shapes = 0
            self.logger.warning(f"optimizer {type(opt).__name__} has no update_param/step_scalars: stage "
                                f"{name!r} compiles its forward and backward, the update runs eagerly")
        self._train_compiled = PrecompiledStep(
            self._run_train_step, name=f"{name}.train_step", compile=False,
            preserve=lambda: preserving(modules=[state.model], optimizers=[opt],
                                        tensors=list((state.ema or {}).values()), holders=[state]),
            recompile_limit=max(2 * n_buckets if per_block else n_buckets, 2 * n_shapes))
        # a block region serves the train (grad) and the val (no_grad) calls
        self._val_compiled = PrecompiledStep(
            self._run_val_step, name=f"{name}.val_step", compile=False,
            preserve=lambda: preserving(tensors=list(state.model.buffers())),
            recompile_limit=2 * n_buckets if per_block else n_buckets)
        if self.precompile():
            self._run_precompile_phase()
        # the runtime retrace guard reads the registry's _cache_size(): any
        # signature beyond the expected bucket set is a mid-run compile stall
        self._train_guard = TraceGuard(self._train_compiled, max_traces=n_buckets or 1, action="warn",
                                       name=f"{name}.train_step")

    def _host_batch_spec(self, dataset_fn) -> Any:
        """The abstract HOST batch for precompilation: ``batch_spec()`` if
        declared (train only), else the peeked first batch; None when the
        dataset is absent."""
        from .compile.aot import abstract_spec

        if dataset_fn == self.train_dataset:
            declared = self.batch_spec()
            if declared is not None:
                return abstract_spec(declared)
        try:
            ds = dataset_fn()
        except DatasetNotFoundError:
            return None
        if iter(ds) is ds:
            raise ValueError(
                f"precompile() needs the first batch's shapes, but stage {self.name!r} "
                "feeds from a one-shot iterator that peeking would consume — declare "
                "batch_spec() or register a re-iterable dataset"
            )
        from .data.device import peek_spec

        spec, _ = peek_spec(ds)
        return spec

    def _run_precompile_phase(self) -> None:
        """The timed precompile phase: run every expected train/val signature
        once on zeros BEFORE the data loop, so compile cost is measured
        (``misc/compile_ms``), cache hits are counted, and shape mismatches
        fail here — at stage start."""
        from .compile import aot
        from .compile import cache as compile_cache
        from .compile.buckets import bucket_spec

        t0 = time.perf_counter()
        stats0 = compile_cache.cache_stats()
        mesh = self.mesh if self.mesh is not None else {DATA: runtime.world_size()}

        def variants(host_spec):
            if host_spec is None:
                return []
            if self._buckets_resolved:
                out = [bucket_spec(host_spec, b, mask_key=self.bucket_mask_key()) for b in self._buckets_resolved]
            else:
                out = [host_spec]
            for hs in out:
                aot.validate_global_batch_spec(aot.global_batch_spec(hs, mesh), mesh)
            return out

        train = variants(self._host_batch_spec(self.train_dataset))
        # val is best-effort: a stage may have no val dataset, or one whose
        # first-batch peek is impossible — the val step then compiles lazily
        try:
            val = variants(self._host_batch_spec(self.val_dataset))
        except ValueError as e:
            self.logger.warning(f"val-step precompile skipped: {e}")
            val = None
        train, val = self._agreed_warmups(train, val)
        n_train = 0
        for hs in train:
            self._train_compiled.precompile(hs, device=self.device)
            if n_train == 0 and self._telemetry_armed and float(self.step_flops()) <= 0:
                # the MFU fallback's count (one eager step on zeros)
                self._train_compiled.count_flops(hs, device=self.device)
            n_train += 1
        n_val = 0
        for hs in val:
            self._val_compiled.precompile(hs, device=self.device)
            n_val += 1
        # the warm-ups' zeros are no batch: the peers' first-batch check is
        # still to come
        self._batch_checked = False

        elapsed_ms = (time.perf_counter() - t0) * 1e3
        if not ("misc/compile_ms" in self.tracker and self.tracker.has_value("misc/compile_ms")):
            self.track("misc/compile_ms", round(elapsed_ms, 3), prefixed=False)
        stats1 = compile_cache.cache_stats()
        if n_train or n_val:
            self.logger.info(
                f"precompile: {n_train} train + {n_val} val signature(s) in {elapsed_ms:.0f} ms "
                f"(compile cache: {stats1['aot_hits'] - stats0['aot_hits']} hit(s), "
                f"{stats1['aot_misses'] - stats0['aot_misses']} miss(es))"
            )
        else:
            self.logger.warning(
                f"precompile() on stage {self.name!r} found no batch spec to compile "
                "against; the first step pays the compile as usual"
            )

    def _agreed_warmups(self, train: list, val: list | None) -> tuple[list, list]:
        """The warm-ups every process runs. Each one runs the step's
        collectives (FSDP2's all-gathers, the ``model`` and ``expert`` sums,
        the gradient average), so a process that warmed one signature more
        than another would hang it. One exchange of the counts at stage
        start: the train counts must agree (the shapes may differ over
        data-parallel ranks, whose collectives do not depend on the batch),
        and the val warm-ups run only where every process has as many (None:
        this one has none to offer)."""
        if runtime.world_size() == 1:
            return train, val or []
        every = runtime.all_gather_object((len(train), None if val is None else len(val)))
        if len({n for n, _ in every}) > 1:
            raise ValueError(f"precompile() on stage {self.name!r}: the processes would warm "
                             f"{[n for n, _ in every]} train signature(s) (by rank); each warm-up runs the step's "
                             "collectives, so every process must warm as many — declare batch_spec() or buckets()")
        if val is not None and len({v for _, v in every}) > 1:
            self.logger.warning(f"val-step precompile skipped: the processes have {[v for _, v in every]} val "
                                "signature(s) (by rank)")
            val = None
        return train, val or []

    def _cost_analysis_flops(self) -> float:
        """MFU fallback when ``step_flops()`` is not declared: FLOPs of one
        step over all processes, counted during precompile
        (``telemetry.goodput.flops_from_compiled``; 0.0 when nothing was
        counted — the MFU metric is then skipped, never invented). Cached."""
        if self._cost_flops is None:
            val = 0.0
            if self._train_compiled is not None:
                record = self._train_compiled.any_compiled()
                if record is not None:
                    from .telemetry.goodput import flops_from_compiled

                    val = flops_from_compiled(record, n_devices=runtime.world_size()) or 0.0
            self._cost_flops = val
        return self._cost_flops

    # -- lifecycle ----------------------------------------------------------
    def _configure_state_manager(self):
        """Bind this stage's retention options (keep count, optional
        keep-best ranking) before any save or restore touches the scope."""
        ckpt = self.pipeline.checkpoint_dir
        if ckpt is None:
            return
        asave = bool(self.async_checkpoint())
        # step-save scope first: it gets its newest-only retention even when
        # the user configured the epoch scope or disabled epoch saves
        if int(self.checkpoint_every_steps()) > 0 and not ckpt.has_state_manager(self._steps_scope):
            ckpt.state_manager(self._steps_scope, max_to_keep=1, async_save=asave)
        if int(self.checkpoint_every()) <= 0 or ckpt.has_state_manager(self.name):
            return  # disabled, or the user configured this scope in pre_stage
        policy = None
        metric = self.checkpoint_best_metric()
        if metric is not None:
            mode = self.checkpoint_best_mode()
            if mode not in ("min", "max"):
                raise ValueError(f"checkpoint_best_mode() must be 'min' or 'max', got {mode!r}")
            # best-N by the metric PLUS always the newest (a requeued run
            # resumes from the latest epoch either way)
            policy = ckpt_lib.AnyPreservationPolicy([
                ckpt_lib.LatestN(n=1),
                ckpt_lib.BestN(get_metric_fn=lambda m: m[metric], reverse=(mode == "min"),
                               n=int(self.checkpoint_keep()), keep_checkpoints_without_metrics=False),
            ])
        keep = None if policy is not None else int(self.checkpoint_keep())
        ckpt.state_manager(self.name, max_to_keep=keep, async_save=asave, preservation_policy=policy)

    @property
    def _steps_scope(self) -> str:
        """Scope of the mid-epoch step saves (separate from the epoch scope,
        so step ids never collide with epoch numbers)."""
        return f"{self.name}.steps"

    def _pre_stage(self):
        super()._pre_stage()
        if self.state is None:
            self.state = self.make_state()
        models = self.pipeline.models
        self._plan = self.pipeline._model_entry(self.model_name()).plan if models else None
        if self._quant_layers and self._plan is not None and PIPE in self._plan.axes:
            raise NotImplementedError(f'precision="int8" on a mesh with a {PIPE!r} axis ({self._plan.axes}) is not '
                                      "ported yet (ROADMAP Queue 1 item 16); 'data', 'fsdp', 'model' and 'seq' are")
        if models:
            entry = self.pipeline._model_entry(self.model_name())
            self._sharding = self._plan.record if self._plan is not None else sharding_record(
                entry.module, {DATA: runtime.world_size()}, entry.sharding)
        self._batch_checked = False
        self._configure_state_manager()
        if self.pipeline.resumed and (int(self.checkpoint_every()) > 0 or int(self.checkpoint_every_steps()) > 0):
            self._restore_state()
        self._setup_compiled_steps()

    def _pre_epoch(self):
        self._stall.reset()  # misc/host_stall_ms is a per-epoch total
        self._gp_data_wait_ns = 0
        self._gp_pad_slots = 0
        self._gp_token_slots = 0
        self._gp_reader_mark = _shard_store.reader_activity()
        super()._pre_epoch()

    @property
    def _telemetry_armed(self) -> bool:
        return self.pipeline.telemetry_armed

    def _reduce_metrics(self):
        self.track("misc/host_stall_ms", round(self._stall.ms, 3), prefixed=False)
        if self._telemetry_armed and self.epoch_stop_time is not None:
            # the goodput ledger's buckets, disjoint by construction: data_wait
            # is timed outside the stall timer, ckpt is the timer's
            # "checkpoint" share, productive is the rest
            epoch_s = (self.epoch_stop_time - self.epoch_start_time).total_seconds()
            data_wait_ms = self._gp_data_wait_ns / 1e6
            productive_s = max(epoch_s - (data_wait_ms + self._stall.ms) / 1e3, 0.0)
            self.track_reduce("misc/data_wait_ms", round(data_wait_ms, 3), prefixed=False)
            self.track_reduce("misc/ckpt_ms", round(self._stall.label_ms("checkpoint"), 3), prefixed=False)
            self.track_reduce("misc/goodput", round(productive_s / epoch_s, 6) if epoch_s > 0 else 0.0,
                              prefixed=False)
            if self._gp_token_slots:
                self.track_reduce("misc/pad_fraction", round(self._gp_pad_slots / self._gp_token_slots, 6),
                                  prefixed=False)
            if _shard_store.reader_activity() > self._gp_reader_mark:
                # a ShardReader fetched blocks this epoch: the goodput advisor
                # points at the reader's knobs, not the generic prefetch
                self.track_reduce("misc/shard_reader", 1.0, reduction=Reduction.MAX, prefixed=False)
        if self._train_compiled is not None:
            # signatures that showed up this epoch WITHOUT a precompiled graph:
            # each one was a mid-run compilation (0 is the goal; the TraceGuard
            # wrapper has already warned per growth event)
            self.tracker.bump(
                "misc/recompiles",
                self._train_compiled.pop_recompiles() + self._val_compiled.pop_recompiles(),
            )
        super()._reduce_metrics()

    def _post_epoch(self):
        super()._post_epoch()
        self._maybe_save_state()

    def _post_stage(self):
        # every async save of this stage is committed before the stage counts
        # as finished: a following stage's restore, the run-end teardown and
        # a preemption exit all rely on the newest save being durable here
        ckpt = self.pipeline.checkpoint_dir
        if ckpt is not None:
            ckpt.wait_until_finished(scope=self.name)
            ckpt.wait_until_finished(scope=self._steps_scope)
        if self._restore_blocks is not None:
            self._restore_blocks()
            self._restore_blocks = None
        super()._post_stage()

    # -- automatic state checkpointing --------------------------------------
    def _maybe_save_state(self):
        ckpt = self.pipeline.checkpoint_dir
        every = int(self.checkpoint_every())
        if ckpt is None or every <= 0 or self.state is None:
            return
        completed = self.current_epoch - 1  # super()._post_epoch incremented
        final = completed == self.max_epochs or self._stop_requested or self._preempt_exit
        if completed % every != 0 and not final:
            return
        metrics = None
        best_metric = self.checkpoint_best_metric()
        if best_metric is not None:
            hist = self.tracker[best_metric] if best_metric in self.tracker else []
            val = hist[-1] if hist else None
            if val is None:
                self.logger.warning(f"checkpoint_best_metric {best_metric!r} has no value for epoch {completed}; "
                                    "this save is unranked (retained only while it is the newest)")
            else:
                metrics = {best_metric: float(val)}
        # single flight: a save still committing is waited out (as stall)
        # before the new one dispatches; the dispatch itself costs the copy to
        # host memory (async) or the whole write (sync)
        t0 = time.perf_counter()
        with self._stall.measure(label="checkpoint"):
            self._stall.block(self.device)
            ckpt.wait_until_finished(scope=self.name)
            ckpt.save_state(completed, self.state.state_dict(), scope=self.name, metrics=metrics,
                            sharding=self._sharding)
        self._last_save_latency_s = time.perf_counter() - t0
        if is_root():
            from .utils.serialization import to_jsonable

            try:
                tracker_state = to_jsonable(self.tracker.state_dict())
            except TypeError as e:
                # a non-numeric tracked value must not kill the run at save time
                # (only the root would die; the others would hang)
                self.logger.warning(f"Metric tracker state is not JSON-encodable ({e}); saving resume "
                                    "metadata without metric history")
                tracker_state = None
            self._write_resume_sidecar(
                self.name, completed, {"epoch": completed, "stopped": self._stop_requested, "tracker": tracker_state}
            )

    def _write_resume_sidecar(self, scope: str, key: int, payload: dict) -> None:
        """Root-side atomic sidecar write plus cleanup in lockstep with the
        COMMITTED saves: while an async save is in flight, the previous save is
        the newest restorable one, so its sidecar stays."""
        ckpt = self.pipeline.checkpoint_dir
        meta_dir = ckpt.path / "meta" / scope
        meta_dir.mkdir(parents=True, exist_ok=True)
        ckpt_lib.atomic_write_text(meta_dir / f"{key}.json", json.dumps(payload))
        kept = set(ckpt.state_manager(scope).all_steps()) | {key}
        for f in meta_dir.glob("*.json"):
            if f.stem.isdigit() and int(f.stem) not in kept:
                f.unlink(missing_ok=True)

    def _save_step_state(self, epoch_step: int) -> None:
        """Collective mid-epoch save keyed by the GLOBAL optimizer step, with a
        root-written sidecar recording where inside which epoch it landed and
        under which world size."""
        ckpt = self.pipeline.checkpoint_dir
        t0 = time.perf_counter()
        with self._stall.measure(label="checkpoint"):
            self._stall.block(self.device)
            ckpt.wait_until_finished(scope=self._steps_scope)
            gstep = int(self.state.step)
            ckpt.save_state(gstep, self.state.state_dict(), scope=self._steps_scope, sharding=self._sharding)
        self._last_save_latency_s = time.perf_counter() - t0
        if is_root():
            payload = {"epoch": self.current_epoch, "step_in_epoch": epoch_step, "world_size": runtime.world_size(),
                       "data_parallel_size": self._data_parallel_size(), "epoch_batches": self._epoch_batches()}
            data = self._train_data_state()
            if data is not None:
                payload["data"] = data
            self._write_resume_sidecar(self._steps_scope, gstep, payload)

    def _train_data_state(self) -> dict | None:
        """The train dataset's iterator state (``DataPipeline.state_dict``)
        as plain JSON values, or None when it has none."""
        try:
            ds = self.train_dataset()
        except DatasetNotFoundError:
            return None
        if not hasattr(ds, "state_dict"):
            return None
        try:
            return json.loads(json.dumps(ds.state_dict(), default=lambda v: v.item()))
        except Exception:
            self.logger.warning("train dataset state_dict() failed; a resume will skip by batch count instead",
                                exc_info=True)
            return None

    def _data_parallel_size(self) -> int:
        """Processes that feed distinct rows (tensor- and sequence-parallel
        peers count once)."""
        return self._plan.dp_size if self._plan is not None else runtime.world_size()

    def _epoch_batches(self) -> int | None:
        """Batches per epoch this process iterates (None: the dataset has no length)."""
        try:
            return len(self.train_dataset())
        except TypeError:
            return None

    def _read_step_resume_meta(self, gstep: int) -> dict | None:
        """Root only: the step-save sidecar, or None (degrade to epoch resume)."""
        meta_file = self.pipeline.checkpoint_dir.path / "meta" / self._steps_scope / f"{gstep}.json"
        try:
            raw = json.loads(meta_file.read_text())
            world = int(raw.get("world_size", runtime.world_size()))
            batches = raw.get("epoch_batches")
            meta = {"epoch": int(raw["epoch"]), "step_in_epoch": int(raw["step_in_epoch"]), "world_size": world,
                    "data_parallel_size": int(raw.get("data_parallel_size", world)),
                    "epoch_batches": None if batches is None else int(batches)}
            if isinstance(raw.get("data"), dict):
                meta["data"] = raw["data"]
            return meta
        except Exception:
            self.logger.warning(f"No usable step-resume metadata at {meta_file}; falling back (last completed "
                                "epoch if one exists, else weights-only step restore)")
            return None

    def _read_resume_meta(self, step: int) -> dict | None:
        """Root only: read and validate the JSON resume sidecar of epoch save
        ``step``; None (with a warning) on a missing, corrupt or ill-typed
        file, and the caller degrades to a state-only resume."""
        from .utils.serialization import from_jsonable

        meta_file = self.pipeline.checkpoint_dir.path / "meta" / self.name / f"{step}.json"
        try:
            raw = json.loads(meta_file.read_text())
            meta = {"epoch": int(raw["epoch"]), "stopped": bool(raw["stopped"]),
                    "tracker": from_jsonable(raw["tracker"])}
            if meta["tracker"] is not None:
                # validate on a throwaway tracker: an incomplete sidecar degrades
                # here instead of crashing the real restore
                MetricTracker().load_state_dict(meta["tracker"])
            return meta
        except FileNotFoundError:
            self.logger.warning(f"No resume metadata at {meta_file}; continuing from the saved state alone "
                                "(metric history and early-stop flag are lost)")
        except Exception:
            self.logger.warning(f"Corrupt resume metadata {meta_file}; continuing from the saved state alone "
                                "(metric history and early-stop flag are lost)")
        return None

    def _restore_tree(self, scope: str, key: int) -> None:
        """Restore the state from ``scope``/``key`` in place, tolerating the
        one legitimate structure drift: ``ema_decay()`` toggled since the save.
        Any other mismatch raises."""
        ckpt = self.pipeline.checkpoint_dir
        template = self.state.state_dict()
        saved_ema = any(k.startswith("ema.") for k in ckpt.state_manager(scope).keys(key))
        if "ema" in template and not saved_ema:
            self.logger.warning(f"Checkpoint {key} for scope '{scope}' has no EMA tree (ema_decay() was enabled "
                                "after it was written); the shadow restarts from the restored params")
            del template["ema"]
        elif saved_ema and "ema" not in template:
            self.logger.warning(f"Checkpoint {key} for scope '{scope}' carries an EMA tree but ema_decay() is "
                                "now 0; the shadow is dropped")
        ckpt.restore_state(key, template=template, scope=scope)
        self.state.load_state_dict(template)
        if self.state.ema is not None and not saved_ema:
            # EMA newly enabled on a resumed run: average from the restored
            # params, not from the initialisation
            self.state.ema = ema_like(self.state.model)

    def _restore_state(self):
        ckpt = self.pipeline.checkpoint_dir
        if ckpt is None or self.state is None:
            return
        # manual epoch checkpointing (checkpoint_every() == 0) owns its scope's
        # keys, so only step saves are considered for automatic resume then
        latest = ckpt.latest_step(scope=self.name) if int(self.checkpoint_every()) > 0 else None
        # a step save mid-epoch may be fresher than the last completed epoch
        step_meta = step_latest = None
        if int(self.checkpoint_every_steps()) > 0:
            step_latest = ckpt.latest_step(scope=self._steps_scope)
            if step_latest is not None:
                sm = self._read_step_resume_meta(step_latest) if is_root() else None
                if sm is not None:  # the root's epoch length decides the skip for every rank
                    sm["epoch_batches_now"] = self._epoch_batches()
                sm = runtime.broadcast_object(sm)
                if sm is not None and sm["epoch"] > (latest or 0):
                    step_meta = sm
        # no epoch save to fall back on, but a step save with unusable position
        # metadata: restore the WEIGHTS rather than silently train from scratch
        blind_step = latest is None and step_meta is None and step_latest is not None
        if latest is None and step_meta is None and not blind_step:
            return  # e.g. a crash before this stage's first save
        if step_meta is not None or blind_step:
            self._restore_tree(self._steps_scope, step_latest)
        else:
            self._restore_tree(self.name, latest)
        # the root alone reads the sidecar and broadcasts the result: ranks
        # that read different files would diverge, then deadlock
        meta = None
        if latest is not None:
            meta = runtime.broadcast_object(self._read_resume_meta(latest) if is_root() else None)
        if meta is not None:
            if meta["tracker"] is not None:
                self.tracker.load_state_dict(meta["tracker"])
            self.current_epoch = meta["epoch"] + 1
            # a stage that had already stopped early must not re-train
            self._stop_requested = meta["stopped"]
        elif latest is not None:
            self.current_epoch = latest + 1
        if step_meta is not None:
            self.current_epoch = step_meta["epoch"]
            # the sidecar's batch count is per process UNDER THE SAVED layout.
            # An epoch of unchanged length means every process iterates the
            # same global batches (slicing its rows, as on a mesh): skip the
            # same count. Otherwise each data-parallel rank iterates its own
            # shard: re-derive the skip from the global count (the
            # reference's world-size rule, over data-parallel ranks)
            saved_ws, ws = int(step_meta["world_size"]), runtime.world_size()
            saved_dp, dp = step_meta["data_parallel_size"], self._data_parallel_size()
            if step_meta["epoch_batches"] is not None and step_meta["epoch_batches"] == step_meta["epoch_batches_now"]:
                skip = step_meta["step_in_epoch"]
            else:
                global_batches = step_meta["step_in_epoch"] * saved_dp
                skip, rem = divmod(global_batches, dp)
                if rem:
                    self.logger.warning(f"mid-epoch resume: {global_batches} globally-consumed batches do not divide "
                                        f"the new data-parallel size {dp}; rounding down (up to {dp - 1} global "
                                        "batch(es) replay)")
            self._resume_skip_steps = skip
            self._resume_data_state = step_meta.get("data")
            # the restored tracker may trail the resumed epoch: pad the gap
            self.tracker.fast_forward(self.current_epoch)
            self.logger.info(
                f"Restored stage '{self.name}' from mid-epoch step save (global step {step_latest}); continuing "
                f"epoch {self.current_epoch} at batch {skip}"
                + (f" (resharded from world size {saved_ws})" if saved_ws != ws else "")
            )
        elif blind_step:
            self.logger.warning(f"Restored stage '{self.name}' WEIGHTS from step save {step_latest} but its position "
                                f"metadata was unusable: the epoch loop restarts at epoch {self.current_epoch} on the "
                                "restored state")
        else:
            self.logger.info(f"Restored stage '{self.name}' state from epoch {latest}; continuing at epoch "
                             f"{self.current_epoch}")

    # -- epochs -------------------------------------------------------------
    def run_epoch(self):
        self.train_epoch()
        if self._mid_epoch_exit:
            return  # preempted at a step save: no validation of a partial epoch
        self.val_epoch()

    def _feed(self, ds):
        """The device feed: ``data.device_iterator`` with ``prefetch_depth()``
        copies in flight and ``host_prefetch()`` host batches read ahead. A
        ``DataPipeline`` goes through it by ``iter_through``, so that its
        cursor counts the batches the step took, not those in flight; one that
        already ends in ``to_device`` is fed as it is."""
        if getattr(ds, "on_device", None) is not None:
            return self._bucketed(iter(ds))

        def to_device(it):
            if self._telemetry_armed:
                it = self._count_padding(it)
            return device_iterator(self._bucketed(it), self.device, prefetch=int(self.prefetch_depth()),
                                   host_prefetch=int(self.host_prefetch()))

        return ds.iter_through(to_device) if isinstance(ds, DataPipeline) else to_device(ds)

    def _bucketed(self, it):
        """With ``buckets()`` armed, every batch padded up to its bucket (plus
        the mask leaf), before the device copy when the batches are host ones."""
        if not self._buckets_resolved:
            return it
        from .compile.buckets import bucket_iterator

        return bucket_iterator(it, self._buckets_resolved, mask_key=self.bucket_mask_key())

    def _count_padding(self, ds):
        """Count padding slots (segment id 0, from ``segment_ids_of``) of the
        HOST batches, before any copy: ``misc/pad_fraction``. Only numpy
        segment ids count, so no device value is read."""
        for batch in ds:
            seg = self.segment_ids_of(batch)
            if isinstance(seg, np.ndarray) and seg.size:
                self._gp_pad_slots += int(np.count_nonzero(seg == 0))
                self._gp_token_slots += int(seg.size)
            yield batch

    def _timed_feed(self, ds):
        """``_feed`` with each ``next()`` timed into the goodput ledger's
        data_wait bucket and journalled as a ``data_wait`` span."""
        it = iter(self._feed(ds))
        try:
            while True:
                t0 = time.perf_counter()
                try:
                    batch = next(it)
                except StopIteration:
                    return
                t1 = time.perf_counter()
                self._gp_data_wait_ns += int((t1 - t0) * 1e9)
                _journal.emit("data_wait", t0, t1)
                yield batch
        finally:
            # a break out of the loop (the preemption drain) shuts the feed's
            # reader down now, not when the generator is collected
            it.close()

    def _feed_for_epoch(self, ds):
        return self._timed_feed(ds) if self._telemetry_armed else self._feed(ds)

    def train_epoch(self):
        self.is_train = True
        self.metric_prefix = self.train_metric_prefix()
        train_ds = self.train_dataset()
        if hasattr(train_ds, "set_epoch"):
            train_ds.set_epoch(self.current_epoch)
        elif hasattr(getattr(train_ds, "sampler", None), "set_epoch"):
            # a torch DataLoader: its DistributedSampler reshuffles per epoch
            train_ds.sampler.set_epoch(self.current_epoch)

        # mid-epoch resume: a dataset with an iterator state (DataPipeline)
        # fast-forwards itself from the sidecar's (its cursor survives a change
        # of world size, and later step saves keep checkpointing it); any
        # other skips the batches the interrupted run consumed. Either way on
        # the host: no step runs and no copy reaches the device for them
        skipped, self._resume_skip_steps = self._resume_skip_steps, 0
        data_state, self._resume_data_state = self._resume_data_state, None
        if data_state is not None and hasattr(train_ds, "load_state_dict"):
            train_ds.load_state_dict(data_state)
            self.logger.info(f"mid-epoch resume: train dataset fast-forwarded from saved iterator state {data_state} "
                             f"for epoch {self.current_epoch}")
        elif skipped:
            train_ds = itertools.islice(iter(train_ds), skipped, None)
            self.logger.info(f"mid-epoch resume: skipping the first {skipped} batches of epoch {self.current_epoch}")
        every_steps = int(self.checkpoint_every_steps()) if self.pipeline.checkpoint_dir is not None else 0

        live = self.table.live_target() is not None
        deferred = bool(self.deferred_metrics())
        log_every = int(self.log_every())
        guard = bool(self.nan_guard())
        loss_name = self.loss_metric_name()
        self.train_losses = []
        loss_ema = None
        steps_done = 0
        epoch_t0 = time.perf_counter()
        last_render = 0.0

        def guard_loss(v: float) -> None:
            if guard and not np.isfinite(v):
                raise FloatingPointError(
                    f"non-finite loss ({v}) detected at step {steps_done} of epoch "
                    f"{self.current_epoch} (stage {self.name!r})"
                )

        feed = self._feed_for_epoch(train_ds)
        self._in_step_loop = True
        try:
            for batch in feed:
                step_start = time.perf_counter_ns()
                metrics = self._train_step(batch)
                step_end = time.perf_counter_ns()
                _journal.emit("step_dispatch", step_start / 1e9, step_end / 1e9, step=steps_done + 1)
                if not deferred:
                    # the eager path: this step's metrics on the host now
                    metrics = self._stall.fetch(metrics)
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

                if every_steps and (skipped + steps_done) % every_steps == 0:
                    self._save_step_state(skipped + steps_done)
                    if self.pipeline._preemption_coordinated():
                        # the save just above is the resume point: cut the epoch
                        # here (Stage.run handles the exit)
                        self._mid_epoch_exit = True
                        break

                if not deferred:
                    if loss_val is not None:
                        # dmllint: disable-next-line=DML101 -- converts, not syncs: already on the host
                        v = float(loss_val)
                        loss_ema = v if loss_ema is None else 0.98 * loss_ema + 0.02 * v
                        guard_loss(v)
                elif log_every > 0 and steps_done % log_every == 0 and self.train_losses:
                    # two steps behind: already computed, so the read barely waits
                    v = float(self._stall.fetch(self.train_losses[max(0, len(self.train_losses) - 3)]))
                    loss_ema = v if loss_ema is None else 0.98 * loss_ema + 0.02 * v
                    guard_loss(v)
                if live:
                    now = time.perf_counter()
                    if now - last_render > 0.25:
                        self.table.live(
                            {"Epoch": self.current_epoch, "[Train] Loss": loss_ema,
                             "it/s": steps_done / max(now - epoch_t0, 1e-9)}
                        )
                        last_render = now
        finally:
            self._in_step_loop = False
            # a break (the preemption drain) stops the feed's reader now
            feed.close()

        # the epoch's one sync point: every queued step has run past this line
        self._stall.block(self.device)
        if self._mid_epoch_exit:
            return  # partial epoch: the resumed run finishes it and reduces its metrics
        train_elapsed = time.perf_counter() - epoch_t0
        if steps_done:
            self.track("misc/train_step_avg_ms", train_elapsed / steps_done * 1e3, prefixed=False)
            self._track_mfu(steps_done, train_elapsed)
        self.table["it/s"] = steps_done / max(train_elapsed, 1e-9)
        step_count = self.state.step if self.state is not None else 0
        for name, schedule in self.pipeline.schedulers.items():
            self.track(f"misc/lr_{name}", float(schedule(step_count)), prefixed=False)

    def _track_mfu(self, steps: int, train_elapsed: float) -> None:
        """``misc/mfu = flops * steps / train_elapsed / (peak * world_size)``,
        the reference's formula; skipped, with one warning, on a device the
        peak table does not know."""
        flops = float(self.step_flops())
        if flops <= 0 and self._telemetry_armed:
            flops = self._cost_analysis_flops()
        if flops <= 0:
            return
        kind = device_kind(self.device)
        peak = peak_flops_for_kind(kind)
        if peak is None:
            if not self._warned_mfu_peak:
                self._warned_mfu_peak = True
                self.logger.warning(f"device kind {kind!r} is not in the bf16 peak table; "
                                    "misc/mfu will not be tracked on this device")
            return
        self.track("misc/mfu", flops * steps / train_elapsed / (peak * runtime.world_size()), prefixed=False)

    def val_epoch(self):
        self.is_train = False
        self.metric_prefix = self.val_metric_prefix()
        try:
            val_ds = self.val_dataset()
        except DatasetNotFoundError:
            return  # validation is optional
        deferred = bool(self.deferred_metrics())
        batches = 0
        swapped = None
        if (self._plan is not None or self._val_fwd is not None) and self._validates_on_ema():
            # a sharded module gathers its parameters in its own forward
            # hooks, and a compiled step reads the parameters it was compiled
            # on, so the average goes into them, once for the epoch
            params = dict(self.state.model.named_parameters())
            swapped = [params[n] for n in self.state.ema]
            swapped = swapped, _swap_in(swapped, list(self.state.ema.values()))
        try:
            for batch in self._feed_for_epoch(val_ds):
                metrics = self._val_step(batch)
                if not deferred:
                    metrics = self._stall.fetch(metrics)
                for mname, mval in metrics.items():
                    self.track_reduce(mname, mval)
                self.track_reduce("misc/total_val_batches", 1, reduction=Reduction.SUM, prefixed=False)
                self.track_reduce(
                    "misc/worker_val_batches", 1, reduction=Reduction.SUM, reduce_globally=False, prefixed=False
                )
                batches += 1
        finally:
            if swapped is not None:
                with torch.no_grad():
                    for p, raw in zip(*swapped):
                        local_tensor(p).copy_(raw)
        if batches:
            self._stall.block(self.device)

    def table_columns(self):
        columns = super().table_columns()
        columns.insert(1, {"name": "[Train] Loss", "metric": f"{self.train_metric_prefix()}/{self.loss_metric_name()}"})
        columns.insert(2, {"name": "[Val] Loss", "metric": f"{self.val_metric_prefix()}/{self.loss_metric_name()}"})
        columns.insert(3, {"name": "it/s", "metric": None})
        return columns
