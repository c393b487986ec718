"""TrainingPipeline: the experiment orchestrator.

Counterpart of ``dmlcloud_tpu/pipeline.py`` (``TrainingPipeline`` :53):
config container, registries for models, optimizers, schedules, datasets and
stages (``register_model`` :210, ``register_optimizer`` :268,
``register_dataset`` :278, ``append_stage`` :296) and the run lifecycle
(``run`` :561) with its run-start diagnostics. Each process owns one
``torch.device`` (``cuda`` unless the caller passes another; no card and no
explicit CPU request raises).

Checkpointing (``enable_checkpointing`` :364, the run directory of
``checkpoint.py`` with ``config.yaml`` and the ``log.txt`` tee) and preemption
handling (``enable_preemption_handling`` :487, the requeue verdict of
``run``/``_post_run``/``_teardown``) follow the reference, and so do the
flight recorder that ``telemetry=`` arms (:115-150; ``_arm_telemetry`` :711,
``_telemetry_ledger`` :775, ``_disarm_telemetry`` :801, with the ``"hang"``
verdict that ``completed`` supersedes, :857-860) and the per-epoch metric
sinks ``enable_wandb`` and ``enable_tensorboard`` (:386-434).

The device mesh (``set_mesh`` :200, ``_init_mesh`` :600) is a named
``DeviceMesh`` over the processes (``parallel.mesh``); ``register_model``
(:209-256) lays a model out on it under the reference's policies:
``"replicate"`` (data parallelism), ``"fsdp"``, rule lists such as
``models.transformer.llama_partition_rules()`` and callables ``(path, leaf) ->
spec`` on the flax path (FSDP2 for ``fsdp``, tensor parallelism for
``model``). Without ``set_mesh`` the mesh is ``{data: world}``, under which
every policy keeps every parameter replicated: plain data parallelism, with
no ``DeviceMesh`` built.
"""

from __future__ import annotations

import json
import logging
import os
import re
from contextlib import contextmanager
from dataclasses import dataclass
from datetime import datetime
from typing import Any, Callable, Optional

import torch

from .checkpoint import CheckpointDir, find_slurm_checkpoint, generate_checkpoint_path, write_requeue_verdict
from .metrics import MetricTracker, Reduction
from .parallel import mesh as mesh_lib
from .parallel import runtime
from .parallel.data_parallel import broadcast_parameters
from .stage import Stage
from .utils.config import Config, as_config
from .utils.logging import IORedirector, add_log_handlers, experiment_header, general_diagnostics
from .utils.wandb import wandb, wandb_is_initialized, wandb_set_startup_timeout


@dataclass
class ModelEntry:
    name: str
    module: torch.nn.Module
    #: the parameter policy: "replicate", "fsdp", a rule list or a callable
    sharding: Any = "replicate"
    #: how ``parallel.mesh.shard_module`` laid it out on the pipeline's mesh
    #: (None: replicated over the default mesh, plain data parallelism)
    plan: Optional[mesh_lib.MeshPlan] = None


class TrainingPipeline:
    def __init__(
        self,
        config: Any = None,
        name: Optional[str] = None,
        device: str | torch.device | None = None,
        telemetry: Any = None,
    ):
        """``telemetry`` arms the flight recorder (``dmlcloud_tpu_torch.telemetry``):
        a per-process span journal (JSONL), the goodput ledger (``misc/goodput``
        and its buckets, a root-only end-of-run table and ``goodput.json``) and
        the hang watchdog (a forensics dump and a ``"hang"`` requeue verdict when
        span progress stops). ``True`` journals into ``<run dir>/telemetry``
        (``./telemetry`` without checkpointing); a path selects the directory; a
        dict configures ``{"dir", "hang_threshold_s" (default 600),
        "watchdog_interval_s" (10), "ring_size" (1024)}``. Forensics go to
        ``<run dir>/forensics``, else beside the journal directory. None/False
        (default): off, and each instrumentation point is one attribute read."""
        if telemetry is not None and not isinstance(telemetry, (bool, str, dict)) and not hasattr(
            telemetry, "__fspath__"
        ):
            raise ValueError(f"telemetry must be None/bool, a directory path, or a config dict, got {telemetry!r}")
        self._telemetry_cfg = telemetry
        self.telemetry_dir: str | None = None
        self._journal = None
        self._watchdog = None
        self._run_span_t0: float | None = None
        self.config: Config = as_config(config)
        self.name = name
        self.device = runtime.resolve_device(device)
        #: the named ``DeviceMesh`` of ``set_mesh`` (None: the default
        #: ``{data: world}``, which needs none)
        self.mesh = None
        self.logger = logging.getLogger("dmlcloud_tpu_torch")
        self.checkpoint_dir: CheckpointDir | None = None
        self.io_redirector: IORedirector | None = None
        self.resumed: bool | None = None
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

        self.wandb = False
        self._wandb_opts: dict | None = None
        self._wandb_timeout = 360
        self._tensorboard_dir: str | None = None
        self._tb_writer = None

        self._preemption = runtime.PreemptionGuard(signals=())
        self._verdict_written = False
        self._verdict_kind: Optional[str] = None

    @property
    def checkpointing_enabled(self) -> bool:
        return self.checkpoint_dir is not None

    @property
    def telemetry_armed(self) -> bool:
        """True between telemetry arming at run start and the teardown."""
        return self._journal is not None

    # -------------------------------------------------------- checkpointing
    def enable_checkpointing(self, root: str, resume: bool = False):
        """Reuse ``root`` as the run directory when resuming and it is one,
        rediscover it by Slurm job id on a requeue, else create a fresh path
        under ``root``, agreed across processes by broadcast."""
        if self.checkpointing_enabled:
            raise ValueError("Checkpointing already enabled")
        path = None
        if resume and CheckpointDir(root).is_valid:
            path = root
            self.resumed = True
        elif resume and (slurm_path := find_slurm_checkpoint(root)):
            path = slurm_path
            self.resumed = True
        if path is None:
            path = runtime.broadcast_object(generate_checkpoint_path(root=root, name=self.name))
            self.resumed = False
        self.checkpoint_dir = CheckpointDir(path)

    # ------------------------------------------------------- metric sinks
    def enable_wandb(
        self,
        project: str | None = None,
        entity: str | None = None,
        group: str | None = None,
        tags: list[str] | None = None,
        startup_timeout: int = 360,
        **kwargs,
    ):
        """Send the tracker's per-epoch metrics to Weights & Biases. Only
        stores the options here (a missing ``wandb`` raises ``ImportError``
        now); the root process opens the run at run start. Extra ``kwargs``
        pass through to ``wandb.init``."""
        import wandb as _wandb  # noqa: F401 - a missing install surfaces at call time

        self._wandb_opts = dict(entity=entity, project=project or self.name, group=group, tags=tags, **kwargs)
        self._wandb_timeout = startup_timeout
        self.wandb = True

    def enable_tensorboard(self, logdir: str | None = None):
        """Write the per-epoch tracker scalars as TensorBoard event files
        (root only; needs ``tensorboardX``). Default logdir:
        ``<checkpoint_dir>/tb``, resolved at run start."""
        import tensorboardX  # noqa: F401 - a missing install surfaces at call time

        self._tensorboard_dir = logdir if logdir is not None else "__checkpoint__"
        return self

    @runtime.root_only
    def _start_wandb(self):
        import wandb as _wandb

        wandb_set_startup_timeout(self._wandb_timeout)
        _wandb.init(config=self.config.to_dict(resolve=True), name=self.name, **self._wandb_opts)

    # ----------------------------------------------------------- preemption
    def enable_preemption_handling(self, signals: tuple[str, ...] | None = ("SIGTERM",)):
        """Exit cleanly at the next save boundary when any of ``signals``
        arrives on ANY rank (Slurm jobs typically arrange
        ``--signal=USR1@60``: pass ``("SIGUSR1",)``; ``signals=None`` takes
        the guard's default: SIGTERM + SIGINT, plus SIGUSR1 inside a Slurm
        step).

        With epoch checkpointing the drain lands at the epoch boundary (the
        finished epoch has been saved); with ``checkpoint_every_steps()`` it
        lands at the next step save mid-epoch. Either way the stage is NOT
        marked stopped, and the root writes a requeue verdict
        (``requeue.json``) so that a requeued run resumes where this one
        drained."""
        # re-arming: restore the ORIGINAL dispositions first, so the new guard
        # records them (not our previous handler)
        self._preemption.uninstall()
        self._preemption = runtime.PreemptionGuard(signals=signals).install()

    def _preemption_coordinated(self) -> bool:
        """Whether ANY rank caught a preemption signal."""
        return self._preemption.coordinated()

    def _write_requeue_verdict(self, requeue: bool, kind: str, reason: str, force: bool = False, **extra) -> None:
        """Root-only, first-writer-wins requeue verdict of this run (a
        preemption or hang verdict must not be overwritten by the teardown's
        generic classification; ``force`` is for the one legitimate
        supersession: a run that recovered from a stall the watchdog flagged
        and completed). No-op without a checkpoint dir: there is nowhere
        durable to resume from."""
        if (self._verdict_written and not force) or self.checkpoint_dir is None or not runtime.is_root():
            return
        try:
            if not self.checkpoint_dir.exists:
                return  # e.g. the run failed before _init_checkpointing created it
            write_requeue_verdict(self.checkpoint_dir.path, requeue, reason, kind, **extra)
            self._verdict_written = True
            self._verdict_kind = kind
            self.logger.info("requeue verdict: requeue=%s (%s) — %s", requeue, kind, reason)
        except Exception:
            self.logger.warning("could not write requeue verdict", exc_info=True)

    def _classify_failure(self, exc: BaseException) -> tuple[bool, str, str]:
        """(requeue, kind, reason) for an uncaught exception: deterministic
        failures (a NaN loss) are not requeued, since they recur; transient
        ones (stragglers, filesystem errors) are."""
        if isinstance(exc, KeyboardInterrupt):
            return False, "user-interrupt", "run aborted by user (KeyboardInterrupt)"
        if isinstance(exc, runtime.BarrierTimeout):
            return True, "hang", (f"barrier '{exc.tag}' timed out; straggler ranks {exc.stragglers or 'unknown'}"
                                  " — transient by default")
        if isinstance(exc, FloatingPointError):
            return False, "exception", f"non-finite loss is deterministic: {exc}"
        if isinstance(exc, OSError):
            return True, "exception", f"filesystem/IO error ({type(exc).__name__}: {exc}) — transient by default"
        return False, "exception", f"{type(exc).__name__}: {exc}"

    # ----------------------------------------------------------- registries
    def set_mesh(self, mesh_or_axes) -> None:
        """Set the device mesh: a named ``DeviceMesh``, or an axes dict like
        ``{'data': -1}`` / ``{'fsdp': 2, 'model': 2}`` (one process per device,
        ``parallel.mesh.create_mesh``; a single process gets a one-rank process
        group). Default if never called: a single ``data`` axis over all
        processes. Call it before ``register_model``."""
        if self.models:
            raise ValueError("set_mesh() must come before register_model(): the models are laid out already")
        if isinstance(mesh_or_axes, dict):
            self.mesh = mesh_lib.create_mesh(mesh_or_axes, device=self.device)
        else:
            self.mesh = mesh_or_axes

    def _init_mesh(self) -> None:
        """The default mesh, ``{data: world}``: nothing on it is sharded, so no
        ``DeviceMesh`` is built (``register_model`` checks the policy on it)."""
        if not runtime.is_initialized():
            runtime.init_auto(self.device)

    def register_model(self, name: str, model: torch.nn.Module, sharding: Any = "replicate", verbose: bool = True):
        """Register a module, move it to the pipeline's device and lay it out
        on the mesh under the parameter policy ``sharding``:

        - ``"replicate"`` (default, the reference's DDP semantics): a whole copy
          on every process; the stage averages the gradients over the
          data-parallel processes every step;
        - ``"fsdp"``: the largest divisible dim of each parameter sharded over
          the ``fsdp`` axis (FSDP2; HSDP with a ``data`` axis);
        - a rule list ``[(regex, spec), ...]`` on the flax path (e.g.
          ``llama_partition_rules()``): ``fsdp`` as above, ``model`` as tensor
          parallelism;
        - a callable ``(path, leaf) -> spec`` on the flax path.

        First rank 0's parameters and buffers are broadcast to every rank, so
        all start equal. Each process then feeds the batch of its
        data-parallel coordinate (``parallel.mesh.data_parallel_rank``);
        processes that differ only along ``model`` feed the same batch. A
        ``model`` placement the model cannot execute raises ``ValueError``."""
        if name in self.models:
            raise ValueError(f"Model with name {name} already exists")
        if not isinstance(model, torch.nn.Module):
            raise ValueError("register_model needs a torch.nn.Module")
        model.to(self.device)
        if self.mesh is None:
            self._init_mesh()
        # a model registered before run() must see the world size too, or it
        # would skip the broadcast and train from per-rank weights
        broadcast_parameters(model)
        plan = None
        if self.mesh is not None:
            plan = mesh_lib.shard_module(model, self.mesh, sharding)
            self.tracker.ranks = plan.metric_ranks
            where = f"mesh {plan.axes}"
        else:
            # the default mesh: the policy can place nothing there (a split
            # over 'data' raises)
            axes = {mesh_lib.DATA: runtime.world_size()}
            mesh_lib.placements(model, axes, sharding)
            where = f"mesh {axes} (default)"
        self.models[name] = ModelEntry(name=name, module=model, sharding=sharding, plan=plan)
        if verbose:
            n_params = sum(p.numel() for p in model.parameters())
            policy = sharding if isinstance(sharding, str) else "custom rules"
            self.logger.info(f'Model "{name}":\n    - Parameters: {n_params / 1e6:.1f} M\n    - Device: {self.device}'
                             f'\n    - Sharding policy: {policy}\n    - Mesh: {where} over {runtime.world_size()} '
                             'process(es)')

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

    def barrier(self, timeout: float | None = None):
        """All-process barrier with a timeout (600 s by default) that names
        stragglers."""
        runtime.barrier("pipeline", timeout if timeout is not None else 600.0)

    # ------------------------------------------------------------ lifecycle
    def run(self):
        """Run all registered stages sequentially."""
        with _run_guard(self):
            self._pre_run()
            for stage in self.stages:
                self.current_stage = stage
                stage.run()
                # the stage's own coordinated decision: already in lockstep
                # across ranks
                if stage._preempt_exit:
                    self.logger.info("preemption requested; skipping remaining stages")
                    extra = {"stage": stage.name, "epoch": stage.current_epoch,
                             "mid_epoch": bool(getattr(stage, "_mid_epoch_exit", False))}
                    lat = getattr(stage, "_last_save_latency_s", None)
                    if lat is not None:
                        extra["save_on_preempt_latency_s"] = round(float(lat), 4)
                    sig = self._preemption.signal_name or "coordinated-drain"
                    self._write_requeue_verdict(
                        True, "preemption", f"drained cleanly on {sig}; state saved at the last boundary, resumable",
                        **extra,
                    )
                    break
            self._post_run()

    def pre_run(self):
        pass

    def post_run(self):
        pass

    def resume_run(self):
        pass

    def _pre_run(self):
        if len(self.stages) == 0:
            raise ValueError("No stages defined. Use append_stage() to add stages to the pipeline.")
        self._verdict_written = False
        self._verdict_kind = None
        if not runtime.is_initialized():
            runtime.init_auto(self.device)
        # no process creates the directory before every process looked for it
        self.barrier()
        if self.checkpointing_enabled:
            self._init_checkpointing()
        self._arm_telemetry()
        if self.wandb:
            self._start_wandb()
        if self._tensorboard_dir is not None and runtime.is_root():
            from .utils.tensorboard import TensorBoardWriter

            tb_dir = self._tensorboard_dir
            if tb_dir == "__checkpoint__":
                if self.checkpoint_dir is None:
                    raise ValueError(
                        "enable_tensorboard() without a logdir needs checkpointing enabled "
                        "(the default logdir is <checkpoint_dir>/tb); pass an explicit logdir"
                    )
                tb_dir = str(self.checkpoint_dir.path / "tb")
            self._tb_writer = TensorBoardWriter(tb_dir)
        self.barrier()
        self.start_time = datetime.now()
        add_log_handlers(self.logger)
        header = experiment_header(self.name, str(self.checkpoint_dir) if self.checkpoint_dir else None,
                                   self.start_time)
        self.logger.info("\n" + header)
        if self.resumed:
            self._resume_run()
        diagnostics = general_diagnostics()
        diagnostics += "\n* RUNTIME:\n"
        diagnostics += f"    - device: {self.device}\n"
        diagnostics += f"    - processes: {runtime.world_size()} (rank {runtime.rank()})"
        diagnostics += "\n* CONFIG:\n"
        diagnostics += "\n".join(f"    {line}" for line in self.config.to_yaml(resolve=True).splitlines())
        self.logger.info(diagnostics)
        self.pre_run()

    @runtime.root_only
    def _init_checkpointing(self):
        if not self.checkpoint_dir.is_valid:
            self.checkpoint_dir.create()
            self.checkpoint_dir.save_config(self.config)
        self.io_redirector = IORedirector(self.checkpoint_dir.log_file)
        self.io_redirector.install()

    def _arm_telemetry(self):
        """Start the flight recorder: journal, goodput ledger, hang watchdog.
        Every process journals and watches; only the root prints the ledger."""
        cfg = self._telemetry_cfg
        if cfg is None or cfg is False:
            return
        from .telemetry import journal as journal_mod
        from .telemetry.watchdog import HangWatchdog

        opts = dict(cfg) if isinstance(cfg, dict) else {}
        tdir = opts.get("dir")
        if tdir is None and not isinstance(cfg, (bool, dict)):
            tdir = os.fspath(cfg)
        if tdir is None:
            tdir = str(self.checkpoint_dir.path / "telemetry") if self.checkpoint_dir is not None else "telemetry"
        self.telemetry_dir = os.path.abspath(tdir)
        self._journal = journal_mod.SpanJournal(self.telemetry_dir, rank=runtime.rank(),
                                                ring_size=int(opts.get("ring_size", 1024)))
        journal_mod.activate(self._journal)
        self._journal.start()
        if self.checkpoint_dir is not None:
            forensics_dir = str(self.checkpoint_dir.path / "forensics")
        else:
            forensics_dir = os.path.normpath(os.path.join(self.telemetry_dir, os.pardir, "forensics"))
        self._watchdog = HangWatchdog(
            forensics_dir,
            rank=runtime.rank(),
            world_size=runtime.world_size(),
            threshold_s=float(opts.get("hang_threshold_s", 600.0)),
            interval_s=float(opts.get("watchdog_interval_s", 10.0)),
            journal=self._journal,
        )
        self._journal.on_emit = self._watchdog.notify

        def hang_verdict(reason: str) -> None:
            # a hang is transient by default: requeue, and name the stragglers
            extra = {}
            stragglers = runtime.barrier_state().get("stragglers")
            if stragglers:
                extra["stragglers"] = stragglers
            self._write_requeue_verdict(True, "hang", reason, **extra)

        self._watchdog.on_dump = hang_verdict
        self._watchdog.start()
        self._run_span_t0 = journal_mod.now()
        if runtime.is_root():
            self.logger.info("telemetry armed: journal %s, forensics %s (hang threshold %.0fs)",
                             self.telemetry_dir, self._watchdog.dump_dir, self._watchdog.threshold_s)

    def _telemetry_ledger(self):
        """The end-of-run goodput ledger: the ``run`` span, then on the root
        the table, the advice lines and ``goodput.json`` beside the journals."""
        from .telemetry import journal as journal_mod
        from .telemetry.goodput import ledger_from_tracker

        if self._run_span_t0 is not None:
            journal_mod.emit("run", self._run_span_t0, label=self.name or "run")
        if not runtime.is_root():
            return
        ledger = ledger_from_tracker(self.tracker)
        if ledger.rows:
            self.logger.info("\n%s", ledger.format_table())
            for line in ledger.advise():
                self.logger.warning("goodput advisor: %s", line)
        try:
            with open(os.path.join(self.telemetry_dir, "goodput.json"), "w", encoding="utf-8") as f:
                json.dump(ledger.to_dict(), f)
        except OSError:
            self.logger.warning("could not write %s/goodput.json", self.telemetry_dir, exc_info=True)

    def _disarm_telemetry(self, exc: BaseException | None = None):
        """The teardown half of ``_arm_telemetry``, on every exit path. An
        uncaught exception first leaves a forensics dump."""
        from .telemetry import journal as journal_mod

        if self._watchdog is not None:
            if exc is not None and not isinstance(exc, KeyboardInterrupt):
                try:
                    path = self._watchdog.dump(f"uncaught exception: {type(exc).__name__}: {exc}")
                    self.logger.info("forensics dumped to %s", path)
                except Exception:
                    self.logger.warning("forensics dump failed", exc_info=True)
            self._watchdog.stop()
            self._watchdog = None
        if self._journal is not None:
            if journal_mod.active_journal() is self._journal:
                journal_mod.deactivate()
            self._journal.close()
            self._journal = None

    def _resume_run(self):
        self.logger.info(f"Resuming training from checkpoint: {self.checkpoint_dir}")
        self.resume_run()

    def _post_run(self):
        self.stop_time = datetime.now()
        if self.checkpoint_dir is not None:
            self.checkpoint_dir.wait_until_finished()
        if self.telemetry_armed:
            self._telemetry_ledger()
        self.logger.info(f"Finished training in {self.stop_time - self.start_time} ({self.stop_time})")
        if self.checkpointing_enabled:
            self.logger.info(f"Outputs have been saved to {self.checkpoint_dir}")
        # a run that got here without a preemption verdict finished for real:
        # the requeue wrapper stands down. A survived watchdog stall is the one
        # verdict that completion supersedes (the run recovered).
        self._write_requeue_verdict(False, "completed", "run finished all stages",
                                    force=(self._verdict_kind == "hang"))
        self.post_run()

    def _post_epoch(self):
        """Send the finished epoch's values to wandb and TensorBoard (root only)."""
        if not ((self.wandb or self._tb_writer is not None) and runtime.is_root()):
            return
        metrics = {name: self.tracker[name][-1] for name in self.tracker if self.tracker[name]}
        if self.wandb:
            wandb.log(metrics)
        if self._tb_writer is not None:
            # the stage's _reduce_metrics has advanced the tracker already
            self._tb_writer.log_epoch(metrics, epoch=self.tracker.epoch - 1)

    def _teardown(self, exc: BaseException | None) -> None:
        """Runs whether the stages finished, raised or were interrupted; the
        exception (if any) propagates afterwards."""
        if isinstance(exc, KeyboardInterrupt):
            self.logger.info("=== run aborted by user (KeyboardInterrupt) ===")
        elif exc is not None:
            self.logger.error("=== run failed; traceback follows ===", exc_info=exc)
        if exc is not None:
            # first writer wins: a preemption verdict of this run stays
            requeue, kind, reason = self._classify_failure(exc)
            self._write_requeue_verdict(requeue, kind, reason)
        try:
            self._disarm_telemetry(exc)
        except Exception:
            self.logger.warning("telemetry teardown failed", exc_info=True)
        if self.checkpoint_dir is not None:
            # a failed or interrupted run may still have an async save in
            # flight: let it commit (or log its own error) rather than orphan
            # a half-written save behind the exception about to propagate
            try:
                self.checkpoint_dir.wait_until_finished()
            except Exception:
                self.logger.warning("pending async checkpoint save failed during teardown", exc_info=True)
        if self.wandb and wandb_is_initialized():
            wandb.finish(exit_code=0 if exc is None else 1)
        if self._tb_writer is not None:
            self._tb_writer.close()
            self._tb_writer = None
        if self.io_redirector is not None:
            self.io_redirector.uninstall()
        # restore process-wide signal dispositions: a stale handler would make
        # a post-run SIGTERM a silent no-op
        self._preemption.uninstall()


@contextmanager
def _run_guard(pipeline: TrainingPipeline):
    try:
        yield
    except BaseException as exc:
        pipeline._teardown(exc)
        raise
    else:
        pipeline._teardown(None)
