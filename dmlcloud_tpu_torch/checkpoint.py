"""Checkpoint directories and the tensor state kept in them.

Counterpart of ``dmlcloud_tpu/checkpoint.py``: collision-free run-directory
naming ``{name}-{YYYY.MM.DD-HH.MM}-{id}``, Slurm-requeue rediscovery by job id,
the requeue verdict (``requeue.json``, schema v1), and the directory contract::

    <path>/
      .dmlcloud_tpu     # indicator
      config.yaml       # experiment config snapshot
      log.txt           # stdout/stderr tee (utils/logging.py)
      .slurm-jobid      # written iff launched under Slurm
      requeue.json      # the run's requeue verdict
      meta/<scope>/     # JSON resume sidecars (stage.py)
      meta/_sharding/<scope or _root>/<step>.json  # sharding sidecars
      state/<scope>/<step>/  # tensor state of one save

File names and JSON schemas are the JAX package's, so either package finds,
validates and reads the other's run directories and verdicts. The tensor files
are not interchangeable: the JAX package writes Orbax checkpoints, this one
writes ``torch.distributed.checkpoint`` (DCP) directories (``*.distcp`` shards
plus a ``.metadata`` file that DCP renames into place last, which marks the
save as committed).

A save is collective (every process writes its shards into the step
directory; DCP stores a tensor that every rank holds, a replicated model's,
once); its collectives run on the runtime's ``side_group``, so an async save's
writer thread never interleaves them with the training loop's collectives on
the default group. The contract files and retention are root-only. Async saves
(``dcp.async_save``) copy the state to host memory before the call returns,
so the next optimizer step may mutate the live tensors at once; the write
runs on a background thread, and each scope has at most one save in flight.
Retention is host-side: the newest ``max_to_keep`` committed steps, or a
preservation policy (``LatestN``/``BestN``/``AnyPreservationPolicy``, the
reference's keep-best composition) evaluated by ``steps_to_keep``.

Elastic restore (the reference's :355-580, doc/elasticity.md): every save
writes, from rank 0 and best effort, a sharding sidecar with the mesh's shape
and each saved tensor's spec (the parameter policy's, as
``parallel.mesh.sharding_record`` gives it: by flax path, in the flax layout,
with the map onto the torch tensor's dims; else the tensor's own DTensor
placements). ``restore_state(mesh=)`` then restores onto any mesh without a
template: ``restore_template`` builds one from DCP's own metadata (shapes and
dtypes) with each entry laid out by its saved spec re-targeted onto the new
mesh (``respec_for_mesh``), and DCP reshards on read. The specs decide only
that layout: where a template is given, its own tensors (e.g. a live FSDP2
module's DTensors) decide it, and DCP's metadata says where the saved shards
are.

Not here yet: remote (``gs://``) paths.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import random
import shutil
import string
import threading
import time
import warnings
from datetime import datetime
from pathlib import Path
from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist
import torch.distributed.checkpoint as dcp

from .parallel import runtime
from .utils import slurm
from .utils.config import Config, as_config

_logger = logging.getLogger("dmlcloud_tpu_torch")

# DCP warns on every save and load without a process group, the background
# write of an async save included; one process is an intended case here
warnings.filterwarnings("ignore", message="torch.distributed is disabled, unavailable or uninitialized")

#: indicator file marking a valid run directory
INDICATOR_FILE = ".dmlcloud_tpu"

#: the requeue verdict a run leaves behind: one JSON object answering whether
#: the job should be resubmitted, and why
REQUEUE_FILE = "requeue.json"

#: the file DCP writes last into a step directory: its presence marks a commit
_COMMIT_FILE = ".metadata"


def as_run_path(path: Any) -> Path:
    """An absolute, user-expanded ``Path`` (stable equality across processes)."""
    return Path(os.path.abspath(os.path.expanduser(os.fspath(path))))


def atomic_write_text(target: Path, text: str) -> None:
    """Crash-safe small-file write: a temporary file, then ``os.replace``."""
    target = Path(target)
    tmp = target.parent / f".{target.name}.tmp"
    tmp.write_text(text)
    os.replace(tmp, target)


def write_requeue_verdict(run_dir: Any, requeue: bool, reason: str, kind: str, **extra) -> None:
    """Atomically write the requeue verdict for ``run_dir`` (schema v1)::

        {"v": 1, "requeue": true|false, "kind": "preemption"|"hang"|
         "exception"|"user-interrupt"|"completed", "reason": "...",
         "written_at": iso8601, ...extra}

    Call from ONE process (the root). ``extra`` carries kind-specific fields
    (stage, epoch and save latency for preemptions)."""
    record = {
        "v": 1,
        "requeue": bool(requeue),
        "kind": kind,
        "reason": reason,
        "written_at": datetime.now().isoformat(timespec="seconds"),
    }
    record.update(extra)
    atomic_write_text(as_run_path(run_dir) / REQUEUE_FILE, json.dumps(record, indent=1))


def read_requeue_verdict(run_dir: Any) -> dict | None:
    """The run's requeue verdict, or None when absent or corrupt."""
    try:
        raw = json.loads((as_run_path(run_dir) / REQUEUE_FILE).read_text())
        if raw.get("v") == 1 and isinstance(raw.get("requeue"), bool):
            return raw
    except (OSError, ValueError, AttributeError):
        pass
    return None


def sanitize_filename(filename: str) -> str:
    return filename.replace("/", "_")


def generate_id(length: int = 8) -> str:
    """URL-safe random id."""
    alphabet = string.ascii_lowercase + string.digits
    return "".join(random.choices(alphabet, k=length))


def generate_checkpoint_path(root: Any, name: str | None = None, dt: datetime | None = None) -> Path:
    """``{root}/{name}-{YYYY.MM.DD-HH.MM}-{id}``: collision-free and sortable."""
    if name is None:
        name = "run"
    if dt is None:
        dt = datetime.now()
    stamp = dt.strftime("%Y.%m.%d-%H.%M")
    return as_run_path(root) / sanitize_filename(f"{name}-{stamp}-{generate_id()}")


def find_slurm_checkpoint(root: Any) -> Path | None:
    """Scan ``root`` for a run dir whose recorded Slurm job id matches the
    current job: how a requeued job finds its own previous checkpoint."""
    job_id = slurm.slurm_job_id()
    if job_id is None:
        return None
    root = as_run_path(root)
    if not root.exists():
        return None
    for child in root.iterdir():
        ckpt = CheckpointDir(child)
        if ckpt.is_valid and ckpt.slurm_job_id == job_id:
            return child
    return None


# ---------------------------------------------------------------------------
# retention policies: the reference's host-side preservation-policy shim
# (utils/orbax_compat.py), same fields and semantics
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LatestN:
    """Keep the ``n`` most recent steps."""

    n: int = 1


@dataclasses.dataclass
class BestN:
    """Keep the ``n`` best steps by ``get_metric_fn`` over the metrics dict
    passed to ``save_state``. ``reverse=False`` means larger is better;
    metricless steps survive only when ``keep_checkpoints_without_metrics``."""

    get_metric_fn: Callable[[dict], float] = None
    reverse: bool = False
    n: int | None = None
    keep_checkpoints_without_metrics: bool = True


@dataclasses.dataclass
class AnyPreservationPolicy:
    """Keep a step if ANY member policy keeps it (union)."""

    policies: Sequence[Any] = ()


def steps_to_keep(policy: Any, steps: Sequence[int], metrics_by_step: dict[int, dict]) -> set[int]:
    """The set of committed ``steps`` that ``policy`` KEEPS (the caller
    deletes the complement); a union over ``AnyPreservationPolicy`` members."""
    steps = sorted(set(int(s) for s in steps))
    members = list(policy.policies) if isinstance(policy, AnyPreservationPolicy) else [policy]
    keep: set[int] = set()
    for member in members:
        if isinstance(member, LatestN):
            keep.update(steps[-int(member.n):] if member.n else [])
        elif isinstance(member, BestN):
            ranked = [s for s in steps if s in metrics_by_step]
            unranked = [s for s in steps if s not in metrics_by_step]
            if member.keep_checkpoints_without_metrics:
                keep.update(unranked)
            # ascending sort; larger-is-better keeps the tail, reverse=True
            # (smaller is better) keeps the head
            ranked.sort(key=lambda s: member.get_metric_fn(metrics_by_step[s]))
            if member.n is None:
                keep.update(ranked)
            elif member.n > 0:
                keep.update(ranked[-member.n:] if not member.reverse else ranked[: member.n])
        else:
            raise TypeError(f"unsupported preservation policy {type(member).__name__!r}; "
                            "use LatestN/BestN/AnyPreservationPolicy")
    return keep


def _normalize_opt(v: Any, _seen: frozenset = frozenset()) -> Any:
    """Structural key of a state-manager option, comparable across calls:
    callables map to their qualname plus their captured closure values,
    dataclass policies to their fields, anything else to ``(type, repr)``. So
    re-specifying an identical configuration (a keep-best lambda rebuilt per
    call) is idempotent, and a different one trips the changed-options guard."""
    if id(v) in _seen:
        return "<recursive>"
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        sub = _seen | {id(v)}
        return (type(v).__name__,
                tuple((f.name, _normalize_opt(getattr(v, f.name), sub)) for f in dataclasses.fields(v)))
    if callable(v):
        key: Any = getattr(v, "__qualname__", repr(type(v)))
        cells = getattr(v, "__closure__", None)
        if cells:
            sub = _seen | {id(v)}
            try:
                key = (key, tuple(_normalize_opt(c.cell_contents, sub) for c in cells))
            except ValueError:  # an empty (yet-unassigned) cell
                pass
        return key
    if isinstance(v, (list, tuple)):
        sub = _seen | {id(v)}
        return tuple(_normalize_opt(x, sub) for x in v)
    if isinstance(v, (str, int, float, bool, bytes, type(None))):
        return v
    return (type(v).__name__, repr(v))


def _no_dist() -> bool:
    """DCP without a process group: one process."""
    return not (dist.is_available() and dist.is_initialized())


def _nbytes(tree: Any) -> int:
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    return tree.numel() * tree.element_size() if hasattr(tree, "element_size") else 0


def _sidecar_record(state: dict, sharding: dict | None) -> dict:
    """The sharding sidecar of ``state``: an entry named after a parameter of
    ``sharding`` (``parallel.mesh.sharding_record``) gets that parameter's spec
    under its flax path (``params/layer_0/attn/q_proj/kernel``, as the
    reference's sidecar names it), any other its DTensor placements over the
    torch dims (a plain tensor: replicated)."""
    from torch.distributed.tensor import DTensor

    params = (sharding or {}).get("params", {})
    mesh = dict((sharding or {}).get("mesh", {}))
    specs, entries = {}, {}

    def visit(node: dict, prefix: tuple) -> None:
        nonlocal mesh
        for name, value in node.items():
            keys = prefix + (str(name),)
            if isinstance(value, dict):
                visit(value, keys)
                continue
            if not hasattr(value, "shape"):
                continue
            if name in params:
                rec = params[name]
                path = "/".join(keys[:-1] + (rec["path"],))
                specs[path] = rec["spec"]
                entries[".".join(keys)] = {"spec": path, "shape": rec["shape"], "dims": rec["dims"]}
                continue
            by_dim: list[list[str]] = [[] for _ in range(value.dim())]
            if isinstance(value, DTensor):
                dmesh = value.device_mesh
                mesh = mesh or dict(zip(dmesh.mesh_dim_names, dmesh.shape))
                for axis, placement in zip(dmesh.mesh_dim_names, value.placements):
                    if placement.is_shard():
                        by_dim[placement.dim].append(axis)
            spec = [None if not a else a[0] if len(a) == 1 else a for a in by_dim]
            while spec and spec[-1] is None:
                spec.pop()
            path = "/".join(keys)
            specs[path] = spec
            entries[".".join(keys)] = {"spec": path, "shape": list(value.shape), "dims": list(range(value.dim()))}

    visit(state, ())
    return {"v": 1, "mesh": mesh or {"data": runtime.world_size()}, "specs": specs, "entries": entries}


def _placements(spec: Sequence, dims: Sequence, mesh_dims: list[str]) -> list:
    """DTensor placements, one per mesh dim, for ``spec`` over the flax dims
    whose torch dims ``dims`` gives (None: the fused heads dim, 0)."""
    from torch.distributed.tensor import Replicate, Shard

    placements = [Replicate() for _ in mesh_dims]
    for i, entry in enumerate(spec):
        for axis in (() if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)):
            placements[mesh_dims.index(axis)] = Shard(0 if dims[i] is None else dims[i])
    return placements


class StateManager:
    """The saves of one scope: ``state/<scope>/<step>/`` DCP directories,
    at most one save in flight, host-side retention after each commit.

    ``last_save`` describes the newest save: its step, bytes, the seconds the
    call blocked (the whole save when synchronous; the copy to host memory
    when async) and, once written, the seconds the background commit took."""

    def __init__(self, root: Path, max_to_keep: int | None, async_save: bool, policy: Any = None,
                 metrics_file: Path | None = None):
        self.root = root
        self.max_to_keep = max_to_keep
        self.async_save = async_save
        self.policy = policy
        self._metrics_file = metrics_file
        self._metrics: dict[int, dict] | None = None  # loaded on first use
        self._pending = None  # (step, future, commit-time recorded, metrics) of an async save
        self.last_save: dict | None = None

    def _step_dirs(self) -> dict[int, Path]:
        if not self.root.is_dir():
            return {}
        return {int(p.name): p for p in self.root.iterdir() if p.is_dir() and p.name.isdigit()}

    def all_steps(self) -> list[int]:
        """Committed steps, ascending."""
        return sorted(s for s, p in self._step_dirs().items() if (p / _COMMIT_FILE).exists())

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state_dict: dict, metrics: dict | None = None) -> None:
        self.wait_until_finished()  # single flight
        path = self.root / str(int(step))
        path.mkdir(parents=True, exist_ok=True)
        info = {"step": int(step), "bytes": _nbytes(state_dict), "async": self.async_save, "commit_s": None}
        t0 = time.perf_counter()
        if self.async_save:
            ret = dcp.async_save(state_dict, checkpoint_id=path, no_dist=_no_dist(),
                                 process_group=runtime.side_group())
            future = getattr(ret, "upload_completion", ret)  # AsyncSaveResponse on newer torch
            t1 = time.perf_counter()
            committed = threading.Event()  # result() may return before the callback ran
            future.add_done_callback(lambda _f: (info.update(commit_s=time.perf_counter() - t1), committed.set()))
            self._pending = (int(step), future, committed, metrics)
        else:
            dcp.save(state_dict, checkpoint_id=path, no_dist=_no_dist(), process_group=runtime.side_group())
            t1 = time.perf_counter()
        info["blocking_s"] = t1 - t0
        self.last_save = info
        if not self.async_save:
            self._finalize(int(step), metrics)

    def wait_until_finished(self) -> None:
        """Block until the save in flight (if any) has committed, then apply
        retention. A failed background write re-raises here."""
        if self._pending is None:
            return
        step, future, committed, metrics = self._pending
        self._pending = None
        future.result()
        committed.wait()
        self._finalize(step, metrics)

    def _finalize(self, step: int, metrics: dict | None) -> None:
        if self.policy is None and self.max_to_keep is None:
            return
        dirs = self._step_dirs()
        steps = set(self.all_steps()) | {step}
        if self.policy is not None:
            known = self._policy_metrics()
            if metrics is not None:
                known[step] = metrics
            keep = steps_to_keep(self.policy, steps, known)
        else:
            keep = set(sorted(steps)[-self.max_to_keep:]) if self.max_to_keep > 0 else set()
        # everything else goes, uncommitted leftovers of killed runs included
        for old in sorted(set(dirs) - keep):
            self.delete(old)
        if self.policy is not None and runtime.is_root():
            self._metrics_file.parent.mkdir(parents=True, exist_ok=True)
            atomic_write_text(self._metrics_file, json.dumps({str(k): v for k, v in self._metrics.items()}))

    def _policy_metrics(self) -> dict[int, dict]:
        """Rankings of earlier saves; they persist across restarts in a
        root-written JSON sidecar."""
        if self._metrics is None:
            self._metrics = {}
            try:
                raw = json.loads(self._metrics_file.read_text())
                self._metrics.update({int(k): v for k, v in raw.items()})
            except (OSError, ValueError, AttributeError):
                pass  # fresh run dir: rank what we have
        return self._metrics

    def delete(self, step: int) -> None:
        if self._metrics is not None:
            self._metrics.pop(int(step), None)
        if runtime.is_root():
            shutil.rmtree(self.root / str(int(step)), ignore_errors=True)

    def keys(self, step: int) -> set[str]:
        """Flattened keys (``params.embed.weight``, ...) saved at ``step``."""
        return set(dcp.FileSystemReader(self.root / str(int(step))).read_metadata().state_dict_metadata)

    def restore(self, step: int, state_dict: dict) -> dict:
        """Fill the tensors of ``state_dict`` in place from ``step``."""
        dcp.load(state_dict, checkpoint_id=self.root / str(int(step)), no_dist=_no_dist(),
                 process_group=runtime.side_group())
        return state_dict

    def close(self) -> None:
        self.wait_until_finished()


class CheckpointDir:
    """A single run directory and its contract files (layout in the module
    docstring)."""

    _ALL_SCOPES = object()  # sentinel: scope=None names a real scope

    def __init__(self, path: Any):
        self.path = as_run_path(path)
        self._state_managers: dict[str | None, StateManager] = {}
        self._manager_opts: dict[str | None, tuple] = {}
        #: transient-filesystem-error policy for save dispatch: total attempts
        #: and the first backoff (doubling per retry, capped at 8 s)
        self.save_retries = 3
        self.save_backoff_s = 0.5

    # -- contract files -----------------------------------------------------
    @property
    def config_file(self) -> Path:
        return self.path / "config.yaml"

    @property
    def indicator_file(self) -> Path:
        return self.path / INDICATOR_FILE

    @property
    def log_file(self) -> Path:
        return self.path / "log.txt"

    @property
    def slurm_file(self) -> Path:
        return self.path / ".slurm-jobid"

    @property
    def requeue_file(self) -> Path:
        return self.path / REQUEUE_FILE

    @property
    def state_dir(self) -> Path:
        return self.path / "state"

    @property
    def exists(self) -> bool:
        return self.path.exists()

    @property
    def is_valid(self) -> bool:
        return self.path.is_dir() and self.indicator_file.exists()

    @property
    def slurm_job_id(self) -> str | None:
        if not self.slurm_file.exists():
            return None
        return self.slurm_file.read_text().strip()

    def create(self) -> None:
        """Create the directory and its contract files (root only)."""
        if self.exists:
            raise RuntimeError(f"checkpoint dir already exists: {self.path}")
        self.path.mkdir(parents=True)
        self.indicator_file.touch()
        self.log_file.touch()
        if slurm.slurm_job_id() is not None:
            self.slurm_file.write_text(slurm.slurm_job_id())

    def save_config(self, config: Any) -> None:
        as_config(config).save(self.config_file)

    def load_config(self) -> Config:
        return Config.load(self.config_file)

    # -- tensor state -------------------------------------------------------
    def has_state_manager(self, scope: str | None = None) -> bool:
        """Whether the manager of ``scope`` exists (its options are bound)."""
        return scope in self._state_managers

    def state_manager(self, scope: str | None = None, max_to_keep: int | None = None,
                      async_save: bool | None = None, preservation_policy: Any = None) -> StateManager:
        """The manager of ``state/`` (or ``state/<scope>``: stages save under
        their own scope, so step ids never collide across stages). Saves and
        restores are collective.

        Defaults: ``max_to_keep=3``, ``async_save=True``; a
        ``preservation_policy`` owns retention outright. Options bind at the
        FIRST call per scope (e.g. in ``pre_stage``); passing different
        options for an existing scope raises."""
        explicit = max_to_keep is not None or async_save is not None or preservation_policy is not None
        requested = (
            (None if preservation_policy is not None else 3) if max_to_keep is None else max_to_keep,
            True if async_save is None else async_save,
            _normalize_opt(preservation_policy),
        )
        if scope in self._state_managers:
            if explicit and requested != self._manager_opts[scope]:
                raise RuntimeError(
                    f"state manager for scope {scope!r} already exists with options "
                    f"{self._manager_opts[scope]}; configure it via state_manager(...) BEFORE the "
                    "first save/restore for that scope (e.g. in pre_stage)"
                )
            return self._state_managers[scope]
        root = self.state_dir / scope if scope else self.state_dir
        metrics_file = self.path / "meta" / (scope or "_root") / "_policy_metrics.json"
        self._state_managers[scope] = StateManager(root, requested[0], requested[1], preservation_policy,
                                                   metrics_file)
        self._manager_opts[scope] = requested
        return self._state_managers[scope]

    def save_state(self, step: int, state: dict, scope: str | None = None, metrics: dict | None = None,
                   sharding: dict | None = None) -> None:
        """Save a (nested) dict of tensors under ``state/<scope>/<step>``.
        A transient filesystem error (``OSError``) at dispatch is retried
        ``save_retries`` times with exponential backoff before the ORIGINAL
        error surfaces. ``metrics`` ranks the save for a keep-best policy.
        ``sharding`` (``parallel.mesh.sharding_record``) is what the sharding
        sidecar records of the entries named after a parameter."""
        self._retry_transient(lambda: self.state_manager(scope).save(step, state, metrics=metrics),
                              what=f"save of step {step} (scope {scope!r})")
        self._write_sharding_sidecar(scope, int(step), state, sharding)

    def _retry_transient(self, fn, what: str):
        attempts = max(int(self.save_retries), 1)
        delay = float(self.save_backoff_s)
        first: OSError | None = None
        for attempt in range(1, attempts + 1):
            try:
                return fn()
            except OSError as e:
                first = first or e
                if attempt == attempts:
                    break
                _logger.warning("checkpoint %s hit a transient filesystem error (%s: %s); retry %d/%d in %.1fs",
                                what, type(e).__name__, e, attempt, attempts - 1, delay)
                time.sleep(delay)
                delay = min(delay * 2, 8.0)
        raise first

    # -- sharding sidecar (elastic resharded restore) ------------------------
    def _sharding_sidecar_file(self, scope: str | None, step: int) -> Path:
        # a subtree of its own: meta/<scope>/ holds the stage's resume sidecars
        return self.path / "meta" / "_sharding" / (scope or "_root") / f"{int(step)}.json"

    def _write_sharding_sidecar(self, scope: str | None, step: int, state: dict, sharding: dict | None) -> None:
        """Root only: record the mesh's shape and every saved tensor's spec,
        then prune the sidecars of steps no longer kept. Best effort: a failed
        write degrades a template-free restore to ``policy``, never fails the
        save."""
        if not runtime.is_root():
            return
        try:
            record = _sidecar_record(state, sharding)
            target = self._sharding_sidecar_file(scope, step)
            target.parent.mkdir(parents=True, exist_ok=True)
            atomic_write_text(target, json.dumps(record))
            kept = set(self.state_manager(scope).all_steps()) | {int(step)}
            for f in target.parent.glob("*.json"):
                if f.stem.isdigit() and int(f.stem) not in kept:
                    f.unlink(missing_ok=True)
        except Exception:
            _logger.warning("could not write sharding sidecar for scope %r step %d (resharded restore will need an "
                            "explicit template/policy)", scope, step, exc_info=True)

    def read_sharding_sidecar(self, scope: str | None, step: int) -> dict | None:
        """The save-time sharding record of ``step`` (``{"v": 1, "mesh": {axis:
        size}, "specs": {path: spec}, "entries": {saved key: {"spec": path,
        "shape": [...], "dims": [...]}}}``), or None when absent or damaged."""
        try:
            raw = json.loads(self._sharding_sidecar_file(scope, step).read_text())
            if raw.get("v") == 1 and isinstance(raw.get("specs"), dict):
                return raw
        except (OSError, ValueError, AttributeError):
            pass
        return None

    def restore_template(self, step: int, scope: str | None = None, mesh: Any = None, policy: Any = None) -> dict:
        """A template for restoring ``step`` onto ``mesh`` (a ``DeviceMesh``),
        without the caller building the state: the structure, shapes and
        dtypes come from DCP's metadata; each entry is an empty DTensor on
        ``mesh``, laid out by its save-time spec (sharding sidecar) re-targeted
        with ``parallel.mesh.respec_for_mesh``: axes the new mesh lacks restore
        replicated, axes that stopped dividing move or drop. Without a sidecar
        (an older checkpoint) ``policy`` (``make_param_policy``'s values on the
        ``/``-joined key and torch shape; default ``"replicate"``) decides."""
        from torch.distributed.checkpoint.metadata import TensorStorageMetadata
        from torch.distributed.tensor import empty as dtensor_empty

        from .parallel import mesh as mesh_lib

        if mesh is None:
            raise ValueError("restore_template needs the target mesh")
        step_dir = self.state_manager(scope).root / str(int(step))
        try:
            meta = dcp.FileSystemReader(step_dir).read_metadata()
        except (OSError, ValueError) as exc:
            raise ValueError(f"no checkpoint metadata for step {step} (scope {scope!r})") from exc
        sidecar = self.read_sharding_sidecar(scope, step)
        if sidecar is None:
            _logger.warning("no sharding sidecar for scope %r step %d (checkpoint predates elastic resume?); "
                            "restoring with policy %r", scope, step, policy or "replicate")
        policy_fn = mesh_lib.make_param_policy(policy or "replicate")
        axes = mesh_lib.mesh_axes(mesh)
        entries = (sidecar or {}).get("entries", {})
        specs = (sidecar or {}).get("specs", {})
        template: dict = {}
        for key, md in meta.state_dict_metadata.items():
            if not isinstance(md, TensorStorageMetadata):
                continue  # the state holds tensors only
            shape = tuple(md.size)
            entry = entries.get(key)
            if entry is not None and entry.get("spec") in specs:
                spec = mesh_lib.respec_for_mesh(mesh_lib.spec_from_jsonable(specs[entry["spec"]]), entry["shape"],
                                                mesh)
                dims = entry["dims"]
            elif sidecar is not None:
                spec, dims = mesh_lib.P(), []  # saved unsharded (or its spec unrecorded)
            else:
                spec = policy_fn(key.replace(".", "/"), torch.empty(shape, device="meta"), axes)
                dims = list(range(len(shape)))
            t = dtensor_empty(shape, dtype=md.properties.dtype, device_mesh=mesh,
                              placements=_placements(spec, dims, list(mesh.mesh_dim_names)))
            path = meta.planner_data.get(key, (key,)) if meta.planner_data else (key,)
            node = template
            for part in path[:-1]:
                node = node.setdefault(part, {})
            node[path[-1]] = t
        return template

    def restore_state(self, step: int | None = None, template: dict | None = None, scope: str | None = None, *,
                      mesh: Any = None, policy: Any = None) -> dict | None:
        """Restore the latest (or a given) step. None when the scope holds no
        committed save. Two modes:

        - ``template=``: a dict of tensors with the saved structure that DCP
          fills in place (the live state's own tensors: no second copy on the
          device). Its tensors may lie on another mesh than the save's: DCP
          reshards on read (this is how stages resume);
        - ``mesh=`` (no template): the elastic restore. The template comes from
          ``restore_template`` (DCP's metadata plus the sharding sidecar,
          re-targeted onto ``mesh``; ``policy`` for a checkpoint without a
          sidecar); returns the nested dict of DTensors on ``mesh``.

        With neither it raises: a state without a layout has nowhere to go."""
        if template is None and mesh is None:
            raise ValueError("restore_state needs a template (the state dict to fill in place) or a mesh (an elastic "
                             "restore)")
        mgr = self.state_manager(scope)
        if step is None:
            step = mgr.latest_step()
        if step is None:
            return None
        if template is None:
            template = self.restore_template(step, scope=scope, mesh=mesh, policy=policy)
        return mgr.restore(step, template)

    def latest_step(self, scope: str | None = None) -> int | None:
        return self.state_manager(scope).latest_step()

    def wait_until_finished(self, scope: Any = _ALL_SCOPES) -> None:
        """Block until pending async saves commit: for one ``scope``, or for
        every manager (the default). A scope with no manager is a no-op."""
        if scope is not CheckpointDir._ALL_SCOPES:
            mgr = self._state_managers.get(scope)
            if mgr is not None:
                mgr.wait_until_finished()
            return
        for mgr in self._state_managers.values():
            mgr.wait_until_finished()

    def close(self) -> None:
        for mgr in self._state_managers.values():
            mgr.close()
        self._state_managers = {}
        self._manager_opts = {}

    def __str__(self) -> str:
        return str(self.path)

    def __repr__(self) -> str:
        return f"CheckpointDir({str(self.path)!r})"
