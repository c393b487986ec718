"""Process-group bootstrap, device selection and control-plane collectives.

Counterpart of ``dmlcloud_tpu/parallel/runtime.py`` on ``torch.distributed``:
NCCL for tensors when the program runs on the card (with a gloo side for CPU
objects, which ``torch.distributed.checkpoint.async_save`` needs), gloo on the
CPU. The ``init_auto`` ladder is env:// -> Slurm -> MPI -> single process; the
reference's Cloud TPU pod rung has no counterpart. Around it: the rank
accessors and root helpers, ``barrier`` with a timeout that names the ranks
that never arrived (over the process group's c10d store), the object
collectives ``broadcast_object``/``all_gather_object``/``gather_object`` over
the same store (small pickled payloads, matched by a per-process sequence
number and checked by the caller's file:line, ``CollectiveMismatchError``),
and ``PreemptionGuard``, the signal-driven drain flag of preemption-safe
training.

Entry points of the port run on ``cuda`` unless the caller asks for the CPU
(``resolve_device``): with no card and no explicit CPU request they raise
instead of carrying on on the CPU.
"""

from __future__ import annotations

import datetime
import functools
import logging
import os
import pickle
import sys
import time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from ..telemetry import journal as _journal
from ..utils import slurm as _slurm
from ..utils.tcp import find_free_port, get_local_ips

logger = logging.getLogger("dmlcloud_tpu_torch")

#: default rendezvous port of the Slurm rung, overridable via env
DEFAULT_PORT = int(os.environ.get("DMLCLOUD_TPU_PORT", 41313))

_DEFAULT_TIMEOUT = 600.0  # seconds, the reference's barrier timeout


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``cuda`` unless the caller names another device; raise when the named
    (or default) CUDA device is not there — never fall back to the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "dmlcloud_tpu_torch runs on a CUDA device by default and none is available; "
            'pass device="cpu" to run on the CPU explicitly'
        )
    return device


@dataclass
class _WorkerInfo:
    rank: int = 0
    world_size: int = 1
    local_rank: int = 0
    local_world_size: int = 1
    node: int = 0
    initialized: bool = False
    backend: str = "single"
    #: a gloo group of its own for collectives that run beside the training
    #: loop's (an async checkpoint save's, on its writer thread); None at
    #: world size 1 without a process group
    side_group: Any = None


_info = _WorkerInfo()


# ---------------------------------------------------------------------------
# predicates and accessors
# ---------------------------------------------------------------------------

def is_initialized() -> bool:
    return _info.initialized


def has_environment() -> bool:
    """True when a launcher (torchrun, or the user) set the env:// variables."""
    return all(k in os.environ for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"))


def has_slurm() -> bool:
    """True inside a Slurm step."""
    return _slurm.slurm_available()


def has_mpi() -> bool:
    """True if mpi4py is importable."""
    try:
        import mpi4py  # noqa: F401

        return True
    except ImportError:
        return False


def rank() -> int:
    return _info.rank


def world_size() -> int:
    return _info.world_size


def local_rank() -> int:
    return _info.local_rank


def local_world_size() -> int:
    return _info.local_world_size


def local_node() -> int:
    return _info.node


def is_root() -> bool:
    return rank() == 0


def side_group():
    """The gloo group for collectives issued off the training thread (the
    async checkpoint writer's), so they never interleave with the default
    group's; None without a process group."""
    return _info.side_group


# ---------------------------------------------------------------------------
# root helpers
# ---------------------------------------------------------------------------

def root_only(fn: Callable) -> Callable:
    """Decorator: run only on the root process; other ranks return None."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if is_root():
            return fn(*args, **kwargs)
        return None

    return wrapper


@contextmanager
def root_first():
    """The root process executes the body first, then all other ranks enter
    after a barrier. Canonical use: dataset download."""
    if is_root():
        try:
            yield
        finally:
            barrier("root_first")
    else:
        barrier("root_first")
        yield


def print_root(*args, **kwargs) -> None:
    if is_root():
        print(*args, **kwargs)


def print_worker(*args, flush: bool = True, barrier_first: bool = False, **kwargs) -> None:
    """Print prefixed with the worker rank."""
    if barrier_first:
        barrier("print_worker")
    print(f"Worker {rank()} ({local_node()}.{local_rank()}):", *args, flush=flush, **kwargs)


# ---------------------------------------------------------------------------
# init ladder
# ---------------------------------------------------------------------------

def init_single() -> None:
    """Single process: no process group, every collective is the identity."""
    global _info
    _info = _WorkerInfo(initialized=True, backend="single")


def _init_group(device, init_method: str, rank_: int, world: int, local: int, local_world: int, node: int,
                timeout: float) -> None:
    """``init_process_group`` for ``device``: NCCL (plus gloo for CPU objects)
    on the card, gloo on the CPU."""
    global _info
    device = resolve_device(device)
    nccl = device.type == "cuda"
    if nccl:
        torch.cuda.set_device(local)
    dist.init_process_group(
        "cpu:gloo,cuda:nccl" if nccl else "gloo", init_method=init_method, rank=rank_, world_size=world,
        timeout=datetime.timedelta(seconds=timeout),
    )
    _info = _WorkerInfo(
        rank=rank_, world_size=world, local_rank=local, local_world_size=local_world, node=node,
        initialized=True, backend="nccl" if nccl else "gloo", side_group=dist.new_group(backend="gloo"),
    )


def init_from_env(device: str | torch.device | None = None, timeout: float = _DEFAULT_TIMEOUT) -> None:
    """The env:// rung (``MASTER_ADDR``/``MASTER_PORT``/``RANK``/``WORLD_SIZE``,
    as torchrun sets them)."""
    rank_, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", rank_))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    node = int(os.environ.get("GROUP_RANK", 0))
    _init_group(device, "env://", rank_, world, local, local_world, node, timeout)


def init_slurm(device: str | torch.device | None = None, port: int = DEFAULT_PORT,
               timeout: float = _DEFAULT_TIMEOUT) -> None:
    """The Slurm rung: rank and world from ``SLURM_PROCID``/``SLURM_NTASKS``,
    rendezvous at ``tcp://<first node of the allocation>:<port>``."""
    rank_, world, head = _slurm.slurm_rank(), _slurm.slurm_world_size(), _slurm.slurm_head_node()
    if rank_ is None or world is None or head is None:
        raise RuntimeError("Slurm environment incomplete (need SLURM_PROCID/SLURM_NTASKS/nodelist)")
    _init_group(
        device, f"tcp://{head}:{port}", rank_, world, _slurm.slurm_local_rank() or 0,
        _slurm.slurm_tasks_per_node() or 1, _slurm.slurm_node_id() or 0, timeout,
    )


def init_mpi(device: str | torch.device | None = None, timeout: float = _DEFAULT_TIMEOUT) -> None:
    """The MPI rung: MPI gives rank and size; the root picks a free port and a
    routable IP and broadcasts them; the process group then rendezvouses on
    that address. MPI is used only for the address exchange."""
    from mpi4py import MPI

    comm = MPI.COMM_WORLD
    rank_, world = comm.Get_rank(), comm.Get_size()
    local_comm = comm.Split_type(MPI.COMM_TYPE_SHARED)
    ip, port = None, None
    if rank_ == 0:
        port = find_free_port()
        ip = get_local_ips()[0]
    ip = comm.bcast(ip, root=0)
    port = comm.bcast(port, root=0)
    comm.Barrier()
    local_world = local_comm.Get_size()
    _init_group(device, f"tcp://{ip}:{port}", rank_, world, local_comm.Get_rank(), local_world,
                rank_ // max(local_world, 1), timeout)


def init_auto(device: str | torch.device | None = None, verbose: bool = False) -> str:
    """Detect the launch environment and initialise the right way. Ladder:
    env:// variables -> Slurm -> MPI -> single process (the reference's Cloud
    TPU pod rung has no counterpart). Returns the chosen backend name."""
    if _info.initialized:
        return _info.backend
    if has_environment():
        init_from_env(device)
    elif has_slurm():
        init_slurm(device)
    elif has_mpi():
        init_mpi(device)
    else:
        init_single()
    if verbose:
        logger.info(f"initialized distributed runtime via '{_info.backend}' (rank {rank()}/{world_size()})")
    return _info.backend


def ensure_process_group(device: str | torch.device | None = None, timeout: float = _DEFAULT_TIMEOUT) -> None:
    """Make sure a process group exists: a device mesh needs one even when it
    spans one process. A single process without a group (``init_single``)
    gets a one-rank group on ``tcp://127.0.0.1:<free port>`` (NCCL on the
    card, gloo on the CPU)."""
    if not _info.initialized:
        init_auto(device)
    if dist.is_available() and dist.is_initialized():
        return
    if world_size() != 1:
        raise RuntimeError(f"runtime reports world size {world_size()} but no process group exists")
    _init_group(device, f"tcp://127.0.0.1:{find_free_port()}", 0, 1, 0, 1, 0, timeout)


def deinitialize() -> None:
    global _info
    if _info.initialized and _info.backend != "single" and dist.is_initialized():
        dist.destroy_process_group()
    _info = _WorkerInfo()
    _seq.update(barrier=0, obj=0)
    _gc_barrier_ids.clear()
    _barrier_state.clear()


# ---------------------------------------------------------------------------
# control-plane collectives
# ---------------------------------------------------------------------------

def _collective_device() -> torch.device:
    return torch.device("cuda", torch.cuda.current_device()) if _info.backend == "nccl" else torch.device("cpu")


_seq = {"barrier": 0, "obj": 0}

#: ids of the last completed barrier, whose arrival keys the root deletes at
#: the NEXT successful barrier (see ``barrier``)
_gc_barrier_ids: list = []

#: this rank's most recent barrier: tag, status ("waiting"/"completed"/
#: "timeout"/"error"), entry time and, after a timeout, the straggler ranks
_barrier_state: dict = {}


def barrier_state() -> dict:
    """Copy of this rank's most recent barrier record; empty before the first
    barrier."""
    return dict(_barrier_state)


class BarrierTimeout(RuntimeError):
    """A barrier timed out; ``stragglers`` lists the ranks that never arrived."""

    def __init__(self, tag: str, timeout: float, stragglers: list[int]):
        self.tag = tag
        self.timeout = timeout
        self.stragglers = stragglers
        super().__init__(
            f"barrier '{tag}' timed out after {timeout:.0f}s; "
            f"straggler ranks (never arrived): {stragglers or 'unknown'}"
        )


def barrier(tag: str = "", timeout: float = _DEFAULT_TIMEOUT) -> None:
    """All-process barrier with a timeout that NAMES stragglers.

    Every process sets a per-rank arrival key in the process group's c10d
    store, then waits for all ranks' keys; on timeout the error lists exactly
    the ranks whose key never appeared (``BarrierTimeout.stragglers``).
    Control plane only: no device traffic."""
    if world_size() <= 1:
        return
    store = dist.distributed_c10d._get_default_store()
    _seq["barrier"] += 1
    barrier_id = f"dmlcloud_tpu:{tag}:{_seq['barrier']}"
    _barrier_state.clear()
    _barrier_state.update({"tag": tag, "id": barrier_id, "rank": rank(), "status": "waiting",
                           "entered_at": time.strftime("%Y-%m-%dT%H:%M:%S"), "timeout_s": timeout})
    keys = [f"{barrier_id}/arrived/{src}" for src in range(world_size())]
    t0 = _journal.now()
    # Arrival keys are NOT deleted when their own barrier completes: a rank
    # whose timer expired in the same instant could then misreport arrived
    # ranks as stragglers. The root deletes them one completed barrier later,
    # when every rank has provably left the earlier one.
    store.set(keys[rank()], "1")
    try:
        store.wait(keys, datetime.timedelta(seconds=timeout))
    except Exception as e:
        msg = str(e).lower()
        if "timeout" in msg or "timed out" in msg or "deadline" in msg:
            stragglers = [src for src, key in enumerate(keys) if not store.check([key])]
            _barrier_state.update({"status": "timeout", "stragglers": stragglers})
            _journal.emit("barrier", t0, label=tag, status="timeout", stragglers=stragglers)
            raise BarrierTimeout(tag, timeout, stragglers) from e
        _barrier_state["status"] = "error"
        raise  # not a timeout (e.g. the store's connection was lost)
    _barrier_state["status"] = "completed"
    _journal.emit("barrier", t0, label=tag, status="completed")
    if is_root():
        for done_id in _gc_barrier_ids:
            for src in range(world_size()):
                try:
                    store.delete_key(f"{done_id}/arrived/{src}")
                except Exception:  # best effort: a missed delete only costs store memory
                    pass
    _gc_barrier_ids.clear()
    _gc_barrier_ids.append(barrier_id)


class CollectiveMismatchError(RuntimeError):
    """Two processes paired up object collectives issued from DIFFERENT call
    sites.

    The object collectives match messages by a per-process sequence counter,
    which assumes every process issues the identical sequence of collective
    calls. A rank-conditional extra (or skipped) call would silently pair
    call N on one rank with a different call N on another and deliver the
    wrong object; the call-site tag carried inside every payload turns that
    into this error whenever the misaligned pair spans two different call
    sites. (A misalignment that pairs the SAME line with itself, e.g. one rank
    running an extra loop iteration of one collective, is not detectable from
    the tag alone.)"""

    def __init__(self, kind: str, seq: int, local_tag: str, remote_tag: str, src: int):
        self.local_tag, self.remote_tag = local_tag, remote_tag
        super().__init__(
            f"control-plane {kind} #{seq}: this process called from {local_tag} but "
            f"rank {src} published from {remote_tag} — the ranks' collective call "
            "sequences have diverged (a rank-conditional collective call?). If the "
            "differing call sites are intentional, pass the same explicit tag= on "
            "both sides."
        )


def _call_site_tag() -> str:
    """``dir/file.py:lineno`` of the first frame outside this module: the
    user call site, fingerprinting WHICH collective call this is. Two path
    components are kept, because a bare basename collides across packages."""
    f = sys._getframe(1)
    while f is not None and f.f_code.co_filename == __file__:
        f = f.f_back
    if f is None:  # pragma: no cover - interpreter entry
        return "?"
    parts = f.f_code.co_filename.replace(os.sep, "/").rsplit("/", 2)
    return f"{'/'.join(parts[-2:])}:{f.f_lineno}"


def _obj_key(kind: str, seq: int, src: int) -> str:
    return f"dmlcloud_tpu/obj/{kind}/{seq}/{src}"


def _publish(store, kind: str, seq: int, obj: Any, tag: str) -> None:
    store.set(_obj_key(kind, seq, rank()), pickle.dumps((tag, obj)))


def _fetch(store, kind: str, seq: int, srcs: list[int], timeout: float, tag: str) -> list[Any]:
    """The objects ``srcs`` published for collective ``seq``, each checked
    against this call's tag: a blocking wait for every key (the store's
    timeout error names the missing ones), then one get each."""
    keys = [_obj_key(kind, seq, src) for src in srcs]
    store.wait(keys, datetime.timedelta(seconds=timeout))
    objs = []
    for src, key in zip(srcs, keys):
        remote_tag, obj = pickle.loads(store.get(key))
        if remote_tag != tag:
            raise CollectiveMismatchError(kind, seq, tag, remote_tag, src)
        objs.append(obj)
    return objs


def _release(store, kind: str, seq: int, srcs: list[int], readers: int) -> None:
    """Count this process's read of collective ``seq``; the last of its
    ``readers`` deletes the payload keys, so a key never goes before every
    reader has it."""
    if store.add(f"dmlcloud_tpu/obj/{kind}/{seq}/reads", 1) < readers:
        return
    for key in [_obj_key(kind, seq, src) for src in srcs] + [f"dmlcloud_tpu/obj/{kind}/{seq}/reads"]:
        try:
            store.delete_key(key)
        except Exception:  # best effort: a missed delete only costs store memory
            pass


def _next_obj_seq() -> int:
    _seq["obj"] += 1
    return _seq["obj"]


def broadcast_object(obj: Any = None, root: int = 0, timeout: float = _DEFAULT_TIMEOUT,
                     tag: str | None = None) -> Any:
    """Broadcast a picklable object from ``root`` to all processes, over the
    process group's c10d store: small payloads, no device memory.

    Every payload carries a call-site tag (default: the caller's file:line)
    that receivers verify, so rank-divergent call sequences fail with
    :class:`CollectiveMismatchError` instead of silently delivering the wrong
    object. Pass an explicit shared ``tag`` when matching calls legitimately
    come from different lines (e.g. an if/else on ``is_root()``)."""
    if world_size() <= 1:
        return obj
    tag = tag or _call_site_tag()
    seq, store = _next_obj_seq(), dist.distributed_c10d._get_default_store()
    if rank() == root:
        _publish(store, "broadcast_object", seq, obj, tag)
        return obj
    (obj,) = _fetch(store, "broadcast_object", seq, [root], timeout, tag)
    _release(store, "broadcast_object", seq, [root], world_size() - 1)
    return obj


def all_gather_object(obj: Any, timeout: float = _DEFAULT_TIMEOUT, tag: str | None = None) -> list:
    """One picklable object from every process, returned to all ranks ordered
    by rank. Call-site-tag verified, see :func:`broadcast_object`."""
    if world_size() <= 1:
        return [obj]
    tag = tag or _call_site_tag()
    seq, store = _next_obj_seq(), dist.distributed_c10d._get_default_store()
    _publish(store, "all_gather_object", seq, obj, tag)
    srcs = list(range(world_size()))
    objs = _fetch(store, "all_gather_object", seq, srcs, timeout, tag)
    _release(store, "all_gather_object", seq, srcs, world_size())
    return objs


def gather_object(obj: Any, root: int = 0, timeout: float = _DEFAULT_TIMEOUT,
                  tag: str | None = None) -> list | None:
    """Objects of every process, ordered by rank, on ``root`` only; other
    ranks get None. Call-site-tag verified, see :func:`broadcast_object`."""
    if world_size() <= 1:
        return [obj]
    tag = tag or _call_site_tag()
    seq, store = _next_obj_seq(), dist.distributed_c10d._get_default_store()
    _publish(store, "gather_object", seq, obj, tag)
    if rank() != root:
        return None
    srcs = list(range(world_size()))
    objs = _fetch(store, "gather_object", seq, srcs, timeout, tag)
    _release(store, "gather_object", seq, srcs, 1)
    return objs


def all_gather_array(vec: np.ndarray) -> np.ndarray:
    """``[world, n]`` float32 rows of every rank's ``vec``, in ONE
    ``all_reduce``: each rank fills its own row of a zero matrix and the sum
    is the gather. The epoch-end metric exchange rides on it."""
    vec = np.asarray(vec, np.float32)
    if world_size() == 1:
        return vec[None]
    rows = torch.zeros((world_size(), vec.size), dtype=torch.float32, device=_collective_device())
    rows[rank()] = torch.from_numpy(vec).to(rows.device)
    dist.all_reduce(rows)
    return rows.cpu().numpy()


# ---------------------------------------------------------------------------
# preemption guard
# ---------------------------------------------------------------------------

class PreemptionGuard:
    """Signal-driven drain flag for preemption-tolerant training.

    The scheduler's eviction warning (SIGTERM; Slurm's ``--signal=USR1@60``
    -> SIGUSR1; an operator's Ctrl-C: SIGINT) lands on SOME rank as an async
    signal. The handler only sets :attr:`triggered` (it never logs or raises:
    the signal may interrupt a buffered stream), and the step loop polls
    :meth:`coordinated` at save boundaries so every rank agrees to stop at
    the SAME step — a one-sided exit would strand the others in the next
    collective.

    ``install()`` resolves every signal name BEFORE touching any handler (a
    misspelt name must not leave a half-installed set) and remembers the
    original dispositions for :meth:`uninstall`. ``armed`` is separate from
    installation, so tests (and code that learns of a preemption out of band)
    can set :attr:`triggered` directly.
    """

    #: default signal set: scheduler eviction + operator interrupt, plus the
    #: Slurm warning signal inside a Slurm step
    DEFAULT_SIGNALS = ("SIGTERM", "SIGINT")

    def __init__(self, signals: tuple[str, ...] | None = None):
        if signals is None:
            signals = self.DEFAULT_SIGNALS
            if _slurm.slurm_available():
                signals = signals + ("SIGUSR1",)
        self.signals = tuple(signals)
        #: set (async) by the signal handler; cleared by install()
        self.triggered = False
        #: the signal name that tripped the guard, for the requeue verdict
        self.signal_name: str | None = None
        #: perf_counter instant the guard tripped
        self.triggered_at: float | None = None
        #: whether coordinated() takes part in the cross-rank gather
        self.armed = False
        self._prev: dict = {}

    def install(self) -> "PreemptionGuard":
        import signal as _signal

        sigs = [getattr(_signal, name) for name in self.signals]
        for sig in sigs:
            prev = _signal.signal(sig, self._handler)
            # a re-install on the same signal keeps the ORIGINAL disposition
            self._prev.setdefault(sig, prev)
        self.triggered = False
        self.signal_name = None
        self.triggered_at = None
        self.armed = True
        return self

    def _handler(self, signum, frame):
        # flag only: the normal control path reports the drain
        import signal as _signal

        self.triggered = True
        self.triggered_at = time.perf_counter()
        try:
            self.signal_name = _signal.Signals(signum).name
        except ValueError:  # pragma: no cover - exotic signum
            self.signal_name = str(signum)

    def uninstall(self) -> None:
        """Restore the original process-wide dispositions (a stale handler
        would make a post-run SIGTERM a silent no-op)."""
        if self._prev:
            import signal as _signal

            for sig, prev in self._prev.items():
                _signal.signal(sig, prev)
            self._prev = {}
        self.armed = False

    def coordinated(self) -> bool:
        """Whether ANY rank caught a preemption signal: one
        ``all_gather_object`` at world size > 1, none at world size 1."""
        if not self.armed:
            return False
        if world_size() <= 1:
            return self.triggered
        return any(all_gather_object(self.triggered))
