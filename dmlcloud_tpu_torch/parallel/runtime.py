"""Process-group bootstrap, device selection and control-plane collectives.

Counterpart of ``dmlcloud_tpu/parallel/runtime.py`` on ``torch.distributed``:
NCCL when the program runs on the card, gloo on the CPU. This slice ports the
env:// rung (``MASTER_ADDR``/``MASTER_PORT``/``RANK``/``WORLD_SIZE``, as torchrun
sets them) and the single-process rung of ``init_auto``; the Slurm and MPI
rungs come later.

Entry points of the port run on ``cuda`` unless the caller asks for the CPU
(``resolve_device``): with no card and no explicit CPU request they raise
instead of carrying on on the CPU.
"""

from __future__ import annotations

import datetime
import logging
import os
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

logger = logging.getLogger("dmlcloud_tpu_torch")

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
    initialized: bool = False
    backend: str = "single"


_info = _WorkerInfo()


def is_initialized() -> bool:
    return _info.initialized


def has_environment() -> bool:
    """True when a launcher (torchrun, or the user) set the env:// variables."""
    return all(k in os.environ for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"))


def rank() -> int:
    return _info.rank


def world_size() -> int:
    return _info.world_size


def is_root() -> bool:
    return rank() == 0


def init_single() -> None:
    """Single process: no process group, every collective is the identity."""
    global _info
    _info = _WorkerInfo(initialized=True, backend="single")


def init_from_env(device: str | torch.device | None = None, timeout: float = _DEFAULT_TIMEOUT) -> None:
    """The env:// rung: NCCL for a CUDA ``device``, gloo for the CPU."""
    global _info
    device = resolve_device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    rank_, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", rank_))
    if backend == "nccl":
        torch.cuda.set_device(local)
    dist.init_process_group(
        backend, init_method="env://", rank=rank_, world_size=world,
        timeout=datetime.timedelta(seconds=timeout),
    )
    _info = _WorkerInfo(
        rank=rank_, world_size=world, local_rank=local, initialized=True, backend=backend,
    )


def init_auto(device: str | torch.device | None = None, verbose: bool = False) -> str:
    """Detect the launch environment: env:// variables, else a single
    process. Returns the chosen backend name."""
    if _info.initialized:
        return _info.backend
    if has_environment():
        init_from_env(device)
    else:
        init_single()
    if verbose:
        logger.info(f"initialized distributed runtime via '{_info.backend}' (rank {rank()}/{world_size()})")
    return _info.backend


def deinitialize() -> None:
    global _info
    if _info.initialized and _info.backend != "single" and dist.is_initialized():
        dist.destroy_process_group()
    _info = _WorkerInfo()


def _collective_device() -> torch.device:
    return torch.device("cuda", torch.cuda.current_device()) if _info.backend == "nccl" else torch.device("cpu")


def barrier() -> None:
    """All-process barrier (the process group's timeout bounds it)."""
    if world_size() > 1:
        dist.barrier()


def broadcast_object(obj: Any, src: int = 0) -> Any:
    if world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def all_gather_object(obj: Any) -> list:
    if world_size() == 1:
        return [obj]
    out = [None] * world_size()
    dist.all_gather_object(out, obj)
    return out


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
