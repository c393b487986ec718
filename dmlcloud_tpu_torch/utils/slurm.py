"""Slurm environment introspection.

A copy of ``dmlcloud_tpu/utils/slurm.py``: job and step id, rank, world size,
local rank, node id, tasks per node and the head node, so that
``torch.distributed.init_process_group`` can be fed from Slurm alone
(``parallel.runtime.init_slurm``).
"""

from __future__ import annotations

import os
import re
import subprocess


def slurm_job_id() -> str | None:
    """The current Slurm job id (``SLURM_JOB_ID``), or None outside Slurm."""
    return os.environ.get("SLURM_JOB_ID")


def slurm_step_id() -> str | None:
    """The current Slurm step id (``SLURM_STEP_ID``), or None outside Slurm."""
    return os.environ.get("SLURM_STEP_ID")


def slurm_available() -> bool:
    """True if this process runs inside a Slurm step (``SLURM_PROCID`` set)."""
    return "SLURM_PROCID" in os.environ


def slurm_rank() -> int | None:
    v = os.environ.get("SLURM_PROCID")
    return int(v) if v is not None else None


def slurm_world_size() -> int | None:
    v = os.environ.get("SLURM_NTASKS") or os.environ.get("SLURM_STEP_NUM_TASKS")
    return int(v) if v is not None else None


def slurm_local_rank() -> int | None:
    v = os.environ.get("SLURM_LOCALID")
    return int(v) if v is not None else None


def slurm_node_id() -> int | None:
    v = os.environ.get("SLURM_NODEID")
    return int(v) if v is not None else None


def slurm_tasks_per_node() -> int | None:
    """Tasks on this node, parsed from ``SLURM_STEP_TASKS_PER_NODE`` (e.g. ``"4(x2),3"``)."""
    spec = os.environ.get("SLURM_STEP_TASKS_PER_NODE") or os.environ.get("SLURM_TASKS_PER_NODE")
    if spec is None:
        return None
    node = slurm_node_id() or 0
    counts: list[int] = []
    for part in spec.split(","):
        m = re.fullmatch(r"(\d+)(?:\(x(\d+)\))?", part.strip())
        if not m:
            continue
        counts.extend([int(m.group(1))] * int(m.group(2) or 1))
    if node < len(counts):
        return counts[node]
    return counts[0] if counts else None


def slurm_head_node() -> str | None:
    """Hostname of the first node in the allocation — used as the process group's
    rendezvous host. Prefers ``SLURM_SRUN_COMM_HOST``; falls back to expanding
    ``SLURM_JOB_NODELIST`` via ``scontrol``."""
    host = os.environ.get("SLURM_SRUN_COMM_HOST")
    if host:
        return host
    nodelist = os.environ.get("SLURM_JOB_NODELIST") or os.environ.get("SLURM_NODELIST")
    if not nodelist:
        return None
    # Cheap expansion for the common "prefix[a-b,...]" pattern; shell out only if needed.
    m = re.match(r"^([^\[,]+)\[(\d+)", nodelist)
    if m:
        return f"{m.group(1)}{m.group(2)}"
    if "[" not in nodelist:
        return nodelist.split(",")[0]
    try:
        out = subprocess.run(
            ["scontrol", "show", "hostnames", nodelist],
            capture_output=True, text=True, timeout=10, check=True,
        )
        return out.stdout.splitlines()[0].strip()
    except Exception:
        return None
