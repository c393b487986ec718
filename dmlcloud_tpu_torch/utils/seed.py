"""Seeding for the port: host RNGs plus an explicit ``torch.Generator``.

Counterpart of ``dmlcloud_tpu/utils/seed.py``. Where the JAX package returns a
root ``PRNGKey`` for traced code, the port returns a seeded
``torch.Generator`` that callers pass on explicitly (model initialisation,
sampling); ``worker_key`` and ``step_key`` derive per-process and per-step
generators from it, as the reference folds an index into a key. The same seed
does not give the same numbers in both frameworks: tests make their inputs
with numpy and hand them to both.
"""

from __future__ import annotations

import os
import random

import numpy as np
import torch


def seed_all(seed: int | None = None, device: str | torch.device = "cpu") -> torch.Generator:
    """Seed Python's, numpy's and torch's global RNGs and return a
    ``torch.Generator`` on ``device`` seeded with the same value.

    With ``seed=None``, process 0 draws a seed and broadcasts it so every
    process agrees.
    """
    if seed is None:
        seed = int(np.random.SeedSequence().entropy % (2**31))
        from ..parallel import runtime

        if runtime.world_size() > 1:
            seed = runtime.broadcast_object(seed)
    random.seed(seed)
    np.random.seed(seed % (2**32))
    torch.manual_seed(seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def _derive(gen_or_seed: torch.Generator | int, index: int, salt: int) -> torch.Generator:
    """A generator on the same device as ``gen_or_seed`` whose seed mixes the
    root seed, ``salt`` and ``index`` (numpy's SeedSequence hash), so that
    neighbouring indices give unrelated streams."""
    if isinstance(gen_or_seed, torch.Generator):
        root, device = gen_or_seed.initial_seed(), gen_or_seed.device
    else:
        root, device = int(gen_or_seed), torch.device("cpu")
    seed = int(np.random.SeedSequence([root % 2**63, salt, int(index)]).generate_state(1, np.uint64)[0] >> 1)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def worker_key(gen_or_seed: torch.Generator | int, process_index: int | None = None) -> torch.Generator:
    """A per-process generator: the root seed with the process index folded
    in (default: this process's rank), deterministic and distinct per rank."""
    if process_index is None:
        from ..parallel import runtime

        process_index = runtime.rank()
    return _derive(gen_or_seed, process_index, salt=0)


def step_key(gen_or_seed: torch.Generator | int, step: int) -> torch.Generator:
    """A per-step generator, deterministic in (root seed, step)."""
    return _derive(gen_or_seed, step, salt=1)


def enable_determinism() -> None:
    """Make runs bitwise reproducible on the same hardware: deterministic
    algorithms only (an op without one raises), cuBLAS's fixed workspace and
    no cuDNN autotuning."""
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.benchmark = False
