"""Seeding for the port: host RNGs plus an explicit ``torch.Generator``.

Counterpart of ``dmlcloud_tpu/utils/seed.py``. Where the JAX package returns a
root ``PRNGKey`` for traced code, the port returns a seeded
``torch.Generator`` that callers pass on explicitly (model initialisation,
sampling). The same seed does not give the same numbers in both frameworks:
tests make their inputs with numpy and hand them to both.
"""

from __future__ import annotations

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
