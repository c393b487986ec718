"""DML102 bad fixture (torch): Python/NumPy RNG inside step code.

Static lint corpus — never imported or executed.
"""

import random

import numpy as np
import torch

from dmlcloud_tpu_torch import TrainValStage


class RngStage(TrainValStage):
    def step(self, state, batch):
        noise = np.random.normal(size=(4,))  # BAD: drawn on the host every step
        keep = random.uniform(0.0, 1.0)  # BAD: stdlib RNG in a step
        return (state.model(batch) + torch.as_tensor(noise)).mean() * keep


@torch.compile
def compiled_augment(x):
    return x + torch.as_tensor(np.random.rand(*x.shape))  # BAD: a constant of the graph
