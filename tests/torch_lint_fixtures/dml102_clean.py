"""DML102 clean fixture (torch): torch's RNG in step code, host RNG only in
data helpers outside the hazard contexts.

Static lint corpus — never imported or executed.
"""

import random

import numpy as np
import torch

from dmlcloud_tpu_torch import TrainValStage


class RngStage(TrainValStage):
    def step(self, state, batch):
        noise = torch.randn(batch.shape, generator=self.gen, device=batch.device)
        keep = torch.bernoulli(torch.full((batch.shape[0], 1), 0.9, device=batch.device))
        return (state.model(batch + noise) * keep).mean()


@torch.compile(fullgraph=True)
def compiled_augment(x, noise):
    return x + noise


def make_docs(n):
    rs = np.random.RandomState(0)
    random.shuffle(list(range(n)))
    return [rs.randint(0, 100, size=8) for _ in range(n)]
