"""DML104 bad fixture (torch): data-dependent Python control flow on tensor
values inside step code — a host sync eagerly, a graph break or a recompile
under torch.compile.

Static lint corpus — never imported or executed.
"""

import torch

from dmlcloud_tpu_torch import TrainValStage


@torch.compile(fullgraph=True)
def train_fn(acc, batch, flag):
    if batch.sum() > 0:  # BAD: branches on tensor data
        acc = acc + 1
    while flag:  # BAD: loops on a tensor value
        flag = flag - 1
    for row in batch:  # BAD: iterates a tensor
        acc = acc + row
    return acc


class BranchyStage(TrainValStage):
    def step(self, state, batch):
        loss = state.model(batch).mean()
        scale = 0.5 if loss > 1.0 else 1.0  # BAD: conditional on the loss
        return loss * scale
