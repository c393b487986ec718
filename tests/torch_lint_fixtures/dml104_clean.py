"""DML104 clean fixture (torch): branches on metadata, structure and None
checks only; data-dependent choices stay on the device.

Static lint corpus — never imported or executed.
"""

import torch

from dmlcloud_tpu_torch import TrainValStage


@torch.compile(fullgraph=True)
def train_fn(acc, batch, mask=None):
    if batch.dim() == 3 and batch.size(0) > 1:
        batch = batch.flatten(0, 1)
    if mask is not None:
        batch = batch * mask
    if batch.dtype == torch.bfloat16 or not batch.is_floating_point():
        batch = batch.float()
    return torch.where(batch.sum() > 0, acc + 1, acc)


class ShapeStage(TrainValStage):
    def step(self, state, batch):
        x = batch["x"] if "x" in batch else batch["tokens"]
        if x.shape[0] > 2 and isinstance(x, torch.Tensor):
            x = x[:2]
        return state.model(x).mean()
