"""DML101 bad fixture (torch): unaccounted host syncs in step and epoch code.

Static lint corpus — never imported or executed.
"""

import torch

from dmlcloud_tpu_torch import TrainValStage


class SyncyStage(TrainValStage):
    def step(self, state, batch):
        loss = state.model(batch["x"]).mean()
        print(loss)  # BAD: print inside a step
        host = float(loss)  # BAD: reads a tensor on the host
        return loss + host

    def train_epoch(self):
        for batch in self.ds:
            metrics = self._train_step(batch)
            v = metrics["loss"].item()  # BAD: per-step .item() sync
            torch.cuda.synchronize()  # BAD: unaccounted device wait
            rows = metrics["acc"].tolist()  # BAD: per-step host copy
            f = float(metrics["loss"])  # BAD: per-step float() on a metric
            self.track_reduce("loss", v + f + sum(rows))
