"""DML101 clean fixture (torch): device values tracked, host reads accounted
under the stall timer, and host syncs outside the hazard contexts.

Static lint corpus — never imported or executed.
"""

import torch

from dmlcloud_tpu_torch import TrainValStage


class QuietStage(TrainValStage):
    def step(self, state, batch):
        loss = state.model(batch["x"]).mean()
        return {"loss": loss, "n": int(batch["x"].shape[0])}

    def train_epoch(self):
        for batch in self.ds:
            metrics = self._train_step(batch)
            self.track_reduce("loss", metrics["loss"])
        host = self._stall.fetch(metrics)
        with self._stall.measure():
            torch.cuda.synchronize()
            v = metrics["loss"].item()
        self.track("last", host["loss"] + v)


def summarize(metrics):
    # not a hazard context: a report helper may read values
    return {k: v.item() for k, v in metrics.items()}
