"""DML108 clean fixture (torch): monotonic clocks in step/epoch code, the
wall clock only outside the hazard contexts.

Static lint corpus — never imported or executed.
"""

import time

import torch

from dmlcloud_tpu_torch import TrainValStage


class TimerStage(TrainValStage):
    def train_epoch(self):
        epoch_t0 = time.perf_counter()
        for batch in self.batches:
            t0 = time.perf_counter_ns()
            metrics = self._train_step(batch)
            self.track("step_ms", (time.perf_counter_ns() - t0) / 1e6)
        self._stall.block(metrics)
        self.track("epoch_s", time.perf_counter() - epoch_t0)


@torch.compile
def step(params, batch):
    return params, {"n": batch.shape[0]}


def run_name():
    return f"run-{int(time.time())}"
