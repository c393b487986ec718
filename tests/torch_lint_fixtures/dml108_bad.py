"""DML108 bad fixture (torch): wall-clock ``time.time()`` used for step
timing in step/epoch code — NTP slews/steps it, corrupting span durations.

Static lint corpus — never imported or executed.
"""

import time

import torch

from dmlcloud_tpu_torch import TrainValStage


class TimerStage(TrainValStage):
    def train_epoch(self):
        epoch_t0 = time.time()  # BAD: wall clock for a duration
        for batch in self.batches:
            t0 = time.time_ns()  # BAD: wall clock for step timing
            metrics = self._train_step(batch)
            self.track("step_ms", (time.time_ns() - t0) / 1e6)  # BAD
        self._stall.block(metrics)
        self.track("epoch_s", time.time() - epoch_t0)  # BAD


@torch.compile
def step(params, batch):
    started = time.time()  # BAD: wall clock inside a compiled step
    return params, {"t": started}
