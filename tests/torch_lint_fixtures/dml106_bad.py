"""DML106 bad fixture (torch): wall-clock timing of CUDA launches without a
device sync — the benchmark measures launch cost, not execution.

Static lint corpus — never imported or executed.
"""

import time

import torch


def bench_steps(train_step, state, batch):
    t0 = time.perf_counter()
    for _ in range(100):
        state, _ = train_step(state, batch)
    elapsed = time.perf_counter() - t0  # BAD: nothing has finished yet
    return 100 / elapsed


def bench_compiled(fn, x):
    f = torch.compile(fn)
    start = time.perf_counter()
    y = f(x)
    return time.perf_counter() - start, y  # BAD: timed the launch only
