"""DML106 clean fixture (torch): every timed region ends in a device sync —
``torch.cuda.synchronize()``, an event's ``synchronize()``, or a value read.

Static lint corpus — never imported or executed.
"""

import time

import torch


def bench_steps(train_step, state, batch):
    t0 = time.perf_counter()
    for _ in range(100):
        state, _ = train_step(state, batch)
    torch.cuda.synchronize()
    return 100 / (time.perf_counter() - t0)


def bench_compiled(fn, x):
    f = torch.compile(fn)
    start = time.perf_counter()
    y = f(x)
    done = torch.cuda.Event()
    done.record()
    done.synchronize()
    return time.perf_counter() - start, y


def bench_value_read(train_step, state, batch):
    t0 = time.perf_counter()
    state, loss = train_step(state, batch)
    value = loss.item()
    return time.perf_counter() - t0, value
