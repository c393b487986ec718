"""DML107 bad fixture (torch): torch.compile inside loop bodies — each
iteration builds a fresh compiled callable with an empty cache, so every
iteration re-captures and re-compiles."""

import functools

import torch


def sweep(batches, g):
    results = []
    for batch in batches:
        f = torch.compile(g)  # BAD: fresh compile per iteration
        results.append(f(batch))
    return results


def poll(g, batch):
    out = None
    while out is None:
        f = functools.partial(torch.compile, fullgraph=True)(g)  # BAD
        out = f(batch)
    return out


def decorated_in_loop(batches):
    outs = []
    for batch in batches:
        @torch.compile  # BAD: the def re-executes (re-compiles) every iteration
        def kernel(x):
            return x * 2

        outs.append(kernel(batch))
    return outs
