"""DML107 clean fixture (torch): the compile is hoisted out of the loop, and
a def inside a loop body compiles only when it is called.

Static lint corpus — never imported or executed.
"""

import functools

import torch


def sweep(batches, g):
    f = torch.compile(g, fullgraph=True)
    return [f(batch) for batch in batches]


compile_full = functools.partial(torch.compile, fullgraph=True)


def loop_defines_but_compiles_once(batches, g):
    f = compile_full(g)
    outs = []
    for batch in batches:
        def post(x):
            return x * 2

        outs.append(post(f(batch)))
    return outs
