"""ctypes binding of the C++ batch interleave (``interleave.cpp``); the
numpy loop of ``data.datasets._interleave_pytrees`` is the fallback.

That loop does ``num_batches**2`` strided copies per group through the
interpreter; the C++ path does the same copies with ``std::memcpy`` across a
thread pool.
"""

from __future__ import annotations

import ctypes

import numpy as np

from . import _lib


def _load():
    return _lib.load_symbol(
        "dmltpu_interleave",
        ctypes.c_int,
        [
            ctypes.c_void_p,  # dst
            ctypes.POINTER(ctypes.c_void_p),  # srcs
            ctypes.c_long,  # num_batches
            ctypes.c_long,  # slice_bytes
            ctypes.c_long,  # batch_bytes
        ],
    )


def available() -> bool:
    """Whether the library is built (building it on first call)."""
    return _load() is not None


def interleave_into(memory: np.ndarray, batches: list[np.ndarray], slice_size: int) -> None:
    """``memory[i, j*s:(j+1)*s] = batches[j][i*s:(i+1)*s]`` for all i, j, in C++."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native interleave not built: {_lib.build_error}")
    n = len(batches)
    itemsize = batches[0].itemsize
    row_bytes = int(np.prod(batches[0].shape[1:])) * itemsize if batches[0].ndim > 1 else itemsize
    slice_bytes = slice_size * row_bytes
    batch_bytes = batches[0].shape[0] * row_bytes
    srcs = (ctypes.c_void_p * n)(*[b.ctypes.data for b in batches])
    rc = lib(memory.ctypes.data, srcs, n, slice_bytes, batch_bytes)
    if rc != 0:
        raise RuntimeError(f"dmltpu_interleave failed with code {rc}")
    _lib.CALLS["interleave"] += 1
