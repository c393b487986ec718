"""ctypes binding of the C++ sequence packer (``pack.cpp``); the Python
packer is the fallback.

``data.pack_sequences`` is a per-example Python loop: fine for thousands of
documents, interpreter-bound for millions. ``pack_flat`` takes the corpus as
two numpy buffers (the tokens, flattened, and the per-document lengths) and
hands the greedy fill to the library, which produces the same rows bit for bit
(``tests/test_torch_native.py``).
"""

from __future__ import annotations

import ctypes
from typing import Iterable, Sequence

import numpy as np

from . import _lib


def _load():
    return _lib.load_symbol(
        "dmltpu_pack",
        ctypes.c_long,
        [
            ctypes.c_void_p,  # flat tokens (null when counting)
            ctypes.c_void_p,  # lengths
            ctypes.c_long,  # n examples
            ctypes.c_long,  # seq_len
            ctypes.c_int,  # split_long
            ctypes.c_void_p,  # out tokens (null when counting)
            ctypes.c_void_p,  # out segs (null when counting)
        ],
    )


def available() -> bool:
    """Whether the library is built (building it on first call)."""
    return _load() is not None


def pack_flat(
    flat: np.ndarray,
    lengths: np.ndarray,
    seq_len: int,
    *,
    split_long: bool = True,
) -> tuple[np.ndarray, np.ndarray]:
    """Pack a pre-flattened corpus: ``flat`` is every example's tokens
    concatenated, ``lengths`` the per-example counts. Returns ``(tokens,
    segment_ids)`` as ``[rows, seq_len]`` int32 arrays with the exact
    ``pack_sequences`` semantics: one C call counts the rows, one fills them.
    Needs the library (raises ``RuntimeError`` when it cannot be built)."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native packer not built ({_lib.build_error}); data.pack_sequences and "
                           "pack_sequences_fast fall back to Python")
    if seq_len < 1:
        raise ValueError(f"seq_len must be >= 1, got {seq_len}")
    flat = np.ascontiguousarray(flat, np.int32)
    lengths = np.ascontiguousarray(lengths, np.int64)
    if lengths.size and int(lengths.min()) < 0:
        raise ValueError("lengths must be non-negative")  # a negative entry would read outside flat
    if int(lengths.sum()) != flat.size:
        raise ValueError(f"lengths sum to {int(lengths.sum())} but flat has {flat.size} tokens")
    n_rows = lib(None, lengths.ctypes.data, lengths.size, seq_len, int(split_long), None, None)
    if n_rows < 0:
        raise ValueError("invalid packing arguments")
    tokens = np.zeros((n_rows, seq_len), np.int32)
    segs = np.zeros((n_rows, seq_len), np.int32)
    filled = lib(flat.ctypes.data, lengths.ctypes.data, lengths.size, seq_len, int(split_long), tokens.ctypes.data,
                 segs.ctypes.data)
    if filled != n_rows:
        raise RuntimeError(f"dmltpu_pack filled {filled} rows, counted {n_rows}")
    _lib.CALLS["pack"] += 1
    return tokens, segs


def pack_sequences_fast(
    examples: Iterable[Sequence[int] | np.ndarray],
    seq_len: int,
    *,
    split_long: bool = True,
) -> list[dict]:
    """``pack_sequences`` through the library: the same row dicts
    (``{"tokens", "segment_ids"}``), as a list (the corpus is flattened up
    front). Falls back to the Python packer when the library cannot be built."""
    if seq_len < 1:
        raise ValueError(f"seq_len must be >= 1, got {seq_len}")
    arrays = [np.asarray(ex, np.int32).ravel() for ex in examples]
    if _load() is None:
        from ..data.datasets import pack_sequences

        return list(pack_sequences(arrays, seq_len, split_long=split_long))
    lengths = np.fromiter((a.size for a in arrays), np.int64, count=len(arrays))
    flat = np.concatenate(arrays) if arrays else np.zeros(0, np.int32)
    tokens, segs = pack_flat(flat, lengths, seq_len, split_long=split_long)
    return [{"tokens": tokens[i], "segment_ids": segs[i]} for i in range(len(tokens))]
