"""Rank-sharding index math: pure numpy functions, a copy of
``dmlcloud_tpu/data/sharding.py``, so that both packages shard a dataset into
identical per-rank indices for the same seed, rank and world size.

- ``shard_indices``: strided slice ``indices[rank::world_size]`` with an
  optional MT19937 shuffle and drop-remainder (``even_shards``).
- ``chunk_and_shard_indices``: a chunk grid over a long dimension, sharded by
  rank, with ``chunk_overlap`` for windowed time-series context.
- ``shard_sequence``: the materialised per-rank subsequence.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def shard_indices(
    num_elements: int,
    rank: int,
    world_size: int,
    shuffle: bool = False,
    even_shards: bool = True,
    seed: int = 0,
) -> list[int]:
    """Per-rank element indices. ``even_shards=True`` drops the tail so every
    rank gets the same count (required for lock-step data-parallel training)."""
    indices = np.arange(num_elements)

    if shuffle:
        np.random.Generator(np.random.MT19937(seed)).shuffle(indices)

    if even_shards:
        indices = indices[: num_elements - num_elements % world_size]

    return indices[rank::world_size].tolist()


def chunk_and_shard_indices(
    num_elements: int,
    chunk_size: int,
    rank: int,
    world_size: int,
    chunk_overlap: int = 0,
    even_shards: bool = True,
    equal_chunks: bool = True,
    shuffle: bool = False,
    seed: int = 0,
) -> list[tuple[int, int]]:
    """Shard a chunk grid over ranks; returns per-rank ``(start, end)`` slices
    (end exclusive, extended by ``chunk_overlap``)."""
    if equal_chunks:
        num_chunks = num_elements // chunk_size
    else:
        num_chunks = (num_elements + chunk_size - 1) // chunk_size

    chunk_indices = shard_indices(
        num_chunks, rank, world_size, shuffle=shuffle, even_shards=even_shards, seed=seed
    )
    chunks = []
    for chunk_idx in chunk_indices:
        start = chunk_idx * chunk_size
        end = start + chunk_size + chunk_overlap
        chunks.append((start, end))
    return chunks


def shard_sequence(
    sequence: Sequence,
    rank: int,
    world_size: int,
    shuffle: bool = False,
    even_shards: bool = True,
    seed: int = 0,
) -> list:
    """This rank's elements of ``sequence``, in ``shard_indices`` order."""
    indices = shard_indices(
        len(sequence), rank, world_size, shuffle=shuffle, even_shards=even_shards, seed=seed
    )
    return [sequence[i] for i in indices]
