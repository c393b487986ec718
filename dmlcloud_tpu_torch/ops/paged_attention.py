"""Paged KV-cache indexing: gather/scatter between a block pool and
per-sequence block tables.

Counterpart of ``dmlcloud_tpu/ops/paged_attention.py``: ``gather_pages``
(:60) and ``scatter_tokens`` (:74). The serving engine (``serve/``) keeps the
KV cache as a fixed pool of ``[num_blocks, block_size, KH, D]`` pages per
layer; each sequence owns a short list of pool blocks, its *block table*.
``scatter_tokens`` writes a batch of new K/V rows into the pages the tables
name, ``gather_pages`` reassembles each row's pages into a contiguous
``[B, NB * block_size, KH, D]`` view for the same masked attention as the
dense decode path (``models.transformer._dot_attention``).

Block tables are padded with a SENTINEL entry equal to ``num_blocks``, one
past the pool. The reference leans on JAX to clip an out-of-bounds gather
index and to drop an out-of-bounds scatter (``mode="drop"``). Torch raises
on the CPU and fires a device-side assert on a CUDA tensor, which ends the
process, so the masking is explicit here:

- the gather reads a clamped index (the sentinel reads the last real block,
  as JAX's clip does; the caller's ``kv_pos <= q_pos`` mask hides it);
- the scatter writes only the rows whose logical block lies in the table
  (``0 <= position // block_size < NB``) and whose table entry names a real
  block; everything else (a sentinel-only row, a position past the table, a
  negative position) is dropped, never wrapped into a real block.

The kept rows of a scatter are found with a boolean mask, one host sync on a
CUDA tensor; ``DecoderLM`` finds them once per forward (``write_index``) and
every layer's K and V scatter reuses them. The pool is written in place.
"""

from __future__ import annotations

import torch

__all__ = ["gather_pages", "scatter_tokens", "write_index"]


def gather_pages(pool: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """Reassemble each row's pages into a contiguous KV view.

    ``pool`` is ``[num_blocks, block_size, KH, D]``; ``tables`` is ``[B, NB]``
    physical block ids (sentinel ``num_blocks`` for unused entries: clamped
    here, masked by the caller). Returns ``[B, NB * block_size, KH, D]``: row
    ``b``'s token position ``p`` lives at gathered index ``p``."""
    g = pool[tables.clamp(0, pool.shape[0] - 1)]  # [B, NB, bs, KH, D]
    return g.reshape(tables.shape[0], tables.shape[1] * pool.shape[1], *pool.shape[2:])


def write_index(tables: torch.Tensor, positions: torch.Tensor, num_blocks: int, block_size: int):
    """Where a scatter through ``tables`` at ``positions`` ([B, T]) lands:
    ``(row, col, block, slot)`` index tensors of the kept ``(b, t)`` pairs.
    A position whose logical block falls outside its table row, or whose
    table entry is no real block (the sentinel), is dropped."""
    nb = tables.shape[1]
    block = torch.div(positions, block_size, rounding_mode="floor")  # [B, T] logical block
    slot = positions - block * block_size
    phys = tables.gather(1, block.clamp(0, nb - 1))
    keep = (block >= 0) & (block < nb) & (phys >= 0) & (phys < num_blocks)
    row, col = keep.nonzero(as_tuple=True)
    return row, col, phys[row, col], slot[row, col]


def scatter_tokens(
    pool: torch.Tensor, tables: torch.Tensor, positions: torch.Tensor, values: torch.Tensor, index=None
) -> torch.Tensor:
    """Write per-token K/V rows into the pages their block tables name, in
    place, and return ``pool``.

    ``positions`` is ``[B, T]`` absolute token positions (position ``p`` lands
    in logical block ``p // block_size``, slot ``p % block_size``);
    ``values`` is ``[B, T, KH, D]``. A position whose logical block falls
    outside its table row, a sentinel entry, or a negative position is
    dropped. ``index`` is ``write_index``'s result for these tables and
    positions, when the caller already has it."""
    if index is None:
        index = write_index(tables, positions, pool.shape[0], pool.shape[1])
    row, col, block, slot = index
    pool.index_put_((block, slot), values[row, col].to(pool.dtype))
    return pool
