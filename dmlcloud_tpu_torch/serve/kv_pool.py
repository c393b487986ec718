"""The paged KV-cache block pool: fixed device pages, host-side free list.

Counterpart of ``dmlcloud_tpu/serve/kv_pool.py`` (:54-235), whole. One fixed
set of ``[num_blocks, block_size, KH, D]`` pages per layer lives on the device
for the engine's lifetime; each sequence owns just the blocks its live tokens
occupy (its block table), and a finished sequence's blocks go back on the
free list at once, so cache memory scales with live tokens, not with
max-length x batch.

The pool is split in two:

- ``pools`` is the DEVICE half, shaped like ``init_cache``'s tree
  (``{layer_i: {k, v}}``) with the page tensors as leaves. The engine's
  decode step writes them in place (``ops/paged_attention.py``) and
  :meth:`swap` installs what it returns.
- The free list and the live set are the HOST half. Allocation never touches
  the device. Double frees and foreign blocks raise; ``free + live ==
  capacity`` always holds.

Blocks are REFERENCE-COUNTED: ``alloc`` hands a block out with one reference,
:meth:`retain` adds holders, :meth:`release` drops one, and a block returns to
the free list when its last holder lets go. ``live`` counts unique referenced
blocks. A block with ``refcount > 1`` is read-only: a write must fork it
first (the prefix cache's copy-on-write, ``ServeEngine._cow_guard``).
"""

from __future__ import annotations

from typing import Any

import torch

from ..parallel.runtime import resolve_device

__all__ = ["KVBlockPool", "PoolExhausted"]


class PoolExhausted(RuntimeError):
    """An allocation asked for more blocks than the pool has free."""


class KVBlockPool:
    """Fixed pool of KV pages per layer + host-side block accounting."""

    def __init__(
        self,
        num_layers: int,
        kv_heads: int,
        head_dim: int,
        *,
        num_blocks: int,
        block_size: int,
        dtype: torch.dtype = torch.bfloat16,
        device=None,
    ):
        if num_blocks < 1 or block_size < 1:
            raise ValueError(
                f"need num_blocks >= 1 and block_size >= 1, got {num_blocks}/{block_size}"
            )
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.dtype = dtype
        device = resolve_device(device)
        shape = (self.num_blocks, self.block_size, int(kv_heads), int(head_dim))
        #: device half: the page tensors, init_cache-shaped ({layer_i: {k, v}})
        self.pools = {
            f"layer_{i}": {"k": torch.zeros(shape, dtype=dtype, device=device),
                           "v": torch.zeros(shape, dtype=dtype, device=device)}
            for i in range(int(num_layers))
        }
        # host half: low ids hand out first (pop from the end of a reversed
        # stack) — purely cosmetic determinism that makes tests readable
        self._free: list[int] = list(range(self.num_blocks - 1, -1, -1))
        self._ref: dict[int, int] = {}  # live block -> reference count

    @classmethod
    def for_model(cls, cfg, *, num_blocks: int, block_size: int, dtype: Any = None, device=None) -> "KVBlockPool":
        """Pool sized for a ``TransformerConfig``, or for a ``DecoderLM``,
        whose rank holds ``kv_heads / model`` KV heads under tensor
        parallelism (so ``num_blocks`` pages are per rank); dtype defaults to
        the model's compute dtype, matching ``init_cache``."""
        kv_heads = getattr(cfg, "local_kv_heads", None)
        cfg = getattr(cfg, "cfg", cfg)
        return cls(
            cfg.num_layers, cfg.kv_heads if kv_heads is None else kv_heads, cfg.head_dim,
            num_blocks=num_blocks, block_size=block_size,
            dtype=cfg.dtype if dtype is None else dtype, device=device,
        )

    # -- accounting ----------------------------------------------------------
    @property
    def sentinel(self) -> int:
        """The out-of-bounds table entry (``num_blocks``): gathers through
        it are masked, scatters through it are dropped."""
        return self.num_blocks

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_live(self) -> int:
        """UNIQUE referenced blocks — a block mapped into three tables (or
        pinned by the radix tree) still counts once, so ``free + live ==
        capacity`` holds under arbitrary sharing."""
        return len(self._ref)

    def refcount(self, block: int) -> int:
        """Current holders of ``block`` (0 = free / not from this pool)."""
        return self._ref.get(int(block), 0)

    def is_shared(self, block: int) -> bool:
        """More than one holder: the block is READ-ONLY — any write must
        copy-on-write fork first."""
        return self._ref.get(int(block), 0) > 1

    def blocks_for(self, tokens: int) -> int:
        """Blocks needed to hold ``tokens`` cache slots."""
        return -(-int(tokens) // self.block_size)

    def bytes_per_block(self) -> int:
        leaves = next(iter(self.pools.values()))
        per_layer = sum(x.element_size() * self.block_size * x.shape[2] * x.shape[3]
                        for x in leaves.values())
        return per_layer * len(self.pools)

    def stats(self) -> dict:
        """The pool's accounting snapshot (``free + live == capacity`` by
        construction) and its size in bytes."""
        return {
            "capacity": self.num_blocks,
            "free": self.num_free,
            "live": self.num_live,
            "shared": sum(1 for c in self._ref.values() if c > 1),
            "block_size": self.block_size,
            "bytes_total": self.bytes_per_block() * self.num_blocks,
        }

    def assert_consistent(self) -> None:
        """Audit the host accounting itself: every id in exactly one of
        {free list, live set}, counts positive, ids in range, and
        ``free + unique-live == capacity``. Raises ``AssertionError``
        with the discrepancy (also under ``python -O``), so a corrupted free
        list cannot hide behind a numerically balanced invariant."""
        free = set(self._free)
        live = set(self._ref)
        problems = [
            (len(free) != len(self._free), "duplicate ids on the free list"),
            (bool(free & live), f"blocks both free and live: {sorted(free & live)}"),
            (len(free) + len(live) != self.num_blocks,
             f"free ({len(free)}) + live ({len(live)}) != capacity ({self.num_blocks})"),
            (any(not 0 <= b < self.num_blocks for b in self._ref),
             f"live ids out of range: {[b for b in self._ref if not 0 <= b < self.num_blocks]}"),
            (any(c < 1 for c in self._ref.values()),
             f"non-positive refcounts: {[b for b, c in self._ref.items() if c < 1]}"),
        ]
        for bad, msg in problems:
            if bad:
                raise AssertionError(msg)

    # -- alloc / retain / release --------------------------------------------
    def alloc(self, n: int) -> list[int]:
        """Hand out ``n`` free blocks, each with ONE reference; raises
        :class:`PoolExhausted` (and allocates nothing) when fewer than
        ``n`` are free."""
        n = int(n)
        if n > len(self._free):
            raise PoolExhausted(
                f"asked for {n} blocks with only {len(self._free)} of "
                f"{self.num_blocks} free"
            )
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self._ref[b] = 1
        return out

    def retain(self, blocks) -> None:
        """Add one holder to each block (a prefix-cache hit mapping shared
        blocks into a new table, or the radix tree pinning a cached
        block). Retaining a block that is not live raises — a free block
        has no content worth sharing, and silently resurrecting it would
        hand a recycled page to two owners."""
        blocks = list(blocks)
        for b in blocks:
            if b not in self._ref:
                raise ValueError(
                    f"block {b} is not live (cannot retain a free/foreign block)"
                )
        for b in blocks:
            self._ref[b] += 1

    def release(self, blocks) -> None:
        """Drop one reference per block; a block whose LAST holder lets go
        returns to the free list. Releasing a block that is not live, or
        more times in one call than it has holders (double-release,
        release-below-zero, or never allocated here) raises — and releases
        NOTHING, so a bad call can never corrupt the free list or hand the
        same page to two sequences."""
        blocks = [int(b) for b in blocks]
        counts: dict[int, int] = {}
        for b in blocks:
            counts[b] = counts.get(b, 0) + 1
        for b, n in counts.items():
            if self._ref.get(b, 0) < n:
                raise ValueError(
                    f"block {b} is not live (double-freed, released below zero, "
                    "or not from this pool)"
                )
        for b in blocks:
            self._ref[b] -= 1
            if self._ref[b] == 0:
                del self._ref[b]
                self._free.append(b)

    def free(self, blocks) -> None:
        """Back-compat alias of :meth:`release` — under refcounting,
        "freeing" means dropping YOUR reference; the block only reaches
        the free list when nobody else (another table, the radix tree)
        still holds it."""
        self.release(blocks)

    def swap(self, new_pools) -> None:
        """Install the page tensors a decode step returns (the step writes
        the pages in place and returns the same tensors)."""
        self.pools = new_pools
