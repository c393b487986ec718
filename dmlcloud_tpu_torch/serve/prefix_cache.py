"""Prefix-cache sharing: a radix tree of content-addressed KV blocks.

Counterpart of ``dmlcloud_tpu/serve/prefix_cache.py``, whole and host-only:
``_mix_u64``, ``root_key``, ``content_key``, ``prefix_keys``, ``PrefixMatch``
and ``PrefixCache``. The keys are the reference's integers for the same tokens
and adapter (a splitmix64 chain, identical in every process), so prefix
affinity computed by either package names the same template.

- **Content addressing.** A FULL block of ``block_size`` tokens is keyed by the
  tokens it holds, chained from its parent block, so a block's address commits
  to the entire prefix behind it. Partial trailing blocks are never cached.
- **The radix tree.** One node per cached full block, one root per LoRA
  adapter id (adapter deltas change the K/V projections, so tenants never
  share pages). :meth:`PrefixCache.match` walks the tree with a prompt's full
  blocks; :meth:`PrefixCache.lock` re-validates that chain (an eviction may
  have raced between match and admit) and pins it with one
  :meth:`~KVBlockPool.retain` per block. The scheduler maps those blocks
  read-only into the request's table and starts chunked prefill at the
  divergence point.
- **Copy-on-write.** A shared block (``pool.refcount > 1``) is read-only; a
  write into one forks it first (``ServeEngine._cow_guard``).
- **Eviction: leaf-first LRU over refcount.** The tree holds one reference
  per cached block, so an idle cached block has ``refcount == 1`` and is
  evictable; :meth:`PrefixCache.evict` drops least-recently-used unpinned
  leaves first and never tears a cached chain in the middle.

Everything here is host bookkeeping over the pool's free list and refcounts;
the device only sees block tables in which one page id may appear in many
rows.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np

from .kv_pool import KVBlockPool

__all__ = ["PrefixCache", "PrefixMatch", "content_key", "prefix_keys", "root_key"]

# -- stable content addresses -----------------------------------------------
#
# Builtin hash() salts str/bytes per interpreter (PYTHONHASHSEED); these use
# the splitmix64-style counter mix of data/datasets._mix_u64 instead: a pure
# function of the inputs, identical in every process and on every platform.

_M64 = (1 << 64) - 1
_ROOT_TAG = 0x726F6F74  # b"root": the per-adapter tree anchor


def _mix_u64(a: int, b: int) -> int:
    x = (int(a) * 0x9E3779B97F4A7C15 + (int(b) + 1) * 0xD1B54A32D192ED03) & _M64
    x ^= x >> 30
    x = (x * 0xBF58476D1CE4E5B9) & _M64
    x ^= x >> 27
    x = (x * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def root_key(adapter: int) -> int:
    """The content address of an adapter's tree root."""
    return _mix_u64(_ROOT_TAG, int(adapter))


def content_key(parent_key: int, tokens) -> int:
    """One full block's chained content address: every token id folded
    into the parent's key, committing to the entire prefix behind it."""
    k = int(parent_key)
    for t in tokens:
        k = _mix_u64(k, int(t))
    return k


def prefix_keys(tokens, block_size: int, adapter: int = 0) -> list[int]:
    """The content-address chain of a prompt's full blocks, deepest last —
    computable WITHOUT a cache instance, so two replicas agree on what "the
    same template" means (the deepest key names the warmest replica)."""
    toks = np.asarray(tokens).reshape(-1)
    bs = int(block_size)
    keys: list[int] = []
    k = root_key(adapter)
    for i in range(0, (toks.size // bs) * bs, bs):
        k = content_key(k, (int(t) for t in toks[i : i + bs]))
        keys.append(k)
    return keys


class _Node:
    """One cached full block: ``tokens`` (its block_size token ids),
    the physical ``block`` it pinned in the pool, a content address
    chained from the parent, and an LRU tick."""

    __slots__ = ("tokens", "block", "key", "parent", "children", "tick", "dead")

    def __init__(self, tokens: tuple, block: int, parent: "_Node | None"):
        self.tokens = tokens
        self.block = block
        #: chained content address: commits to the whole prefix behind it
        #: (splitmix64 chain — stable across processes, see content_key)
        self.key = content_key(parent.key if parent is not None else 0, tokens)
        self.parent = parent
        self.children: dict[tuple, _Node] = {}
        self.tick = 0
        self.dead = False  # set at eviction: invalidates stale PrefixMatch handles


@dataclass
class PrefixMatch:
    """A :meth:`PrefixCache.match` result: the cached chain for a prompt.
    NOT a lease — nothing is pinned until :meth:`PrefixCache.lock`
    re-validates it (any node may be evicted in between; lock truncates
    at the first dead node instead of handing out a recycled page)."""

    nodes: list = field(default_factory=list)
    #: tokens covered by ``nodes`` (always a multiple of block_size)
    tokens: int = 0

    @property
    def blocks(self) -> list[int]:
        return [n.block for n in self.nodes]


class PrefixCache:
    """Radix tree of content-addressed, refcounted KV blocks over one
    :class:`KVBlockPool` (the TARGET pool only — a speculative engine's
    draft pool has no tree; draft prefill skips via the target's match
    length and the verifier guarantees token identity regardless)."""

    def __init__(self, pool: KVBlockPool):
        self.pool = pool
        self.block_size = pool.block_size
        self._roots: dict[int, _Node] = {}  # adapter id -> tree root
        self._tick = 0  # monotonic LRU clock (deterministic, never wall time)
        self._nodes = 0
        # observables (the ledger carries the per-request twins)
        self.lookups = 0
        self.hits = 0
        self.evictions = 0

    # -- internals -----------------------------------------------------------
    def _root(self, adapter: int) -> _Node:
        root = self._roots.get(int(adapter))
        if root is None:
            root = self._roots[int(adapter)] = _Node((), -1, None)
            root.key = root_key(int(adapter))
        return root

    def _touch(self, node: _Node) -> None:
        self._tick += 1
        node.tick = self._tick

    def _full_blocks(self, tokens) -> list[tuple]:
        toks = np.asarray(tokens).reshape(-1)
        bs = self.block_size
        return [
            tuple(int(t) for t in toks[i : i + bs])
            for i in range(0, (toks.size // bs) * bs, bs)
        ]

    # -- lookup --------------------------------------------------------------
    def match(self, tokens, adapter: int = 0) -> PrefixMatch:
        """The longest cached chain covering ``tokens``' full blocks for
        this adapter. Pure lookup — pins nothing (see :meth:`lock`)."""
        self.lookups += 1
        node = self._root(adapter)
        out = PrefixMatch()
        for chunk in self._full_blocks(tokens):
            child = node.children.get(chunk)
            if child is None:
                break
            out.nodes.append(child)
            out.tokens += self.block_size
            node = child
        if out.nodes:
            self.hits += 1
        return out

    def lock(self, match: PrefixMatch) -> tuple[list[int], int]:
        """Pin a matched chain for admission: re-validate every node (an
        eviction between match and admit marks nodes dead — the chain is
        truncated at the first one, never a recycled page), then retain
        each surviving block ONCE for the admitting request. Returns
        ``(blocks, tokens)`` for the still-valid prefix; the caller owns
        one reference per returned block and must :meth:`KVBlockPool.release`
        them (directly on a failed admit, or via the sequence's normal
        block release at finish)."""
        blocks: list[int] = []
        for node in match.nodes:
            if node.dead:
                break
            blocks.append(node.block)
            self._touch(node)
        if blocks:
            self.pool.retain(blocks)
        return blocks, len(blocks) * self.block_size

    # -- insertion -----------------------------------------------------------
    def insert(self, tokens, blocks, adapter: int = 0) -> int:
        """Register a sequence's written full blocks: ``blocks[i]`` must
        hold the K/V of ``tokens[i*bs:(i+1)*bs]`` (the caller only passes
        fully-written prefixes — stale speculative slots live past the
        fill boundary, in blocks this never sees). Existing nodes are
        LRU-touched and keep THEIR block (the caller's duplicate stays
        private and releases normally); each new node adopts the caller's
        block with one tree-held reference, which is what keeps the page
        alive after the request itself finishes. Returns the number of
        newly adopted blocks."""
        node = self._root(adapter)
        adopted = 0
        for i, chunk in enumerate(self._full_blocks(tokens)):
            child = node.children.get(chunk)
            if child is None:
                if i >= len(blocks):
                    break  # caller owns fewer blocks than full chunks (defensive)
                child = _Node(chunk, int(blocks[i]), node)
                self.pool.retain([child.block])
                node.children[chunk] = child
                self._nodes += 1
                adopted += 1
            self._touch(child)
            node = child
        return adopted

    # -- eviction ------------------------------------------------------------
    def _evictable_leaves(self) -> list[_Node]:
        out = []
        stack = [c for root in self._roots.values() for c in root.children.values()]
        while stack:
            n = stack.pop()
            if n.children:
                stack.extend(n.children.values())
            elif self.pool.refcount(n.block) == 1:  # only the tree holds it
                out.append(n)
        return out

    def _drop(self, node: _Node) -> None:
        node.dead = True
        if node.parent is not None:
            node.parent.children.pop(node.tokens, None)
        self._nodes -= 1
        self.evictions += 1
        self.pool.release([node.block])

    def evict(self, need_free: int) -> int:
        """Free cached blocks until the pool has ``need_free`` free blocks
        (or nothing evictable remains): least-recently-used UNPINNED leaf
        first — a block a live request still maps has ``refcount > 1``
        and is never touched, and dropping leaves before parents keeps
        every surviving chain contiguous. Returns ``pool.num_free``."""
        while self.pool.num_free < need_free:
            leaves = self._evictable_leaves()
            if not leaves:
                break
            self._drop(min(leaves, key=lambda n: n.tick))
        return self.pool.num_free

    def evictable(self) -> int:
        """Cached blocks reclaimable RIGHT NOW plus those reclaimable once
        running requests release their pins — for admission this is every
        tree-held block not pinned by a live mapping, counted by walking
        the tree (pinned interior nodes unwind leaf-first as requests
        finish, so all refcount-1 nodes are eventually reachable)."""
        count = 0
        stack = [c for root in self._roots.values() for c in root.children.values()]
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            if self.pool.refcount(n.block) == 1:
                count += 1
        return count

    # -- observability -------------------------------------------------------
    def leaked_locks(self) -> list[int]:
        """Tree blocks with MORE holders than the tree's own reference —
        call when no request is live (engine idle): every extra holder is
        a lock some admission or exit path forgot to release. Empty list
        = zero lock leaks, the chaos drill's prefix observable."""
        out = []
        stack = [c for root in self._roots.values() for c in root.children.values()]
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            if self.pool.refcount(n.block) > 1:
                out.append(n.block)
        return out

    def stats(self) -> dict:
        return {
            "nodes": self._nodes,
            "cached_blocks": self._nodes,
            "evictable_now": len(self._evictable_leaves()),
            "lookups": self.lookups,
            "hits": self.hits,
            "hit_rate": round(self.hits / self.lookups, 4) if self.lookups else None,
            "evictions": self.evictions,
        }
