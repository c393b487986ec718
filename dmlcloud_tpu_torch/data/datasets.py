"""Host-side data pipelines: sharding, batching, packing, mixing, prefetch,
interleave, and the feed onto the device.

Counterpart of ``dmlcloud_tpu/data/datasets.py``, element for element:

- ``DataPipeline`` (:63-410) is an epoch-aware iterator factory plus a chain of
  combinators (``map``, ``pack``, ``pack_stream``, ``shuffle``, ``batch``,
  ``interleave``, ``prefetch``, ``to_device``). Each stage receives the epoch at
  iteration time, so one ``set_epoch`` on the pipeline re-seeds every
  shuffling stage. ``state_dict``/``load_state_dict`` checkpoint the cursor as
  a global element offset (``local consumed x world size``), which the stage's
  step sidecar carries across a preemption.
- ``pack_stream`` (:256) with ``PackStats`` (:412): the chunked greedy packer
  (``_pack_stream_iter``, through the native ``pack_flat`` when the library is
  built) and the first-fit-decreasing window (``_pack_ffd_iter``).
- ``MixPipeline`` (:655-810): weighted mixing whose draw ``t`` is a pure
  function of ``(seed, t)`` (``_mix_u64``, splitmix64 in 64-bit arithmetic).
- ``interleave_batches``/``interleave_dict_batches`` (:883-960), through the
  native ``interleave_into`` for contiguous leaves.
- The reference's class names: ``ShardedSequenceDataset``,
  ``ShardedXrDataset``/``sharded_xr_dataset`` (duck-typed over ``.isel`` and
  ``.load``: no xarray import), ``DownstreamDataset``, ``PrefetchDataset``,
  ``BatchDataset``, including torch ``DataLoader`` worker sub-sharding
  (effective rank ``rank * num_workers + worker_id``).

Every output is the reference's bit for bit on the same numpy inputs. Where
the JAX pipeline ends in ``to_device(mesh)`` (mesh-sharded global arrays), this
one ends in ``to_device(device)`` over ``data.device_iterator``: pinned copies
on a copy stream, ``prefetch`` of them in flight; given a ``mesh``, each batch
is first cut to the rows of this process's data-parallel coordinate.
"""

from __future__ import annotations

import collections
import itertools
import logging
import queue as _queue
import threading
from typing import Any, Callable, Iterable, Iterator, Sequence

import numpy as np
from torch.utils.data import IterableDataset, get_worker_info

from ..parallel import runtime
from .sharding import chunk_and_shard_indices, shard_sequence

__all__ = [
    "BatchDataset",
    "DataPipeline",
    "DownstreamDataset",
    "MixPipeline",
    "PackStats",
    "PrefetchDataset",
    "ShardedSequenceDataset",
    "ShardedXrDataset",
    "interleave_batches",
    "interleave_dict_batches",
    "pack_sequences",
    "sharded_xr_dataset",
]

_logger = logging.getLogger("dmlcloud_tpu_torch")


def _effective_rank_world(rank: int, world_size: int) -> tuple[int, int]:
    """Sub-shard across DataLoader workers: each (rank, worker) pair becomes a
    distinct effective rank, ``rank * num_workers + worker_id``."""
    info = get_worker_info()
    if info is None:
        return rank, world_size
    return rank * info.num_workers + info.id, world_size * info.num_workers


# ---------------------------------------------------------------------------
# pipeline core
# ---------------------------------------------------------------------------

class DataPipeline(IterableDataset):
    """An epoch-aware, composable host-data pipeline.

    Built from a ``make_iter(epoch) -> iterator`` factory; every combinator
    returns a NEW pipeline whose factory pulls from this one's, threading the
    epoch through the chain. Each pass calls the factory with the epoch last
    given to ``set_epoch`` (None before the first call), so one pipeline is
    iterated once per epoch."""

    def __init__(self, make_iter: Callable[[int | None], Iterator], length_fn: Callable[[], int] | None = None):
        self._make_iter = make_iter
        self._length_fn = length_fn
        #: None until set_epoch: a source tells "nobody drives epochs through
        #: this pipeline" (leave a wrapped dataset's own epoch alone) from epoch 0
        self.epoch: int | None = None
        #: elements the CURRENT pass has yielded: the cursor state_dict saves
        self._consumed = 0
        #: one-shot fast-forward of the next pass (set by load_state_dict)
        self._pending_skip = 0
        #: the cursor as the consumer of ``iter_through``'s output sees it
        #: (None: the live cursor)
        self._consumer_state: dict | None = None

    # -- protocol -----------------------------------------------------------
    def set_epoch(self, epoch: int) -> None:
        """Re-seed every shuffling stage for this epoch
        (``DistributedSampler.set_epoch``'s counterpart)."""
        self.epoch = epoch

    def __iter__(self) -> Iterator:
        return self._tracked(self._make_iter(self.epoch))

    def _tracked(self, it: Iterator) -> Iterator:
        """Count the yields (the resumable cursor) and apply a pending
        fast-forward. The skip REPLAYS the upstream chain and discards: every
        stateful stage (shuffle reservoirs, pack and interleave buffers, the
        per-epoch RNG) re-derives its state, so the elements after the skip
        are those of an uninterrupted pass, bit for bit."""
        self._consumed = 0
        self._consumer_state = None
        skip, self._pending_skip = self._pending_skip, 0
        if skip:
            for _ in itertools.islice(it, skip):
                pass
            self._consumed = skip
        for x in it:
            self._consumed += 1
            yield x

    def iter_through(self, wrap: Callable[[Iterator], Iterator]) -> Iterator:
        """One pass through ``wrap``, a function of the host iterator that
        yields one element per host element, in order, and may read ahead of
        its consumer (the stage's device feed: ``prefetch`` copies in flight,
        ``host_prefetch`` batches on a thread). The cursor follows the
        CONSUMER: ``state_dict`` names the element the consumer of ``wrap``'s
        output takes next, however far ``wrap`` has read, for every kind of
        pipeline (a mix's draws and children included): the cursor is
        snapshotted as each element is read and handed over with it. A
        pending fast-forward replays on the host, before ``wrap``."""
        return self._iter_through(self._make_iter(self.epoch), wrap)

    def _iter_through(self, it: Iterator, wrap: Callable[[Iterator], Iterator]) -> Iterator:
        skip, self._pending_skip = self._pending_skip, 0
        self._consumed = 0
        self._consumer_state = None
        if skip:
            for _ in itertools.islice(it, skip):
                pass
            self._consumed = skip
        states: collections.deque = collections.deque()

        def host() -> Iterator:
            for x in it:
                self._consumed += 1
                states.append(self._live_state())
                yield x

        out = wrap(host())
        try:
            for y in out:
                self._consumer_state = states.popleft()
                yield y
        finally:
            close = getattr(out, "close", None)
            if close is not None:
                close()

    # -- resumable iteration state ----------------------------------------
    def state_dict(self) -> dict:
        """The epoch and the GLOBAL element offset (``local consumed x world
        size``: every rank consumes in lockstep, so the globally consumed
        prefix does not depend on the world size), as plain ints. A resume on
        another world size re-derives the per-rank skip from it. During an
        ``iter_through`` pass, the cursor of what its consumer has taken."""
        if self._consumer_state is not None:
            return dict(self._consumer_state)
        return self._live_state()

    def _live_state(self) -> dict:
        """``state_dict`` of what this pipeline's iterator has yielded."""
        ws = runtime.world_size()
        return {"v": 1, "epoch": self.epoch, "global_offset": int(self._consumed) * ws, "world_size": ws}

    def load_state_dict(self, state: dict) -> None:
        """Restore ``state_dict``'s output: re-seed the epoch and arm a
        fast-forward, so that the next pass resumes at the next element. An
        offset not divisible by the new world size rounds DOWN with a
        warning, replaying at most ``world_size - 1`` global elements."""
        if not isinstance(state, dict) or state.get("v") != 1:
            raise ValueError(f"unrecognised DataPipeline state: {state!r}")
        if state.get("epoch") is not None:
            self.set_epoch(int(state["epoch"]))
        ws = runtime.world_size()
        skip, rem = divmod(int(state["global_offset"]), ws)
        if rem:
            _logger.warning("DataPipeline resume: global offset %d is not divisible by the new world size %d; "
                            "rounding down (up to %d element(s) replay)", state["global_offset"], ws, ws - 1)
        self._pending_skip = skip

    def __len__(self) -> int:
        if self._length_fn is None:
            raise TypeError(f"{type(self).__name__} has no length")
        return self._length_fn()

    # -- sources ------------------------------------------------------------
    @classmethod
    def from_source(cls, iterable: Iterable) -> "DataPipeline":
        """Wrap any (re-)iterable; its ``set_epoch`` is called with an
        explicit epoch, never with None."""

        def make(epoch: int | None) -> Iterator:
            if epoch is not None and hasattr(iterable, "set_epoch"):
                iterable.set_epoch(epoch)
            return iter(iterable)

        # evaluated lazily: a source whose length changes after wrapping stays truthful
        length = (lambda: len(iterable)) if hasattr(iterable, "__len__") else None
        return cls(make, length)

    @classmethod
    def from_sequence(
        cls,
        sequence: Sequence,
        shuffle: bool = False,
        even_shards: bool = True,
        seed: int = 0,
        rank: int | None = None,
        world_size: int | None = None,
    ) -> "DataPipeline":
        """This process's share of ``sequence``, reshuffled per epoch with seed
        ``seed + epoch``; the shard is computed lazily at iteration time so
        torch DataLoader workers sub-shard correctly."""
        rank = runtime.rank() if rank is None else rank
        world_size = runtime.world_size() if world_size is None else world_size

        def make(epoch: int | None) -> Iterator:
            r, w = _effective_rank_world(rank, world_size)
            e = 0 if epoch is None else epoch
            return iter(shard_sequence(sequence, r, w, shuffle=shuffle, even_shards=even_shards, seed=seed + e))

        def length() -> int:
            if even_shards:
                return len(sequence) // world_size
            n, rem = divmod(len(sequence), world_size)
            return n + (1 if rank < rem else 0)

        return cls(make, length)

    @classmethod
    def from_chunked(
        cls,
        ds: Any,
        dim: str,
        chunk_size: int,
        chunk_overlap: int = 0,
        even_shards: bool = True,
        equal_chunks: bool = True,
        shuffle: bool = False,
        seed: int = 0,
        rank: int | None = None,
        world_size: int | None = None,
        load: bool = False,
        load_kwargs: dict | None = None,
    ) -> "DataPipeline":
        """This process's chunks of an xarray-like (``.isel``-capable) dataset
        along ``dim``, overlapping windows supported."""
        rank = runtime.rank() if rank is None else rank
        world_size = runtime.world_size() if world_size is None else world_size

        def make(epoch: int | None) -> Iterator:
            r, w = _effective_rank_world(rank, world_size)
            e = 0 if epoch is None else epoch
            return _iter_chunks(ds, dim, chunk_size, chunk_overlap, even_shards, equal_chunks, shuffle, seed + e, r,
                                w, load, load_kwargs)

        return cls(make)

    # -- combinators --------------------------------------------------------
    def _chain(self, wrap: Callable[[Iterator, int | None], Iterator], length_fn=None) -> "DataPipeline":
        parent_make = self._make_iter
        return DataPipeline(lambda epoch: wrap(parent_make(epoch), epoch), length_fn)

    def map(self, fn: Callable[[Any], Any]) -> "DataPipeline":
        return self._chain(lambda it, _e: (fn(x) for x in it), self._length_fn)

    def pack(self, seq_len: int, *, split_long: bool = True) -> "DataPipeline":
        """Pack a stream of variable-length token sequences into fixed
        ``seq_len`` rows of ``{"tokens", "segment_ids"}`` (``pack_sequences``)."""
        if seq_len < 1:
            raise ValueError(f"seq_len must be >= 1, got {seq_len}")
        return self._chain(lambda it, _e: _pack_sequences_iter(it, seq_len, split_long))

    def pack_stream(
        self,
        seq_len: int,
        chunk_docs: int = 1024,
        *,
        split_long: bool = True,
        pack_window: int = 0,
        stats: "PackStats | None" = None,
    ) -> "DataPipeline":
        """Streaming packing of a ragged corpus into ``{"tokens",
        "segment_ids"}`` rows, the production input path.

        ``pack_window == 0``: buffer ``chunk_docs`` documents, flatten them
        to two numpy buffers and pack them greedily in one native
        ``pack_flat`` call (the Python packer when the library is not built:
        the same rows). Each chunk packs on its own, so its last row is
        emitted padded (the chunk-boundary loss, at most ``seq_len - 1``
        slots per chunk).

        ``pack_window > 0``: first-fit-decreasing over windows of
        ``pack_window`` documents (``_pack_ffd_iter``), with open rows that
        persist across windows: no boundary loss but the end-of-stream flush;
        rows reorder within a window's horizon, deterministically.

        The returned pipeline's ``pack_stats`` (a ``PackStats``) is updated
        live during iteration."""
        if seq_len < 1:
            raise ValueError(f"seq_len must be >= 1, got {seq_len}")
        if chunk_docs < 1:
            raise ValueError(f"chunk_docs must be >= 1, got {chunk_docs}")
        if pack_window < 0:
            raise ValueError(f"pack_window must be >= 0, got {pack_window}")
        st = stats if stats is not None else PackStats()

        def wrap(it: Iterator, _e) -> Iterator:
            if pack_window:
                return _pack_ffd_iter(it, seq_len, pack_window, split_long, st)
            return _pack_stream_iter(it, seq_len, chunk_docs, split_long, st)

        out = self._chain(wrap)
        out.pack_stats = st
        return out

    @classmethod
    def mix(cls, sources: Sequence["DataPipeline"], weights: Sequence[float] | None = None,
            seed: int = 0) -> "MixPipeline":
        """Deterministic weighted sampling over child pipelines
        (``MixPipeline``)."""
        return MixPipeline(sources, weights=weights, seed=seed)

    def shuffle(self, buffer_size: int, seed: int = 0) -> "DataPipeline":
        """Streaming shuffle through a ``buffer_size`` reservoir: each yield
        swaps a random buffer slot with the next upstream element. Reshuffles
        per epoch (seed + epoch)."""
        if buffer_size < 1:
            raise ValueError(f"buffer_size must be >= 1, got {buffer_size}")

        def wrap(it: Iterator, epoch: int | None) -> Iterator:
            rng = np.random.default_rng(seed + (0 if epoch is None else epoch))
            buf = []
            for x in it:
                buf.append(x)
                if len(buf) == buffer_size:
                    j = rng.integers(len(buf))
                    buf[j], out = buf[-1], buf[j]
                    buf.pop()
                    yield out
            for i in rng.permutation(len(buf)):  # drain in a random order
                yield buf[i]

        return self._chain(wrap, self._length_fn)

    def batch(self, batch_size: int, drop_remainder: bool = False, collate: Callable | None = None) -> "DataPipeline":
        """Group consecutive elements into lists of ``batch_size``, optionally
        collated (e.g. ``np.stack``)."""

        def wrap(it: Iterator, _e) -> Iterator:
            buf: list = []
            for x in it:
                buf.append(x)
                if len(buf) == batch_size:
                    yield collate(buf) if collate else buf
                    buf = []
            if buf and not drop_remainder:
                yield collate(buf) if collate else buf

        parent_len = self._length_fn

        def length() -> int:
            n = parent_len()
            return n // batch_size if drop_remainder else -(-n // batch_size)

        return self._chain(wrap, length if parent_len is not None else None)

    def interleave(self, num_batches: int, copy: bool = True) -> "DataPipeline":
        """Re-mix groups of ``num_batches`` consecutive batches
        (``interleave_batches``). Batches are copied out of the reused buffer
        by default: lookahead stages (``prefetch``, ``to_device``) hold
        several at once."""
        return self._chain(lambda it, _e: _interleave_pytrees(it, num_batches, copy=copy), self._length_fn)

    def prefetch(self, num_elements: int) -> "DataPipeline":
        """Read ahead ``num_elements`` items on a background thread."""
        return self._chain(lambda it, _e: _prefetch_iter(it, num_elements), self._length_fn)

    def to_device(self, device, prefetch: int = 2, host_prefetch: int = 0, mesh: Any = None) -> "DataPipeline":
        """End the pipeline on ``device`` (``data.device_iterator``): pinned
        copies on a copy stream with ``prefetch`` in flight ahead of the step,
        and with ``host_prefetch > 0`` that many host batches read ahead on a
        background thread. Given a ``mesh``, each (global) batch is cut first
        to the rows of this process's data-parallel coordinate
        (``parallel.mesh.data_parallel_rank``), the rows its tensor- and
        sequence-parallel peers feed too. The cursor counts the batches the
        consumer took, not those in flight (``iter_through``), and a resume's
        fast-forward replays on the host: skipped batches are never copied.
        The stage feeds such a pipeline as it is, without a second device
        iterator."""
        return _DevicePipeline(self, device, prefetch, host_prefetch, mesh)


class _DevicePipeline(DataPipeline):
    """``DataPipeline.to_device``'s result (``on_device`` names the device)."""

    def __init__(self, parent: DataPipeline, device, prefetch: int, host_prefetch: int, mesh: Any):
        import torch

        from .device import device_iterator

        self.on_device = torch.device(device)
        rows = _mesh_rows(mesh) if mesh is not None else None
        parent_make = parent._make_iter

        def host(epoch) -> Iterator:
            it = parent_make(epoch)
            return it if rows is None else (_take_rows(b, rows) for b in it)

        def feed(it: Iterator) -> Iterator:
            return device_iterator(it, self.on_device, prefetch=prefetch, host_prefetch=host_prefetch)

        self._host_make, self._feed = host, feed
        super().__init__(lambda epoch: feed(host(epoch)), parent._length_fn)

    def __iter__(self) -> Iterator:
        return self._iter_through(self._host_make(self.epoch), self._feed)


def _mesh_rows(mesh) -> tuple[int, int]:
    from ..parallel.mesh import data_parallel_rank, data_parallel_size

    return data_parallel_rank(mesh), data_parallel_size(mesh)


def _take_rows(batch: Any, rows: tuple[int, int]) -> Any:
    """The ``rank``-th of ``size`` contiguous row blocks of every leaf."""
    rank, size = rows
    if isinstance(batch, dict):
        return {k: _take_rows(v, rows) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(_take_rows(v, rows) for v in batch)
    n = batch.shape[0]
    if n % size:
        raise ValueError(f"batch of {n} rows does not divide over the mesh's {size} data-parallel ranks")
    per = n // size
    return batch[rank * per:(rank + 1) * per]


# ---------------------------------------------------------------------------
# streaming chunked packing (the production ragged-corpus input path)
# ---------------------------------------------------------------------------

class PackStats:
    """Live packing accounting of one ``pack_stream`` stage, cumulative across
    epochs unless ``reset``:

    - ``docs`` / ``chunks`` / ``rows``: documents consumed, chunks packed,
      fixed-shape rows emitted;
    - ``tokens_in``: real tokens entering the packer;
    - ``tokens_placed``: real tokens placed into rows (fewer than
      ``tokens_in`` only when ``split_long=False`` truncates);
    - ``slots``: ``rows * seq_len``;
    - ``pad_slots``: slots holding padding (``segment_ids == 0``);
    - ``boundary_pad_slots``: the part of ``pad_slots`` in each chunk's last
      row (the price of never packing across a chunk boundary)."""

    def __init__(self):
        self.docs = 0
        self.chunks = 0
        self.rows = 0
        self.tokens_in = 0
        self.tokens_placed = 0
        self.slots = 0
        self.pad_slots = 0
        self.boundary_pad_slots = 0

    def reset(self) -> None:
        self.__init__()

    @property
    def pad_fraction(self) -> float:
        """Fraction of emitted slots that are padding (0.0 before any row)."""
        return self.pad_slots / self.slots if self.slots else 0.0

    @property
    def boundary_fraction(self) -> float:
        """Fraction of emitted slots lost to chunk-boundary tail rows."""
        return self.boundary_pad_slots / self.slots if self.slots else 0.0

    def as_dict(self) -> dict:
        return {
            "docs": self.docs,
            "chunks": self.chunks,
            "rows": self.rows,
            "tokens_in": self.tokens_in,
            "tokens_placed": self.tokens_placed,
            "slots": self.slots,
            "pad_slots": self.pad_slots,
            "boundary_pad_slots": self.boundary_pad_slots,
            "pad_fraction": round(self.pad_fraction, 6),
            "boundary_fraction": round(self.boundary_fraction, 6),
        }

    def __repr__(self):
        return f"PackStats({self.as_dict()})"


def _pack_stream_iter(docs: Iterator, seq_len: int, chunk_docs: int, split_long: bool,
                      stats: PackStats) -> Iterator[dict]:
    """Chunked packing: per window of ``chunk_docs`` documents, one flatten
    and one native ``pack_flat`` call (the Python packer without the library:
    the same rows), the rows yielded one at a time. Each chunk's rows are
    exactly ``pack_sequences(chunk)``."""
    from ..native import pack as _native_pack

    native_ok = _native_pack.available()

    def pack_chunk(buf: list) -> Iterator[dict]:
        arrays = [np.asarray(d, np.int32).ravel() for d in buf]
        stats.docs += len(arrays)
        arrays = [a for a in arrays if a.size]  # the packer skips empty docs
        if not arrays:
            return
        stats.tokens_in += sum(int(a.size) for a in arrays)
        if native_ok:
            lengths = np.fromiter((a.size for a in arrays), np.int64, count=len(arrays))
            tokens, segs = _native_pack.pack_flat(np.concatenate(arrays), lengths, seq_len, split_long=split_long)
            rows = [{"tokens": tokens[i], "segment_ids": segs[i]} for i in range(len(tokens))]
        else:
            rows = list(_pack_sequences_iter(arrays, seq_len, split_long))
        stats.chunks += 1
        stats.rows += len(rows)
        stats.slots += len(rows) * seq_len
        pad = sum(int(np.count_nonzero(r["segment_ids"] == 0)) for r in rows)
        stats.pad_slots += pad
        stats.tokens_placed += len(rows) * seq_len - pad
        if rows:
            stats.boundary_pad_slots += int(np.count_nonzero(rows[-1]["segment_ids"] == 0))
        yield from rows

    buf: list = []
    for doc in docs:
        buf.append(doc)
        if len(buf) == chunk_docs:
            yield from pack_chunk(buf)
            buf = []
    if buf:
        yield from pack_chunk(buf)


def _pack_ffd_iter(docs: Iterator, seq_len: int, window_docs: int, split_long: bool,
                   stats: PackStats) -> Iterator[dict]:
    """Window-based first-fit-decreasing packing (``pack_stream(...,
    pack_window=N)``).

    Documents buffer in windows of ``window_docs``; each window is sorted
    longest-first (stable: equal lengths keep arrival order) and first-fit
    placed into open rows ("bins"), which stay open across windows. A row is
    emitted the moment it fills, or when the open-bin cap (``max(window_docs,
    16)``) evicts the fullest (oldest on ties); the end-of-stream flush is the
    only boundary waste. The row sequence is a pure function of the input
    stream, ``seq_len`` and ``window_docs``."""
    max_open = max(int(window_docs), 16)
    bins: list[list] = []  # [fill, parts]; list order == creation order == first-fit order

    def emit(parts: list, fill: int, boundary: bool = False) -> dict:
        tokens = np.zeros(seq_len, np.int32)
        segs = np.zeros(seq_len, np.int32)
        at = 0
        for seg, p in enumerate(parts, 1):
            tokens[at:at + p.size] = p
            segs[at:at + p.size] = seg
            at += p.size
        stats.rows += 1
        stats.slots += seq_len
        stats.pad_slots += seq_len - fill
        stats.tokens_placed += fill
        if boundary:
            stats.boundary_pad_slots += seq_len - fill
        return {"tokens": tokens, "segment_ids": segs}

    def place(part: np.ndarray) -> dict | None:
        for b in bins:
            if b[0] + part.size <= seq_len:
                b[1].append(part)
                b[0] += part.size
                if b[0] == seq_len:
                    bins.remove(b)
                    return emit(b[1], b[0])
                return None
        bins.append([int(part.size), [part]])
        if len(bins) > max_open:
            # bound memory: close the fullest bin (ties: the oldest); its
            # padding is ordinary waste, not boundary waste
            full = max(bins, key=lambda b: b[0])
            bins.remove(full)
            return emit(full[1], full[0])
        return None

    def run_window(buf: list) -> Iterator[dict]:
        arrays = [np.asarray(d, np.int32).ravel() for d in buf]
        stats.docs += len(arrays)
        arrays = [a for a in arrays if a.size]
        if not arrays:
            return
        stats.tokens_in += sum(int(a.size) for a in arrays)
        stats.chunks += 1
        parts: list[np.ndarray] = []
        for a in arrays:
            if a.size > seq_len:
                if split_long:
                    # whole seq_len pieces are born full rows; the tail joins
                    # the window's pool like any short document
                    off = 0
                    while a.size - off >= seq_len:
                        yield emit([a[off:off + seq_len]], seq_len)
                        off += seq_len
                    if off < a.size:
                        parts.append(a[off:])
                else:
                    yield emit([a[:seq_len]], seq_len)
            else:
                parts.append(a)
        parts.sort(key=lambda p: p.size, reverse=True)  # stable: ties keep arrival order
        for p in parts:
            row = place(p)
            if row is not None:
                yield row

    buf: list = []
    for doc in docs:
        buf.append(doc)
        if len(buf) == window_docs:
            yield from run_window(buf)
            buf = []
    if buf:
        yield from run_window(buf)
    for fill, parts in bins:  # end-of-stream flush: the only boundary waste
        yield emit(parts, fill, boundary=True)


# ---------------------------------------------------------------------------
# deterministic weighted multi-source mixing
# ---------------------------------------------------------------------------

_M64 = (1 << 64) - 1


def _mix_u64(seed: int, step: int) -> int:
    """splitmix64-style counter hash: a uniform u64, a pure function of
    ``(seed, step)`` (Python ints masked to 64 bits), so the draw sequence
    re-enters at any step and is the same on every rank and platform."""
    x = (int(seed) * 0x9E3779B97F4A7C15 + (int(step) + 1) * 0xD1B54A32D192ED03) & _M64
    x ^= x >> 30
    x = (x * 0xBF58476D1CE4E5B9) & _M64
    x ^= x >> 27
    x = (x * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def _mix_choice(seed: int, step: int, weights: Sequence[float], alive: Sequence[bool]) -> int:
    """Source index of draw ``step``: the u64 mapped onto the cumulative
    weights of the sources still alive (an exhausted source carries no mass)."""
    total = sum(w for w, a in zip(weights, alive) if a)
    u = (_mix_u64(seed, step) / float(1 << 64)) * total
    acc = 0.0
    last = 0
    for i, (w, a) in enumerate(zip(weights, alive)):
        if not a:
            continue
        acc += w
        last = i
        if u < acc:
            return i
    return last  # float roundoff on the final boundary


class MixPipeline(DataPipeline):
    """Deterministic weighted mixing over child pipelines
    (``DataPipeline.mix``).

    The choice sequence is a pure function of ``(seed + epoch, draw index)``,
    so the mix is reproducible and resumable mid-stream: ``state_dict`` holds
    the draw cursor and every child's own state, ``load_state_dict``
    fast-forwards the children and re-enters the draw sequence at the next
    step (nothing replayed or skipped, on another world size too). A source
    that runs out renormalizes the remaining weights with a warning; the mix
    ends when every source is exhausted."""

    def __init__(self, sources: Sequence[DataPipeline], weights: Sequence[float] | None = None, seed: int = 0):
        sources = list(sources)
        if not sources:
            raise ValueError("mix needs at least one source")
        if weights is None:
            weights = [1.0] * len(sources)
        weights = [float(w) for w in weights]
        if len(weights) != len(sources):
            raise ValueError(f"mix got {len(sources)} source(s) but {len(weights)} weight(s)")
        if any(not np.isfinite(w) or w <= 0 for w in weights):
            raise ValueError(f"mix weights must be positive and finite, got {weights}")
        self._sources = sources
        self._weights = weights
        self._seed = int(seed)
        #: draws of the CURRENT pass, and those carried in from a resume
        self._draws = 0
        self._draws_base = 0
        #: elements the pass resumed past (load_state_dict arms it)
        self._consumed_base = 0
        self._exhausted = [False] * len(sources)
        #: one-shot resume payload of the next __iter__
        self._mix_resume: dict | None = None
        super().__init__(self._mix_iter, lambda: sum(len(s) for s in self._sources))

    def set_epoch(self, epoch: int) -> None:
        super().set_epoch(epoch)
        for s in self._sources:
            if hasattr(s, "set_epoch"):
                s.set_epoch(epoch)

    def _mix_iter(self, epoch) -> Iterator:
        # the epoch folds into the seed (the shuffle() convention)
        seed = self._seed + (0 if epoch is None else int(epoch))
        resume, self._mix_resume = self._mix_resume, None
        if resume is None:
            self._draws_base = 0
            self._consumed_base = 0
            alive = [True] * len(self._sources)
        else:
            self._draws_base = resume["draws"]
            self._consumed_base = resume["consumed"]
            alive = [not x for x in resume["exhausted"]]
        self._draws = 0
        self._exhausted = [not a for a in alive]
        its = [iter(s) for s in self._sources]
        while any(alive):
            i = _mix_choice(seed, self._draws_base + self._draws, self._weights, alive)
            self._draws += 1
            try:
                yield next(its[i])
            except StopIteration:
                alive[i] = False
                self._exhausted[i] = True
                if any(alive):
                    remaining = [w for w, a in zip(self._weights, alive) if a]
                    _logger.warning("mix: source %d exhausted after %d draw(s); renormalizing over the %d remaining "
                                    "source(s) (weights %s)", i, self._draws_base + self._draws, len(remaining),
                                    remaining)

    def _live_state(self) -> dict:
        """The global element offset AND global draw count (draws outnumber
        yields when a draw hit an exhausted source), plus every child's own
        state; all counters global (``local x world size``)."""
        ws = runtime.world_size()
        return {
            "v": 1,
            "kind": "mix",
            "epoch": self.epoch,
            "global_offset": (self._consumed_base + self._consumed) * ws,
            "global_draws": (self._draws_base + self._draws) * ws,
            "world_size": ws,
            "exhausted": list(self._exhausted),
            "children": [s.state_dict() for s in self._sources],
        }

    def load_state_dict(self, state: dict) -> None:
        """Restore a mix ``state_dict``: each child fast-forwards through its
        OWN ``load_state_dict``, and the next pass re-enters the draws at the
        saved step. A plain v1 state degrades to the base class's replay
        (the draws are pure, so a replay makes the same choices)."""
        if not (isinstance(state, dict) and state.get("kind") == "mix"):
            super().load_state_dict(state)
            return
        if state.get("v") != 1:
            raise ValueError(f"unrecognised MixPipeline state: {state!r}")
        children = state.get("children") or []
        if len(children) != len(self._sources):
            raise ValueError(f"mix state carries {len(children)} child state(s) for {len(self._sources)} source(s)")
        for s, cs in zip(self._sources, children):
            s.load_state_dict(cs)
        if state.get("epoch") is not None:
            self.set_epoch(int(state["epoch"]))
        ws = runtime.world_size()
        consumed, rem_c = divmod(int(state["global_offset"]), ws)
        draws, rem_d = divmod(int(state["global_draws"]), ws)
        if rem_c or rem_d:
            _logger.warning("mix resume: global cursor (%d elements, %d draws) is not divisible by the new world "
                            "size %d; rounding down", state["global_offset"], state["global_draws"], ws)
        self._pending_skip = 0  # the children fast-forward themselves
        self._mix_resume = {
            "consumed": consumed,
            "draws": draws,
            "exhausted": [bool(x) for x in state.get("exhausted", [])] or [False] * len(self._sources),
        }


def _iter_chunks(ds, dim, chunk_size, chunk_overlap, even_shards, equal_chunks, shuffle, seed, rank, world_size,
                 load, load_kwargs) -> Iterator[Any]:
    num_elements = len(ds[dim]) if hasattr(ds, "__getitem__") and not isinstance(ds, np.ndarray) else ds.sizes[dim]
    chunks = chunk_and_shard_indices(num_elements, chunk_size, rank, world_size, chunk_overlap=chunk_overlap,
                                     even_shards=even_shards, equal_chunks=equal_chunks, shuffle=shuffle, seed=seed)
    for start, end in chunks:
        chunk = ds.isel({dim: slice(start, end)})
        if load:
            chunk.load(**(load_kwargs or {}))
        yield chunk


def _prefetch_iter(src: Iterator, num_elements: int, name: str = "dml-host-prefetch") -> Iterator:
    """Read ``src`` ahead on a background thread through a queue of
    ``num_elements``. An exception in the source re-raises in the consumer;
    closing or abandoning the consumer generator stops the producer, which
    otherwise would block forever on a full queue, pinning the thread, its
    queued batches and the source. ``name`` labels the producer thread
    (``ShardReader`` uses ``dml-shard-reader``)."""
    q: _queue.Queue = _queue.Queue(maxsize=max(num_elements, 1))
    stop = threading.Event()
    _END, _ERR = object(), object()

    def put(item: Any) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except _queue.Full:
                continue
        return False

    def produce() -> None:
        try:
            for item in src:
                if not put(item):
                    return
        except BaseException as e:  # noqa: BLE001 - re-raised on the consumer's side
            put((_ERR, e))
            return
        put(_END)

    # daemon, so that a leaked consumer can never pin process exit
    thread = threading.Thread(target=produce, daemon=True, name=name)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                return
            if isinstance(item, tuple) and len(item) == 2 and item[0] is _ERR:
                raise item[1]
            yield item
    finally:
        stop.set()
        try:  # free one slot, so that a producer blocked in put sees the stop
            q.get_nowait()
        except _queue.Empty:
            pass


# ---------------------------------------------------------------------------
# batch interleaving (nested dicts, lists and tuples of arrays)
# ---------------------------------------------------------------------------

def _flatten(tree: Any) -> tuple[list, Callable[[list], Any]]:
    """The array leaves of ``tree`` (dicts, lists, tuples) in a fixed order,
    and the function that rebuilds the structure from such a list."""
    if isinstance(tree, dict):
        keys = list(tree)
        parts = [_flatten(tree[k]) for k in keys]
    elif isinstance(tree, (list, tuple)):
        keys = None
        parts = [_flatten(v) for v in tree]
    else:
        return [tree], lambda leaves: leaves[0]
    sizes = [len(p[0]) for p in parts]
    leaves = [leaf for p in parts for leaf in p[0]]
    kind = type(tree)

    def unflatten(values: list) -> Any:
        out, at = [], 0
        for (_, rebuild), n in zip(parts, sizes):
            out.append(rebuild(values[at:at + n]))
            at += n
        if keys is not None:
            return dict(zip(keys, out))
        return kind(out)

    return leaves, unflatten


def _interleave_pytrees(iterable: Iterable[Any], num_batches: int, copy: bool = False) -> Iterator[Any]:
    """Re-slice each window of ``num_batches`` consecutive batches into
    ``num_batches`` mixed batches, per leaf, through preallocated buffers:
    mixed batch ``i`` is the concatenation of slice ``i`` of every window
    batch. Contiguous leaves go through the native kernel
    (``native/interleave.cpp``), others through strided numpy copies. The
    yielded leaves ALIAS the reused buffers unless ``copy``."""
    if num_batches < 1:
        raise ValueError("num_batches must be greater than 0")
    if num_batches == 1:
        yield from iterable
        return

    from ..native import interleave as _native

    native_ok = _native.available()
    unflatten = None
    buffers: list[np.ndarray] = []
    slice_sizes: list[int] = []
    window: list[list[np.ndarray]] = []

    for batch in iterable:
        leaves, this_unflatten = _flatten(batch)
        leaves = [np.asarray(x) for x in leaves]
        if unflatten is None:
            unflatten = this_unflatten
            for leaf in leaves:
                if leaf.shape[0] % num_batches:
                    raise ValueError(
                        f"Batch dimension ({leaf.shape[0]}) must be divisible by num_batches={num_batches}")
                slice_sizes.append(leaf.shape[0] // num_batches)
                buffers.append(np.empty((num_batches, *leaf.shape), dtype=leaf.dtype))

        window.append(leaves)
        if len(window) < num_batches:
            continue

        for li, (buf, s) in enumerate(zip(buffers, slice_sizes)):
            srcs = [w[li] for w in window]
            if native_ok and all(b.flags.c_contiguous for b in srcs):
                _native.interleave_into(buf, srcs, s)
            else:
                for i in range(num_batches):
                    for j in range(num_batches):
                        buf[i, j * s:(j + 1) * s] = srcs[j][i * s:(i + 1) * s]
        window = []
        for i in range(num_batches):
            yield unflatten([buf[i].copy() if copy else buf[i] for buf in buffers])


def interleave_batches(iterable: Iterable[np.ndarray], num_batches: int) -> Iterator[np.ndarray]:
    """Array variant. Yielded views alias a reused buffer: consume or copy
    immediately."""
    return _interleave_pytrees(iterable, num_batches)


def interleave_dict_batches(iterable: Iterable[dict[str, np.ndarray]],
                            num_batches: int) -> Iterator[dict[str, np.ndarray]]:
    """Dict-of-arrays variant; the yielded dicts alias reused buffers."""
    return _interleave_pytrees(iterable, num_batches)


# ---------------------------------------------------------------------------
# the reference's class names
# ---------------------------------------------------------------------------

class _ReconstructOnUnpickle:
    """The pipeline core holds closures, which do not pickle; these classes
    must (DataLoader workers receive the dataset by pickle), so each records
    its constructor arguments and is rebuilt, epoch kept, on the other side."""

    _ctor_args: tuple = ()
    _ctor_kwargs: dict = {}

    def __getstate__(self):
        return {"args": self._ctor_args, "kwargs": self._ctor_kwargs, "epoch": self.epoch}

    def __setstate__(self, state):
        self.__init__(*state["args"], **state.get("kwargs", {}))
        self.epoch = state["epoch"]


def sharded_xr_dataset(
    ds: Any,
    dim: str,
    chunk_size: int,
    chunk_overlap: int = 0,
    even_shards: bool = True,
    equal_chunks: bool = True,
    shuffle: bool = False,
    seed: int = 0,
    rank: int | None = None,
    world_size: int | None = None,
    load: bool = False,
    load_kwargs: dict | None = None,
) -> Iterator[Any]:
    """One epoch of this process's chunks of an ``.isel``-capable dataset."""
    rank = runtime.rank() if rank is None else rank
    world_size = runtime.world_size() if world_size is None else world_size
    return _iter_chunks(ds, dim, chunk_size, chunk_overlap, even_shards, equal_chunks, shuffle, seed, rank,
                        world_size, load, load_kwargs)


class ShardedSequenceDataset(_ReconstructOnUnpickle, DataPipeline):
    """``DataPipeline.from_sequence`` under the reference's class name."""

    def __init__(
        self,
        sequence: Sequence,
        shuffle: bool = False,
        even_shards: bool = True,
        seed: int = 0,
        rank: int | None = None,
        world_size: int | None = None,
    ):
        rank = runtime.rank() if rank is None else rank
        world_size = runtime.world_size() if world_size is None else world_size
        self._ctor_args = (sequence, shuffle, even_shards, seed, rank, world_size)
        self._ctor_kwargs = {}
        p = DataPipeline.from_sequence(sequence, shuffle=shuffle, even_shards=even_shards, seed=seed, rank=rank,
                                       world_size=world_size)
        super().__init__(p._make_iter, p._length_fn)
        self.sequence = sequence


class ShardedXrDataset(_ReconstructOnUnpickle, DataPipeline):
    """``DataPipeline.from_chunked`` under the reference's class name, with
    its positional order, ``process_group`` slot included (pass
    ``rank``/``world_size`` instead)."""

    def __init__(
        self,
        ds: Any,
        dim: str,
        chunk_size: int,
        chunk_overlap: int = 0,
        even_shards: bool = True,
        equal_chunks: bool = True,
        shuffle: bool = False,
        seed: int = 0,
        rank: int | None = None,
        world_size: int | None = None,
        process_group: Any = None,
        load: bool = False,
        load_kwargs: dict | None = None,
    ):
        if process_group is not None:
            raise ValueError("process_group is not taken here: the dataset shards by rank and world size; pass "
                             "rank/world_size instead")
        rank = runtime.rank() if rank is None else rank
        world_size = runtime.world_size() if world_size is None else world_size
        self._ctor_args = (ds, dim, chunk_size, chunk_overlap, even_shards, equal_chunks, shuffle, seed, rank,
                           world_size, None, load, load_kwargs)
        self._ctor_kwargs = {}
        p = DataPipeline.from_chunked(ds, dim, chunk_size, chunk_overlap=chunk_overlap, even_shards=even_shards,
                                      equal_chunks=equal_chunks, shuffle=shuffle, seed=seed, rank=rank,
                                      world_size=world_size, load=load, load_kwargs=load_kwargs)
        super().__init__(p._make_iter, p._length_fn)
        self.ds = ds


class DownstreamDataset(_ReconstructOnUnpickle, DataPipeline):
    """Base of the wrappers: the epoch propagates to the wrapped source."""

    def __init__(self, source_ds: Iterable):
        self._ctor_args = (source_ds,)
        self._ctor_kwargs = {}
        p = DataPipeline.from_source(source_ds)
        super().__init__(p._make_iter, p._length_fn)
        self.source_ds = source_ds

    def set_epoch(self, epoch: int) -> None:
        super().set_epoch(epoch)
        if hasattr(self.source_ds, "set_epoch"):
            self.source_ds.set_epoch(epoch)


class PrefetchDataset(DownstreamDataset):
    """``.prefetch()`` under the reference's class name."""

    def __init__(self, source_ds: Iterable, num_elements: int):
        super().__init__(source_ds)
        self._ctor_args = (source_ds, num_elements)
        self.num_elements = num_elements
        parent = self._make_iter
        self._make_iter = lambda epoch: _prefetch_iter(parent(epoch), num_elements)


class BatchDataset(DownstreamDataset):
    """``.batch()`` under the reference's class name."""

    def __init__(self, source_ds: Iterable, batch_size: int, drop_remainder: bool = False):
        super().__init__(source_ds)
        self._ctor_args = (source_ds, batch_size, drop_remainder)
        self.batch_size = batch_size
        self.drop_remainder = drop_remainder
        batched = DataPipeline(self._make_iter, self._length_fn).batch(batch_size, drop_remainder)
        self._make_iter = batched._make_iter
        self._length_fn = batched._length_fn


def pack_sequences(
    examples: Iterable[Sequence[int] | np.ndarray],
    seq_len: int,
    *,
    split_long: bool = True,
) -> Iterator[dict]:
    """Greedily pack variable-length token sequences into fixed ``seq_len``
    rows, yielding ``{"tokens": [seq_len] int32, "segment_ids": [seq_len]
    int32}`` — the input contract of ``DecoderLM(segment_ids=...)`` /
    ``lm_loss(segment_ids=...)``: segment ids are 1-based per row, 0 marks
    padding, attention never crosses a segment boundary and positions restart
    per segment.

    Streaming single-pass fill: an example that fits the remaining row space
    is appended whole; one that fits an EMPTY row starts a fresh row (never
    split); only examples longer than ``seq_len`` itself are split across rows
    when ``split_long`` (each part its own segment), else truncated to
    ``seq_len``. The trailing partially-filled row is emitted padded.
    """
    if seq_len < 1:  # validate eagerly — the generator body runs lazily
        raise ValueError(f"seq_len must be >= 1, got {seq_len}")
    return _pack_sequences_iter(examples, seq_len, split_long)


def _pack_sequences_iter(examples, seq_len, split_long):
    tokens = np.zeros(seq_len, np.int32)
    segs = np.zeros(seq_len, np.int32)
    fill, seg = 0, 0

    def flush():
        nonlocal tokens, segs, fill, seg
        out = {"tokens": tokens, "segment_ids": segs}
        tokens, segs = np.zeros(seq_len, np.int32), np.zeros(seq_len, np.int32)
        fill, seg = 0, 0
        return out

    def place(part):
        nonlocal fill, seg
        seg += 1
        tokens[fill : fill + part.size] = part
        segs[fill : fill + part.size] = seg
        fill += part.size

    for ex in examples:
        ex = np.asarray(ex, np.int32).ravel()
        if ex.size == 0:
            continue
        if ex.size <= seq_len:
            if ex.size > seq_len - fill:
                yield flush()
            place(ex)
            if fill == seq_len:
                yield flush()
        elif split_long:
            offset = 0
            while offset < ex.size:
                if fill == seq_len:
                    yield flush()
                take = min(ex.size - offset, seq_len - fill)
                place(ex[offset : offset + take])
                offset += take
        else:
            if fill:
                yield flush()
            place(ex[:seq_len])
            yield flush()
    if fill:
        yield flush()
