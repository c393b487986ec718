"""Sequence packing, rank-sharded index datasets and the background host
reader of the port's data path.

Of ``dmlcloud_tpu/data/datasets.py`` these pieces are ported so far:
``pack_sequences`` (the ``--pack`` flag of the LM example needs it), a
verbatim numpy copy, so both packages pack a corpus into identical rows;
``DataPipeline`` with only its ``from_sequence`` source, and the
``ShardedSequenceDataset`` shim over it (the MNIST example's per-rank,
per-epoch shuffled indices); ``_effective_rank_world`` (:50), which sub-shards
across torch ``DataLoader`` workers; and ``_prefetch_iter`` (:828), the
bounded-queue reader behind ``device_iterator(host_prefetch=...)``.
"""

from __future__ import annotations

import queue as _queue
import threading
from typing import Any, Callable, Iterable, Iterator, Sequence

import numpy as np
from torch.utils.data import IterableDataset, get_worker_info

from ..parallel import runtime
from .sharding import shard_sequence

__all__ = ["DataPipeline", "ShardedSequenceDataset", "pack_sequences"]


def _effective_rank_world(rank: int, world_size: int) -> tuple[int, int]:
    """Sub-shard across DataLoader workers: each (rank, worker) pair becomes a
    distinct effective rank, ``rank * num_workers + worker_id``."""
    info = get_worker_info()
    if info is None:
        return rank, world_size
    return rank * info.num_workers + info.id, world_size * info.num_workers


class DataPipeline(IterableDataset):
    """An epoch-aware host-data source, built from a ``make_iter(epoch) ->
    iterator`` factory; each pass calls the factory with the epoch last given
    to ``set_epoch`` (None before the first call), so one pipeline is iterated
    once per epoch. Of the reference's combinators only the ``from_sequence``
    source is ported."""

    def __init__(self, make_iter: Callable[[int | None], Iterator], length_fn: Callable[[], int] | None = None):
        self._make_iter = make_iter
        self._length_fn = length_fn
        self.epoch: int | None = None

    def set_epoch(self, epoch: int) -> None:
        """Re-seed the shuffle for this epoch (``DistributedSampler.set_epoch``'s
        counterpart)."""
        self.epoch = epoch

    def __iter__(self) -> Iterator:
        return self._make_iter(self.epoch)

    def __len__(self) -> int:
        if self._length_fn is None:
            raise TypeError(f"{type(self).__name__} has no length")
        return self._length_fn()

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


class ShardedSequenceDataset(DataPipeline):
    """``DataPipeline.from_sequence`` under the reference's class name. It
    pickles (DataLoader workers receive the dataset by pickle) by its
    constructor arguments and epoch, since the pipeline holds closures."""

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
        p = DataPipeline.from_sequence(
            sequence, shuffle=shuffle, even_shards=even_shards, seed=seed, rank=rank, world_size=world_size
        )
        super().__init__(p._make_iter, p._length_fn)
        self.sequence = sequence

    def __getstate__(self):
        return {"args": self._ctor_args, "epoch": self.epoch}

    def __setstate__(self, state):
        self.__init__(*state["args"])
        self.epoch = state["epoch"]


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


def _prefetch_iter(src: Iterator, num_elements: int, name: str = "dml-host-prefetch") -> Iterator:
    """Read ``src`` ahead on a background thread through a queue of
    ``num_elements``. An exception in the source re-raises in the consumer;
    closing or abandoning the consumer generator stops the producer, which
    otherwise would block forever on a full queue, pinning the thread, its
    queued batches and the source. ``name`` labels the producer thread."""
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
