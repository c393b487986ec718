"""Sequence packing and the background host reader of the port's data path.

Of ``dmlcloud_tpu/data/datasets.py`` two pieces are ported so far:
``pack_sequences`` (the ``--pack`` flag of the LM example needs it), a
verbatim numpy copy, so both packages pack a corpus into identical rows; and
``_prefetch_iter`` (:828), the bounded-queue reader behind
``device_iterator(host_prefetch=...)``.
"""

from __future__ import annotations

import queue as _queue
import threading
from typing import Any, Iterable, Iterator, Sequence

import numpy as np

__all__ = ["pack_sequences"]


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
