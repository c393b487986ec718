"""Sequence packing for the port's data path.

Only ``pack_sequences`` of ``dmlcloud_tpu/data/datasets.py`` is ported so far
(the ``--pack`` flag of the LM example needs it); it is a verbatim numpy copy,
so both packages pack a corpus into identical rows.
"""

from __future__ import annotations

from typing import Iterable, Iterator, Sequence

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
