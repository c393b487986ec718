"""The disk-native data plane: mmap'd ``.dmlshard`` files and the async shard
reader.

Counterpart of ``dmlcloud_tpu/data/store.py``, with the same format byte for
byte, so a corpus written by either package is read by the other. A
``.dmlshard`` file is a schema-versioned, checksummed container for
variable-length int32 token records, laid out so a reader never deserialises
anything:

=========  =======================  ==============================================
offset     bytes                    contents
=========  =======================  ==============================================
0          8                        magic ``b"DMLSHRD1"``
8          4                        format version (u32 little-endian, currently 1)
12         4                        dtype code (u32; 1 = int32 tokens)
16         8                        record count ``n`` (u64)
24         8                        payload token count ``t`` (u64)
32         4                        CRC32 of the offset index (u32)
36         4                        CRC32 of the token payload (u32)
40         24                       reserved (zero)
64         8 * (n + 1)              offset index: u64 TOKEN offsets, ``off[0] = 0``,
                                    ``off[n] = t`` — record ``i`` spans
                                    ``payload[off[i] : off[i+1]]``
64+8(n+1)  4 * t                    payload: int32 tokens, records back to back
=========  =======================  ==============================================

Every region is naturally aligned, so ``ShardFile`` maps the file once with
``np.memmap`` and serves each record as a zero-copy int32 view. Checksums are
verified on demand (``ShardFile.verify``), not on open, so opening a corpus
costs header reads only.

``ShardStore`` is an ordered corpus of shards (sorted file names define the
global record order); ``ShardReader`` is the pipeline source: a
double-buffered reader on a ``dml-shard-reader`` thread, with record-strided
assignment over the ranks and a cursor that seeks, and survives a change of
world size.
"""

from __future__ import annotations

import json
import os
import struct
import threading
import zlib
from typing import Iterable, Iterator, Sequence

import numpy as np

from ..parallel import runtime
from .datasets import DataPipeline, _prefetch_iter

MAGIC = b"DMLSHRD1"
FORMAT_VERSION = 1
_DTYPE_INT32 = 1
HEADER_SIZE = 64
_HEADER_STRUCT = struct.Struct("<8sIIQQII")  # magic, version, dtype, n, t, crc_idx, crc_pay
SHARD_SUFFIX = ".dmlshard"
MANIFEST_NAME = "corpus.json"

__all__ = [
    "FORMAT_VERSION",
    "CorpusBuilder",
    "ShardCorruptError",
    "ShardFile",
    "ShardReader",
    "ShardStore",
    "build_corpus",
    "reader_activity",
    "write_shard",
]


class ShardCorruptError(ValueError):
    """A shard failed structural validation (bad magic/version, truncation)
    or checksum verification. The message always names the offending file —
    the one actionable fact when a corpus of hundreds of shards has one bad
    byte."""

    def __init__(self, path: str | os.PathLike, reason: str):
        self.path = str(path)
        self.reason = reason
        super().__init__(f"corrupt shard {self.path}: {reason}")


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------

def write_shard(path: str | os.PathLike, docs: Iterable[Sequence[int] | np.ndarray]) -> dict:
    """Write one ``.dmlshard`` from an iterable of token sequences.

    Records are stored in iteration order as int32. The write goes through
    a same-directory temp file and ``os.replace`` so a crashed builder never
    leaves a half-written shard behind a valid name. Returns a summary dict
    (``{"file", "records", "tokens"}``) for manifests."""
    path = os.fspath(path)
    arrays = [np.ascontiguousarray(np.asarray(d, np.int32).ravel()) for d in docs]
    offsets = np.zeros(len(arrays) + 1, np.uint64)
    np.cumsum([a.size for a in arrays], out=offsets[1:])
    payload = np.concatenate(arrays) if arrays else np.zeros(0, np.int32)
    index_bytes = offsets.tobytes()
    payload_bytes = payload.tobytes()
    header = _HEADER_STRUCT.pack(
        MAGIC, FORMAT_VERSION, _DTYPE_INT32,
        len(arrays), int(payload.size),
        zlib.crc32(index_bytes), zlib.crc32(payload_bytes),
    )
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(header.ljust(HEADER_SIZE, b"\0"))
        f.write(index_bytes)
        f.write(payload_bytes)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return {"file": os.path.basename(path), "records": len(arrays), "tokens": int(payload.size)}


class CorpusBuilder:
    """Incrementally build a sharded corpus directory.

    ``add()`` buffers documents and rolls a new shard whenever the buffered
    payload reaches ``shard_tokens``; ``finalize()`` flushes the tail and
    writes the ``corpus.json`` manifest. Shard files are named
    ``{prefix}-{index:05d}.dmlshard`` so lexicographic order IS write order
    — the global record order every reader agrees on."""

    def __init__(self, directory: str | os.PathLike, shard_tokens: int = 1 << 22, prefix: str = "corpus"):
        if shard_tokens < 1:
            raise ValueError(f"shard_tokens must be >= 1, got {shard_tokens}")
        self.directory = os.fspath(directory)
        self.shard_tokens = int(shard_tokens)
        self.prefix = prefix
        os.makedirs(self.directory, exist_ok=True)
        self._buf: list[np.ndarray] = []
        self._buf_tokens = 0
        self._shards: list[dict] = []
        self._total_records = 0
        self._total_tokens = 0
        self._finalized = False

    def add(self, doc: Sequence[int] | np.ndarray) -> None:
        if self._finalized:
            raise RuntimeError("CorpusBuilder already finalized")
        a = np.asarray(doc, np.int32).ravel()
        self._buf.append(a)
        self._buf_tokens += int(a.size)
        if self._buf_tokens >= self.shard_tokens:
            self._roll()

    def _roll(self) -> None:
        name = f"{self.prefix}-{len(self._shards):05d}{SHARD_SUFFIX}"
        info = write_shard(os.path.join(self.directory, name), self._buf)
        self._shards.append(info)
        self._total_records += info["records"]
        self._total_tokens += info["tokens"]
        self._buf, self._buf_tokens = [], 0

    def finalize(self) -> dict:
        """Flush the buffered tail shard and write the manifest; returns the
        manifest dict."""
        if self._finalized:
            raise RuntimeError("CorpusBuilder already finalized")
        if self._buf:
            self._roll()
        self._finalized = True
        manifest = {
            "format": "dmlshard",
            "version": FORMAT_VERSION,
            "shards": self._shards,
            "total_records": self._total_records,
            "total_tokens": self._total_tokens,
        }
        tmp = os.path.join(self.directory, f"{MANIFEST_NAME}.tmp.{os.getpid()}")
        with open(tmp, "w") as f:
            json.dump(manifest, f, indent=2)
            f.write("\n")
        os.replace(tmp, os.path.join(self.directory, MANIFEST_NAME))
        return manifest


def build_corpus(
    directory: str | os.PathLike,
    docs: Iterable[Sequence[int] | np.ndarray],
    shard_tokens: int = 1 << 22,
    prefix: str = "corpus",
) -> dict:
    """One-shot :class:`CorpusBuilder`: write every document of ``docs`` and
    return the manifest."""
    builder = CorpusBuilder(directory, shard_tokens=shard_tokens, prefix=prefix)
    for doc in docs:
        builder.add(doc)
    return builder.finalize()


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------

class ShardFile:
    """One memory-mapped ``.dmlshard``.

    Opening validates structure only (magic, version, dtype, exact file
    size) — O(1) regardless of shard size. ``record(i)`` returns a
    read-only int32 view over the mapping: zero copies, zero syscalls; the
    page cache faults pages in on first touch (the :class:`ShardReader`
    producer thread does that touching off the training thread).
    :meth:`verify` streams both CRC32s for corruption that structural
    checks can't see."""

    def __init__(self, path: str | os.PathLike):
        self.path = os.fspath(path)
        try:
            size = os.path.getsize(self.path)
        except OSError as e:
            raise ShardCorruptError(self.path, f"unreadable ({e})") from e
        if size < HEADER_SIZE:
            raise ShardCorruptError(self.path, f"file is {size} bytes, smaller than the {HEADER_SIZE}-byte header")
        with open(self.path, "rb") as f:
            raw = f.read(_HEADER_STRUCT.size)
        magic, version, dtype_code, n, t, crc_idx, crc_pay = _HEADER_STRUCT.unpack(raw)
        if magic != MAGIC:
            raise ShardCorruptError(self.path, f"bad magic {magic!r} (expected {MAGIC!r})")
        if version != FORMAT_VERSION:
            raise ShardCorruptError(self.path, f"unsupported format version {version} (reader supports {FORMAT_VERSION})")
        if dtype_code != _DTYPE_INT32:
            raise ShardCorruptError(self.path, f"unsupported dtype code {dtype_code}")
        expected = HEADER_SIZE + 8 * (n + 1) + 4 * t
        if size != expected:
            raise ShardCorruptError(
                self.path,
                f"truncated or oversized: {size} bytes on disk, header promises {expected} "
                f"({n} record(s), {t} token(s))",
            )
        self.version = int(version)
        self.num_records = int(n)
        self.num_tokens = int(t)
        self._crc_index = crc_idx
        self._crc_payload = crc_pay
        raw_map = np.memmap(self.path, dtype=np.uint8, mode="r")
        idx_end = HEADER_SIZE + 8 * (n + 1)
        self._offsets = raw_map[HEADER_SIZE:idx_end].view(np.uint64)
        self._payload = raw_map[idx_end:].view(np.int32)

    def record(self, i: int) -> np.ndarray:
        """Zero-copy int32 view of record ``i`` (read-only: it aliases the
        mapping)."""
        if not 0 <= i < self.num_records:
            raise IndexError(f"record {i} out of range for shard with {self.num_records} record(s)")
        return self._payload[int(self._offsets[i]) : int(self._offsets[i + 1])]

    def __len__(self) -> int:
        return self.num_records

    def verify(self) -> None:
        """Recompute both CRC32s over the mapping; raises
        :class:`ShardCorruptError` naming this file on mismatch."""
        if zlib.crc32(self._offsets.tobytes()) != self._crc_index:
            raise ShardCorruptError(self.path, "offset-index checksum mismatch")
        if zlib.crc32(self._payload.tobytes()) != self._crc_payload:
            raise ShardCorruptError(self.path, "payload checksum mismatch")

    def __repr__(self):  # pragma: no cover - debugging aid
        return f"ShardFile({self.path!r}, records={self.num_records}, tokens={self.num_tokens})"


class ShardStore:
    """An ordered corpus of ``.dmlshard`` files in one directory.

    Shards sort by filename — the builder's zero-padded numbering makes
    lexicographic order equal write order — and their concatenation defines
    the **global record order**: record ``g`` of the corpus is record
    ``g - base(s)`` of the shard ``s`` that :meth:`locate` maps it to.
    Every elastic-cursor contract in :class:`ShardReader` is stated in this
    order."""

    def __init__(self, directory: str | os.PathLike, *, verify: bool = False):
        self.directory = os.fspath(directory)
        if not os.path.isdir(self.directory):
            raise FileNotFoundError(f"corpus directory not found: {self.directory}")
        names = sorted(n for n in os.listdir(self.directory) if n.endswith(SHARD_SUFFIX))
        if not names:
            raise FileNotFoundError(f"no *{SHARD_SUFFIX} files in {self.directory}")
        self.shards = [ShardFile(os.path.join(self.directory, n)) for n in names]
        if verify:
            self.verify()
        #: global record index where each shard starts, plus the total
        self._starts = np.zeros(len(self.shards) + 1, np.int64)
        np.cumsum([s.num_records for s in self.shards], out=self._starts[1:])

    @property
    def version(self) -> int:
        return self.shards[0].version

    @property
    def total_records(self) -> int:
        return int(self._starts[-1])

    @property
    def total_tokens(self) -> int:
        return sum(s.num_tokens for s in self.shards)

    def locate(self, g: int) -> tuple[int, int]:
        """Map global record index ``g`` to ``(shard_id, record_offset)``.
        ``g == total_records`` maps to ``(num_shards, 0)`` — the
        one-past-the-end cursor a fully-consumed reader checkpoints."""
        if not 0 <= g <= self.total_records:
            raise IndexError(f"global record {g} out of range for {self.total_records} record(s)")
        if g == self.total_records:
            return len(self.shards), 0
        sid = int(np.searchsorted(self._starts, g, side="right")) - 1
        return sid, int(g - self._starts[sid])

    def record(self, g: int) -> np.ndarray:
        sid, off = self.locate(g)
        if sid == len(self.shards):
            raise IndexError(f"global record {g} out of range for {self.total_records} record(s)")
        return self.shards[sid].record(off)

    def verify(self) -> None:
        """Checksum every shard (raises on the first corrupt file)."""
        for s in self.shards:
            s.verify()

    def info(self) -> dict:
        """Summary of the corpus (directory, format version, counts)."""
        return {
            "directory": self.directory,
            "format_version": self.version,
            "shards": len(self.shards),
            "total_records": self.total_records,
            "total_tokens": self.total_tokens,
        }

    def __len__(self) -> int:
        return self.total_records

    def __repr__(self):  # pragma: no cover - debugging aid
        return f"ShardStore({self.directory!r}, shards={len(self.shards)}, records={self.total_records})"


# ---------------------------------------------------------------------------
# async pipeline source
# ---------------------------------------------------------------------------

#: monotone count of read-ahead blocks the producer threads have fetched; the
#: stage samples it per epoch (``misc/shard_reader``) to tell that a
#: ShardReader, not a generic iterable, fed the run
_ACTIVITY = 0
_ACTIVITY_LOCK = threading.Lock()


def _bump_activity() -> None:
    global _ACTIVITY
    with _ACTIVITY_LOCK:
        _ACTIVITY += 1


def reader_activity() -> int:
    """Total read-ahead blocks fetched by all :class:`ShardReader` threads
    since import (monotone; compare two samples to detect activity)."""
    return _ACTIVITY


class ShardReader(DataPipeline):
    """Async double-buffered pipeline source over a :class:`ShardStore`.

    **Assignment.** Rank ``r`` of world ``w`` owns global records
    ``g ≡ r (mod w)`` in shard order — record-strided, so every rank
    consumes in lockstep and the globally-consumed prefix after each rank
    reads ``c`` records is exactly records ``[0, c*w)``. So the pipeline
    cursor (``global_offset = consumed * world_size``) holds literally, and a
    resume on a DIFFERENT world size is pure arithmetic:
    ``divmod(global_offset, new_w)`` — indivisible offsets warn and round
    down exactly like ``MixPipeline``.

    **Read-ahead.** Records are fetched in blocks of ``read_ahead`` on a
    dedicated ``dml-shard-reader`` daemon thread (``_prefetch_iter``) with
    ``buffers`` blocks in flight — double-buffered by default. The producer
    touches one int32 per page of every view it fetches, so cold-disk page
    faults land on the reader thread, not the training thread; the consumer
    then hands out the zero-copy views.

    **Cursor.** ``state_dict()`` extends the pipeline cursor with
    ``kind="shards"`` plus the human-auditable ``shard_id`` /
    ``record_offset`` of the first unconsumed global record;
    ``load_state_dict`` restores by SEEKING (two u64 loads via the offset
    index) instead of the base class's replay-and-discard skip — resume
    cost is O(1) regardless of how deep into the corpus the run died."""

    def __init__(
        self,
        store: "ShardStore | str | os.PathLike",
        *,
        rank: int | None = None,
        world_size: int | None = None,
        buffers: int = 2,
        read_ahead: int = 64,
    ):
        if buffers < 1:
            raise ValueError(f"buffers must be >= 1, got {buffers}")
        if read_ahead < 1:
            raise ValueError(f"read_ahead must be >= 1, got {read_ahead}")
        self.store = store if isinstance(store, ShardStore) else ShardStore(store)
        self._rank = rank
        self._world_size = world_size
        self.buffers = int(buffers)
        self.read_ahead = int(read_ahead)
        #: records the CURRENT pass resumed past (set by the iterator from
        #: the one-shot resume payload, mirroring MixPipeline's bases)
        self._consumed_base = 0
        self._shard_resume: int | None = None
        super().__init__(self._shard_iter, self._assigned)

    def _rank_world(self) -> tuple[int, int]:
        # resolved at call time, not construction: an elastic resume changes
        # the world size under the same reader object
        r = runtime.rank() if self._rank is None else self._rank
        w = runtime.world_size() if self._world_size is None else self._world_size
        return r, w

    def _assigned(self) -> int:
        """Records assigned to this rank: |{g < N : g mod w == r}|."""
        r, w = self._rank_world()
        n = self.store.total_records
        return max(0, (n - r + w - 1) // w)

    def _shard_iter(self, epoch) -> Iterator[np.ndarray]:
        resume = self._shard_resume
        self._shard_resume = None
        base = 0 if resume is None else int(resume)
        self._consumed_base = base
        r, w = self._rank_world()
        store = self.store
        n = store.total_records

        def blocks() -> Iterator[list[np.ndarray]]:
            g = r + base * w
            while g < n:
                block = []
                for _ in range(self.read_ahead):
                    if g >= n:
                        break
                    block.append(store.record(g))
                    g += w
                # fault every page of the block on THIS (producer) thread —
                # one int32 per 4 KiB page — so disk latency never reaches
                # the consumer
                for v in block:
                    if v.size:
                        int(v[::1024].sum())
                _bump_activity()
                yield block

        for block in _prefetch_iter(blocks(), self.buffers, name="dml-shard-reader"):
            yield from block

    # -- resumable iteration state -----------------------------------------
    def _live_state(self) -> dict:
        """The pipeline cursor plus the disk location it denotes: global record
        offset (world-size-independent), and the ``(shard_id,
        record_offset)`` of the first unconsumed record —
        ``(num_shards, 0)`` once the corpus is fully consumed."""
        ws = self._rank_world()[1]
        consumed = self._consumed_base + self._consumed
        g = min(consumed * ws, self.store.total_records)
        sid, off = self.store.locate(g)
        return {
            "v": 1,
            "kind": "shards",
            "epoch": self.epoch,
            "global_offset": consumed * ws,
            "world_size": ws,
            "shard_id": sid,
            "record_offset": off,
        }

    def load_state_dict(self, state: dict) -> None:
        """Restore a shard cursor by seeking (no replay). A plain (non-
        shard) v1 state degrades to the base class's replay skip. An offset
        not divisible by the new world size warns and rounds down, exactly
        the MixPipeline contract."""
        if not (isinstance(state, dict) and state.get("kind") == "shards"):
            super().load_state_dict(state)
            return
        if state.get("v") != 1:
            raise ValueError(f"unrecognised ShardReader state: {state!r}")
        if state.get("epoch") is not None:
            self.set_epoch(int(state["epoch"]))
        ws = self._rank_world()[1]
        skip, rem = divmod(int(state["global_offset"]), ws)
        if rem:
            import logging

            logging.getLogger("dmlcloud_tpu_torch").warning(
                "ShardReader resume: global offset %d is not divisible by the new "
                "world size %d; rounding down (up to %d record(s) replay)",
                state["global_offset"], ws, ws - 1,
            )
        self._pending_skip = 0  # the iterator seeks; nothing to replay
        self._shard_resume = skip
