"""The port's ``DataPipeline``/``MixPipeline`` against the JAX package's, on the
same numpy inputs made from a seed.

- Every combinator: ``pack`` and ``pack_stream`` (chunked greedy, through the
  native packer on the port's side, and the first-fit-decreasing window),
  ``shuffle`` across epochs, ``batch`` (collated, remainder kept or dropped),
  ``map``, ``interleave`` and ``interleave_batches``/``interleave_dict_batches``
  (arrays, dicts, nested), ``prefetch``, the sources ``from_sequence``/
  ``from_chunked`` and the reference's class names: elements equal bit for
  bit (dtype included) and ``PackStats`` equal.
- ``MixPipeline``: ``_mix_u64`` on 64-bit edge values, the chosen sources, a
  source running out.
- The cursors: ``state_dict`` taken at several cut points equals the
  reference's, and reloaded into a fresh pipeline of either package gives the
  uninterrupted pass's continuation; a mix resume at another world size.
- The port's own consumer-side cursor: ``iter_through`` and ``to_device`` with
  batches in flight count only what the consumer took.
"""

import itertools

import numpy as np
import pytest
import torch

from dmlcloud_tpu.data import datasets as jd
from dmlcloud_tpu.parallel import runtime as jruntime
from dmlcloud_tpu_torch.data import datasets as td
from dmlcloud_tpu_torch.parallel import runtime as truntime

torch.set_num_threads(2)


def _docs(n: int, seed: int = 0, median: float = 24, sigma: float = 0.9, lo: int = 0, hi: int = 200):
    """``n`` lognormal-length int32 documents (some empty when ``lo`` is 0)."""
    rs = np.random.RandomState(seed)
    lengths = np.clip(np.round(rs.lognormal(np.log(median), sigma, n)), lo, hi).astype(np.int64)
    lengths[rs.rand(n) < 0.05] = 0
    return [rs.randint(1, 1000, size=int(k)).astype(np.int32) for k in lengths]


def _eq(got, want):
    """Bit-for-bit equality of nested dicts, lists and tuples of arrays."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want)
        for k in want:
            _eq(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want)
        for a, b in zip(got, want):
            _eq(a, b)
    elif isinstance(want, np.ndarray):
        got = got.numpy() if isinstance(got, torch.Tensor) else got
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


def _both(build):
    """``build(module)`` for both packages' ``datasets`` modules."""
    return build(td), build(jd)


def _stack(rows):
    return {k: np.stack([r[k] for r in rows]) for k in ("tokens", "segment_ids")}


# ---------------------------------------------------------------------------
# packing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("split_long", [True, False])
@pytest.mark.parametrize("chunk_docs,pack_window", [(1, 0), (7, 0), (1024, 0), (0, 4), (0, 64)])
def test_pack_stream_rows_and_stats_match(chunk_docs, pack_window, split_long):
    docs = _docs(300, seed=1)
    stats = {}

    def build(m):
        st = m.PackStats()
        p = m.DataPipeline.from_source(docs).pack_stream(64, max(chunk_docs, 1), split_long=split_long,
                                                         pack_window=pack_window, stats=st)
        stats[m] = st
        return list(p)

    got, want = _both(build)
    _eq(got, want)
    assert stats[td].as_dict() == stats[jd].as_dict()
    assert stats[td].rows == len(want) > 0


def test_pack_stream_took_the_native_packer():
    from dmlcloud_tpu_torch.native import _lib

    _lib.reset_calls()
    list(td.DataPipeline.from_source(_docs(50)).pack_stream(32, 16))
    assert _lib.CALLS["pack"] == 4, _lib.build_error  # ceil(50 / 16) chunks


@pytest.mark.parametrize("split_long", [True, False])
def test_pack_and_pack_sequences_match(split_long):
    docs = _docs(120, seed=2)
    got, want = _both(lambda m: list(m.DataPipeline.from_source(docs).pack(48, split_long=split_long)))
    _eq(got, want)
    _eq(list(td.pack_sequences(docs, 48, split_long=split_long)), want)


# ---------------------------------------------------------------------------
# shuffle, batch, map, prefetch, interleave
# ---------------------------------------------------------------------------

def test_shuffle_batch_map_prefetch_match_across_epochs():
    xs = [np.full(3, i, np.int64) for i in range(37)]

    def build(m):
        p = (m.DataPipeline.from_source(xs).shuffle(8, seed=3).map(lambda a: a * 2).batch(4, collate=np.stack)
             .prefetch(3))
        out = []
        for epoch in (0, 1, 2):
            p.set_epoch(epoch)
            out.append(list(p))
        return out

    got, want = _both(build)
    _eq(got, want)
    assert not all(np.array_equal(a, b) for a, b in zip(want[0][0], want[1][0]))  # reshuffled
    for drop in (True, False):
        got, want = _both(lambda m: list(m.DataPipeline.from_source(xs).batch(5, drop_remainder=drop)))
        _eq(got, want)
        assert len(td.DataPipeline.from_sequence(xs).batch(5, drop_remainder=drop)) == len(want)


@pytest.mark.parametrize("copy", [True, False])
def test_interleave_matches_on_arrays_dicts_and_nests(copy):
    rs = np.random.RandomState(4)
    arrays = [rs.randn(9, 3).astype(np.float32) for _ in range(9)]
    dicts = [{"x": rs.randint(0, 9, (8, 2)).astype(np.int32), "y": rs.randn(8).astype(np.float64)} for _ in range(6)]
    nests = [{"a": (rs.randn(6, 2), [rs.randn(6)]), "b": rs.randint(0, 5, (6, 4))} for _ in range(6)]
    # a non-contiguous leaf takes the numpy path on both sides
    strided = [rs.randn(8, 6)[:, ::2] for _ in range(4)]
    for batches, n in ((arrays, 3), (dicts, 2), (nests, 3), (strided, 4), (arrays, 1)):
        got, want = _both(lambda m: [_copy(b) for b in m.DataPipeline.from_source(batches).interleave(n, copy=copy)])
        _eq(got, want)
    _eq([_copy(b) for b in td.interleave_batches(arrays, 3)], [_copy(b) for b in jd.interleave_batches(arrays, 3)])
    _eq([_copy(b) for b in td.interleave_dict_batches(dicts, 2)],
        [_copy(b) for b in jd.interleave_dict_batches(dicts, 2)])
    with pytest.raises(ValueError, match="divisible"):
        list(td.interleave_batches([np.zeros((5, 2))], 2))


def _copy(tree):
    """A copy of a yielded batch (interleave aliases its buffers)."""
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_copy(v) for v in tree)
    return np.array(tree)


def test_interleave_took_the_native_kernel():
    from dmlcloud_tpu_torch.native import _lib

    _lib.reset_calls()
    list(td.interleave_batches([np.zeros((4, 2), np.float32)] * 4, 2))
    assert _lib.CALLS["interleave"] == 2, _lib.build_error


# ---------------------------------------------------------------------------
# sources and the reference's class names
# ---------------------------------------------------------------------------

class FakeXr:
    """A stand-in for an xarray dataset: ``.isel``, a dim lookup, ``.load``."""

    def __init__(self, data: np.ndarray, dim: str = "time"):
        self.data, self.dim, self.loaded = data, dim, False

    def __getitem__(self, dim):
        assert dim == self.dim
        return self.data

    def isel(self, indexers):
        return FakeXr(self.data[indexers[self.dim]], self.dim)

    def load(self):
        self.loaded = True


@pytest.mark.parametrize("rank,world", [(0, 1), (1, 2), (2, 3)])
def test_sources_and_class_names_match(rank, world):
    seq = list(range(23))
    xr = FakeXr(np.arange(40))
    kw = dict(rank=rank, world_size=world)
    for epoch in (0, 3):
        def build(m):
            out = []
            for p in (m.DataPipeline.from_sequence(seq, shuffle=True, seed=5, **kw),
                      m.DataPipeline.from_sequence(seq, even_shards=False, **kw),
                      m.ShardedSequenceDataset(seq, shuffle=True, seed=2, **kw),
                      m.BatchDataset(m.ShardedSequenceDataset(seq, **kw), 3),
                      m.PrefetchDataset(m.ShardedSequenceDataset(seq, shuffle=True, **kw), 2),
                      m.DownstreamDataset(m.ShardedSequenceDataset(seq, shuffle=True, **kw))):
                p.set_epoch(epoch)
                out.append((list(p), len(p)))
            for p in (m.DataPipeline.from_chunked(xr, "time", 4, chunk_overlap=1, shuffle=True, **kw),
                      m.ShardedXrDataset(xr, "time", 3, shuffle=True, seed=1, load=True, **kw)):
                p.set_epoch(epoch)
                out.append([c.data for c in p])
            out.append([c.data for c in m.sharded_xr_dataset(xr, "time", 5, equal_chunks=False, even_shards=False,
                                                              **kw)])
            return out

        got, want = _both(build)
        _eq(got, want)


# ---------------------------------------------------------------------------
# mixing
# ---------------------------------------------------------------------------

def test_mix_hash_and_choice_match():
    cases = [(0, 0), (1, 2), (2**63 - 1, 5), (2**64 - 1, 2**64 - 2), (12345, 2**40)]
    for seed, step in cases:
        assert td._mix_u64(seed, step) == jd._mix_u64(seed, step)
        assert 0 <= td._mix_u64(seed, step) < 2**64
    weights = [0.5, 2.0, 1.25]
    for step in range(200):
        for alive in ([True] * 3, [True, False, True], [False, False, True]):
            assert td._mix_choice(7, step, weights, alive) == jd._mix_choice(7, step, weights, alive)


def test_mix_matches_with_a_source_running_out():
    a = [np.array([i], np.int64) for i in range(5)]
    b = [np.array([100 + i], np.int64) for i in range(40)]
    c = [np.array([1000 + i], np.int64) for i in range(12)]

    def build(m):
        mix = m.DataPipeline.mix([m.DataPipeline.from_source(s) for s in (a, b, c)], weights=[3.0, 1.0, 2.0], seed=9)
        out = []
        for epoch in (0, 1):
            mix.set_epoch(epoch)
            out.append(list(mix))
        return out, len(mix)

    got, want = _both(build)
    _eq(got, want)
    assert sum(len(e) for e in want[0]) == 2 * 57
    with pytest.raises(ValueError, match="positive"):
        td.DataPipeline.mix([td.DataPipeline.from_source(a)], weights=[0.0])


# ---------------------------------------------------------------------------
# the cursors
# ---------------------------------------------------------------------------

def _chains(m, docs):
    """Pipelines with state along the whole chain: shuffle reservoir, packer
    buffers, interleave windows, a mix's draws."""
    src = m.DataPipeline.from_source(docs)
    return {
        "shuffle-pack-batch": src.shuffle(16, seed=1).pack_stream(40, 9).batch(3, collate=_stack),
        "ffd-interleave": m.DataPipeline.from_source(docs).pack_stream(40, pack_window=8).batch(
            4, collate=_stack).interleave(2),
        "mix": m.DataPipeline.mix([m.DataPipeline.from_source(docs[:60]).shuffle(4, seed=2),
                                   m.DataPipeline.from_source(docs[60:])], weights=[1.0, 2.0], seed=4),
    }


@pytest.mark.parametrize("name", ["shuffle-pack-batch", "ffd-interleave", "mix"])
@pytest.mark.parametrize("cut", [0, 1, 5, 17])
def test_state_dict_at_cut_points_matches_and_resumes_in_both(name, cut):
    docs = _docs(150, seed=6)
    full = [_copy(x) for x in _chains(td, docs)[name]]
    assert len(full) > 17

    states = {}
    for m in (td, jd):
        p = _chains(m, docs)[name]
        p.set_epoch(2)
        it = iter(p)
        head = [_copy(x) for x in itertools.islice(it, cut)]
        states[m] = p.state_dict()
        it.close()
        assert len(head) == cut
    assert states[td] == states[jd]
    assert states[td]["global_offset"] == cut

    want_rest = None
    for m, state in ((td, states[jd]), (jd, states[td])):  # each package resumes the other's state
        p = _chains(m, docs)[name]
        p.load_state_dict(state)
        rest = [_copy(x) for x in p]
        if want_rest is None:
            want_rest = rest
        _eq(rest, want_rest)
    ref = _chains(jd, docs)[name]
    ref.set_epoch(2)
    _eq(want_rest, [_copy(x) for x in ref][cut:])
    _eq(full[:0], [])


@pytest.mark.parametrize("old_ws,new_ws", [(2, 1), (4, 2), (3, 5)])
def test_cursor_resume_on_another_world_size_matches(monkeypatch, old_ws, new_ws):
    docs = _docs(80, seed=7)
    out = {}
    for m, rt in ((td, truntime), (jd, jruntime)):
        monkeypatch.setattr(rt, "world_size", lambda: old_ws)
        p = m.DataPipeline.from_source(docs).pack_stream(32, 5)
        mix = m.DataPipeline.mix([p, m.DataPipeline.from_source(docs[::-1])], seed=1)
        it = iter(mix)
        for _ in range(7):
            next(it)
        state = mix.state_dict()
        it.close()
        monkeypatch.setattr(rt, "world_size", lambda: new_ws)
        fresh = m.DataPipeline.mix([m.DataPipeline.from_source(docs).pack_stream(32, 5),
                                    m.DataPipeline.from_source(docs[::-1])], seed=1)
        fresh.load_state_dict(state)
        out[m] = (state, [_copy(x) for x in fresh], fresh.state_dict())
    assert out[td][0] == out[jd][0]
    _eq(out[td][1], out[jd][1])
    assert out[td][2] == out[jd][2]


def _read_ahead(depth: int):
    """A ``wrap`` for ``iter_through`` that reads ``depth`` elements ahead of
    its consumer, as the device feed does."""
    def wrap(it):
        buf = list(itertools.islice(it, depth))
        for x in it:
            buf.append(x)
            yield buf.pop(0)
        yield from buf
    return wrap


@pytest.mark.parametrize("name", ["shuffle-pack-batch", "mix"])
def test_iter_through_counts_what_the_consumer_took(name):
    docs = _docs(150, seed=8)
    plain = _chains(td, docs)[name]
    want_states = []
    for x in plain:
        want_states.append(plain.state_dict())
    p = _chains(td, docs)[name]
    got_states = []
    for x in p.iter_through(_read_ahead(3)):
        got_states.append(p.state_dict())
    assert got_states == want_states
    # a resume from a state taken mid-pass continues at the consumer's element
    p = _chains(td, docs)[name]
    it = p.iter_through(_read_ahead(2))
    head = [_copy(x) for x in itertools.islice(it, 6)]
    state = p.state_dict()
    it.close()
    fresh = _chains(td, docs)[name]
    fresh.load_state_dict(state)
    _eq(head + [_copy(x) for x in fresh.iter_through(_read_ahead(2))], [_copy(x) for x in _chains(td, docs)[name]])


def test_to_device_feeds_tensors_and_resumes_on_the_host():
    docs = _docs(120, seed=9)
    host = [_copy(b) for b in td.DataPipeline.from_source(docs).pack_stream(32, 8).batch(2, collate=_stack)]
    p = td.DataPipeline.from_source(docs).pack_stream(32, 8).batch(2, collate=_stack).to_device("cpu", prefetch=2)
    assert p.on_device == torch.device("cpu")
    it = iter(p)
    head = list(itertools.islice(it, 4))
    state = p.state_dict()
    it.close()
    assert state == {"v": 1, "epoch": None, "global_offset": 4, "world_size": 1}
    for got, want in zip(head, host):
        assert isinstance(got["tokens"], torch.Tensor)
        _eq(got, want)
    fresh = td.DataPipeline.from_source(docs).pack_stream(32, 8).batch(2, collate=_stack).to_device("cpu")
    fresh.load_state_dict(state)
    _eq(list(fresh), host[4:])
    # rows of a data-parallel coordinate: the rank-th block of each leaf
    _eq(td._take_rows({"a": np.arange(8), "b": (np.arange(16).reshape(8, 2),)}, (1, 4)),
        {"a": np.arange(2, 4), "b": (np.arange(4, 8).reshape(2, 2),)})
