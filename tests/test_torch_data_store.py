"""The port's ``.dmlshard`` store and ``ShardReader`` against the JAX package's.

- ``write_shard``/``build_corpus`` from both packages on the same documents
  give byte-identical shard files and equal manifests, and each package's
  ``ShardStore`` reads the other's corpus record for record (zero-copy views).
- ``ShardReader`` at worlds 1, 2 and 4: every rank's records and every cursor
  (``state_dict`` after each cut) equal the reference's; a cursor saved at
  world 4 loads at world 2 in both, each record read exactly once; a plain
  (non-shard) state degrades to the replay skip; the read-ahead thread and
  ``reader_activity``.
- ``ShardReader -> pack_stream`` (greedy and FFD) equals the reference's
  rows and ``PackStats``.
- A flipped payload byte raises ``ShardCorruptError`` naming the file in
  ``verify``; truncation and bad magic raise at open.
"""

import filecmp
import json
import os
import threading

import numpy as np
import pytest
import torch

from dmlcloud_tpu.data import datasets as jd
from dmlcloud_tpu.data import store as js
from dmlcloud_tpu_torch.data import datasets as td
from dmlcloud_tpu_torch.data import store as ts

torch.set_num_threads(2)


def _docs(n=160, seed=0, vocab=512, median=40.0, sigma=0.8, lo=1, hi=300):
    rs = np.random.RandomState(seed)
    lengths = np.clip(np.round(rs.lognormal(np.log(median), sigma, n)), lo, hi).astype(int)
    return [rs.randint(1, vocab, size=int(k)).astype(np.int32) for k in lengths]


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """The same documents written by each package: {module: directory}."""
    docs = _docs()
    out = {}
    for m in (ts, js):
        d = tmp_path_factory.mktemp(m.__name__.split(".")[0])
        manifest = m.build_corpus(d, docs, shard_tokens=1500)
        out[m] = (str(d), manifest)
    return docs, out


def test_files_and_manifests_are_byte_identical(corpora, tmp_path):
    docs, out = corpora
    (td_dir, t_manifest), (jd_dir, j_manifest) = out[ts], out[js]
    assert t_manifest == j_manifest and len(t_manifest["shards"]) > 3
    names = sorted(os.listdir(td_dir))
    assert names == sorted(os.listdir(jd_dir))
    for name in names:
        assert filecmp.cmp(os.path.join(td_dir, name), os.path.join(jd_dir, name), shallow=False), name
    # a single shard, and the empty one
    for docs_, name in ((docs[:7], "a.dmlshard"), ([], "empty.dmlshard")):
        got, want = (tmp_path / side / name for side in ("port", "reference"))
        got.parent.mkdir(exist_ok=True)
        want.parent.mkdir(exist_ok=True)
        assert ts.write_shard(got, docs_) == js.write_shard(want, docs_)
        assert filecmp.cmp(got, want, shallow=False)
    assert json.load(open(os.path.join(td_dir, "corpus.json")))["total_records"] == len(docs)


def test_each_package_reads_the_others_corpus(corpora):
    docs, out = corpora
    for reader_mod, writer_mod in ((ts, js), (js, ts)):
        store = reader_mod.ShardStore(out[writer_mod][0], verify=True)
        assert store.total_records == len(docs) and store.total_tokens == sum(d.size for d in docs)
        for g in (0, 1, len(docs) // 2, len(docs) - 1):
            rec = store.record(g)
            assert rec.dtype == np.int32 and not rec.flags.writeable
            np.testing.assert_array_equal(rec, docs[g])
    t, j = ts.ShardStore(out[js][0]), js.ShardStore(out[ts][0])
    assert t.info()["shards"] == j.info()["shards"]
    for g in range(len(docs) + 1):
        assert t.locate(g) == j.locate(g)


@pytest.mark.parametrize("world", [1, 2, 4])
def test_reader_assignment_and_cursors_match(corpora, world):
    docs, out = corpora
    d = out[ts][0]
    for rank in range(world):
        readers = {m: m.ShardReader(d, rank=rank, world_size=world, read_ahead=5) for m in (ts, js)}
        its = {m: iter(r) for m, r in readers.items()}
        assert len(readers[ts]) == len(readers[js])
        n = 0
        for t_rec, j_rec in zip(its[ts], its[js]):
            np.testing.assert_array_equal(t_rec, j_rec)
            np.testing.assert_array_equal(t_rec, docs[rank + n * world])
            n += 1
            if n % 7 == 0:
                assert readers[ts].state_dict() == readers[js].state_dict()
        assert n == len(readers[js])
        assert readers[ts].state_dict() == readers[js].state_dict()
        assert readers[ts].state_dict()["shard_id"] == len(readers[ts].store.shards)


@pytest.mark.parametrize("old_ws,new_ws,k", [(4, 2, 9), (2, 4, 6), (4, 1, 5), (1, 2, 10)])
def test_elastic_cursor_loads_at_another_world_size(corpora, old_ws, new_ws, k):
    """``k`` records per rank at ``old_ws``, the cursor saved, the rest at
    ``new_ws`` in both packages: the same records, each read exactly once."""
    docs, out = corpora
    d = out[ts][0]
    seen, states = [], {}
    for m in (ts, js):
        readers = [m.ShardReader(d, rank=r, world_size=old_ws) for r in range(old_ws)]
        iters = [iter(r) for r in readers]
        head = [next(it) for _ in range(k) for it in iters]
        states[m] = readers[0].state_dict()
        for it in iters:
            it.close()
        tail = []
        for r in range(new_ws):
            reader = m.ShardReader(d, rank=r, world_size=new_ws)
            reader.load_state_dict(states[m])
            assert reader._shard_resume == k * old_ws // new_ws and reader._pending_skip == 0
            tail.append(list(reader))
        seen.append((head, tail))
    assert states[ts] == states[js]
    assert states[ts]["global_offset"] == k * old_ws
    for a, b in zip(seen[0][0] + sum(seen[0][1], []), seen[1][0] + sum(seen[1][1], [])):
        np.testing.assert_array_equal(a, b)
    got = sorted(r.tobytes() for r in seen[0][0] + sum(seen[0][1], []))
    assert got == sorted(doc.tobytes() for doc in docs)


def test_plain_state_replays_and_indivisible_rounds_down(corpora, caplog):
    docs, out = corpora
    d = out[ts][0]
    for m in (ts, js):
        reader = m.ShardReader(d, rank=0, world_size=1)
        reader.load_state_dict({"v": 1, "epoch": None, "global_offset": 5, "world_size": 1})
        got = list(reader)
        assert len(got) == len(docs) - 5 and np.array_equal(got[0], docs[5])
    reader = ts.ShardReader(d, rank=0, world_size=3)
    with caplog.at_level("WARNING", logger="dmlcloud_tpu_torch"):
        reader.load_state_dict({"v": 1, "kind": "shards", "epoch": None, "global_offset": 7, "world_size": 7,
                                "shard_id": 0, "record_offset": 7})
    assert reader._shard_resume == 2 and any("not divisible" in r.message for r in caplog.records)


def test_reader_thread_and_activity(corpora):
    _, out = corpora
    before = ts.reader_activity()
    it = iter(ts.ShardReader(out[ts][0], rank=0, world_size=1, read_ahead=8))
    next(it)
    assert ts.reader_activity() > before
    assert any(t.name == "dml-shard-reader" for t in threading.enumerate())
    it.close()
    with pytest.raises(ValueError):
        ts.ShardReader(out[ts][0], buffers=0)


@pytest.mark.parametrize("pack_window", [0, 16])
def test_reader_through_pack_stream_matches(corpora, pack_window):
    _, out = corpora
    d = out[ts][0]
    stats = {ts: td.PackStats(), js: jd.PackStats()}
    rows = {m: list(m.ShardReader(d, rank=1, world_size=2).pack_stream(128, 11, pack_window=pack_window,
                                                                       stats=stats[m])) for m in (ts, js)}
    assert len(rows[ts]) == len(rows[js]) > 0
    for a, b in zip(rows[ts], rows[js]):
        for key in ("tokens", "segment_ids"):
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])
    assert stats[ts].as_dict() == stats[js].as_dict()


def test_a_flipped_byte_is_named_by_verify(corpora, tmp_path):
    _, out = corpora
    d = out[ts][0]
    name = sorted(n for n in os.listdir(d) if n.endswith(".dmlshard"))[1]
    path = tmp_path / "bad-00000.dmlshard"
    path.write_bytes(open(os.path.join(d, name), "rb").read())
    size = path.stat().st_size
    with open(path, "r+b") as f:
        f.seek(size - 3)
        byte = f.read(1)
        f.seek(size - 3)
        f.write(bytes([byte[0] ^ 0xA5]))
    shard = ts.ShardFile(path)  # structurally valid: opening succeeds
    with pytest.raises(ts.ShardCorruptError, match="bad-00000.dmlshard") as exc:
        shard.verify()
    assert "payload checksum" in str(exc.value)
    with pytest.raises(js.ShardCorruptError, match="payload checksum"):
        js.ShardFile(path).verify()
    trunc = tmp_path / "trunc.dmlshard"
    trunc.write_bytes(path.read_bytes()[:-4])
    with pytest.raises(ts.ShardCorruptError, match="truncated"):
        ts.ShardFile(trunc)
    magic = tmp_path / "magic.dmlshard"
    magic.write_bytes(b"XXXXXXXX" + path.read_bytes()[8:])
    with pytest.raises(ts.ShardCorruptError, match="bad magic"):
        ts.ShardFile(magic)
