"""The port's native host library (``native/pack.cpp``, ``interleave.cpp``),
built with ``g++`` into a temporary directory, against the JAX package's
Python ``pack_sequences`` and ``interleave_batches``, bit for bit.

- ``pack_flat``/``pack_sequences_fast`` on a lognormal corpus with empty and
  over-long documents, ``split_long`` on and off, several row lengths; the
  argument checks; an empty corpus.
- ``interleave_into`` through ``interleave_batches`` on several dtypes and
  shapes, one above the 1 MiB at which the kernel starts its threads.
- Three processes building into one empty directory at once all load the
  same library (the compiler's output is moved into place by ``os.replace``).
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from dmlcloud_tpu.data import datasets as jd
from dmlcloud_tpu_torch.data import datasets as td
from dmlcloud_tpu_torch.native import _lib, interleave, pack

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """The library built afresh into a temporary directory."""
    build_dir = tmp_path_factory.mktemp("native")
    _lib.reset(build_dir)
    try:
        assert pack.available() and interleave.available(), _lib.build_error
        path = _lib.loaded_path()
        assert path.parent == build_dir and path.is_file()
        yield path
    finally:
        _lib.reset()


def _docs(n: int, seed: int):
    rs = np.random.RandomState(seed)
    lengths = np.clip(np.round(rs.lognormal(np.log(30), 1.0, n)), 0, 400).astype(np.int64)
    lengths[rs.rand(n) < 0.05] = 0
    return [rs.randint(1, 32000, size=int(k)).astype(np.int32) for k in lengths]


@pytest.mark.parametrize("seq_len", [1, 17, 64, 256])
@pytest.mark.parametrize("split_long", [True, False])
def test_pack_matches_the_reference_packer(built, seq_len, split_long):
    docs = _docs(400, seed=seq_len)
    want = list(jd.pack_sequences(docs, seq_len, split_long=split_long))
    _lib.reset_calls()
    got = pack.pack_sequences_fast(docs, seq_len, split_long=split_long)
    lengths = np.array([d.size for d in docs], np.int64)
    tokens, segs = pack.pack_flat(np.concatenate(docs), lengths, seq_len, split_long=split_long)
    assert _lib.CALLS["pack"] == 2
    assert len(got) == len(want) == len(tokens)
    for i, row in enumerate(want):
        for key, flat in (("tokens", tokens), ("segment_ids", segs)):
            assert got[i][key].dtype == row[key].dtype == flat.dtype == np.int32
            np.testing.assert_array_equal(got[i][key], row[key])
            np.testing.assert_array_equal(flat[i], row[key])


def test_pack_checks_its_arguments_and_takes_an_empty_corpus(built):
    with pytest.raises(ValueError, match="sum to"):
        pack.pack_flat(np.zeros(5, np.int32), np.array([2, 2]), 8)
    with pytest.raises(ValueError, match="non-negative"):
        pack.pack_flat(np.zeros(2, np.int32), np.array([3, -1]), 8)
    with pytest.raises(ValueError, match="seq_len"):
        pack.pack_flat(np.zeros(2, np.int32), np.array([2]), 0)
    tokens, segs = pack.pack_flat(np.zeros(0, np.int32), np.zeros(0, np.int64), 8)
    assert tokens.shape == segs.shape == (0, 8)
    assert pack.pack_sequences_fast([], 8) == list(jd.pack_sequences([], 8)) == []


@pytest.mark.parametrize("shape,dtype,n", [((8,), np.int32, 2), ((12, 5), np.float32, 3), ((4, 3, 2), np.int64, 4),
                                           ((64, 2048), np.float64, 2)])
def test_interleave_matches_the_reference(built, shape, dtype, n):
    rs = np.random.RandomState(n)
    batches = [(rs.randn(*shape) * 100).astype(dtype) for _ in range(2 * n)]
    want = [np.array(b) for b in jd.interleave_batches(batches, n)]
    _lib.reset_calls()
    got = [np.array(b) for b in td.interleave_batches(batches, n)]
    assert _lib.CALLS["interleave"] == 2  # two windows of n batches, one leaf each
    assert len(got) == len(want) == 2 * n
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


_BUILD = textwrap.dedent(
    """
    import sys
    from dmlcloud_tpu_torch.native import _lib, pack
    _lib.reset(sys.argv[1])
    assert pack.available(), _lib.build_error
    print(_lib.loaded_path())
    """
)


def test_concurrent_builds_into_one_directory(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, str(tmp_path)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(3)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1][-2000:] for o in outs]
    paths = {o[0].strip() for o in outs}
    assert len(paths) == 1 and Path(paths.pop()).is_file()
    assert [p.name for p in tmp_path.iterdir()] == [_lib.lib_path().name]
