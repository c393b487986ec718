"""The port's rank sharding against the JAX package's, on the CPU.

``data/sharding.py`` is a numpy copy: ``shard_indices``,
``chunk_and_shard_indices`` and ``shard_sequence`` must return the JAX
package's indices over a grid of sizes, ranks, world sizes, shuffles,
seeds and overlaps. ``ShardedSequenceDataset`` must yield the reference's
per-rank indices, and length, for epochs 0-2 after ``set_epoch``, sub-shard
across ``DataLoader`` workers (``get_worker_info`` stubbed) like the
reference, and pickle for worker processes.
"""

import pickle

import pytest
import torch

from dmlcloud_tpu.data import datasets as jdatasets
from dmlcloud_tpu.data import sharding as jsharding
from dmlcloud_tpu_torch.data import ShardedSequenceDataset, datasets, sharding

torch.set_num_threads(2)

SIZES = [0, 1, 7, 16, 33]
WORLDS = [1, 2, 3, 4]
SEEDS = [0, 5, 1234]


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("even_shards", [True, False])
@pytest.mark.parametrize("n", SIZES)
def test_shard_indices_and_sequence_match_the_reference(n, shuffle, even_shards):
    seq = [f"x{i}" for i in range(n)]
    for world in WORLDS:
        for rank in range(world):
            for seed in SEEDS:
                args = (rank, world, shuffle, even_shards, seed)
                got = sharding.shard_indices(n, *args)
                assert got == jsharding.shard_indices(n, *args), args
                assert sharding.shard_sequence(seq, *args) == jsharding.shard_sequence(seq, *args), args


@pytest.mark.parametrize("chunk_overlap", [0, 3])
@pytest.mark.parametrize("equal_chunks", [True, False])
@pytest.mark.parametrize("shuffle", [False, True])
def test_chunk_and_shard_indices_match_the_reference(chunk_overlap, equal_chunks, shuffle):
    for n in (0, 10, 37, 100):
        for world in WORLDS:
            for rank in range(world):
                for even_shards in (True, False):
                    for seed in SEEDS:
                        kw = dict(chunk_overlap=chunk_overlap, even_shards=even_shards, equal_chunks=equal_chunks,
                                  shuffle=shuffle, seed=seed)
                        got = sharding.chunk_and_shard_indices(n, 8, rank, world, **kw)
                        assert got == jsharding.chunk_and_shard_indices(n, 8, rank, world, **kw), (n, rank, world, kw)


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("even_shards", [True, False])
def test_sharded_sequence_dataset_matches_the_reference_per_epoch(shuffle, even_shards):
    seq = list(range(37))
    for world in (1, 2, 3):
        for rank in range(world):
            kw = dict(shuffle=shuffle, even_shards=even_shards, seed=3, rank=rank, world_size=world)
            got, want = ShardedSequenceDataset(seq, **kw), jdatasets.ShardedSequenceDataset(seq, **kw)
            assert list(got) == list(want) and len(got) == len(want)  # no set_epoch yet: epoch 0's shard
            for epoch in range(3):
                got.set_epoch(epoch)
                want.set_epoch(epoch)
                assert list(got) == list(want), (kw, epoch)
                assert len(got) == len(want)
    if shuffle:
        ds = ShardedSequenceDataset(seq, shuffle=True, rank=0, world_size=2)
        first = list(ds)
        ds.set_epoch(1)
        assert list(ds) != first, "set_epoch did not reshuffle"


@pytest.mark.parametrize("num_workers", [2, 3])
def test_dataloader_workers_sub_shard_like_the_reference(monkeypatch, num_workers):
    """Each (rank, worker) pair is an effective rank ``rank * workers + id``:
    the grid partitions the data, as in the reference."""

    class Info:
        def __init__(self, wid):
            self.id, self.num_workers = wid, num_workers

    seq = list(range(24))
    seen = []
    for rank in range(2):
        for wid in range(num_workers):
            monkeypatch.setattr(datasets, "get_worker_info", lambda: Info(wid))
            monkeypatch.setattr(jdatasets, "_get_worker_info", lambda: Info(wid))
            kw = dict(shuffle=True, seed=1, rank=rank, world_size=2)
            got = list(ShardedSequenceDataset(seq, **kw))
            assert got == list(jdatasets.ShardedSequenceDataset(seq, **kw))
            assert datasets._effective_rank_world(rank, 2) == (rank * num_workers + wid, 2 * num_workers)
            seen += got
    assert sorted(seen) == seq


def test_pickles_for_dataloader_worker_processes():
    ds = ShardedSequenceDataset(list(range(16)), shuffle=True, rank=1, world_size=2)
    ds.set_epoch(2)
    clone = pickle.loads(pickle.dumps(ds))
    assert clone.epoch == 2 and list(clone) == list(ds) and len(clone) == len(ds)
    assert isinstance(clone, torch.utils.data.IterableDataset)  # a DataLoader iterates it, not indexes it
