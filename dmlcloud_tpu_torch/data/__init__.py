from .datasets import (
    BatchDataset,
    DataPipeline,
    DownstreamDataset,
    MixPipeline,
    PackStats,
    PrefetchDataset,
    ShardedSequenceDataset,
    ShardedXrDataset,
    interleave_batches,
    interleave_dict_batches,
    pack_sequences,
    sharded_xr_dataset,
)
from .device import device_iterator
from .sharding import chunk_and_shard_indices, shard_indices, shard_sequence
from .store import (
    CorpusBuilder,
    ShardCorruptError,
    ShardFile,
    ShardReader,
    ShardStore,
    build_corpus,
    write_shard,
)
from .synthetic import markov_tokens

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
    "device_iterator",
    "markov_tokens",
    "chunk_and_shard_indices",
    "shard_indices",
    "shard_sequence",
    "CorpusBuilder",
    "ShardCorruptError",
    "ShardFile",
    "ShardReader",
    "ShardStore",
    "build_corpus",
    "write_shard",
]
