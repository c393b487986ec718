from .datasets import DataPipeline, ShardedSequenceDataset, pack_sequences
from .device import device_iterator
from .synthetic import markov_tokens

__all__ = ["DataPipeline", "ShardedSequenceDataset", "device_iterator", "markov_tokens", "pack_sequences"]
