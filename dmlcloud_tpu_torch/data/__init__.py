from .datasets import pack_sequences
from .device import device_iterator
from .synthetic import markov_tokens

__all__ = ["device_iterator", "markov_tokens", "pack_sequences"]
