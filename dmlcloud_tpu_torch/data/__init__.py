from .datasets import pack_sequences
from .synthetic import markov_tokens

__all__ = ["markov_tokens", "pack_sequences"]
