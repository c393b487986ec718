"""Native (C++) host code, loaded with ctypes, with Python fallbacks.

The port's own copy of ``dmlcloud_tpu/native``: the same two C++ sources
(``interleave.cpp``, ``pack.cpp``) and the same Python signatures, built at
first use by ``_lib`` with ``g++`` into ``native/build/``:

- ``interleave``: the strided-memcpy batch interleave, the inner loop of
  ``data.interleave_batches``, across a thread pool;
- ``pack``: the greedy sequence packer (``pack_flat``,
  ``pack_sequences_fast``), bit-identical to ``data.pack_sequences``, in one
  memcpy pass over a flattened corpus.

Every entry point falls back to Python/numpy when the library cannot be
built, as the reference's does without its library.
"""

from . import interleave, pack

__all__ = ["interleave", "pack"]
