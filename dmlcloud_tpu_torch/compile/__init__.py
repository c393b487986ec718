"""dmlcloud_tpu_torch.compile — the compiled step and its cold start.

Counterpart of ``dmlcloud_tpu/compile/``. Three parts, composable but
independent:

- :mod:`.cache` — Inductor's persistent caches (FX graphs, AOTAutograd, Triton
  kernels) in one directory, with stats: compile once per *cluster*, not once
  per process (``TrainingPipeline(compile_cache=...)``,
  ``$DMLCLOUD_COMPILE_CACHE_DIR``).
- :mod:`.aot` — the step under ``torch.compile(fullgraph=True,
  dynamic=False)``, warmed against the batch spec in a timed ``precompile``
  phase before the data loop (``misc/compile_ms``), so shape mismatches
  error at stage start instead of step 1 (``TrainingPipeline(precompile=True)``
  / ``Stage.precompile()``).
- :mod:`.buckets` — shape bucketing for ragged batches: pad to a small fixed
  bucket set with a zero-weight ``sample_mask``, so the compiled-signature
  count is bounded by ``len(buckets)`` and ``misc/recompiles`` stays 0
  (``TrainingPipeline(buckets=(...,))`` / ``Stage.buckets()``).
"""

from .aot import (
    PrecompiledStep,
    abstract_spec,
    global_batch_spec,
    signature_of,
    validate_global_batch_spec,
)
from .buckets import (
    DEFAULT_MASK_KEY,
    bucket_for,
    bucket_iterator,
    bucket_spec,
    masked_mean,
    masked_sum,
    pad_to_bucket,
    resolve_buckets,
)
from .cache import cache_stats, configure_cache, configured_cache_dir, resolve_cache_dir

__all__ = [
    "PrecompiledStep",
    "abstract_spec",
    "global_batch_spec",
    "signature_of",
    "validate_global_batch_spec",
    "DEFAULT_MASK_KEY",
    "bucket_for",
    "bucket_iterator",
    "bucket_spec",
    "masked_mean",
    "masked_sum",
    "pad_to_bucket",
    "resolve_buckets",
    "cache_stats",
    "configure_cache",
    "configured_cache_dir",
    "resolve_cache_dir",
]
