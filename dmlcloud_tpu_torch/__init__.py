"""dmlcloud_tpu_torch — the PyTorch/CUDA port of dmlcloud_tpu.

The JAX package ``dmlcloud_tpu`` stays the reference; this package mirrors its
module paths (``models/transformer.py``, ``ops/flash_attention.py``,
``stage.py``, ...) in PyTorch and imports nothing of it. Attention runs in
hand-written CUDA kernels for Hopper (``csrc/flash_attention.cu``), built with
nvcc at first use. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``.
"""

from . import compile, data, lint, metrics, optim, parallel, telemetry, utils
from .checkpoint import CheckpointDir, find_slurm_checkpoint, generate_checkpoint_path
from .metrics import MetricReducer, MetricTracker, Reduction
from .pipeline import TrainingPipeline
from .stage import DatasetNotFoundError, Stage, TrainValStage
from .train_state import TrainState

#: the reference package's version, which this port follows
__version__ = "0.5.0"

__all__ = [
    "__version__",
    "compile",
    "data",
    "lint",
    "metrics",
    "optim",
    "parallel",
    "telemetry",
    "utils",
    "CheckpointDir",
    "find_slurm_checkpoint",
    "generate_checkpoint_path",
    "MetricReducer",
    "MetricTracker",
    "Reduction",
    "TrainingPipeline",
    "DatasetNotFoundError",
    "Stage",
    "TrainValStage",
    "TrainState",
]
