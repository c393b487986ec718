"""dmlcloud_tpu_torch.utils — counterpart of ``dmlcloud_tpu/utils``.

The submodules are bound as the reference binds them, and ``paths`` (run
directories on fsspec URLs) beside them. The reference's ``thirdparty`` probe
is folded into ``logging.ML_MODULES`` (ROADMAP, "By design"); ``Config``,
``as_config`` and ``seed_all`` stay bound at the package level.
"""

from . import argparse_ext, config, git, logging, paths, profiling, project, seed, slurm, table, tcp, wandb
from .config import Config, as_config
from .seed import seed_all

__all__ = [
    "argparse_ext",
    "config",
    "git",
    "logging",
    "paths",
    "profiling",
    "project",
    "seed",
    "slurm",
    "table",
    "tcp",
    "wandb",
    "Config",
    "as_config",
    "seed_all",
]
