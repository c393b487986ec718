"""TensorBoard metrics sink: per-epoch tracker scalars as event files.

Copy of ``dmlcloud_tpu/utils/tensorboard.py``. ``tensorboardX`` is imported
only when a writer is made, so it stays an optional dependency; a
``torch.profiler`` trace exported into the same directory opens beside the
curves of the same run."""

from __future__ import annotations

from typing import Any

__all__ = ["TensorBoardWriter", "tensorboard_available"]


def tensorboard_available() -> bool:
    try:
        import tensorboardX  # noqa: F401

        return True
    except ImportError:
        return False


class TensorBoardWriter:
    """Root-only scalar writer over a tracker's per-epoch histories."""

    def __init__(self, logdir: str):
        from tensorboardX import SummaryWriter  # deferred: optional dependency

        self._writer = SummaryWriter(str(logdir))

    def log_epoch(self, metrics: dict[str, Any], epoch: int) -> None:
        for name, value in metrics.items():
            try:
                self._writer.add_scalar(name, float(value), global_step=epoch)
            except (TypeError, ValueError):
                continue  # a non-scalar tracked value stays in the console table and wandb
        self._writer.flush()

    def close(self) -> None:
        self._writer.close()
