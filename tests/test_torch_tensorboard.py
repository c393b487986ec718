"""The port's metric sinks on the CPU: TensorBoard event files and wandb.

The counterpart of ``tests/test_tensorboard.py``: per-epoch tracker scalars
land in event files that TensorBoard's own reader parses back. Beside it:
``enable_wandb`` raises ``ImportError`` where ``wandb`` is missing, as the
reference's does, and the copied ``EnumAction``.
"""

import argparse
import sys

import numpy as np
import pytest
import torch

import dmlcloud_tpu_torch as tdml
from dmlcloud_tpu_torch.metrics import Reduction
from dmlcloud_tpu_torch.utils.argparse_ext import EnumAction
from dmlcloud_tpu_torch.utils.tensorboard import tensorboard_available

torch.set_num_threads(2)


def _reader_available() -> bool:
    try:
        from tensorboard.backend.event_processing import event_accumulator  # noqa: F401

        return True
    except ImportError:
        return False


needs_tensorboard = pytest.mark.skipif(
    not (tensorboard_available() and _reader_available()),
    reason="tensorboardX (writer) or tensorboard (test reader) not installed",
)


class _TinyStage(tdml.TrainValStage):
    def pre_stage(self):
        self.pipeline.register_model("lin", torch.nn.Linear(4, 1, bias=False), verbose=False)
        self.pipeline.register_optimizer("sgd", lambda params: torch.optim.SGD(params, lr=0.1))
        rng = np.random.RandomState(0)
        xs = rng.randn(4, 16, 4).astype(np.float32)
        self.pipeline.register_dataset("train", [{"x": x, "y": x.sum(1, keepdims=True)} for x in xs], verbose=False)

    def step(self, state, batch):
        return torch.mean((state.model(batch["x"]) - batch["y"]) ** 2)

    def val_epoch(self):
        pass


def _read_scalars(logdir):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    acc = EventAccumulator(str(logdir))
    acc.Reload()
    return {tag: [(e.step, e.value) for e in acc.Scalars(tag)] for tag in acc.Tags()["scalars"]}


@needs_tensorboard
def test_scalars_written_per_epoch(tmp_path):
    pipe = tdml.TrainingPipeline(name="tb-test", device="cpu")
    pipe.enable_tensorboard(str(tmp_path / "tb"))
    pipe.append_stage(_TinyStage(), max_epochs=3)
    pipe.run()
    scalars = _read_scalars(tmp_path / "tb")
    assert "train/loss" in scalars, sorted(scalars)
    assert [s for s, _ in scalars["train/loss"]] == [1, 2, 3]
    # the values are the tracker's reduced per-epoch losses
    hist = [float(v) for v in pipe.stages[0].tracker["train/loss"]]
    np.testing.assert_allclose([v for _, v in scalars["train/loss"]], hist, rtol=1e-6)


@needs_tensorboard
def test_default_logdir_needs_checkpointing():
    pipe = tdml.TrainingPipeline(name="tb-test2", device="cpu")
    pipe.enable_tensorboard()  # default dir: <checkpoint_dir>/tb
    pipe.append_stage(_TinyStage(), max_epochs=1)
    with pytest.raises(ValueError, match="checkpointing"):
        pipe.run()


@needs_tensorboard
def test_default_logdir_under_checkpoint_dir(tmp_path):
    pipe = tdml.TrainingPipeline(name="tb-test3", device="cpu")
    pipe.enable_checkpointing(str(tmp_path), resume=False)
    pipe.enable_tensorboard()
    pipe.append_stage(_TinyStage(), max_epochs=2)
    pipe.run()
    scalars = _read_scalars(pipe.checkpoint_dir.path / "tb")
    assert "train/loss" in scalars and len(scalars["train/loss"]) == 2


def test_enable_wandb_raises_import_error_without_wandb(monkeypatch):
    monkeypatch.setitem(sys.modules, "wandb", None)  # as on a machine without it
    pipe = tdml.TrainingPipeline(name="wandb-test", device="cpu")
    with pytest.raises(ImportError):
        pipe.enable_wandb(project="p")
    assert pipe.wandb is False


def test_enum_action_maps_lowercase_names():
    parser = argparse.ArgumentParser()
    parser.add_argument("--reduction", type=Reduction, action=EnumAction)
    assert parser.parse_args(["--reduction", "sum"]).reduction is Reduction.SUM
    with pytest.raises(SystemExit):
        parser.parse_args(["--reduction", "median"])
    with pytest.raises(TypeError, match="Enum"):
        argparse.ArgumentParser().add_argument("--n", type=int, action=EnumAction)
