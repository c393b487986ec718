"""``step_flops()`` -> ``misc/mfu`` in the port, on the CPU.

The counterpart of ``tests/test_mfu_metric.py`` (tracked per epoch against a
patched peak entry, by the reference's formula; skipped with one warning on a
device without a peak; absent when disabled), plus the H100 rows of the peak
table and the LM example's ``step_flops`` against the JAX example's.
"""

import importlib.util
import logging
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dmlcloud_tpu_torch as tdml
from dmlcloud_tpu.models import transformer as jtr
from dmlcloud_tpu.utils.config import as_config as j_as_config
from dmlcloud_tpu_torch.examples import train_lm as t_example
from dmlcloud_tpu_torch.models import transformer as ttr
from dmlcloud_tpu_torch.train_state import TrainState
from dmlcloud_tpu_torch.utils import profiling
from dmlcloud_tpu_torch.utils.config import as_config as t_as_config

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent


class _FlopsStage(tdml.TrainValStage):
    def step_flops(self):
        return 1.0e9

    def pre_stage(self):
        model = torch.nn.Linear(4, 1, bias=False)
        self.pipeline.register_model("lin", model, verbose=False)
        self.pipeline.register_optimizer("sgd", lambda params: torch.optim.SGD(params, lr=0.1))
        x = np.ones((16, 4), np.float32)
        self.pipeline.register_dataset("train", [{"x": x, "y": x.sum(1, keepdims=True)}] * 4, verbose=False)

    def step(self, state, batch):
        return torch.mean((state.model(batch["x"]) - batch["y"]) ** 2)

    def val_epoch(self):
        pass


def _run(stage, epochs):
    pipe = tdml.TrainingPipeline(name="mfu-test", device="cpu")
    pipe.append_stage(stage, max_epochs=epochs)
    pipe.run()
    return pipe


def test_mfu_tracked_per_epoch(monkeypatch):
    # give the CPU an entry, so that the metric is tracked here as on a card
    monkeypatch.setitem(profiling.PEAK_BF16_FLOPS, "cpu", 197e12)
    stage = _FlopsStage()
    _run(stage, 2)
    hist = stage.tracker["misc/mfu"]
    assert len(hist) == 2 and all(v is not None and v > 0 for v in hist)
    # mfu == flops per step / step time / total peak
    step_ms = stage.tracker["misc/train_step_avg_ms"][-1]
    peak_total = profiling.chip_peak_flops("cpu") * tdml.parallel.runtime.world_size()
    np.testing.assert_allclose(hist[-1], 1.0e9 / (step_ms / 1e3) / peak_total, rtol=1e-6)


def test_mfu_skipped_with_one_warning_on_a_device_without_a_peak(caplog):
    assert profiling.peak_flops_for_kind(profiling.device_kind("cpu")) is None
    stage = _FlopsStage()
    with caplog.at_level(logging.WARNING, logger="dmlcloud_tpu_torch"):
        _run(stage, 2)
    assert "misc/mfu" not in stage.tracker
    assert stage.tracker["misc/train_step_avg_ms"]  # step timing is still tracked
    warnings = [r for r in caplog.records if "peak table" in r.getMessage()]
    assert len(warnings) == 1, [r.getMessage() for r in warnings]


def test_mfu_absent_when_disabled(monkeypatch):
    monkeypatch.setitem(profiling.PEAK_BF16_FLOPS, "cpu", 197e12)

    class Off(_FlopsStage):
        def step_flops(self):
            return 0.0

    stage = Off()
    _run(stage, 1)
    assert "misc/mfu" not in stage.tracker


@pytest.mark.parametrize(
    "name, peak",
    [
        ("NVIDIA H100 80GB HBM3", 989.4e12),
        ("NVIDIA H100 PCIe", 756e12),
        ("NVIDIA H100 NVL", 835e12),
        ("nvidia h100 nvl", 835e12),
        ("NVIDIA A100-SXM4-80GB", None),
        ("cpu", None),
    ],
)
def test_h100_peak_table(name, peak):
    assert profiling.peak_flops_for_kind(name) == peak


def _jax_example():
    spec = importlib.util.spec_from_file_location("jax_train_lm_example", REPO / "examples" / "train_lm.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("preset", ["tiny", "small"])
def test_step_flops_of_the_example_equals_the_jax_examples(preset):
    cfg = {"preset": preset, "batch_size": 4, "seq_len": 64, "vocab_size": 512, "mfu": True}
    kw = dict(vocab_size=512, max_seq_len=64, **t_example.PRESETS[preset])

    jex = _jax_example()
    jstage = jex.LMStage()
    jstage.pipeline = SimpleNamespace(config=j_as_config(cfg))
    jmodel = jtr.DecoderLM(jtr.TransformerConfig(**kw))
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    jstage.state = SimpleNamespace(params=shapes)

    tstage = t_example.LMStage()
    tstage.pipeline = SimpleNamespace(config=t_as_config(cfg))
    tstage.state = TrainState(model=ttr.DecoderLM(ttr.TransformerConfig(**kw), device="cpu"), optimizer=None)

    want = jstage.step_flops()
    assert want > 0 and tstage.step_flops() == want
    tstage.pipeline.config.mfu = False
    assert tstage.step_flops() == 0.0
