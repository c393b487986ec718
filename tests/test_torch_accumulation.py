"""Gradient accumulation in the port's TrainValStage, on the CPU.

The counterpart of ``tests/test_accumulation.py``: an accumulated step equals
the full-batch step, in-place buffers see the microbatches in order, an
indivisible batch raises. Beside it: the tiny ``DecoderLM`` with
``gradient_accumulation() = 2`` against the JAX package's stage with the same
setting on weights carried by the bridge, the fp32 accumulator of a bf16
parameter, the step contract's 3-tuple, and a mid-epoch resume with
accumulation.
"""

import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import dmlcloud_tpu as jdml
import dmlcloud_tpu_torch as tdml
from dmlcloud_tpu.models import transformer as jtr
from dmlcloud_tpu.parallel import mesh as jmesh
from dmlcloud_tpu_torch import optim as toptim
from dmlcloud_tpu_torch.data import device as tdevice
from dmlcloud_tpu_torch.data import markov_tokens
from dmlcloud_tpu_torch.examples import train_lm
from dmlcloud_tpu_torch.models import transformer as ttr
from dmlcloud_tpu_torch.train_state import TrainState

torch.set_num_threads(2)


def _sgd(lr):
    return lambda params: torch.optim.SGD(params, lr=lr)


class _LinearStage(tdml.TrainValStage):
    def __init__(self, accum, batches=None):
        super().__init__()
        self._accum = accum
        self._batches = batches

    def pre_stage(self):
        rng = np.random.RandomState(0)
        xs = rng.randn(16, 10).astype(np.float32)
        ys = (xs @ rng.randn(10, 1)).astype(np.float32)
        data = self._batches if self._batches is not None else [{"x": xs, "y": ys}]
        self.pipeline.register_dataset("train", data, verbose=False)
        model = torch.nn.Linear(10, 1)
        torch.nn.init.zeros_(model.weight)
        torch.nn.init.zeros_(model.bias)
        self.pipeline.register_model("linear", model, verbose=False)
        self.pipeline.register_optimizer("sgd", _sgd(0.05))

    def gradient_accumulation(self):
        return self._accum

    def step(self, state, batch):
        pred = state.model(batch["x"])
        loss = torch.mean((pred - batch["y"]) ** 2)
        # a real metrics dict, so the fp32 metric sums are exercised
        return loss, {"mae": torch.mean(torch.abs(pred - batch["y"]))}

    def val_epoch(self):
        pass


def _run_linear(accum, batches=None):
    pipeline = tdml.TrainingPipeline({"seed": 0}, name=f"accum{accum}", device="cpu")
    stage = _LinearStage(accum, batches)
    pipeline.append_stage(stage, max_epochs=1)
    pipeline.run()
    return stage


def test_accumulated_step_matches_full_batch():
    full = _run_linear(1)
    acc = _run_linear(4)
    for name, p in acc.state.model.named_parameters():
        want = dict(full.state.model.named_parameters())[name]
        np.testing.assert_allclose(p.detach().numpy(), want.detach().numpy(), rtol=1e-5, err_msg=name)
    # mean over microbatch means == full-batch mean for MSE
    tf, ta = full.pipeline.tracker, acc.pipeline.tracker
    assert abs(float(ta["train/loss"][0]) - float(tf["train/loss"][0])) < 1e-5
    assert abs(float(ta["train/mae"][0]) - float(tf["train/mae"][0])) < 1e-5
    # one optimizer step, counted once
    assert acc.state.step == 1 and float(ta["misc/total_train_batches"][0]) == 1


def test_accumulation_rejects_indivisible_batch():
    with pytest.raises(ValueError, match="must divide"):
        _run_linear(3)


class _Recorder(torch.nn.Module):
    """Multiplies by ``w``; an in-place buffer keeps the largest input seen so
    far, and every forward records its microbatch's first element."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.ones(()))
        self.register_buffer("seen", torch.zeros(()))
        self.calls: list[float] = []

    def forward(self, x):
        self.calls.append(float(x[0, 0]))
        self.seen.copy_(torch.maximum(self.seen, x.max()))
        return x * self.w


def test_in_place_buffers_see_the_microbatches_in_order():
    class BufferStage(tdml.TrainValStage):
        def pre_stage(self):
            xs = np.arange(8, dtype=np.float32).reshape(8, 1)
            self.pipeline.register_dataset("train", [{"x": xs}], verbose=False)
            self.pipeline.register_model("m", _Recorder(), verbose=False)
            self.pipeline.register_optimizer("sgd", _sgd(0.0))

        def gradient_accumulation(self):
            return 4

        def step(self, state, batch):
            return torch.mean(state.model(batch["x"]) ** 2)

        def val_epoch(self):
            pass

    pipeline = tdml.TrainingPipeline(name="accum-buffers", device="cpu")
    stage = BufferStage()
    pipeline.append_stage(stage, max_epochs=1)
    pipeline.run()
    model = stage.state.model
    assert model.calls == [0.0, 2.0, 4.0, 6.0]  # the four microbatches, in order
    # the buffer carried across all four: the global max, not the last slice's
    assert float(model.seen) == 7.0


def test_bf16_parameters_accumulate_in_fp32():
    torch.manual_seed(0)
    model = torch.nn.Linear(64, 32, bias=False).to(torch.bfloat16)
    x = torch.randn(8, 64).to(torch.bfloat16)
    target = torch.randn(8, 32).to(torch.bfloat16)

    def loss_of(mb):
        return torch.mean((model(mb["x"]).float() - mb["t"].float()) ** 2)

    # each microbatch's gradient on its own, as autograd gives it (bf16)
    micro = []
    for i in range(4):
        model.zero_grad(set_to_none=True)
        loss_of({"x": x[2 * i : 2 * i + 2], "t": target[2 * i : 2 * i + 2]}).backward()
        micro.append(model.weight.grad.clone())
    want = (sum(g.float() for g in micro) / 4).to(torch.bfloat16)  # the reference's f32 accumulators
    naive = micro[0]
    for g in micro[1:]:
        naive = naive + g  # summed in bf16
    naive = naive / 4
    assert not torch.equal(naive, want), "the data must tell the two summations apart"

    class Stage(tdml.TrainValStage):
        def step(self, state, batch):
            return loss_of(batch)

    stage = Stage()
    stage.state = TrainState(model=model, optimizer=None)
    model.zero_grad(set_to_none=True)
    stage._backward({"x": x, "t": target}, 4)
    assert model.weight.grad.dtype == torch.bfloat16
    assert torch.equal(model.weight.grad, want)


def test_a_3_tuple_step_names_the_in_place_buffers():
    class Stage(tdml.TrainValStage):
        def step(self, state, batch):
            return torch.zeros(()), {}, {"aux": 1}

    with pytest.raises(TypeError, match="in-place buffers"):
        Stage()._unpack(Stage().step(None, None))


# ---------------------------------------------------------------------------
# the tiny DecoderLM against the JAX package, both with 2 microbatches
# ---------------------------------------------------------------------------

TINY = dict(vocab_size=256, num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16, hidden_dim=64, mlp_dim=160,
            max_seq_len=32)
STEPS, BATCH, SEQ = 2, 4, 32
SCHEDULE = (0.0, 0.05, 1, 100)  # step 1 at lr 0, step 2 at the peak


def _lm_batches():
    tokens = markov_tokens(TINY["vocab_size"], STEPS * BATCH, SEQ, seed=5)
    return [tokens[i * BATCH : (i + 1) * BATCH] for i in range(STEPS)]


def _jax_run(tree, model):
    class Stage(jdml.TrainValStage):
        def pre_stage(self):
            self.pipeline.register_model("lm", model, params=tree, verbose=False)
            schedule = optax.warmup_cosine_decay_schedule(*SCHEDULE)
            self.pipeline.register_optimizer("adamw", optax.adamw(schedule), scheduler=schedule)
            self.pipeline.register_dataset("train", _lm_batches(), verbose=False)

        def gradient_clip(self):
            return 1.0

        def gradient_accumulation(self):
            return 2

        def step(self, state, batch):
            return jtr.lm_loss(state.apply_fn({"params": state.params}, batch), batch)

        def _build_train_step(self):
            jitted = super()._build_train_step()

            def recorded(state, batch):
                state, metrics = jitted(state, batch)
                self.step_losses.append(float(metrics["loss"]))
                return state, metrics

            return recorded

    pipeline = jdml.TrainingPipeline({"seed": 0}, name="jax-accum")
    pipeline.set_mesh(jmesh.create_mesh({"data": 1}, devices=jax.devices()[:1]))
    stage = Stage()
    stage.step_losses = []
    pipeline.append_stage(stage, max_epochs=1)
    pipeline.run()
    return stage


def _port_run(tree):
    class Stage(tdml.TrainValStage):
        def pre_stage(self):
            model = ttr.DecoderLM(ttr.TransformerConfig(dtype=torch.float32, **TINY), device="cpu")
            ttr.load_flax_params(model, tree)
            self.pipeline.register_model("lm", model, verbose=False)
            schedule = toptim.warmup_cosine_decay_schedule(*SCHEDULE)
            self.pipeline.register_optimizer("adamw", toptim.adamw(schedule), scheduler=schedule)
            self.pipeline.register_dataset("train", _lm_batches(), verbose=False)

        def gradient_clip(self):
            return 1.0

        def gradient_accumulation(self):
            return 2

        def step(self, state, batch):
            return ttr.lm_loss(state.model(batch), batch)

    pipeline = tdml.TrainingPipeline({"seed": 0}, name="port-accum", device="cpu")
    stage = Stage()
    pipeline.append_stage(stage, max_epochs=1)
    pipeline.run()
    return stage


def test_tiny_decoder_with_two_microbatches_matches_the_jax_stage(single_runtime):
    model = jtr.DecoderLM(jtr.TransformerConfig(dtype=jnp.float32, **TINY))
    tree = model.init(jax.random.PRNGKey(2), jnp.zeros((1, SEQ), jnp.int32))["params"]
    tree = jax.tree_util.tree_map(np.asarray, tree)
    jstage = _jax_run(tree, model)
    tstage = _port_run(tree)

    t_losses = [float(x) for x in tstage.train_losses]
    assert len(jstage.step_losses) == len(t_losses) == STEPS
    np.testing.assert_allclose(t_losses, jstage.step_losses, rtol=1e-4)
    assert tstage.state.step == STEPS and int(jstage.state.step) == STEPS

    j_params = jax.tree_util.tree_flatten_with_path(jax.tree_util.tree_map(np.asarray, jstage.state.params))[0]
    t_params = dict(jax.tree_util.tree_flatten_with_path(ttr.to_flax_params(tstage.state.model))[0])
    moved = 0.0
    for path, want in j_params:
        got = t_params[path]
        name = jax.tree_util.keystr(path)
        rel = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12)
        assert rel <= 1e-4, f"{name}: relative error {rel:.3g}"
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max(), err_msg=name)
        start = tree
        for key in path:
            start = start[key.key]
        moved = max(moved, float(np.abs(want - start).max()))
    assert moved > 1e-3, "the steps did not move the weights: the comparison would be vacuous"


# ---------------------------------------------------------------------------
# mid-epoch resume with accumulation: one host batch is one optimizer step
# ---------------------------------------------------------------------------

ARGV = ["--device", "cpu", "--preset", "tiny", "--vocab-size", "128", "--seq-len", "32", "--batch-size", "4",
        "--n-seqs", "40", "--lr", "0.05", "--epochs", "1", "--save-every-steps", "3"]
TRAIN_BATCHES = 9


class _SignalAfter:
    def __init__(self, ds, k: int):
        self.ds, self.k = ds, k

    def __iter__(self):
        for i, batch in enumerate(self.ds):
            yield batch
            if i + 1 == self.k:
                os.kill(os.getpid(), signal.SIGUSR1)

    def __len__(self):
        return len(self.ds)


def _run_lm(root=None, resume=False, signal_after=None):
    argv = ARGV + (["--checkpoint-dir", str(root)] if root is not None else [])
    pipeline, stage = train_lm.build(argv, resume=resume)
    stage.gradient_accumulation = lambda: 2
    if signal_after is not None:
        datasets = stage.train_dataset
        stage.train_dataset = lambda: _SignalAfter(datasets(), signal_after)
        pipeline.enable_preemption_handling(("SIGUSR1",))
    pipeline.run()
    return pipeline, stage


def test_mid_epoch_resume_with_accumulation_skips_the_consumed_host_batches(tmp_path, monkeypatch):
    _, control = _run_lm()
    assert control.state.step == TRAIN_BATCHES
    pipe1, stage1 = _run_lm(root=tmp_path, resume=True, signal_after=2)
    assert stage1._mid_epoch_exit and stage1.state.step == 3

    copies, micro = [], []
    real_put = tdevice._HostCopier.put
    monkeypatch.setattr(tdevice._HostCopier, "put", lambda self, b: (copies.append(b), real_put(self, b))[1])
    real_step = train_lm.LMStage.train_step
    monkeypatch.setattr(train_lm.LMStage, "train_step", lambda self, s, b: (micro.append(1), real_step(self, s, b))[1])
    _, stage2 = _run_lm(root=pipe1.checkpoint_dir.path, resume=True)
    # 6 host batches left, each one optimizer step of 2 microbatches
    assert len(micro) == 2 * (TRAIN_BATCHES - 3)
    assert len(copies) == TRAIN_BATCHES - 3 + 1  # and the one validation batch
    assert stage2.state.step == TRAIN_BATCHES
    assert float(stage2.tracker["misc/total_train_batches"][-1]) == TRAIN_BATCHES - 3
    for name, p in stage2.state.model.named_parameters():
        assert torch.equal(p, dict(control.state.model.named_parameters())[name]), name
    for got, want in zip(stage2.train_losses, control.train_losses[3:]):
        assert torch.equal(got, want)
