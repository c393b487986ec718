"""The port's quantized training against the JAX package, on the CPU.

- ``quant_train_dot`` (a ``torch.autograd.Function``): forward, ``dx`` and
  ``dw`` against the reference's ``custom_vjp`` within 5e-5 (fp32), on 2-D
  and 3-D (q/k/v-shaped) kernels; ``dscale`` is zero;
- ``amax_tree``/``wrap_train_tree`` match kernels only, as the reference's; a
  zero channel gets scale 1.0;
- ``TrainValStage(precision=...)`` validates with the reference's message;
- the reference's trajectory test through the port: per-epoch int8 losses
  within 5% of the port's bf16 arm, and falling;
- the port's int8 stage against the reference's int8 stage on the same
  corpus and initial weights: step 1 within 1e-5; later steps within 1e-3
  relative, because a one-ulp difference of an optimizer update can flip a
  ``round`` of ``w / scale`` and so one int8 weight;
- the amax is delayed by one step and refreshed once per step under
  gradient accumulation; an int8 run preempted and resumed equals the
  uninterrupted one bitwise; ``precompile=True`` (Dynamo's ``aot_eager``)
  stays within 1e-5 of the eager int8 run.
"""

import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

import dmlcloud_tpu as jdml
import dmlcloud_tpu_torch as tdml
from dmlcloud_tpu.models import quant as jq
from dmlcloud_tpu.models import transformer as jtr
from dmlcloud_tpu.parallel import mesh as jmesh
from dmlcloud_tpu_torch import optim as toptim
from dmlcloud_tpu_torch.compile import aot
from dmlcloud_tpu_torch.examples import train_lm
from dmlcloud_tpu_torch.models import quant as tq
from dmlcloud_tpu_torch.models import transformer as ttr

torch.set_num_threads(2)

FP32 = dict(atol=5e-5, rtol=5e-5)
VOCAB = 64
CFG = dict(vocab_size=VOCAB, num_layers=2, num_heads=2, num_kv_heads=1, head_dim=8, hidden_dim=16, mlp_dim=32,
           max_seq_len=32)


# ---------------------------------------------------------------------------
# quant_train_dot
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(16, 8), (16, 2, 4)])
def test_quant_train_dot_matches_the_references_custom_vjp(shape):
    rng = np.random.RandomState(1)
    x = rng.randn(3, 5, shape[0]).astype(np.float32)
    w = rng.randn(*shape).astype(np.float32)
    scale = np.abs(w).max(axis=0, keepdims=True) / 127.0

    def jloss(x, w, scale):
        return jnp.sum(jnp.sin(jq.quant_train_dot(x, w, scale)))

    jy = np.asarray(jq.quant_train_dot(jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale)))
    jdx, jdw, jds = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale))
    tx, tw, ts = (torch.tensor(a, requires_grad=True) for a in (x, w, scale))
    ty = tq.quant_train_dot(tx, tw, ts)
    assert tuple(ty.shape) == jy.shape == (3, 5, *shape[1:])
    torch.sin(ty).sum().backward()
    np.testing.assert_allclose(ty.detach().numpy(), jy, **FP32)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), **FP32)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw), **FP32)
    np.testing.assert_array_equal(ts.grad.numpy(), 0.0)
    np.testing.assert_array_equal(np.asarray(jds), 0.0)


def _tiny_model(seed=0):
    jmodel = jtr.DecoderLM(jtr.TransformerConfig(dtype=jnp.float32, **CFG))
    tree = jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(seed), jnp.ones((1, 4), jnp.int32))["params"])
    tmodel = ttr.load_flax_params(ttr.DecoderLM(ttr.TransformerConfig(dtype=torch.float32, **CFG), device="cpu"), tree)
    return jmodel, tree, tmodel


def test_amax_and_wrap_match_kernels_only():
    _, tree, tmodel = _tiny_model()
    with torch.no_grad():
        tmodel.layers[0].mlp.up_proj.weight[3] = 0.0  # output channel 3 of the flax kernel [in, out]
    tree = ttr.to_flax_params(tmodel)
    want = jq.amax_tree(tree)
    got = tq.amax_tree(tmodel)
    flat = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    kept = {"/".join(k.key for k in path): np.asarray(v) for path, v in flat.items() if np.asarray(v).ndim}
    assert sorted(got) == sorted(kept)  # the kernels, not the embedding or the norms
    for path, a in got.items():
        assert tuple(a.shape) == kept[path].shape, path  # keepdims over the flax kernel: [1, out] / [1, H, hd]
        np.testing.assert_array_equal(a.numpy(), kept[path], err_msg=path)
    assert tuple(got["layer_0/attn/q_proj/kernel"].shape) == (1, 2, 8)
    wrapped = tq.wrap_train_tree(tmodel, got)
    jwrapped = jq.wrap_train_tree(tree, want)
    assert sorted(wrapped) == sorted(got)
    up = wrapped["layer_0/mlp/up_proj/kernel"]
    assert up.scale[0, 3] == 1.0  # a zero channel's scale is 1.0, as quantize's
    np.testing.assert_array_equal(up.scale.numpy(), np.asarray(jwrapped["layer_0"]["mlp"]["up_proj"]["kernel"].scale))
    # the master weight passes through: its flax view shares the parameter's storage
    assert up.w.data_ptr() == tmodel.layers[0].mlp.up_proj.weight.data_ptr()
    y = tq.quant_train_dot(torch.ones(1, 16), up.w, up.scale)
    assert bool(torch.isfinite(y).all())


def test_precision_knob_validates():
    with pytest.raises(ValueError, match="precision") as port:
        tdml.TrainValStage(precision="fp8")
    with pytest.raises(ValueError, match="precision") as ref:
        jdml.TrainValStage(precision="fp8")
    assert str(port.value) == str(ref.value)
    assert tdml.TrainValStage().precision() == "full" and tdml.TrainValStage("int8").precision() == "int8"


# ---------------------------------------------------------------------------
# the stage: the trajectory, the reference's int8 stage, delayed amax
# ---------------------------------------------------------------------------

def _corpus(n, b, t, seed):
    rng = np.random.RandomState(seed)
    return [{"tokens": rng.randint(0, VOCAB, size=(b, t)).astype(np.int32)} for _ in range(n)]


def _port_stage(tree, dtype, train, precision):
    class LMStage(tdml.TrainValStage):
        def pre_stage(self):
            model = ttr.DecoderLM(ttr.TransformerConfig(dtype=dtype, **CFG), device="cpu")
            ttr.load_flax_params(model, tree)
            self.pipeline.register_model("lm", model, verbose=False)
            self.pipeline.register_optimizer("adamw", toptim.adamw(1e-3))
            self.pipeline.register_dataset("train", train, verbose=False)
            self.pipeline.register_dataset("val", [dict(train[0])], verbose=False)

        def step(self, state, batch):
            toks = batch["tokens"].long()
            logits = state.model(toks[:, :-1])
            return F.cross_entropy(logits.float().reshape(-1, VOCAB), toks[:, 1:].reshape(-1))

    return LMStage(precision=precision)


def _run_port(tree, dtype, train, precision, epochs=2):
    pipeline = tdml.TrainingPipeline({"seed": 0}, name=f"port-quant-{precision}", device="cpu")
    stage = _port_stage(tree, dtype, train, precision)
    pipeline.append_stage(stage, max_epochs=epochs)
    pipeline.run()
    return stage


def test_int8_loss_trajectory_tracks_bf16():
    _, tree, _ = _tiny_model()
    train = _corpus(6, 8, 24, 0)
    bf16 = _run_port(tree, torch.bfloat16, train, "full")
    int8 = _run_port(tree, torch.float32, train, "int8")
    l_bf16 = [float(x) for x in bf16.tracker["train/loss"]]
    l_int8 = [float(x) for x in int8.tracker["train/loss"]]
    assert len(l_int8) == len(l_bf16) >= 2
    for a, b in zip(l_int8, l_bf16):
        assert abs(a - b) / abs(b) <= 0.05, (l_int8, l_bf16)
    assert l_int8[-1] < l_int8[0]  # it trains
    # the delayed amax rides the checkpoint's extras; full precision carries none
    assert any(k.endswith(tq.QUANT_AMAX_KEY) for k in int8.state.state_dict().get("extras", {}))
    assert "extras" not in bf16.state.state_dict()
    # the parameters stay plain fp32 tensors, and validation ran at full precision
    assert all(p.dtype == torch.float32 for p in int8.state.model.parameters())
    assert not any(getattr(m, "quant_train", False) for m in int8.state.model.modules())


def test_int8_stage_matches_the_references_int8_stage(single_runtime):
    jmodel, tree, _ = _tiny_model(seed=3)
    train = _corpus(4, 8, 16, 7)

    class JStage(jdml.TrainValStage):
        def pre_stage(self):
            self.pipeline.register_model("lm", jmodel, params={"params": tree}, verbose=False)
            self.pipeline.register_optimizer("adamw", optax.adamw(1e-3))
            self.pipeline.register_dataset("train", train, verbose=False)

        def step(self, state, batch):
            toks = batch["tokens"]
            logits = state.apply_fn({"params": state.params}, toks[:, :-1])
            return optax.softmax_cross_entropy_with_integer_labels(logits.astype(jnp.float32), toks[:, 1:]).mean()

        def val_epoch(self):
            pass

        def _build_train_step(self):
            jitted = super()._build_train_step()

            def recorded(state, batch):
                state, metrics = jitted(state, batch)
                self.step_losses.append(float(metrics["loss"]))
                return state, metrics

            return recorded

    pipeline = jdml.TrainingPipeline({"seed": 0}, name="jax-int8")
    pipeline.set_mesh(jmesh.create_mesh({"data": 1}, devices=jax.devices()[:1]))
    jstage = JStage(precision="int8")
    jstage.step_losses = []
    pipeline.append_stage(jstage, max_epochs=1)
    pipeline.run()
    port = _run_port(tree, torch.float32, train, "int8", epochs=1)
    got = [float(x) for x in port.train_losses]
    want = jstage.step_losses
    assert len(got) == len(want) == 4
    assert abs(got[0] - want[0]) <= 1e-5, (got, want)
    np.testing.assert_allclose(got[1:], want[1:], rtol=1e-3)
    # the amax state each carries after its last step: the updated weights'
    jamax = dict(jax.tree_util.tree_flatten_with_path(jstage.state.extras[jq.QUANT_AMAX_KEY])[0])
    jamax = {"/".join(k.key for k in path if hasattr(k, "key")): np.asarray(v) for path, v in jamax.items()}
    for path, a in tq.amax_tree(port.state.model).items():
        np.testing.assert_allclose(a.numpy(), jamax[path], rtol=1e-3, err_msg=path)


def test_int8_amax_is_delayed_by_one_step():
    """After one step the layers' amax buffers equal ``amax_tree`` of the
    current (updated) weights, not of the initial ones."""
    _, tree, init_model = _tiny_model()
    stage = _run_port(tree, torch.float32, _corpus(1, 8, 16, 3), "int8", epochs=1)
    model = stage.state.model
    initial, current = tq.amax_tree(init_model), tq.amax_tree(model)
    held = {path: model.get_submodule(name.rpartition(".")[0]).quant_amax
            for path, (name, _) in tq._paths(model).items() if path in current}
    assert sorted(held) == sorted(current)
    assert any(not torch.equal(initial[p], current[p]) for p in current)
    for path in current:
        np.testing.assert_array_equal(held[path].numpy(), current[path].numpy(), err_msg=path)


# ---------------------------------------------------------------------------
# resume and the compiled step
# ---------------------------------------------------------------------------

ARGV = ["--device", "cpu", "--preset", "tiny", "--vocab-size", "128", "--seq-len", "32", "--batch-size", "4",
        "--n-seqs", "28", "--lr", "0.01", "--epochs", "1"]


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


def _run_lm(argv, resume=False, signal_after=None, **build_kw):
    pipeline, stage = train_lm.build(argv, resume=resume, **build_kw)
    stage.precision = lambda: "int8"
    if signal_after is not None:
        datasets = stage.train_dataset
        stage.train_dataset = lambda: _SignalAfter(datasets(), signal_after)
        pipeline.enable_preemption_handling(("SIGUSR1",))
    pipeline.run()
    return stage


def _state(stage):
    return {k: v.detach().clone() for k, v in stage.state.model.state_dict().items()}


def test_int8_preempted_and_resumed_equals_uninterrupted(tmp_path):
    control = _run_lm(ARGV)
    argv = ARGV + ["--checkpoint-dir", str(tmp_path), "--save-every-steps", "3"]
    first = _run_lm(argv, resume=True, signal_after=2)
    assert first._mid_epoch_exit and first.state.step == 3
    resumed = _run_lm(argv, resume=True)
    assert resumed.state.step == control.state.step > 3
    want, got = _state(control), _state(resumed)
    assert sorted(got) == sorted(want) and any(k.endswith("quant_amax") for k in want)
    for name in want:
        assert torch.equal(got[name], want[name]), name
    after = control.state.step - 3  # the steps the resumed run took
    assert [float(x) for x in resumed.train_losses][-after:] == [float(x) for x in control.train_losses][-after:]


def test_int8_under_precompile_matches_eager_int8(monkeypatch, tmp_path):
    monkeypatch.setattr(aot, "BACKEND", "aot_eager")
    argv = ARGV + ["--n-seqs", "16"]
    eager = _run_lm(argv)
    compiled = _run_lm(argv, precompile=True, compile_cache=str(tmp_path))
    assert compiled._train_compiled is not None
    np.testing.assert_allclose([float(x) for x in compiled.train_losses], [float(x) for x in eager.train_losses],
                               atol=1e-5, rtol=1e-5)
    for name, p in eager.state.model.state_dict().items():
        np.testing.assert_allclose(compiled.state.model.state_dict()[name].numpy(), p.numpy(), atol=1e-5, err_msg=name)


def test_int8_with_accumulation_refreshes_the_amax_once_per_step(monkeypatch):
    """Two microbatches share one delayed amax: it is refreshed once per
    optimizer step, and the run tracks the one-microbatch int8 run."""
    refreshes = []
    real = tq._refresh_amax
    monkeypatch.setattr(tq, "_refresh_amax", lambda layers: (refreshes.append(len(layers)), real(layers))[1])
    argv = ARGV + ["--n-seqs", "16"]
    single = _run_lm(argv)
    steps = single.state.step
    refreshes.clear()
    pipeline, accum = train_lm.build(argv)
    accum.precision = lambda: "int8"
    accum.gradient_accumulation = lambda: 2
    pipeline.run()
    assert accum.state.step == steps and refreshes == [len(accum._quant_layers)] * steps
    np.testing.assert_allclose([float(x) for x in accum.train_losses], [float(x) for x in single.train_losses],
                               rtol=1e-4)
