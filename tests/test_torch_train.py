"""The port's training loop against the JAX package's, on the CPU.

Three optimizer steps of the port's ``TrainValStage`` (AdamW + warmup-cosine
schedule + global-norm clip 1.0) run through its ``TrainingPipeline``, and
three steps of the reference's jitted train step (``TrainValStage.
_build_train_step``) run through a JAX ``TrainingPipeline``, from the same
carried weights and the same batches. Per-step losses and the final
parameters must agree within 1e-4 relative. Around that: the optimizer and
schedule against optax, the packed metric exchange against the JAX package's,
and a two-process gloo run of the env:// rung and its single ``all_reduce``.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import dmlcloud_tpu as jdml
import dmlcloud_tpu_torch as tdml
from dmlcloud_tpu import metrics as jmetrics
from dmlcloud_tpu.models import transformer as jtr
from dmlcloud_tpu.parallel import mesh as jmesh
from dmlcloud_tpu_torch import metrics as tmetrics
from dmlcloud_tpu_torch import optim as toptim
from dmlcloud_tpu_torch.data import markov_tokens
from dmlcloud_tpu_torch.models import transformer as ttr

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
TINY = dict(vocab_size=512, num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16, hidden_dim=64, mlp_dim=160,
            max_seq_len=32)
STEPS, BATCH, SEQ = 3, 4, 32
# a short warmup so that steps 2 and 3 move the weights visibly (step 1 runs at lr 0)
SCHEDULE = (0.0, 0.05, 2, 100)


def _batches():
    tokens = markov_tokens(TINY["vocab_size"], STEPS * BATCH, SEQ, seed=3)
    return [tokens[i * BATCH : (i + 1) * BATCH] for i in range(STEPS)]


def _flax_init(attn_impl):
    model = jtr.DecoderLM(jtr.TransformerConfig(dtype=jnp.float32, attn_impl=attn_impl, **TINY))
    params = model.init(jax.random.PRNGKey(1), jnp.zeros((1, SEQ), jnp.int32))["params"]
    return model, jax.tree_util.tree_map(np.asarray, params)


def _run_jax(attn_impl):
    model, tree = _flax_init(attn_impl)

    class Stage(jdml.TrainValStage):
        def pre_stage(self):
            self.pipeline.register_model("lm", model, params=tree, verbose=False)
            schedule = optax.warmup_cosine_decay_schedule(*SCHEDULE)
            self.pipeline.register_optimizer("adamw", optax.adamw(schedule), scheduler=schedule)
            self.pipeline.register_dataset("train", _batches(), verbose=False)

        def gradient_clip(self):
            return 1.0

        def step(self, state, batch):
            return jtr.lm_loss(state.apply_fn({"params": state.params}, batch), batch)

        def _build_train_step(self):
            jitted = super()._build_train_step()

            def recorded(state, batch):
                state, metrics = jitted(state, batch)
                self.step_losses.append(float(metrics["loss"]))
                return state, metrics

            return recorded

    pipeline = jdml.TrainingPipeline({"seed": 0}, name="jax-3-steps")
    pipeline.set_mesh(jmesh.create_mesh({"data": 1}, devices=jax.devices()[:1]))
    stage = Stage()
    stage.step_losses = []
    pipeline.append_stage(stage, max_epochs=1)
    pipeline.run()
    return tree, stage, pipeline


def _run_port(attn_impl, tree):
    class Stage(tdml.TrainValStage):
        def pre_stage(self):
            model = ttr.DecoderLM(ttr.TransformerConfig(dtype=torch.float32, attn_impl=attn_impl, **TINY),
                                  device="cpu")
            ttr.load_flax_params(model, tree)
            self.pipeline.register_model("lm", model, verbose=False)
            schedule = toptim.warmup_cosine_decay_schedule(*SCHEDULE)
            self.pipeline.register_optimizer("adamw", toptim.adamw(schedule), scheduler=schedule)
            self.pipeline.register_dataset("train", _batches(), verbose=False)

        def gradient_clip(self):
            return 1.0

        def step(self, state, batch):
            return ttr.lm_loss(state.model(batch), batch)

    pipeline = tdml.TrainingPipeline({"seed": 0}, name="port-3-steps", device="cpu")
    stage = Stage()
    pipeline.append_stage(stage, max_epochs=1)
    pipeline.run()
    return stage, pipeline


@pytest.mark.parametrize("attn_impl", ["dot", "flash"])
def test_three_steps_match_the_jax_train_step(single_runtime, attn_impl):
    tree, jstage, jpipe = _run_jax(attn_impl)
    tstage, tpipe = _run_port(attn_impl, tree)

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
        # elementwise, relative to the leaf's scale: Adam divides each moment by
        # its own root, so elements with near-zero gradients carry the gradients'
        # summation-order noise into updates of size ~lr
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max(), err_msg=name)
        start = tree
        for key in path:
            start = start[key.key]
        moved = max(moved, float(np.abs(want - start).max()))
    assert moved > 1e-3, "the three steps did not move the weights: the comparison would be vacuous"

    # the same metrics, under the same names, with the same epoch values
    jt, tt = jpipe.tracker, tpipe.tracker
    for name in ["train/loss", "misc/total_train_batches", "misc/worker_train_batches", "misc/lr_adamw", "misc/epoch"]:
        assert name in tt and name in jt, name
        np.testing.assert_allclose(float(tt[name][-1]), float(jt[name][-1]), rtol=1e-4, err_msg=name)
    for name in ["misc/step_dispatch_ms", "misc/train_step_avg_ms", "misc/host_stall_ms", "misc/epoch_time"]:
        assert name in tt and name in jt, name


@pytest.mark.parametrize("counts", [[0, 1, 2, 5, 19, 20, 21, 700, 1999, 2000, 2001, 5000]])
def test_schedule_matches_optax(counts):
    want = optax.warmup_cosine_decay_schedule(0.0, 3e-4, 20, 2000)
    got = toptim.warmup_cosine_decay_schedule(0.0, 3e-4, 20, 2000)
    for c in counts:
        # optax evaluates in fp32, the port in double: atol is fp32's resolution at the peak
        np.testing.assert_allclose(got(c), float(want(c)), rtol=1e-6, atol=3e-4 * 1e-6, err_msg=f"count {c}")
    assert got(0) == 0.0  # the first update of the warmup runs at lr 0


def test_adamw_matches_optax_defaults_and_weight_decay():
    rng = np.random.RandomState(0)
    shapes = [(7, 5), (5,), (3, 2, 4)]
    params = [rng.randn(*s).astype(np.float32) for s in shapes]
    grads = [[rng.randn(*s).astype(np.float32) * 10 ** rng.uniform(-6, 0) for s in shapes] for _ in range(4)]
    schedule = optax.warmup_cosine_decay_schedule(0.0, 1e-2, 2, 50)

    tx = optax.adamw(schedule)
    j_params, j_state = [jnp.asarray(p) for p in params], None
    j_state = tx.init(j_params)
    for g in grads:
        updates, j_state = tx.update([jnp.asarray(x) for x in g], j_state, j_params)
        j_params = optax.apply_updates(j_params, updates)

    t_params = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = toptim.adamw(toptim.warmup_cosine_decay_schedule(0.0, 1e-2, 2, 50))(t_params)
    assert opt.param_groups[0]["weight_decay"] == 1e-4  # optax's default, not torch's 0.01
    for g in grads:
        for p, x in zip(t_params, g):
            p.grad = torch.from_numpy(x)
        opt.step()
    assert opt.count == len(grads)
    for t, j in zip(t_params, j_params):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=1e-6, atol=1e-7)


def test_train_lm_example_packed_and_windowed_on_cpu():
    """The example's --pack (segment_ids) and --window paths through the flash
    plain versions: finite losses, the val split, and the tracked lr."""
    from dmlcloud_tpu_torch.examples.train_lm import main

    stage = main(["--device", "cpu", "--epochs", "1", "--n-seqs", "48", "--seq-len", "32", "--batch-size", "4",
                  "--attn", "flash", "--pack", "--window", "8"])
    tracker = stage.tracker
    assert all(np.isfinite(float(x)) for x in stage.train_losses)
    assert np.isfinite(float(tracker["val/loss"][-1]))
    assert float(tracker["misc/total_train_batches"][-1]) == len(stage.train_losses)
    np.testing.assert_allclose(float(tracker["misc/lr_adamw"][-1]), 3e-4 * len(stage.train_losses) / 20)


def test_seed_all_seeds_the_host_rngs_and_returns_a_generator():
    from dmlcloud_tpu_torch.utils.seed import seed_all

    gen = seed_all(123)
    first = (np.random.rand(), torch.rand(1, generator=gen).item(), torch.rand(1).item())
    gen = seed_all(123)
    assert (np.random.rand(), torch.rand(1, generator=gen).item(), torch.rand(1).item()) == first


def test_clip_uses_the_reference_formula():
    stage = tdml.TrainValStage()
    grads = [torch.full((4,), 3.0), torch.full((2, 2), 4.0)]  # sum g^2 = 100
    stage._clip_gradients(grads, 2.0)
    assert torch.allclose(grads[0], torch.full((4,), 0.6)) and torch.allclose(grads[1], torch.full((2, 2), 0.8))
    small = [torch.full((3,), 0.1)]
    stage._clip_gradients(small, 1.0)  # inside the clip: untouched
    assert torch.equal(small[0], torch.full((3,), 0.1))


def test_packed_metric_vector_matches_the_jax_package():
    names = ["misc/total_train_batches", "train/loss", "val/loss"]
    local = {"misc/total_train_batches": (False, np.float64(7.0)), "train/loss": (False, np.float32(2.5)),
             "val/loss": (True, None)}
    want = jmetrics._pack_scalar_metrics(names, local)
    got = tmetrics._pack_scalar_metrics(names, local)
    np.testing.assert_array_equal(got, want)
    reductions = {"misc/total_train_batches": tmetrics.Reduction.SUM, "train/loss": tmetrics.Reduction.MEAN,
                  "val/loss": tmetrics.Reduction.MEAN}
    out = tmetrics._unpack_scalar_metrics(names, np.stack([got, got]), reductions)
    assert out == {"misc/total_train_batches": 14.0, "train/loss": 2.5, "val/loss": None}


def test_tracker_reduces_device_tensors_in_one_copy():
    tracker = tmetrics.MetricTracker()
    tracker.register_metric("loss", tmetrics.Reduction.MEAN)
    tracker.register_metric("count", tmetrics.Reduction.SUM)
    for v in (1.0, 2.0, 6.0):
        tracker.track("loss", torch.tensor(v))
        tracker.track("count", 1)
    tracker.next_epoch()
    assert tracker["loss"] == [3.0] and tracker["count"] == [3]


_WORKER = textwrap.dedent(
    """
    import json, sys
    import torch
    from dmlcloud_tpu_torch.metrics import MetricTracker, Reduction
    from dmlcloud_tpu_torch.parallel import runtime

    assert runtime.init_auto(device="cpu") == "gloo"
    calls = []
    reduce = torch.distributed.all_reduce
    torch.distributed.all_reduce = lambda *a, **k: (calls.append(1), reduce(*a, **k))[1]
    rank = runtime.rank()
    tracker = MetricTracker()
    tracker.register_metric("loss", Reduction.MEAN)
    tracker.register_metric("n", Reduction.SUM)
    tracker.register_metric("peak", Reduction.MAX)
    for v in range(rank + 1):
        tracker.track("loss", torch.tensor(float(rank)))
        tracker.track("n", 1)
        tracker.track("peak", torch.tensor(float(10 * rank + v)))
    tracker.next_epoch()
    print(json.dumps({"rank": rank, "all_reduce_calls": len(calls),
                      "loss": float(tracker["loss"][0]), "n": float(tracker["n"][0]), "peak": float(tracker["peak"][0])}))
    runtime.deinitialize()
    """
)


def test_env_rung_and_one_all_reduce_per_epoch_over_gloo():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in range(2):
        env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(rank), WORLD_SIZE="2",
                   OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
        procs.append(subprocess.Popen([sys.executable, "-c", _WORKER], env=env, cwd=REPO,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
        outs.append(json.loads(out.strip().splitlines()[-1]))
    for o in outs:
        assert o["all_reduce_calls"] == 1
        assert o["loss"] == 0.5  # mean of the per-rank means 0 and 1
        assert o["n"] == 3.0
        assert o["peak"] == 11.0


def test_clip_rounds_the_scale_to_each_gradients_dtype():
    """bf16 gradients are multiplied by the scale rounded to bf16, the
    reference's ``g * scale.astype(g.dtype)``: bitwise equal to the JAX formula."""
    g = (np.random.RandomState(4).randn(4096) * 0.05).astype(np.float32)
    jg = jnp.asarray(g, jnp.bfloat16)
    sq = jnp.sum(jg.astype(jnp.float32) ** 2)
    scale = jnp.minimum(1.0, 0.7 * jax.lax.rsqrt(jnp.maximum(sq, 1e-12)))
    want = np.asarray((jg * scale.astype(jnp.bfloat16)).astype(jnp.float32))
    unrounded = np.asarray((jg.astype(jnp.float32) * scale).astype(jnp.bfloat16).astype(jnp.float32))
    assert float(scale) < 1 and (want != unrounded).sum() > 100, "the case would not tell the two formulas apart"
    grads = [torch.from_numpy(g).to(torch.bfloat16)]
    tdml.TrainValStage()._clip_gradients(grads, 0.7)
    np.testing.assert_array_equal(grads[0].float().numpy(), want)


def test_reduce_tensor_matches_the_reference():
    t = np.arange(24.0).reshape(2, 3, 4)
    for reduction in ("MEAN", "SUM", "MIN", "MAX"):
        for dim in (None, 1, [0, 2]):
            got = tmetrics.reduce_tensor(torch.from_numpy(t), tmetrics.Reduction(reduction), dim=dim)
            want = jmetrics.reduce_tensor(t, jmetrics.Reduction(reduction), dim=dim)
            np.testing.assert_array_equal(got, want, err_msg=f"{reduction} over {dim}")


def test_metric_reducer_api_matches_tests_test_metrics():
    """tests/test_metrics.py's TestMetricReducer expectations, case for case,
    with torch tensors in place of jax arrays, at world size 1."""
    r = tmetrics.MetricReducer(tmetrics.Reduction.MEAN)
    for v in (1.0, 2.0, 3.0):
        r.append(v)
    np.testing.assert_allclose(r.reduce_locally(), 2.0)
    np.testing.assert_allclose(r.reduce_globally(), 2.0)
    r = tmetrics.MetricReducer(tmetrics.Reduction.SUM)
    r.append(torch.tensor(1.5))
    r.append(torch.tensor(2.5))
    assert float(r.reduce_globally()) == 4.0
    assert tmetrics.MetricReducer().reduce_globally() is None
    # the list protocol
    r = tmetrics.MetricReducer()
    r += 1.0
    r.extend([2.0, 3.0])
    assert len(r) == 3
    del r[0]
    assert len(r) == 2
    r[0] = 9.0
    assert r[0] == 9.0
    r.clear()
    assert len(r) == 0
    # reduce_and_append reduces over dim before buffering
    r = tmetrics.MetricReducer(tmetrics.Reduction.SUM, dim=[1])
    r.reduce_and_append(torch.arange(6.0).reshape(2, 3))
    np.testing.assert_array_equal(r[0], [3.0, 12.0])


def test_tracker_bump_counts_like_the_reference():
    trackers = (tmetrics.MetricTracker(), jmetrics.MetricTracker())
    for tracker in trackers:
        tracker.bump("retries")
        tracker.bump("retries", 2)
        tracker.bump("local", 5, globally=False)
        tracker.next_epoch()
    assert [(float(t["retries"][0]), float(t["local"][0]), t.reducers["retries"].reduction.value,
             t.reducers["local"].globally) for t in trackers] == [(3.0, 5.0, "SUM", False)] * 2


def test_worker_and_step_keys_are_deterministic_distinct_generators():
    from dmlcloud_tpu_torch.utils.seed import seed_all, step_key, worker_key

    root = seed_all(7)
    draws = {}
    for name, make in (("w0", lambda: worker_key(root, 0)), ("w1", lambda: worker_key(7, 1)),
                       ("s0", lambda: step_key(root, 0)), ("s1", lambda: step_key(7, 1))):
        a, b = make(), make()
        assert isinstance(a, torch.Generator)
        draws[name] = torch.rand(4, generator=a)
        assert torch.equal(draws[name], torch.rand(4, generator=b)), f"{name} is not deterministic"
    assert len({tuple(d.tolist()) for d in draws.values()}) == 4  # per rank, per step, and apart from each other
    assert torch.equal(torch.rand(4, generator=worker_key(root)), draws["w0"])  # default index: this rank, 0


def test_enable_determinism_sets_the_torch_flags(monkeypatch):
    from dmlcloud_tpu_torch.utils.seed import enable_determinism

    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    before = (torch.are_deterministic_algorithms_enabled(), torch.backends.cudnn.benchmark)
    try:
        enable_determinism()
        assert torch.are_deterministic_algorithms_enabled()
        assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == ":4096:8"
        assert torch.backends.cudnn.benchmark is False
    finally:
        torch.use_deterministic_algorithms(before[0])
        torch.backends.cudnn.benchmark = before[1]
