"""The port's compiled step inside the stage (``precompile()``/``buckets()``), on the CPU.

- The reference's ``tests/test_compile.py::TestStageIntegration``: bounded
  signatures with buckets, recompiles without, buckets without precompile, a
  falling loss, errors at stage start, the default eager path.
- The precompile warm-up leaves parameters, buffers, optimizer state and
  generators bitwise as they were: a run with it ends bitwise equal to the
  same compiled run without it.
- The compiled tiny LM step against the JAX package's train step, on the same
  weights, within tests/test_torch_train.py's bounds.
- The compiled replicate step over two gloo processes against eager, and a
  ``seq`` or ``pipe`` plan under ``precompile`` raising with its ROADMAP item
  (14b).

Compiled regions use ``backend="aot_eager"`` (``compile.aot.BACKEND``,
monkeypatched), which traces and partitions like Inductor without generating
code.
"""

import os
import pickle
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
from dmlcloud_tpu.models import transformer as jtr
from dmlcloud_tpu.parallel import mesh as jmesh
from dmlcloud_tpu_torch import optim as toptim
from dmlcloud_tpu_torch.compile import aot, buckets as bk
from dmlcloud_tpu_torch.data import markov_tokens
from dmlcloud_tpu_torch.models import transformer as ttr
from dmlcloud_tpu_torch.parallel import runtime
from dmlcloud_tpu_torch.utils import tcp

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
TINY = dict(vocab_size=512, num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16, hidden_dim=64, mlp_dim=160,
            max_seq_len=32)
STEPS, BATCH, SEQ = 3, 4, 32
SCHEDULE = (0.0, 0.05, 2, 100)


@pytest.fixture(autouse=True)
def aot_eager(monkeypatch):
    monkeypatch.setattr(aot, "BACKEND", "aot_eager")


def _flax_init(attn_impl="flash"):
    model = jtr.DecoderLM(jtr.TransformerConfig(dtype=jnp.float32, attn_impl=attn_impl, **TINY))
    params = model.init(jax.random.PRNGKey(1), jnp.zeros((1, SEQ), jnp.int32))["params"]
    return model, jax.tree_util.tree_map(np.asarray, params)


# ------------------------------------------------------------ the stage


class _MaskedStage(tdml.TrainValStage):
    """Linear regression whose step zero-weights padded rows via the
    injected sample mask (the reference test's stage)."""

    def __init__(self, sizes=(8, 8, 5, 3), feature_dim=4):
        super().__init__()
        self._sizes = sizes
        self._dim = feature_dim

    def pre_stage(self):
        rng = np.random.RandomState(42)
        w_true = rng.randn(self._dim, 1).astype(np.float32)
        batches = []
        for s in self._sizes:
            x = rng.randn(s, self._dim).astype(np.float32)
            batches.append({"x": x, "y": x @ w_true})
        model = torch.nn.Linear(self._dim, 1, bias=False)
        torch.nn.init.zeros_(model.weight)
        self.pipeline.register_model("linear", model, verbose=False)
        self.pipeline.register_optimizer("sgd", toptim.sgd(0.05))
        self.pipeline.register_dataset("train", batches, verbose=False)

    def step(self, state, batch):
        per_sample = ((state.model(batch["x"]) - batch["y"]) ** 2).sum(-1)
        if "sample_mask" in batch:
            return bk.masked_mean(per_sample, batch["sample_mask"])
        return per_sample.mean()

    def val_epoch(self):
        pass


def _run_pipeline(stage, epochs=2, **pipeline_kw):
    pipeline = tdml.TrainingPipeline(name="compile-test", device="cpu", **pipeline_kw)
    pipeline.append_stage(stage, max_epochs=epochs)
    pipeline.run()
    return pipeline


@pytest.mark.parametrize("case", ["buckets_bound", "recompiles", "buckets_no_precompile", "loss_falls", "flops",
                                  "default"])
def test_stage_integration(single_runtime, tmp_path, case):
    if case == "buckets_bound":
        stage = _MaskedStage(sizes=(8, 8, 5, 3))
        pipeline = _run_pipeline(stage, precompile=True, buckets=(4, 8))
        # every ragged batch landed in a precompiled bucket: zero mid-run compiles
        assert pipeline.tracker["misc/recompiles"] == [0, 0]
        assert stage._train_compiled.signatures == 2 and stage._train_compiled._cache_size() == 2
        assert pipeline.tracker["misc/compile_ms"][0] > 0.0
    elif case == "recompiles":
        stage = _MaskedStage(sizes=(8, 5, 3))
        pipeline = _run_pipeline(stage, precompile=True)
        # only the peeked (size-8) signature was precompiled; 5 and 3 compiled
        # mid-run in epoch 1, already-seen signatures in epoch 2
        assert pipeline.tracker["misc/recompiles"] == [2, 0]
        assert stage._train_compiled.signatures == 1 and stage._train_compiled._cache_size() == 3
    elif case == "buckets_no_precompile":
        stage = _MaskedStage(sizes=(8, 5, 3, 2))
        pipeline = _run_pipeline(stage, buckets=(4, 8))
        assert pipeline.tracker["misc/recompiles"] == [2, 0]
        assert "misc/compile_ms" not in pipeline.tracker
        assert stage._train_compiled._cache_size() == 2
    elif case == "loss_falls":
        stage = _MaskedStage(sizes=(8, 8, 5, 3))
        pipeline = _run_pipeline(stage, epochs=4, precompile=True, buckets=(4, 8))
        losses = pipeline.tracker["train/loss"]
        assert losses[-1] < losses[0]
    elif case == "flops":
        # the MFU fallback: with telemetry armed and no step_flops(), the
        # precompile counts one step (x @ w forward and its weight gradient)
        from dmlcloud_tpu_torch.telemetry.goodput import flops_from_compiled

        stage = _MaskedStage(sizes=(8, 8))
        _run_pipeline(stage, precompile=True, telemetry=str(tmp_path / "telemetry"))
        record = stage._train_compiled.any_compiled()
        assert record.flops == 2 * (2 * 8 * 4 * 1)
        assert flops_from_compiled(record, n_devices=2) == 2 * record.flops
        assert stage._cost_analysis_flops() == record.flops
    else:
        stage = _MaskedStage(sizes=(8, 8))
        pipeline = _run_pipeline(stage)
        assert stage._train_compiled is None and stage._train_fwd is None and stage._update_fn is None
        assert "misc/recompiles" not in pipeline.tracker


def test_stage_start_errors(single_runtime):
    class BadSpec(_MaskedStage):
        def gradient_accumulation(self):
            return 4

        def batch_spec(self):
            # 6 rows cannot split into 4 microbatches: the step-1 crash, at stage start
            return {"x": aot.TensorSpec((6, 4), torch.float32), "y": aot.TensorSpec((6, 1), torch.float32)}

    stage = BadSpec()
    pipeline = tdml.TrainingPipeline(name="badspec", device="cpu", precompile=True)
    pipeline.append_stage(stage, max_epochs=1)
    with pytest.raises(ValueError, match="must divide"):
        pipeline.run()
    assert stage.state.step == 0 and not stage.train_losses  # no step ran

    class OneShot(_MaskedStage):
        def pre_stage(self):
            super().pre_stage()
            batches = self.pipeline.datasets.pop("train")
            self.pipeline.register_dataset("train", iter(batches), verbose=False)

    pipeline = tdml.TrainingPipeline(name="oneshot", device="cpu", precompile=True)
    pipeline.append_stage(OneShot(), max_epochs=1)
    with pytest.raises(ValueError, match="one-shot iterator"):
        pipeline.run()


class _NoisyStage(tdml.TrainValStage):
    """BatchNorm (running statistics) and dropout (the default generator) under AdamW."""

    def pre_stage(self):
        torch.manual_seed(0)
        model = torch.nn.Sequential(torch.nn.Linear(6, 16), torch.nn.BatchNorm1d(16), torch.nn.ReLU(),
                                    torch.nn.Dropout(0.3), torch.nn.Linear(16, 1))
        rng = np.random.RandomState(1)
        batches = [{"x": rng.randn(8, 6).astype(np.float32), "y": rng.randn(8, 1).astype(np.float32)}
                   for _ in range(3)]
        self.pipeline.register_model("net", model, verbose=False)
        self.pipeline.register_optimizer("adamw", toptim.adamw(1e-2))
        self.pipeline.register_dataset("train", batches, verbose=False)
        self.pipeline.register_dataset("val", batches[:1], verbose=False)

    def gradient_clip(self):
        return 1.0

    def ema_decay(self):
        return 0.9

    def step(self, state, batch):
        return ((state.model(batch["x"]) - batch["y"]) ** 2).mean()


def _noisy_run(skip_precompile: bool) -> dict:
    stage = _NoisyStage()
    if skip_precompile:
        stage._run_precompile_phase = lambda: None
    pipeline = tdml.TrainingPipeline(name="noisy", device="cpu", precompile=True)
    pipeline.append_stage(stage, max_epochs=1)
    pipeline.run()
    state = stage.state.state_dict()
    flat = {f"{k}.{n}": t.clone() for k, v in state.items() if isinstance(v, dict)
            for n, t in (v.items() if k != "opt_state" else
                         ((f"{s}.{m}", x) for s, d in v.items() if isinstance(d, dict) for m, x in d.items()))}
    return {"tensors": flat, "losses": [float(x) for x in stage.train_losses], "val": pipeline.tracker["val/loss"],
            "step": stage.state.step, "count": stage.state.optimizer.count, "rng": torch.get_rng_state(),
            "bn_batches": int(stage.state.model[1].num_batches_tracked), "recompiles": pipeline.tracker[
                "misc/recompiles"]}


def test_precompile_leaves_the_state_and_generators_as_they_were(single_runtime):
    torch.manual_seed(123)
    warmed = _noisy_run(skip_precompile=False)
    torch.manual_seed(123)
    lazy = _noisy_run(skip_precompile=True)
    assert warmed["recompiles"] == [0] and lazy["recompiles"] == [2]  # the train and the val signature
    assert warmed["tensors"].keys() == lazy["tensors"].keys()
    assert any(k.startswith("extras.") for k in warmed["tensors"])  # BatchNorm's running statistics
    assert any(k.startswith("ema.") for k in warmed["tensors"]) and any(".mu." in k for k in warmed["tensors"])
    for k in warmed["tensors"]:
        torch.testing.assert_close(warmed["tensors"][k], lazy["tensors"][k], rtol=0, atol=0, msg=k)
    assert warmed["losses"] == lazy["losses"] and warmed["val"] == lazy["val"]
    assert (warmed["step"], warmed["count"], warmed["bn_batches"]) == (lazy["step"], lazy["count"], 3)
    assert torch.equal(warmed["rng"], lazy["rng"])


def _batches():
    tokens = markov_tokens(TINY["vocab_size"], STEPS * BATCH, SEQ, seed=3)
    return [tokens[i * BATCH : (i + 1) * BATCH] for i in range(STEPS)]


def test_compiled_lm_step_matches_the_jax_train_step(single_runtime):
    jmodel, tree = _flax_init("flash")

    class JStage(jdml.TrainValStage):
        def pre_stage(self):
            self.pipeline.register_model("lm", jmodel, params=tree, verbose=False)
            schedule = optax.warmup_cosine_decay_schedule(*SCHEDULE)
            self.pipeline.register_optimizer("adamw", optax.adamw(schedule), scheduler=schedule)
            self.pipeline.register_dataset("train", _batches(), verbose=False)

        def gradient_clip(self):
            return 1.0

        def step(self, state, batch):
            return jtr.lm_loss(state.apply_fn({"params": state.params}, batch), batch)

    jpipe = jdml.TrainingPipeline({"seed": 0}, name="jax-steps")
    jpipe.set_mesh(jmesh.create_mesh({"data": 1}, devices=jax.devices()[:1]))
    jstage = JStage()
    jpipe.append_stage(jstage, max_epochs=1)
    jpipe.run()

    class TStage(tdml.TrainValStage):
        def pre_stage(self):
            model = ttr.DecoderLM(ttr.TransformerConfig(dtype=torch.float32, attn_impl="flash", **TINY), device="cpu")
            ttr.load_flax_params(model, tree)
            self.pipeline.register_model("lm", model, verbose=False)
            schedule = toptim.warmup_cosine_decay_schedule(*SCHEDULE)
            self.pipeline.register_optimizer("adamw", toptim.adamw(schedule), scheduler=schedule)
            self.pipeline.register_dataset("train", _batches(), verbose=False)

        def gradient_clip(self):
            return 1.0

        def step(self, state, batch):
            return ttr.lm_loss(state.model(batch), batch)

    tpipe = tdml.TrainingPipeline({"seed": 0}, name="port-steps", device="cpu", precompile=True)
    tstage = TStage()
    tpipe.append_stage(tstage, max_epochs=1)
    tpipe.run()
    assert tstage._train_compiled.signatures == 1 and tpipe.tracker["misc/recompiles"] == [0]
    # tests/test_torch_train.py's bounds
    np.testing.assert_allclose(float(tpipe.tracker["train/loss"][-1]), float(jpipe.tracker["train/loss"][-1]),
                               rtol=1e-4)
    assert tstage.state.step == STEPS and int(jstage.state.step) == STEPS
    t_params = dict(jax.tree_util.tree_flatten_with_path(ttr.to_flax_params(tstage.state.model))[0])
    for path, want in jax.tree_util.tree_flatten_with_path(jax.tree_util.tree_map(np.asarray, jstage.state.params))[0]:
        got, name = t_params[path], jax.tree_util.keystr(path)
        assert np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12) <= 1e-4, name
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max(), err_msg=name)


@pytest.mark.parametrize("mesh", ["seq=1", "pipe=1"])
def test_a_mesh_plan_under_precompile_names_its_queue_item(mesh):
    """The ring's and the pipeline's point-to-point hops have no functional
    form for Dynamo: a compiled step on ``seq`` or ``pipe`` still raises
    (``fsdp``, ``model`` and ``expert`` compile: tests/test_torch_fsdp.py,
    tests/test_torch_moe_dist.py)."""
    from dmlcloud_tpu_torch.examples import train_lm

    pipeline, _ = train_lm.build(["--device", "cpu", "--mesh", mesh, "--epochs", "1", "--n-seqs", "16",
                                  "--seq-len", "16", "--batch-size", "4"], precompile=True)
    try:
        with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 14b"):
            pipeline.run()
    finally:
        runtime.deinitialize()


def test_the_precompile_warm_ups_agree_over_the_processes(monkeypatch):
    """Each warm-up runs the step's collectives: the processes must warm as
    many train signatures (else a ``ValueError``, not a hang), and val
    warm-ups run only where every process has as many."""
    import logging
    import types

    from dmlcloud_tpu_torch import stage as stage_mod

    other = {}
    monkeypatch.setattr(stage_mod.runtime, "world_size", lambda: 2)
    monkeypatch.setattr(stage_mod.runtime, "all_gather_object", lambda mine, **kw: [mine, other["counts"]])
    me = types.SimpleNamespace(name="LM", logger=logging.getLogger("test"))
    agreed = tdml.TrainValStage._agreed_warmups
    other["counts"] = (2, 1)
    assert agreed(me, ["a", "b"], ["v"]) == (["a", "b"], ["v"])
    other["counts"] = (2, None)
    assert agreed(me, ["a", "b"], ["v"]) == (["a", "b"], [])
    assert agreed(me, ["a", "b"], None) == (["a", "b"], [])
    other["counts"] = (1, 1)
    with pytest.raises(ValueError, match=r"\[2, 1\] train signature"):
        agreed(me, ["a", "b"], ["v"])


_DP_WORKER = textwrap.dedent(
    """
    import os, pickle, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    import dmlcloud_tpu_torch as dml
    from dmlcloud_tpu_torch.compile import aot
    from dmlcloud_tpu_torch.optim import adamw
    from dmlcloud_tpu_torch.parallel import runtime

    aot.BACKEND = "aot_eager"
    runtime.init_auto("cpu")
    rank = runtime.rank()

    class Stage(dml.TrainValStage):
        def pre_stage(self):
            torch.manual_seed(0)
            model = torch.nn.Sequential(torch.nn.Linear(6, 16), torch.nn.Tanh(), torch.nn.Linear(16, 1))
            rng = np.random.RandomState(7)
            rows = [(rng.randn(8, 6).astype(np.float32), rng.randn(8, 1).astype(np.float32)) for _ in range(3)]
            self.pipeline.register_model("net", model, verbose=False)
            self.pipeline.register_optimizer("adamw", adamw(1e-2))
            self.pipeline.register_dataset("train", [{"x": x[rank::2], "y": y[rank::2]} for x, y in rows],
                                           verbose=False)

        def gradient_clip(self):
            return 0.5

        def step(self, state, batch):
            return ((state.model(batch["x"]) - batch["y"]) ** 2).mean()

    out = {}
    for tag, knobs in (("eager", {}), ("compiled", {"precompile": True})):
        pipeline = dml.TrainingPipeline(name=tag, device="cpu", **knobs)
        stage = Stage()
        pipeline.append_stage(stage, max_epochs=2)
        pipeline.run()
        out[tag] = {"losses": [float(x) for x in pipeline.tracker["train/loss"]],
                    "params": {n: p.detach().numpy().copy() for n, p in stage.state.model.named_parameters()}}
    with open(os.path.join(os.environ["OUT_DIR"], f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    runtime.deinitialize()
    """
)


def test_compiled_replicate_step_over_two_gloo_processes_matches_eager(tmp_path):
    port = tcp.find_free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(rank), WORLD_SIZE="2",
                   OMP_NUM_THREADS="1", PYTHONPATH=str(REPO), OUT_DIR=str(tmp_path))
        # output to files: a full pipe would block one rank inside a collective, and with it the other
        with open(tmp_path / f"log{rank}.txt", "w") as log:
            procs.append(subprocess.Popen([sys.executable, "-c", _DP_WORKER], env=env, cwd=tmp_path, stdout=log,
                                          stderr=subprocess.STDOUT))
    try:
        for p in procs:
            p.wait(timeout=240)
    finally:
        for p in procs:
            p.kill()
    for rank, p in enumerate(procs):
        assert p.returncode == 0, (tmp_path / f"log{rank}.txt").read_text()[-4000:]
    outs = [pickle.loads((tmp_path / f"rank{r}.pkl").read_bytes()) for r in range(2)]
    for out in outs:
        np.testing.assert_allclose(out["compiled"]["losses"], out["eager"]["losses"], rtol=1e-6)
        for n, want in out["eager"]["params"].items():
            np.testing.assert_allclose(out["compiled"]["params"][n], want, rtol=1e-5, atol=1e-7, err_msg=n)
    for n, p in outs[0]["compiled"]["params"].items():
        np.testing.assert_array_equal(p, outs[1]["compiled"]["params"][n], err_msg=n)  # replicas stay equal
