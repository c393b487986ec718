"""FSDP2 and tensor parallelism of the port over a named mesh, across two and
four gloo processes on the CPU, against one process and the JAX step.

The tiny ``DecoderLM`` (2 layers, 4/2 heads of 16, hidden 64, vocab 512,
fp32) registers with ``llama_partition_rules()`` on each mesh and trains 3
steps with a global-norm clip and an EMA (then one validation batch on the
EMA), each process feeding the rows of its data-parallel coordinate of the
same global batches. Two and then four processes (env:// rung) run the cases
below one after another, rank 0 writing what it saw to a pickle:

- meshes ``fsdp=2`` and ``model=2`` (two processes), ``data=2,fsdp=2`` and
  ``fsdp=2,model=2`` (four): per-step losses, the gathered final parameters,
  the EMA and the validation loss within ``REL`` of one process at the same
  global batch; ``fsdp=2,model=2`` also on the flash path (its plain version
  on the CPU) and with ``chunked_lm_loss`` on the vocab-parallel head;
- ``data=2,fsdp=2`` and ``fsdp=2,model=2`` against the JAX package's step on
  a JAX mesh of the same axes, from the same bridged weights;
- ``gradient_accumulation() = 2`` equal to one microbatch;
- a save after epoch 1 resumed on the same mesh ends bitwise equal to the
  uninterrupted two-epoch run;
- tensor-parallel peers fed different batches raise;
- the pure-``data`` mesh (``set_mesh({"data": 2})``) bitwise equal to the
  path with no mesh set.
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
from dmlcloud_tpu_torch.data import markov_tokens
from dmlcloud_tpu_torch.models import transformer as ttr
from dmlcloud_tpu_torch.optim import adamw, warmup_cosine_decay_schedule
from dmlcloud_tpu_torch.parallel import mesh as tmesh
from dmlcloud_tpu_torch.parallel import runtime
from dmlcloud_tpu_torch.utils import tcp

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
TINY = dict(vocab_size=512, num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16, hidden_dim=64, mlp_dim=160,
            max_seq_len=32)
STEPS, BATCH, SEQ, CLIP, EMA = 3, 8, 32, 1.0, 0.9
SCHEDULE = (0.0, 0.05, 2, 100)
#: norm-relative (per parameter) and relative (losses) bound of a mesh against
#: one process, fp32: the sums of the batch and of the sharded matmuls run in
#: another order
REL = 1e-5
#: against the JAX step: the port's LM step is held to this in
#: tests/test_torch_train.py (XLA's and torch's CPU matmuls round differently)
JAX_REL = 1e-4


def global_batches() -> list[np.ndarray]:
    tokens = markov_tokens(TINY["vocab_size"], (STEPS + 1) * BATCH, SEQ, seed=3)
    return [tokens[i * BATCH:(i + 1) * BATCH] for i in range(STEPS)]


def val_batches() -> list[np.ndarray]:
    return [markov_tokens(TINY["vocab_size"], (STEPS + 1) * BATCH, SEQ, seed=3)[STEPS * BATCH:]]


def flax_init() -> dict:
    model = jtr.DecoderLM(jtr.TransformerConfig(dtype=jnp.float32, **TINY))
    params = model.init(jax.random.PRNGKey(1), jnp.zeros((1, SEQ), jnp.int32))["params"]
    return jax.tree_util.tree_map(np.asarray, params)


class LM(tdml.TrainValStage):
    """The tiny model under ``llama_partition_rules()``; each process feeds its
    data-parallel slice of every global batch (``feed="skewed"``: each
    process another slice, which tensor-parallel peers must refuse)."""

    def __init__(self, tree, attn="dot", accum=1, chunk=0, feed="dp"):
        super().__init__()
        self.tree, self.attn, self.accum, self.chunk, self.feed = tree, attn, accum, chunk, feed
        self.losses = []

    def pre_stage(self):
        model = ttr.DecoderLM(ttr.TransformerConfig(dtype=torch.float32, attn_impl=self.attn, **TINY), device="cpu")
        ttr.load_flax_params(model, self.tree)
        self.pipeline.register_model("lm", model, sharding=ttr.llama_partition_rules(), verbose=False)
        schedule = warmup_cosine_decay_schedule(*SCHEDULE)
        self.pipeline.register_optimizer("adamw", adamw(schedule), scheduler=schedule)
        mesh = self.pipeline.mesh
        if mesh is None:
            dp, r = runtime.world_size(), runtime.rank()
        else:
            dp, r = tmesh.data_parallel_size(mesh), tmesh.data_parallel_rank(mesh)
        if self.feed == "skewed":
            dp, r = runtime.world_size(), runtime.rank()
        rows = slice(r * BATCH // dp, (r + 1) * BATCH // dp)
        self.pipeline.register_dataset("train", [b[rows] for b in global_batches()], verbose=False)
        self.pipeline.register_dataset("val", [b[rows] for b in val_batches()], verbose=False)

    def gradient_clip(self):
        return CLIP

    def ema_decay(self):
        return EMA

    def gradient_accumulation(self):
        return self.accum

    def post_epoch(self):
        self.losses.extend(float(x) for x in self.train_losses)

    def step(self, state, batch):
        if self.chunk:
            hidden = state.model(batch, return_hidden=True)
            kernel, tp = ttr.lm_head_kernel(state.model)
            return ttr.chunked_lm_loss(hidden, kernel, batch, vocab_chunk=self.chunk, tp=tp)
        return ttr.lm_loss(state.model(batch), batch)


def _full(t: torch.Tensor) -> np.ndarray:
    from torch.distributed.tensor import DTensor

    t = t.detach()
    return (t.full_tensor() if isinstance(t, DTensor) else t).numpy().copy()


def run(tree, axes=None, epochs=1, root=None, resume=False, **kw) -> dict:
    """One pipeline run; what every rank saw (gathered to full tensors)."""
    from torch.distributed.tensor import DTensor

    pipe = tdml.TrainingPipeline({"seed": 0}, name="mesh", device="cpu")
    if axes:
        pipe.set_mesh(axes)
    if root:
        pipe.enable_checkpointing(root, resume=resume)
    stage = LM(tree, **kw)
    pipe.append_stage(stage, max_epochs=epochs)
    pipe.run()
    state, plan = stage.state, pipe.models["lm"].plan
    # the global loss of a step: the mean over the data-parallel processes
    # (tensor-parallel peers hold the same value)
    per_rank = runtime.all_gather_object(stage.losses)
    names = {p: n for n, p in state.model.named_parameters()}
    return {
        "losses": [float(np.mean(step)) for step in zip(*per_rank)],
        "val": float(stage.tracker["val/loss"][-1]),
        "batches": float(stage.tracker["misc/total_train_batches"][-1]),
        "params": ttr.to_flax_params(state.model),
        "ema": ttr.to_flax_params(state.model, state.ema),
        "mu": {names[p]: _full(s["mu"]) for p, s in state.optimizer.state.items()},
        "nu": {names[p]: _full(s["nu"]) for p, s in state.optimizer.state.items()},
        "step": state.step, "count": state.optimizer.count,
        "dtensors": sum(isinstance(p, DTensor) for p in state.model.parameters()),
        "n_params": len(list(state.model.parameters())),
        "fsdp": bool(plan and plan.fsdp), "tp": bool(plan and plan.tp is not None),
        "local_heads": int(getattr(state.model.layers[0].attn.q_proj.weight, "_local_tensor",
                                   state.model.layers[0].attn.q_proj.weight).shape[0]) // TINY["head_dim"],
        "run_dir": str(pipe.checkpoint_dir.path) if pipe.checkpoint_dir else None,
    }


_WORKER = textwrap.dedent(
    """
    import os, pickle, sys
    import torch
    sys.path.insert(0, os.environ["TEST_DIR"])
    from dmlcloud_tpu_torch.parallel import runtime
    from test_torch_fsdp import run

    torch.set_num_threads(1)
    assert runtime.init_auto(device="cpu") == "gloo"
    rank, world = runtime.rank(), runtime.world_size()
    tree = pickle.loads(open(os.environ["INIT"], "rb").read())
    root = os.environ["CKPT_ROOT"]
    out = {}
    if world == 2:
        out["fsdp=2"] = run(tree, {"fsdp": 2})
        out["model=2"] = run(tree, {"model": 2})
        out["no mesh"] = run(tree)
        out["data=2"] = run(tree, {"data": 2})
        try:
            run(tree, {"model": 2}, feed="skewed")
            out["skewed"] = None
        except ValueError as exc:
            out["skewed"] = str(exc)
    else:
        out["data=2,fsdp=2"] = run(tree, {"data": 2, "fsdp": 2})
        out["data=2,fsdp=2 accum 2"] = run(tree, {"data": 2, "fsdp": 2}, accum=2)
        out["fsdp=2,model=2"] = run(tree, {"fsdp": 2, "model": 2})
        out["fsdp=2,model=2 flash"] = run(tree, {"fsdp": 2, "model": 2}, attn="flash")
        out["fsdp=2,model=2 chunked"] = run(tree, {"fsdp": 2, "model": 2}, chunk=200)
        out["two epochs"] = run(tree, {"data": 2, "fsdp": 2}, epochs=2, root=root + "/a")
        first = run(tree, {"data": 2, "fsdp": 2}, epochs=1, root=root + "/b")
        out["resumed"] = run(tree, {"data": 2, "fsdp": 2}, epochs=2, root=first["run_dir"], resume=True)
    runtime.barrier("done", timeout=60)
    if rank == 0:
        with open(os.path.join(os.environ["OUT_DIR"], f"world{world}.pkl"), "wb") as f:
            pickle.dump(out, f)
    """
)


def _launch(world: int, out_dir: Path, init: Path) -> dict:
    port = tcp.find_free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(rank),
                   WORLD_SIZE=str(world), OMP_NUM_THREADS="1", PYTHONPATH=str(REPO),
                   TEST_DIR=str(Path(__file__).parent), OUT_DIR=str(out_dir), INIT=str(init),
                   CKPT_ROOT=str(out_dir / f"ckpt{world}"))
        # output to files: a full pipe would block one rank inside a collective
        with open(out_dir / f"log{world}.{rank}.txt", "w") as log:
            procs.append(subprocess.Popen([sys.executable, "-c", _WORKER], env=env, cwd=out_dir, stdout=log,
                                          stderr=subprocess.STDOUT))
    return procs


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("mesh_out")
    tree = flax_init()
    init = out_dir / "init.pkl"
    init.write_bytes(pickle.dumps(tree))
    procs = {w: _launch(w, out_dir, init) for w in (2, 4)}
    try:
        for ps in procs.values():
            for p in ps:
                p.wait(timeout=300)
    finally:
        for ps in procs.values():
            for p in ps:
                p.kill()
    for w, ps in procs.items():
        for rank, p in enumerate(ps):
            assert p.returncode == 0, (out_dir / f"log{w}.{rank}.txt").read_text()[-4000:]
    out = {}
    for w in (2, 4):
        out.update(pickle.loads((out_dir / f"world{w}.pkl").read_bytes()))
    runtime.init_single()
    try:
        out["one"] = run(tree)
        out["one flash"] = run(tree, attn="flash")
    finally:
        runtime.deinitialize()
    out["tree"] = tree
    return out


def _rel(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _assert_trees_close(got: dict, want: dict, rel: float, what: str) -> None:
    g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
        r = _rel(g[path], w)
        assert r <= rel, f"{what} {jax.tree_util.keystr(path)}: relative error {r:.3g} > {rel}"


def _assert_trees_equal(got: dict, want: dict, what: str) -> None:
    g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
        np.testing.assert_array_equal(g[path], w, err_msg=f"{what} {jax.tree_util.keystr(path)}")


MESH_CASES = {"fsdp=2": (True, False, 4), "model=2": (False, True, 2), "data=2,fsdp=2": (True, False, 4),
              "fsdp=2,model=2": (True, True, 2)}


@pytest.mark.parametrize("case", sorted(MESH_CASES))
def test_a_mesh_matches_one_process(results, case):
    got, want = results[case], results["one"]
    fsdp, tp, heads = MESH_CASES[case]
    assert (got["fsdp"], got["tp"], got["local_heads"]) == (fsdp, tp, heads)
    assert got["dtensors"] == got["n_params"], "a sharded model's parameters are all DTensors"
    assert len(got["losses"]) == STEPS and got["step"] == STEPS
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=REL)
    np.testing.assert_allclose(got["val"], want["val"], rtol=REL)
    _assert_trees_close(got["params"], want["params"], REL, case)
    _assert_trees_close(got["ema"], want["ema"], REL, case + " ema")
    # tensor-parallel peers count once in the epoch's metrics
    assert got["batches"] == want["batches"] * tmesh.data_parallel_size(
        dict(a.split("=") and (a.split("=")[0], int(a.split("=")[1])) for a in case.split(",")))
    moved = max(float(np.abs(a - b).max()) for a, b in zip(jax.tree_util.tree_leaves(want["params"]),
                                                           jax.tree_util.tree_leaves(results["tree"])))
    assert moved > 1e-3, "the steps did not move the weights: the comparison would be vacuous"


def test_the_flash_path_and_the_chunked_loss_on_a_tensor_parallel_mesh(results):
    flash, one = results["fsdp=2,model=2 flash"], results["one flash"]
    np.testing.assert_allclose(flash["losses"], one["losses"], rtol=REL)
    _assert_trees_close(flash["params"], one["params"], REL, "flash")
    chunked, dense = results["fsdp=2,model=2 chunked"], results["fsdp=2,model=2"]
    np.testing.assert_allclose(chunked["losses"], dense["losses"], rtol=REL)
    _assert_trees_close(chunked["params"], dense["params"], REL, "chunked")


def _run_jax(tree, axes: dict) -> tuple[list[float], dict]:
    model = jtr.DecoderLM(jtr.TransformerConfig(dtype=jnp.float32, **TINY))

    class Stage(jdml.TrainValStage):
        def pre_stage(self):
            self.pipeline.register_model("lm", model, params=tree, sharding=jtr.llama_partition_rules(),
                                         verbose=False)
            schedule = optax.warmup_cosine_decay_schedule(*SCHEDULE)
            self.pipeline.register_optimizer("adamw", optax.adamw(schedule), scheduler=schedule)
            self.pipeline.register_dataset("train", global_batches(), verbose=False)

        def gradient_clip(self):
            return CLIP

        def step(self, state, batch):
            return jtr.lm_loss(state.apply_fn({"params": state.params}, batch), batch)

        def _build_train_step(self):
            jitted = super()._build_train_step()

            def recorded(state, batch):
                state, metrics = jitted(state, batch)
                self.step_losses.append(float(metrics["loss"]))
                return state, metrics

            return recorded

    pipeline = jdml.TrainingPipeline({"seed": 0}, name="jax-mesh")
    n = int(np.prod(list(axes.values())))
    pipeline.set_mesh(jmesh.create_mesh(axes, devices=jax.devices()[:n]))
    stage = Stage()
    stage.step_losses = []
    pipeline.append_stage(stage, max_epochs=1)
    pipeline.run()
    return stage.step_losses, jax.tree_util.tree_map(np.asarray, stage.state.params)


@pytest.mark.parametrize("case", ["data=2,fsdp=2", "fsdp=2,model=2"])
def test_a_mesh_matches_the_jax_step_on_the_same_mesh(results, case):
    from dmlcloud_tpu.parallel import runtime as jruntime

    axes = {a.split("=")[0]: int(a.split("=")[1]) for a in case.split(",")}
    jruntime.init_single()
    try:
        losses, params = _run_jax(results["tree"], axes)
    finally:
        jruntime.deinitialize()
    np.testing.assert_allclose(results[case]["losses"], losses, rtol=JAX_REL)
    _assert_trees_close(results[case]["params"], params, JAX_REL, case + " vs JAX")


def test_two_microbatches_equal_one(results):
    one, two = results["data=2,fsdp=2"], results["data=2,fsdp=2 accum 2"]
    np.testing.assert_allclose(two["losses"], one["losses"], rtol=REL)
    _assert_trees_close(two["params"], one["params"], REL, "accum 2")


def test_a_resume_on_the_same_mesh_is_bitwise(results):
    want, got = results["two epochs"], results["resumed"]
    assert (got["step"], got["count"]) == (want["step"], want["count"]) == (2 * STEPS, 2 * STEPS)
    assert got["losses"] == want["losses"][STEPS:]
    for part in ("params", "ema"):
        _assert_trees_equal(got[part], want[part], f"resumed {part}")
    for part in ("mu", "nu"):
        assert got[part].keys() == want[part].keys()
        for name in want[part]:
            np.testing.assert_array_equal(got[part][name], want[part][name], err_msg=f"resumed {part} {name}")


def test_tensor_parallel_peers_must_feed_the_same_batch(results):
    assert results["skewed"] is not None and "tensor-parallel peers" in results["skewed"]


def test_the_pure_data_mesh_is_bitwise_the_default_path(results):
    got, want = results["data=2"], results["no mesh"]
    assert not (got["fsdp"] or got["tp"]) and got["dtensors"] == 0
    assert got["losses"] == want["losses"] and got["val"] == want["val"]
    _assert_trees_equal(got["params"], want["params"], "data=2")
    _assert_trees_equal(got["ema"], want["ema"], "data=2 ema")
