"""The MoE ``DecoderLM`` on meshes with an ``expert`` axis, over gloo
processes on the CPU, against the JAX package's single-device apply.

A tiny fp32 model (2 blocks, both MoE, 4 experts, top-2) at BINDING capacity
(``moe_capacity_factor`` 0.5: most (token, choice) pairs drop) is initialised
by the JAX package. Each process lays it out under ``llama_partition_rules()``
(``shard_module``, the model's ``apply_data_parallel``, as ``register_model``
does), feeds the rows of its data-parallel coordinate, and runs
``lm_loss + total_aux_loss`` forward and backward; the gradients are averaged
over the data-parallel processes as the stage averages them (FSDP2 does so
in the backward). On ``expert=2``, ``data=2,expert=2`` and
``fsdp=2,expert=2`` the gathered logits, the loss (the mean over
data-parallel ranks), the aux loss and every gradient must equal the JAX
apply of the global batch within ``REL``. This holds only if the capacity
and the queue positions count every data-parallel rank's tokens in global
order, the balance loss is the product of the global means, and the summing
rules sit on the local experts' inputs and the combine's gates; a local
capacity is also shown to differ.

An ``expert=2`` AdamW step's state, saved with its sharding sidecar, restores
onto one process bitwise.

Compiled, in the same processes: on every mesh the same forward and backward
with each block's forward a ``compile.aot.compile_region`` (``compile_blocks``,
the boundary the stage takes on a mesh; Dynamo's ``aot_eager`` backend), so
the data-parallel routing's all-gather and the sums over the ``expert`` group
trace as functional collectives, against the eager run within
``COMPILED_REL`` and the JAX apply within ``REL``; and on ``expert=2`` and
``data=2,expert=2`` a ``TrainingPipeline(precompile=True)`` of ``STAGE_STEPS``
clipped AdamW steps against the same pipeline eager: 0 graph breaks,
``misc/recompiles`` 0 and the warm-up's state unchanged on every rank, losses
and parameters within ``COMPILED_REL``.
"""

import functools
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dmlcloud_tpu_torch as tdml
from dmlcloud_tpu.models import moe as jmoe
from dmlcloud_tpu.models import transformer as jtr
from dmlcloud_tpu.parallel import mesh as jmesh
from dmlcloud_tpu_torch.checkpoint import CheckpointDir
from dmlcloud_tpu_torch.compile import aot
from dmlcloud_tpu_torch.models import moe as tmoe
from dmlcloud_tpu_torch.models import transformer as ttr
from dmlcloud_tpu_torch.optim import adamw
from dmlcloud_tpu_torch.parallel import mesh as tmesh
from dmlcloud_tpu_torch.parallel import runtime
from dmlcloud_tpu_torch.parallel.data_parallel import all_reduce_gradients
from dmlcloud_tpu_torch.train_state import TrainState
from dmlcloud_tpu_torch.utils import tcp

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
#: meshes against one process, fp32: PERF.md's gate (sums run in another order)
REL = 1e-5
#: compiled against eager on the same mesh, fp32
COMPILED_REL = 1e-5
STAGE_STEPS = 2
CFG = dict(vocab_size=64, num_layers=2, num_heads=2, head_dim=8, hidden_dim=16, mlp_dim=32, max_seq_len=32,
           num_experts=4, moe_every=1, moe_capacity_factor=0.5)
GLOBAL, T = 4, 16
MESHES = {2: [{"expert": 2}], 4: [{"data": 2, "expert": 2}, {"fsdp": 2, "expert": 2}]}


def tokens() -> np.ndarray:
    return np.random.RandomState(3).randint(0, CFG["vocab_size"], (GLOBAL, T)).astype(np.int32)


def port_model(tree: dict) -> ttr.DecoderLM:
    return ttr.load_flax_params(ttr.DecoderLM(ttr.TransformerConfig(dtype=torch.float32, **CFG), device="cpu"), tree)


def moe_case(tree: dict, axes: dict | None, compiled: bool = False) -> dict:
    """One forward and backward of this process's rows on a mesh of ``axes``
    (None: one process, the global batch); ``compiled``: each block's forward
    a compiled region."""
    model = port_model(tree)
    plan = None
    if axes is not None:
        mesh = tmesh.create_mesh(axes, device="cpu")
        plan = tmesh.shard_module(model, mesh, ttr.llama_partition_rules())
        model.apply_data_parallel(tmesh.data_parallel_group(plan))
        dp, r = tmesh.data_parallel_size(mesh), tmesh.data_parallel_rank(mesh)
    else:
        dp, r = 1, 0
    if compiled:
        import torch._dynamo.utils as dynamo_utils

        dynamo_utils.counters.clear()
        aot.compile_blocks(model.fsdp_blocks(), "moe")
    rows = torch.tensor(tokens()[r * GLOBAL // dp:(r + 1) * GLOBAL // dp]).long()
    logits = model(rows)
    aux = tmoe.total_aux_loss(model)
    loss = ttr.lm_loss(logits, rows) + aux
    loss.backward()
    if plan is not None and not plan.fsdp and plan.dp_size > 1:
        all_reduce_gradients(model.parameters(), group=plan.grad_group)
    grads = ttr.to_flax_params(model, {n: p.grad for n, p in model.named_parameters()})
    out = {"logits": logits.detach().numpy(), "loss": float(loss), "aux": float(aux), "grads": grads, "dp": r,
           "ep": None if plan is None or plan.ep is None else (plan.ep.rank, plan.ep.size)}
    if compiled:
        out["graphs"] = (sum(dynamo_utils.counters["graph_break"].values()),
                         dynamo_utils.counters["stats"]["unique_graphs"])
    if axes is not None:
        every = runtime.all_gather_object({k: out[k] for k in ("logits", "loss", "aux", "dp")})
        by_dp = {o["dp"]: o for o in every}
        out["logits"] = np.concatenate([by_dp[i]["logits"] for i in sorted(by_dp)])
        out["loss"] = float(np.mean([by_dp[i]["loss"] for i in sorted(by_dp)]))
        out["aux"] = float(np.mean([by_dp[i]["aux"] for i in sorted(by_dp)]))
    return out


def saved_state(tree: dict, mesh=None) -> tuple[TrainState, dict | None]:
    """The model after one AdamW step on the global batch, laid out on
    ``mesh``, and its sidecar record."""
    model = port_model(tree)
    record = None
    if mesh is not None:
        record = tmesh.shard_module(model, mesh, ttr.llama_partition_rules()).record
    state = TrainState.create(model=model, tx=adamw(lambda step: 1e-2), ema=True)
    rows = torch.tensor(tokens()).long()
    (ttr.lm_loss(model(rows), rows) + tmoe.total_aux_loss(model)).backward()
    state.apply_gradients()
    state.update_ema(0.9)
    return state, record


class MoEStage(tdml.TrainValStage):
    """``STAGE_STEPS`` clipped AdamW steps of the tiny MoE model on
    ``lm_loss + total_aux_loss``, each process feeding its data-parallel rows."""

    def __init__(self, tree):
        super().__init__()
        self.tree, self.losses, self.warmup_kept_state = tree, [], None

    def pre_stage(self):
        self.pipeline.register_model("lm", port_model(self.tree), sharding=ttr.llama_partition_rules(),
                                     verbose=False)
        self.pipeline.register_optimizer("adamw", adamw(lambda step: 1e-2))
        mesh = self.pipeline.mesh
        dp, r = tmesh.data_parallel_size(mesh), tmesh.data_parallel_rank(mesh)
        rows = np.random.RandomState(5).randint(0, CFG["vocab_size"], (STAGE_STEPS, GLOBAL, T)).astype(np.int64)
        self.pipeline.register_dataset("train", [b[r * GLOBAL // dp:(r + 1) * GLOBAL // dp] for b in rows],
                                       verbose=False)

    def gradient_clip(self):
        return 0.5

    def _run_precompile_phase(self):
        before = flat(self.state.state_dict())
        super()._run_precompile_phase()
        after = flat(self.state.state_dict())
        self.warmup_kept_state = all(torch.equal(before[k], after[k]) for k in before)

    def post_epoch(self):
        self.losses.extend(float(x) for x in self.train_losses)

    def step(self, state, batch):
        return ttr.lm_loss(state.model(batch), batch) + tmoe.total_aux_loss(state.model)


def stage_case(tree: dict, axes: dict, compiled: bool) -> dict:
    """A pipeline run of ``MoEStage`` on ``axes``, eager or precompiled; the
    losses (mean over data-parallel ranks), the gathered parameters and every
    rank's compile record."""
    import torch._dynamo.utils as dynamo_utils

    pipe = tdml.TrainingPipeline({"seed": 0}, name="moe", device="cpu", precompile=compiled)
    pipe.set_mesh(axes)
    stage = MoEStage(tree)
    pipe.append_stage(stage, max_epochs=1)
    dynamo_utils.counters.clear()
    pipe.run()
    every = runtime.all_gather_object(stage.losses)
    return {"losses": [float(np.mean(step)) for step in zip(*every)],
            "params": {k: v.numpy() for k, v in flat(dict(stage.state.model.named_parameters())).items()},
            "compile": runtime.all_gather_object({
                "graph_breaks": sum(dynamo_utils.counters["graph_break"].values()),
                "recompiles": [float(x) for x in stage.tracker["misc/recompiles"]] if compiled else None,
                "warmup_kept_state": stage.warmup_kept_state})}


def flat(tree: dict, prefix: str = "") -> dict:
    """Every tensor of a nested state dict, gathered to full tensors."""
    from torch.distributed.tensor import DTensor

    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(flat(value, f"{prefix}{key}."))
        else:
            value = value.detach()
            out[prefix + key] = (value.full_tensor() if isinstance(value, DTensor) else value).clone()
    return out


_WORKER = textwrap.dedent(
    """
    import os, pickle, sys
    import torch
    sys.path.insert(0, os.environ["TEST_DIR"])
    from dmlcloud_tpu_torch.checkpoint import CheckpointDir
    from dmlcloud_tpu_torch.compile import aot
    from dmlcloud_tpu_torch.parallel import mesh as tmesh, runtime
    from test_torch_moe_dist import MESHES, flat, moe_case, saved_state, stage_case

    torch.set_num_threads(1)
    aot.BACKEND = "aot_eager"
    assert runtime.init_auto(device="cpu") == "gloo"
    world, rank = runtime.world_size(), runtime.rank()
    out_dir = os.environ["OUT_DIR"]
    tree = pickle.loads(open(os.path.join(out_dir, "tree.pkl"), "rb").read())
    out = {}
    for axes in MESHES[world]:
        name = ",".join(f"{k}={v}" for k, v in axes.items())
        out[name] = moe_case(tree, axes)
        out[name + " compiled"] = moe_case(tree, axes, compiled=True)
    stage_axes = {"expert": 2} if world == 2 else {"data": 2, "expert": 2}
    for compiled in (False, True):
        name = "stage " + ",".join(f"{k}={v}" for k, v in stage_axes.items())
        out[name + (" compiled" if compiled else "")] = stage_case(tree, stage_axes, compiled)
    if world == 2:
        state, record = saved_state(tree, tmesh.create_mesh({"expert": 2}, device="cpu"))
        ckpt = CheckpointDir(os.path.join(out_dir, "save"))
        if rank == 0:
            ckpt.create()
        runtime.barrier("created", timeout=60)
        ckpt.state_manager("s", async_save=False)
        ckpt.save_state(1, state.state_dict(), scope="s", sharding=record)
        ref = flat(state.state_dict())
        local = {n: tuple(p.to_local().shape) for n, p in state.model.named_parameters() if "moe" in n}
        out["saved"] = {"local shapes": local}
        if rank == 0:
            torch.save(ref, os.path.join(out_dir, "ref.pt"))
    runtime.barrier("done", timeout=60)
    if rank == 0:
        with open(os.path.join(out_dir, f"world{world}.pkl"), "wb") as f:
            pickle.dump(out, f)
    """
)


def _launch(world: int, out_dir: Path) -> list:
    port = tcp.find_free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(rank),
                   WORLD_SIZE=str(world), OMP_NUM_THREADS="1", PYTHONPATH=str(REPO),
                   TEST_DIR=str(Path(__file__).parent), OUT_DIR=str(out_dir))
        # output to files: a full pipe would block one rank inside a collective
        with open(out_dir / f"log{world}.{rank}.txt", "w") as log:
            procs.append(subprocess.Popen([sys.executable, "-c", _WORKER], env=env, cwd=out_dir, stdout=log,
                                          stderr=subprocess.STDOUT))
    return procs


@functools.lru_cache(maxsize=None)
def jax_reference():
    jmodel = jtr.DecoderLM(jtr.TransformerConfig(dtype=jnp.float32, **CFG))
    toks = jnp.asarray(tokens())
    params = jmodel.init(jax.random.PRNGKey(2), toks)["params"]

    def loss(p):
        logits, state = jmodel.apply({"params": p}, toks, mutable=["losses"])
        aux = jmoe.total_aux_loss(state)
        return jtr.lm_loss(logits, toks) + aux, (logits, aux)

    (l, (logits, aux)), grads = jax.value_and_grad(loss, has_aux=True)(params)
    return (jax.tree_util.tree_map(np.asarray, params),
            {"logits": np.asarray(logits), "loss": float(l), "aux": float(aux),
             "grads": jax.tree_util.tree_map(np.asarray, grads)})


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("moe_dist")
    tree, want = jax_reference()
    (out_dir / "tree.pkl").write_bytes(pickle.dumps(tree))
    procs = {w: _launch(w, out_dir) for w in MESHES}
    try:
        out = {"jax": want, "one": moe_case(tree, None),
               "one stage params": {n: p.detach().numpy().copy() for n, p in port_model(tree).named_parameters()}}
        for ps in procs.values():
            for p in ps:
                p.wait(timeout=240)
    finally:
        for ps in procs.values():
            for p in ps:
                p.kill()
    for w, ps in procs.items():
        for rank, p in enumerate(ps):
            assert p.returncode == 0, (out_dir / f"log{w}.{rank}.txt").read_text()[-4000:]
    for w in MESHES:
        out.update(pickle.loads((out_dir / f"world{w}.pkl").read_bytes()))
    out["tree"], out["dir"] = tree, out_dir
    return out


def _rel(got, want) -> float:
    return float(np.linalg.norm(np.asarray(got) - np.asarray(want)) / max(np.linalg.norm(np.asarray(want)), 1e-30))


def _check(got: dict, want: dict) -> None:
    assert _rel(got["logits"], want["logits"]) <= REL
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=REL)
    np.testing.assert_allclose(got["aux"], want["aux"], rtol=REL)
    flat_g = {jmesh.path_str(p): g for p, g in jax.tree_util.tree_leaves_with_path(got["grads"])}
    flat_w = {jmesh.path_str(p): g for p, g in jax.tree_util.tree_leaves_with_path(want["grads"])}
    assert flat_g.keys() == flat_w.keys()
    for path, w in flat_w.items():
        assert _rel(flat_g[path], w) <= REL, (path, _rel(flat_g[path], w))


def test_the_capacity_binds():
    cfg = ttr.TransformerConfig(**CFG).moe_config()
    assert tmoe.capacity(GLOBAL * T, cfg) == 8  # 128 choices over 4 experts: most drop


def test_one_process_equals_the_jax_apply(results):
    _check(results["one"], results["jax"])


@pytest.mark.parametrize("case", ["expert=2", "data=2,expert=2", "fsdp=2,expert=2"])
def test_expert_meshes_equal_the_jax_single_device_apply(results, case):
    got = results[case]
    assert got["ep"] is not None and got["ep"][1] == 2
    _check(got, results["jax"])


@pytest.mark.parametrize("case", ["expert=2", "data=2,expert=2", "fsdp=2,expert=2"])
def test_compiled_blocks_on_expert_meshes_equal_eager_and_the_jax_apply(results, case):
    got, eager = results[case + " compiled"], results[case]
    assert got["graphs"][0] == 0 and got["graphs"][1] > 0, got["graphs"]  # no graph break, something compiled
    _check(got, results["jax"])
    assert _rel(got["logits"], eager["logits"]) <= COMPILED_REL
    np.testing.assert_allclose(got["loss"], eager["loss"], rtol=COMPILED_REL)
    np.testing.assert_allclose(got["aux"], eager["aux"], rtol=COMPILED_REL)
    for path, w in jax.tree_util.tree_leaves_with_path(eager["grads"]):
        g = dict(jax.tree_util.tree_leaves_with_path(got["grads"]))[path]
        assert _rel(g, w) <= COMPILED_REL, (jmesh.path_str(path), _rel(g, w))


@pytest.mark.parametrize("case", ["expert=2", "data=2,expert=2"])
def test_a_precompiled_pipeline_on_an_expert_mesh_equals_its_eager_run(results, case):
    got, eager = results[f"stage {case} compiled"], results[f"stage {case}"]
    for rank in got["compile"]:
        assert rank == {"graph_breaks": 0, "recompiles": [0.0], "warmup_kept_state": True}, rank
    assert len(got["losses"]) == STAGE_STEPS
    np.testing.assert_allclose(got["losses"], eager["losses"], rtol=COMPILED_REL)
    assert got["params"].keys() == eager["params"].keys()
    for name, w in eager["params"].items():
        assert _rel(got["params"][name], w) <= COMPILED_REL, (name, _rel(got["params"][name], w))
    moved = max(float(np.abs(w - t).max()) for w, t in zip(eager["params"].values(),
                                                           results["one stage params"].values()))
    assert moved > 1e-3, "the steps did not move the weights: the comparison would be vacuous"


def test_a_local_capacity_would_differ(results):
    """Each data-parallel rank routing only its own rows (capacity and queue
    positions of 32 tokens) gives other logits: the global routing is what
    the meshes above reproduce."""
    model = port_model(results["tree"])
    rows = torch.tensor(tokens()).long()
    with torch.no_grad():
        local = torch.cat([model(rows[:2]), model(rows[2:])]).numpy()
    assert _rel(local, results["jax"]["logits"]) > 100 * REL


def test_the_experts_are_split_on_the_expert_axis(results):
    shapes = results["saved"]["local shapes"]
    assert shapes["layers.0.moe.gate_proj"] == (2, 16, 32)
    assert shapes["layers.1.moe.down_proj"] == (2, 32, 16)
    assert shapes["layers.0.moe.router.weight"] == (4, 16)


def test_an_expert_sharded_save_restores_onto_one_process_bitwise(results):
    ref = torch.load(results["dir"] / "ref.pt")
    ckpt = CheckpointDir(results["dir"] / "save")
    state, _ = saved_state(results["tree"])
    template = state.state_dict()
    ckpt.restore_state(1, template=template, scope="s")
    state.load_state_dict(template)
    got = flat(state.state_dict())
    assert got.keys() == ref.keys()
    for key in ref:
        assert torch.equal(got[key], ref[key]), key
    sidecar = ckpt.read_sharding_sidecar("s", 1)
    assert sidecar["mesh"] == {"expert": 2}
    assert sidecar["specs"]["params/layer_0/moe/moe/gate_proj"] == ["expert", None, None]
    assert sidecar["specs"]["params/layer_1/moe/moe/down_proj"] == ["expert", None, None]
    assert sidecar["specs"]["params/layer_1/moe/router/kernel"] == []


def test_expert_with_model_is_not_ported_yet():
    axes = {"expert": 2, "model": 2}
    model = port_model(jax_reference()[0])
    _, _, model_dim, expert_dim = tmesh.expert_placements(model, axes, ttr.llama_partition_rules())
    assert model_dim["layers.0.moe.gate_proj"] == 2 and expert_dim["layers.0.moe.gate_proj"] == 0
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 15"):
        tmesh.shard_module(model, _FakeMesh(axes), ttr.llama_partition_rules())


class _FakeMesh:
    """Just the names and shape ``shard_module`` reads before it raises."""

    def __init__(self, axes):
        self.mesh_dim_names, self.shape = tuple(axes), tuple(axes.values())
