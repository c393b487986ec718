"""Elastic restore of the port: ``parallel.mesh.respec_for_mesh``, the
sharding sidecar and ``CheckpointDir.restore_state(mesh=)``/``restore_template``
in ``checkpoint.py``, and a mid-epoch stage resume on another layout.

- ``respec_for_mesh`` and the sidecar's JSON form against the JAX functions
  on tests/test_elastic.py's cases and a few more;
- the sidecar's ``specs`` for the tiny ``DecoderLM`` under
  ``llama_partition_rules()`` against the reference's sidecar on the same two
  meshes;
- four gloo processes save a trained ``TrainState`` of the tiny model on
  ``fsdp=4``; it is restored onto ``data=2,fsdp=2`` (the same four), onto
  ``fsdp=2`` (two other processes) and onto one process (here), each with
  ``restore_state(mesh=)`` and no template and into a live state laid out on
  the new mesh, and every tensor must equal the saved one bitwise;
- a missing sidecar falls back to the policy with the reference's warning,
  a damaged one reads as None;
- two processes stop mid-epoch after a step save (the LM example on
  ``--mesh fsdp=2``, each process slicing the global batches; and a stage on a
  ``ShardedSequenceDataset``, each rank its own shard); one process resumes
  each: the first skips the same 3 batches and continues the losses of an
  uninterrupted run, the second skips the 6 global batches the two ranks
  consumed.
"""

import json
import logging
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
from jax.sharding import PartitionSpec as JP

import dmlcloud_tpu_torch as tdml
from dmlcloud_tpu.checkpoint import CheckpointDir as JCheckpointDir
from dmlcloud_tpu.models import transformer as jtr
from dmlcloud_tpu.parallel import mesh as jmesh
from dmlcloud_tpu_torch.checkpoint import CheckpointDir
from dmlcloud_tpu_torch.data import ShardedSequenceDataset
from dmlcloud_tpu_torch.examples import train_lm
from dmlcloud_tpu_torch.models import transformer as ttr
from dmlcloud_tpu_torch.optim import adamw
from dmlcloud_tpu_torch.parallel import mesh as tmesh
from dmlcloud_tpu_torch.parallel import runtime
from dmlcloud_tpu_torch.train_state import TrainState
from dmlcloud_tpu_torch.utils import tcp

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
TINY = dict(vocab_size=512, num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16, hidden_dim=64, mlp_dim=160,
            max_seq_len=32)
LM_ARGV = ["--device", "cpu", "--preset", "tiny", "--seq-len", "32", "--batch-size", "4", "--n-seqs", "64",
           "--epochs", "1", "--save-every-steps", "3"]
SAVE_AT = 3
#: fp32 losses of a run resumed on another layout against an uninterrupted
#: one: AdamW's first updates are about +-lr per element (m / sqrt(v) of a
#: single gradient), so an element whose gradient is near 0 can take the other
#: sign under another reduction order; eleven steps on, the losses drift
#: apart by ~1e-4 (the batches themselves are checked exactly)
RESUME_REL = 1e-3

#: (spec, shape, mesh axes): tests/test_elastic.py:49-77, then moves and drops
RESPEC_CASES = {
    "kept": (JP("fsdp", None), (8, 4), {"data": 2, "fsdp": 2}),
    "missing axis dropped": (JP("fsdp", None), (8, 4), {"data": 2}),
    "relocated": (JP("fsdp", None), (6, 8), {"fsdp": 4}),
    "dropped with no home": (JP("fsdp"), (6,), {"fsdp": 4}),
    "tuple axes": (JP(("data", "fsdp"), None, "model"), (8, 4, 6), {"data": 2, "fsdp": 2, "model": 2}),
    "tuple axis relocated": (JP(None, ("data", "fsdp")), (8, 6), {"data": 2, "fsdp": 2}),
    "two axes, one moves": (JP("model", "fsdp"), (6, 16), {"fsdp": 2, "model": 4}),
    "grown axis": (JP("fsdp", None), (8, 4), {"fsdp": 8}),
}


def _jax_mesh(axes: dict):
    n = int(np.prod(list(axes.values())))
    return jmesh.create_mesh(axes, devices=jax.devices()[:n])


def _full(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    t = t.detach()
    return (t.full_tensor() if isinstance(t, DTensor) else t).clone()


def flat(tree: dict, prefix: str = "") -> dict:
    """Every tensor of a nested state dict, gathered to full tensors (a
    collective on a sharded state)."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(flat(value, f"{prefix}{key}."))
        else:
            out[prefix + key] = _full(value)
    return out


def trained_state(mesh=None) -> tuple[TrainState, dict | None]:
    """The tiny model after one AdamW step (seeded), laid out on ``mesh``
    under ``llama_partition_rules()``, and its sidecar record."""
    model = ttr.DecoderLM(ttr.TransformerConfig(dtype=torch.float32, **TINY), device="cpu")
    record = None
    if mesh is not None:
        record = tmesh.shard_module(model, mesh, ttr.llama_partition_rules()).record
    state = TrainState.create(model=model, tx=adamw(lambda step: 1e-2), ema=True)
    tokens = torch.randint(0, TINY["vocab_size"], (2, 32), generator=torch.Generator().manual_seed(0))
    ttr.lm_loss(model(tokens), tokens).backward()
    state.apply_gradients()
    state.update_ema(0.9)
    return state, record


def fresh_state(mesh=None) -> TrainState:
    """A state of the same structure, laid out on ``mesh``, before any step."""
    model = ttr.DecoderLM(ttr.TransformerConfig(dtype=torch.float32, **TINY), device="cpu",
                          generator=torch.Generator().manual_seed(5))
    if mesh is not None:
        tmesh.shard_module(model, mesh, ttr.llama_partition_rules())
    return TrainState.create(model=model, tx=adamw(lambda step: 1e-2), ema=True)


def restored_equal(ckpt: CheckpointDir, ref: dict, mesh) -> dict:
    """Restore step 1 onto ``mesh`` (None: one process, no mesh) without a
    template and into a live state; whether each equals ``ref`` bitwise."""
    out = {}
    if mesh is not None:
        got = flat(ckpt.restore_state(scope="s", mesh=mesh))
        out["no template"] = got.keys() == ref.keys() and all(torch.equal(got[k], ref[k]) for k in ref)
    state = fresh_state(mesh)
    template = state.state_dict()
    ckpt.restore_state(1, template=template, scope="s")
    state.load_state_dict(template)
    got = flat(state.state_dict())
    out["live state"] = got.keys() == ref.keys() and all(torch.equal(got[k], ref[k]) for k in ref)
    out["step"] = (state.step, state.optimizer.count)
    return out


class Stopping:
    """A dataset with its length whose iteration raises a few batches after
    ``after`` (the feed reads ahead of the step), so the run ends right after
    the step save at ``after``."""

    def __init__(self, ds, after: int):
        self.ds, self.after = ds, after

    def __len__(self):
        return len(self.ds)

    def set_epoch(self, epoch):
        if hasattr(self.ds, "set_epoch"):
            self.ds.set_epoch(epoch)

    def __iter__(self):
        for i, batch in enumerate(self.ds):
            if i == self.after + 2:
                raise RuntimeError("stop after the step save")
            yield batch


class Sharded(tdml.TrainValStage):
    """A linear model on a ``ShardedSequenceDataset`` of 16 batches: each
    data-parallel rank iterates its own shard."""

    def __init__(self, stop: int | None = None):
        super().__init__()
        self.stop = stop

    def pre_stage(self):
        model = torch.nn.Linear(4, 1)
        with torch.no_grad():
            model.weight.fill_(0.1)
            model.bias.zero_()
        self.pipeline.register_model("m", model, verbose=False)
        self.pipeline.register_optimizer("adamw", adamw(lambda step: 1e-2))
        rng = np.random.RandomState(0)
        batches = [torch.from_numpy(rng.randn(2, 4).astype(np.float32)) for _ in range(16)]
        ds = ShardedSequenceDataset(batches)
        self.pipeline.register_dataset("train", ds if self.stop is None else Stopping(ds, self.stop), verbose=False)
        self.pipeline.register_dataset("val", batches[:1], verbose=False)

    def checkpoint_every(self):
        return 0

    def checkpoint_every_steps(self):
        return SAVE_AT

    def async_checkpoint(self):
        return False

    def step(self, state, batch):
        return (state.model(batch) ** 2).mean()


def run_sharded(root: str, stop: int | None = None, resume: bool = False) -> tuple:
    pipe = tdml.TrainingPipeline({"seed": 0}, name="sharded", device="cpu")
    pipe.enable_checkpointing(root, resume=resume)
    stage = Sharded(stop)
    pipe.append_stage(stage, max_epochs=1)
    try:
        pipe.run()
    except RuntimeError as exc:
        if "stop after the step save" not in str(exc):
            raise
    return pipe, stage


def run_lm(argv: list[str], stop: int | None = None, resume: bool = False):
    """The LM example with step saves only (synchronous); ``stage.seen`` holds
    every batch a step trained on."""
    pipe, stage = train_lm.build(argv, resume=resume)
    stage.checkpoint_every = lambda: 0
    stage.async_checkpoint = lambda: False
    stage.seen = []
    step = stage.step

    def recording(state, batch):
        stage.seen.append(batch.detach().cpu().numpy().copy())
        return step(state, batch)

    stage.step = recording
    if stop is not None:
        orig = stage.train_dataset
        stage.train_dataset = lambda: Stopping(orig(), stop)
    try:
        pipe.run()
    except RuntimeError as exc:
        if "stop after the step save" not in str(exc):
            raise
    return pipe, stage


_WORKER = textwrap.dedent(
    """
    import os, pickle, sys, time
    import torch
    sys.path.insert(0, os.environ["TEST_DIR"])
    from dmlcloud_tpu_torch.checkpoint import CheckpointDir
    from dmlcloud_tpu_torch.parallel import mesh as tmesh
    from dmlcloud_tpu_torch.parallel import runtime
    from test_torch_elastic import LM_ARGV, SAVE_AT, flat, restored_equal, run_lm, run_sharded, trained_state

    torch.set_num_threads(1)
    assert runtime.init_auto(device="cpu") == "gloo"
    world, rank = runtime.world_size(), runtime.rank()
    out_dir = os.environ["OUT_DIR"]
    root = os.path.join(out_dir, "save")
    out = {}
    if world == 4:
        state, record = trained_state(tmesh.create_mesh({"fsdp": 4}, device="cpu"))
        ckpt = CheckpointDir(root)
        if rank == 0:
            ckpt.create()
        runtime.barrier("created", timeout=60)
        ckpt.state_manager("s", async_save=False)
        ckpt.save_state(1, state.state_dict(), scope="s", sharding=record)
        ref = flat(state.state_dict())
        if rank == 0:
            torch.save(ref, os.path.join(out_dir, "ref.pt"))
            open(os.path.join(out_dir, "saved"), "w").close()
        out["data=2,fsdp=2"] = restored_equal(ckpt, ref, tmesh.create_mesh({"data": 2, "fsdp": 2}, device="cpu"))
    else:
        # two stage runs that stop after the step-3 save; one process resumes them
        pipe, _ = run_lm(LM_ARGV + ["--mesh", "fsdp=2", "--checkpoint-dir", os.path.join(out_dir, "lm")],
                         stop=SAVE_AT)
        out["lm run dir"] = str(pipe.checkpoint_dir.path)
        pipe, _ = run_sharded(os.path.join(out_dir, "sharded"), stop=SAVE_AT)
        out["sharded run dir"] = str(pipe.checkpoint_dir.path)
        deadline = time.time() + 120
        while not os.path.exists(os.path.join(out_dir, "saved")):
            if time.time() > deadline:
                raise TimeoutError("the four processes did not save")
            time.sleep(0.2)
        ref = torch.load(os.path.join(out_dir, "ref.pt"))
        out["fsdp=2"] = restored_equal(CheckpointDir(root), ref, tmesh.create_mesh({"fsdp": 2}, device="cpu"))
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


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("elastic_out")
    procs = {w: _launch(w, out_dir) for w in (4, 2)}
    try:
        # the uninterrupted one-process run the resumed LM run is held against
        runtime.init_single()
        try:
            _, control = run_lm(LM_ARGV)
            control_losses = [float(x) for x in control.train_losses]
            control_batches = control.seen
        finally:
            runtime.deinitialize()
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
    out = {}
    for w in (4, 2):
        out.update(pickle.loads((out_dir / f"world{w}.pkl").read_bytes()))
    ref = torch.load(out_dir / "ref.pt")
    out["one process"] = restored_equal(CheckpointDir(out_dir / "save"), ref, None)
    runtime.init_single()
    try:
        out["one-rank mesh"] = restored_equal(CheckpointDir(out_dir / "save"), ref,
                                              tmesh.create_mesh({"fsdp": 1}, device="cpu"))
        _, lm = run_lm(LM_ARGV + ["--checkpoint-dir", out["lm run dir"]], resume=True)
        out["lm resumed"] = [float(x) for x in lm.train_losses]
        out["lm resumed batches"] = lm.seen
        _, sharded = run_sharded(out["sharded run dir"], resume=True)
        out["sharded resumed"] = len(sharded.train_losses)
    finally:
        runtime.deinitialize()
    out["lm control"], out["lm control batches"] = control_losses, control_batches
    out["ref"] = ref
    out["saved sidecar"] = CheckpointDir(out_dir / "save").read_sharding_sidecar("s", 1)
    return out


@pytest.mark.parametrize("case", list(RESPEC_CASES))
def test_respec_for_mesh_matches_the_reference(case):
    spec, shape, axes = RESPEC_CASES[case]
    want = jmesh.respec_for_mesh(spec, shape, _jax_mesh(axes))
    assert tmesh.respec_for_mesh(tuple(spec), shape, axes) == tuple(want)
    as_json = tmesh.spec_to_jsonable(tuple(spec))
    assert as_json == jmesh.spec_to_jsonable(spec)
    assert tmesh.spec_from_jsonable(json.loads(json.dumps(as_json))) == tuple(jmesh.spec_from_jsonable(as_json))


@pytest.mark.parametrize("axes", [{"fsdp": 2, "model": 2}, {"data": 2, "fsdp": 4}], ids=str)
def test_the_sidecar_records_the_references_specs(tmp_path, axes):
    from dmlcloud_tpu.parallel import runtime as jruntime
    from test_torch_fsdp import flax_init

    tree = flax_init()
    jruntime.init_single()
    try:
        params = jmesh.shard_pytree(jax.tree_util.tree_map(jnp.asarray, tree), _jax_mesh(axes),
                                    jtr.llama_partition_rules())
        jckpt = JCheckpointDir(tmp_path / "jax")
        jckpt.create()
        jckpt.state_manager("s", async_save=False)
        jckpt.save_state(1, {"params": params}, scope="s")
        jckpt.wait_until_finished()
        want = jckpt.read_sharding_sidecar("s", 1)
        jckpt.close()
    finally:
        jruntime.deinitialize()

    model = ttr.DecoderLM(ttr.TransformerConfig(dtype=torch.float32, **TINY), device="cpu")
    ckpt = CheckpointDir(tmp_path / "torch")
    ckpt.create()
    ckpt.state_manager("s", async_save=False)
    ckpt.save_state(1, {"params": {n: p.detach() for n, p in model.named_parameters()}}, scope="s",
                    sharding=tmesh.sharding_record(model, axes, ttr.llama_partition_rules()))
    got = ckpt.read_sharding_sidecar("s", 1)
    assert got["mesh"] == want["mesh"] == axes
    assert got["specs"] == want["specs"]


@pytest.mark.parametrize("case", ["data=2,fsdp=2", "fsdp=2", "one-rank mesh", "one process"])
def test_a_save_on_fsdp4_restores_bitwise_on_another_layout(results, case):
    got = results[case]
    assert got["live state"], f"{case}: the live state differs from the saved one"
    if case != "one process":
        assert got["no template"], f"{case}: restore_state(mesh=) differs from the saved state"
    assert got["step"] == (1, 1)


def test_the_fsdp4_sidecar_records_the_policy_and_the_torch_layout(results):
    side = results["saved sidecar"]
    assert side["mesh"] == {"fsdp": 4}
    assert side["specs"]["params/layer_0/attn/q_proj/kernel"] == ["fsdp", None]
    entry = side["entries"]["params.layers.0.attn.q_proj.weight"]
    assert entry == {"spec": "params/layer_0/attn/q_proj/kernel", "shape": [64, 4, 16], "dims": [1, 0, None]}
    assert side["entries"]["opt_state.mu.layers.0.attn.q_proj.weight"]["spec"] == \
        "opt_state/mu/layer_0/attn/q_proj/kernel"
    assert side["specs"]["step"] == [] and side["specs"]["opt_state/count"] == []


def _single_save(tmp_path) -> tuple[CheckpointDir, dict]:
    state, _ = trained_state()
    ckpt = CheckpointDir(tmp_path / "run")
    ckpt.create()
    ckpt.state_manager("s", async_save=False)
    ckpt.save_state(1, state.state_dict(), scope="s",
                    sharding=tmesh.sharding_record(state.model, {"fsdp": 1}, "fsdp"))
    return ckpt, flat(state.state_dict())


def test_a_missing_sidecar_falls_back_to_the_policy_with_the_references_warning(tmp_path, caplog):
    from torch.distributed.tensor import Replicate, Shard

    ckpt, ref = _single_save(tmp_path)
    ckpt._sharding_sidecar_file("s", 1).unlink()
    runtime.init_single()
    try:
        mesh = tmesh.create_mesh({"fsdp": 1}, device="cpu")
        with caplog.at_level(logging.WARNING, logger="dmlcloud_tpu_torch"):
            got = ckpt.restore_state(scope="s", mesh=mesh)
        assert "no sharding sidecar for scope 's' step 1" in caplog.text and "policy 'replicate'" in caplog.text
        assert all(t.placements == (Replicate(),) for t in got["params"].values())
        assert all(torch.equal(v, ref[k]) for k, v in flat(got).items())
        # a rule list matches the '/'-joined saved key and the torch shape
        rules = ckpt.restore_template(1, scope="s", mesh=mesh, policy=[("params/embed", tmesh.P("fsdp", None))])
        assert rules["params"]["embed.weight"].placements == (Shard(0),)
        assert rules["opt_state"]["mu"]["embed.weight"].placements == (Replicate(),)
    finally:
        runtime.deinitialize()


def test_a_damaged_sidecar_reads_as_none_and_the_restore_still_works(tmp_path):
    ckpt, ref = _single_save(tmp_path)
    assert ckpt.read_sharding_sidecar("s", 1)["specs"]
    ckpt._sharding_sidecar_file("s", 1).write_text("{not json")
    assert ckpt.read_sharding_sidecar("s", 1) is None
    ckpt._sharding_sidecar_file("s", 1).write_text(json.dumps({"v": 2, "specs": {}}))
    assert ckpt.read_sharding_sidecar("s", 1) is None
    runtime.init_single()
    try:
        got = ckpt.restore_state(scope="s", mesh=tmesh.create_mesh({"fsdp": 1}, device="cpu"))
        assert all(torch.equal(v, ref[k]) for k, v in flat(got).items())
    finally:
        runtime.deinitialize()
    with pytest.raises(ValueError, match="needs a template"):
        ckpt.restore_state(scope="s")


def test_sidecars_of_dropped_steps_are_pruned(tmp_path):
    state, _ = trained_state()
    ckpt = CheckpointDir(tmp_path / "run")
    ckpt.create()
    ckpt.state_manager("s", max_to_keep=1, async_save=False)
    for step in (1, 2, 3):
        ckpt.save_state(step, state.state_dict(), scope="s")
    # synchronous saves: steps 1 and 2 are gone before step 3's sidecar is written
    assert sorted(p.name for p in ckpt._sharding_sidecar_file("s", 1).parent.iterdir()) == ["3.json"]


def test_a_mid_epoch_resume_on_one_process_continues_the_mesh_run(results):
    control, resumed = results["lm control"], results["lm resumed"]
    # each process slices the same global batches: the epoch is as long on one
    # process, and the resume skips the 3 batches the two processes trained on
    assert len(resumed) == len(control) - SAVE_AT
    for got, want in zip(results["lm resumed batches"], results["lm control batches"][SAVE_AT:], strict=True):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(resumed, control[SAVE_AT:], rtol=RESUME_REL)


def test_a_mid_epoch_resume_of_a_sharded_dataset_skips_the_global_count(results):
    # 16 batches: 8 per rank at world 2, 3 steps = 6 global batches consumed
    assert results["sharded resumed"] == 16 - 2 * SAVE_AT
