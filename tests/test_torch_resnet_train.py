"""Training the port's ResNet through its pipeline, on the CPU: the stage
against the JAX stage, global BatchNorm statistics over two gloo processes,
and the module buffers in checkpoints.

- Three ``TrainValStage`` steps of ResNet-18 (32x32, batch 8, fp32,
  ``sgd(0.1, momentum=0.9)``) against the JAX stage's 3-tuple step (``loss,
  metrics, {"batch_stats"}``, ``optax.sgd``) from the same bridged weights:
  losses, parameters and running statistics within ``STEP_REL``, momentum
  within ``TRACE_REL`` (norm-relative over the tree).
- Two gloo processes, each feeding half of every global batch, against one
  process on the whole batch: with the BatchNorm statistics summed over the
  data-parallel group (``ResNet.apply_data_parallel``, which
  ``register_model`` calls) the losses, parameters and running statistics
  agree within ``DP_REL``; with per-process statistics they do not.
- The buffer-resume guard: a model with a BatchNorm, preempted mid-epoch by a
  real SIGUSR1 at a step save and resumed, ends bitwise equal to an
  uninterrupted run, running statistics included (``TrainState.state_dict()``
  carries the persistent buffers under ``"extras"``; before, a resumed run
  restarted them). The same for a small ResNet with ``sgd`` momentum; a
  non-persistent buffer stays out, the EMA covers the parameters only, and the
  ``DecoderLM``'s checkpoint keys are unchanged.
"""

import os
import pickle
import signal
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
import torch.nn.functional as F

import dmlcloud_tpu as jdml
import dmlcloud_tpu_torch as tdml
from dmlcloud_tpu.models import resnet as jr
from dmlcloud_tpu.parallel import mesh as jmesh
from dmlcloud_tpu_torch.models import resnet as tr
from dmlcloud_tpu_torch.optim import adamw, sgd
from dmlcloud_tpu_torch.parallel import runtime
from dmlcloud_tpu_torch.train_state import TrainState
from dmlcloud_tpu_torch.utils import tcp

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
SIZE, BATCH, CLASSES, STEPS = 32, 8, 10, 3
#: the port's stage against the JAX stage after 3 steps, relative (losses)
#: and norm-relative (over the tree): the two sides' convolutions round differently
#: and SGD momentum carries that into the next steps' weights
STEP_REL = 1e-4
#: the momentum is a sum of gradients, and XLA:CPU's fp32 gradients of this
#: model are 1e-3 to 1e-2 from its own float64 ones once the blocks' last
#: BatchNorm scales leave 0 (tests/test_torch_resnet.py)
TRACE_REL = 1e-3
#: two processes against one: the global statistics' sums run in another order
DP_REL = 1e-5


def _batches(n: int = STEPS, size: int = SIZE, seed: int = 7) -> list[dict]:
    rng = np.random.RandomState(seed)
    return [{"image": rng.rand(BATCH, size, size, 3).astype(np.float32), "label": rng.randint(0, CLASSES, BATCH)}
            for _ in range(n)]


def _variables(seed: int = 0) -> dict:
    return tr.to_flax_params(tr.ResNet18(num_classes=CLASSES, dtype=torch.float32, device="cpu",
                                         generator=torch.Generator().manual_seed(seed)))


class ResNetStage(tdml.TrainValStage):
    """ResNet-18 from bridged ``variables`` on this process's rows of each
    global batch; ``local_stats`` turns the global BatchNorm statistics off."""

    def __init__(self, variables, batches, local_stats=False):
        super().__init__()
        self.variables, self.batches, self.local_stats = variables, batches, local_stats

    def pre_stage(self):
        model = tr.load_flax_params(tr.ResNet18(num_classes=CLASSES, dtype=torch.float32, device="cpu"),
                                    self.variables)
        self.pipeline.register_model("resnet", model, verbose=False)
        if self.local_stats:
            model.apply_data_parallel(None)
        self.pipeline.register_optimizer("sgd", sgd(0.1, momentum=0.9))
        world, rank = runtime.world_size(), runtime.rank()
        rows = slice(rank * BATCH // world, (rank + 1) * BATCH // world)
        self.pipeline.register_dataset("train", [{k: v[rows] for k, v in b.items()} for b in self.batches],
                                       verbose=False)

    def step(self, state, batch):
        return F.cross_entropy(state.model(batch["image"]), batch["label"].long())

    def val_epoch(self):
        pass


def run_port(variables, batches, local_stats=False) -> dict:
    pipe = tdml.TrainingPipeline({"seed": 0}, name="resnet", device="cpu")
    stage = ResNetStage(variables, batches, local_stats)
    pipe.append_stage(stage, max_epochs=1)
    pipe.run()
    model = stage.state.model
    names = {p: n for n, p in model.named_parameters()}
    per_rank = runtime.all_gather_object([float(x) for x in stage.train_losses])
    return {"losses": [float(np.mean(s)) for s in zip(*per_rank)], "variables": tr.to_flax_params(model),
            "trace": tr.to_flax_params(model, {names[p]: s["trace"] for p, s in stage.state.optimizer.state.items()}),
            "groups": sorted({str(m.group) for m in model.modules() if isinstance(m, tr.BatchNorm)})}


def run_jax(variables, batches) -> dict:
    class Stage(jdml.TrainValStage):
        def pre_stage(self):
            self.pipeline.register_model("resnet", jr.ResNet18(num_classes=CLASSES, dtype=jnp.float32),
                                         params=variables, verbose=False)
            self.pipeline.register_optimizer("sgd", optax.sgd(0.1, momentum=0.9))
            self.pipeline.register_dataset("train", batches, verbose=False)

        def step(self, state, batch):
            logits, new = state.apply_fn({"params": state.params, **state.extras}, batch["image"], train=True,
                                         mutable=["batch_stats"])
            loss = optax.softmax_cross_entropy_with_integer_labels(logits, batch["label"]).mean()
            return loss, {}, {"batch_stats": new["batch_stats"]}

        def val_epoch(self):
            pass

        def _build_train_step(self):
            jitted = super()._build_train_step()

            def recorded(state, batch):
                state, metrics = jitted(state, batch)
                self.step_losses.append(float(metrics["loss"]))
                return state, metrics

            return recorded

    pipe = jdml.TrainingPipeline({"seed": 0}, name="jax-resnet")
    pipe.set_mesh(jmesh.create_mesh({"data": 1}, devices=jax.devices()[:1]))
    stage = Stage()
    stage.step_losses = []
    pipe.append_stage(stage, max_epochs=1)
    pipe.run()
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
    trace = stage.state.opt_state[0].trace
    return {"losses": stage.step_losses,
            "variables": {"params": to_np(stage.state.params), "batch_stats": to_np(stage.state.extras["batch_stats"])},
            "trace": {"params": to_np(trace)}}


def _assert_trees_close(got: dict, want: dict, rel: float, what: str) -> None:
    """Norm-relative error over the whole tree (per leaf, leaves whose
    gradients nearly cancel under batch statistics, such as the bias of a
    BatchNorm that feeds another one, would measure rounding noise)."""
    g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    pairs = [(g[path], w, path) for path, w in jax.tree_util.tree_flatten_with_path(want)[0]]
    err = float(np.sqrt(sum(np.sum((a - b) ** 2) for a, b, _ in pairs) / sum(np.sum(b**2) for _, b, _ in pairs)))
    worst = max(pairs, key=lambda t: np.linalg.norm(t[0] - t[1]))[2]
    assert err <= rel, f"{what}: relative error {err:.3g} > {rel} (largest at {jax.tree_util.keystr(worst)})"


def test_three_steps_match_the_jax_stage(single_runtime):
    variables, batches = _variables(), _batches()
    want = run_jax(variables, batches)
    got = run_port(variables, batches)
    assert len(got["losses"]) == len(want["losses"]) == STEPS
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=STEP_REL)
    _assert_trees_close(got["variables"], want["variables"], STEP_REL, "variables")
    _assert_trees_close(got["trace"], want["trace"], TRACE_REL, "momentum")
    assert got["groups"] == ["None"], "one process: no collective"
    moved = max(float(np.abs(a - b).max()) for a, b in zip(jax.tree_util.tree_leaves(got["variables"]),
                                                           jax.tree_util.tree_leaves(variables)))
    assert moved > 1e-2, "the steps did not move the weights: the comparison would be vacuous"


_WORKER = textwrap.dedent(
    """
    import os, pickle, sys
    import torch
    sys.path.insert(0, os.environ["TEST_DIR"])
    from dmlcloud_tpu_torch.parallel import runtime
    from test_torch_resnet_train import _batches, run_port

    torch.set_num_threads(1)
    assert runtime.init_auto(device="cpu") == "gloo"
    variables = pickle.loads(open(os.environ["INIT"], "rb").read())
    out = {"global": run_port(variables, _batches()), "local": run_port(variables, _batches(), local_stats=True)}
    runtime.barrier("done", timeout=60)
    if runtime.rank() == 0:
        with open(os.path.join(os.environ["OUT_DIR"], "world2.pkl"), "wb") as f:
            pickle.dump(out, f)
    """
)


def test_two_processes_on_half_batches_match_one_on_the_whole(tmp_path):
    variables = _variables(seed=1)
    init = tmp_path / "init.pkl"
    init.write_bytes(pickle.dumps(variables))
    port = tcp.find_free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(rank), WORLD_SIZE="2",
                   OMP_NUM_THREADS="1", PYTHONPATH=str(REPO), TEST_DIR=str(Path(__file__).parent),
                   OUT_DIR=str(tmp_path), INIT=str(init))
        # output to files: a full pipe would block one rank inside a collective
        with open(tmp_path / f"log{rank}.txt", "w") as log:
            procs.append(subprocess.Popen([sys.executable, "-c", _WORKER], env=env, cwd=tmp_path, stdout=log,
                                          stderr=subprocess.STDOUT))
    try:
        for p in procs:
            p.wait(timeout=240)
    finally:
        for p in procs:
            p.kill()
    for rank, p in enumerate(procs):
        assert p.returncode == 0, (tmp_path / f"log{rank}.txt").read_text()[-4000:]
    two = pickle.loads((tmp_path / "world2.pkl").read_bytes())
    runtime.init_single()
    try:
        one = run_port(variables, _batches())
    finally:
        runtime.deinitialize()
    got = two["global"]
    assert got["groups"] != ["None"], "register_model did not hand the data-parallel group to the BatchNorms"
    np.testing.assert_allclose(got["losses"], one["losses"], rtol=DP_REL)
    _assert_trees_close(got["variables"], one["variables"], DP_REL, "world 2")
    # per-process statistics are a different computation: the test can tell
    local = two["local"]
    stats_err = max(float(np.abs(a - b).max()) for a, b in zip(
        jax.tree_util.tree_leaves(local["variables"]["batch_stats"]),
        jax.tree_util.tree_leaves(one["variables"]["batch_stats"])))
    assert stats_err > 100 * DP_REL


# ---------------------------------------------------------------------------
# module buffers through a preempt-and-resume
# ---------------------------------------------------------------------------

class _SignalAfter:
    """A dataset that sends this process SIGUSR1 after yielding batch ``k``."""

    def __init__(self, ds, k: int):
        self.ds, self.k = ds, k

    def __iter__(self):
        for i, batch in enumerate(self.ds):
            yield batch
            if i + 1 == self.k:
                os.kill(os.getpid(), signal.SIGUSR1)

    def __len__(self):
        return len(self.ds)


def _bn_mlp() -> torch.nn.Module:
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(4, 16), torch.nn.BatchNorm1d(16), torch.nn.ReLU(),
                                torch.nn.Linear(16, 3))
    model.register_buffer("table", torch.arange(3.0), persistent=False)
    return model


def _small_resnet() -> torch.nn.Module:
    return tr.ResNet(stage_sizes=[1, 1], block_cls=tr.BasicBlock, num_classes=3, num_filters=8,
                     dtype=torch.float32, device="cpu")


def _resume_batches(kind: str) -> list[dict]:
    rng = np.random.RandomState(3)
    shape = (8, 4) if kind == "mlp" else (8, 16, 16, 3)
    return [{"x": rng.randn(*shape).astype(np.float32), "y": rng.randint(0, 3, 8)} for _ in range(6)]


def _resume_run(kind, root=None, resume=False, signal_after=None):
    make, tx = (_bn_mlp, adamw(0.05)) if kind == "mlp" else (_small_resnet, sgd(0.1, momentum=0.9))

    class Stage(tdml.TrainValStage):
        def pre_stage(self):
            self.pipeline.register_model("m", make(), verbose=False)
            self.pipeline.register_optimizer("opt", tx)
            ds = _resume_batches(kind)
            self.pipeline.register_dataset("train", ds if signal_after is None else _SignalAfter(ds, signal_after),
                                           verbose=False)

        def checkpoint_every_steps(self):
            return 2

        def ema_decay(self):
            return 0.9

        def step(self, state, batch):
            return F.cross_entropy(state.model(batch["x"]), batch["y"].long())

        def val_epoch(self):
            pass

    pipe = tdml.TrainingPipeline({"seed": 0}, name=f"bn-{kind}", device="cpu")
    if root is not None:
        pipe.enable_checkpointing(str(root), resume=resume)
    if signal_after is not None:
        pipe.enable_preemption_handling(("SIGUSR1",))
    stage = Stage()
    pipe.append_stage(stage, max_epochs=1)
    pipe.run()
    return pipe, stage


def _flat(sd: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in sd.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("kind", ["mlp", "resnet"])
def test_preempted_and_resumed_equals_uninterrupted_running_statistics_included(tmp_path, kind):
    _, control = _resume_run(kind)
    pipe1, stage1 = _resume_run(kind, root=tmp_path, resume=True, signal_after=3)
    assert stage1._mid_epoch_exit and stage1.state.step == 4
    pipe2, stage2 = _resume_run(kind, root=pipe1.checkpoint_dir.path, resume=True)
    assert pipe2.resumed and stage2.state.step == control.state.step == 6
    got, want = _flat(stage2.state.state_dict()), _flat(control.state.state_dict())
    assert got.keys() == want.keys()
    buffers = [k for k in want if k.startswith("extras/")]
    assert buffers and all("running_" in k or "num_batches_tracked" in k for k in buffers), buffers
    for key in want:
        assert torch.equal(got[key], want[key]), key
    resumed = dict(stage2.state.model.named_buffers())
    for name, buf in control.state.model.named_buffers():
        assert torch.equal(resumed[name], buf), name
    for a, b in zip(stage2.train_losses, control.train_losses[4:]):
        assert torch.equal(a, b)


def test_state_dict_carries_persistent_buffers_only_and_the_ema_covers_parameters():
    model = _bn_mlp()
    state = TrainState.create(model=model, tx=adamw(0.1), ema=True)
    sd = state.state_dict()
    assert sorted(sd["extras"]) == ["1.num_batches_tracked", "1.running_mean", "1.running_var"]
    assert sd["extras"]["1.running_mean"] is model[1].running_mean  # the live tensor
    assert sorted(state.ema) == sorted(n for n, _ in model.named_parameters())
    # loading copies into the live buffers
    new = {**sd, "extras": {k: v + 1 for k, v in sd["extras"].items()}}
    before = model[1].running_var.clone()
    state.load_state_dict(new)
    assert torch.equal(model[1].running_var, before + 1)

    resnet = tr.ResNet18(num_classes=CLASSES, device="cpu")
    rstate = TrainState.create(model=resnet, tx=sgd(0.1, momentum=0.9), ema=True)
    assert sorted(rstate.ema) == sorted(n for n, _ in resnet.named_parameters())
    assert len(rstate.state_dict()["extras"]) == 2 * sum(isinstance(m, tr.BatchNorm) for m in resnet.modules())


def test_decoder_checkpoint_keys_are_unchanged():
    from dmlcloud_tpu_torch.models.transformer import DecoderLM, TransformerConfig

    cfg = TransformerConfig(vocab_size=64, num_layers=1, num_heads=2, head_dim=8, hidden_dim=16, mlp_dim=32,
                            max_seq_len=16)
    sd = TrainState.create(model=DecoderLM(cfg, device="cpu"), tx=adamw(0.1), ema=True).state_dict()
    assert sorted(sd) == ["ema", "opt_state", "params", "step"]  # the rotary tables are not persistent
