"""Data parallelism of the port (``register_model(sharding="replicate")``)
across two gloo processes on the CPU, against one process and the JAX step.

Two processes (env:// rung) run, one after another, the cases below, each
writing what it saw to a pickle; the tests then read both ranks' files:

(a) ranks that build ``MnistCNN`` from different seeds hold rank 0's weights
    after ``register_model``, and bitwise equal parameters after every step;
(b) the world-2 trajectory (each rank feeding its half of every global batch)
    equals a world-1 port run on the global batches, and the one-device JAX
    step (``MnistCNN.apply`` + ``optax.adam(cosine_decay_schedule)``, plain
    ``jax.jit``) on the same batches, within ``TRAJ_REL`` (``JAX_REL``) per
    parameter in norm after every step;
(c) the same with ``gradient_accumulation() = 2`` and a global-norm clip;
(d) a parameter that one rank's step does not use neither hangs the reduction
    nor lets the replicas drift;
(e) the epoch-end metrics equal the world-1 run's;
(f) a ``DataLoader`` with a ``DistributedSampler`` gets ``set_epoch(e)`` every
    epoch, and the ranks' index sets are disjoint;
(g) a world-2 run checkpointed after epoch 1 and resumed at world 2 ends
    bitwise equal to the uninterrupted world-2 run.
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

import dmlcloud_tpu_torch as tdml
from dmlcloud_tpu.models.cnn import MnistCNN as JMnistCNN
from dmlcloud_tpu_torch.models.cnn import MnistCNN, load_flax_params, to_flax_params
from dmlcloud_tpu_torch.optim import adamw, cosine_decay_schedule
from dmlcloud_tpu_torch.utils import tcp

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
#: per-rank batch, processes, steps, learning rate, clip of case (c)
B, WORLD, K, LR, CLIP = 4, 2, 4, 1e-3, 0.5
#: ||got - want|| / ||want|| per parameter after every step, fp32, world 2
#: against world 1: the two sum the batch in another order (per-rank means,
#: then their mean; or one mean over the global batch), which Adam's
#: per-element normalisation carries into the updates (measured <= 1e-6)
TRAJ_REL = 1e-5
#: the same against the JAX step, and its losses (relative): XLA's and
#: torch's CPU convolutions round differently (measured <= 2.8e-5); the bound
#: tests/test_torch_train.py holds the port's LM steps to
JAX_REL = 1e-4
#: per-step losses and epoch metrics of world 2 against world 1, relative
LOSS_RTOL = 1e-5


def global_batches(k: int = K, seed: int = 0) -> list[dict]:
    rng = np.random.RandomState(seed)
    return [{"image": rng.rand(WORLD * B, 28, 28, 1).astype(np.float32),
             "label": rng.randint(0, 10, WORLD * B).astype(np.int64)} for _ in range(k)]


_WORKER = textwrap.dedent(
    """
    import os, pickle, sys
    import numpy as np
    import torch
    import torch.nn.functional as F
    from torch.utils.data import DataLoader, DistributedSampler, TensorDataset
    sys.path.insert(0, os.environ["TEST_DIR"])
    import dmlcloud_tpu_torch as dml
    from dmlcloud_tpu_torch.models.cnn import MnistCNN
    from dmlcloud_tpu_torch.optim import adamw, cosine_decay_schedule
    from dmlcloud_tpu_torch.parallel import runtime
    from test_torch_data_parallel import B, CLIP, LR, global_batches

    torch.set_num_threads(1)
    assert runtime.init_auto(device="cpu") == "gloo"
    rank, out_dir = runtime.rank(), os.environ["OUT_DIR"]
    local = [{k: v[rank * B:(rank + 1) * B] for k, v in g.items()} for g in global_batches()]

    def params(model):
        return {n: p.detach().numpy().copy() for n, p in model.named_parameters()}

    class Mnist(dml.TrainValStage):
        def __init__(self, accum=1, clip=0.0, train=local, val=None):
            super().__init__()
            self.accum, self.clip, self.train, self.val, self.snaps = accum, clip, train, val, []

        def pre_stage(self):
            # every rank starts from its own weights: the broadcast must equalise them
            model = MnistCNN(generator=torch.Generator().manual_seed(100 + rank))
            self.before = params(model)
            self.pipeline.register_model("cnn", model, sharding="replicate", verbose=False)
            self.registered = params(model)
            schedule = cosine_decay_schedule(LR, decay_steps=1000)
            self.pipeline.register_optimizer("adam", adamw(schedule, weight_decay=0.0), scheduler=schedule)
            self.pipeline.register_dataset("train", self.train, verbose=False)
            if self.val is not None:
                self.pipeline.register_dataset("val", self.val, verbose=False)

        def gradient_accumulation(self):
            return self.accum

        def gradient_clip(self):
            return self.clip

        def step(self, state, batch):
            logits = state.model(batch["image"])
            acc = (logits.argmax(-1) == batch["label"]).float().mean()
            return F.cross_entropy(logits, batch["label"]), {"accuracy": acc}

        def _train_step(self, batch):
            metrics = super()._train_step(batch)
            self.snaps.append(params(self.state.model))
            return metrics

    def run(stage, epochs=1, **kw):
        pipe = dml.TrainingPipeline({"seed": 0}, name="dp", device="cpu", **kw)
        pipe.append_stage(stage, max_epochs=epochs)
        return pipe, stage

    out = {"rank": rank}
    # (a), (b), (e): plain steps, then validation on the same batches
    pipe, stage = run(Mnist(val=local[:2]))
    pipe.run()
    out["plain"] = {"before": stage.before, "registered": stage.registered, "snaps": stage.snaps,
                    "losses": [float(x) for x in stage.train_losses],
                    "metrics": {n: float(pipe.tracker[n][-1]) for n in
                                ("train/loss", "train/accuracy", "val/loss", "val/accuracy",
                                 "misc/total_train_batches", "misc/worker_train_batches")}}
    # (c): two microbatches and a clip
    pipe, stage = run(Mnist(accum=2, clip=CLIP))
    pipe.run()
    out["accum_clip"] = {"snaps": stage.snaps, "losses": [float(x) for x in stage.train_losses]}

    # (d): rank 0's step never uses the second layer
    class TwoLayers(dml.TrainValStage):
        def pre_stage(self):
            torch.manual_seed(0)
            self.pipeline.register_model("m", torch.nn.ModuleDict({"a": torch.nn.Linear(4, 1),
                                                                   "b": torch.nn.Linear(4, 1)}), verbose=False)
            self.pipeline.register_optimizer("sgd", adamw(1e-2, weight_decay=0.0))
            self.pipeline.register_dataset("train", [np.full((2, 4), float(i + rank), np.float32)
                                                     for i in range(3)], verbose=False)
            self.start = params(self.pipeline.models["m"].module)

        def step(self, state, x):
            loss = state.model["a"](x).square().mean()
            return loss + state.model["b"](x).square().mean() if rank == 1 else loss

    pipe, stage = run(TwoLayers())
    pipe.run()
    out["unused"] = {"start": stage.start, "end": params(stage.state.model)}

    # (f): a DataLoader over a DistributedSampler, 2 epochs
    class Sampled(dml.TrainValStage):
        def pre_stage(self):
            self.seen = {}
            data = TensorDataset(torch.arange(16, dtype=torch.float32)[:, None], torch.arange(16))
            sampler = DistributedSampler(data, num_replicas=runtime.world_size(), rank=rank, shuffle=True, seed=0)
            self.pipeline.register_dataset("train", DataLoader(data, batch_size=2, sampler=sampler), verbose=False)
            self.pipeline.register_model("m", torch.nn.Linear(1, 1), verbose=False)
            self.pipeline.register_optimizer("adam", adamw(1e-3))

        def step(self, state, batch):
            x, idx = batch
            sampler = self.pipeline.datasets["train"].sampler
            self.seen.setdefault(self.current_epoch, {"sampler_epoch": sampler.epoch, "idx": []})
            self.seen[self.current_epoch]["idx"] += idx.tolist()
            return state.model(x).square().mean()

    pipe, stage = run(Sampled(), epochs=2)
    pipe.run()
    out["sampler"] = stage.seen

    # (g): 2 epochs uninterrupted, and 1 epoch then a resume to 2, both checkpointed
    def final(stage):
        sd = stage.state.state_dict()
        return {"params": {n: t.numpy().copy() for n, t in sd["params"].items()},
                "mu": {n: t.numpy().copy() for n, t in sd["opt_state"]["mu"].items()},
                "nu": {n: t.numpy().copy() for n, t in sd["opt_state"]["nu"].items()},
                "step": stage.state.step, "count": stage.state.optimizer.count,
                "losses": [float(x) for x in stage.train_losses]}

    root = os.environ["CKPT_ROOT"]
    pipe, stage = run(Mnist(), epochs=2)
    pipe.enable_checkpointing(os.path.join(root, "uninterrupted"))
    pipe.run()
    out["ckpt_uninterrupted"] = final(stage)
    pipe, stage = run(Mnist(), epochs=1)
    pipe.enable_checkpointing(os.path.join(root, "interrupted"))
    pipe.run()
    run_dir = str(pipe.checkpoint_dir.path)
    pipe, stage = run(Mnist(), epochs=2)
    pipe.enable_checkpointing(run_dir, resume=True)
    pipe.run()
    out["ckpt_resumed"] = final(stage)
    out["ckpt_resumed_flag"] = bool(pipe.resumed)

    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    runtime.barrier("done", timeout=60)
    runtime.deinitialize()
    """
)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("dp_out")
    ckpt = tmp_path_factory.mktemp("dp_ckpt")
    port = tcp.find_free_port()
    procs = []
    for rank in range(WORLD):
        env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(rank),
                   WORLD_SIZE=str(WORLD), OMP_NUM_THREADS="1", PYTHONPATH=str(REPO),
                   TEST_DIR=str(Path(__file__).parent), OUT_DIR=str(out_dir), CKPT_ROOT=str(ckpt))
        # output to files: a full pipe would block one rank inside a collective, and with it the other
        with open(out_dir / f"log{rank}.txt", "w") as log:
            procs.append(subprocess.Popen([sys.executable, "-c", _WORKER], env=env, cwd=out_dir,
                                          stdout=log, stderr=subprocess.STDOUT))
    try:
        for p in procs:
            p.wait(timeout=240)
    finally:
        for p in procs:
            p.kill()
    for rank, p in enumerate(procs):
        assert p.returncode == 0, (out_dir / f"log{rank}.txt").read_text()[-4000:]
    return [pickle.loads((out_dir / f"rank{r}.pkl").read_bytes()) for r in range(WORLD)]


def _assert_equal_trees(a: dict, b: dict, what: str) -> None:
    assert a.keys() == b.keys(), what
    for n in a:
        np.testing.assert_array_equal(a[n], b[n], err_msg=f"{what}: {n}")


def _rel(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _world1_port(start: dict, accum: int = 1, clip: float = 0.0, val: bool = False):
    """The port at world 1 on the global batches, from ``start`` (torch names)."""

    class Stage(tdml.TrainValStage):
        snaps = []

        def pre_stage(self):
            model = MnistCNN()
            with torch.no_grad():
                for n, p in model.named_parameters():
                    p.copy_(torch.from_numpy(start[n]))
            self.pipeline.register_model("cnn", model, verbose=False)
            schedule = cosine_decay_schedule(LR, decay_steps=1000)
            self.pipeline.register_optimizer("adam", adamw(schedule, weight_decay=0.0), scheduler=schedule)
            self.pipeline.register_dataset("train", global_batches(), verbose=False)
            if val:
                self.pipeline.register_dataset("val", global_batches()[:2], verbose=False)

        def gradient_accumulation(self):
            return accum

        def gradient_clip(self):
            return clip

        def step(self, state, batch):
            logits = state.model(batch["image"])
            acc = (logits.argmax(-1) == batch["label"]).float().mean()
            return torch.nn.functional.cross_entropy(logits, batch["label"]), {"accuracy": acc}

        def _train_step(self, batch):
            metrics = super()._train_step(batch)
            self.snaps.append({n: p.detach().numpy().copy() for n, p in self.state.model.named_parameters()})
            return metrics

    pipe = tdml.TrainingPipeline({"seed": 0}, name="w1", device="cpu")
    stage = Stage()
    stage.snaps = []
    pipe.append_stage(stage, max_epochs=1)
    pipe.run()
    return pipe, stage


def _jax_trajectory(start: dict, clip: float = 0.0) -> tuple[list[dict], list[float]]:
    """One-device JAX steps on the global batches: the reference model's
    apply, optax.adam over the cosine schedule, the reference's clip."""
    model = JMnistCNN()
    tx = optax.adam(optax.cosine_decay_schedule(LR, decay_steps=1000))

    def loss_fn(params, x, y):
        logits = model.apply({"params": params}, x)
        return optax.softmax_cross_entropy_with_integer_labels(logits, y).mean()

    @jax.jit
    def step(params, opt_state, x, y):
        loss, grads = jax.value_and_grad(loss_fn)(params, x, y)
        if clip > 0.0:
            sq = sum(jnp.sum(g.astype(jnp.float32) ** 2) for g in jax.tree_util.tree_leaves(grads))
            scale = jnp.minimum(1.0, clip * jax.lax.rsqrt(jnp.maximum(sq, 1e-12)))
            grads = jax.tree_util.tree_map(lambda g: g * scale.astype(g.dtype), grads)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    ported = MnistCNN()
    with torch.no_grad():
        for n, p in ported.named_parameters():
            p.copy_(torch.from_numpy(start[n]))
    params = jax.tree_util.tree_map(jnp.asarray, to_flax_params(ported))
    opt_state = tx.init(params)
    snaps, losses = [], []
    for g in global_batches():
        params, opt_state, loss = step(params, opt_state, g["image"], g["label"])
        losses.append(float(loss))
        load_flax_params(ported, jax.tree_util.tree_map(np.asarray, params))
        snaps.append({n: p.detach().numpy().copy() for n, p in ported.named_parameters()})
    return snaps, losses


def test_a_register_model_broadcasts_rank0_and_replicas_stay_bitwise_equal(ranks):
    r0, r1 = ranks[0]["plain"], ranks[1]["plain"]
    assert any(not np.array_equal(r0["before"][n], r1["before"][n]) for n in r0["before"]), \
        "the ranks started equal: the broadcast would be untested"
    _assert_equal_trees(r1["registered"], r0["before"], "rank 1 after register_model vs rank 0's init")
    _assert_equal_trees(r0["registered"], r0["before"], "rank 0 after register_model")
    for case in ("plain", "accum_clip"):
        assert len(ranks[0][case]["snaps"]) == K
        for step, (a, b) in enumerate(zip(ranks[0][case]["snaps"], ranks[1][case]["snaps"])):
            _assert_equal_trees(a, b, f"{case}, step {step + 1}, rank 0 vs rank 1")


@pytest.mark.parametrize("case", ["plain", "accum_clip"])
def test_bc_world2_trajectory_equals_world1_and_the_jax_step(ranks, case):
    accum, clip = (2, CLIP) if case == "accum_clip" else (1, 0.0)
    start = ranks[0]["plain"]["registered"]
    _, w1 = _world1_port(start, accum=accum, clip=clip)
    j_snaps, j_losses = _jax_trajectory(start, clip=clip)
    w2 = ranks[0][case]
    # the global batch's mean loss is the mean of the two ranks' means
    w2_losses = np.mean([ranks[r][case]["losses"] for r in range(WORLD)], axis=0)
    np.testing.assert_allclose(w2_losses, [float(x) for x in w1.train_losses], rtol=LOSS_RTOL)
    np.testing.assert_allclose(w2_losses, j_losses, rtol=JAX_REL)
    moved = 0.0
    for step in range(K):
        for n, want in w1.snaps[step].items():
            got = w2["snaps"][step][n]
            assert _rel(got, want) <= TRAJ_REL, f"{case} step {step + 1} {n}: world 2 vs world 1 {_rel(got, want):.3g}"
            assert _rel(got, j_snaps[step][n]) <= JAX_REL, \
                f"{case} step {step + 1} {n}: world 2 vs JAX {_rel(got, j_snaps[step][n]):.3g}"
            moved = max(moved, _rel(got, start[n]))
    assert moved > 1e-2, "the steps did not move the weights: the comparison would be vacuous"


def test_d_a_parameter_unused_on_one_rank_is_averaged_not_hung(ranks):
    u0, u1 = ranks[0]["unused"], ranks[1]["unused"]
    _assert_equal_trees(u0["end"], u1["end"], "replicas after steps with a rank-local unused layer")
    assert not np.array_equal(u0["end"]["b.weight"], u0["start"]["b.weight"]), \
        "rank 0 did not apply rank 1's gradient of the layer it does not use"


def test_e_epoch_metrics_equal_the_world1_run(ranks):
    _, w1 = _world1_port(ranks[0]["plain"]["registered"], val=True)
    for r in range(WORLD):
        got = ranks[r]["plain"]["metrics"]
        for name in ("train/loss", "train/accuracy", "val/loss", "val/accuracy"):
            np.testing.assert_allclose(got[name], float(w1.tracker[name][-1]), rtol=LOSS_RTOL, err_msg=name)
        assert got["misc/total_train_batches"] == WORLD * K  # summed over the ranks
        assert got["misc/worker_train_batches"] == K


def test_f_distributed_sampler_sees_set_epoch_and_disjoint_shards(ranks):
    seen = [ranks[r]["sampler"] for r in range(WORLD)]
    for epoch in (1, 2):
        assert [s[epoch]["sampler_epoch"] for s in seen] == [epoch, epoch]
        shards = [set(s[epoch]["idx"]) for s in seen]
        assert not shards[0] & shards[1] and shards[0] | shards[1] == set(range(16))
    assert seen[0][1]["idx"] != seen[0][2]["idx"], "epoch 2 repeated epoch 1's shuffle"


def test_g_world2_checkpoint_resume_is_bitwise(ranks):
    for r in range(WORLD):
        want, got = ranks[r]["ckpt_uninterrupted"], ranks[r]["ckpt_resumed"]
        assert ranks[r]["ckpt_resumed_flag"]
        assert (got["step"], got["count"]) == (want["step"], want["count"]) == (2 * K, 2 * K)
        for part in ("params", "mu", "nu"):
            _assert_equal_trees(got[part], want[part], f"rank {r} resumed {part}")
        # both hold their last epoch's losses: epoch 2
        assert len(got["losses"]) == K and got["losses"] == want["losses"]
    _assert_equal_trees(ranks[0]["ckpt_resumed"]["params"], ranks[1]["ckpt_resumed"]["params"], "resumed replicas")


@pytest.mark.parametrize("sharding", ["fsdp", [("embed", "data")], lambda name, shape: None])
def test_register_model_refuses_every_policy_but_replicate(sharding):
    # the policies are ported (tests/test_torch_mesh.py, test_torch_fsdp.py):
    # on the default mesh, {data: world}, each of them leaves every parameter
    # replicated, the data-parallel path; what is refused is a policy that is none
    pipe = tdml.TrainingPipeline(device="cpu")
    pipe.register_model("m", torch.nn.Linear(2, 2), sharding=sharding, verbose=False)
    assert pipe.models["m"].plan is None
    assert all(type(p) is torch.nn.Parameter for p in pipe.models["m"].module.parameters())
    with pytest.raises(ValueError, match="unknown sharding policy"):
        pipe.register_model("n", torch.nn.Linear(2, 2), sharding="zero3", verbose=False)
    assert "n" not in pipe.models


def test_world_one_launches_no_collective(monkeypatch):
    from dmlcloud_tpu_torch.parallel import data_parallel

    def refuse(*a, **k):
        raise AssertionError("a collective ran at world size 1")

    monkeypatch.setattr(torch.distributed, "all_reduce", refuse)
    monkeypatch.setattr(torch.distributed, "broadcast", refuse)
    model = torch.nn.Linear(3, 2)
    model(torch.ones(4, 3)).sum().backward()
    grads = [p.grad.clone() for p in model.parameters()]
    data_parallel.broadcast_parameters(model)
    data_parallel.all_reduce_gradients(model.parameters())
    assert all(torch.equal(p.grad, g) for p, g in zip(model.parameters(), grads))


@pytest.mark.parametrize("bucket_bytes", [4, 12, 40, 1 << 20])
def test_buckets_cover_every_element_once_and_cast_back(bucket_bytes):
    """The packing alone, with a collective that doubles its buffer: tensors
    straddling bucket edges and low-precision tensors (packed in fp32, cast
    back) come back doubled, each element once."""
    from dmlcloud_tpu_torch.parallel import data_parallel

    rng = np.random.RandomState(0)
    tensors = [torch.from_numpy(rng.randn(*shape).astype(np.float32)) for shape in [(3,), (2, 5), (7,), (1,)]]
    tensors.append(torch.from_numpy(rng.randn(6).astype(np.float32)).to(torch.bfloat16))
    want = [t.float() * 2 for t in tensors]
    calls = []
    data_parallel._bucketed(tensors, torch.float32, lambda buf: (calls.append(buf.numel()), buf.mul_(2)),
                            bucket_bytes)
    for got, w in zip(tensors, want):
        torch.testing.assert_close(got.float(), w.to(got.dtype).float(), rtol=0, atol=0)
    assert sum(calls) == sum(t.numel() for t in tensors)
    assert max(calls) <= max(bucket_bytes // 4, 1)
