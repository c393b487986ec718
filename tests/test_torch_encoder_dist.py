"""The encoder families across two gloo processes on the CPU, against one
process on the global batch.

- ``clip_loss`` with the data-parallel group: each process holds half of the
  embeddings; the mean of the two losses equals the one-process loss of the
  global batch, and each process's gradients of its own embeddings, once the
  stage's average over the processes divides them by 2, equal the
  one-process gradients, all within ``REL``. The gather's backward sums the
  ranks' gradients: a backward that averaged them, or that kept only this
  rank's own part, would be off by far more, which the test also shows.
- BERT (the sequence classifier) registered with ``encoder_partition_rules()``
  on ``fsdp=2`` (FSDP2 over the encoder blocks) and on ``data=2``: three AdamW
  steps, each process feeding its rows of the global batch; losses and the
  gathered parameters within ``REL`` of one process (the attention key biases
  left out: the softmax does not depend on them, so their gradients are
  rounding noise, which AdamW scales to steps of the learning rate's size).
- A ``model`` axis raises ``NotImplementedError`` (ROADMAP Queue 1 item 11).
"""

import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import dmlcloud_tpu_torch as tdml
from dmlcloud_tpu_torch.models import bert as tb
from dmlcloud_tpu_torch.models import clip as tc
from dmlcloud_tpu_torch.models.encoder import encoder_partition_rules
from dmlcloud_tpu_torch.optim import adamw
from dmlcloud_tpu_torch.parallel import mesh as tmesh
from dmlcloud_tpu_torch.parallel import runtime
from dmlcloud_tpu_torch.utils import tcp

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
#: two processes against one, fp32: sums over the batch run in another order
REL = 1e-5
BERT = dict(vocab_size=128, max_seq_len=32, hidden_dim=64, num_layers=2, num_heads=4, mlp_dim=128)
GLOBAL, DIM, STEPS = 8, 16, 3


def embeddings() -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.RandomState(0)
    img, txt = rng.randn(GLOBAL, DIM), rng.randn(GLOBAL, DIM)
    return [(a / np.linalg.norm(a, axis=-1, keepdims=True)).astype(np.float32) for a in (img, txt)]


class _AveragingGather(torch.autograd.Function):
    """A wrong gather for the test: its backward AVERAGES the ranks' gradients."""

    @staticmethod
    def forward(ctx, x, group):
        parts = [torch.empty_like(x) for _ in range(torch.distributed.get_world_size(group))]
        torch.distributed.all_gather(parts, x.contiguous(), group=group)
        ctx.group, ctx.n = group, x.shape[0]
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        torch.distributed.all_reduce(g, group=ctx.group)
        world, rank = torch.distributed.get_world_size(ctx.group), torch.distributed.get_rank(ctx.group)
        return g[rank * ctx.n:(rank + 1) * ctx.n] / world, None


def clip_case(group, averaging: bool = False) -> dict:
    """``clip_loss`` of this process's rows (all rows without ``group``) and
    the gradients of those rows; ``averaging`` swaps in the wrong gather."""
    img, txt = embeddings()
    world, rank = (1, 0) if group is None else (torch.distributed.get_world_size(), torch.distributed.get_rank())
    rows = slice(rank * GLOBAL // world, (rank + 1) * GLOBAL // world)
    ti = torch.from_numpy(img[rows]).requires_grad_(True)
    tt = torch.from_numpy(txt[rows]).requires_grad_(True)
    gather = tc.gather_rows
    if averaging:
        tc.gather_rows = _AveragingGather.apply
    try:
        loss = tc.clip_loss(ti, tt, torch.tensor(10.0), group)
    finally:
        tc.gather_rows = gather
    loss.backward()
    return {"loss": float(loss), "g_img": ti.grad.numpy(), "g_txt": tt.grad.numpy()}


def batches() -> list[dict]:
    rng = np.random.RandomState(1)
    out = []
    for _ in range(STEPS):
        tokens = rng.randint(0, BERT["vocab_size"], (GLOBAL, 16))
        mask = np.ones((GLOBAL, 16), np.int32)
        mask[::2, 12:] = 0
        out.append({"tokens": tokens, "mask": mask, "label": rng.randint(0, 2, GLOBAL)})
    return out


class BertStage(tdml.TrainValStage):
    def pre_stage(self):
        model = tb.BertForSequenceClassification(tb.BertConfig(dtype=torch.float32, **BERT), device="cpu",
                                                 generator=torch.Generator().manual_seed(0))
        self.pipeline.register_model("bert", model, sharding=encoder_partition_rules(), verbose=False)
        self.pipeline.register_optimizer("adamw", adamw(1e-3))
        mesh = self.pipeline.mesh
        dp, r = (tmesh.data_parallel_size(mesh), tmesh.data_parallel_rank(mesh)) if mesh is not None else (1, 0)
        rows = slice(r * GLOBAL // dp, (r + 1) * GLOBAL // dp)
        self.pipeline.register_dataset("train", [{k: v[rows] for k, v in b.items()} for b in batches()],
                                       verbose=False)

    def step(self, state, batch):
        return F.cross_entropy(state.model(batch["tokens"], batch["mask"]), batch["label"].long())

    def val_epoch(self):
        pass


def bert_run(axes=None) -> dict:
    pipe = tdml.TrainingPipeline({"seed": 0}, name="bert", device="cpu")
    if axes:
        pipe.set_mesh(axes)
    stage = BertStage()
    pipe.append_stage(stage, max_epochs=1)
    pipe.run()
    per_rank = runtime.all_gather_object([float(x) for x in stage.train_losses])
    plan = pipe.models["bert"].plan
    return {"losses": [float(np.mean(s)) for s in zip(*per_rank)], "params": tb.to_flax_params(stage.state.model),
            "fsdp": bool(plan and plan.fsdp)}


_WORKER = textwrap.dedent(
    """
    import os, pickle, sys
    import torch
    sys.path.insert(0, os.environ["TEST_DIR"])
    from dmlcloud_tpu_torch.parallel import runtime
    from test_torch_encoder_dist import bert_run, clip_case

    torch.set_num_threads(1)
    assert runtime.init_auto(device="cpu") == "gloo"
    out = {"clip": clip_case(torch.distributed.group.WORLD),
           "clip averaging": clip_case(torch.distributed.group.WORLD, averaging=True)}
    out["fsdp=2"] = bert_run({"fsdp": 2})
    out["data=2"] = bert_run({"data": 2})
    try:
        bert_run({"model": 2})
        out["model=2"] = None
    except NotImplementedError as exc:
        out["model=2"] = str(exc)
    runtime.barrier("done", timeout=60)
    out["clip"] = runtime.all_gather_object(out["clip"])
    out["clip averaging"] = runtime.all_gather_object(out["clip averaging"])
    if runtime.rank() == 0:
        with open(os.path.join(os.environ["OUT_DIR"], "world2.pkl"), "wb") as f:
            pickle.dump(out, f)
    """
)


def _launch(tmp_path: Path) -> dict:
    port = tcp.find_free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(rank), WORLD_SIZE="2",
                   OMP_NUM_THREADS="1", PYTHONPATH=str(REPO), TEST_DIR=str(Path(__file__).parent),
                   OUT_DIR=str(tmp_path))
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
    return pickle.loads((tmp_path / "world2.pkl").read_bytes())


def params_rel(got: dict, want: dict) -> float:
    """Norm-relative error over the parameters, the attention key biases left out."""
    g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    pairs = [(g[path], w) for path, w in jax.tree_util.tree_flatten_with_path(want)[0]
             if "k_proj']['bias" not in jax.tree_util.keystr(path)]
    return float(np.sqrt(sum(np.sum((a - b) ** 2) for a, b in pairs) / sum(np.sum(b**2) for _, b in pairs)))


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = _launch(tmp_path_factory.mktemp("encoder_dist"))
    out["one clip"] = clip_case(None)
    runtime.init_single()
    try:
        out["one bert"] = bert_run()
    finally:
        runtime.deinitialize()
    return out


def test_clip_loss_over_two_processes_equals_the_global_batch(results):
    one = results["one clip"]
    ranks = results["clip"]
    np.testing.assert_allclose(np.mean([r["loss"] for r in ranks]), one["loss"], rtol=REL)
    for key in ("g_img", "g_txt"):
        # the stage's average over the processes divides each rank's gradients by 2
        got = np.concatenate([r[key] for r in ranks]) / 2
        np.testing.assert_allclose(got, one[key], rtol=REL, atol=REL * np.abs(one[key]).max())


def test_an_averaging_or_a_local_backward_of_the_gather_would_be_wrong(results):
    one = results["one clip"]
    scale = np.abs(one["g_img"]).max()
    averaged = np.concatenate([r["g_img"] for r in results["clip averaging"]]) / 2
    own = np.concatenate([clip_case_local_only(r) for r in range(2)]) / 2
    np.testing.assert_allclose(np.mean([r["loss"] for r in results["clip averaging"]]), one["loss"], rtol=REL)
    for wrong in (averaged, own):
        assert np.abs(wrong - one["g_img"]).max() > 100 * REL * scale


@pytest.mark.parametrize("case", ["fsdp=2", "data=2"])
def test_bert_on_a_mesh_of_two_processes_matches_one(results, case):
    got, one = results[case], results["one bert"]
    assert got["fsdp"] == (case == "fsdp=2")
    np.testing.assert_allclose(got["losses"], one["losses"], rtol=REL)
    assert params_rel(got["params"], one["params"]) <= REL
    start = tb.to_flax_params(tb.BertForSequenceClassification(
        tb.BertConfig(dtype=torch.float32, **BERT), device="cpu", generator=torch.Generator().manual_seed(0)))
    moved = max(float(np.abs(a - b).max()) for a, b in zip(jax.tree_util.tree_leaves(one["params"]),
                                                           jax.tree_util.tree_leaves(start)))
    assert moved > 1e-4, "the steps did not move the weights: the comparison would be vacuous"


def test_a_model_axis_is_not_ported_yet(results):
    assert results["model=2"] is not None and "ROADMAP Queue 1 item 11" in results["model=2"]


def clip_case_local_only(rank: int) -> np.ndarray:
    """A rank's image-row gradients when the other rank's part of the
    gathered rows' gradient is dropped: the loss of its own rows against the
    global batch, differentiated through its own copy only."""
    img, txt = embeddings()
    rows = slice(rank * GLOBAL // 2, (rank + 1) * GLOBAL // 2)
    ti = torch.from_numpy(img[rows]).requires_grad_(True)
    all_img = torch.cat([torch.from_numpy(img[:rows.start]), ti, torch.from_numpy(img[rows.stop:])])
    tt, all_txt = torch.from_numpy(txt[rows]), torch.from_numpy(txt)
    labels = torch.arange(GLOBAL // 2) + rows.start
    loss = 0.5 * (F.cross_entropy(10.0 * ti @ all_txt.T, labels) + F.cross_entropy(10.0 * tt @ all_img.T, labels))
    loss.backward()
    return ti.grad.numpy()
