"""The port's CLIP recipe (``dmlcloud_tpu_torch.examples.pod_clip_vit``) on the
CPU, against the JAX example and across processes.

- ``--toy`` (2 epochs of 4 steps, 16 pairs, fp32) against the JAX example's
  ``CLIPStage`` (``examples/pod_clip_vit.py``, one device) from the same
  weights (bridged) on the same batches: ``SyntheticPairs`` yields the
  reference's arrays bit for bit; every step's loss within ``STEP_REL``, the
  epochs' accuracy and logit scale alike.
- ``--mesh fsdp=1`` (FSDP2 over a one-rank group) bitwise equal to the run
  without a mesh.
- A data-parallel coordinate draws only its own rows' images (the stream is
  advanced past the others'), equal to the full draw's slice, step by step.
- A URL ``--checkpoint-dir`` is used as it is.
- ``--mesh data=2``, ``--mesh fsdp=2`` and no mesh (the model replicated,
  the gradients averaged by the stage) over two gloo processes, each
  feeding its half of every global batch, against one process: losses and
  accuracies within ``DP_REL``, the gathered parameters within ``DP_REL`` in
  norm (``params_rel``: the attention key biases, whose gradients vanish,
  left out).
"""

import importlib.util
import os
import pickle
import subprocess
import sys
import textwrap
import tracemalloc
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import dmlcloud_tpu as jdml
from dmlcloud_tpu.parallel import mesh as jmesh
from dmlcloud_tpu_torch.examples import pod_clip_vit
from dmlcloud_tpu_torch.models import clip as tc
from dmlcloud_tpu_torch.parallel import runtime
from dmlcloud_tpu_torch.utils import tcp

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
TOY = ["--toy", "--device", "cpu"]
#: per-step losses against the JAX example over 8 AdamW steps, relative
STEP_REL = 1e-4
#: two processes against one: the gathered similarities sum in another order
DP_REL = 1e-5


def _reference_example():
    spec = importlib.util.spec_from_file_location("reference_pod_clip_vit", REPO / "examples" / "pod_clip_vit.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    return ref


def run_jax() -> dict:
    ref = _reference_example()

    class Stage(ref.CLIPStage):
        def pre_epoch(self):
            if not hasattr(self, "start"):
                self.start = jax.tree_util.tree_map(np.asarray, self.state.params)

        def _build_train_step(self):
            jitted = super()._build_train_step()

            def recorded(state, batch):
                state, metrics = jitted(state, batch)
                self.step_losses.append(float(metrics["loss"]))
                return state, metrics

            return recorded

    steps = 2 * 4
    config = {"preset": "toy", "global_batch": 16, "steps_per_epoch": 4, "lr": 1e-3,
              "warmup_steps": max(steps // 50, 1), "decay_steps": steps, "save_every_steps": 500, "seed": 0}
    pipe = jdml.TrainingPipeline(config, name="clip-toy")
    pipe.set_mesh(jmesh.create_mesh({"data": 1}, devices=jax.devices()[:1]))
    stage = Stage()
    stage.step_losses = []
    pipe.append_stage(stage, max_epochs=2)
    pipe.run()
    return {"losses": stage.step_losses, "start": stage.start,
            "accuracy": [float(x) for x in stage.tracker["train/accuracy"]],
            "logit_scale": [float(x) for x in stage.tracker["train/logit_scale"]]}


def run_port(argv: list[str], start: dict | None = None) -> dict:
    """The example built from ``argv``; ``start`` (a flax tree) replaces the
    initial weights. What every rank saw, parameters gathered."""
    pipe, stage = pod_clip_vit.build(argv)
    losses = []
    step, pre_stage = stage._train_step, stage.pre_stage

    def recorded(batch):
        metrics = step(batch)
        losses.append(float(metrics["loss"]))
        return metrics

    def loaded():
        pre_stage()
        if start is not None:
            tc.load_flax_params(pipe.models["clip"].module, start)

    stage._train_step, stage.pre_stage = recorded, loaded
    pipe.run()
    per_rank = runtime.all_gather_object(losses)
    return {"losses": [float(np.mean(s)) for s in zip(*per_rank)],
            "accuracy": [float(x) for x in stage.tracker["train/accuracy"]],
            "logit_scale": [float(x) for x in stage.tracker["train/logit_scale"]],
            "params": tc.to_flax_params(stage.state.model), "plan": bool(pipe.models["clip"].plan)}


def test_toy_run_matches_the_jax_example():
    want = run_jax()
    runtime.init_single()
    try:
        got = run_port(TOY, want["start"])
    finally:
        runtime.deinitialize()
    assert len(got["losses"]) == len(want["losses"]) == 8
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=STEP_REL)
    np.testing.assert_allclose(got["accuracy"], want["accuracy"], atol=1e-6)
    np.testing.assert_allclose(got["logit_scale"], want["logit_scale"], rtol=STEP_REL)
    assert got["losses"][-1] < got["losses"][0]  # the contrastive objective has signal


def test_synthetic_pairs_are_the_references_arrays_and_slice_by_rank():
    ref = _reference_example()
    cfg = pod_clip_vit.clip_config("toy")
    want = list(ref.SyntheticPairs(ref.build_clip("toy").cfg, 16, 3, seed=0))
    got = list(pod_clip_vit.SyntheticPairs(cfg, 16, 3))
    halves = [list(pod_clip_vit.SyntheticPairs(cfg, 16, 3, dp_size=2, dp_rank=r)) for r in range(2)]
    for w, g, a, b in zip(want, got, *halves):
        for key in ("image", "tokens"):
            np.testing.assert_array_equal(g[key], w[key])
            np.testing.assert_array_equal(np.concatenate([a[key], b[key]]), w[key])
    with pytest.raises(ValueError, match="divide evenly"):
        pod_clip_vit.SyntheticPairs(cfg, 15, 1, dp_size=2)


def test_a_one_rank_fsdp_mesh_is_bitwise_the_run_without_a_mesh():
    runtime.init_single()
    try:
        plain = run_port(TOY)
    finally:
        runtime.deinitialize()
    try:
        meshed = run_port(TOY + ["--mesh", "fsdp=1"])
    finally:
        runtime.deinitialize()
    assert meshed["plan"] and not plain["plan"]
    assert meshed["losses"] == plain["losses"] and meshed["accuracy"] == plain["accuracy"]
    for a, b in zip(jax.tree_util.tree_leaves(meshed["params"]), jax.tree_util.tree_leaves(plain["params"])):
        np.testing.assert_array_equal(a, b)


def test_each_process_draws_only_its_rows_of_images():
    """A coordinate's draw equals the full draw's slice, and so do the draws
    after it (the next steps), while the stream is advanced past the other
    rows' images: ``_skip_floats(rng, n)`` leaves the generator exactly where
    ``n`` float32 draws would, from a buffered half and without one."""
    for start in (0, 1):
        for n in (0, 1, 2, 5, 3072, 75264):
            a, b = np.random.default_rng(11), np.random.default_rng(11)
            a.random(start, dtype=np.float32)
            b.random(start, dtype=np.float32)
            a.random(n, dtype=np.float32)
            pod_clip_vit.SyntheticPairs._skip_floats(b, n)
            sa, sb = a.bit_generator.state, b.bit_generator.state
            # the buffered half counts only while it is flagged
            assert (sa["state"], sa["has_uint32"]) == (sb["state"], sb["has_uint32"]), (start, n)
            assert not sa["has_uint32"] or sa["uinteger"] == sb["uinteger"], (start, n)
            np.testing.assert_array_equal(a.random(7, dtype=np.float32), b.random(7, dtype=np.float32))
    cfg = pod_clip_vit.clip_config("toy")
    full = list(pod_clip_vit.SyntheticPairs(cfg, 12, 4))
    quarters = [list(pod_clip_vit.SyntheticPairs(cfg, 12, 4, dp_size=4, dp_rank=r)) for r in range(4)]
    for step, want in enumerate(full):
        for key in ("image", "tokens"):
            np.testing.assert_array_equal(np.concatenate([q[step][key] for q in quarters]), want[key])
    # a coordinate's peak allocation is its own rows' images, not the global batch's
    batch_bytes = 16 * cfg.vision.image_size ** 2 * 3 * 4
    tracemalloc.start()
    try:
        next(iter(pod_clip_vit.SyntheticPairs(cfg, 16, 1, dp_size=8, dp_rank=3)))
        _, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert peak < batch_bytes / 2, (peak, batch_bytes)


def test_remote_checkpoint_directories_wait_for_their_roadmap_item():
    """Remote run directories are ported (ROADMAP Queue 1 item 3): the recipe
    takes a URL as it is, no longer refusing it."""
    pipeline, _ = pod_clip_vit.build(TOY + ["--checkpoint-dir", "memory://clip-runs"])
    try:
        assert str(pipeline.checkpoint_dir.path).startswith("memory://clip-runs/clip-toy-")
    finally:
        runtime.deinitialize()


_WORKER = textwrap.dedent(
    """
    import os, pickle, sys
    import torch
    sys.path.insert(0, os.environ["TEST_DIR"])
    from dmlcloud_tpu_torch.parallel import runtime
    from test_torch_pod_clip import TOY, run_port

    torch.set_num_threads(1)
    out = {"data=2": run_port(TOY + ["--mesh", "data=2"]), "fsdp=2": run_port(TOY + ["--mesh", "fsdp=2"]),
           "no mesh": run_port(TOY)}
    runtime.barrier("done", timeout=60)
    if runtime.rank() == 0:
        with open(os.path.join(os.environ["OUT_DIR"], "world2.pkl"), "wb") as f:
            pickle.dump(out, f)
    """
)


@pytest.fixture(scope="module")
def two_processes(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("pod_clip")
    port = tcp.find_free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(rank), WORLD_SIZE="2",
                   OMP_NUM_THREADS="1", PYTHONPATH=str(REPO), TEST_DIR=str(Path(__file__).parent),
                   OUT_DIR=str(out_dir))
        # output to files: a full pipe would block one rank inside a collective
        with open(out_dir / f"log{rank}.txt", "w") as log:
            procs.append(subprocess.Popen([sys.executable, "-c", _WORKER], env=env, cwd=out_dir, stdout=log,
                                          stderr=subprocess.STDOUT))
    try:
        for p in procs:
            p.wait(timeout=240)
    finally:
        for p in procs:
            p.kill()
    for rank, p in enumerate(procs):
        assert p.returncode == 0, (out_dir / f"log{rank}.txt").read_text()[-4000:]
    out = pickle.loads((out_dir / "world2.pkl").read_bytes())
    runtime.init_single()
    try:
        out["one"] = run_port(TOY)
    finally:
        runtime.deinitialize()
    return out


@pytest.mark.parametrize("mesh", ["data=2", "fsdp=2", "no mesh"])
def test_two_processes_match_one_on_the_global_batch(two_processes, mesh):
    got, one = two_processes[mesh], two_processes["one"]
    np.testing.assert_allclose(got["losses"], one["losses"], rtol=DP_REL)
    np.testing.assert_allclose(got["accuracy"], one["accuracy"], atol=1e-6)
    assert params_rel(got["params"], one["params"]) <= DP_REL


def params_rel(got: dict, want: dict) -> float:
    """Norm-relative error over the parameters, the attention key biases left
    out: the softmax does not depend on them, so their gradients are rounding
    noise, which AdamW scales to steps of the learning rate's size."""
    g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    pairs = [(g[path], w) for path, w in jax.tree_util.tree_flatten_with_path(want)[0]
             if "k_proj']['bias" not in jax.tree_util.keystr(path)]
    return float(np.sqrt(sum(np.sum((a - b) ** 2) for a, b in pairs) / sum(np.sum(b**2) for _, b in pairs)))
