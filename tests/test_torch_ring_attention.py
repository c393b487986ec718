"""Ring attention of the port (``ops.ring_attention``, ``DecoderLM(attn_impl=
"ring")``) over a ``seq`` axis of two and four gloo processes on the CPU,
against the JAX package's ``ring_attention_sharded`` and ``DecoderLM``.

Two groups of processes (two and four, env:// rung) run every case once,
rank 0 writing what it saw to a pickle; the parametrised tests read it:

- ``ring_attention_sharded`` on ``seq=2`` and ``seq=4`` (and ``data=2,seq=2``):
  causal, non-causal, GQA and the windows ``[1, 5, 8, 13, 40, 64]`` at
  ``Tl = 8``; the output and dQ/dK/dV of a random cotangent against the JAX
  function on a CPU mesh of the same axes (its blockwise-XLA mode, as
  tests/test_ops.py runs it) at tests/test_ops.py's tolerances;
- the tiny ``DecoderLM(attn_impl="ring")`` on ``seq=2`` and ``fsdp=2,seq=2``:
  one step's loss and gradients against the JAX ring model on the same
  bridged weights, three training steps through the pipeline against one
  process on the flash path, and the ``seq`` peers' parameters and AdamW
  moments bitwise equal;
- the mesh bookkeeping of ``data=2,seq=2``: ``seq`` peers share their
  data-parallel rank, feed-check group and metric rank.

The errors (``segment_ids``, a sequence the axis does not divide, a window
without ``causal``, the example's flags) are checked in this process.
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
import pytest
import torch

from dmlcloud_tpu.models import transformer as jtr
from dmlcloud_tpu.ops.ring_attention import ring_attention_sharded as jax_ring
from dmlcloud_tpu.parallel import mesh as jmesh
from dmlcloud_tpu_torch.examples import train_lm
from dmlcloud_tpu_torch.models import transformer as ttr
from dmlcloud_tpu_torch.ops import flash_attention as fa
from dmlcloud_tpu_torch.ops.ring_attention import ring_attention, ring_attention_sharded
from dmlcloud_tpu_torch.parallel import runtime
from dmlcloud_tpu_torch.parallel.tensor_parallel import ModelGroup
from dmlcloud_tpu_torch.utils import tcp

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
#: tests/test_ops.py's ring tolerances (fp32)
OUT_TOL, GRAD_TOL = 2e-5, 1e-4
WINDOWS = [1, 5, 8, 13, 40, 64]
#: case -> (mesh axes, B, H, KH, causal, window); Tl = 8, head dim 16
ATTN_CASES = {}
for _n in (2, 4):
    ATTN_CASES[f"seq={_n} causal"] = ({"seq": _n}, 1, 2, 2, True, None)
    ATTN_CASES[f"seq={_n} non-causal"] = ({"seq": _n}, 1, 2, 2, False, None)
    ATTN_CASES[f"seq={_n} gqa 4->2"] = ({"seq": _n}, 1, 4, 2, True, None)
    for _w in WINDOWS:
        ATTN_CASES[f"seq={_n} window {_w}"] = ({"seq": _n}, 1, 2, 2, True, _w)
ATTN_CASES["data=2,seq=2 causal"] = ({"data": 2, "seq": 2}, 2, 2, 2, True, None)
MODEL_MESHES = {"seq=2": {"seq": 2}, "fsdp=2,seq=2": {"fsdp": 2, "seq": 2}}


def attn_inputs(axes: dict, b: int, h: int, kh: int) -> tuple[np.ndarray, ...]:
    t = 8 * axes["seq"]
    rng = np.random.RandomState(t + h + 7 * b)
    return tuple((rng.randn(*shape) * scale).astype(np.float32) for shape, scale in
                 (((b, t, h, 16), 0.5), ((b, t, kh, 16), 0.5), ((b, t, kh, 16), 1.0), ((b, t, h, 16), 1.0)))


_WORKER = textwrap.dedent(
    """
    import os, pickle, sys
    import numpy as np
    import torch
    sys.path.insert(0, os.environ["TEST_DIR"])
    from dmlcloud_tpu_torch.models import transformer as ttr
    from dmlcloud_tpu_torch.ops.ring_attention import ring_attention_sharded
    from dmlcloud_tpu_torch.parallel import mesh as tmesh
    from dmlcloud_tpu_torch.parallel import runtime
    from test_torch_fsdp import BATCH, TINY, global_batches, run
    from test_torch_ring_attention import ATTN_CASES, MODEL_MESHES, attn_inputs

    def leaves(tree):
        if isinstance(tree, dict):
            return [x for key in sorted(tree) for x in leaves(tree[key])]
        return [tree]

    torch.set_num_threads(1)
    assert runtime.init_auto(device="cpu") == "gloo"
    world = runtime.world_size()
    tree = pickle.loads(open(os.environ["INIT"], "rb").read())
    out = {}
    for name, (axes, b, h, kh, causal, window) in ATTN_CASES.items():
        if int(np.prod(list(axes.values()))) != world:
            continue
        mesh = tmesh.create_mesh(axes, device="cpu")
        q, k, v, cot = (torch.from_numpy(x) for x in attn_inputs(axes, b, h, kh))
        dp_rank = tmesh.data_parallel_rank(mesh)
        # each process feeds the rows of its data-parallel coordinate
        q, k, v, cot = (x[dp_rank::tmesh.data_parallel_size(mesh)] for x in (q, k, v, cot))
        q, k, v = (x.clone().requires_grad_(True) for x in (q, k, v))
        o = ring_attention_sharded(q, k, v, mesh, causal=causal, window=window)
        (o * cot).sum().backward()
        parts = runtime.all_gather_object([x.detach().numpy() for x in (o, q.grad, k.grad, v.grad)])
        # seq is the minor axis: ranks d*n + s; seq peers must hold the same bits
        n = axes["seq"]
        assert all(np.array_equal(a, b) for r in range(world) for a, b in zip(parts[r], parts[r - r % n]))
        parts = parts[::n]
        if "data" in axes:
            plan = tmesh.shard_module(torch.nn.Linear(2, 2), mesh)
            out["bookkeeping"] = {"dp_rank": runtime.all_gather_object(dp_rank), "metric_ranks": plan.metric_ranks,
                                  "peer_size": plan.peer_size, "dp_size": plan.dp_size}
        out[name] = [np.concatenate(xs) for xs in zip(*parts)]

    for name, axes in MODEL_MESHES.items():
        if int(np.prod(list(axes.values()))) != world:
            continue
        mesh = tmesh.create_mesh(axes, device="cpu")
        model = ttr.DecoderLM(ttr.TransformerConfig(dtype=torch.float32, attn_impl="ring", **TINY), device="cpu")
        ttr.load_flax_params(model, tree)
        tmesh.shard_module(model, mesh, ttr.llama_partition_rules())
        dp, r = tmesh.data_parallel_size(mesh), tmesh.data_parallel_rank(mesh)
        batch = torch.from_numpy(global_batches()[0])[r * BATCH // dp:(r + 1) * BATCH // dp]
        loss = ttr.lm_loss(model(batch), batch)
        loss.backward()
        grads = ttr.to_flax_params(model, {n: p.grad for n, p in model.named_parameters()})
        step = {"loss": float(np.mean(runtime.all_gather_object(float(loss))[::axes["seq"]])), "grads": grads}
        res = run(tree, axes, attn="ring")
        # every rank's view of the state after the run: seq peers must hold the same bits
        peers = runtime.all_gather_object([leaves(res[part]) for part in ("params", "mu", "nu", "ema")])
        res["replicas_equal"] = all(np.array_equal(a, b) for p in peers[1:] for xs, ys in zip(peers[0], p)
                                    for a, b in zip(xs, ys))
        out[name] = {"step": step, "run": res}
    runtime.barrier("done", timeout=60)
    if runtime.rank() == 0:
        with open(os.path.join(os.environ["OUT_DIR"], f"world{world}.pkl"), "wb") as f:
            pickle.dump(out, f)
    """
)


def _launch(world: int, out_dir: Path, init: Path) -> list:
    port = tcp.find_free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(rank),
                   WORLD_SIZE=str(world), OMP_NUM_THREADS="1", PYTHONPATH=str(REPO),
                   TEST_DIR=str(Path(__file__).parent), OUT_DIR=str(out_dir), INIT=str(init))
        # output to files: a full pipe would block one rank inside a collective
        with open(out_dir / f"log{world}.{rank}.txt", "w") as log:
            procs.append(subprocess.Popen([sys.executable, "-c", _WORKER], env=env, cwd=out_dir, stdout=log,
                                          stderr=subprocess.STDOUT))
    return procs


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    from test_torch_fsdp import flax_init, run

    out_dir = tmp_path_factory.mktemp("ring_out")
    tree = flax_init()
    init = out_dir / "init.pkl"
    init.write_bytes(pickle.dumps(tree))
    procs = {w: _launch(w, out_dir, init) for w in (2, 4)}
    try:
        # the JAX side while the processes run
        jax_out = {case: _jax_attention(case) for case in ATTN_CASES}
        jax_out.update({case: _jax_model_step(tree, axes) for case, axes in MODEL_MESHES.items()})
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
    for w in (2, 4):
        out.update(pickle.loads((out_dir / f"world{w}.pkl").read_bytes()))
    runtime.init_single()
    try:
        out["one flash"] = run(tree, attn="flash")
    finally:
        runtime.deinitialize()
    out["tree"], out["jax"] = tree, jax_out
    return out


def _jax_mesh(axes: dict):
    n = int(np.prod(list(axes.values())))
    return jmesh.create_mesh(axes, devices=jax.devices()[:n])


def _jax_attention(case: str) -> list[np.ndarray]:
    """The JAX ring's output and dQ/dK/dV of the cotangent, one jitted program."""
    axes, b, h, kh, causal, window = ATTN_CASES[case]
    q, k, v, cot = (jnp.asarray(x) for x in attn_inputs(axes, b, h, kh))
    mesh = _jax_mesh(axes)

    def fwd_vjp(q, k, v):
        out, vjp = jax.vjp(lambda q, k, v: jax_ring(q, k, v, mesh, causal=causal, window=window), q, k, v)
        return (out, *vjp(cot))

    return [np.asarray(x) for x in jax.jit(fwd_vjp)(q, k, v)]


def _jax_model_step(tree: dict, axes: dict) -> tuple[float, dict]:
    """Loss and gradients of the JAX ring model on the first global batch."""
    from test_torch_fsdp import TINY, global_batches

    model = jtr.DecoderLM(jtr.TransformerConfig(dtype=jnp.float32, attn_impl="ring", mesh=_jax_mesh(axes), **TINY))
    batch = jnp.asarray(global_batches()[0])
    loss, grads = jax.jit(jax.value_and_grad(lambda p: jtr.lm_loss(model.apply({"params": p}, batch), batch)))(tree)
    return float(loss), jax.tree_util.tree_map(np.asarray, grads)


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_ring_matches_the_jax_ring_attention_sharded(results, case):
    want, got = results["jax"][case], results[case]
    np.testing.assert_allclose(got[0], want[0], atol=OUT_TOL, rtol=OUT_TOL, err_msg=f"{case} out")
    for g, w, name in zip(got[1:], want[1:], "qkv"):
        np.testing.assert_allclose(g, w, atol=GRAD_TOL, rtol=GRAD_TOL, err_msg=f"{case} d{name}")


@pytest.mark.parametrize("case", list(MODEL_MESHES))
def test_a_ring_decoder_step_matches_the_jax_ring_model(results, case):
    from test_torch_fsdp import JAX_REL, _assert_trees_close

    loss, grads = results["jax"][case]
    got = results[case]["step"]
    np.testing.assert_allclose(got["loss"], loss, rtol=JAX_REL)
    _assert_trees_close(got["grads"], grads, JAX_REL, f"{case} grads vs JAX")


@pytest.mark.parametrize("case", list(MODEL_MESHES))
def test_ring_training_matches_one_process_and_seq_replicas_stay_bitwise_equal(results, case):
    from test_torch_fsdp import REL, STEPS, _assert_trees_close

    got, want = results[case]["run"], results["one flash"]
    assert got["replicas_equal"], f"{case}: seq peers' parameters or AdamW moments differ"
    assert got["fsdp"] == ("fsdp" in case) and not got["tp"]
    assert len(got["losses"]) == STEPS and got["step"] == STEPS
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=REL)
    np.testing.assert_allclose(got["val"], want["val"], rtol=REL)
    _assert_trees_close(got["params"], want["params"], REL, case)
    # seq peers count once in the epoch's metrics: the data-parallel processes' batches
    assert got["batches"] == want["batches"] * (2 if "fsdp" in case else 1)


def test_seq_peers_share_the_data_parallel_rank_the_feed_check_and_the_metric_rank(results):
    # data=2,seq=2 over ranks 0-3 (seq the minor axis): 0,1 and 2,3 are seq peers
    book = results["bookkeeping"]
    assert book["dp_rank"] == [0, 0, 1, 1]
    assert book["metric_ranks"] == [0, 2] and book["peer_size"] == 2 and book["dp_size"] == 2


def test_a_ring_of_one_is_the_flash_path_bitwise():
    rng = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rng.randn(2, 24, h, 16).astype(np.float32)) for h in (4, 2, 2))
    for causal, window in [(True, None), (False, None), (True, 7)]:
        want = fa.flash_attention(q, k, v, causal=causal, window=window)
        assert torch.equal(ring_attention(q, k, v, causal=causal, window=window), want)


def test_the_reference_errors():
    q = torch.zeros(1, 15, 2, 16)
    with pytest.raises(ValueError, match="not divisible by mesh axis 'seq'"):
        ring_attention_sharded(q, q, q, ModelGroup(None, 0, 2))
    with pytest.raises(ValueError, match="requires causal=True"):
        ring_attention(q, q, q, causal=False, window=5)
    cfg = ttr.TransformerConfig(vocab_size=32, num_layers=1, num_heads=2, head_dim=8, hidden_dim=16, mlp_dim=32,
                                attn_impl="ring", dtype=torch.float32)
    model = ttr.DecoderLM(cfg, device="cpu")
    tokens = torch.zeros(1, 8, dtype=torch.int64)
    with pytest.raises(ValueError, match="segment_ids are not supported with attn_impl='ring'"):
        model(tokens, segment_ids=torch.ones(1, 8, dtype=torch.int32))
    with pytest.raises(ValueError, match="apply_sequence_parallel"):
        model(tokens)  # no seq group: registered on no mesh
    for argv in (["--attn", "ring", "--pack", "--mesh", "seq=1"], ["--attn", "ring"], ["--attn", "ring", "--mesh",
                                                                                        "fsdp=1"]):
        with pytest.raises(SystemExit):
            train_lm.build(argv + ["--device", "cpu"])
