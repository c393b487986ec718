"""GPipe pipeline parallelism of the port (``parallel.pipeline_parallel``) over
a ``pipe`` axis of two and four gloo processes on the CPU, against the JAX
package's ``pipeline_apply`` and against the sequential program.

The stages are tests/test_pipeline_parallel.py's: ``tanh(x @ w + b)`` on
width 16, stacked parameters from numpy with a seed. Two groups of processes
(two and four, env:// rung) run the cases below once, rank 0 writing what it
saw to a pickle; each process's gradients are summed over all processes (each
holds its stage's row and its data rows' part):

- ``pipe=2`` with 4 microbatches (two processes), ``pipe=4`` with 8 and
  ``data=2,pipe=2`` with 4 (four processes): the output of every process and
  the gradients of ``sum(y**2)`` with respect to the stacked parameters and
  the input, against the JAX ``pipeline_apply`` on a CPU mesh of the same
  axes and against the stages run one after another;
- the leading-dim ``ValueError``, word for word the reference's.
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

from dmlcloud_tpu.parallel import mesh as jmesh
from dmlcloud_tpu.parallel import pipeline_parallel as jpp
from dmlcloud_tpu_torch.parallel import mesh as tmesh
from dmlcloud_tpu_torch.parallel import pipeline_parallel as tpp
from dmlcloud_tpu_torch.parallel import runtime
from dmlcloud_tpu_torch.utils import tcp

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
DIM = 16
#: fp32 against the sequential program and JAX: the same products, the
#: gradient sums over microbatches and processes in another order
TOL = dict(atol=1e-5, rtol=1e-5)
#: case -> (mesh axes, n_micro)
CASES = {"pipe=2 micro 4": ({"pipe": 2}, 4), "pipe=4 micro 8": ({"pipe": 4}, 8),
         "data=2,pipe=2 micro 4": ({"data": 2, "pipe": 2}, 4)}


def inputs(axes: dict, n_micro: int) -> tuple[list[dict], np.ndarray]:
    """Per-stage parameters and the batch ([n_micro * data * 2, DIM])."""
    rng = np.random.RandomState(len(axes) * 10 + axes["pipe"])
    params = [{"w": (rng.randn(DIM, DIM) / np.sqrt(DIM)).astype(np.float32),
               "b": (rng.randn(DIM) * 0.1).astype(np.float32)} for _ in range(axes["pipe"])]
    return params, rng.randn(n_micro * axes.get("data", 1) * 2, DIM).astype(np.float32)


def torch_stage(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def jax_stage(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


_WORKER = textwrap.dedent(
    """
    import os, pickle, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    sys.path.insert(0, os.environ["TEST_DIR"])
    from dmlcloud_tpu_torch.parallel import mesh as tmesh
    from dmlcloud_tpu_torch.parallel import pipeline_parallel as tpp
    from dmlcloud_tpu_torch.parallel import runtime
    from test_torch_pipeline_parallel import CASES, inputs, torch_stage

    torch.set_num_threads(1)
    assert runtime.init_auto(device="cpu") == "gloo"
    world = runtime.world_size()
    out = {}
    for name, (axes, n_micro) in CASES.items():
        if int(np.prod(list(axes.values()))) != world:
            continue
        mesh = tmesh.create_mesh(axes, device="cpu")
        params, batch = inputs(axes, n_micro)
        stacked = {k: v.requires_grad_(True) for k, v in tpp.stack_pytrees(
            [{k: torch.from_numpy(v) for k, v in p.items()} for p in params]).items()}
        x = torch.from_numpy(batch).requires_grad_(True)
        y = tpp.pipeline_apply(torch_stage, stacked, tpp.microbatch(x, n_micro), mesh)
        (tpp.unmicrobatch(y) ** 2).sum().backward()
        ys = runtime.all_gather_object(y.detach().numpy())
        grads = [stacked["w"].grad, stacked["b"].grad, x.grad]
        rows = [bool((g.abs().sum(dim=tuple(range(1, g.dim()))) != 0).nonzero().flatten().tolist()
                     == [mesh.get_local_rank("pipe")]) for g in grads[:2]]
        for g in grads:
            dist.all_reduce(g)
        out[name] = {"y": ys, "grads": [g.numpy() for g in grads], "own_row_only": runtime.all_gather_object(rows)}
        if world == 2:
            bad = tpp.stack_pytrees([{k: torch.from_numpy(v) for k, v in p.items()} for p in params * 2])
            try:
                tpp.pipeline_apply(torch_stage, bad, tpp.microbatch(x.detach(), n_micro), mesh)
                out["leading dim"] = None
            except ValueError as exc:
                out["leading dim"] = str(exc)
    runtime.barrier("done", timeout=60)
    if runtime.rank() == 0:
        with open(os.path.join(os.environ["OUT_DIR"], f"world{world}.pkl"), "wb") as f:
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


def _jax(axes: dict, n_micro: int) -> dict:
    """The JAX pipeline's output and gradients, and the sequential program's."""
    params, batch = inputs(axes, n_micro)
    n = int(np.prod(list(axes.values())))
    mesh = jmesh.create_mesh(axes, devices=jax.devices()[:n])
    stacked = jpp.stack_pytrees([jax.tree_util.tree_map(jnp.asarray, p) for p in params])

    def pipe_loss(p, x):
        y = jpp.pipeline_apply(jax_stage, p, jpp.microbatch(x, n_micro), mesh)
        return jnp.sum(y ** 2), y

    def seq_loss(p, x):
        for i in range(axes["pipe"]):
            x = jax_stage(jax.tree_util.tree_map(lambda leaf: leaf[i], p), x)
        return jnp.sum(x ** 2), x

    out = {}
    for name, fn in (("pipe", pipe_loss), ("seq", seq_loss)):
        (_, y), (gp, gx) = jax.jit(jax.value_and_grad(fn, argnums=(0, 1), has_aux=True))(stacked, jnp.asarray(batch))
        out[name] = {"y": np.asarray(y), "grads": [np.asarray(gp["w"]), np.asarray(gp["b"]), np.asarray(gx)]}
    out["seq"]["y"] = np.asarray(jpp.microbatch(out["seq"]["y"], n_micro))
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("pipe_out")
    procs = {w: _launch(w, out_dir) for w in (2, 4)}
    try:
        jax_out = {case: _jax(*CASES[case]) for case in CASES}  # while the processes run
        for ps in procs.values():
            for p in ps:
                p.wait(timeout=180)
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
    out["jax"] = jax_out
    return out


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("oracle", ["jax pipeline_apply", "sequential program"])
def test_outputs_and_gradients_match(results, case, oracle):
    want = results["jax"][case]["pipe" if oracle.startswith("jax") else "seq"]
    got = results[case]
    for rank, y in enumerate(got["y"]):
        np.testing.assert_allclose(y, want["y"], **TOL, err_msg=f"{case}: output of rank {rank}")
    for g, w, name in zip(got["grads"], want["grads"], ("dw", "db", "dx")):
        np.testing.assert_allclose(g, w, **TOL, err_msg=f"{case} {name}")


@pytest.mark.parametrize("case", list(CASES))
def test_each_process_gets_the_gradient_of_its_own_stage_row(results, case):
    assert all(all(rows) for rows in results[case]["own_row_only"])


def test_the_leading_dim_error_is_the_references(results):
    axes, n_micro = CASES["pipe=2 micro 4"]
    params, batch = inputs(axes, n_micro)
    mesh = jmesh.create_mesh(axes, devices=jax.devices()[:2])
    bad = jpp.stack_pytrees([jax.tree_util.tree_map(jnp.asarray, p) for p in params * 2])
    with pytest.raises(ValueError) as exc:
        jpp.pipeline_apply(jax_stage, bad, jpp.microbatch(jnp.asarray(batch), n_micro), mesh)
    assert results["leading dim"] == str(exc.value)


def test_one_stage_on_a_one_rank_group_is_the_stage_itself():
    params, batch = inputs({"pipe": 1}, 4)
    runtime.init_single()
    try:
        mesh = tmesh.create_mesh({"pipe": 1}, device="cpu")
        stacked = {k: v.requires_grad_(True) for k, v in tpp.stack_pytrees(
            [{k: torch.from_numpy(v) for k, v in params[0].items()}]).items()}
        x = torch.from_numpy(batch)
        y = tpp.unmicrobatch(tpp.pipeline_apply(torch_stage, stacked, tpp.microbatch(x, 4), mesh))
        (y ** 2).sum().backward()
    finally:
        runtime.deinitialize()
    p = {k: torch.from_numpy(v).requires_grad_(True) for k, v in params[0].items()}
    want = torch_stage(p, x)
    (want ** 2).sum().backward()
    torch.testing.assert_close(y, want, **TOL)
    for k in p:
        torch.testing.assert_close(stacked[k].grad[0], p[k].grad, **TOL)


def test_microbatch_round_trip_and_its_error_match_the_reference():
    x = np.arange(24.0, dtype=np.float32).reshape(12, 2)
    mb = tpp.microbatch(torch.from_numpy(x), 4)
    assert tuple(mb.shape) == (4, 3, 2)
    np.testing.assert_array_equal(mb.numpy(), np.asarray(jpp.microbatch(jnp.asarray(x), 4)))
    np.testing.assert_array_equal(tpp.unmicrobatch(mb).numpy(), x)
    with pytest.raises(ValueError, match="not divisible into 5 microbatches"):
        tpp.microbatch(torch.from_numpy(x), 5)
    assert tpp.stage_sharding(None) == ("pipe",) and tmesh.P(*jpp.stage_sharding(
        jmesh.create_mesh({"pipe": 2}, devices=jax.devices()[:2])).spec) == tpp.stage_sharding(None)
