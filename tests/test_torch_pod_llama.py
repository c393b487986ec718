"""``dmlcloud_tpu_torch.examples.pod_llama_fsdp`` (the port of
``examples/pod_llama_fsdp.py``) on the CPU: ``--toy --mesh data=2,fsdp=2``
over four gloo processes against the same run in one process.

Each process feeds the rows of its data-parallel coordinate of one seeded
global stream, so the four-process run's per-step loss (the mean over the
data-parallel processes) equals the one-process run's, with ``--chunked-loss``
and ``--remat`` on as well: within ``REL`` of the one process summing the same
four row groups (``--grad-accum 4``), within ``ORDER_REL`` of one process
summing the whole batch at once.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from dmlcloud_tpu_torch.examples import pod_llama_fsdp as pod
from dmlcloud_tpu_torch.parallel import runtime
from dmlcloud_tpu_torch.utils import tcp

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
ARGV = ["--toy", "--device", "cpu", "--remat", "--chunked-loss", "200", "--steps-per-epoch", "3"]
#: the mean of per-process means against the mean of per-microbatch means
#: over the same row groups, fp32
REL = 1e-5
#: against one mean over the whole batch: the gradient sums run in another
#: order, and AdamW (b2 0.95) turns that noise into updates of size ~lr where a
#: gradient is near zero; one process with 1, 2 and 4 microbatches spreads as
#: far (7e-5 at step 3 on the CPU), as tests/test_torch_train.py notes
ORDER_REL = 1e-4

_WORKER = textwrap.dedent(
    """
    import json, os, sys
    import torch
    from dmlcloud_tpu_torch.examples import pod_llama_fsdp as pod
    from dmlcloud_tpu_torch.parallel import runtime

    torch.set_num_threads(1)
    argv = json.loads(os.environ["ARGV"])
    stage = pod.main(argv)
    losses = runtime.all_gather_object([float(x) for x in stage.train_losses])
    plan = stage.pipeline.models["llama"].plan
    if runtime.rank() == 0:
        with open(os.environ["OUT"], "w") as f:
            json.dump({"losses": losses, "axes": plan.axes, "fsdp": plan.fsdp,
                       "batches": float(stage.tracker["misc/total_train_batches"][-1])}, f)
    runtime.deinitialize()
    """
)


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("pod_out")
    port, world = tcp.find_free_port(), 4
    procs = []
    for rank in range(world):
        env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(rank),
                   WORLD_SIZE=str(world), OMP_NUM_THREADS="1", PYTHONPATH=str(REPO), OUT=str(out_dir / "out.json"),
                   ARGV=json.dumps(ARGV + ["--mesh", "data=2,fsdp=2"]))
        # output to files: a full pipe would block one rank inside a collective
        with open(out_dir / f"log{rank}.txt", "w") as log:
            procs.append(subprocess.Popen([sys.executable, "-c", _WORKER], env=env, cwd=out_dir, stdout=log,
                                          stderr=subprocess.STDOUT))
    try:
        for p in procs:
            p.wait(timeout=300)
    finally:
        for p in procs:
            p.kill()
    for rank, p in enumerate(procs):
        assert p.returncode == 0, (out_dir / f"log{rank}.txt").read_text()[-4000:]
    return json.loads((out_dir / "out.json").read_text())


def test_toy_over_four_processes_equals_one_process(four):
    assert four["axes"] == {"data": 2, "fsdp": 2} and four["fsdp"]
    per_rank = np.array(four["losses"])
    assert per_rank.shape == (4, 3) and np.isfinite(per_rank).all()
    one = {}
    for accum in (1, 4):
        try:
            stage = pod.main(ARGV + ["--grad-accum", str(accum)])
            one[accum] = [float(x) for x in stage.train_losses]
            assert stage.pipeline.models["llama"].plan.axes == {"fsdp": 1}
        finally:
            runtime.deinitialize()
    np.testing.assert_allclose(per_rank.mean(0), one[4], rtol=REL)
    np.testing.assert_allclose(per_rank.mean(0), one[1], rtol=ORDER_REL)
    # each data-parallel rank fed its own rows
    assert len({tuple(r) for r in per_rank.tolist()}) == 4
    assert four["batches"] == 4 * len(one[1])


def test_rank_batches_slice_one_stream():
    whole = pod.rank_batches(512, 8, 3, 16, 1, 0)
    parts = [pod.rank_batches(512, 8, 3, 16, 4, r) for r in range(4)]
    for i in range(3):
        np.testing.assert_array_equal(np.concatenate([p[i] for p in parts]), whole[i])
    with pytest.raises(ValueError, match="divide evenly"):
        pod.rank_batches(512, 6, 3, 16, 4, 0)
