"""Run directories on an fsspec URL, on the CPU: fsspec's in-process
``memory://`` store (one process) and ``file://`` (two gloo processes, since
``memory://`` is per process); no network.

- ``as_run_path``/``is_remote_path``/``generate_checkpoint_path`` against the
  JAX package's, by string: a URL keeps its scheme (``gs://bucket/runs`` no
  longer becomes ``<cwd>/gs:/bucket/runs``), a local path is absolutised.
- ``CheckpointDir`` on ``memory://``: the contract files, the config round
  trip, ``save_state``/``restore_state`` bitwise (sync and async, through
  DCP's fsspec storage), ``LatestN`` retention listing and deleting over
  fsspec, the sharding sidecar, ``find_slurm_checkpoint``, the verdict.
- ``_RemoteLogFile`` keeps the previous attempt's log in front and uploads at
  most every ``flush_interval`` and at close.
- ``examples.train_lm --checkpoint-dir memory://...`` preempted by SIGUSR1 and
  resumed: bitwise the uninterrupted run; ``log.txt`` holds both attempts.
- Two gloo processes with a ``file://`` root: the same drill, every rank's
  state bitwise the uninterrupted run's.
"""

import os
import pickle
import signal
import subprocess
import sys
import textwrap
from pathlib import Path

import fsspec
import numpy as np
import pytest
import torch

from dmlcloud_tpu import checkpoint as jckpt
from dmlcloud_tpu_torch import checkpoint as tckpt
from dmlcloud_tpu_torch.examples import train_lm
from dmlcloud_tpu_torch.utils import tcp
from dmlcloud_tpu_torch.utils.logging import IORedirector, _RemoteLogFile
from dmlcloud_tpu_torch.utils.paths import RemotePath

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parent.parent
MEM = fsspec.filesystem("memory")

ARGV = ["--device", "cpu", "--preset", "tiny", "--vocab-size", "128", "--seq-len", "32", "--batch-size", "4",
        "--n-seqs", "40", "--lr", "0.05", "--epochs", "1", "--save-every-steps", "3"]


@pytest.fixture
def mem_root(request):
    """A fresh ``memory://`` root, removed afterwards."""
    root = f"memory://{request.node.name.replace('[', '_').replace(']', '')}"
    yield root
    RemotePath(root).rm()


# ---------------------------------------------------------------------------
# paths, by string against the reference
# ---------------------------------------------------------------------------

def test_paths_match_the_reference(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    for path in ("gs://bucket/runs", "gs://bucket/runs/", "relative/run", str(tmp_path / "abs"), "~/x"):
        assert str(tckpt.as_run_path(path)) == str(jckpt.as_run_path(path)), path
        assert tckpt.is_remote_path(path) == jckpt.is_remote_path(path)
    assert str(tckpt.as_run_path("memory://run/x")) == "memory://run/x"
    p = tckpt.generate_checkpoint_path(root="gs://bucket/runs", name="exp/1")
    assert str(p).startswith("gs://bucket/runs/exp_1-") and isinstance(p, RemotePath)
    assert str(jckpt.generate_checkpoint_path("gs://bucket/runs", "exp")).startswith("gs://bucket/runs/exp-")
    ckpt = tckpt.CheckpointDir("gs://bucket/run")
    assert (str(ckpt), str(ckpt.config_file), str(ckpt.state_dir)) == (
        "gs://bucket/run", "gs://bucket/run/config.yaml", "gs://bucket/run/state")
    assert p.parent == RemotePath("gs://bucket/runs") and p.parent.name == "runs"
    assert RemotePath("gs://b/x/7.json").stem == "7" and os.fspath(RemotePath("s3://b/k")) == "s3://b/k"


# ---------------------------------------------------------------------------
# the run directory on memory://
# ---------------------------------------------------------------------------

def _tree(seed: float) -> dict:
    return {"params": {"w": torch.arange(12.0).reshape(3, 4) + seed, "b": torch.full((4,), seed)},
            "step": torch.tensor(int(seed))}


@pytest.mark.parametrize("async_save", [False, True])
def test_checkpoint_dir_on_memory(mem_root, monkeypatch, async_save):
    monkeypatch.setenv("SLURM_JOB_ID", "4242")
    ckpt = tckpt.CheckpointDir(tckpt.generate_checkpoint_path(mem_root, "exp"))
    assert isinstance(ckpt.path, RemotePath) and not ckpt.exists
    ckpt.create()
    assert ckpt.is_valid and ckpt.slurm_job_id == "4242" and ckpt.log_file.exists()
    ckpt.save_config({"lr": 0.1, "nested": {"a": [1, 2]}})
    assert ckpt.load_config().to_dict() == {"lr": 0.1, "nested": {"a": [1, 2]}}

    ckpt.state_manager("s", max_to_keep=2, async_save=async_save)
    for step in range(1, 5):
        ckpt.save_state(step, _tree(step), scope="s")
    ckpt.wait_until_finished()
    assert ckpt.latest_step("s") == 4 and ckpt.state_manager("s").all_steps() == [3, 4]
    _, local = ckpt.state_dir._fs()
    assert sorted(p.rsplit("/", 1)[-1] for p in MEM.ls(local + "/s", detail=False)) == ["3", "4"]
    assert MEM.exists(local + "/s/4/.metadata")
    assert ckpt.read_sharding_sidecar("s", 4)["specs"]["params/w"] == []
    # pruned in lockstep with the committed saves (an async save in flight keeps its predecessor's)
    sidecars = {f.name for f in (ckpt.path / "meta" / "_sharding" / "s").iterdir()}
    assert {"3.json", "4.json"} <= sidecars <= {"2.json", "3.json", "4.json"}

    template = {"params": {"w": torch.zeros(3, 4), "b": torch.zeros(4)}, "step": torch.tensor(0)}
    restored = ckpt.restore_state(template=template, scope="s")
    for got, want in ((restored["params"]["w"], _tree(4)["params"]["w"]), (restored["step"], torch.tensor(4))):
        assert torch.equal(got, want)
    assert ckpt.state_manager("s").keys(3) == {"params.w", "params.b", "step"}
    tckpt.write_requeue_verdict(ckpt.path, True, "preempted", "preemption", epoch=1)
    assert tckpt.read_requeue_verdict(ckpt.path)["kind"] == "preemption"
    assert str(tckpt.find_slurm_checkpoint(mem_root)) == str(ckpt.path)
    monkeypatch.setenv("SLURM_JOB_ID", "1")
    assert tckpt.find_slurm_checkpoint(mem_root) is None
    ckpt.close()


def test_remote_log_file_keeps_the_previous_attempt(mem_root):
    path = RemotePath(mem_root) / "log.txt"
    path.write_text("attempt 1\n")
    log = _RemoteLogFile(path, flush_interval=3600.0)
    log.write("attempt 2, line 1\n")
    log.flush()  # the first flush uploads ...
    assert path.read_text() == "attempt 1\nattempt 2, line 1\n"
    log.write("line 2\n")
    log.flush()  # ... the next ones wait for the interval
    assert path.read_text() == "attempt 1\nattempt 2, line 1\n"
    log.close()
    assert path.read_text() == "attempt 1\nattempt 2, line 1\nline 2\n"
    tee = IORedirector(str(path))
    assert isinstance(tee.log_path, RemotePath)


def _signal_after(stage, k: int) -> None:
    step = stage._train_step
    done = [0]

    def wrapped(batch):
        out = step(batch)
        done[0] += 1
        if done[0] == k:
            os.kill(os.getpid(), signal.SIGUSR1)
        return out

    stage._train_step = wrapped


def _final(stage) -> dict:
    sd = stage.state.state_dict()
    return {"params": {n: t.numpy().copy() for n, t in sd["params"].items()},
            "mu": {n: t.numpy().copy() for n, t in sd["opt_state"]["mu"].items()},
            "step": stage.state.step, "count": stage.state.optimizer.count,
            "losses": [float(x) for x in stage.train_losses]}


def _assert_final_equal(got: dict, want: dict, resumed_from: int):
    assert (got["step"], got["count"]) == (want["step"], want["count"])
    for part in ("params", "mu"):
        for name in want[part]:
            np.testing.assert_array_equal(got[part][name], want[part][name], err_msg=f"{part} {name}")
    assert got["losses"] == want["losses"][resumed_from:]


def test_train_lm_preempted_and_resumed_on_memory(mem_root):
    pipe, control = train_lm.build(ARGV)
    pipe.run()
    want = _final(control)

    pipe1, stage1 = train_lm.build(ARGV + ["--checkpoint-dir", mem_root], resume=True)
    pipe1.enable_preemption_handling(("SIGUSR1",))
    _signal_after(stage1, 4)
    pipe1.run()
    run_dir = pipe1.checkpoint_dir.path
    assert isinstance(run_dir, RemotePath) and str(run_dir).startswith(mem_root + "/lm-tiny-")
    assert stage1._mid_epoch_exit and stage1.state.step == 6
    assert tckpt.read_requeue_verdict(run_dir)["kind"] == "preemption"
    first_log = (run_dir / "log.txt").read_text()
    assert "Checkpoint: " + str(run_dir) in first_log

    pipe2, resumed = train_lm.build(ARGV + ["--checkpoint-dir", str(run_dir)], resume=True)
    pipe2.run()
    assert pipe2.resumed and pipe2.checkpoint_dir.path == run_dir
    _assert_final_equal(_final(resumed), want, resumed_from=6)
    log = (run_dir / "log.txt").read_text()
    assert log.startswith(first_log) and log.count("Checkpoint: ") == 2
    assert tckpt.read_requeue_verdict(run_dir)["kind"] == "completed"
    assert not os.path.exists(str(run_dir).replace("://", ":/")), "the URL leaked onto the local disk"


# ---------------------------------------------------------------------------
# two processes, file://
# ---------------------------------------------------------------------------

_WORKER = textwrap.dedent(
    """
    import os, pickle, sys
    import torch
    sys.path.insert(0, os.environ["TEST_DIR"])
    from dmlcloud_tpu_torch.examples import train_lm
    from dmlcloud_tpu_torch.parallel import runtime
    from test_torch_remote import ARGV, _final, _signal_after

    torch.set_num_threads(1)
    pipe, control = train_lm.build(ARGV)
    pipe.run()
    out = {"control": _final(control)}
    pipe1, stage1 = train_lm.build(ARGV + ["--checkpoint-dir", os.environ["ROOT"]], resume=True)
    pipe1.enable_preemption_handling(("SIGUSR1",))
    if runtime.rank() == 0:
        _signal_after(stage1, 4)  # one rank's signal drains both
    pipe1.run()
    out["drained_at"] = stage1.state.step
    out["run_dir"] = str(pipe1.checkpoint_dir.path)
    pipe2, resumed = train_lm.build(ARGV + ["--checkpoint-dir", out["run_dir"]], resume=True)
    pipe2.run()
    out["resumed"] = _final(resumed)
    with open(f"rank{runtime.rank()}.pkl", "wb") as f:
        pickle.dump(out, f)
    runtime.barrier("done", timeout=60)
    runtime.deinitialize()
    """
)


def test_two_processes_on_a_file_url(tmp_path):
    out_dir, root = tmp_path / "out", tmp_path / "runs"
    out_dir.mkdir()
    port = tcp.find_free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(rank), WORLD_SIZE="2",
                   OMP_NUM_THREADS="1", PYTHONPATH=str(REPO), TEST_DIR=str(Path(__file__).parent),
                   ROOT=f"file://{root}")
        # output to files: a full pipe would block one rank inside a collective, and with it the other
        with open(out_dir / f"log{rank}.txt", "w") as log:
            procs.append(subprocess.Popen([sys.executable, "-c", _WORKER], env=env, cwd=out_dir, stdout=log,
                                          stderr=subprocess.STDOUT))
    try:
        for p in procs:
            p.wait(timeout=240)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), [(out_dir / f"log{r}.txt").read_text()[-3000:] for r in range(2)]
    outs = [pickle.load(open(out_dir / f"rank{r}.pkl", "rb")) for r in range(2)]
    run_dir = outs[0]["run_dir"]
    assert run_dir.startswith(f"file://{root}/lm-tiny-") and outs[1]["run_dir"] == run_dir
    local = Path(run_dir[len("file://"):])
    # the resumed run's step-9 save (retention dropped step 6's) and its epoch save
    assert (local / "state" / "LMStage.steps" / "9" / ".metadata").is_file()
    assert (local / "state" / "LMStage" / "1" / ".metadata").is_file()
    assert (local / "log.txt").read_text().count("Checkpoint: ") == 2
    for out in outs:
        assert out["drained_at"] == 6
        _assert_final_equal(out["resumed"], out["control"], resumed_from=6)
