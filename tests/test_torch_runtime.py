"""The port's cluster bootstrap against the JAX package's, on the CPU.

The Slurm parsers are copies and must agree with the reference on a table of
``SLURM_*`` environments; ``init_auto`` climbs env:// -> Slurm -> MPI ->
single; ``PreemptionGuard`` answers like the reference's guard on the same
signal sequence. Two gloo processes then show the coordinated drain (one rank
catches the signal, both stop) and a ``barrier`` timeout that names the rank
that never arrived; two more run the object collectives (``root=``, explicit
and call-site tags, ``CollectiveMismatchError``, the keys' clean-up),
``pipeline.barrier(timeout)`` and ``Stage.barrier_timeout``.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from dmlcloud_tpu.parallel import runtime as jruntime
from dmlcloud_tpu.utils import slurm as jslurm
from dmlcloud_tpu_torch.parallel import runtime
from dmlcloud_tpu_torch.utils import slurm, tcp

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent

SLURM_VARS = ["SLURM_JOB_ID", "SLURM_STEP_ID", "SLURM_PROCID", "SLURM_NTASKS", "SLURM_STEP_NUM_TASKS",
              "SLURM_LOCALID", "SLURM_NODEID", "SLURM_STEP_TASKS_PER_NODE", "SLURM_TASKS_PER_NODE",
              "SLURM_SRUN_COMM_HOST", "SLURM_JOB_NODELIST", "SLURM_NODELIST"]

SLURM_ENVS = [
    {},
    {"SLURM_JOB_ID": "77", "SLURM_STEP_ID": "0", "SLURM_PROCID": "3", "SLURM_NTASKS": "8", "SLURM_LOCALID": "1",
     "SLURM_NODEID": "1", "SLURM_STEP_TASKS_PER_NODE": "4(x2)", "SLURM_JOB_NODELIST": "node[017-018]"},
    {"SLURM_PROCID": "5", "SLURM_STEP_NUM_TASKS": "7", "SLURM_NODEID": "2", "SLURM_TASKS_PER_NODE": "3(x2),1",
     "SLURM_NODELIST": "gpu-a,gpu-b,gpu-c"},
    {"SLURM_PROCID": "0", "SLURM_NTASKS": "2", "SLURM_NODEID": "9", "SLURM_STEP_TASKS_PER_NODE": "2",
     "SLURM_SRUN_COMM_HOST": "login1", "SLURM_JOB_NODELIST": "node[1-4]"},
    {"SLURM_PROCID": "1", "SLURM_NTASKS": "4", "SLURM_STEP_TASKS_PER_NODE": "bogus,2", "SLURM_JOB_NODELIST": "solo"},
]

PARSERS = ["slurm_job_id", "slurm_step_id", "slurm_available", "slurm_rank", "slurm_world_size",
           "slurm_local_rank", "slurm_node_id", "slurm_tasks_per_node", "slurm_head_node"]


@pytest.fixture
def clean_env(monkeypatch):
    for var in SLURM_VARS + ["MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "DMLCLOUD_TPU_PORT"]:
        monkeypatch.delenv(var, raising=False)
    return monkeypatch


@pytest.mark.parametrize("env", SLURM_ENVS, ids=range(len(SLURM_ENVS)))
def test_slurm_parsers_agree_with_the_reference(clean_env, env):
    for key, value in env.items():
        clean_env.setenv(key, value)
    for name in PARSERS:
        assert getattr(slurm, name)() == getattr(jslurm, name)(), name
    assert runtime.has_slurm() == jruntime.has_slurm() == ("SLURM_PROCID" in env)


def test_tcp_helpers():
    port = tcp.find_free_port()
    assert 0 < port < 65536
    with socket.socket() as s:
        s.bind(("", port))  # it was free
    assert tcp.get_local_ips() and all(isinstance(ip, str) for ip in tcp.get_local_ips())


@pytest.fixture
def ladder(clean_env):
    """``init_auto`` with every rung stubbed to record its name."""
    chosen = []
    for name in ("init_from_env", "init_slurm", "init_mpi", "init_single"):
        clean_env.setattr(runtime, name, lambda *a, n=name, **k: chosen.append(n))
    clean_env.setattr(runtime, "_info", runtime._WorkerInfo())
    return clean_env, chosen


@pytest.mark.parametrize("env, mpi, want", [
    ({"MASTER_ADDR": "h", "MASTER_PORT": "1", "RANK": "0", "WORLD_SIZE": "2", "SLURM_PROCID": "0"}, True,
     "init_from_env"),
    ({"SLURM_PROCID": "0", "SLURM_NTASKS": "2"}, True, "init_slurm"),
    ({"MASTER_ADDR": "h", "RANK": "0"}, True, "init_mpi"),  # an incomplete env:// set is no env rung
    ({}, False, "init_single"),
])
def test_init_auto_ladder(ladder, env, mpi, want):
    monkeypatch, chosen = ladder
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    monkeypatch.setattr(runtime, "has_mpi", lambda: mpi)
    runtime.init_auto("cpu")
    assert chosen == [want]


def test_init_slurm_rendezvous_at_the_head_node(clean_env):
    calls = []
    clean_env.setattr(runtime, "_init_group", lambda *a: calls.append(a))
    with pytest.raises(RuntimeError, match="Slurm environment incomplete"):
        runtime.init_slurm("cpu")
    for key, value in SLURM_ENVS[1].items():
        clean_env.setenv(key, value)
    runtime.init_slurm("cpu", port=5123)
    # device, init method, rank, world, local rank, local world, node, timeout
    assert calls == [("cpu", "tcp://node017:5123", 3, 8, 1, 4, 1, 600.0)]


def test_root_helpers_at_world_one(capsys):
    runtime.init_single()
    try:
        assert runtime.root_only(lambda: 5)() == 5
        with runtime.root_first():
            pass
        runtime.barrier("noop", timeout=0.01)
        runtime.print_root("hello")
        runtime.print_worker("there")
        assert (runtime.local_rank(), runtime.local_world_size(), runtime.local_node()) == (0, 1, 0)
        assert runtime.broadcast_object({"a": 1}) == {"a": 1} and runtime.all_gather_object(3) == [3]
    finally:
        runtime.deinitialize()
    out = capsys.readouterr().out
    assert "hello" in out and "Worker 0 (0.0): there" in out


@pytest.mark.parametrize("signals", [("SIGUSR1",), ("SIGUSR1", "SIGUSR2")])
def test_preemption_guard_matches_the_reference(signals):
    """install, trigger, uninstall, re-arm: both guards answer the same."""
    before = {s: signal.getsignal(getattr(signal, s)) for s in signals}
    log = {}
    for name, mod in (("port", runtime), ("jax", jruntime)):
        guard = mod.PreemptionGuard(signals=signals)
        trace = [guard.coordinated(), guard.armed]  # not armed: never drains
        guard.install()
        trace += [guard.coordinated(), guard.triggered]
        os.kill(os.getpid(), getattr(signal, signals[-1]))
        trace += [guard.coordinated(), guard.signal_name, guard.triggered_at is not None]
        guard.install()  # re-arm: clears the flag, keeps the ORIGINAL disposition
        trace += [guard.coordinated(), guard.signal_name]
        guard.uninstall()
        trace += [guard.armed, guard.coordinated(), all(signal.getsignal(getattr(signal, s)) == before[s]
                                                        for s in signals)]
        log[name] = trace
    assert log["port"] == log["jax"]
    assert log["port"] == [False, False, False, False, True, signals[-1], True, False, None, False, False, True]


def test_preemption_guard_resolves_every_name_before_installing():
    before = signal.getsignal(signal.SIGUSR1)
    for mod in (runtime, jruntime):
        with pytest.raises(AttributeError):
            mod.PreemptionGuard(signals=("SIGUSR1", "SIGNOPE")).install()
        assert signal.getsignal(signal.SIGUSR1) == before  # nothing half-installed


def test_preemption_guard_default_signals(clean_env):
    assert runtime.PreemptionGuard().signals == jruntime.PreemptionGuard().signals == ("SIGTERM", "SIGINT")
    clean_env.setenv("SLURM_PROCID", "0")
    assert runtime.PreemptionGuard().signals == jruntime.PreemptionGuard().signals == (
        "SIGTERM", "SIGINT", "SIGUSR1")


_WORKER = textwrap.dedent(
    """
    import json, os, signal, time
    import torch
    from dmlcloud_tpu_torch.parallel import runtime

    assert runtime.init_auto(device="cpu") == "gloo"
    rank = runtime.rank()
    gathers = []
    gather = runtime.all_gather_object
    runtime.all_gather_object = lambda obj: (gathers.append(1), gather(obj))[1]
    guard = runtime.PreemptionGuard(signals=("SIGUSR1",)).install()
    runtime.barrier("armed", timeout=60)
    if rank == 1:
        os.kill(os.getpid(), signal.SIGUSR1)  # only rank 1 is told
    runtime.barrier("signalled", timeout=60)
    drain = guard.coordinated()
    guard.uninstall()
    # rank 1 never reaches this barrier: rank 0 must name it
    error = None
    if rank == 0:
        try:
            runtime.barrier("late", timeout=2)
        except runtime.BarrierTimeout as e:
            error = {"tag": e.tag, "stragglers": e.stragglers, "state": runtime.barrier_state()["status"]}
    print(json.dumps({"rank": rank, "triggered": guard.triggered, "drain": drain, "gathers": len(gathers),
                      "error": error}), flush=True)
    runtime.all_gather_object(rank)  # both ranks leave together
    runtime.deinitialize()
    """
)


def test_two_gloo_processes_drain_together_and_name_the_barrier_straggler():
    port = tcp.find_free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(rank), WORLD_SIZE="2",
                   OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
        procs.append(subprocess.Popen([sys.executable, "-c", _WORKER], env=env, cwd=REPO,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = {}
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err[-3000:]
        o = json.loads(out.strip().splitlines()[-1])
        outs[o["rank"]] = o
    assert outs[0]["triggered"] is False and outs[1]["triggered"] is True
    assert outs[0]["drain"] is True and outs[1]["drain"] is True  # one signal, both stop
    assert outs[0]["gathers"] == outs[1]["gathers"] == 1  # one all_gather_object per poll
    assert outs[0]["error"] == {"tag": "late", "stragglers": [1], "state": "timeout"}


_OBJ_WORKER = textwrap.dedent(
    """
    import json, time
    import torch
    import dmlcloud_tpu_torch as dml
    from dmlcloud_tpu_torch.parallel import runtime

    assert runtime.init_auto(device="cpu") == "gloo"
    rank = runtime.rank()
    out = {"rank": rank}
    out["bcast"] = runtime.broadcast_object({"from": rank} if rank == 1 else None, root=1, tag="cfg", timeout=30)
    out["agather"] = runtime.all_gather_object(rank * 10)
    out["gather"] = runtime.gather_object({"r": rank}, root=0)
    # matching calls from different lines pair up under one explicit tag
    if runtime.is_root():
        out["same_tag"] = runtime.broadcast_object("root says", tag="split")
    else:
        out["same_tag"] = runtime.broadcast_object(tag="split")
    # ... and without a tag they are a divergence
    try:
        if runtime.is_root():
            runtime.all_gather_object("a")
        else:
            runtime.all_gather_object("b")
        out["mismatch"] = None
    except runtime.CollectiveMismatchError as e:
        out["mismatch"] = str(e)
    # pipeline.barrier(timeout): rank 1 comes 3 s late to a 1 s barrier
    pipe = dml.TrainingPipeline(device="cpu")
    if rank == 1:
        time.sleep(3)
    try:
        pipe.barrier(1)
        out["late"] = None
    except runtime.BarrierTimeout as e:
        out["late"] = {"timeout": e.timeout, "stragglers": e.stragglers}
    runtime.barrier("realign", timeout=60)
    # the stage's barrier_timeout reaches both stage barriers
    seen = []
    barrier = runtime.barrier
    runtime.barrier = lambda tag="", timeout=600.0: (seen.append([tag, timeout]), barrier(tag, timeout))[1]

    class Stage(dml.TrainValStage):
        def pre_stage(self):
            self.pipeline.register_model("m", torch.nn.Linear(2, 1), verbose=False)
            self.pipeline.register_optimizer("adam", dml.optim.adamw(1e-3))
            self.pipeline.register_dataset("train", [torch.ones(2, 2)], verbose=False)

        def step(self, state, x):
            return state.model(x).square().mean()

    stage = Stage()
    stage.barrier_timeout = 45.0
    pipe = dml.TrainingPipeline(device="cpu")
    pipe.append_stage(stage, max_epochs=1)
    pipe.run()
    runtime.barrier = barrier
    out["stage_barriers"] = [t for tag, t in seen if tag == "pipeline"]
    out["store_keys_left"] = sum(1 for k in range(1, 5) if runtime.dist.distributed_c10d._get_default_store()
                                 .check([f"dmlcloud_tpu/obj/all_gather_object/{k}/0"]))
    print(json.dumps(out), flush=True)
    runtime.barrier("done", timeout=60)
    runtime.deinitialize()
    """
)


def test_object_collectives_tags_and_barrier_timeouts_over_two_gloo_processes(tmp_path):
    port = tcp.find_free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(rank), WORLD_SIZE="2",
                   OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
        with open(tmp_path / f"log{rank}.txt", "w") as log:  # a full pipe would stall one rank in a collective
            procs.append(subprocess.Popen([sys.executable, "-c", _OBJ_WORKER], env=env, cwd=tmp_path,
                                          stdout=log, stderr=subprocess.STDOUT, text=True))
    try:
        for p in procs:
            p.wait(timeout=120)
    finally:
        for p in procs:
            p.kill()
    outs = {}
    for rank, p in enumerate(procs):
        text = (tmp_path / f"log{rank}.txt").read_text()
        assert p.returncode == 0, text[-3000:]
        o = json.loads(next(line for line in reversed(text.splitlines()) if line.startswith('{"rank"')))
        outs[o["rank"]] = o
    for r in (0, 1):
        assert outs[r]["bcast"] == {"from": 1}  # root=1
        assert outs[r]["agather"] == [0, 10]
        assert outs[r]["same_tag"] == "root says"
        # each rank names the other's call site, file and line
        assert "test_torch_runtime" not in outs[r]["mismatch"]  # the worker runs as <string>
        assert "rank %d published from <string>:" % (1 - r) in outs[r]["mismatch"]
        # the run's two start barriers at the default, then the stage's start and end
        assert outs[r]["stage_barriers"] == [600.0, 600.0, 45.0, 45.0]
    assert outs[0]["gather"] == [{"r": 0}, {"r": 1}] and outs[1]["gather"] is None
    assert outs[0]["late"] == {"timeout": 1.0, "stragglers": [1]}
    assert outs[1]["late"] is None  # rank 0's arrival key was already there
    assert outs[0]["store_keys_left"] == 0  # the last reader deleted the payloads


def test_object_collective_signature_matches_the_reference():
    import inspect

    for name in ("broadcast_object", "all_gather_object", "gather_object"):
        want = list(inspect.signature(getattr(jruntime, name)).parameters)
        assert list(inspect.signature(getattr(runtime, name)).parameters) == want, name
    assert runtime.gather_object(5) == [5]  # world 1: no process group
