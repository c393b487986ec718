"""The port's cluster bootstrap against the JAX package's, on the CPU.

The Slurm parsers are copies and must agree with the reference on a table of
``SLURM_*`` environments; ``init_auto`` climbs env:// -> Slurm -> MPI ->
single; ``PreemptionGuard`` answers like the reference's guard on the same
signal sequence. Two gloo processes then show the coordinated drain (one rank
catches the signal, both stop) and a ``barrier`` timeout that names the rank
that never arrived.
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
