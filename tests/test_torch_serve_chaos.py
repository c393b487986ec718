"""Chaos drills and drain verdicts of the port's engine against the JAX
package's, on the CPU (tests/test_serve.py ``TestChaosDrill``,
``TestSpecChaos``, ``TestDrainAndVerdict``, ``TestFailedAdmitChaos``).

- The seeded drill (step faults, pool squats, clock stalls, random cancels,
  deadlines) over the same trace under the same fake clock, on a plain and on
  a prefix-cache engine: the monkey's event log, every request's terminal
  status and every greedy survivor's tokens are the reference's;
  ``assert_consistent()`` holds after every step and nothing leaks (blocks,
  prefix locks). The drill replays itself; a squat only stalls; a step fault
  fails only its rows.
- A verify fault in a speculative round fails exactly the reference's rows.
- Failed admits (oversized prompts) interleaved with sheds, faults and squats
  end with the reference's statuses and census.
- ``drain()``: a manual drain, a blown drain budget, a tripped
  ``PreemptionGuard`` and a ``HangWatchdog.serve_guard`` hang write a
  ``requeue.json`` whose fields, times aside, equal the reference's.
- The chaos monkey's replica events attach to the Router (drilled against the
  reference in tests/test_torch_serve_router.py).
"""

import json
import tempfile

import numpy as np
import pytest
import torch

from dmlcloud_tpu.checkpoint import read_requeue_verdict as jread_verdict
from dmlcloud_tpu.parallel.runtime import PreemptionGuard as JGuard
from dmlcloud_tpu.serve import ChaosMonkey as JMonkey
from dmlcloud_tpu.serve.engine import ServeEngine as JEngine
from dmlcloud_tpu.telemetry.watchdog import HangWatchdog as JWatchdog
from dmlcloud_tpu_torch.checkpoint import read_requeue_verdict
from dmlcloud_tpu_torch.parallel.runtime import PreemptionGuard
from dmlcloud_tpu_torch.serve import TERMINAL_STATUSES, ChaosMonkey, ServeEngine
from dmlcloud_tpu_torch.telemetry.watchdog import HangWatchdog
from test_torch_serve import _Clock, _models, _port_generate, _prompt

torch.set_num_threads(2)


def _engine(pkg, clock=None, **kw):
    kw = dict(dict(num_blocks=64, block_size=4, max_slots=2, prefill_chunk=8), **kw)
    if clock is not None:
        kw["clock"] = clock
    jmodel, params, tmodel = _models()
    if pkg == "jax":
        return JEngine(jmodel, params, batch_buckets=[kw["max_slots"]], table_buckets=[16], **kw)
    return ServeEngine(tmodel, **kw)


def _step_all(engine, max_steps=4000):
    steps = 0
    while not engine.idle and steps < max_steps:
        engine.step()
        engine.pool.assert_consistent()
        if engine.draft_pool is not None:
            engine.draft_pool.assert_consistent()
        steps += 1


# ---------------------------------------------------------------------------
# the seeded drill
# ---------------------------------------------------------------------------

def _drill(pkg, prefix):
    rs = np.random.RandomState(31)
    specs = [(int(rs.randint(1, 16)), int(rs.randint(1, 8)), float(rs.uniform(0.02, 0.3)) if rs.rand() < 0.3 else None)
             for _ in range(16)]
    engine = _engine(pkg, clock=_Clock(tick=1e-3), num_blocks=48, max_slots=3, prefix_cache=prefix)
    monkey = (JMonkey if pkg == "jax" else ChaosMonkey)(
        seed=37, p_fault=0.08, max_faults=4, p_exhaust=0.15, exhaust_blocks=6, exhaust_steps=2, p_stall=0.05,
        stall_s=0.05, p_cancel=0.08)
    monkey.attach(engine)
    rids = [engine.submit(_prompt(n, seed=500 + i), m, deadline_s=d) for i, (n, m, d) in enumerate(specs)]
    _step_all(engine)
    monkey.detach()
    statuses = [engine.status(r) for r in rids]
    out = {
        "log": list(monkey.log),
        "statuses": statuses,
        "survivors": {i: np.asarray(engine.output(r)).tolist() for i, (r, s) in enumerate(zip(rids, statuses))
                      if s == "ok"},
        "census": engine.ledger.status_counts(),
        "leaked": engine.leaked_blocks(),
        "locks": engine.prefix.leaked_locks() if prefix else [],
    }
    return out, specs


@pytest.mark.parametrize("prefix", [False, True], ids=["plain", "prefix_cache"])
def test_seeded_drill_replays_the_references_faults_and_statuses(prefix):
    want, specs = _drill("jax", prefix)
    got, _ = _drill("torch", prefix)
    assert got == want
    assert all(s in TERMINAL_STATUSES for s in got["statuses"])
    assert got["leaked"] == 0 and got["locks"] == []
    assert got["survivors"], "drill too hot: no survivors"
    assert {kind for _, kind, _ in got["log"]} >= {"fault", "exhaust", "cancel"}
    for i, toks in got["survivors"].items():
        n, m, _ = specs[i]
        assert toks == _port_generate(_prompt(n, seed=500 + i), m).tolist()


def test_drill_is_replayable():
    logs = []
    for _ in range(2):
        engine = _engine("torch", num_blocks=32)
        monkey = ChaosMonkey(seed=41, p_fault=0.1, max_faults=3, p_cancel=0.1).attach(engine)
        for i in range(8):
            engine.submit(_prompt(4 + (i % 3) * 4, seed=600 + i), 3 + (i % 2))
        engine.run(max_steps=2000)
        monkey.detach()
        logs.append((list(monkey.log), engine.ledger.status_counts(), engine.leaked_blocks()))
    assert logs[0] == logs[1] and logs[0][2] == 0


def test_pool_exhaustion_squat_only_stalls():
    engine = _engine("torch", num_blocks=24)
    monkey = ChaosMonkey(seed=43, p_exhaust=0.5, exhaust_blocks=12, exhaust_steps=2).attach(engine)
    rids = [engine.submit(_prompt(5, seed=700 + i), 4) for i in range(6)]
    engine.run(max_steps=3000)
    monkey.detach()
    assert all(engine.status(r) == "ok" for r in rids)
    assert any(kind == "exhaust" for _, kind, _ in monkey.log)
    assert engine.pool.num_free == engine.pool.num_blocks


def test_step_fault_fails_only_its_rows():
    engine = _engine("torch", max_slots=1)
    monkey = ChaosMonkey(seed=47, p_fault=1.0, fault_points=("decode",), max_faults=1).attach(engine)
    r_hit = engine.submit(_prompt(5, seed=800), 6)
    r_ok = engine.submit(_prompt(5, seed=801), 6)
    engine.run(max_steps=2000)
    monkey.detach()
    assert engine.status(r_hit) == "error" and engine.status(r_ok) == "ok"
    np.testing.assert_array_equal(engine.output(r_ok), _port_generate(_prompt(5, seed=801), 6))
    assert engine.pool.num_free == engine.pool.num_blocks


def test_verify_fault_fails_the_references_rows():
    res = []
    for pkg in ("jax", "torch"):
        engine = _engine(pkg, spec_k=2)
        monkey = (JMonkey if pkg == "jax" else ChaosMonkey)(seed=61, p_fault=1.0, fault_points=("verify",),
                                                            max_faults=1)
        monkey.attach(engine)
        rids = [engine.submit(_prompt(4, seed=970 + i), 5) for i in range(3)]
        _step_all(engine, 3000)
        monkey.detach()
        res.append(([engine.status(r) for r in rids], list(monkey.log),
                    {i: np.asarray(engine.output(r)).tolist() for i, r in enumerate(rids)
                     if engine.status(r) == "ok"}, engine.leaked_blocks()))
    assert res[1] == res[0]
    assert res[1][0].count("error") >= 1 and "ok" in res[1][0] and res[1][3] == 0


def test_failed_admits_interleaved_with_chaos_end_as_the_reference():
    res = []
    for pkg in ("jax", "torch"):
        rs = np.random.RandomState(67)
        engine = _engine(pkg, num_blocks=16, max_waiting=3, shed_policy="oldest-deadline")
        monkey = (JMonkey if pkg == "jax" else ChaosMonkey)(seed=71, p_fault=0.05, max_faults=2, p_exhaust=0.2,
                                                            exhaust_blocks=4, exhaust_steps=1, p_cancel=0.1)
        monkey.attach(engine)
        accepted, failed = [], 0
        for i in range(18):
            if rs.random_sample() < 0.25:
                with pytest.raises(ValueError):  # exceeds max_seq_len
                    engine.submit(_prompt(50, seed=i), 20)
                failed += 1
            else:
                accepted.append(engine.submit(_prompt(int(rs.randint(1, 10)), seed=1000 + i), int(rs.randint(1, 6))))
            for _ in range(int(rs.randint(0, 3))):
                engine.step()
        engine.run(max_steps=3000)
        monkey.detach()
        res.append(([engine.status(r) for r in accepted], failed, engine.ledger.status_counts(), len(engine._all),
                    list(monkey.log), engine.leaked_blocks()))
    assert res[1] == res[0]
    statuses, failed, census, n_all, _, leaked = res[1]
    assert failed > 0 and n_all == len(statuses) and sum(census.values()) == len(statuses) and leaked == 0


def test_replica_events_wait_for_the_router():
    """The replica events need a Router: the monkey takes them as arguments,
    attaches to one router (or one engine), and its kill spares the last
    standing replica."""
    from dmlcloud_tpu_torch.serve import Router

    monkey = ChaosMonkey(seed=0, p_replica_kill=1.0, max_replica_kills=2, p_replica_stall=0.1)
    router = Router([_engine("torch"), _engine("torch")], backoff_base_s=0.0)
    assert monkey.attach_router(router) is monkey and router.fault_injector is monkey
    with pytest.raises(RuntimeError, match="already attached"):
        monkey.attach(_engine("torch"))
    rid = router.submit(_prompt(5, seed=900), 3)
    router.run(max_steps=200)
    monkey.detach_router()
    assert router.fault_injector is None and monkey.replica_kills == 1
    assert [kind for _, kind, _ in monkey.log].count("replica_kill") == 1
    assert router.status(rid) == "ok" and router.leaked_blocks() == 0


# ---------------------------------------------------------------------------
# drain and the requeue verdict
# ---------------------------------------------------------------------------

def _drain(pkg, case, run_dir):
    t = [0.0]
    clock = lambda: t[0]
    kw = dict(max_slots=1, run_dir=run_dir)
    if case == "budget":
        kw["drain_budget_s"] = 1.0
    if case == "preemption":
        guard = (JGuard if pkg == "jax" else PreemptionGuard)()
        guard.triggered = True  # the documented out-of-band path
        guard.signal_name = "SIGTERM"
        kw["preemption"] = guard
    engine = _engine(pkg, clock=clock, **kw)
    if case == "hang":
        wt = [0.0]
        wd = (JWatchdog if pkg == "jax" else HangWatchdog)(run_dir, threshold_s=10.0, clock=lambda: wt[0])
        wd.serve_guard(engine)
    r_run = engine.submit(_prompt(5, seed=70), 30 if case == "budget" else 4)
    queued = [engine.submit(_prompt(4, seed=71 + i), 3) for i in range(2)]
    engine.step()
    if case == "manual":
        verdict = engine.drain(max_steps=2000)
        late = engine.submit(_prompt(4, seed=75), 3)  # admission stays closed
        extra = [engine.status(late)]
    elif case == "budget":
        engine.step()
        engine.request_drain("test shutdown")
        t[0] = 5.0  # blow the budget
        verdict = engine.drain(max_steps=100)
        extra = []
    elif case == "preemption":
        verdict = engine.drain(max_steps=2000)
        extra = []
    else:
        wt[0] = 5.0
        extra = [wd.check() is None]
        wt[0] = 100.0
        extra += [wd.check() is not None, engine.draining, engine._drain_kind, engine._drain_requeue]
        verdict = engine.drain(max_steps=2000)
    on_disk = (jread_verdict if pkg == "jax" else read_requeue_verdict)(run_dir)
    for v in (verdict, on_disk):
        v["serve"].pop("drain_s")
    on_disk.pop("written_at")
    return (verdict, on_disk, [engine.status(r) for r in [r_run, *queued]], extra, engine.leaked_blocks(),
            engine.pool.num_free == engine.pool.num_blocks)


@pytest.mark.parametrize("case", ["manual", "budget", "preemption", "hang"])
def test_drain_writes_the_references_verdict(case):
    with tempfile.TemporaryDirectory() as jdir, tempfile.TemporaryDirectory() as tdir:
        want, got = _drain("jax", case, jdir), _drain("torch", case, tdir)
        files = sorted(p.name for p in __import__("pathlib").Path(tdir).iterdir())
    assert json.loads(json.dumps(got)) == json.loads(json.dumps(want))
    verdict, on_disk, statuses, extra, leaked, clean = got
    assert on_disk["v"] == 1 and on_disk["requeue"] == verdict["requeue"] and leaked == 0 and clean
    assert "requeue.json" in files
    if case == "manual":
        assert verdict["kind"] == "completed" and not verdict["requeue"] and statuses == ["ok", "shed", "shed"]
        assert extra == ["shed"]
    elif case == "budget":
        assert statuses[0] == "shed" and verdict["serve"]["drained_clean"]
    elif case == "preemption":
        assert verdict["kind"] == "preemption" and verdict["requeue"] and verdict["reason"] == "preemption:SIGTERM"
    else:
        assert extra == [True, True, True, "hang", True] and verdict["kind"] == "hang"


def test_drain_writes_the_verdict_to_a_url():
    """``run_dir`` may be any fsspec URL: the verdict goes through
    ``checkpoint.write_requeue_verdict`` and reads back."""
    engine = _engine("torch", run_dir="memory://serve-drain-verdict")
    engine.submit(_prompt(5, seed=70), 3)
    engine.step()  # admitted: the drain lets it finish
    verdict = engine.drain(reason="rolling restart", requeue=True)
    on_disk = read_requeue_verdict("memory://serve-drain-verdict")
    assert on_disk["reason"] == "rolling restart" and on_disk["requeue"] is True
    assert on_disk["serve"]["statuses"] == verdict["serve"]["statuses"] == {"ok": 1}
