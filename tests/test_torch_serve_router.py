"""The port's multi-replica ``Router`` against the JAX package's, on the CPU
(tests/test_serve_router.py).

Every scenario runs the reference ``Router`` and the port's side by side on
the same trace and the same fake clock, each over stub engines of its own
package (a stub raises its own package's ``DuplicateRequest`` and keeps its
own ``ServeLedger``, so the re-attach path and ``ttfts`` run on each side),
and asserts equal placements (replica, engine id, token, retries and trace
per request), statuses, summaries (``failovers``, ``kills``, breaker states),
drain verdicts, journal spans per trace and ``metrics_text`` pages; then the
reference test's own asserts on the port:

- routing (``TestRouterBasics``): least-outstanding spread, per-tenant FIFO
  under DRR, queued cancel, unknown ids;
- failover (``TestFailover``): a missed heartbeat, retries exhausted to
  ``error``, a kill that reaps the engine and keeps the token, the
  ``DuplicateRequest`` re-attach;
- the circuit breaker (``TestCircuitBreaker``): trip, half-open probe,
  close; a failed probe doubling the cooldown;
- drain and affinity (``TestDrainAndAffinity``): queued requests migrate
  with a ``.m`` token, the verdict, affinity and its fallback;
- telemetry and traces (``TestRouterTelemetry``, ``TestTracePropagation``):
  the ``route``/``failover``/``replica_drain`` spans, one trace per request
  across a failover, zero orphans in a kill-one, drain-one drill, the
  exhausted-retries status stamped on the trace;
- the seeded replica-chaos drill (the reference's ``_DET_SCRIPT``): the
  port's event log, statuses and counters, in two interpreters under
  ``PYTHONHASHSEED`` 0 and 4271, are the reference's byte for byte;
- tiny models (``TestRouterIntegration``): 3 replicas, a kill and a drain;
  the survivors' greedy tokens equal the reference Router's over reference
  engines (one module-scoped run) and the port's serial ``generate``; a
  killed replica is reaped to 0 leaked blocks with and without the prefix
  cache; the random property drill under a tight pool (``slow``, as in the
  reference).
"""

import contextlib
import io
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from dmlcloud_tpu.checkpoint import read_requeue_verdict as jread_verdict
from dmlcloud_tpu.serve import ChaosMonkey as JMonkey
from dmlcloud_tpu.serve import DuplicateRequest as JDuplicate
from dmlcloud_tpu.serve import Router as JRouter
from dmlcloud_tpu.serve import ServeLedger as JLedger
from dmlcloud_tpu.serve.engine import ServeEngine as JEngine
from dmlcloud_tpu.telemetry import journal as jjournal
from dmlcloud_tpu.telemetry import metrics_registry as jreg
from dmlcloud_tpu_torch.checkpoint import read_requeue_verdict
from dmlcloud_tpu_torch.serve import (TERMINAL_STATUSES, ChaosMonkey, DuplicateRequest, Router, ServeEngine,
                                      ServeLedger)
from dmlcloud_tpu_torch.telemetry import journal as tjournal
from dmlcloud_tpu_torch.telemetry import metrics_registry as treg
from test_torch_serve import _models, _port_generate, _prompt

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: per package: its Router, DuplicateRequest, ServeLedger, journal, metrics registry and verdict reader
PKG = {
    "jax": types.SimpleNamespace(Router=JRouter, Duplicate=JDuplicate, Ledger=JLedger, journal=jjournal, reg=jreg,
                                 read_verdict=jread_verdict, Monkey=JMonkey),
    "torch": types.SimpleNamespace(Router=Router, Duplicate=DuplicateRequest, Ledger=ServeLedger, journal=tjournal,
                                   reg=treg, read_verdict=read_requeue_verdict, Monkey=ChaosMonkey),
}


# ---------------------------------------------------------------------------
# a fake clock and a pure-host stub engine per package (tests/test_serve_router.py:68-190)
# ---------------------------------------------------------------------------

class _Clock:
    def __init__(self, t=0.0):
        self.t = float(t)

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += float(dt)


class _StubPool:
    def __init__(self, block_size=4, num_blocks=64):
        self.block_size = block_size
        self.num_blocks = num_blocks

    def blocks_for(self, tokens):
        return max(1, -(-int(tokens) // self.block_size))

    def assert_consistent(self):
        pass


class _StubEngine:
    """The reference test's stub over one package's ``DuplicateRequest``,
    ``ServeLedger`` and metrics registry: ``steps_to_finish`` steps of service,
    ``max_slots`` running at once, ``fail_next`` raising steps."""

    def __init__(self, pkg, *, clock=None, steps_to_finish=2, max_slots=4, block_size=4, num_blocks=64,
                 prefill_chunk=8):
        self.pkg = PKG[pkg]
        self.pool = _StubPool(block_size, num_blocks)
        self.draft_pool = None
        self.scheduler = types.SimpleNamespace(prefill_chunk=prefill_chunk)
        self.ledger = self.pkg.Ledger()
        self.clock = clock if clock is not None else _Clock()
        self.steps_to_finish = steps_to_finish
        self.max_slots = max_slots
        self.fail_next = 0
        self._all = {}
        self._tokens = {}
        self._next = 0
        self.steps = 0
        self.submits = []  # (rid, token, tenant, trace) admission audit trail

    def submit(self, prompt, max_new_tokens=32, *, token=None, tenant=None, trace=None, **kw):
        if token is not None and token in self._tokens:
            raise self.pkg.Duplicate(token, self._tokens[token])
        rid = self._next
        self._next += 1
        self._all[rid] = {"status": None, "left": self.steps_to_finish, "prompt": np.asarray(prompt, np.int32),
                          "max_new": int(max_new_tokens)}
        if token is not None:
            self._tokens[token] = rid
        self.ledger.arrived(rid, self.clock(), tenant=tenant)
        self.submits.append((rid, token, tenant, trace))
        return rid

    def _running(self):
        return [r for r, s in self._all.items() if s["status"] is None][: self.max_slots]

    def step(self):
        if self.fail_next > 0:
            self.fail_next -= 1
            raise RuntimeError("injected step failure")
        self.steps += 1
        running = self._running()
        now = self.clock()
        for rid in running:
            s = self._all[rid]
            if "first" not in s:
                s["first"] = True
                self.ledger.first_token(rid, now)
            s["left"] -= 1
            if s["left"] <= 0:
                s["status"] = "ok"
                self.ledger.finished(rid, now, "ok")
        return bool(running)

    def status(self, rid):
        if rid not in self._all:
            raise KeyError(rid)
        s = self._all[rid]
        if s["status"] is not None:
            return s["status"]
        return "running" if rid in self._running() else "queued"

    def statuses(self):
        return {rid: self.status(rid) for rid in self._all}

    def cancel(self, rid):
        s = self._all.get(rid)
        if s is None or s["status"] is not None:
            return False
        s["status"] = "cancelled"
        self.ledger.finished(rid, self.clock(), "cancelled")
        return True

    def output(self, rid):
        s = self._all[rid]
        if s["status"] != "ok":
            raise KeyError(rid)
        return np.concatenate([s["prompt"], np.arange(s["max_new"], dtype=np.int32)])

    @property
    def idle(self):
        return all(s["status"] is not None for s in self._all.values())

    def leaked_blocks(self):
        return 0

    def metrics_snapshot(self):
        reg = self.pkg.reg.MetricsRegistry()
        reg.counter("dml_stub_steps_total", "stub engine steps").inc(self.steps)
        return reg.snapshot()


def _stub_router(pkg, n=2, clock=None, engine_kw=None, **router_kw):
    clock = clock if clock is not None else _Clock()
    engines = [_StubEngine(pkg, clock=clock, **(engine_kw or {})) for _ in range(n)]
    router_kw.setdefault("drr_quantum", 100)  # placement on first visit
    router_kw.setdefault("backoff_base_s", 0.0)
    return PKG[pkg].Router(engines, clock=clock, **router_kw), clock


def _observe(router) -> dict:
    """Everything the router decided, in plain values."""
    return {
        "records": {rid: (rec.replica, rec.engine_rid, rec.token, rec.retries, rec.trace, rec.status, rec.tenant,
                          rec.not_before)
                    for rid, rec in router._records.items()},
        "statuses": router.statuses(),
        "summary": router.summary(),
        "replicas": {name: (rep.alive, rep.removed, rep.draining, rep.breaker, rep.consec_failures, rep.cooldown,
                            rep.breaker_until, rep.probe_rid, rep.migrated, rep.stall_steps, rep.last_beat)
                     for name, rep in router.replicas.items()},
        "submits": {name: list(rep.engine.submits) for name, rep in router.replicas.items()},
        "healthy": router.healthy(),
        "ttfts": router.ttfts(),
        "idle": router.idle,
        "drr": (list(router._ring), dict(router._deficit), router.drr_quantum),
    }


def _both(scenario, *args):
    """Run ``scenario(pkg, *args)`` for both packages: equal observations, the port's run returned."""
    want = scenario("jax", *args)
    got = scenario("torch", *args)
    assert _observe(got[0]) == _observe(want[0])
    return got


# ---------------------------------------------------------------------------
# routing basics (tests/test_serve_router.py TestRouterBasics)
# ---------------------------------------------------------------------------

def _routes_all(pkg):
    router, _ = _stub_router(pkg, n=3)
    rids = [router.submit(list(range(4)), 4, tenant="a" if i % 2 else "b") for i in range(6)]
    return router, rids, router.run(max_steps=50)


def test_routes_all_terminal_ok():
    router, rids, outs = _both(_routes_all)
    assert router.idle and set(router.statuses().values()) == {"ok"}
    assert router.summary()["statuses"] == {"ok": 6}
    assert router.leaked_blocks() == 0
    for rid in rids:
        assert np.array_equal(outs[rid], router.output(rid))


def _spread(pkg):
    router, _ = _stub_router(pkg, n=2, engine_kw={"steps_to_finish": 10})
    a = router.submit(list(range(4)), 4)
    b = router.submit(list(range(10, 14)), 4)
    router.step()
    return router, a, b


def test_least_outstanding_spreads_load():
    router, a, b = _both(_spread)
    assert router._records[a].replica == "r0" and router._records[b].replica == "r1"


def _queued_cancel(pkg):
    router, _ = _stub_router(pkg, n=1, drr_quantum=1)
    rid = router.submit(list(range(16)), 16)
    seen = [router.status(rid), router.cancel(rid), router.status(rid), router.cancel(rid), router.idle]
    router.step()
    return router, rid, seen


def test_status_lifecycle_and_queued_cancel():
    router, rid, seen = _both(_queued_cancel)
    assert seen == ["queued", True, "cancelled", False, True]
    assert router._records[rid].replica is None
    for pkg in PKG:
        with pytest.raises(KeyError):
            _stub_router(pkg, n=1)[0].status(99)


def _fifo(pkg):
    router, _ = _stub_router(pkg, n=2, drr_quantum=2, engine_kw={"steps_to_finish": 1, "max_slots": 1})
    placements = []
    orig = router._place

    def spy(rec, rep, now):
        placements.append((rec.tenant, rec.rid, rec.retries, rep.name))
        return orig(rec, rep, now)

    router._place = spy
    for i in range(8):
        router.submit(list(range(8)), 8, tenant="hot" if i % 2 == 0 else "cold")
    router.run(max_steps=200)
    return router, placements


def test_per_tenant_fifo_survives_interleaving():
    want = _fifo("jax")
    router, placements = _both(_fifo)
    assert placements == want[1]
    assert router.idle and set(router.statuses().values()) == {"ok"}
    for tenant in ("hot", "cold"):
        first = [rid for (t, rid, retries, _) in placements if t == tenant and retries == 0]
        assert first == sorted(first), f"tenant {tenant} placed out of order"


@pytest.mark.parametrize("kw,match", [({}, "at least one replica"), ({"heartbeat_timeout_s": 0}, "heartbeat"),
                                      ({"max_retries": -1}, "max_retries"), ({"breaker_threshold": 0}, "breaker")])
def test_validation_messages_are_the_references(kw, match):
    msgs = []
    for pkg in PKG:
        engines = [] if not kw else [_StubEngine(pkg)]
        with pytest.raises(ValueError, match=match) as exc:
            PKG[pkg].Router(engines, **kw)
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]


# ---------------------------------------------------------------------------
# health detection and failover (TestFailover)
# ---------------------------------------------------------------------------

def _heartbeat(pkg):
    router, clock = _stub_router(pkg, n=2, heartbeat_timeout_s=1.0, engine_kw={"steps_to_finish": 5})
    rid = router.submit(list(range(4)), 4)
    router.step()
    first = router._records[rid].replica
    router.stall_replica("r0", 10)
    clock.advance(2.0)
    health = router.healthy()["r0"]
    router.step()
    mid = (router.failovers, router._records[rid].replica, router._records[rid].retries, router._records[rid].token)
    router.run(max_steps=50)
    return router, rid, first, health, mid


def test_missed_heartbeat_fails_over():
    router, rid, first, health, mid = _both(_heartbeat)
    assert first == "r0" and health is False
    assert mid[:3] == (1, "r1", 1) and mid[3].endswith(".f1")
    assert router.status(rid) == "ok"


def _exhausted(pkg):
    router, _ = _stub_router(pkg, n=2, max_retries=1, breaker_threshold=100, engine_kw={"steps_to_finish": 5})
    for rep in router.replicas.values():
        rep.engine.fail_next = 100
    rid = router.submit(list(range(4)), 4)
    for _ in range(10):
        router.step()
        if router.idle:
            break
    return router, rid


def test_step_raise_retries_exhausted_to_error():
    router, rid = _both(_exhausted)
    assert router.status(rid) == "error" and router.idle
    assert router._records[rid].retries == router.max_retries + 1
    with pytest.raises(KeyError):
        router.output(rid)


def _kill(pkg):
    router, _ = _stub_router(pkg, n=2, engine_kw={"steps_to_finish": 6})
    a = router.submit(list(range(4)), 4)
    b = router.submit(list(range(4)), 4)
    router.step()
    token_before = router._records[a].token
    router.kill_replica("r0", "drill")
    reaped = router.replicas["r0"].engine.statuses()
    mid = (router._records[a].token, router._records[a].retries)
    router.run(max_steps=60)
    return router, a, b, token_before, reaped, mid


def test_kill_reaps_engine_and_keeps_token():
    router, a, b, token_before, reaped, mid = _both(_kill)
    r0 = router.replicas["r0"]
    assert not r0.alive and router.kills == 1
    assert all(st in TERMINAL_STATUSES for st in reaped.values())
    assert mid == (token_before, 1)  # a fatal failover keeps the token
    assert router.status(a) == "ok" and router.status(b) == "ok"
    assert router._records[a].replica == "r1" and router.leaked_blocks() == 0


def _duplicate(pkg):
    router, clock = _stub_router(pkg, n=1)
    rid = router.submit(list(range(4)), 4)
    router.step()
    rec = router._records[rid]
    rep = router.replicas[rec.replica]
    erid, admissions = rec.engine_rid, len(rep.engine.submits)
    router._place(rec, rep, clock())  # the engine raises its package's DuplicateRequest
    return router, rec, erid, admissions, len(rep.engine.submits)


def test_duplicate_request_reattaches():
    router, rec, erid, before, after = _both(_duplicate)
    assert rec.engine_rid == erid and after == before


# ---------------------------------------------------------------------------
# the circuit breaker (TestCircuitBreaker)
# ---------------------------------------------------------------------------

def _breaker_router(pkg):
    return _stub_router(pkg, n=2, breaker_threshold=2, breaker_cooldown_s=1.0, heartbeat_timeout_s=1e9,
                        max_retries=10, engine_kw={"steps_to_finish": 10})


def _trip_probe_close(pkg):
    router, clock = _breaker_router(pkg)
    r0 = router.replicas["r0"]
    r0.engine.fail_next = 2
    seen = []
    router.step()
    seen.append((r0.consec_failures, r0.breaker))
    router.step()
    seen.append(r0.breaker)
    a = router.submit(list(range(4)), 4)
    b = router.submit(list(range(10, 14)), 4)
    router.step()
    seen.append((router._records[a].replica, router._records[b].replica))
    clock.advance(1.5)
    c = router.submit(list(range(20, 24)), 4)
    d = router.submit(list(range(30, 34)), 4)
    router.step()
    seen.append((r0.breaker, router._records[c].replica, r0.probe_rid == c, router._records[d].replica))
    router.run(max_steps=60)
    return router, c, seen


def test_trip_half_open_probe_close():
    router, c, seen = _both(_trip_probe_close)
    assert seen == [(1, "closed"), "open", ("r1", "r1"), ("half_open", "r0", True, "r1")]
    r0 = router.replicas["r0"]
    assert router.status(c) == "ok"
    assert r0.breaker == "closed" and r0.consec_failures == 0 and r0.probe_rid is None


def _failed_probe(pkg):
    router, clock = _breaker_router(pkg)
    r0 = router.replicas["r0"]
    r0.engine.fail_next = 2
    router.step()
    router.step()
    cooldown = r0.cooldown
    clock.advance(1.5)
    c = router.submit(list(range(20, 24)), 4)
    router.step()
    seen = [(r0.breaker, r0.probe_rid == c)]
    r0.engine.fail_next = 1
    router.step()
    seen.append((r0.breaker, r0.cooldown == cooldown * 2.0, r0.probe_rid, router._records[c].replica))
    router.run(max_steps=60)
    return router, c, seen


def test_failed_probe_reopens_with_doubled_cooldown():
    router, c, seen = _both(_failed_probe)
    assert seen == [("half_open", True), ("open", True, None, "r1")]
    assert router.status(c) == "ok"


# ---------------------------------------------------------------------------
# drain and affinity (TestDrainAndAffinity)
# ---------------------------------------------------------------------------

def _drain(pkg, run_dir):
    router, _ = _stub_router(pkg, n=2, run_dir=run_dir, engine_kw={"steps_to_finish": 4, "max_slots": 1})
    router.submit(list(range(4)), 4)
    router.submit(list(range(10, 14)), 4)
    c = router.submit(list(range(20, 24)), 4)
    router.step()
    seen = [router._records[c].replica, router.status(c), router._records[c].token]
    router.drain_replica("r0")
    r0 = router.replicas["r0"]
    seen.append((r0.draining, r0.migrated, router._records[c].replica, router._records[c].token,
                 router._records[c].retries))
    router.run(max_steps=100)
    verdict = PKG[pkg].read_verdict(run_dir)
    verdict.pop("written_at")
    verdict["serve"].pop("drain_s")
    return router, c, seen, verdict


def test_drain_migrates_queued_finishes_running_writes_verdict(tmp_path):
    for pkg in PKG:
        (tmp_path / pkg).mkdir()
    want = _drain("jax", tmp_path / "jax")
    router, c, seen, verdict = got = _drain("torch", tmp_path / "torch")
    assert _observe(router) == _observe(want[0]) and got[2:] == want[2:]
    assert seen[:2] == ["r0", "queued"]
    assert seen[3] == (True, 1, None, f"{seen[2]}.m", 0)  # a fresh token; a migration is not a retry
    assert set(router.statuses().values()) == {"ok"} and router._records[c].replica == "r1"
    r0 = router.replicas["r0"]
    assert r0.removed and not r0.alive and router.failovers == 0
    assert verdict["requeue"] is False and verdict["kind"] == "completed"
    assert verdict["serve"]["replica"] == "r0" and verdict["serve"]["migrated"] == 1
    assert verdict["serve"]["drained_clean"] is True


def _affinity(pkg, kill):
    router, _ = _stub_router(pkg, n=2, engine_kw={"steps_to_finish": 1})
    warm = list(range(8))  # two full blocks: a real affinity key
    a = router.submit(warm, 4)
    router.run(max_steps=20)
    if kill:
        router.kill_replica("r0", "gone")
        b = router.submit(warm, 4)
        router.run(max_steps=20)
    else:
        for rep in router.replicas.values():
            rep.engine.steps_to_finish = 50
        router.submit(list(range(100, 104)), 4)
        b = router.submit(warm, 4)
        router.step()
    return router, a, b


@pytest.mark.parametrize("kill", [False, True], ids=["affinity_beats_load", "falls_back_when_unplaceable"])
def test_prefix_affinity(kill):
    router, a, b = _both(_affinity, kill)
    assert router._records[a].replica == "r0"
    assert router._records[b].replica == ("r1" if kill else "r0")
    if kill:
        assert router.status(b) == "ok"


# ---------------------------------------------------------------------------
# telemetry: spans, traces and the metrics page (TestRouterTelemetry, TestTracePropagation)
# ---------------------------------------------------------------------------

def _journaled(pkg, tmp, fn):
    """Run ``fn(pkg)`` under a fresh journal of that package: its result and the journal's records."""
    jm = PKG[pkg].journal
    j = jm.SpanJournal(tmp / pkg, rank=0, ring_size=512)
    jm.activate(j)
    try:
        out = fn(pkg)
    finally:
        jm.deactivate()
    return out, j.tail(512)


def _span_view(records):
    """The records' kinds and attributes, host times aside."""
    drop = {"ts", "dur", "tid"}
    return [{k: v for k, v in r.items() if k not in drop} for r in records]


def _compare_journaled(tmp_path, fn):
    (want, jrec), (got, trec) = (_journaled(pkg, tmp_path, fn) for pkg in PKG)
    assert _observe(got[0]) == _observe(want[0])
    assert _span_view(trec) == _span_view(jrec)
    report, jreport = tjournal.linked_trace_report(trec), jjournal.linked_trace_report(jrec)
    assert {t: [r["kind"] for r in s] for t, s in report["traces"].items()} == {
        t: [r["kind"] for r in s] for t, s in jreport["traces"].items()}
    assert report["statuses"] == jreport["statuses"] and len(report["orphans"]) == len(jreport["orphans"])
    return got, trec, report


def _spans_drill(pkg):
    router, _ = _stub_router(pkg, n=2, engine_kw={"steps_to_finish": 3})
    router.submit(list(range(4)), 4)
    router.submit(list(range(4)), 4)
    router.step()
    router.kill_replica("r0", "drill")
    router.run(max_steps=50)
    router.drain_replica("r1")
    router.step()
    return (router,)


def test_route_failover_drain_spans(tmp_path):
    (router,), records, _ = _compare_journaled(tmp_path, _spans_drill)
    assert router.replicas["r1"].removed
    assert {"route", "failover", "replica_drain"} <= {r["kind"] for r in records}


def _rotating_token(pkg):
    router, clock = _stub_router(pkg, n=2, heartbeat_timeout_s=1.0, engine_kw={"steps_to_finish": 5})
    rid = router.submit(list(range(4)), 4)
    router.step()
    rec = router._records[rid]
    trace_before = rec.trace
    router.stall_replica(rec.replica, 10)
    clock.advance(2.0)
    router.step()
    mid = (rec.retries, rec.token, rec.trace)
    router.run(max_steps=50)
    return router, rid, trace_before, mid


def test_failover_rotates_token_but_keeps_trace(tmp_path):
    (router, rid, trace_before, mid), _, report = _compare_journaled(tmp_path, _rotating_token)
    assert mid[0] == 1 and mid[1].endswith(".f1") and mid[2] == trace_before == f"tr-{rid}"
    assert router.status(rid) == "ok" and report["orphans"] == []
    kinds = [r["kind"] for r in report["traces"][f"tr-{rid}"]]
    assert kinds.count("route") == 2 and kinds.count("failover") == 1
    # every placement carried the trace to the engine
    traces = [t for rep in router.replicas.values() for (_, _, _, t) in rep.engine.submits]
    assert traces == [f"tr-{rid}"] * 2


def _kill_one_drain_one(pkg):
    router, _ = _stub_router(pkg, n=3, engine_kw={"steps_to_finish": 4})
    rids = [router.submit(list(range(i, i + 4)), 4) for i in range(6)]
    router.step()
    router.kill_replica("r0", "drill")
    router.run(max_steps=30)
    router.drain_replica("r1", "drill")
    router.run(max_steps=60)
    return router, rids


def test_kill_one_drain_one_drill_has_zero_orphans(tmp_path):
    (router, rids), _, report = _compare_journaled(tmp_path, _kill_one_drain_one)
    assert all(router.status(r) in TERMINAL_STATUSES for r in rids)
    assert report["orphans"] == []
    assert set(report["traces"]) == {f"tr-{r}" for r in rids}
    assert all(report["traces"].values())


def test_exhausted_retries_stamp_the_trace_status(tmp_path):
    (router, rid), _, report = _compare_journaled(tmp_path, _exhausted)
    assert router.status(rid) == "error"
    assert report["orphans"] == [] and report["statuses"][f"tr-{rid}"] == "error"


def test_metrics_text_is_the_references_page():
    pages = {}
    for pkg in PKG:
        router, clock = _breaker_router(pkg)
        router.replicas["r0"].engine.fail_next = 2
        for i in range(3):
            router.submit(list(range(i, i + 4)), 4)
        router.step()
        router.step()
        pages[pkg] = (router.metrics_text(), router)
    text, router = pages["torch"]
    assert text == pages["jax"][0]
    fams = treg.parse_prometheus_text(text)
    assert {"dml_router_failovers_total", "dml_router_kills_total", "dml_router_pending_requests",
            "dml_router_breaker_state", "dml_stub_steps_total"} <= set(fams)
    assert 'dml_router_breaker_state{replica="r0"} 2' in text  # open
    assert all(f'replica="r{i}"' in text for i in range(2))


# ---------------------------------------------------------------------------
# the seeded replica-chaos drill in two interpreters (the reference's _DET_SCRIPT)
# ---------------------------------------------------------------------------

_DET_SCRIPT = r"""
import json
from {pkg}.serve.prefix_cache import content_key, prefix_keys, root_key
from {pkg}.serve import ChaosMonkey, Router, ServeLedger

out = {{"prefix": {{
    "keys": prefix_keys(list(range(40)), 8),
    "adapter3": prefix_keys(list(range(40)), 8, adapter=3),
    "root": root_key(0),
    "chain": content_key(123, (7, 8, 9)),
}}}}


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class _Pool:
    block_size = 4
    num_blocks = 64

    def blocks_for(self, n):
        return max(1, -(-int(n) // 4))

    def assert_consistent(self):
        pass


class _Stub:
    def __init__(self, clock):
        import types
        self.pool = _Pool()
        self.draft_pool = None
        self.scheduler = types.SimpleNamespace(prefill_chunk=8)
        self.ledger = ServeLedger()
        self.clock = clock
        self._all = {{}}
        self._next = 0

    def submit(self, prompt, max_new_tokens=8, *, token=None, tenant=None, **kw):
        rid = self._next
        self._next += 1
        self._all[rid] = {{"st": None, "left": 3}}
        self.ledger.arrived(rid, self.clock(), tenant=tenant)
        return rid

    def step(self):
        did = False
        for rid, s in self._all.items():
            if s["st"] is None:
                did = True
                s["left"] -= 1
                if s["left"] <= 0:
                    s["st"] = "ok"
                    self.ledger.finished(rid, self.clock(), "ok")
        return did

    def status(self, rid):
        if rid not in self._all:
            raise KeyError(rid)
        st = self._all[rid]["st"]
        return st if st is not None else "running"

    def statuses(self):
        return {{r: self.status(r) for r in self._all}}

    def cancel(self, rid):
        s = self._all.get(rid)
        if s is None or s["st"] is not None:
            return False
        s["st"] = "cancelled"
        self.ledger.finished(rid, self.clock(), "cancelled")
        return True

    @property
    def idle(self):
        return all(s["st"] is not None for s in self._all.values())

    def leaked_blocks(self):
        return 0


clock = _Clock()
router = Router(
    [_Stub(clock) for _ in range(3)], clock=clock,
    heartbeat_timeout_s=1e9, max_retries=3, backoff_base_s=0.0,
    drr_quantum=100,
)
monkey = ChaosMonkey(
    seed=11, p_replica_kill=0.04, max_replica_kills=1,
    p_replica_stall=0.15, replica_stall_steps=2,
).attach_router(router)
for i in range(8):
    router.submit(list(range(i, i + 8)), 8, tenant="a" if i % 2 else "b")
steps = 0
while not router.idle and steps < 300:
    router.step()
    clock.t += 0.01
    steps += 1
out["chaos"] = {{
    "log": monkey.log,
    "statuses": {{str(k): v for k, v in sorted(router.statuses().items())}},
    "failovers": router.failovers,
    "kills": router.kills,
    "idle": router.idle,
}}
print(json.dumps(out, sort_keys=True))
"""


@pytest.fixture(scope="module")
def _det_runs():
    """The port's drill in two fresh interpreters with different hash seeds (raw stdouts), and the
    reference's drill run in this process."""
    outs = []
    for hash_seed in ("0", "4271"):
        env = dict(os.environ, PYTHONHASHSEED=hash_seed, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
        proc = subprocess.run([sys.executable, "-c", _DET_SCRIPT.format(pkg="dmlcloud_tpu_torch")],
                              capture_output=True, timeout=240, env=env, cwd=REPO)
        assert proc.returncode == 0, proc.stderr.decode()
        outs.append(proc.stdout.decode())
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        exec(_DET_SCRIPT.format(pkg="dmlcloud_tpu"), {"__name__": "det_drill"})
    return outs, buf.getvalue()


def test_chaos_event_log_replays_the_references_byte_for_byte(_det_runs):
    (a, b), ref = _det_runs
    assert a == b == ref  # the whole drill record, prefix addresses included
    chaos = json.loads(a)["chaos"]
    assert chaos["idle"] is True and set(chaos["statuses"].values()) <= set(TERMINAL_STATUSES)
    kinds = {kind for (_, kind, _) in chaos["log"]}
    assert kinds & {"replica_kill", "replica_stall"}


@pytest.mark.parametrize("kw,drain", [(dict(seed=3, p_replica_kill=0.5, p_replica_stall=0.5), True),
                                     (dict(seed=0, p_replica_kill=1.0, max_replica_kills=1, p_replica_stall=1.0),
                                      False)],
                         ids=["drain_r2", "kill_and_stall_in_one_step"])
def test_replica_chaos_spares_the_last_and_the_draining_replica(kw, drain):
    logs = {}
    for pkg in PKG:
        router, clock = _stub_router(pkg, n=3, heartbeat_timeout_s=1e9, max_retries=5)
        monkey = PKG[pkg].Monkey(**kw).attach_router(router)
        with pytest.raises(RuntimeError, match="already attached"):
            monkey.attach_router(router)
        if drain:
            router.drain_replica("r2")
        for i in range(6):
            router.submit(list(range(i, i + 4)), 4)
        router.run(max_steps=200)
        monkey.detach_router()
        assert router.fault_injector is None
        logs[pkg] = (list(monkey.log), _observe(router))
    assert logs["torch"] == logs["jax"]
    log, obs = logs["torch"]
    kills = [d for _, k, d in log if k == "replica_kill"]
    assert len(kills) == 1  # never the last one standing
    if drain:  # never the draining one
        assert kills[0] in ("r0", "r1") and all(not d.startswith("r2") for _, _, d in log)
    else:  # the step's stall spares the replica its kill just took
        assert log[:2] == [(1, "replica_kill", kills[0]), log[1]] and not log[1][2].startswith(kills[0])
    assert obs["idle"] and set(obs["statuses"].values()) == {"ok"}


# ---------------------------------------------------------------------------
# tiny models: a kill and a drain over real engines (TestRouterIntegration)
# ---------------------------------------------------------------------------

def _tiny_engine(pkg, **kw):
    kw = dict(dict(num_blocks=64, block_size=4, max_slots=2, prefill_chunk=8), **kw)
    jmodel, params, tmodel = _models()
    if pkg == "jax":
        return JEngine(jmodel, params, batch_buckets=[kw["max_slots"]], table_buckets=[16], **kw)
    return ServeEngine(tmodel, **kw)


def _integration(pkg, run_dir, prefix_cache=False):
    prompts = [_prompt(8, seed=200 + i) for i in range(6)]
    engines = [_tiny_engine(pkg, prefix_cache=prefix_cache) for _ in range(3)]
    router = PKG[pkg].Router(engines, heartbeat_timeout_s=1e9, max_retries=2, backoff_base_s=0.0, run_dir=run_dir)
    rids = [router.submit(p, 6, tenant="t") for p in prompts]
    for _ in range(3):
        router.step()
    router.kill_replica("r2", "drill")
    killed = router.replicas["r2"].engine.leaked_blocks()
    router.drain_replica("r1")
    router.run(max_steps=500)
    verdict = PKG[pkg].read_verdict(run_dir)
    return {
        "outputs": {rid: np.asarray(router.output(rid)).tolist() for rid in rids},
        "placements": {rid: (rec.replica, rec.engine_rid, rec.token, rec.retries) for rid, rec in
                       router._records.items()},
        "statuses": router.statuses(), "failovers": router.failovers, "kills": router.kills,
        "killed_leaked": killed, "leaked": router.leaked_blocks(), "idle": router.idle,
        "removed": router.replicas["r1"].removed, "verdict_replica": verdict["serve"]["replica"],
        "verdict_statuses": verdict["serve"]["statuses"], "migrated": verdict["serve"]["migrated"],
    }, prompts


@pytest.fixture(scope="module")
def _reference_integration(tmp_path_factory):
    """The reference Router over three reference engines, once for the module."""
    return _integration("jax", tmp_path_factory.mktemp("jax_router"))[0]


@pytest.mark.parametrize("prefix_cache", [False, True], ids=["plain", "prefix_cache"])
def test_outputs_identical_through_kill_and_drain(_reference_integration, tmp_path, prefix_cache):
    got, prompts = _integration("torch", tmp_path, prefix_cache)
    want = _reference_integration
    if not prefix_cache:
        assert got == want
    else:  # the cache changes no decision the reference's plain engines make here
        assert got["outputs"] == want["outputs"] and got["statuses"] == want["statuses"]
    assert got["idle"] and set(got["statuses"].values()) == {"ok"}
    assert got["killed_leaked"] == 0 and got["leaked"] == 0  # the kill reaped every page
    assert got["removed"] and got["verdict_replica"] == "r1" and got["kills"] == 1
    for rid, p in enumerate(prompts):
        assert got["outputs"][rid] == _port_generate(p, 6).tolist()


def test_killed_prefix_cache_replica_is_reaped_to_zero_leaks():
    """Killed mid-prefill and mid-decode: the reaped engine owes no page; the
    blocks its radix tree still owns are cached, not leaked."""
    engines = [_tiny_engine("torch", prefix_cache=True, num_blocks=32) for _ in range(2)]
    router = Router(engines, heartbeat_timeout_s=1e9, backoff_base_s=0.0)
    shared = _prompt(12, seed=300)
    rids = [router.submit(np.concatenate([shared, _prompt(4, seed=310 + i)]), 5) for i in range(4)]
    router.step()
    router.step()
    router.kill_replica("r0", "drill")
    r0 = router.replicas["r0"].engine
    assert r0.leaked_blocks() == 0 and r0.prefix.leaked_locks() == []
    router.run(max_steps=500)
    assert set(router.statuses().values()) == {"ok"} and router.leaked_blocks() == 0
    for rid in rids:
        rec = router._records[rid]
        assert router.output(rid).tolist() == _port_generate(rec.prompt, 5).tolist()


# ---------------------------------------------------------------------------
# the failover property drill (TestFailoverProperty; slow, as in the reference)
# ---------------------------------------------------------------------------

class _DrillChaos:
    """Seeded replica-level chaos: at any router step a standing replica may
    be killed, drained or stalled, with one non-draining replica left."""

    def __init__(self, router, seed):
        self.router = router
        self.rng = np.random.RandomState(seed)
        self.events = []

    def __call__(self, point, seqs):
        r = self.router
        standing = [n for n, rep in r.replicas.items() if rep.alive and not rep.removed and not rep.draining]
        if len(standing) > 1 and self.rng.random_sample() < 0.02:
            name = standing[int(self.rng.randint(len(standing)))]
            self.events.append(("kill", name))
            r.kill_replica(name, "drill")
            standing.remove(name)
        if len(standing) > 1 and self.rng.random_sample() < 0.02:
            name = standing[int(self.rng.randint(len(standing)))]
            self.events.append(("drain", name))
            r.drain_replica(name)
            standing.remove(name)
        if standing and self.rng.random_sample() < 0.05:
            name = standing[int(self.rng.randint(len(standing)))]
            self.events.append(("stall", name))
            r.stall_replica(name, 2)


@pytest.mark.slow  # random replica-chaos property drill; the seeded kill+drain integration stays tier-1
def test_random_replica_chaos_under_tight_pool(tmp_path):
    n_req = 10
    prompts = [_prompt(6 + (i % 3) * 4, seed=100 + i) for i in range(n_req)]
    max_new = [4 + (i % 2) * 2 for i in range(n_req)]
    router = Router([_tiny_engine("torch", num_blocks=24) for _ in range(3)], heartbeat_timeout_s=1e9,
                    max_retries=3, backoff_base_s=0.0, breaker_threshold=3, breaker_cooldown_s=0.01,
                    run_dir=tmp_path)
    chaos = _DrillChaos(router, seed=7)
    router.fault_injector = chaos
    rids = [router.submit(p, m, tenant="hot" if i % 2 == 0 else "cold")
            for i, (p, m) in enumerate(zip(prompts, max_new))]
    steps = 0
    while not router.idle and steps < 2000:
        router.step()
        steps += 1
        for rep in router.replicas.values():
            rep.engine.pool.assert_consistent()
        live_on = {}
        for name, rep in router.replicas.items():
            for seq in rep.engine._all.values():
                if seq.status is None and seq.token:
                    live_on.setdefault(seq.token.split(".")[0], []).append(name)
        assert all(len(names) == 1 for names in live_on.values()), live_on
    assert router.idle, f"drill did not converge (events: {chaos.events})"
    statuses = router.statuses()
    assert set(statuses.values()) <= set(TERMINAL_STATUSES) and router.leaked_blocks() == 0
    ok = [rid for rid in rids if statuses[rid] == "ok"]
    assert len(ok) >= n_req // 2, f"too much collateral: {statuses}"
    for rid in ok:
        assert router.output(rid).tolist() == _port_generate(prompts[rid], max_new[rid]).tolist()
    if any(rep.removed for rep in router.replicas.values()):
        assert read_requeue_verdict(tmp_path)["serve"]["drained_clean"]
