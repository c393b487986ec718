"""The serve telemetry of the port against the JAX package, on the CPU
(tests/test_serve.py ``TestServeTelemetry``/``TestLedgerRetention``,
tests/test_observability.py ``TestSLOMonitor``/``TestMetricsServer``/
``TestEngineObservability``).

- ``ServeLedger``: the same random events (arrivals, admissions, first
  tokens, tokens, prefix matches, spec rounds, step samples, terminal
  statuses) give the reference's records, census and ``summary()`` after every
  event, with and without bounded retention;
- the engine under one fake clock, with ``metrics=True`` and an SLO, plain and
  with the prefix cache: ``ledger.summary()`` (its ``"slo"`` section too) and
  ``metrics_text()`` equal the reference engine's, every series and value;
- ``SLO``/``SLOMonitor``: the reference's alerting scenarios raise the same
  alerts and scorecards, and bad declarations raise the same errors;
- ``MetricsServer`` serves ``metrics_text`` on ``127.0.0.1`` (200, 404, 500);
- ``to_request_trace``/``linked_trace_report`` give the reference's output on
  the same records, and the engine's spans carry the trace ids (no orphan, a
  caller's trace id kept, a fault stamping its trace ``error``), the same
  kinds per trace as the reference engine's.
"""

import json
import re
import tempfile
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from dmlcloud_tpu.serve import SLO as JSLO
from dmlcloud_tpu.serve import SLOMonitor as JSLOMonitor
from dmlcloud_tpu.serve.engine import ServeEngine as JEngine
from dmlcloud_tpu.serve.ledger import ServeLedger as JLedger
from dmlcloud_tpu.telemetry import journal as jjournal
from dmlcloud_tpu_torch.serve import SLO, MetricsServer, ServeEngine, ServeLedger, SLOMonitor
from dmlcloud_tpu_torch.telemetry import journal as tjournal
from dmlcloud_tpu_torch.telemetry.metrics_registry import parse_prometheus_text
from test_torch_serve import _Clock, _models, _prompt

torch.set_num_threads(2)


# ---------------------------------------------------------------------------
# the ledger
# ---------------------------------------------------------------------------

def _ledger_drill(ledger, seed, n=300):
    rs = np.random.RandomState(seed)
    t, live, log = 0.0, {}, []
    for rid in range(n):
        t += float(rs.uniform(0, 0.5))
        op = rs.randint(6)
        if op == 0 or not live:
            ledger.arrived(rid, t, tenant=["a", "b", None][rs.randint(3)])
            live[rid] = "arrived"
        else:
            r = list(live)[rs.randint(len(live))]
            stage = live[r]
            if stage == "arrived":
                ledger.admitted(r, t)
                if rs.rand() < 0.5:
                    ledger.prefix_match(r, cached=int(rs.randint(0, 16)), saved=int(rs.randint(0, 16)),
                                        prompt=int(rs.randint(16, 40)))
                live[r] = "admitted"
            elif stage == "admitted":
                ledger.first_token(r, t)
                live[r] = "decoding"
            elif rs.rand() < 0.3:
                ledger.finished(r, t, status=["ok", "ok", "error", "shed", "cancelled"][rs.randint(5)])
                del live[r]
            else:
                ledger.token(r)
                if rs.rand() < 0.4:
                    ledger.spec_round(r, drafted=3, accepted=int(rs.randint(0, 4)))
            if rs.rand() < 0.3:
                ledger.step_sample(int(rs.randint(0, 9)), int(rs.randint(1, 5)))
        log.append((ledger.summary(), ledger.status_counts(), sorted(ledger.records)))
    return log


@pytest.mark.parametrize("max_records", [None, 3])
def test_ledger_drill_matches_the_reference(max_records):
    want = _ledger_drill(JLedger(max_records=max_records), 7)
    got = _ledger_drill(ServeLedger(max_records=max_records), 7)
    assert got == want


def test_ledger_retention_cases_match_the_reference():
    """tests/test_serve.py's ``TestLedgerRetention`` events on both ledgers."""
    out = []
    for cls in (JLedger, ServeLedger):
        led = cls(max_records=3)
        for i in range(10):
            t = float(i)
            led.arrived(i, t, tenant="t")
            led.admitted(i, t + 0.5)
            led.first_token(i, t + 1.0)
            for _ in range(4):
                led.token(i)
            led.finished(i, t + 3.0, status="ok" if i % 2 == 0 else "error")
        live = cls(max_records=2)
        for i in range(6):
            live.arrived(i, float(i))
        held = len(live.records)
        for i in range(6):
            live.finished(i, 10.0 + i, status="ok")
        out.append((led.summary(), sorted(led.records), held, sorted(live.records), live.summary()))
    assert out[1] == out[0]
    assert out[1][0]["requests"] == 10 and out[1][1] == [7, 8, 9] and out[1][2] == 6
    with pytest.raises(ValueError, match=re.escape("max_records must be >= 1, got 0")):
        ServeLedger(max_records=0)


# ---------------------------------------------------------------------------
# the engine's ledger, metrics and SLOs under one fake clock
# ---------------------------------------------------------------------------

def _observed(pkg, prefix):
    """Three tenants' requests through one slot (queueing), the same fake
    clock; the summary, the Prometheus page and the retained records."""
    jmodel, params, tmodel = _models()
    clock = _Clock(tick=1e-3)
    slo_cls = JSLO if pkg == "jax" else SLO
    slos = [slo_cls("lat", ttft_p99_s=0.004, good_fraction=0.5, window_s=1.0, fast_window_s=0.05,
                    burn_threshold=1.0), slo_cls("avail", tenant="gold", availability=0.5)]
    kw = dict(num_blocks=64, block_size=4, max_slots=1, prefill_chunk=8, metrics=True, slos=slos, clock=clock,
              prefix_cache=prefix)
    engine = (JEngine(jmodel, params, batch_buckets=[1], table_buckets=[16], **kw) if pkg == "jax"
              else ServeEngine(tmodel, **kw))
    tmpl = _prompt(8, seed=60)
    rids = []
    for i in range(5):
        p = np.concatenate([tmpl, _prompt(2 + i, seed=61 + i)]) if i % 2 else _prompt(6 + i, seed=70 + i)
        rids.append(engine.submit(p, 3 + i % 3, tenant=["gold", "free"][i % 2]))
    engine.step()
    engine.cancel(rids[-1])
    engine.run(max_steps=2000)
    return engine.ledger.summary(), engine.metrics_text(), [engine.ledger.records[r] for r in rids]


@pytest.mark.parametrize("prefix", [False, True], ids=["plain", "prefix_cache"])
def test_ledger_summary_and_metrics_text_equal_the_reference_engines(prefix):
    want, got = _observed("jax", prefix), _observed("torch", prefix)
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[2] == want[2]
    fams = parse_prometheus_text(got[1])
    assert float(fams["dml_serve_requests_total"]["samples"][0][2]) == 5.0
    assert got[0]["slo"]["alerts"] >= 1 and got[0]["statuses"] == {"ok": 4, "cancelled": 1}
    if prefix:
        assert got[0]["prefix_hit_rate"] > 0


def test_engine_retention_bounds_the_ledger_and_the_records():
    """``ledger_max_records`` and ``max_done`` bound a long-running engine:
    old terminal requests leave the ledger and the status map, the census
    stays exact (tests/test_serve.py ``test_engine_retention_bounds_memory``)."""
    jmodel, params, tmodel = _models()
    kw = dict(num_blocks=64, block_size=4, max_slots=2, ledger_max_records=3, max_done=3)
    res = []
    for engine in (JEngine(jmodel, params, batch_buckets=[2], table_buckets=[16], **kw), ServeEngine(tmodel, **kw)):
        rids = [engine.submit(_prompt(4, seed=110 + i), 2) for i in range(8)]
        engine.run(max_steps=2000)
        with pytest.raises(KeyError):
            engine.status(rids[0])
        res.append((sorted(engine.ledger.records), engine.statuses(), engine.ledger.status_counts(),
                    engine.ledger.summary()["requests"]))
    assert res[1] == res[0]
    records, statuses, census, requests = res[1]
    assert len(records) <= 3 and len(statuses) <= 3 and statuses[rids[-1]] == "ok"
    assert census == {"ok": 8} and requests == 8


def _replayed(pkg):
    """``serve_trace`` of a timed trace (offsets, adapters-free kwargs) under
    one fake clock whose sleeps advance it."""
    jmodel, params, tmodel = _models()
    clock = _Clock(tick=2e-3)
    kw = dict(num_blocks=64, block_size=4, max_slots=2, prefill_chunk=8, clock=clock)
    engine = (JEngine(jmodel, params, batch_buckets=[2], table_buckets=[16], **kw) if pkg == "jax"
              else ServeEngine(tmodel, **kw))

    def sleep(s):
        clock.t += s

    trace = [(0.0, _prompt(6, seed=90), 3), (0.01, _prompt(9, seed=91), 4, {"tenant": "b"}),
             (0.5, _prompt(5, seed=92), 2, {"deadline_s": 10.0, "priority": 1})]
    summary = engine.serve_trace(trace, sleep=sleep)
    return summary, [np.asarray(v).tolist() for v in engine.results().values()]


def test_serve_trace_replays_as_the_reference():
    want, got = _replayed("jax"), _replayed("torch")
    assert got == want
    assert got[0]["requests"] == got[0]["completed"] == 3 and got[0]["tenant_ttft"]["b"]["n"] == 1


# ---------------------------------------------------------------------------
# SLOs
# ---------------------------------------------------------------------------

def _slo_scenario(name, slo_cls, mon_cls):
    """tests/test_observability.py's ``TestSLOMonitor`` scenarios; returns the
    alerts fired per evaluation and the final scorecard."""
    lat = lambda **kw: slo_cls("lat", **dict(dict(ttft_p99_s=0.1, good_fraction=0.5, window_s=10.0,
                                                  fast_window_s=1.0, burn_threshold=1.5), **kw))
    out = []
    if name == "burn_rearm":
        mon = mon_cls([lat()], clock=lambda: 0.0)
        for i in range(20):
            mon.record_ttft(None, 1.0, now=i * 0.05)
        out.append(mon.evaluate(now=1.0))
        mon.record_ttft(None, 1.0, now=1.2)
        out.append(mon.evaluate(now=1.3))
        for i in range(20):
            mon.record_ttft(None, 0.01, now=3.0 + i * 0.04)
        out.append(mon.evaluate(now=3.9))
        for i in range(40):
            mon.record_ttft(None, 1.0, now=5.0 + i * 0.1)
        out.append(mon.evaluate(now=9.0))
    elif name == "one_slow":
        mon = mon_cls([lat()], clock=lambda: 0.0)
        for i in range(50):
            mon.record_ttft(None, 0.01, now=i * 0.1)
        mon.record_ttft(None, 5.0, now=4.95)
        out.append(mon.evaluate(now=5.0))
    elif name == "cancelled":
        mon = mon_cls([slo_cls("avail", availability=0.9, window_s=10.0, fast_window_s=1.0, burn_threshold=1.0)],
                      clock=lambda: 0.0)
        for i in range(30):
            mon.record_terminal(None, "cancelled", now=i * 0.1)
        out.append(mon.evaluate(now=3.0))
        for i in range(10):
            mon.record_terminal(None, "error", now=4.0 + i * 0.05)
        out.append(mon.evaluate(now=4.5))
    elif name == "tenants":
        mon = mon_cls([slo_cls("gold", tenant="gold", ttft_p99_s=0.1, good_fraction=0.5, window_s=10.0,
                               fast_window_s=1.0, burn_threshold=1.0)], clock=lambda: 0.0)
        for i in range(20):
            mon.record_ttft("bronze", 9.0, now=i * 0.05)
        out.append(mon.evaluate(now=1.0))
        for i in range(20):
            mon.record_ttft("gold", 9.0, now=2.0 + i * 0.05)
        out.append(mon.evaluate(now=3.0))
    elif name == "scorecard":
        mon = mon_cls([lat()], clock=lambda: 2.0)
        for i in range(10):
            mon.record_ttft(None, 0.02, now=1.0 + i * 0.01)
    out.append(mon.status())
    out.append(mon.alerts)
    return out


@pytest.mark.parametrize("name", ["burn_rearm", "one_slow", "cancelled", "tenants", "scorecard"])
def test_slo_monitor_raises_the_references_alerts(name):
    want = _slo_scenario(name, JSLO, JSLOMonitor)
    got = _slo_scenario(name, SLO, SLOMonitor)
    assert got == want
    if name == "burn_rearm":
        assert len(got[-1]) == 2


def test_slo_alerts_journal_as_spans():
    with tempfile.TemporaryDirectory() as tmp:
        j = tjournal.activate(tjournal.SpanJournal(tmp))
        try:
            _slo_scenario("burn_rearm", SLO, SLOMonitor)
        finally:
            tjournal.deactivate()
        spans = [r for r in j.tail(64) if r["kind"] == "slo_alert"]
    assert [s["slo"] for s in spans] == ["lat", "lat"] and spans[0]["part"] == "ttft"


@pytest.mark.parametrize("kw", [dict(), dict(ttft_p99_s=-1), dict(availability=1.5),
                                dict(ttft_p99_s=1.0, window_s=1.0, fast_window_s=2.0),
                                dict(ttft_p99_s=1.0, good_fraction=1.0), dict(ttft_p99_s=1.0, burn_threshold=0)])
def test_bad_slos_raise_as_the_reference(kw):
    with pytest.raises(ValueError) as jerr:
        JSLO("bad", **kw)
    with pytest.raises(ValueError, match=re.escape(str(jerr.value))):
        SLO("bad", **kw)


def test_duplicate_slo_names_raise():
    with pytest.raises(ValueError, match="duplicate SLO names") as jerr:
        JSLOMonitor([JSLO("x", ttft_p99_s=1.0), JSLO("x", availability=0.9)])
    with pytest.raises(ValueError, match=re.escape(str(jerr.value))):
        SLOMonitor([SLO("x", ttft_p99_s=1.0), SLO("x", availability=0.9)])


# ---------------------------------------------------------------------------
# the /metrics endpoint
# ---------------------------------------------------------------------------

def test_metrics_server_serves_the_engine_on_localhost():
    engine = ServeEngine(_models()[2], num_blocks=32, block_size=4, metrics=True)
    engine.submit(_prompt(5), 3)
    engine.run()
    with MetricsServer(engine.metrics_text) as srv:
        assert srv.host == "127.0.0.1" and srv.url.startswith("http://127.0.0.1:")
        with urllib.request.urlopen(srv.url, timeout=5) as resp:
            assert resp.status == 200 and resp.headers["Content-Type"].startswith("text/plain")
            body = resp.read().decode()
        assert body == engine.metrics_text()
        assert parse_prometheus_text(body)["dml_serve_tokens_total"]["samples"][0][2] == "3"
        with pytest.raises(urllib.error.HTTPError) as e404:
            urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/nope", timeout=5)
        assert e404.value.code == 404

    def boom():
        raise RuntimeError("registry on fire")

    with MetricsServer(boom) as srv:
        with pytest.raises(urllib.error.HTTPError) as e500:
            urllib.request.urlopen(srv.url, timeout=5)
        assert e500.value.code == 500 and "registry on fire" in e500.value.read().decode()
    with pytest.raises(RuntimeError):
        MetricsServer(lambda: "").port
    assert ServeEngine(_models()[2], num_blocks=8, block_size=4).metrics_text() == ""


# ---------------------------------------------------------------------------
# request traces
# ---------------------------------------------------------------------------

def _traced(pkg, prefix=True):
    """A journal of an engine run: two requests (one with a caller's trace
    id), a prefix hit with a COW fork, one request failing at decode."""
    jmodel, params, tmodel = _models()
    jmod = jjournal if pkg == "jax" else tjournal
    kw = dict(num_blocks=64, block_size=4, max_slots=2, prefill_chunk=8, prefix_cache=prefix)
    engine = (JEngine(jmodel, params, batch_buckets=[2], table_buckets=[16], **kw) if pkg == "jax"
              else ServeEngine(tmodel, **kw))
    fault = {"armed": False}

    def inject(point, seqs):
        if point == "decode" and fault["armed"]:
            fault["armed"] = False
            raise RuntimeError("injected decode fault")

    engine.fault_injector = inject
    with tempfile.TemporaryDirectory() as tmp:
        j = jmod.activate(jmod.SpanJournal(tmp, ring_size=1 << 16))
        try:
            a = engine.submit(_prompt(8, seed=80), 4, trace="caller-trace")
            b = engine.submit(_prompt(8, seed=80), 5)  # exact duplicate of full blocks
            engine.run(max_steps=2000)
            c = engine.submit(_prompt(8, seed=80), 3)  # a warm exact match: the COW fork
            engine.run(max_steps=2000)
            fault["armed"] = True
            d = engine.submit(_prompt(6, seed=81), 6)
            engine.run(max_steps=2000)
        finally:
            jmod.deactivate()
        records = j.tail(1 << 16)
    return records, [engine.status(r) for r in (a, b, c, d)]


def _kinds_by_trace(report):
    return {t: [r["kind"] for r in spans] for t, spans in report["traces"].items()}


def test_request_traces_match_the_reference_engines():
    trecs, tstat = _traced("torch")
    jrecs, jstat = _traced("jax")
    assert tstat == jstat == ["ok", "ok", "ok", "error"]
    got, want = tjournal.linked_trace_report(trecs), jjournal.linked_trace_report(jrecs)
    assert got["orphans"] == [] and want["orphans"] == []
    assert _kinds_by_trace(got) == _kinds_by_trace(want)
    assert got["statuses"] == want["statuses"] == {"caller-trace": None, "tr-1": None, "tr-2": None, "tr-3": "error"}
    kinds = _kinds_by_trace(got)
    assert {"queue_wait", "admission", "prefix_lookup", "prefill", "decode_batch"} <= set(kinds["caller-trace"])
    assert "cow_fork" in kinds["tr-2"] and "fault" in kinds["tr-3"]


def test_request_trace_converters_equal_the_references():
    records, _ = _traced("torch")
    records = json.loads(json.dumps(records))
    assert json.dumps(tjournal.to_request_trace(records), sort_keys=True) == json.dumps(
        jjournal.to_request_trace(records), sort_keys=True)
    assert tjournal.linked_trace_report(records) == jjournal.linked_trace_report(records)
    orphan = dict(records[0])
    orphan.pop("trace", None)
    orphan.pop("traces", None)
    orphan["kind"] = "prefill"
    assert tjournal.linked_trace_report(records + [orphan])["orphans"] == [orphan]
    assert tjournal.REQUEST_SPAN_KINDS == jjournal.REQUEST_SPAN_KINDS
    assert tjournal.BATCH_SPAN_KINDS == jjournal.BATCH_SPAN_KINDS
    assert tjournal.SPAN_KINDS == jjournal.SPAN_KINDS
