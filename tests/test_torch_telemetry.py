"""The port's flight recorder on the CPU: journal, goodput ledger, hang watchdog.

The counterpart of ``tests/test_telemetry.py``. The journal's schema, the
Chrome trace and the goodput ledger's rows, totals, table and advice are held
to the JAX package's functions on the same records and tracker values (one
format for both packages); the watchdog, the ``"hang"`` verdict that
``completed`` supersedes, the forensics dump of an uncaught exception and the
goodput buckets of a pipeline run are held to the reference's contract.
"""

import json
import threading
import time

import numpy as np
import pytest
import torch

import dmlcloud_tpu_torch as tdml
import dmlcloud_tpu_torch.pipeline as tpipeline
from dmlcloud_tpu.metrics import MetricTracker as JTracker
from dmlcloud_tpu.telemetry import goodput as jgoodput
from dmlcloud_tpu.telemetry import journal as jjournal
from dmlcloud_tpu_torch.metrics import MetricTracker as TTracker
from dmlcloud_tpu_torch.parallel import runtime as truntime
from dmlcloud_tpu_torch.telemetry import (
    SCHEMA_VERSION,
    SPAN_KINDS,
    HangWatchdog,
    SpanJournal,
    ledger_from_tracker,
    load_journals,
    to_chrome_trace,
)
from dmlcloud_tpu_torch.telemetry import journal as journal_mod

torch.set_num_threads(2)


# ---------------------------------------------------------------------------
# the journal, against the JAX package's format
# ---------------------------------------------------------------------------


def test_schema_version_and_span_kinds_are_the_jax_packages():
    assert SCHEMA_VERSION == jjournal.SCHEMA_VERSION == 1
    assert SPAN_KINDS == jjournal.SPAN_KINDS


def test_records_round_trip_through_jsonl(tmp_path):
    j = SpanJournal(tmp_path, rank=3)
    t0 = j.now()
    rec = j.emit("step_dispatch", t0, t0 + 0.001, label="x", step=7)
    for field, typ in {"v": int, "kind": str, "ts": float, "dur": float, "rank": int, "tid": str}.items():
        assert isinstance(rec[field], typ), field
    assert rec["dur"] == pytest.approx(0.001, abs=1e-6) and rec["step"] == 7 and rec["label"] == "x"
    j.close()
    lines = (tmp_path / "journal-rank3.jsonl").read_text().splitlines()
    assert [json.loads(line) for line in lines] == [rec]
    assert jjournal.load_journals(tmp_path) == [rec]  # the JAX package reads the port's journal


def test_ring_keeps_the_last_n_and_flush_is_incremental(tmp_path):
    j = SpanJournal(tmp_path, ring_size=8)
    t = j.now()
    for i in range(20):
        j.emit("step_dispatch", t, t, step=i)
    assert [r["step"] for r in j.tail(5)] == [15, 16, 17, 18, 19]
    assert len(j) == 8
    assert j.flush() == 20 and j.flush() == 0
    j.emit("h2d", t, t)
    assert j.flush() == 1
    j.close()
    assert len((tmp_path / "journal-rank0.jsonl").read_text().splitlines()) == 21


def test_background_flusher_writes_without_close(tmp_path):
    j = SpanJournal(tmp_path, flush_interval=0.05).start()
    t = j.now()
    j.emit("barrier", t, t, label="x")
    path = tmp_path / "journal-rank0.jsonl"
    deadline = time.perf_counter() + 5.0
    while time.perf_counter() < deadline and not path.read_text().strip():
        time.sleep(0.02)
    written = path.read_text().strip()
    j.close()
    assert written, "the flusher thread never wrote the pending span"
    assert not any(th.name.startswith("dml-journal") for th in threading.enumerate())


def test_span_on_emit_thread_name_and_the_inactive_no_op(tmp_path):
    assert journal_mod.active_journal() is None
    with journal_mod.span("h2d"):
        pass
    assert journal_mod.emit("h2d", 0.0, 1.0) is None
    j = SpanJournal(tmp_path)
    pings, out = [], {}
    j.on_emit = lambda: pings.append(1)
    with j.span("compile", label="train_step"):
        pass
    th = threading.Thread(target=lambda: out.update(rec=j.emit("h2d", j.now())), name="prefetcher")
    th.start()
    th.join(timeout=5)
    assert pings == [1, 1] and out["rec"]["tid"] == "prefetcher"


def test_chrome_trace_equals_the_jax_converters(tmp_path):
    tdir = tmp_path / "telemetry"
    for rank in (0, 1):
        j = SpanJournal(tdir, rank=rank)
        t = j.now()
        for i in range(3):
            j.emit("step_dispatch", t + i * 0.01, t + i * 0.01 + 0.005, step=i)
        j.emit("epoch", t, t + 0.03, label="stage", epoch=1)
        j.close()
    with open(tdir / "journal-rank1.jsonl", "a") as f:
        f.write('{"v": 1, "kind": "step_dis')  # a writer killed mid-line
    records = load_journals(tmp_path)
    assert records == jjournal.load_journals(tmp_path) and len(records) == 8
    trace = to_chrome_trace(records)
    assert trace == jjournal.to_chrome_trace(records)
    x = [e for e in trace["traceEvents"] if e["ph"] == "X"]
    assert {e["pid"] for e in x} == {0, 1} and min(e["ts"] for e in x) == 0.0
    with pytest.raises(FileNotFoundError, match="telemetry"):
        load_journals(tmp_path / "nope")


# ---------------------------------------------------------------------------
# the goodput ledger, against the JAX package's
# ---------------------------------------------------------------------------

#: epoch_s, data_wait_ms, ckpt_ms, host_stall_ms, mfu, pad_fraction: a healthy
#: epoch, a starved one with padding, and one without telemetry values
EPOCHS = [(10.0, 1000.0, 500.0, 1500.0, 0.31, None), (8.0, 4000.0, 0.0, 200.0, 0.12, 0.25),
          (6.0, None, None, 100.0, None, None)]


def _tracker(cls):
    t = cls()
    for name in ("misc/epoch_time", "misc/data_wait_ms", "misc/ckpt_ms", "misc/host_stall_ms", "misc/goodput",
                 "misc/mfu", "misc/pad_fraction"):
        t.register_metric(name)
    for epoch_s, dw, ck, st, mfu, pad in EPOCHS:
        t.track("misc/epoch_time", epoch_s)
        t.track("misc/host_stall_ms", st)
        if dw is not None:
            t.track("misc/data_wait_ms", dw)
            t.track("misc/ckpt_ms", ck)
            t.track("misc/goodput", (epoch_s - (dw + st) / 1e3) / epoch_s)
        if mfu is not None:
            t.track("misc/mfu", mfu)
        if pad is not None:
            t.track("misc/pad_fraction", pad)
        t.next_epoch()
    return t


def test_ledger_rows_totals_table_and_advice_equal_the_jax_packages():
    got = ledger_from_tracker(_tracker(TTracker))
    want = jgoodput.ledger_from_tracker(_tracker(JTracker))
    assert got.to_dict() == want.to_dict()
    assert got.format_table() == want.format_table()
    assert got.advise() == want.advise() and len(got.advise()) == 2  # prefetch, then packing
    r = got.rows[0]
    assert (r["data_wait_s"], r["ckpt_s"], r["stall_s"]) == (1.0, 0.5, 1.0)  # stall less the ckpt share
    assert r["productive_s"] == pytest.approx(7.5)
    assert got.rows[2]["data_wait_s"] is None  # no telemetry values: None, not 0
    empty = ledger_from_tracker(TTracker())
    assert empty.rows == [] and empty.totals()["goodput_frac"] is None


# ---------------------------------------------------------------------------
# the hang watchdog
# ---------------------------------------------------------------------------


def _watchdog(tmp_path, journal=None, threshold=10.0):
    clock = {"t": 100.0}
    wd = HangWatchdog(tmp_path / "forensics", rank=0, world_size=4, threshold_s=threshold, journal=journal,
                      clock=lambda: clock["t"])
    return wd, clock


def test_watchdog_dumps_once_per_stall_and_rearms(tmp_path):
    wd, clock = _watchdog(tmp_path)
    clock["t"] += 9.0
    assert wd.check() is None and not (tmp_path / "forensics").exists()
    clock["t"] += 2.0
    assert wd.check() is not None
    assert wd.check() is None  # the same stall: no second dump
    wd.notify()
    clock["t"] += 11.0
    assert wd.check() is not None  # progress re-armed it


def test_watchdog_dump_holds_the_ring_the_stacks_and_the_stragglers(tmp_path, monkeypatch):
    monkeypatch.setattr(truntime, "_barrier_state", {"tag": "epoch_end", "status": "timeout", "stragglers": [1, 3]})
    j = SpanJournal(tmp_path / "telemetry", ring_size=16)
    t = j.now()
    for i in range(20):
        j.emit("step_dispatch", t, t, step=i)
    wd, clock = _watchdog(tmp_path, journal=j, threshold=5.0)
    reasons = []
    wd.on_dump = reasons.append
    clock["t"] += 6.0
    dump = json.loads(open(wd.check()).read())
    assert dump["v"] == 1 and dump["rank"] == 0 and dump["world_size"] == 4
    assert "no span/step progress" in dump["reason"] and reasons == [dump["reason"]]
    assert dump["last_progress_age_s"] == pytest.approx(6.0)
    assert [r["step"] for r in dump["spans"]] == list(range(4, 20))
    assert dump["barrier"]["stragglers"] == [1, 3] and dump["barrier"]["tag"] == "epoch_end"
    me = [th for th in dump["threads"] if th["name"] == threading.current_thread().name]
    assert me and any("test_torch_telemetry" in line for line in me[0]["stack"])
    assert j.tail(1)[0]["kind"] == "watchdog"
    j.close()


# ---------------------------------------------------------------------------
# the pipeline with telemetry armed
# ---------------------------------------------------------------------------


def _batches(n=12, b=16, d=8):
    rng = np.random.RandomState(0)
    w = rng.randn(d, 1).astype(np.float32)
    xs = rng.randn(n, b, d).astype(np.float32)
    return [{"x": x, "y": x @ w} for x in xs]


class _TeleStage(tdml.TrainValStage):
    def __init__(self, batches):
        super().__init__()
        self._batches = batches

    def pre_stage(self):
        self.pipeline.register_model("m", torch.nn.Linear(8, 1), verbose=False)
        self.pipeline.register_optimizer("sgd", lambda params: torch.optim.SGD(params, lr=0.01))
        self.pipeline.register_dataset("train", self._batches, verbose=False)

    def step(self, state, batch):
        return torch.mean((state.model(batch["x"]) - batch["y"]) ** 2)

    def log_every(self):
        return 5


def _recorder_threads():
    return [th.name for th in threading.enumerate() if th.name.startswith(("dml-journal", "dml-watchdog"))]


@pytest.fixture
def tele_run(tmp_path):
    pipeline = tdml.TrainingPipeline(name="tele", device="cpu", telemetry=True)
    pipeline.append_stage(_TeleStage(_batches()), max_epochs=2)
    pipeline.enable_checkpointing(str(tmp_path))
    pipeline.run()
    return pipeline


def test_journal_is_written_and_converts(tele_run):
    run_dir = tele_run.checkpoint_dir.path
    records = load_journals(run_dir)
    kinds = {r["kind"] for r in records}
    for expected in ("run", "stage", "epoch", "step_dispatch", "data_wait", "h2d", "checkpoint"):
        assert expected in kinds, f"no {expected!r} spans in the journal"
    assert sum(r["kind"] == "epoch" for r in records) == 2
    assert sum(r["kind"] == "step_dispatch" for r in records) == 24
    json.dumps(to_chrome_trace(records))
    assert not tele_run.telemetry_armed and journal_mod.active_journal() is None
    assert _recorder_threads() == []
    assert (run_dir / "forensics").is_dir() and not (run_dir / "forensics" / "rank0.json").exists()


def test_goodput_buckets_sum_to_the_epoch_time(tele_run):
    tracker = tele_run.tracker
    assert len(tracker["misc/goodput"]) == 2
    for i, epoch_s in enumerate(tracker["misc/epoch_time"]):
        gp = float(tracker["misc/goodput"][i])
        other = (float(tracker["misc/data_wait_ms"][i]) + float(tracker["misc/host_stall_ms"][i])) / 1e3
        assert 0.0 < gp <= 1.0
        assert gp * float(epoch_s) + other == pytest.approx(float(epoch_s), abs=1e-3)
        assert float(tracker["misc/ckpt_ms"][i]) <= float(tracker["misc/host_stall_ms"][i]) + 1e-6
    gp = json.loads((tele_run.checkpoint_dir.path / "telemetry" / "goodput.json").read_text())
    assert gp["v"] == 1 and gp["totals"]["epochs"] == 2
    for row in gp["epochs"]:
        total = row["data_wait_s"] + row["ckpt_s"] + row["stall_s"] + row["productive_s"]
        assert total == pytest.approx(row["epoch_s"], abs=1e-3)


def test_telemetry_is_off_by_default(tmp_path):
    pipeline = tdml.TrainingPipeline(name="off", device="cpu")
    pipeline.append_stage(_TeleStage(_batches(n=4)), max_epochs=1)
    pipeline.enable_checkpointing(str(tmp_path))
    pipeline.run()
    assert not (pipeline.checkpoint_dir.path / "telemetry").exists()
    assert "misc/goodput" not in pipeline.tracker


@pytest.mark.parametrize("bad", [3.14, 7, ["dir"]])
def test_a_bad_telemetry_argument_is_rejected(bad):
    with pytest.raises(ValueError, match="telemetry"):
        tdml.TrainingPipeline(device="cpu", telemetry=bad)


def test_a_stalled_step_dumps_and_completed_supersedes_the_hang_verdict(tmp_path, monkeypatch):
    verdicts = []
    real = tpipeline.write_requeue_verdict
    monkeypatch.setattr(tpipeline, "write_requeue_verdict",
                        lambda path, requeue, reason, kind, **extra: (verdicts.append((kind, requeue)),
                                                                      real(path, requeue, reason, kind, **extra))[1])

    def stalling_batches():
        for i, b in enumerate(_batches(n=6)):
            if i == 3:
                time.sleep(1.0)  # the hang: 4x the threshold
            yield b

    class StallingStage(_TeleStage):
        def pre_stage(self):
            super().pre_stage()
            self.pipeline.datasets["train"] = stalling_batches()

    pipeline = tdml.TrainingPipeline(name="hang", device="cpu",
                                     telemetry={"hang_threshold_s": 0.25, "watchdog_interval_s": 0.05})
    pipeline.enable_checkpointing(str(tmp_path))
    pipeline.append_stage(StallingStage(_batches(n=6)), max_epochs=1)
    pipeline.run()
    run_dir = pipeline.checkpoint_dir.path
    dump = json.loads((run_dir / "forensics" / "rank0.json").read_text())
    assert dump["rank"] == 0 and "no span/step progress" in dump["reason"]
    assert any(th["stack"] for th in dump["threads"])
    assert verdicts[0] == ("hang", True) and verdicts[-1] == ("completed", False)
    assert json.loads((run_dir / "requeue.json").read_text())["kind"] == "completed"
    assert _recorder_threads() == []


def test_an_uncaught_exception_dumps_forensics(tmp_path):
    class BoomStage(_TeleStage):
        def post_epoch(self):
            raise RuntimeError("boom mid-run")

    pipeline = tdml.TrainingPipeline(name="boom", device="cpu", telemetry={"dir": str(tmp_path / "tele")})
    pipeline.append_stage(BoomStage(_batches(n=4)), max_epochs=1)
    with pytest.raises(RuntimeError, match="boom"):
        pipeline.run()
    dump = json.loads((tmp_path / "forensics" / "rank0.json").read_text())
    assert "uncaught exception" in dump["reason"] and "boom mid-run" in dump["reason"]
    assert not pipeline.telemetry_armed and _recorder_threads() == []


def test_step_saves_are_the_checkpoint_bucket(tmp_path):
    class Saving(_TeleStage):
        def checkpoint_every_steps(self):
            return 4

    pipeline = tdml.TrainingPipeline(name="ckpt", device="cpu", telemetry=True)
    pipeline.enable_checkpointing(str(tmp_path))
    pipeline.append_stage(Saving(_batches()), max_epochs=1)
    pipeline.run()
    tracker = pipeline.tracker
    ckpt_ms, stall_ms = float(tracker["misc/ckpt_ms"][-1]), float(tracker["misc/host_stall_ms"][-1])
    assert 0.0 < ckpt_ms <= stall_ms
    spans = [r for r in load_journals(pipeline.checkpoint_dir.path) if r["kind"] == "checkpoint"]
    assert len(spans) >= 3  # three step saves in the epoch, then the epoch save


# ---------------------------------------------------------------------------
# utils.profiling: the labelled stall timer and the step timer
# ---------------------------------------------------------------------------


def test_stall_timer_labels_the_outermost_span_and_journals_it(tmp_path):
    from dmlcloud_tpu_torch.utils.profiling import StallTimer

    timer = StallTimer()
    j = journal_mod.activate(SpanJournal(tmp_path))
    try:
        with timer.measure(label="checkpoint"):
            with timer.measure(label="metric_readback"):  # nested: counts nothing of its own
                time.sleep(0.01)
        assert float(timer.fetch(torch.tensor(2.5))) == 2.5
        with timer.measure(label="custom"):
            pass
    finally:
        journal_mod.deactivate()
        j.close()
    assert timer.label_ms("checkpoint") >= 10.0 and timer.label_ms("metric_readback") < 10.0
    assert timer.ms == pytest.approx(sum(timer.label_ms(k) for k in ("checkpoint", "metric_readback", "custom")))
    kinds = [(r["kind"], r["label"]) for r in j.tail(8)]
    assert kinds == [("checkpoint", None), ("metric_readback", None), ("host_stall", "custom")]
    timer.reset()
    assert timer.ms == 0.0 and timer.label_ms("checkpoint") == 0.0


def test_step_timer_summary_and_reset():
    from dmlcloud_tpu_torch.utils.profiling import StepTimer

    timer = StepTimer()
    for _ in range(4):
        timer.tick()
        time.sleep(0.002)
    assert timer.count == 3
    summary = timer.summary()
    assert set(summary) == {"mean_ms", "p50_ms", "p95_ms", "p99_ms", "max_ms", "total_ms"}
    assert summary["total_ms"] == pytest.approx(3 * summary["mean_ms"])
    timer.reset()
    timer.tick()
    assert timer.count == 0 and timer.summary() == {}  # no interval spans the reset
