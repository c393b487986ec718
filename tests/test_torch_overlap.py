"""The port's feed and metric readback on the CPU.

The counterpart of ``tests/test_overlap.py``: every prefetch depth, with and
without the host reader, feeds the same batches in the same order; deferred
and eager metrics give the same epoch values; nothing is read to the host
inside the step loop when deferred, and every step when eager; the NaN guard
fires at the log boundary or, eager, at the step; a preemption break closes
the feed, and the host reader's thread exits. On a CUDA device the copies are
pinned and streamed; that path, and its stream waits, are held by
``chip_smoke.py`` phase 8 on the card.
"""

import os
import signal
import threading
import time

import numpy as np
import pytest
import torch

import dmlcloud_tpu_torch as tdml
from dmlcloud_tpu_torch.data import device_iterator
from dmlcloud_tpu_torch.data.datasets import _prefetch_iter
from dmlcloud_tpu_torch.telemetry import SpanJournal
from dmlcloud_tpu_torch.telemetry import journal as journal_mod
from dmlcloud_tpu_torch.utils.profiling import StallTimer

torch.set_num_threads(2)


class _ToyStage(tdml.TrainValStage):
    """Deterministic linear regression with its knobs set per test."""

    def __init__(self, deferred=True, prefetch=2, host_prefetch=0, log_every_n=50, guard=True, n_batches=8):
        super().__init__()
        self._deferred, self._prefetch, self._host_prefetch = deferred, prefetch, host_prefetch
        self._log_every, self._guard, self._n_batches = log_every_n, guard, n_batches

    def deferred_metrics(self):
        return self._deferred

    def prefetch_depth(self):
        return self._prefetch

    def host_prefetch(self):
        return self._host_prefetch

    def log_every(self):
        return self._log_every

    def nan_guard(self):
        return self._guard

    def pre_stage(self):
        rng = np.random.RandomState(7)
        w_true = rng.randn(4, 1).astype(np.float32)
        xs = rng.randn(self._n_batches, 16, 4).astype(np.float32)
        model = torch.nn.Linear(4, 1, bias=False)
        torch.nn.init.zeros_(model.weight)
        self.pipeline.register_model("linear", model, verbose=False)
        self.pipeline.register_optimizer("sgd", lambda params: torch.optim.SGD(params, lr=0.05, momentum=0.9))
        self.pipeline.register_dataset("train", [{"x": x, "y": x @ w_true} for x in xs], verbose=False)

    def step(self, state, batch):
        pred = state.model(batch["x"])
        loss = torch.mean((pred - batch["y"]) ** 2)
        return loss, {"abs_err": torch.mean(torch.abs(pred - batch["y"]))}

    def val_epoch(self):
        pass


def _run(stage, max_epochs=3):
    pipeline = tdml.TrainingPipeline(name="overlap", device="cpu")
    pipeline.append_stage(stage, max_epochs=max_epochs, name="TrainValStage")
    pipeline.run()
    return pipeline


@pytest.mark.parametrize("prefetch, host_prefetch", [(0, 2), (1, 0), (1, 2), (2, 0), (2, 2)])
def test_prefetch_depths_feed_the_same_batches(prefetch, host_prefetch):
    base_stage, stage = _ToyStage(prefetch=0), _ToyStage(prefetch=prefetch, host_prefetch=host_prefetch)
    base, got = _run(base_stage), _run(stage)
    for name in ("train/loss", "train/abs_err"):
        assert [float(v) for v in got.tracker[name]] == [float(v) for v in base.tracker[name]], name
    assert torch.equal(stage.state.model.weight, base_stage.state.model.weight)


def test_deferred_and_eager_metrics_give_the_same_epoch_values():
    p_def, p_eag = _run(_ToyStage(deferred=True)), _run(_ToyStage(deferred=False))
    for name in ("train/loss", "train/abs_err", "misc/total_train_batches"):
        assert [float(v) for v in p_def.tracker[name]] == [float(v) for v in p_eag.tracker[name]], name


def _count_fetches(monkeypatch, stage):
    calls = []
    real = StallTimer.fetch

    def counting(self, value, label="metric_readback"):
        if stage._in_step_loop:
            calls.append(label)
        return real(self, value, label)

    monkeypatch.setattr(StallTimer, "fetch", counting)
    return calls


def test_no_metric_read_in_the_step_loop_when_deferred(monkeypatch):
    stage = _ToyStage(deferred=True)  # log_every 50 > 8 steps: no boundary inside the epoch
    calls = _count_fetches(monkeypatch, stage)
    _run(stage)
    assert calls == [] and not stage._in_step_loop


def test_eager_metrics_read_every_step(monkeypatch):
    stage = _ToyStage(deferred=False)
    calls = _count_fetches(monkeypatch, stage)
    _run(stage, max_epochs=1)
    assert calls == ["metric_readback"] * stage._n_batches
    assert stage._stall.label_ms("metric_readback") > 0


class _NaNStage(_ToyStage):
    def step(self, state, batch):
        return torch.mean((state.model(batch["x"]) - batch["y"]) ** 2) / 0.0  # NaN from step one


def test_nan_guard_fires_at_the_log_boundary():
    with pytest.raises(FloatingPointError, match="non-finite loss .* at step 4 "):
        _run(_NaNStage(log_every_n=4), max_epochs=1)


def test_nan_guard_disabled_does_not_raise():
    p = _run(_NaNStage(log_every_n=4, guard=False), max_epochs=1)
    assert np.isnan(float(p.tracker["train/loss"][-1]))


def test_nan_guard_checks_every_step_when_eager():
    with pytest.raises(FloatingPointError, match="non-finite loss .* at step 1 "):
        _run(_NaNStage(deferred=False, log_every_n=0), max_epochs=1)


def test_device_prefetch_override_is_the_depth():
    class OldStyle(tdml.TrainValStage):
        def device_prefetch(self):
            return 0

    assert OldStyle().prefetch_depth() == 0 and tdml.TrainValStage().prefetch_depth() == 2


# ---------------------------------------------------------------------------
# device_iterator and its host reader
# ---------------------------------------------------------------------------


class _Source:
    def __init__(self, n):
        self.n, self.pulled = n, 0

    def __iter__(self):
        for i in range(self.n):
            self.pulled += 1
            yield {"x": np.full((2, 3), i, np.float32), "meta": "keep"}


@pytest.mark.parametrize("prefetch, read", [(0, (1, 2)), (1, (1, 2)), (2, (2, 3))])
def test_device_iterator_reads_prefetch_batches_ahead(tmp_path, prefetch, read):
    src = _Source(6)
    j = journal_mod.activate(SpanJournal(tmp_path))
    try:
        it = device_iterator(src, "cpu", prefetch=prefetch)
        first = next(it)
        # while the step on batch N runs, batches up to N + prefetch - 1 are
        # copied; asking for N + 1 first reads N + prefetch
        assert src.pulled == read[0]
        second = next(it)
        assert src.pulled == read[1]
        rest = [second, *it]
    finally:
        journal_mod.deactivate()
        j.close()
    assert isinstance(first["x"], torch.Tensor) and first["meta"] == "keep"
    assert [float(b["x"][0, 0]) for b in [first, *rest]] == [0, 1, 2, 3, 4, 5]
    h2d = [r for r in j.tail(64) if r["kind"] == "h2d"]
    assert len(h2d) == 6 and all(r["prefetch"] == prefetch for r in h2d)


def test_device_iterator_on_a_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA path runs instead of raising")
    with pytest.raises((RuntimeError, AssertionError)):
        next(device_iterator(_Source(2), "cuda"))


def test_prefetch_iter_reraises_the_sources_error():
    def bad():
        yield 1
        raise KeyError("source broke")

    it = _prefetch_iter(bad(), 2)
    assert next(it) == 1
    with pytest.raises(KeyError, match="source broke"):
        next(it)


def _host_readers():
    return [th for th in threading.enumerate() if th.name == "dml-host-prefetch"]


def _wait_gone(threads, timeout=5.0):
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline and any(th.is_alive() for th in threads):
        time.sleep(0.02)
    return [th for th in threads if th.is_alive()]


def test_closing_the_feed_stops_the_host_reader():
    it = device_iterator(_Source(100), "cpu", prefetch=2, host_prefetch=2)
    next(it)
    readers = _host_readers()
    assert readers, "no host reader thread was started"
    it.close()
    assert _wait_gone(readers) == []


def test_a_preemption_break_closes_the_feed_and_the_host_reader_exits(tmp_path):
    class Preempted(_ToyStage):
        def checkpoint_every_steps(self):
            return 2

        def train_dataset(self):
            ds = super().train_dataset()

            def signalling():
                for i, batch in enumerate(ds):
                    yield batch
                    if i == 0:
                        os.kill(os.getpid(), signal.SIGUSR1)

            return signalling()

    stage = Preempted(host_prefetch=2, n_batches=64)
    pipeline = tdml.TrainingPipeline(name="drain", device="cpu", telemetry=True)
    pipeline.enable_checkpointing(str(tmp_path))
    pipeline.enable_preemption_handling(("SIGUSR1",))
    pipeline.append_stage(stage, max_epochs=1)
    seen = []
    real_feed = stage._feed

    def watching_feed(ds):
        feed = real_feed(ds)
        seen.append(feed)
        return feed

    stage._feed = watching_feed
    pipeline.run()
    assert stage._mid_epoch_exit and stage.state.step == 2  # drained at the first step save
    assert seen and seen[0].gi_frame is None  # the feed generator was closed, not left suspended
    assert _wait_gone(_host_readers()) == []
    assert [th.name for th in threading.enumerate() if th.name.startswith(("dml-journal", "dml-watchdog"))] == []
