"""The port's ``telemetry.metrics_registry`` against the JAX package's.

The same sequence of operations (counters, gauges, histograms, label families
past ``max_series``, a pair of snapshots merged with extra labels) goes
through both packages' ``MetricsRegistry``: the snapshots are equal, the
saved files and the Prometheus pages byte-identical, and every page parses
back through ``parse_prometheus_text`` to the same families.
"""

import json

import numpy as np
import pytest
import torch

from dmlcloud_tpu.telemetry import metrics_registry as jreg
from dmlcloud_tpu_torch.telemetry import metrics_registry as treg

torch.set_num_threads(2)


def _drive(mod, seed: int):
    """One registry through a seeded sequence of operations."""
    rng = np.random.RandomState(seed)
    reg = mod.MetricsRegistry()
    requests = reg.counter("dml_requests_total", "Requests by tenant", labels=("tenant",), max_series=3)
    tokens = reg.counter("dml_tokens_total", 'Tokens "out"\nper step')
    depth = reg.gauge("dml_queue_depth", "Queue depth", labels=("replica", "pool"))
    ttft = reg.histogram("dml_ttft_seconds", "Time to first token", labels=("tenant",))
    itl = reg.histogram("dml_itl_seconds", buckets=mod.ITL_BUCKETS)
    handles = {t: requests.labels(tenant=t) for t in ("a", "b", "c", "d", "e")}  # d and e overflow
    for _ in range(200):
        t = "abcde"[rng.randint(5)]
        handles[t].inc()
        tokens.inc(float(rng.randint(1, 9)))
        ttft.labels(tenant=t).observe(float(rng.lognormal(-3.0, 1.5)))
        itl.observe(float(rng.exponential(0.01)))
    depth.labels(replica="r0", pool="kv").set(17.0)
    g = depth.labels(replica="r1", pool="kv")
    g.set(3.5)
    g.inc(2.0)
    g.dec(0.25)
    return reg


@pytest.mark.parametrize("seed", [0, 1])
def test_snapshots_pages_and_saved_files_are_the_references(tmp_path, seed):
    t, j = _drive(treg, seed), _drive(jreg, seed)
    assert t.snapshot() == j.snapshot()
    assert t.snapshot()["dml_requests_total"] == j.snapshot()["dml_requests_total"]
    overflow = [s for s in t.snapshot()["dml_requests_total"]["series"] if s["labels"]["tenant"] == "__overflow__"]
    # three series, then d and e collapse into one overflow series beside them
    assert len(overflow) == 1 and len(t.snapshot()["dml_requests_total"]["series"]) == 4
    assert t.snapshot()["dml_requests_total"]["overflows"] == 2
    page_t = treg.to_prometheus_text(t.snapshot(), (t.snapshot(), {"replica": "r9"}))
    page_j = jreg.to_prometheus_text(j.snapshot(), (j.snapshot(), {"replica": "r9"}))
    assert page_t == page_j and page_t.endswith("\n")
    assert treg.parse_prometheus_text(page_t) == jreg.parse_prometheus_text(page_j)
    assert t.save(tmp_path / "t.json") == str(tmp_path / "t.json")
    j.save(tmp_path / "j.json")
    assert (tmp_path / "t.json").read_bytes() == (tmp_path / "j.json").read_bytes()
    assert json.loads((tmp_path / "t.json").read_text()) == t.snapshot()


def test_errors_and_parser_round_trip_match_the_reference():
    for mod in (treg, jreg):
        reg = mod.MetricsRegistry()
        reg.counter("x_total", labels=("a",))
    for bad in [lambda m: m.MetricsRegistry().counter("bad name"),
                lambda m: m.MetricsRegistry().gauge("ok", labels=("__reserved",)),
                lambda m: m.MetricsRegistry().histogram("h", buckets=(2.0, 1.0)),
                lambda m: m.parse_prometheus_text("x 1\n"),
                lambda m: m.to_prometheus_text(
                    {"f": {"kind": "counter", "help": "", "series": []}},
                    {"f": {"kind": "gauge", "help": "", "series": []}})]:
        with pytest.raises(ValueError) as want:
            bad(jreg)
        with pytest.raises(ValueError) as got:
            bad(treg)
        assert str(got.value) == str(want.value)
    reg = treg.MetricsRegistry()
    reg.counter("c_total", labels=("a",))
    with pytest.raises(ValueError, match="already registered"):
        reg.gauge("c_total", labels=("a",))
    assert treg.to_prometheus_text() == jreg.to_prometheus_text() == ""
