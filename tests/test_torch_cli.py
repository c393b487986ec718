"""``python -m dmlcloud_tpu_torch`` against the reference's CLI
(``dmlcloud_tpu/__main__.py``), on the CPU.

One seeded run directory is written with the port's own writers and read by
both CLIs: two ranks' span journals (training spans, serve request spans with
trace ids, a fault, SLO alerts), a goodput ledger whose epochs starve on data
(so the advisor speaks), a ``.dmlshard`` corpus and a registry snapshot of the
serving families. Both ``main``s run in this process, their output captured:

- ``timeline`` (stdout and ``-o``), ``--by-request``, ``trace --rid`` as text
  and ``--json``, ``top --once`` over the snapshot file and the run directory,
  ``top_frame`` over a pair of snapshots, ``request_trace_summary``,
  ``_prom_to_snapshot`` and ``_hist_quantile`` give the reference's output;
- ``diag --json --run --corpus``: the telemetry and shard-store summaries are
  the reference's, the compile-cache and native key sets too, and the text
  form's telemetry and shard-store blocks are the reference's lines;
- a corrupt shard, an unknown subcommand, a bare invocation, an empty or
  missing run directory and an unknown trace id give the reference's
  messages and exit codes; ``verify`` raises ``NotImplementedError`` naming
  item 13.
"""

import json
import os
import re
import shutil

import numpy as np
import pytest
import torch

import dmlcloud_tpu.__main__ as ref_cli
import dmlcloud_tpu_torch.__main__ as port_cli
from dmlcloud_tpu_torch.data.store import build_corpus
from dmlcloud_tpu_torch.telemetry.goodput import GoodputLedger
from dmlcloud_tpu_torch.telemetry.journal import SpanJournal, linked_trace_report, load_journals
from dmlcloud_tpu_torch.telemetry.metrics_registry import (ITL_BUCKETS, QUEUE_DEPTH_BUCKETS, TTFT_BUCKETS,
                                                           MetricsRegistry, parse_prometheus_text,
                                                           to_prometheus_text)

torch.set_num_threads(2)


def _journal(tdir, rank, rs):
    """One rank's seeded spans: a run with two epochs of steps, data waits
    and a checkpoint, and on rank 0 four served requests (one faulted) with
    SLO alerts."""
    j = SpanJournal(tdir, rank=rank)
    t = j._perf0 + 1.0
    j.emit("run", t, t + 5.0)
    for epoch in (1, 2):
        j.emit("epoch", t, t + 2.0, label=f"e{epoch}", epoch=epoch)
        for step in range(4):
            a = t + step * 0.4
            j.emit("data_wait", a, a + float(rs.uniform(0.01, 0.2)))
            j.emit("step_dispatch", a + 0.2, a + 0.2 + float(rs.uniform(0.001, 0.01)), step=step + 1)
        j.emit("checkpoint", t + 1.8, t + 1.95, label="save")
        t += 2.0
    if rank == 0:
        for rid in range(4):
            a = t + rid * 0.05
            tr = f"tr-{rid}"
            j.emit("queue_wait", a, a + float(rs.uniform(0.001, 0.05)), label=f"req{rid}", request=rid, trace=tr)
            j.emit("admission", a + 0.06, a + 0.06, label=f"req{rid}", request=rid, trace=tr, tenant=None)
            j.emit("prefill", a + 0.07, a + 0.07 + float(rs.uniform(0.01, 0.03)), label=f"req{rid}", request=rid,
                   trace=tr, chunk=int(rs.randint(8, 64)), fill=int(rs.randint(8, 64)))
        for b in range(3):
            a = t + 0.3 + b * 0.02
            j.emit("decode_batch", a, a + float(rs.uniform(0.005, 0.015)), label="b4", active=4, bucket=4,
                   blocks=int(rs.randint(4, 16)), traces=[f"tr-{r}" for r in range(4 - (b == 2))])
        j.emit("fault", t + 0.37, t + 0.38, label="req3", request=3, trace="tr-3", status="error",
               error="RuntimeError: injected")
        for k in range(3):
            j.emit("slo_alert", t + 0.4 + k * 0.01, label="ttft", slo="ttft" if k < 2 else "avail",
                   part="ttft" if k < 2 else "availability", burn_fast=round(float(rs.uniform(2, 20)), 3))
    j.close()


def _registry(rs, tokens):
    reg = MetricsRegistry()
    reg.counter("dml_serve_requests_total").inc(12)
    reg.gauge("dml_serve_active_requests").set(3)
    term = reg.counter("dml_serve_terminal_total", labels=("status",))
    for status, n in (("ok", 9), ("error", 1), ("shed", 0)):
        term.labels(status=status).inc(n)
    reg.counter("dml_serve_tokens_total").inc(tokens)
    reg.counter("dml_serve_drafted_tokens_total").inc(40)
    reg.counter("dml_serve_accepted_tokens_total").inc(31)
    for name, buckets in (("dml_serve_ttft_seconds", TTFT_BUCKETS), ("dml_serve_itl_seconds", ITL_BUCKETS),
                          ("dml_serve_queue_depth", QUEUE_DEPTH_BUCKETS)):
        fam = reg.histogram(name, buckets=buckets)
        for v in rs.exponential(0.05 if "seconds" in name else 3.0, size=25):
            fam.observe(float(v))
    reg.gauge("dml_serve_kv_blocks_free").set(100)
    reg.gauge("dml_serve_kv_blocks_live").set(28)
    reg.gauge("dml_serve_kv_blocks_shared").set(4)
    reg.counter("dml_serve_prefix_hits_total").inc(7)
    reg.counter("dml_serve_prefix_lookups_total").inc(10)
    reg.counter("dml_serve_prefill_tokens_saved_total").inc(448)
    breaker = reg.gauge("dml_router_breaker_state", labels=("replica",))
    for replica, state in (("r1", 2), ("r0", 0), ("r2", 1)):
        breaker.labels(replica=replica).set(state)
    reg.counter("dml_router_failovers_total").inc(2)
    reg.counter("dml_router_kills_total").inc(1)
    reg.gauge("dml_router_pending_requests").set(5)
    return reg


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    rs = np.random.RandomState(18)
    run_dir = root / "run"
    tdir = run_dir / "telemetry"
    for rank in (0, 1):
        _journal(str(tdir), rank, rs)
    rows = []
    for epoch in (1, 2):
        epoch_s = round(float(rs.uniform(8, 12)), 6)
        wait = round(epoch_s * (0.45 if epoch == 2 else 0.1), 6)
        rows.append({"epoch": epoch, "epoch_s": epoch_s, "data_wait_s": wait, "ckpt_s": 0.5, "goodput": 0.5,
                     "mfu": None, "pad_fraction": 0.4 if epoch == 2 else None, "shard_reader": None,
                     "stall_s": 0.25, "productive_s": round(epoch_s - wait - 0.75, 6)})
    with open(tdir / "goodput.json", "w") as f:
        json.dump(GoodputLedger(rows, compile_s=1.5).to_dict(), f)
    snap_a = _registry(np.random.RandomState(1), 500).snapshot()
    reg_b = _registry(np.random.RandomState(2), 800)
    reg_b.save(str(tdir / "metrics.json"))
    corpus = root / "corpus"
    docs = [rs.randint(0, 1000, size=int(n)).astype(np.int32) for n in rs.randint(1, 300, size=60)]
    build_corpus(str(corpus), docs, shard_tokens=2000)
    empty = root / "empty"
    (empty / "telemetry").mkdir(parents=True)
    return {"root": root, "run": str(run_dir), "corpus": str(corpus), "empty": str(empty),
            "snap_a": snap_a, "snap_b": reg_b.snapshot(), "metrics": str(tdir / "metrics.json")}


def _call(cli, argv, capsys):
    capsys.readouterr()
    rc = cli.main(list(argv))
    out, err = capsys.readouterr()
    return rc, out, err


def _both(argv, capsys):
    return _call(ref_cli, argv, capsys), _call(port_cli, argv, capsys)


def _unprog(text):
    """The message with the program's name taken out: the CLIs differ in it alone."""
    return text.replace("dmlcloud_tpu_torch", "dmlcloud_tpu")


# ---------------------------------------------------------------------------
# timeline / trace / top
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flags", [[], ["--by-request"]], ids=["ranks", "by-request"])
def test_timeline_is_the_references(run, capsys, flags):
    ref, port = _both(["timeline", run["run"], *flags], capsys)
    assert port == ref and port[0] == 0
    trace = json.loads(port[1])
    if not flags:
        spans = load_journals(run["run"])
        assert sum(e["ph"] == "X" for e in trace["traceEvents"]) == len(spans)
        assert {e["pid"] for e in trace["traceEvents"]} == {0, 1}
    else:
        assert trace["metadata"]["traces"] == 4


def test_timeline_to_a_file_is_the_references(run, capsys):
    out = {}
    for name, cli in (("ref", ref_cli), ("port", port_cli)):
        path = str(run["root"] / f"trace-{name}.json")
        rc, stdout, err = _call(cli, ["timeline", run["run"], "-o", path], capsys)
        with open(path) as f:
            out[name] = (rc, stdout, err.replace(path, "<out>"), f.read())
    assert out["port"] == out["ref"] and out["port"][0] == 0
    assert re.match(r"wrote \d+ events from \d+ spans \(2 rank\(s\)\)", out["port"][2])


@pytest.mark.parametrize("argv", [["--rid", "0"], ["--rid", "3"], ["--trace", "tr-1", "--json"],
                                  ["--rid", "3", "--json"]])
def test_trace_is_the_references(run, capsys, argv):
    ref, port = _both(["trace", run["run"], *argv], capsys)
    assert port == ref and port[0] == 0
    if "--json" in argv:
        out = json.loads(port[1])
        assert out["ttft_breakdown"]["ttft_s"] > 0 and out["status"] == ("error" if "3" in argv else None)


def test_request_trace_summary_is_the_references(run):
    report = linked_trace_report(load_journals(run["run"]))
    for tid, spans in report["traces"].items():
        want = ref_cli.request_trace_summary(spans, status=report["statuses"][tid])
        assert port_cli.request_trace_summary(spans, status=report["statuses"][tid]) == want
    # a trace with no prefill has no TTFT, as in the reference
    no_prefill = [s for s in report["traces"]["tr-0"] if s["kind"] != "prefill"]
    assert port_cli.request_trace_summary(no_prefill) == ref_cli.request_trace_summary(no_prefill)
    assert port_cli.request_trace_summary(no_prefill)["ttft_breakdown"]["ttft_s"] is None


@pytest.mark.parametrize("argv", [["--rid", "9"], ["--trace", "nope"], []], ids=["unknown-rid", "unknown-trace",
                                                                               "no-id"])
def test_trace_errors_are_the_references(run, capsys, argv):
    if not argv:
        with pytest.raises(SystemExit) as ref_exit:
            _call(ref_cli, ["trace", run["run"]], capsys)
        ref_err = capsys.readouterr().err
        with pytest.raises(SystemExit) as port_exit:
            _call(port_cli, ["trace", run["run"]], capsys)
        assert port_exit.value.code == ref_exit.value.code == 2
        # the usage lines wrap at the program's name; the error line is the reference's
        assert _unprog(capsys.readouterr().err).splitlines()[-1] == ref_err.splitlines()[-1]
        return
    ref, port = _both(["trace", run["run"], *argv], capsys)
    assert port == ref and port[0] == 1 and "no spans carry trace id" in port[2]


@pytest.mark.parametrize("source", ["snapshot", "run_dir"])
def test_top_once_is_the_references(run, capsys, source):
    src = run["metrics"] if source == "snapshot" else run["run"]
    ref, port = _both(["top", src, "--once"], capsys)
    assert port == ref and port[0] == 0
    lines = port[1].splitlines()
    assert lines[0].startswith("requests  submitted=12 active=3  terminal: error=1 ok=9")
    assert [ln.split()[0] for ln in lines] == ["requests", "tokens", "latency", "kv", "prefix", "router"]


def test_top_frame_over_a_pair_of_snapshots_is_the_references(run):
    a, b = run["snap_a"], run["snap_b"]
    for prev in (None, (a, 2.0), (a, 0.0)):
        assert port_cli.top_frame(b, prev=prev) == ref_cli.top_frame(b, prev=prev)
    assert "(150.0/s)" in port_cli.top_frame(b, prev=(a, 2.0))
    assert port_cli.top_frame({}) == ref_cli.top_frame({}) == "requests  submitted=- active=-\ntokens    total=-"


def test_prom_to_snapshot_and_hist_quantile_are_the_references(run):
    fams = parse_prometheus_text(to_prometheus_text(run["snap_b"]))
    got = port_cli._prom_to_snapshot(fams)
    assert got == ref_cli._prom_to_snapshot(fams)
    assert port_cli.top_frame(got) == ref_cli.top_frame(got) == port_cli.top_frame(run["snap_b"])
    buckets = [[0.01, 2], [0.1, 7], [1.0, 9], ["+Inf", 10]]
    for q in (0.0, 0.2, 0.5, 0.9, 0.95, 1.0):
        for count in (0, 10, 20):
            assert port_cli._hist_quantile(buckets, count, q) == ref_cli._hist_quantile(buckets, count, q)


def test_top_errors_are_the_references(run, capsys):
    missing = str(run["root"] / "no-such.json")
    ref, port = _both(["top", missing, "--once"], capsys)
    assert port == ref and port[0] == 1
    for argv in (["top", "--once"], ["top", missing, "--url", "http://127.0.0.1:1/metrics"]):
        with pytest.raises(SystemExit) as ref_exit:
            _call(ref_cli, argv, capsys)
        ref_err = capsys.readouterr().err
        with pytest.raises(SystemExit) as port_exit:
            _call(port_cli, argv, capsys)
        assert port_exit.value.code == ref_exit.value.code == 2
        assert _unprog(capsys.readouterr().err).splitlines()[-1] == ref_err.splitlines()[-1]


# ---------------------------------------------------------------------------
# diag
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def diag_json(run):
    """One ``diag --json --run --corpus`` of each CLI, shared by the asserts."""
    import contextlib
    import io

    out = {}
    for name, cli in (("ref", ref_cli), ("port", port_cli)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["diag", "--json", "--run", run["run"], "--corpus", run["corpus"]])
        out[name] = (rc, json.loads(buf.getvalue()))
    return out


def test_diag_json_run_and_corpus_are_the_references(diag_json):
    (ref_rc, ref), (rc, port) = diag_json["ref"], diag_json["port"]
    assert rc == ref_rc == 0
    assert port["telemetry"] == ref["telemetry"]
    assert port["telemetry"]["journal"]["ranks"] == 2 and port["telemetry"]["slo_alerts"]["count"] == 3
    assert len(port["telemetry"]["advice"]) == 2  # the starved epoch, and the pad fraction
    assert port["shard_store"] == ref["shard_store"] and port["shard_store"]["shards"] > 1
    assert set(port["compile_cache"]) == set(ref["compile_cache"])
    # the hint is there exactly when a library is missing, in either package
    for native in (port["native"], ref["native"]):
        assert set(native) - {"hint"} == {"pack", "interleave", "lib"}
        assert ("hint" in native) == (not (native["pack"] and native["interleave"]))
    # torch's version where the reference names jax's, and the device as accelerator_info gives it
    assert port["torch"] == torch.__version__ and "jax" not in port
    assert port["cuda"] is torch.cuda.is_available()
    assert set(ref) - set(port) == {"jax", "backend", "process_index", "process_count", "global_devices",
                                    "local_devices", "device_kinds", "device_kind_counts"}


def _blocks(text, heads=("* TELEMETRY", "* SHARD STORE")):
    """The lines of the named ``* ...`` blocks of diag's text output."""
    keep, out = False, []
    for line in text.splitlines():
        if line.startswith("* "):
            keep = line.startswith(heads)
        if keep:
            out.append(line)
    return out


def test_diag_text_blocks_are_the_references(run, capsys):
    argv = ["diag", "--run", run["run"], "--corpus", run["corpus"]]
    ref, port = _both(argv, capsys)
    assert port[0] == ref[0] == 0
    assert _blocks(port[1]) == _blocks(ref[1]) and len(_blocks(port[1])) == 10
    assert port[1].startswith("dmlcloud_tpu_torch ")
    assert "* COMPILE CACHE:" in port[1] and "* NATIVE KERNELS:" in port[1]


def test_diag_names_a_corrupt_shard_as_the_reference(run, capsys):
    corpus = run["root"] / "corrupt"
    shutil.copytree(run["corpus"], corpus)
    shard = sorted(p for p in os.listdir(corpus) if p.endswith(".dmlshard"))[1]
    with open(corpus / shard, "r+b") as f:
        f.seek(-3, os.SEEK_END)
        byte = f.read(1)
        f.seek(-3, os.SEEK_END)
        f.write(bytes([byte[0] ^ 0xFF]))
    ref, port = _both(["diag", "--json", "--corpus", str(corpus)], capsys)
    assert port[0] == ref[0] == 0
    want, got = json.loads(ref[1])["shard_store"], json.loads(port[1])["shard_store"]
    assert got == want and got["file"].endswith(shard) and shard in got["error"]
    ref, port = _both(["diag", "--corpus", str(corpus)], capsys)
    assert _blocks(port[1]) == _blocks(ref[1])
    assert port_cli._corpus_info(str(run["root"] / "none")) == ref_cli._corpus_info(str(run["root"] / "none"))


def test_compile_cache_reads_inductors_own_default_as_unset(monkeypatch):
    """Recent torch writes Inductor's temporary default into
    ``TORCHINDUCTOR_CACHE_DIR`` when Dynamo is imported; that is no
    configured cache, so ``cache_stats`` says disabled, as the reference's
    does on a process that configured none, and ``compile_cache=True``
    resolves to the port's default directory, not the temporary one."""
    from torch._inductor.runtime.cache_dir_utils import default_cache_dir

    from dmlcloud_tpu.compile import cache as ref_cache
    from dmlcloud_tpu_torch.compile import cache

    monkeypatch.delenv(cache.ENV_VAR, raising=False)
    monkeypatch.setenv(cache.INDUCTOR_ENV_VAR, default_cache_dir())
    assert cache.configured_cache_dir() is None
    assert cache.cache_stats()["enabled"] is False
    assert cache.resolve_cache_dir(True) == os.path.abspath(os.path.expanduser(cache.DEFAULT_CACHE_DIR))
    if ref_cache.configured_cache_dir() is None:
        assert ref_cache.cache_stats()["enabled"] is cache.cache_stats()["enabled"]
    # a directory set on purpose still counts
    monkeypatch.setenv(cache.INDUCTOR_ENV_VAR, "/somewhere/else")
    assert cache.configured_cache_dir() == "/somewhere/else" and cache.cache_stats()["enabled"] is True


# ---------------------------------------------------------------------------
# dispatch, exit codes
# ---------------------------------------------------------------------------

def test_unknown_subcommand_exits_2_as_the_reference(capsys):
    ref, port = _both(["bogus"], capsys)
    assert port[0] == ref[0] == 2
    assert _unprog(port[2]) == ref[2] and "unknown subcommand 'bogus'" in port[2]
    assert port_cli._SUBCOMMANDS == ref_cli._SUBCOMMANDS


def test_bare_invocation_is_diag(capsys):
    rc, out, _ = _call(port_cli, [], capsys)
    assert rc == 0 and out.startswith("dmlcloud_tpu_torch ") and "* GENERAL:" in out
    rc, out, _ = _call(port_cli, ["--json"], capsys)
    info = json.loads(out)
    import dmlcloud_tpu
    import dmlcloud_tpu_torch

    assert rc == 0 and info["version"] == dmlcloud_tpu_torch.__version__ == dmlcloud_tpu.__version__
    assert "telemetry" not in info and "shard_store" not in info


@pytest.mark.parametrize("which", ["empty", "missing"])
def test_timeline_of_an_empty_run_exits_1_as_the_reference(run, capsys, which):
    path = run["empty"] if which == "empty" else str(run["root"] / "missing")
    ref, port = _both(["timeline", path], capsys)
    assert port == ref and port[0] == 1 and port[1] == ""
    if which == "empty":
        # journals that hold no span
        tdir = os.path.join(path, "telemetry")
        open(os.path.join(tdir, "journal-rank0.jsonl"), "w").close()
        ref, port = _both(["timeline", path], capsys)
        assert port == ref and "contain no spans" in port[2]


def test_verify_names_the_linters_ir_tier():
    with pytest.raises(NotImplementedError, match="item 13"):
        port_cli.main(["verify"])
