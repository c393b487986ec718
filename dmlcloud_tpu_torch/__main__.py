"""``python -m dmlcloud_tpu_torch`` — the framework's CLI, as subcommands.

Counterpart of ``dmlcloud_tpu/__main__.py``, with the same subcommands, flags,
output text and exit codes:

- ``diag`` (the default): environment / device diagnostics — the same
  reproducibility block a TrainingPipeline logs at run start (argv, host, git
  state, the CUDA device and its power limit, versions) without starting a
  run; the first thing to ask for when a cluster job misbehaves. It reports
  on the device and runs no compute, so it exits 0 on a box without CUDA
  (``"cuda": false``). ``--run`` summarizes a telemetry-armed run directory,
  ``--corpus`` checksums a ``.dmlshard`` corpus.
- ``lint``: the AST-based hazard linter (``lint/cli.py``) — enforces the
  training loop's sync-point contract on the CPU, imports nothing it lints.
- ``verify``: the IR-level preflight, ROADMAP Queue 1 item 13c (the IR tier,
  after item 14); it raises ``NotImplementedError`` until then.
- ``timeline``: merge a telemetry-armed run's per-process span journals into
  one Perfetto/Chrome-trace JSON — open it in https://ui.perfetto.dev or
  chrome://tracing and every rank's epochs, step dispatches, data waits,
  checkpoints, and barriers share one ruler. ``--by-request`` regroups a
  SERVE run into one track per request trace id (batch spans duplicated
  into every linked track). Pure stdlib: runs anywhere the run dir is
  mounted.
- ``trace``: dump ONE request's causal trace from a serve run's journals —
  every span carrying its trace id in ts order, plus the TTFT breakdown
  (queue wait vs prefill vs first decode) and terminal status.
- ``top``: live terminal view of a serving metrics surface — polls either
  a ``/metrics`` HTTP endpoint (``--url``) or a registry snapshot JSON
  (``MetricsRegistry(save_path=...)``) and renders the headline serving
  numbers; ``--once`` prints a single frame (tests, quick checks).

    python -m dmlcloud_tpu_torch                  # diagnostics (diag is implied)
    python -m dmlcloud_tpu_torch --json           # machine-readable diagnostics
    python -m dmlcloud_tpu_torch diag [--json] [--run RUN_DIR] [--corpus DIR]
    python -m dmlcloud_tpu_torch lint [paths...] [--json] [--list-rules]
    python -m dmlcloud_tpu_torch timeline RUN_DIR [-o trace.json] [--by-request]
    python -m dmlcloud_tpu_torch trace RUN_DIR --rid 17   # or --trace tr-17
    python -m dmlcloud_tpu_torch top --url http://127.0.0.1:9100/metrics --once

The bare invocation (no subcommand) is diag, as the reference's is.
"""

import argparse
import json
import sys

_SUBCOMMANDS = ("diag", "lint", "verify", "timeline", "trace", "top")


def _timeline_main(argv) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m dmlcloud_tpu_torch timeline",
        description="Merge a run's per-host telemetry journals into Chrome-trace JSON.",
    )
    parser.add_argument(
        "run_dir",
        help="run directory of a TrainingPipeline(telemetry=...) run "
        "(or its telemetry/ subdirectory)",
    )
    parser.add_argument(
        "-o", "--output", default=None,
        help="write the trace JSON here (default: stdout)",
    )
    parser.add_argument(
        "--by-request", action="store_true",
        help="serve runs: one Perfetto track per request trace id (batch "
        "spans duplicated into every request track they advanced) instead "
        "of the per-rank/thread layout",
    )
    args = parser.parse_args(argv)

    # stdlib-only on purpose: journals convert on a laptop that has only the
    # run directory
    from .telemetry.journal import load_journals, to_chrome_trace, to_request_trace

    try:
        records = load_journals(args.run_dir)
    except FileNotFoundError as e:
        print(f"timeline: {e}", file=sys.stderr)
        return 1
    if not records:
        print(f"timeline: journals under {args.run_dir} contain no spans", file=sys.stderr)
        return 1
    trace = to_request_trace(records) if args.by_request else to_chrome_trace(records)
    ranks = sorted({r.get("rank", 0) for r in records})
    if args.output:
        with open(args.output, "w", encoding="utf-8") as f:
            json.dump(trace, f)
        print(
            f"wrote {len(trace['traceEvents'])} events from {len(records)} spans "
            f"({len(ranks)} rank(s)) to {args.output} — open in https://ui.perfetto.dev",
            file=sys.stderr,
        )
    else:
        json.dump(trace, sys.stdout)
        print()
    return 0


def _trace_main(argv) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m dmlcloud_tpu_torch trace",
        description="Dump one request's causal trace (every span carrying its "
        "trace id, in time order) with the TTFT critical-path breakdown.",
    )
    parser.add_argument("run_dir", help="serve run directory with journals")
    parser.add_argument("--rid", type=int, default=None,
                        help="request id (trace id tr-RID)")
    parser.add_argument("--trace", default=None, metavar="TID",
                        help="explicit trace id (overrides --rid)")
    parser.add_argument("--json", action="store_true",
                        help="machine-readable dump instead of the table")
    args = parser.parse_args(argv)
    if args.trace is None and args.rid is None:
        parser.error("one of --rid / --trace is required")
    tid = args.trace if args.trace is not None else f"tr-{args.rid}"

    from .telemetry.journal import linked_trace_report, load_journals

    try:
        records = load_journals(args.run_dir)
    except FileNotFoundError as e:
        print(f"trace: {e}", file=sys.stderr)
        return 1
    report = linked_trace_report(records)
    spans = report["traces"].get(tid)
    if not spans:
        known = ", ".join(sorted(report["traces"])[:8]) or "none"
        print(f"trace: no spans carry trace id {tid!r} (known: {known})",
              file=sys.stderr)
        return 1
    out = request_trace_summary(spans, status=report["statuses"].get(tid))
    if args.json:
        print(json.dumps({"trace": tid, **out}))
        return 0
    b = out["ttft_breakdown"]
    print(f"trace {tid}: {len(spans)} spans, status={out['status']}")
    if b["ttft_s"] is not None:
        print(
            f"  TTFT {b['ttft_s'] * 1e3:.1f}ms = queue {b['queue_s'] * 1e3:.1f}ms"
            f" + prefill {b['prefill_s'] * 1e3:.1f}ms"
            f" + first decode {b['first_decode_s'] * 1e3:.1f}ms"
            f" (+ {b['other_s'] * 1e3:.1f}ms other)"
        )
    print(f"  {'offset_ms':>10} {'dur_ms':>9}  {'kind':<14} {'where':<8} detail")
    for s in out["spans"]:
        print(
            f"  {s['offset_ms']:>10.2f} {s['dur_ms']:>9.2f}  {s['kind']:<14} "
            f"{s['where']:<8} {s['detail']}"
        )
    return 0


def request_trace_summary(spans: list, status=None) -> dict:
    """One request's trace as a critical-path table + TTFT breakdown
    (``trace`` subcommand's core, importable for tests). ``spans`` is the
    ts-ordered record list from ``linked_trace_report``. The breakdown
    splits arrival -> first token into queue wait, prefill compute, and
    the first decode batch; ``other`` is whatever the three named parts
    don't cover (admission bookkeeping, scheduling gaps)."""
    t0 = min(s["ts"] for s in spans)
    queue_s = sum(s["dur"] for s in spans if s["kind"] == "queue_wait")
    prefills = [s for s in spans if s["kind"] == "prefill"]
    prefill_s = sum(s["dur"] for s in prefills)
    # in this engine the first token is sampled by the LAST prefill chunk;
    # a decode-batch span before that point would belong to other requests
    first_token_t = max(s["ts"] + s["dur"] for s in prefills) if prefills else None
    batch = [s for s in spans
             if s["kind"] in ("decode_batch", "draft", "verify", "medusa")]
    first_decode = min(batch, key=lambda s: s["ts"]) if batch else None
    first_decode_s = first_decode["dur"] if first_decode is not None else 0.0
    ttft = None
    other = None
    if first_token_t is not None:
        ttft = max(first_token_t - t0, 0.0)
        other = max(ttft - queue_s - prefill_s, 0.0)
    rows = []
    core = {"v", "kind", "label", "ts", "dur", "rank", "tid", "trace",
            "traces", "request"}
    for s in spans:
        detail = " ".join(
            f"{k}={s[k]}" for k in sorted(s) if k not in core and s[k] not in (None, "")
        )
        rows.append({
            "offset_ms": round((s["ts"] - t0) * 1e3, 3),
            "dur_ms": round(s["dur"] * 1e3, 3),
            "kind": s["kind"],
            "where": f"r{s.get('rank', 0)}",
            "detail": detail,
        })
    return {
        "status": status,
        "spans": rows,
        "ttft_breakdown": {
            "ttft_s": None if ttft is None else round(ttft, 6),
            "queue_s": round(queue_s, 6),
            "prefill_s": round(prefill_s, 6),
            "first_decode_s": round(first_decode_s, 6),
            "other_s": None if other is None else round(other, 6),
        },
    }


def _hist_quantile(buckets, count, q):
    """Upper-bound estimate of quantile ``q`` from cumulative buckets
    (``[[le, cum], ...]``): the smallest bucket bound covering it."""
    if not count:
        return None
    target = q * count
    for le, cum in buckets:
        if cum >= target:
            return None if le == "+Inf" else float(le)
    return None


def _prom_to_snapshot(families: dict) -> dict:
    """Normalize ``parse_prometheus_text`` output into the registry
    snapshot layout so ``top`` renders both sources with one code path."""
    out: dict = {}
    for name, fam in families.items():
        kind = fam["type"]
        if kind != "histogram":
            series = [
                {"labels": labels, "value": float(value)}
                for sname, labels, value in fam["samples"]
            ]
            out[name] = {"kind": kind, "series": series}
            continue
        per: dict = {}
        for sname, labels, value in fam["samples"]:
            key = tuple(sorted((k, v) for k, v in labels.items() if k != "le"))
            entry = per.setdefault(
                key, {"labels": dict(key), "buckets": [], "sum": 0.0, "count": 0}
            )
            if sname == f"{name}_bucket":
                le = labels.get("le")
                entry["buckets"].append(
                    [le if le == "+Inf" else float(le), int(float(value))]
                )
            elif sname == f"{name}_sum":
                entry["sum"] = float(value)
            elif sname == f"{name}_count":
                entry["count"] = int(float(value))
        out[name] = {"kind": "histogram", "series": list(per.values())}
    return out


def top_frame(snapshot: dict, prev=None) -> str:
    """Render one ``top`` frame from a registry-snapshot dict (importable
    for tests). ``prev`` is ``(snapshot, dt_s)`` from the previous poll —
    when given, counter families render as rates too."""
    def total(name):
        fam = snapshot.get(name)
        if fam is None:
            return None
        return sum(s["value"] for s in fam["series"])

    def rate(name):
        if prev is None:
            return None
        old, dt = prev
        fam = old.get(name)
        cur = total(name)
        if fam is None or cur is None or dt <= 0:
            return None
        return (cur - sum(s["value"] for s in fam["series"])) / dt

    def hist(name):
        fam = snapshot.get(name)
        if fam is None or not fam["series"]:
            return None
        buckets: dict = {}
        tot_sum, tot_count = 0.0, 0
        for s in fam["series"]:
            tot_sum += s["sum"]
            tot_count += s["count"]
            for le, cum in s["buckets"]:
                buckets[le] = buckets.get(le, 0) + cum
        order = sorted(buckets.items(),
                       key=lambda kv: float("inf") if kv[0] == "+Inf" else float(kv[0]))
        return {"count": tot_count, "sum": tot_sum,
                "p50": _hist_quantile(order, tot_count, 0.50),
                "p99": _hist_quantile(order, tot_count, 0.99)}

    def fmt(v, unit="", scale=1.0, digits=1):
        return "-" if v is None else f"{v * scale:.{digits}f}{unit}"

    lines = []
    req = total("dml_serve_requests_total")
    active = total("dml_serve_active_requests")
    term = snapshot.get("dml_serve_terminal_total")
    census = ""
    if term is not None:
        parts = [
            f"{s['labels'].get('status', '?')}={int(s['value'])}"
            for s in term["series"] if s["value"]
        ]
        census = " ".join(sorted(parts))
    lines.append(
        f"requests  submitted={fmt(req, digits=0)} active={fmt(active, digits=0)}"
        + (f"  terminal: {census}" if census else "")
    )
    tok = total("dml_serve_tokens_total")
    drafted = total("dml_serve_drafted_tokens_total")
    accepted = total("dml_serve_accepted_tokens_total")
    accept = (accepted / drafted) if drafted else None
    tks = rate("dml_serve_tokens_total")
    lines.append(
        f"tokens    total={fmt(tok, digits=0)}"
        + (f" ({fmt(tks)}/s)" if tks is not None else "")
        + (f"  spec accept={fmt(accept, digits=2)}" if drafted else "")
    )
    ttft, itl, depth = (hist("dml_serve_ttft_seconds"),
                        hist("dml_serve_itl_seconds"),
                        hist("dml_serve_queue_depth"))
    if ttft is not None:
        lines.append(
            f"latency   ttft p50<={fmt(ttft['p50'], 'ms', 1e3)} "
            f"p99<={fmt(ttft['p99'], 'ms', 1e3)} (n={ttft['count']})"
            + (f"  itl p50<={fmt(itl['p50'], 'ms', 1e3)} "
               f"p99<={fmt(itl['p99'], 'ms', 1e3)}" if itl else "")
        )
    free, live, shared = (total("dml_serve_kv_blocks_free"),
                          total("dml_serve_kv_blocks_live"),
                          total("dml_serve_kv_blocks_shared"))
    if free is not None:
        lines.append(
            f"kv pool   free={fmt(free, digits=0)} live={fmt(live, digits=0)} "
            f"shared={fmt(shared, digits=0)}"
            + (f"  queue depth p50<={fmt(depth['p50'], digits=0)}" if depth else "")
        )
    hits, looks = total("dml_serve_prefix_hits_total"), total("dml_serve_prefix_lookups_total")
    if looks:
        lines.append(
            f"prefix    hit rate={fmt(hits / looks, digits=2)} over "
            f"{int(looks)} lookups, tokens saved="
            f"{fmt(total('dml_serve_prefill_tokens_saved_total'), digits=0)}"
        )
    breaker = snapshot.get("dml_router_breaker_state")
    if breaker is not None:
        code = {0: "closed", 1: "half_open", 2: "open"}
        states = " ".join(
            f"{s['labels'].get('replica', '?')}={code.get(int(s['value']), '?')}"
            for s in sorted(breaker["series"],
                            key=lambda s: s["labels"].get("replica", ""))
        )
        lines.append(
            f"router    breakers: {states}  failovers="
            f"{fmt(total('dml_router_failovers_total'), digits=0)} "
            f"kills={fmt(total('dml_router_kills_total'), digits=0)} "
            f"pending={fmt(total('dml_router_pending_requests'), digits=0)}"
        )
    return "\n".join(lines)


def _top_read(args) -> dict:
    if args.url:
        import urllib.request

        from .telemetry.metrics_registry import parse_prometheus_text

        with urllib.request.urlopen(args.url, timeout=5.0) as resp:
            return _prom_to_snapshot(parse_prometheus_text(
                resp.read().decode("utf-8")))
    import os

    path = args.source
    if os.path.isdir(path):
        for cand in (os.path.join(path, "telemetry", "metrics.json"),
                     os.path.join(path, "metrics.json")):
            if os.path.isfile(cand):
                path = cand
                break
    with open(path, "r", encoding="utf-8") as f:
        return json.load(f)


def _top_main(argv) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m dmlcloud_tpu_torch top",
        description="Live terminal view of a serving metrics surface.",
    )
    parser.add_argument(
        "source", nargs="?", default=None,
        help="registry snapshot JSON (MetricsRegistry(save_path=...)) or a "
        "run dir containing [telemetry/]metrics.json",
    )
    parser.add_argument("--url", default=None,
                        help="poll a Prometheus /metrics endpoint instead")
    parser.add_argument("--interval", type=float, default=1.0,
                        help="seconds between frames (default 1.0)")
    parser.add_argument("--once", action="store_true",
                        help="print one frame and exit (no screen clearing)")
    args = parser.parse_args(argv)
    if (args.source is None) == (args.url is None):
        parser.error("exactly one of SOURCE / --url is required")

    import time as _time

    prev = None
    frame = 0
    while True:
        try:
            snap = _top_read(args)
        except Exception as e:  # noqa: BLE001 — a scrape miss is a message, not a crash
            print(f"top: {e}", file=sys.stderr)
            return 1
        now = _time.monotonic()
        body = top_frame(snap, prev=None if prev is None else (prev[0], now - prev[1]))
        prev = (snap, now)
        frame += 1
        if args.once:
            print(body)
            return 0
        # ANSI clear + home — the classic top repaint
        sys.stdout.write(f"\x1b[2J\x1b[Hdmlcloud_tpu_torch top — {args.url or args.source}"
                         f" (frame {frame}, refresh {args.interval:g}s)\n{body}\n")
        sys.stdout.flush()
        try:
            _time.sleep(max(args.interval, 0.05))
        except KeyboardInterrupt:
            return 0


def _run_telemetry_summary(run_dir: str) -> dict:
    """The diag view of one run's telemetry artifacts: goodput ledger totals
    + journal span counts (or an ``error`` explaining what's missing)."""
    import os

    from .telemetry.journal import load_journals

    out: dict = {"run_dir": run_dir}
    gp_path = None
    for cand in (os.path.join(run_dir, "telemetry", "goodput.json"), os.path.join(run_dir, "goodput.json")):
        if os.path.isfile(cand):
            gp_path = cand
            break
    if gp_path is not None:
        try:
            with open(gp_path, "r", encoding="utf-8") as f:
                gp = json.load(f)
            out["goodput"] = gp["totals"]
            # the goodput advisor: same advice the end-of-run table printed,
            # re-derived from the persisted per-epoch rows (advisory-only)
            from .telemetry.goodput import advise_rows

            advice = advise_rows(gp.get("epochs") or [])
            if advice:
                out["advice"] = advice
        except (OSError, ValueError, KeyError) as e:
            out["goodput_error"] = f"unreadable {gp_path}: {e}"
    else:
        out["goodput_error"] = "no goodput.json (run still in flight, or telemetry not armed?)"
    try:
        records = load_journals(run_dir)
        counts: dict[str, int] = {}
        for r in records:
            counts[r.get("kind", "?")] = counts.get(r.get("kind", "?"), 0) + 1
        out["journal"] = {
            "spans": len(records),
            "ranks": len({r.get("rank", 0) for r in records}),
            "kinds": {k: counts[k] for k in sorted(counts)},
        }
        # SLO burn-rate alert census (serve runs with slos= configured):
        # who fired, which part, how hot the windows were burning
        alerts = [r for r in records if r.get("kind") == "slo_alert"]
        if alerts:
            by_slo: dict[str, int] = {}
            for a in alerts:
                key = f"{a.get('slo', '?')}/{a.get('part', '?')}"
                by_slo[key] = by_slo.get(key, 0) + 1
            out["slo_alerts"] = {
                "count": len(alerts),
                "by_objective": {k: by_slo[k] for k in sorted(by_slo)},
                "max_burn_fast": max(a.get("burn_fast", 0) for a in alerts),
            }
    except FileNotFoundError as e:
        out["journal_error"] = str(e)
    return out


def _native_info() -> dict:
    """Build state of the host data-plane library (``native/_lib.py``: pack
    and interleave, built with g++ at first use into ``native/build/``): a
    missing build silently degrades ``pack_stream``/``interleave`` to the
    interpreter-bound Python paths — correct, but the bandwidth win is
    gone, so diag surfaces it instead of leaving it to a profiler."""
    from .native import _lib
    from .native import interleave as _interleave
    from .native import pack as _pack

    info: dict = {
        "pack": _pack.available(),
        "interleave": _interleave.available(),
    }
    loaded = _lib.loaded_path()
    info["lib"] = str(loaded) if loaded is not None else None
    if not (info["pack"] and info["interleave"]):
        info["hint"] = (
            f"native packer/interleaver not built ({_lib.build_error or 'no symbol'}) — it builds at "
            f"first use with g++ into {_lib.BUILD_DIR} "
            "(pack_stream/interleave fall back to the slower Python paths)"
        )
    return info


def _corpus_info(directory: str) -> dict:
    """Shard-store summary for ``diag --corpus`` — opens and CHECKSUMS every
    shard, so a truncated or bit-flipped file surfaces here (named) instead
    of mid-run. Returns ``{"error": ...}`` rather than raising: diag is a
    diagnostic, the broken corpus IS the finding."""
    from .data.store import ShardCorruptError, ShardStore

    try:
        store = ShardStore(directory, verify=True)
    except ShardCorruptError as e:
        return {"directory": directory, "error": str(e), "file": e.path}
    except (FileNotFoundError, OSError) as e:
        return {"directory": directory, "error": str(e)}
    return store.info()


def _diag_main(argv) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m dmlcloud_tpu_torch diag",
        description="Print environment/topology diagnostics.",
    )
    parser.add_argument("--json", action="store_true", help="machine-readable subset")
    parser.add_argument(
        "--run", default=None, metavar="RUN_DIR",
        help="also summarize a telemetry-armed run directory (goodput ledger "
        "totals + journal span counts)",
    )
    parser.add_argument(
        "--corpus", default=None, metavar="DIR",
        help="also inspect a .dmlshard corpus directory (format version, "
        "shard/record counts; checksums every shard and names a corrupt file)",
    )
    args = parser.parse_args(argv)

    import torch

    from . import __version__
    from .compile.cache import cache_stats
    from .utils.logging import accelerator_info, general_diagnostics

    cache = cache_stats()
    native = _native_info()
    corpus = _corpus_info(args.corpus) if args.corpus else None
    telemetry = _run_telemetry_summary(args.run) if args.run else None
    if not args.json:
        print(f"dmlcloud_tpu_torch {__version__}")
        print(general_diagnostics())
        state = (
            f"{cache['entries']} entries, {cache['size_bytes'] / 1e6:.1f} MB"
            if cache["enabled"]
            else "disabled (TrainingPipeline(compile_cache=True) or $DMLCLOUD_COMPILE_CACHE_DIR)"
        )
        print(f"* COMPILE CACHE:\n    - dir: {cache['dir']}\n    - state: {state}")
        built = lambda b: "yes" if b else "NO"  # noqa: E731 - two-word formatter
        print(
            f"* NATIVE KERNELS:\n    - pack: {built(native['pack'])}\n"
            f"    - interleave: {built(native['interleave'])}"
        )
        if native.get("hint"):
            print(f"    - hint: {native['hint']}")
        if corpus is not None:
            print(f"* SHARD STORE ({corpus['directory']}):")
            if "error" in corpus:
                print(f"    - error: {corpus['error']}")
            else:
                print(f"    - format version: {corpus['format_version']}")
                print(f"    - shards: {corpus['shards']}")
                print(
                    f"    - records: {corpus['total_records']} "
                    f"({corpus['total_tokens']} tokens), checksums OK"
                )
        if telemetry is not None:
            print(f"* TELEMETRY ({telemetry['run_dir']}):")
            gp = telemetry.get("goodput")
            if gp is not None:
                print(
                    f"    - goodput: {gp.get('goodput_frac')} over {gp.get('epochs')} epoch(s) "
                    f"({gp.get('wall_s')}s wall: {gp.get('compile_s')} compile, "
                    f"{gp.get('data_wait_s')} data_wait, {gp.get('ckpt_s')} ckpt, "
                    f"{gp.get('host_stall_s')} host_stall, {gp.get('productive_s')} productive)"
                )
            else:
                print(f"    - goodput: {telemetry.get('goodput_error')}")
            j = telemetry.get("journal")
            if j is not None:
                print(f"    - journal: {j['spans']} spans across {j['ranks']} rank(s): {j['kinds']}")
            else:
                print(f"    - journal: {telemetry.get('journal_error')}")
            slo = telemetry.get("slo_alerts")
            if slo is not None:
                print(
                    f"    - slo alerts: {slo['count']} fired "
                    f"({slo['by_objective']}), max fast burn "
                    f"{slo['max_burn_fast']}x"
                )
            for line in telemetry.get("advice", []):
                print(f"    - advice: {line}")
        return 0

    info = {"version": __version__, "python": sys.version.split()[0], "torch": torch.__version__}
    info["compile_cache"] = cache
    info["native"] = native
    if corpus is not None:
        info["shard_store"] = corpus
    if telemetry is not None:
        info["telemetry"] = telemetry
    # {"cuda": false} without a card; {"error": ...} only when the probe fails
    info.update(accelerator_info())
    print(json.dumps(info))
    return 1 if "error" in info else 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "lint":
        from .lint.cli import main as lint_main

        return lint_main(argv[1:])
    if argv and argv[0] == "verify":
        raise NotImplementedError(
            "python -m dmlcloud_tpu_torch verify (the IR-level preflight, DML6xx) is ROADMAP Queue 1 "
            "item 13c: the linter's IR tier, after item 14"
        )
    if argv and argv[0] == "timeline":
        return _timeline_main(argv[1:])
    if argv and argv[0] == "trace":
        return _trace_main(argv[1:])
    if argv and argv[0] == "top":
        return _top_main(argv[1:])
    if argv and argv[0] == "diag":
        argv = argv[1:]
    elif argv and not argv[0].startswith("-"):
        print(
            f"python -m dmlcloud_tpu_torch: unknown subcommand {argv[0]!r} "
            f"(choose from {', '.join(_SUBCOMMANDS)})",
            file=sys.stderr,
        )
        return 2
    # bare invocation (flags only) == diag, as the reference's
    return _diag_main(argv)


if __name__ == "__main__":
    sys.exit(main())
