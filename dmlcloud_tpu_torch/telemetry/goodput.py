"""Goodput ledger: where the wall clock of a run went.

Counterpart of ``dmlcloud_tpu/telemetry/goodput.py`` (:36-235). Each epoch's
wall time splits into disjoint buckets:

- ``data_wait_s``   host blocked waiting for the next batch (timed around the
  feed iterator's ``next()``),
- ``ckpt_s``        checkpoint dispatch and commit waits (StallTimer spans
  labelled ``checkpoint``),
- ``stall_s``       every other accounted host block (metric readbacks, the
  epoch-end sync): the StallTimer total less the checkpoint share,
- ``productive_s``  the rest: time the host spent dispatching steps while the
  device computed,

so the buckets sum to ``epoch_s`` and ``goodput = productive_s / epoch_s``.
The per-epoch numbers ride the tracker (``misc/goodput``,
``misc/data_wait_ms``, ``misc/ckpt_ms``, ``misc/pad_fraction``), reduced
across processes by the epoch-end exchange; this module reads the reduced
histories back into rows, totals, a table, advice and ``goodput.json``. Rows,
totals and advice are the reference's, key for key and word for word.

MFU comes from ``Stage.step_flops()`` against ``utils.profiling``'s peak
table, or, when that is undeclared and the step is precompiled, from
``flops_from_compiled``: the FLOPs ``torch.utils.flop_counter`` counted over
one step during the precompile phase (the reference reads XLA's cost
analysis of the compiled executable).
"""

from __future__ import annotations

from typing import Any

__all__ = ["GoodputLedger", "ledger_from_tracker", "advise_rows", "flops_from_compiled"]

#: tracker metric -> ledger column (values in ms except goodput/mfu)
_EPOCH_METRICS = {
    "misc/epoch_time": "epoch_s",
    "misc/data_wait_ms": "data_wait_s",
    "misc/ckpt_ms": "ckpt_s",
    "misc/host_stall_ms": "stall_total_s",
    "misc/goodput": "goodput",
    "misc/mfu": "mfu",
    "misc/pad_fraction": "pad_fraction",
    "misc/shard_reader": "shard_reader",
}

#: data_wait share of an epoch above which the advisor speaks up
_ADVISE_DATA_WAIT_FRAC = 0.3

#: pad share of the token slots above which packing is worth suggesting
_ADVISE_PAD_FRAC = 0.1


def _get(tracker, name: str, epoch_idx: int) -> float | None:
    if name not in tracker:
        return None
    hist = tracker[name]
    if epoch_idx >= len(hist) or hist[epoch_idx] is None:
        return None
    return float(hist[epoch_idx])


class GoodputLedger:
    """Per-epoch rows + run totals of the wall-time decomposition."""

    def __init__(self, rows: list[dict], compile_s: float = 0.0):
        self.rows = rows
        self.compile_s = float(compile_s)

    # -- aggregation ---------------------------------------------------------
    def totals(self) -> dict:
        def s(key: str) -> float:
            return sum(r[key] or 0.0 for r in self.rows)

        epoch_s = s("epoch_s")
        out = {
            "epochs": len(self.rows),
            "wall_s": round(epoch_s + self.compile_s, 3),
            "compile_s": round(self.compile_s, 3),
            "data_wait_s": round(s("data_wait_s"), 3),
            "ckpt_s": round(s("ckpt_s"), 3),
            "host_stall_s": round(s("stall_s"), 3),
            "productive_s": round(s("productive_s"), 3),
        }
        total = epoch_s + self.compile_s
        out["goodput_frac"] = round(s("productive_s") / total, 4) if total > 0 else None
        mfus = [r["mfu"] for r in self.rows if r.get("mfu") is not None]
        out["mfu"] = round(sum(mfus) / len(mfus), 4) if mfus else None
        return out

    def to_dict(self) -> dict:
        return {"v": 1, "epochs": self.rows, "totals": self.totals()}

    def advise(self) -> list[str]:
        """Advisory knob suggestions from this ledger (see ``advise_rows``)."""
        return advise_rows(self.rows)

    # -- rendering -----------------------------------------------------------
    def format_table(self) -> str:
        """The root-only end-of-run table."""

        def fmt(v: Any, pct_of: float | None = None) -> str:
            if v is None:
                return "-"
            if pct_of:
                return f"{v:8.2f} ({v / pct_of * 100:4.1f}%)"
            return f"{v:8.2f}"

        lines = [
            "goodput ledger (seconds; productive = epoch - data_wait - ckpt - host_stall)",
            f"{'epoch':>6}{'epoch_s':>10}{'data_wait':>11}{'ckpt':>9}{'host_stall':>12}"
            f"{'productive':>12}{'goodput':>9}{'mfu':>7}",
        ]
        for r in self.rows:
            gp = f"{r['goodput'] * 100:7.1f}%" if r.get("goodput") is not None else "      -"
            mfu = f"{r['mfu'] * 100:5.1f}%" if r.get("mfu") is not None else "    -"
            lines.append(
                f"{r['epoch']:>6}{fmt(r['epoch_s']):>10}{fmt(r['data_wait_s']):>11}"
                f"{fmt(r['ckpt_s']):>9}{fmt(r['stall_s']):>12}{fmt(r['productive_s']):>12}"
                f"{gp:>9}{mfu:>7}"
            )
        t = self.totals()
        gp = f"{t['goodput_frac'] * 100:.1f}%" if t["goodput_frac"] is not None else "-"
        mfu = f"{t['mfu'] * 100:.1f}%" if t["mfu"] is not None else "-"
        lines.append(
            f"total: {t['wall_s']:.2f}s wall = {t['compile_s']:.2f} compile + "
            f"{t['data_wait_s']:.2f} data_wait + {t['ckpt_s']:.2f} ckpt + "
            f"{t['host_stall_s']:.2f} host_stall + {t['productive_s']:.2f} productive"
            f" | goodput {gp}, mfu {mfu}"
        )
        return "\n".join(lines)


def advise_rows(rows: list[dict]) -> list[str]:
    """Advisory-only tuning suggestions from ledger epoch rows: when
    ``data_wait_s`` exceeds 30% of an epoch's wall time, the input pipeline,
    not the device, is the bottleneck, and the advice names the knob: a disk
    reader's ``buffers=``/``read_ahead=`` when one fed the starved epochs
    (``misc/shard_reader``), else ``prefetch_depth()``/``host_prefetch()``;
    and packing when batches carry a pad mask (``misc/pad_fraction``). The
    wording is the reference's, so both packages advise alike. Nothing is
    changed automatically: the pipeline prints the lines at the end of a run."""
    starved = [
        r["epoch"]
        for r in rows
        if r.get("epoch_s") and (r.get("data_wait_s") or 0.0) > _ADVISE_DATA_WAIT_FRAC * r["epoch_s"]
    ]
    if not starved:
        return []
    worst = max(
        ((r.get("data_wait_s") or 0.0) / r["epoch_s"] for r in rows if r.get("epoch_s")),
        default=0.0,
    )
    epochs = ", ".join(str(e) for e in starved[:8]) + ("…" if len(starved) > 8 else "")
    shard_fed = any(r.get("shard_reader") for r in rows if r["epoch"] in starved)
    if shard_fed:
        advice = [
            f"data_wait exceeded {_ADVISE_DATA_WAIT_FRAC:.0%} of epoch time in "
            f"epoch(s) {epochs} (worst {worst:.0%}) with a disk ShardReader "
            "feeding the run: the reader is the starved stage — raise its "
            "buffers= (blocks in flight) and/or read_ahead= (records per "
            "block) so cold-disk page faults stay ahead of the step "
            "(doc/data.md, On-disk shard format)"
        ]
    else:
        advice = [
            f"data_wait exceeded {_ADVISE_DATA_WAIT_FRAC:.0%} of epoch time in "
            f"epoch(s) {epochs} (worst {worst:.0%}): the input pipeline is "
            "starving the device — raise the pipeline's prefetch(n) / the stage's "
            "prefetch_depth(), or enable host_prefetch() to move batch prep off "
            "the training thread (doc/performance.md §3)"
        ]
    pads = [r["pad_fraction"] for r in rows if r.get("pad_fraction") is not None]
    if pads and max(pads) > _ADVISE_PAD_FRAC:
        advice.append(
            f"batches carry a pad mask and {max(pads):.0%} of token slots are "
            "padding: enable DataPipeline.pack_stream(seq_len) to pack "
            "documents into full rows — the data pipeline moves (and the "
            "device computes) only real tokens (doc/data.md)"
        )
    return advice


def ledger_from_tracker(tracker) -> GoodputLedger:
    """Build the ledger from the (already cross-host-reduced) tracker
    histories. Epochs that never tracked the telemetry metrics (telemetry
    armed mid-run, resumed histories) get None buckets, not zeros."""
    n_epochs = 0
    for name in _EPOCH_METRICS:
        if name in tracker:
            n_epochs = max(n_epochs, len(tracker[name]))
    rows: list[dict] = []
    for i in range(n_epochs):
        epoch_s = _get(tracker, "misc/epoch_time", i)
        data_wait_ms = _get(tracker, "misc/data_wait_ms", i)
        ckpt_ms = _get(tracker, "misc/ckpt_ms", i)
        stall_ms = _get(tracker, "misc/host_stall_ms", i)
        row: dict[str, Any] = {
            "epoch": i + 1,
            "epoch_s": round(epoch_s, 6) if epoch_s is not None else None,
            "data_wait_s": round(data_wait_ms / 1e3, 6) if data_wait_ms is not None else None,
            "ckpt_s": round(ckpt_ms / 1e3, 6) if ckpt_ms is not None else None,
            "goodput": _get(tracker, "misc/goodput", i),
            "mfu": _get(tracker, "misc/mfu", i),
            "pad_fraction": _get(tracker, "misc/pad_fraction", i),
            "shard_reader": _get(tracker, "misc/shard_reader", i),
        }
        # host_stall bucket excludes the checkpoint share (disjoint buckets)
        if stall_ms is not None:
            row["stall_s"] = round(max(stall_ms - (ckpt_ms or 0.0), 0.0) / 1e3, 6)
        else:
            row["stall_s"] = None
        if epoch_s is not None:
            used = (row["data_wait_s"] or 0.0) + (row["ckpt_s"] or 0.0) + (row["stall_s"] or 0.0)
            row["productive_s"] = round(max(epoch_s - used, 0.0), 6)
        else:
            row["productive_s"] = None
        rows.append(row)
    compile_ms = 0.0
    if "misc/compile_ms" in tracker:
        compile_ms = sum(v for v in tracker["misc/compile_ms"] if v is not None)
    return GoodputLedger(rows, compile_s=compile_ms / 1e3)


def flops_from_compiled(compiled: Any, n_devices: int = 1) -> float | None:
    """Whole-run FLOPs of one step from a precompiled signature's count
    (``compile.aot.CompiledSignature.flops``: ``FlopCounterMode`` over one
    call of the step during precompile), or None when nothing was counted.
    The count covers one process's step; under data parallelism every device
    runs it, hence ``* n_devices``. Like XLA's cost analysis of the
    reference's Pallas calls, it has no formula for the flash kernels' custom
    ops, which therefore count 0."""
    flops = getattr(compiled, "flops", None)
    if flops is None or not flops > 0:  # NaN/None/0 all mean "not counted"
        return None
    return float(flops) * int(n_devices)
