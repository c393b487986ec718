"""Per-request latency ledger: TTFT, per-token pace, queue depth.

Counterpart of ``dmlcloud_tpu/serve/ledger.py`` (``ServeLedger``), whole and
host-only: every counter and ``summary()`` key of the reference, so the two
packages' summaries are equal for the same events. The engine records, per
request: arrival -> admission (queue wait), admission -> first emitted token,
token count, terminal status and completion, on the engine's clock.
``summary()`` reduces them to p50/p99 TTFT, mean queue wait, served tokens/s
over the busy window, goodput (tokens of ``ok`` requests only), the terminal
status census and the queue-depth profile sampled once per decode step.

**Bounded retention.** ``max_records`` caps the per-request detail dict
(``records``): once a request is terminal it becomes evictable, and the oldest
terminal records are dropped FIFO beyond the cap; live requests are never
evicted. Eviction folds each record into running aggregates first, so every
count, sum and rate in ``summary()`` stays exact over the full history; only
the TTFT/queue-wait percentiles narrow to a window of the latest ``_WINDOW``
samples. Unbounded by default (``max_records=None``).

Prefix sharing adds, per request, the tokens the radix tree matched at
admission (``cached_tokens``), the prefill tokens the skip saved
(``saved_tokens``) and the prompt length; speculative and Medusa serving add
the tokens proposed (``drafted``) and accepted (``accepted``) per round, which
arrive in the same device-to-host copy as the round's tokens.
"""

from __future__ import annotations

import collections

import numpy as np

__all__ = ["ServeLedger"]

#: sliding-window size for the TTFT / queue-wait percentiles once
#: retention is bounded (counts and sums stay exact regardless)
_WINDOW = 4096


def _pct(values, q):
    if not values:
        return None
    return float(np.percentile(np.asarray(values, np.float64), q))


class ServeLedger:
    """Accumulates per-request timing records and step-level samples.
    ``max_records`` bounds the retained per-request detail (module
    docstring); None retains everything."""

    def __init__(self, max_records: int | None = None):
        if max_records is not None and max_records < 1:
            raise ValueError(f"max_records must be >= 1, got {max_records}")
        self.max_records = max_records
        self.records: dict[int, dict] = {}
        self.decode_steps = 0
        # terminal rids in finish order — the FIFO eviction queue
        self._evictable: collections.deque[int] = collections.deque()
        # running aggregates: per-step samples (never per-step lists) and
        # the exact sums/counts of every evicted record
        self._max_queue_depth = 0
        self._batch_size_sum = 0
        self._status_counts: dict[str, int] = {}
        window = None if max_records is None else _WINDOW
        self._window = window
        self._ttfts: collections.deque[float] = collections.deque(maxlen=window)
        self._waits: collections.deque[float] = collections.deque(maxlen=window)
        # per-tenant TTFT windows: same event-time windowing as _ttfts, so
        # the per-tenant percentiles in summary() survive record eviction
        # (the fairness observable)
        self._tenant_ttfts: dict[str, collections.deque] = {}
        self._agg = {
            "requests": 0, "completed": 0, "tokens": 0, "ok_tokens": 0,
            "drafted": 0, "accepted": 0, "rate_sum": 0.0, "rate_n": 0,
            "pref_n": 0, "pref_hits": 0, "prompt_tokens": 0,
            "cached_tokens": 0, "saved_tokens": 0,
            "first_arrival": None, "last_finish": None, "wait_sum": 0.0,
            "wait_n": 0,
        }

    # -- per-request events --------------------------------------------------
    def arrived(self, rid: int, now: float, tenant: str | None = None) -> None:
        rec = {"arrival": now, "tokens": 0, "drafted": 0, "accepted": 0}
        if tenant is not None:
            rec["tenant"] = tenant
        self.records[rid] = rec

    def admitted(self, rid: int, now: float) -> None:
        rec = self.records[rid]
        rec["admitted"] = now
        self._waits.append(now - rec["arrival"])
        self._agg["wait_sum"] += now - rec["arrival"]
        self._agg["wait_n"] += 1

    def first_token(self, rid: int, now: float) -> None:
        rec = self.records[rid]
        rec["first_token"] = now
        self._ttfts.append(now - rec["arrival"])
        tenant = rec.get("tenant")
        if tenant is not None:
            dq = self._tenant_ttfts.get(tenant)
            if dq is None:
                dq = self._tenant_ttfts[tenant] = collections.deque(
                    maxlen=self._window
                )
            dq.append(now - rec["arrival"])

    def token(self, rid: int) -> None:
        self.records[rid]["tokens"] += 1

    def finished(self, rid: int, now: float, status: str = "ok") -> None:
        """Terminal event — ONCE per request, with its terminal status
        (``ok | cancelled | deadline_exceeded | shed | error``). Beyond
        ``max_records`` the oldest TERMINAL record folds into the exact
        aggregates and its detail drops (FIFO)."""
        rec = self.records.get(rid)
        if rec is not None:
            rec["finished"] = now
            rec["status"] = status
        self._status_counts[status] = self._status_counts.get(status, 0) + 1
        last = self._agg["last_finish"]
        self._agg["last_finish"] = now if last is None else max(last, now)
        self._evictable.append(rid)
        if self.max_records is not None:
            while len(self.records) > self.max_records and self._evictable:
                self._evict(self._evictable.popleft())

    def _evict(self, rid: int) -> None:
        """Fold one terminal record into the aggregates and drop it."""
        rec = self.records.pop(rid, None)
        if rec is None:
            return
        agg = self._agg
        agg["requests"] += 1
        agg["tokens"] += rec["tokens"]
        if rec.get("status", "ok") == "ok":
            agg["ok_tokens"] += rec["tokens"]
        if "finished" in rec:
            agg["completed"] += 1
        first = agg["first_arrival"]
        agg["first_arrival"] = (
            rec["arrival"] if first is None else min(first, rec["arrival"])
        )
        agg["drafted"] += rec["drafted"]
        agg["accepted"] += rec["accepted"]
        if rec["drafted"]:
            agg["rate_sum"] += rec["accepted"] / rec["drafted"]
            agg["rate_n"] += 1
        if "prompt_tokens" in rec:
            agg["pref_n"] += 1
            agg["pref_hits"] += 1 if rec["cached_tokens"] > 0 else 0
            agg["prompt_tokens"] += rec["prompt_tokens"]
            agg["cached_tokens"] += rec["cached_tokens"]
            agg["saved_tokens"] += rec["saved_tokens"]

    def prefix_match(self, rid: int, cached: int, saved: int, prompt: int) -> None:
        """The request's prefix-cache outcome at admission: ``cached``
        tokens matched in the radix tree, ``saved`` prefill tokens
        actually skipped (the divergence point — ``cached`` minus the one
        re-fed token of an exact full-block match), out of ``prompt``
        prompt tokens. Host bookkeeping only; the tree itself never
        appears on device."""
        rec = self.records[rid]
        rec["cached_tokens"] = int(cached)
        rec["saved_tokens"] = int(saved)
        rec["prompt_tokens"] = int(prompt)

    def spec_round(self, rid: int, drafted: int, accepted: int) -> None:
        """One speculative verification round's counters for a request.
        The counts arrive packed in the SAME device fetch as the round's
        tokens (serve/engine.py) — this is pure host accounting, never an
        extra readback."""
        rec = self.records[rid]
        rec["drafted"] += int(drafted)
        rec["accepted"] += int(accepted)

    def accept_rate(self, rid: int) -> float | None:
        """The request's measured draft accept rate
        (``accepted / drafted``); None before any verification round."""
        rec = self.records[rid]
        return rec["accepted"] / rec["drafted"] if rec["drafted"] else None

    def status_counts(self) -> dict[str, int]:
        """Terminal status census over the FULL history (exact across
        eviction)."""
        return dict(self._status_counts)

    # -- per-step samples ----------------------------------------------------
    def step_sample(self, queue_depth: int, batch_size: int) -> None:
        self.decode_steps += 1
        self._max_queue_depth = max(self._max_queue_depth, int(queue_depth))
        self._batch_size_sum += int(batch_size)

    # -- reduction -----------------------------------------------------------
    def ttfts(self, tenant: str | None = None) -> list[float]:
        """TTFT samples from the RETAINED records (optionally one
        tenant's); the summary percentiles use the wider event-time
        window, which survives eviction."""
        return [
            r["first_token"] - r["arrival"]
            for r in self.records.values()
            if "first_token" in r and (tenant is None or r.get("tenant") == tenant)
        ]

    def summary(self) -> dict:
        """The serving scorecard. ``tokens_per_sec`` covers the busy window
        (first arrival -> last completion) — the end-to-end number a trace
        replay compares, queueing included; ``goodput_tokens_per_sec``
        counts only ``ok`` requests' tokens over the same window (shed /
        errored / expired work is throughput, never goodput). Counts and
        sums are exact over the full history regardless of eviction."""
        agg = self._agg
        live = list(self.records.values())
        done = [r for r in live if "finished" in r]
        total_tokens = agg["tokens"] + sum(r["tokens"] for r in live)
        ok_tokens = agg["ok_tokens"] + sum(
            r["tokens"] for r in live if r.get("status", None) == "ok"
        )
        arrivals = [r["arrival"] for r in live]
        if agg["first_arrival"] is not None:
            arrivals.append(agg["first_arrival"])
        finishes = [r["finished"] for r in done]
        if agg["last_finish"] is not None:
            finishes.append(agg["last_finish"])
        span = None
        if arrivals and finishes:
            span = max(max(finishes) - min(arrivals), 1e-9)
        # prefix-cache observables (None on an engine without the cache):
        # hit rate over admitted requests, fraction of prompt tokens served
        # from cache, and the prefill tokens the skip actually saved
        pref = [r for r in live if "prompt_tokens" in r]
        pref_n = agg["pref_n"] + len(pref)
        pref_hits = agg["pref_hits"] + sum(1 for r in pref if r["cached_tokens"] > 0)
        prompt_tok = agg["prompt_tokens"] + sum(r["prompt_tokens"] for r in pref)
        cached_tok = agg["cached_tokens"] + sum(r["cached_tokens"] for r in pref)
        saved_tok = agg["saved_tokens"] + sum(r["saved_tokens"] for r in pref)
        drafted = agg["drafted"] + sum(r["drafted"] for r in live)
        accepted = agg["accepted"] + sum(r["accepted"] for r in live)
        rates = [r["accepted"] / r["drafted"] for r in live if r["drafted"]]
        rate_sum = agg["rate_sum"] + sum(rates)
        rate_n = agg["rate_n"] + len(rates)
        waits_mean = (
            agg["wait_sum"] / agg["wait_n"] if agg["wait_n"] else None
        )
        ttft = list(self._ttfts)
        statuses = self.status_counts()
        # the live SLO scorecard when an engine attached its monitor
        # (ServeEngine(slos=...) sets ledger.slo_monitor): declared
        # objectives judged over their sliding windows, alert count
        slo = getattr(self, "slo_monitor", None)
        slo_section = {} if slo is None else {"slo": slo.status()}
        return {
            **slo_section,
            "requests": agg["requests"] + len(self.records),
            "completed": agg["completed"] + len(done),
            "statuses": statuses,
            "total_tokens": total_tokens,
            "tokens_per_sec": round(total_tokens / span, 1) if span else None,
            "goodput_tokens_per_sec": (
                round(ok_tokens / span, 1) if span else None
            ),
            "p50_ttft_s": _pct(ttft, 50),
            "p99_ttft_s": _pct(ttft, 99),
            # per-tenant TTFT percentiles over the same windowed samples
            # (what ttfts(tenant=) gives, but eviction-proof): the fairness
            # observable
            "tenant_ttft": {
                tenant: {
                    "n": len(dq),
                    "p50_s": _pct(list(dq), 50),
                    "p99_s": _pct(list(dq), 99),
                }
                for tenant, dq in sorted(self._tenant_ttfts.items())
            },
            "mean_queue_wait_s": waits_mean,
            "max_queue_depth": self._max_queue_depth,
            "mean_batch_size": (
                self._batch_size_sum / self.decode_steps
                if self.decode_steps else None
            ),
            "decode_steps": self.decode_steps,
            # speculative-decode counters (zero / None on a plain engine):
            # totals across requests plus the per-request mean — the
            # scorecard's accept-rate observable
            # prefix-cache scorecard (None without prefix_cache=True)
            "prefix_hit_rate": (
                round(pref_hits / pref_n, 4) if pref_n else None
            ),
            "cached_token_frac": (
                round(cached_tok / prompt_tok, 4) if prompt_tok else None
            ),
            "prefill_tokens_saved": saved_tok if pref_n else None,
            "prefill_tokens_saved_frac": (
                round(saved_tok / prompt_tok, 4) if prompt_tok else None
            ),
            "drafted_tokens": drafted,
            "accepted_tokens": accepted,
            "accept_rate": round(accepted / drafted, 4) if drafted else None,
            "mean_request_accept_rate": (
                round(rate_sum / rate_n, 4) if rate_n else None
            ),
        }
