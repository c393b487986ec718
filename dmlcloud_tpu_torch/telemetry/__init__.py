"""Flight recorder and goodput telemetry.

Counterpart of ``dmlcloud_tpu/telemetry/``, armed by
``TrainingPipeline(telemetry=True|dir|{...})``:

- **Span journal** (``journal.py``): a per-process JSONL journal of typed spans
  (``run``, ``stage``, ``epoch``, ``step_dispatch``, ``data_wait``, ``h2d``,
  ``metric_readback``, ``checkpoint``, ``barrier``, ...) in the reference's
  schema v1, kept in an in-memory ring and flushed off-thread;
  ``to_chrome_trace`` turns the merged journals into Perfetto/Chrome-trace JSON,
  ``to_request_trace``/``linked_trace_report`` lay the serving engine's spans
  out by request trace.
- **Goodput ledger** (``goodput.py``): each epoch's wall time split into
  data-wait, checkpoint, host-stall and productive buckets (``misc/goodput``,
  ``misc/mfu``), with a root-only end-of-run table and ``goodput.json``.
- **Hang watchdog** (``watchdog.py``): when span progress stops, or on an
  uncaught exception, a dump of all thread stacks, the last spans and the
  barrier state to ``forensics/rank<k>.json``, and a ``"hang"`` requeue verdict
  (``serve_guard``: a serving engine's drain).
- **Metrics registry** (``metrics_registry.py``): counters, gauges and
  histograms with bounded label families, snapshots and Prometheus text.

Everything here is stdlib only.
"""

from . import goodput, journal, metrics_registry, watchdog
from .goodput import GoodputLedger, flops_from_compiled, ledger_from_tracker
from .journal import (REQUEST_SPAN_KINDS, SCHEMA_VERSION, SPAN_KINDS, SpanJournal, active_journal, linked_trace_report,
                      load_journals, span, to_chrome_trace, to_request_trace)
from .metrics_registry import MetricsRegistry, parse_prometheus_text, to_prometheus_text
from .watchdog import HangWatchdog

__all__ = [
    "goodput",
    "journal",
    "metrics_registry",
    "watchdog",
    "GoodputLedger",
    "flops_from_compiled",
    "ledger_from_tracker",
    "REQUEST_SPAN_KINDS",
    "SCHEMA_VERSION",
    "SPAN_KINDS",
    "SpanJournal",
    "active_journal",
    "linked_trace_report",
    "load_journals",
    "span",
    "to_chrome_trace",
    "to_request_trace",
    "MetricsRegistry",
    "parse_prometheus_text",
    "to_prometheus_text",
    "HangWatchdog",
]
