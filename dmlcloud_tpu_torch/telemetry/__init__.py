"""Flight recorder and goodput telemetry.

Counterpart of ``dmlcloud_tpu/telemetry/``, armed by
``TrainingPipeline(telemetry=True|dir|{...})``:

- **Span journal** (``journal.py``): a per-process JSONL journal of typed spans
  (``run``, ``stage``, ``epoch``, ``step_dispatch``, ``data_wait``, ``h2d``,
  ``metric_readback``, ``checkpoint``, ``barrier``, ...) in the reference's
  schema v1, kept in an in-memory ring and flushed off-thread;
  ``to_chrome_trace`` turns the merged journals into Perfetto/Chrome-trace JSON.
- **Goodput ledger** (``goodput.py``): each epoch's wall time split into
  data-wait, checkpoint, host-stall and productive buckets (``misc/goodput``,
  ``misc/mfu``), with a root-only end-of-run table and ``goodput.json``.
- **Hang watchdog** (``watchdog.py``): when span progress stops, or on an
  uncaught exception, a dump of all thread stacks, the last spans and the
  barrier state to ``forensics/rank<k>.json``, and a ``"hang"`` requeue verdict.

Everything here is stdlib only.
"""

from . import goodput, journal, watchdog
from .goodput import GoodputLedger, ledger_from_tracker
from .journal import SCHEMA_VERSION, SPAN_KINDS, SpanJournal, active_journal, load_journals, span, to_chrome_trace
from .watchdog import HangWatchdog

__all__ = [
    "goodput",
    "journal",
    "watchdog",
    "GoodputLedger",
    "ledger_from_tracker",
    "SCHEMA_VERSION",
    "SPAN_KINDS",
    "SpanJournal",
    "active_journal",
    "load_journals",
    "span",
    "to_chrome_trace",
    "HangWatchdog",
]
