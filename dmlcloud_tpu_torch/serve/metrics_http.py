"""Optional stdlib ``/metrics`` HTTP endpoint for the serve registry.

Counterpart of ``dmlcloud_tpu/serve/metrics_http.py`` (``MetricsServer``),
whole. It wraps ``http.server.ThreadingHTTPServer`` in a daemon thread and
answers ``GET /metrics`` with the Prometheus text the ``source`` callable
returns, e.g. ``engine.metrics_text``::

    with MetricsServer(engine.metrics_text) as srv:
        ...  # scrape http://127.0.0.1:{srv.port}/metrics

``port=0`` (the default) binds an ephemeral port on ``127.0.0.1``. The handler
never raises into the serving process: a ``source`` failure answers 500 with
the error text. The engine never imports this module; ``metrics_text()``
works without any server.
"""

from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable

__all__ = ["MetricsServer"]

#: the content type Prometheus scrapers expect from a text-format page
CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class MetricsServer:
    """Serve ``source()`` (Prometheus text) at ``/metrics`` (module
    docstring). ``start()`` is idempotent; ``close()`` shuts the
    listener down and joins the thread."""

    def __init__(self, source: Callable[[], str], host: str = "127.0.0.1",
                 port: int = 0):
        self.source = source
        self.host = host
        self._requested_port = int(port)
        self._server: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None

    @property
    def port(self) -> int:
        """The bound port (the ephemeral one when constructed with 0)."""
        if self._server is None:
            raise RuntimeError("MetricsServer is not running (call start())")
        return self._server.server_address[1]

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/metrics"

    def start(self) -> "MetricsServer":
        if self._server is not None:
            return self
        source = self.source

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 — stdlib handler API
                if self.path.split("?", 1)[0] != "/metrics":
                    self.send_error(404, "only /metrics lives here")
                    return
                try:
                    body = source().encode("utf-8")
                    status, ctype = 200, CONTENT_TYPE
                except Exception as exc:  # noqa: BLE001 — never kill serving
                    body = f"metrics source failed: {exc}\n".encode("utf-8")
                    status, ctype = 500, "text/plain; charset=utf-8"
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # silence per-request stderr spam
                pass

        self._server = ThreadingHTTPServer((self.host, self._requested_port), _Handler)
        self._server.daemon_threads = True
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="dml-metrics-http", daemon=True
        )
        self._thread.start()
        return self

    def close(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def __enter__(self) -> "MetricsServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()
