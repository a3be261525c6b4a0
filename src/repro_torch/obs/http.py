"""Stdlib HTTP exposition: a live `/metrics` + `/traces` endpoint.

`python -m repro_torch.launch.serve --retrieval --metrics-port N` starts
one of these next to the serving loop.  Routes:

  * ``/metrics``       Prometheus text format 0.0.4 (scrape target)
  * ``/metrics.json``  the registry's JSON snapshot
  * ``/traces``        Chrome trace-event JSON of the span ring
    (download and load into https://ui.perfetto.dev)
  * ``/healthz``       health probe.  With a `health` callback wired
    (serve.py passes ``ServingEngine.health``) it returns the live
    health dict as JSON — state ok/degraded/overloaded, queue depth,
    live-device count — with HTTP 503 when overloaded so load
    balancers shed traffic; without a callback it stays the legacy
    liveness ``ok``.

The server runs on a daemon thread (`ThreadingHTTPServer`), so scrapes
never block serving; registry reads are dict scans over counters the
serving thread mutates — Python's GIL makes the torn-read risk a stale
sample at worst, which scraping already tolerates by design.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import NULL_TRACER

PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class ObsServer:
    """Serve one registry (+ optional tracer) over HTTP until `stop()`."""

    def __init__(self, registry: MetricsRegistry, tracer=None,
                 host: str = "127.0.0.1", port: int = 0, health=None):
        self.registry = registry
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.health = health  # () -> dict with a "state" key, or None
        self._httpd = ThreadingHTTPServer(
            (host, port), self._make_handler()
        )
        self._httpd.daemon_threads = True
        self._thread: threading.Thread | None = None

    @property
    def port(self) -> int:
        """Bound port (useful with port=0: the OS picks a free one)."""
        return self._httpd.server_address[1]

    def _make_handler(self):
        obs = self

        class Handler(BaseHTTPRequestHandler):
            def _send(self, body: str, content_type: str,
                      code: int = 200) -> None:
                data = body.encode("utf-8")
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):  # noqa: N802 (http.server API)
                path = self.path.split("?", 1)[0]
                if path == "/metrics":
                    self._send(
                        obs.registry.render_prometheus(),
                        PROMETHEUS_CONTENT_TYPE,
                    )
                elif path == "/metrics.json":
                    self._send(
                        obs.registry.render_json(), "application/json"
                    )
                elif path == "/traces":
                    self._send(
                        json.dumps(obs.tracer.export_chrome()),
                        "application/json",
                    )
                elif path == "/healthz":
                    if obs.health is None:
                        self._send("ok\n", "text/plain")
                    else:
                        h = obs.health()
                        code = 503 if h.get("state") == "overloaded" else 200
                        self._send(
                            json.dumps(h), "application/json", code=code
                        )
                else:
                    self.send_error(404, "unknown path (try /metrics)")

            def log_message(self, fmt, *args):  # silence per-request spam
                pass

        return Handler

    def start(self) -> int:
        """Start serving on a daemon thread; returns the bound port."""
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._httpd.serve_forever,
                name="obs-http",
                daemon=True,
            )
            self._thread.start()
        return self.port

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
