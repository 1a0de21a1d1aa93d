"""Live trainer exporter: an in-process HTTP metrics/status endpoint.

A copy of ``aggregathor_tpu/obs/live.py`` (the module imports no JAX).
``LiveExporter`` is the smallest possible server (the stdlib
``ThreadingHTTPServer``), a daemon thread answering

- ``GET /metrics``: Prometheus text exposition of the process-wide
  registry (``?format=json`` returns the JSON snapshot instead);
- ``GET /status``: a small JSON document from the runner's status
  provider: run id, step progress, steps/s and the most recent
  flight-recorder window (obs/flight.py);
- ``GET /healthz``: liveness.

The handler threads only render text from the registry (scrape-time gauge
callbacks included); they never touch the training loop, the engine or a
tensor on the card, so scraping a live run costs a GIL slice, not a step.
``port=0`` binds an ephemeral port; ``--live-ready-file`` (cli/runner.py)
publishes ``host port`` for scripts.
"""

import json
import threading
import time
import urllib.parse

from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from . import metrics as obs_metrics
from ..utils import info


class _Handler(BaseHTTPRequestHandler):
    server_version = "aggregathor-live/1"
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # scrapes must not spam stderr
        pass

    def _reply(self, code, body, content_type):
        body = body.encode() if isinstance(body, str) else body
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _reply_json(self, code, payload):
        self._reply(code, json.dumps(payload), "application/json")

    def do_GET(self):
        parsed = urllib.parse.urlsplit(self.path)
        server = self.server
        if parsed.path == "/metrics":
            server.note_scrape("metrics")
            fmt = urllib.parse.parse_qs(parsed.query).get("format", [None])[0]
            if fmt == "json":
                self._reply_json(200, server.registry.snapshot())
            elif fmt in (None, "prometheus"):
                self._reply(200, server.registry.render_prometheus(),
                            obs_metrics.PROMETHEUS_CONTENT_TYPE)
            else:
                self._reply_json(
                    400, {"error": "unknown metrics format %r" % fmt})
        elif parsed.path == "/status":
            server.note_scrape("status")
            self._reply_json(200, server.status_payload())
        elif parsed.path == "/healthz":
            server.note_scrape("healthz")
            self._reply_json(200, {"status": "ok", "run_id": server.run_id})
        else:
            self._reply_json(404, {"error": "unknown path %r" % self.path})


class LiveExporter(ThreadingHTTPServer):
    """The training run's scrape endpoint.

    Args:
      registry: the metrics registry to expose (default the process-wide
        ``obs.metrics.REGISTRY``).
      status_provider: zero-arg callable returning the JSON-able ``/status``
        body (the runner closes over its loop state); exceptions degrade to
        an ``{"error": ...}`` payload instead of killing the scrape.
      run_id: stamped on ``/healthz`` and ``/status``.
      port: 0 binds an ephemeral port (read ``server_address[1]``).
    """

    daemon_threads = True

    def __init__(self, registry=None, status_provider=None, run_id=None,
                 host="127.0.0.1", port=0):
        super().__init__((host, int(port)), _Handler)
        self.registry = registry if registry is not None else obs_metrics.REGISTRY
        self.status_provider = status_provider
        self.run_id = run_id
        self.started_at = time.time()
        self._scrapes = self.registry.counter(
            "live_scrapes_total", "Live-exporter requests served",
            labelnames=("endpoint",),
        )
        self._serve_thread = None

    def note_scrape(self, endpoint):
        self._scrapes.labels(endpoint=endpoint).inc()

    def status_payload(self):
        payload = {"run_id": self.run_id, "uptime_s": time.time() - self.started_at}
        if self.status_provider is not None:
            try:
                payload.update(self.status_provider() or {})
            except Exception as exc:  # a scrape must never kill the run
                payload["error"] = str(exc)
        return payload

    def serve_background(self):
        """Run ``serve_forever`` on a daemon thread; returns (host, port)."""
        self._serve_thread = threading.Thread(
            target=self.serve_forever, daemon=True, name="live-exporter"
        )
        self._serve_thread.start()
        host, port = self.server_address[:2]
        info("Live trainer exporter on http://%s:%d (/metrics, /status)"
             % (host, port))
        return host, port

    def shutdown_all(self):
        """Stop the HTTP loop (idempotent) and unregister the scrape
        counter so a successor exporter starts fresh."""
        self.shutdown()
        self.server_close()
        if self._serve_thread is not None:
            self._serve_thread.join(5.0)
            self._serve_thread = None
        self.registry.unregister("live_scrapes_total")
