"""Asyncio serving front end: sustained concurrency without thread-per-request.

A copy of ``aggregathor_tpu/serve/frontend.py`` (the module imports no
JAX).  The front end is ONE event-loop thread: a minimal asyncio HTTP/1.1
server parses requests, submits rows to the continuous scheduler
(``serve/continuous.py``) without blocking, and awaits each ticket through
a completion callback bridged onto the loop, so an in-flight request costs
a parked coroutine, not a thread.  All compute happens on the scheduler's
dispatch lanes; the loop thread only parses and serializes JSON.

The response contract:

- ``POST /predict``  -> 200 with predictions, disagreement, bucket,
  ``weights_step`` and ``active_replicas``; **400** malformed input; **429**
  + ``{"error": "shed"}`` on an explicit :class:`~.continuous.LoadShed`;
  **504** when the batch misses ``request_timeout_s`` (the ticket is
  CANCELLED: lanes never run dead work); **500** on an engine failure (the
  server survives).
- ``GET /healthz``   liveness + replica/custody summary.
- ``GET /metrics``   Prometheus text exposition of the ONE process-wide
  registry (``obs/metrics.py``), like the training exporter's; the JSON
  gauge snapshot is reachable via the EXPLICIT ``?format=json``.
- ``GET /status``    the serving twin of the live trainer exporter's
  ``/status`` (``obs/live.py``): weights step, active replicas, lanes,
  queue/in-flight plus the pressure fields a fleet router routes on (queue
  bound, per-scrape shed delta, at-ceiling, draining).

:class:`InferenceServer` is the composite the CLI and tests drive: engine +
continuous scheduler + this front end + the registry instruments
(``serve_background`` / ``shutdown_all``).
"""

import asyncio
import json
import threading
import urllib.parse

import numpy as np

from ..obs.perf import LatencyHistogram
from ..obs import events as obs_events
from ..obs import metrics as obs_metrics
from ..obs import trace
from ..utils import UserException, info
from .continuous import ContinuousBatcher, LoadShed

_REASONS = {
    200: "OK", 400: "Bad Request", 404: "Not Found",
    429: "Too Many Requests", 500: "Internal Server Error",
    504: "Gateway Timeout",
}

#: request bodies above this are refused outright (a ladder-top batch of
#: any supported experiment serializes far below it)
MAX_BODY_BYTES = 64 * 1024 * 1024


def _jsonable(value):
    value = float(value)
    return value if np.isfinite(value) else None  # strict JSON: inf/NaN -> null


class InferenceServer:
    """The serving process: asyncio front end + continuous scheduler + engine.

    ``port=0`` binds an ephemeral port (``serve_background`` returns the
    bound address).  ``summaries`` is an optional ``SummaryWriter``;
    ``flag_threshold`` marks a replica suspect when its latest disagreement
    exceeds it (non-finite scores are always suspect; retired replicas are
    reported as inactive, never suspect).  ``registry`` is the metrics
    registry to export through (default the process-wide
    ``obs.metrics.REGISTRY``); ``shutdown_all`` unregisters this server's
    serve_* instruments so a successor starts from fresh counts.

    ``lanes``/``max_lanes`` size the scheduler's dispatch-lane pool (the
    autoscaler's capacity range, ``serve/autoscale.py``); ``linger_s`` is
    the optional sub-top coalescing window (0 = pure continuous batching).
    """

    def __init__(self, engine, host="127.0.0.1", port=0, queue_bound=256,
                 lanes=1, max_lanes=None, linger_s=0.0, summaries=None,
                 request_timeout_s=60.0, flag_threshold=None, clock=None,
                 registry=None, custody_verified=None):
        import time

        self.engine = engine
        # Chain-of-custody verdict of the served checkpoints (cli/serve.py):
        # True = every replica's lineage manifest verified, False = at least
        # one unsigned/unverified restore was explicitly allowed through,
        # None = no --session-secret (verification not attempted).  Updated
        # on every hot swap (set_custody_verified), surfaced by /healthz.
        self.custody_verified = custody_verified
        self.clock = clock if clock is not None else time.monotonic
        self.summaries = summaries
        self.request_timeout_s = float(request_timeout_s)
        self.flag_threshold = flag_threshold
        self.registry = registry if registry is not None else obs_metrics.REGISTRY
        self._host, self._port = host, int(port)
        self._lock = threading.Lock()
        self._thread = None
        self._ready = None
        self._startup_error = None
        self._aio_loop = None
        self._aio_stop = None
        self._addr = None
        self._open_connections = 0
        self.shed_rows = 0
        self.draining = False
        self._status_shed_seen = 0
        self._last_disagreement = [0.0] * engine.nb_replicas
        self._metric_names = [
            "serve_request_latency_seconds", "serve_shed_requests_total",
            "serve_shed_rows_total", "serve_batches_total",
            "serve_served_rows_total", "serve_replica_disagreement",
            "serve_queue_rows", "serve_queue_bound", "serve_compile_count",
            "serve_batch_occupancy_fill", "serve_suspect_replica_count",
            "serve_dispatch_lanes", "serve_inflight_batches",
            "serve_active_replicas", "serve_weights_step",
            "serve_cancelled_requests_total", "serve_open_connections",
            "serve_request_timeouts_total",
        ]
        # Registry-backed instruments; ``latency`` keeps the LatencyHistogram
        # API (record/percentiles/count), so the JSON payload is unchanged.
        self.latency = self.registry.histogram(
            "serve_request_latency_seconds", "End-to-end /predict latency"
        )
        self._m_shed_requests = self.registry.counter(
            "serve_shed_requests_total", "Requests rejected by load-shedding (429)"
        )
        self._m_shed_rows = self.registry.counter(
            "serve_shed_rows_total", "Rows rejected by load-shedding"
        )
        self._m_batches = self.registry.counter(
            "serve_batches_total", "Batches dispatched by the scheduler"
        )
        self._m_served_rows = self.registry.counter(
            "serve_served_rows_total", "Rows served through dispatched batches"
        )
        self._m_timeouts = self.registry.counter(
            "serve_request_timeouts_total", "Requests that missed the request "
            "timeout (504; their queued rows were cancelled)"
        )
        self._m_disagreement = self.registry.gauge(
            "serve_replica_disagreement",
            "Latest per-replica disagreement score", labelnames=("replica",),
        )
        self.scheduler = ContinuousBatcher(
            engine.predict,
            buckets=engine.buckets,
            queue_bound=queue_bound,
            nb_lanes=lanes,
            max_lanes=max_lanes,
            linger_s=linger_s,
            on_batch=self._on_batch,
        )
        # Live views, read at scrape time (no writer loop to go stale).
        self.registry.gauge(
            "serve_queue_rows", "Rows queued awaiting dispatch"
        ).set_function(lambda: self.scheduler.queue_depth)
        self.registry.gauge(
            "serve_queue_bound", "Queued-row bound beyond which requests shed"
        ).set_function(lambda: self.scheduler.policy.queue_bound)
        self.registry.gauge(
            "serve_compile_count", "Bucket shapes run (one per bucket once warm)"
        ).set_function(lambda: self.engine.compile_count)
        self.registry.gauge(
            "serve_batch_occupancy_fill", "Row fill of the last dispatched batch"
        ).set_function(
            lambda: (self.scheduler.last_occupancy[0] / self.scheduler.last_occupancy[1])
            if self.scheduler.last_occupancy[1] else 0.0
        )
        self.registry.gauge(
            "serve_suspect_replica_count", "Replicas currently flagged suspect"
        ).set_function(lambda: len(self.suspect_replicas()))
        self.registry.gauge(
            "serve_dispatch_lanes", "Dispatch lanes (concurrent in-flight "
            "batches) — the autoscaled pool size"
        ).set_function(lambda: self.scheduler.nb_lanes)
        self.registry.gauge(
            "serve_inflight_batches", "Batches currently in flight on a lane"
        ).set_function(lambda: self.scheduler.in_flight)
        self.registry.gauge(
            "serve_active_replicas", "Replicas currently voting (pool scale)"
        ).set_function(lambda: len(self.engine.active_replicas))
        self.registry.gauge(
            "serve_weights_step", "Training step of the served weights "
            "(-1 when the checkpoint carried none)"
        ).set_function(
            lambda: -1 if self.engine.weights_step is None
            else self.engine.weights_step
        )
        self.registry.gauge(
            "serve_cancelled_requests_total", "Requests cancelled after a "
            "wait timeout (their queued rows were dropped)"
        ).set_function(lambda: self.scheduler.cancelled_count)
        self.registry.gauge(
            "serve_open_connections", "Open front-end connections"
        ).set_function(self._connections)

    def _connections(self):
        with self._lock:
            return self._open_connections

    # ------------------------------------------------------------------ #
    # request plumbing

    def parse_inputs(self, request):
        """``{"inputs": [...]}`` -> (k, *sample_shape) float32 rows.  Rows may
        arrive shaped or flattened; both forms are reshaped and validated
        against the experiment's sample shape."""
        inputs = request.get("inputs")
        if inputs is None:
            raise UserException('Request body wants {"inputs": [[...], ...]}')
        rows = np.asarray(inputs, np.float32)
        shape = self.engine.sample_shape
        if rows.ndim == 1:  # one flat sample
            rows = rows[None]
        if rows.ndim == 2 and rows.shape[1] == int(np.prod(shape)):
            rows = rows.reshape((rows.shape[0],) + shape)
        if rows.ndim == len(shape):  # one shaped sample
            rows = rows[None]
        if rows.ndim != len(shape) + 1 or tuple(rows.shape[1:]) != shape:
            raise UserException(
                "Input rows of shape %r do not match sample shape %r (flat %d also accepted)"
                % (tuple(rows.shape[1:]), shape, int(np.prod(shape)))
            )
        return rows

    def _on_batch(self, rows, requests, latency_s, output):
        disagreement = np.atleast_1d(np.asarray(output.get("disagreement", [])))
        self._m_batches.inc()
        self._m_served_rows.inc(int(rows))
        with self._lock:
            if disagreement.size == self.engine.nb_replicas:
                self._last_disagreement = [float(v) for v in disagreement]
                for index, score in enumerate(self._last_disagreement):
                    # retired replicas read NaN: freeze their gauge at 0
                    # rather than exporting a NaN sample
                    self._m_disagreement.labels(replica=str(index)).set(
                        0.0 if np.isnan(score)
                        else (score if np.isfinite(score) else float("inf"))
                    )
        if self.summaries is not None:
            self.summaries.event(self.scheduler.batch_count, "serve_batch", {
                "rows": int(rows),
                "requests": int(requests),
                "bucket": int(output.get("bucket", 0)),
                "batch_latency_ms": float(latency_s) * 1e3,
                "weights_step": output.get("weights_step"),
                "disagreement": [_jsonable(v) for v in disagreement],
            })

    def note_shed(self, rows, detail):
        self._m_shed_requests.inc()
        self._m_shed_rows.inc(int(rows))
        with self._lock:
            self.shed_rows += int(rows)
        if self.summaries is not None:
            self.summaries.event(self.scheduler.batch_count, "serve_shed", {
                "rows": int(rows),
                "queue_depth": self.scheduler.queue_depth,
                "detail": detail,
            })

    # ------------------------------------------------------------------ #
    # introspection payloads

    def last_disagreement(self):
        """Latest per-replica disagreement snapshot (NaN = retired) — the
        autoscaler's retire-most-suspect-first ordering reads it."""
        with self._lock:
            return list(self._last_disagreement)

    def suspect_replicas(self):
        """ACTIVE replica indices whose latest disagreement flags them:
        non-finite always; above ``flag_threshold`` when one is configured.
        Retired replicas (disagreement NaN) are inactive, not suspect."""
        with self._lock:
            scores = list(self._last_disagreement)
        suspects = []
        for index, score in enumerate(scores):
            if np.isnan(score):
                continue  # retired by the autoscaler: scaled out, not faulty
            if not np.isfinite(score):
                suspects.append(index)
            elif self.flag_threshold is not None and score > self.flag_threshold:
                suspects.append(index)
        return suspects

    def set_custody_verified(self, verdict):
        """Update the provenance verdict after a hot swap."""
        self.custody_verified = verdict

    def begin_drain(self):
        """Mark this process draining: ``/status`` reports it so the fleet
        router re-routes NEW traffic while in-flight (and any stragglers
        that race the scrape window) keep being served.  The caller
        (cli/serve.py's SIGTERM path) waits for quiescence and exits."""
        with self._lock:
            self.draining = True

    def is_quiescent(self):
        """True when nothing is queued or in flight — the drain exit gate."""
        return self.scheduler.queue_depth == 0 and self.scheduler.in_flight == 0

    def health_payload(self):
        return {
            "status": "ok",
            "replicas": self.engine.nb_replicas,
            "active_replicas": self.engine.active_replicas,
            "vote": type(self.engine.gar).__name__ if self.engine.gar else None,
            "buckets": list(self.engine.buckets),
            "suspect_replicas": self.suspect_replicas(),
            "custody_verified": self.custody_verified,
            "weights_step": self.engine.weights_step,
        }

    def status_payload(self):
        """The serving ``/status`` body — the live handles the smoke's
        swap/autoscale legs poll between requests, and the pressure
        surface the fleet router (``serve/router.py``) routes on.

        ``shed_delta`` is the number of shed REQUESTS since the previous
        ``/status`` read — per-scrape semantics for the one routing
        scraper (a second concurrent scraper would split the deltas; it
        should diff the cumulative ``shed_count`` instead).
        ``at_ceiling`` reads the capacity truth without requiring the
        autoscaler: the lane pool cannot grow further."""
        sheds = self.scheduler.shed_count
        with self._lock:
            shed_delta = sheds - self._status_shed_seen
            self._status_shed_seen = sheds
            draining = self.draining
        return {
            "weights_step": self.engine.weights_step,
            "active_replicas": self.engine.active_replicas,
            "lanes": self.scheduler.nb_lanes,
            "max_lanes": self.scheduler.max_lanes,
            "at_ceiling": self.scheduler.nb_lanes >= self.scheduler.max_lanes,
            "in_flight": self.scheduler.in_flight,
            "queue_depth": self.scheduler.queue_depth,
            "queue_bound": self.scheduler.policy.queue_bound,
            "shed_count": sheds,
            "shed_delta": shed_delta,
            "draining": draining,
            "batch_count": self.scheduler.batch_count,
            "compile_count": self.engine.compile_count,
            "custody_verified": self.custody_verified,
        }

    def metrics_payload(self):
        tail = self.latency.percentiles()
        occupancy_rows, occupancy_cap = self.scheduler.last_occupancy
        with self._lock:
            disagreement = [_jsonable(v) for v in self._last_disagreement]
            shed_rows = self.shed_rows
        return {
            "queue_depth": self.scheduler.queue_depth,
            "queue_bound": self.scheduler.policy.queue_bound,
            "batch_count": self.scheduler.batch_count,
            "served_rows": self.scheduler.served_rows,
            "shed_count": self.scheduler.shed_count,
            "shed_rows": shed_rows,
            "cancelled_count": self.scheduler.cancelled_count,
            "in_flight": self.scheduler.in_flight,
            "lanes": self.scheduler.nb_lanes,
            "max_lanes": self.scheduler.max_lanes,
            "active_replicas": self.engine.active_replicas,
            "weights_step": self.engine.weights_step,
            "batch_occupancy": {
                "rows": occupancy_rows, "cap": occupancy_cap,
                "fill": (occupancy_rows / occupancy_cap) if occupancy_cap else 0.0,
            },
            "latency_ms": {
                name: (tail[name] * 1e3 if tail else None)
                for name, _ in LatencyHistogram.POINTS
            },
            "request_count": self.latency.count,
            "per_replica_disagreement": disagreement,
            "suspect_replicas": self.suspect_replicas(),
            "compile_count": self.engine.compile_count,
            "nb_buckets": len(self.engine.buckets),
        }

    def prometheus_payload(self):
        """Text exposition of the whole registry (``/metrics?format=
        prometheus``) — training/serve metrics that share the process-wide
        registry scrape together."""
        return self.registry.render_prometheus()

    # ------------------------------------------------------------------ #
    # the asyncio front end

    async def _handle_predict(self, body):
        started = self.clock()
        try:
            request = json.loads(body or b"{}")
            if not isinstance(request, dict):
                raise UserException("Request body must be a JSON object")
            rows = self.parse_inputs(request)
        except (ValueError, TypeError, UserException) as exc:
            return 400, {"error": str(exc)}
        try:
            ticket = self.scheduler.submit(rows)
        except LoadShed as exc:
            self.note_shed(rows.shape[0], str(exc))
            return 429, {"error": "shed", "detail": str(exc)}
        except (ValueError, RuntimeError, UserException) as exc:
            return 400, {"error": str(exc)}
        loop = asyncio.get_running_loop()
        future = loop.create_future()

        def deliver(pending):
            # runs on the completing dispatch lane: hop onto the loop; the
            # future may already be gone (request timed out and cancelled)
            def resolve():
                if future.done():
                    return
                if pending.error is not None:
                    future.set_exception(pending.error)
                else:
                    future.set_result(pending.result)
            try:
                loop.call_soon_threadsafe(resolve)
            except RuntimeError:
                pass  # loop already shut down: nobody is waiting

        ticket.add_done_callback(deliver)
        try:
            result = await asyncio.wait_for(future, self.request_timeout_s)
        except (asyncio.TimeoutError, TimeoutError):
            ticket.cancel()
            self._m_timeouts.inc()
            return 504, {"error": "inference batch did not complete in time"}
        except Exception as exc:  # inference failure: surfaced, server lives
            return 500, {"error": str(exc)}
        self.latency.record(self.clock() - started)
        return 200, {
            "predictions": [int(p) for p in result["predictions"]],
            "disagreement": [_jsonable(v)
                             for v in np.atleast_1d(result["disagreement"])],
            "bucket": int(result["bucket"]),
            "weights_step": result.get("weights_step"),
            "active_replicas": result.get("active_replicas"),
        }

    def _wants_prometheus(self, query, headers):
        """Format negotiation: explicit ``?format=`` wins; otherwise the
        bare path serves Prometheus text — the SAME default as the
        training exporter (obs/live.py), so one scrape config covers both.
        An ``Accept`` header asking for JSON (and not text/plain) still
        negotiates the JSON snapshot.  (The historical bare-path JSON
        default is retired; say ``?format=json`` explicitly.)"""
        fmt = urllib.parse.parse_qs(query).get("format", [None])[0]
        if fmt is not None:
            if fmt not in ("json", "prometheus"):
                raise UserException(
                    "unknown metrics format %r (json or prometheus)" % fmt
                )
            return fmt == "prometheus"
        accept = headers.get("accept", "")
        return not ("application/json" in accept and "text/plain" not in accept)

    async def _route(self, method, target, headers, body):
        """-> (code, content_type, body_str)."""
        parsed = urllib.parse.urlsplit(target)
        if method == "POST" and parsed.path == "/predict":
            trace.instant("serve.request", cat="serve", bytes=len(body))
            code, payload = await self._handle_predict(body)
            # the causal-plane echo (docs/observability.md): a valid
            # X-Causal-Id token (the router's journal-event reference)
            # rides back in the response, so the caller can join this
            # answer to the routing decision that produced it; a garbled
            # token is dropped, never a request failure
            token = headers.get("x-causal-id")
            if token is not None and isinstance(payload, dict):
                try:
                    obs_events.parse_cause(token)
                except ValueError:
                    pass
                else:
                    payload = dict(payload, causal_id=token)
            return code, "application/json", json.dumps(payload)
        if method == "GET" and parsed.path == "/healthz":
            return 200, "application/json", json.dumps(self.health_payload())
        if method == "GET" and parsed.path == "/status":
            return 200, "application/json", json.dumps(self.status_payload())
        if method == "GET" and parsed.path == "/metrics":
            try:
                prometheus = self._wants_prometheus(parsed.query, headers)
            except UserException as exc:
                return 400, "application/json", json.dumps({"error": str(exc)})
            if prometheus:
                return (200, obs_metrics.PROMETHEUS_CONTENT_TYPE,
                        self.prometheus_payload())
            return 200, "application/json", json.dumps(self.metrics_payload())
        return 404, "application/json", json.dumps(
            {"error": "unknown path %r" % parsed.path}
        )

    async def _handle_client(self, reader, writer):
        with self._lock:
            self._open_connections += 1
        try:
            while True:
                line = await reader.readline()
                if not line:
                    return
                parts = line.decode("latin1").strip().split()
                if len(parts) != 3:
                    return  # not HTTP: drop the connection
                method, target, version = parts
                headers = {}
                while True:
                    header = await reader.readline()
                    if header in (b"\r\n", b"\n", b""):
                        break
                    name, _, value = header.decode("latin1").partition(":")
                    headers[name.strip().lower()] = value.strip()
                # Drain the body FIRST, before any reply: under keep-alive
                # an unread body would be parsed as the next request line.
                try:
                    length = int(headers.get("content-length", "0") or 0)
                except ValueError:
                    return
                refused_body = length < 0 or length > MAX_BODY_BYTES
                if refused_body:
                    code, ctype, payload = 400, "application/json", json.dumps(
                        {"error": "unacceptable Content-Length %d" % length}
                    )
                else:
                    body = await reader.readexactly(length) if length else b""
                    code, ctype, payload = await self._route(
                        method, target, headers, body
                    )
                # a refused body was never drained: the connection MUST
                # close, or its bytes would be parsed as the next request
                keep = (version == "HTTP/1.1"
                        and headers.get("connection", "").lower() != "close"
                        and not refused_body)
                payload = payload.encode()
                writer.write((
                    "HTTP/1.1 %d %s\r\n"
                    "Content-Type: %s\r\n"
                    "Content-Length: %d\r\n"
                    "Connection: %s\r\n\r\n"
                    % (code, _REASONS.get(code, "OK"), ctype, len(payload),
                       "keep-alive" if keep else "close")
                ).encode("latin1"))
                writer.write(payload)
                await writer.drain()
                if not keep:
                    return
        except (asyncio.IncompleteReadError, ConnectionError):
            return  # client went away mid-request
        finally:
            with self._lock:
                self._open_connections -= 1
            writer.close()

    async def _serve_main(self):
        server = await asyncio.start_server(
            self._handle_client, self._host, self._port
        )
        with self._lock:
            self._aio_loop = asyncio.get_running_loop()
            self._aio_stop = asyncio.Event()
            self._addr = server.sockets[0].getsockname()[:2]
            stop = self._aio_stop
        self._ready.set()
        async with server:
            await stop.wait()

    def _loop_main(self):
        try:
            asyncio.run(self._serve_main())
        except Exception as exc:
            with self._lock:
                self._startup_error = exc
            self._ready.set()

    # ------------------------------------------------------------------ #
    # lifecycle

    def serve_background(self):
        """Start the event-loop thread; returns the bound (host, port)."""
        with self._lock:
            if self._thread is not None:
                return self._addr
            self._ready = threading.Event()
            self._thread = threading.Thread(
                target=self._loop_main, daemon=True, name="serve-frontend"
            )
            thread = self._thread
        thread.start()
        if not self._ready.wait(30.0):
            raise UserException("serve front end failed to start in 30 s")
        with self._lock:
            error, addr = self._startup_error, self._addr
        if error is not None:
            raise error
        host, port = addr
        info("Serving on http://%s:%d (replicas=%d, vote=%s, buckets=%r, "
             "lanes=%d/%d)"
             % (host, port, self.engine.nb_replicas,
                type(self.engine.gar).__name__ if self.engine.gar else "none",
                list(self.engine.buckets), self.scheduler.nb_lanes,
                self.scheduler.max_lanes))
        return host, port

    @property
    def server_address(self):
        """(host, port) once ``serve_background`` returned."""
        with self._lock:
            return self._addr if self._addr else (self._host, self._port)

    def shutdown_all(self):
        """Stop the event loop and the scheduler (idempotent), and
        unregister this server's serve_* instruments so a successor starts
        fresh and the gauge closures no longer keep the engine alive."""
        with self._lock:
            loop, stop = self._aio_loop, self._aio_stop
            thread, self._thread = self._thread, None
            self._aio_loop = self._aio_stop = None
        if loop is not None and stop is not None:
            try:
                loop.call_soon_threadsafe(stop.set)
            except RuntimeError:
                pass  # loop already gone
        if thread is not None:
            thread.join(5.0)
        self.scheduler.close()
        for name in self._metric_names:
            self.registry.unregister(name)
