"""The traffic plane: fleet admission + routing in front of N serving
processes.

A copy of ``aggregathor_tpu/serve/router.py`` (the module imports no JAX).
A :class:`FleetRouter` fronts N independent ``cli/serve.py`` processes
(each following the same snapshot stream) and owns four guarantees:

1. **Routing is a pure policy.**  :class:`RoutingPolicy` is clockless,
   socketless math over immutable :class:`BackendView` snapshots:
   least-in-flight among eligible backends, where eligibility = up, not
   draining, has queue capacity, and (when the client carries a step pin)
   known to serve ``weights_step >= pin``.  Health and pressure come from
   the fleet scrape (an embedded :class:`~..obs.fleet.FleetCollector`
   polling each backend's ``/status`` + ``/metrics``) plus per-request
   outcomes, never from one process's registry.
2. **Fleet-consistent weights_step.**  The router tracks each backend's
   served step and pins a client's session to backends at >= its
   last-seen step, so no client ever observes ``weights_step`` go
   backwards across replicas; during a swap window where no backend has
   yet been seen at the pin, the router waits (bounded by
   ``step_wait_s``) rather than serve an inconsistent read.
3. **Shed is a fleet decision.**  HTTP 429 fires only when the whole
   fleet is saturated; a backend observed ``draining`` takes no NEW
   traffic while its in-flight requests finish.
4. **A mid-flight backend death drops nothing.**  A request whose
   forward dies on a transport error is re-dispatched onto a live backend
   EXACTLY once (``/predict`` is idempotent), and the dead backend is
   latched out of the routable pool at once.

Every router decision lands in the causal journal (``obs/events.py``):
``router_route``, ``router_shed``, ``router_retry``,
``router_backend_down`` / ``router_backend_up``, ``router_drain`` and
``router_step_pin``.  :class:`RouterServer` exports the router's own
``/metrics`` and ``/status``.

Run it: ``python -m aggregathor_tpu_torch.cli.router --backend a=HOST:PORT
--backend b=HOST:PORT --port 9200``.
"""

import collections
import json
import threading
import time
import urllib.error
import urllib.parse
import urllib.request

from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..obs import events as obs_events
from ..obs import metrics as obs_metrics
from ..obs.fleet import FleetCollector
from ..utils import UserException, info

#: the request header carrying the client/session identity the step pin
#: keys on; requests without it are routed (and counted) but not pinned
CLIENT_HEADER = "X-Client-Id"

#: the causal-plane header (docs/observability.md "The causal plane"):
#: a :func:`~..obs.events.format_cause` token naming the journal event
#: that caused this forward.  The router stamps its own latest event for
#: the dispatch (a caused ``router_route`` or a ``router_retry``) —
#: steady-state forwards pass an inbound client token through unchanged —
#: and backends echo the token into their ``/predict`` response, so a
#: postmortem can join the router's decision to the backend's answer.
CAUSAL_HEADER = "X-Causal-Id"

#: request bodies above this are refused outright (mirrors the front end)
MAX_BODY_BYTES = 64 * 1024 * 1024

BackendView = collections.namedtuple(
    "BackendView",
    ("name", "up", "draining", "in_flight", "queue_depth", "queue_bound",
     "at_ceiling", "known_step"),
)
BackendView.__doc__ = """One backend's immutable routing snapshot.

``in_flight`` is the ROUTER-side count (requests this router has
outstanding there — fresher than any scrape); ``queue_depth`` /
``queue_bound`` / ``at_ceiling`` come from the backend's ``/status``
pressure fields (``queue_bound`` None = unknown, treated as unbounded);
``known_step`` is the highest ``weights_step`` ever observed from this
backend (a lower bound on its live step, None until first observed)."""


class RoutingPolicy:
    """Pure routing/admission math over :class:`BackendView` rows.

    No clocks, no sockets, no mutable state — tests drive it on synthetic
    views.  Subclass and override :meth:`route` to
    change the discipline; the router only calls these three methods.
    """

    @staticmethod
    def has_capacity(view):
        """Up, not draining, and its queue is not at the shed bound."""
        if not view.up or view.draining:
            return False
        return view.queue_bound is None or view.queue_depth < view.queue_bound

    def admit(self, views):
        """The FLEET admission verdict: admit while any backend has
        capacity; refusing here is the only path to a router 429."""
        return any(self.has_capacity(view) for view in views)

    def eligible(self, view, pin):
        """Routable for THIS client: capacity plus the step pin — a
        pinned client only lands on backends known to serve >= its pin
        (``known_step`` is a lower bound, so the response cannot
        regress)."""
        if not self.has_capacity(view):
            return False
        if pin is None:
            return True
        return view.known_step is not None and view.known_step >= pin

    def route(self, views, pin=None):
        """Least-in-flight among eligible backends (name-ordered
        tie-break, so the choice is deterministic for tests); None when
        nobody is eligible — the caller decides between shedding (no
        capacity anywhere) and waiting out a swap window (capacity
        exists, the pin starves)."""
        candidates = [v for v in views if self.eligible(v, pin)]
        if not candidates:
            return None
        return min(candidates, key=lambda v: (v.in_flight, v.name)).name


class _Backend:
    """Router-side runtime state for one backend (lock-protected)."""

    __slots__ = ("name", "url", "in_flight", "known_step", "draining",
                 "alive", "status", "dispatched", "failures",
                 "down_event", "drain_event")

    def __init__(self, name, url):
        self.name = name
        self.url = url
        self.in_flight = 0
        self.known_step = None
        self.draining = False
        self.alive = None     # None = never scraped, else bool
        self.status = {}      # last /status body seen by the scrape
        self.dispatched = 0
        self.failures = 0
        self.down_event = None   # last router_backend_down record (cause)
        self.drain_event = None  # last router_drain record (cause)


class _Session:
    """One client's pin + assignment (the step-consistency state)."""

    __slots__ = ("pin", "backend", "pin_event")

    def __init__(self):
        self.pin = None
        self.backend = None
        self.pin_event = None    # last router_step_pin record (cause)


class FleetRouter:
    """The admission/routing runtime over N serving backends.

    Args:
      backends: ``{name: base_url}`` (``host:port`` normalized to http).
      policy: a :class:`RoutingPolicy` (default constructed).
      registry: metrics registry (default the process-wide one — the
        router is its own process).
      poll_interval: seconds between fleet scrapes (:meth:`start`).
      down_after: consecutive scrape misses before the collector reads a
        backend down (per-request failures latch it out IMMEDIATELY).
      timeout: per-scrape fetch timeout.
      request_timeout_s: forward timeout for ``/predict`` (must exceed
        the backends' own batch wait).
      step_wait_s: how long a pinned request may wait for SOME backend to
        reach its pin during a swap window before giving up (503).
      instance_name: this router's fleet-instance name — the ``instance``
        field of the :data:`CAUSAL_HEADER` tokens it stamps (must match
        the name its journal is merged under in ``/fleet/journal``).
      fetch / post / clock / sleep: injectable transports and time — the
        synthetic-clock tests drive every path without sockets.  ``post``
        is ``post(url, body, timeout, headers) -> (code, body_bytes)``.
    """

    def __init__(self, backends, policy=None, registry=None,
                 poll_interval=0.5, down_after=3, timeout=2.0,
                 request_timeout_s=60.0, step_wait_s=5.0,
                 instance_name="router",
                 fetch=None, post=None, clock=None, sleep=None):
        if not backends:
            raise UserException("FleetRouter wants at least one backend")
        if float(step_wait_s) < 0:
            raise UserException("step_wait_s must be >= 0")
        self.instance_name = str(instance_name)
        self.policy = policy if policy is not None else RoutingPolicy()
        self.registry = registry if registry is not None else obs_metrics.REGISTRY
        self.poll_interval = float(poll_interval)
        self.request_timeout_s = float(request_timeout_s)
        self.step_wait_s = float(step_wait_s)
        self.clock = clock if clock is not None else time.monotonic
        self._sleep = sleep if sleep is not None else time.sleep
        self._post = post if post is not None else _default_post
        self._lock = threading.Lock()
        self._backends = {}
        for name, url in backends.items():
            if "://" not in url:
                url = "http://" + url
            self._backends[str(name)] = _Backend(str(name), url.rstrip("/"))
        self._sessions = {}
        self._stop = threading.Event()
        self._thread = None
        # health/pressure through the fleet scrape — the one-scrape
        # federation plane, never a single process's registry
        self.collector = FleetCollector(
            backends, down_after=down_after, timeout=timeout, fetch=fetch,
            clock=clock,
        )
        self._metric_names = [
            "router_requests_total", "router_forwards_total",
            "router_retries_total", "router_sheds_total",
            "router_backend_up", "router_backend_inflight",
            "router_sessions", "router_step_pin_waits_total",
            "router_request_latency_seconds",
        ]
        self._m_requests = self.registry.counter(
            "router_requests_total", "Requests answered by the router",
            labelnames=("code",),
        )
        self._m_forwards = self.registry.counter(
            "router_forwards_total", "Forwards dispatched per backend",
            labelnames=("backend",),
        )
        self._m_retries = self.registry.counter(
            "router_retries_total",
            "Requests re-dispatched after their backend died mid-flight",
        )
        self._m_sheds = self.registry.counter(
            "router_sheds_total", "Fleet-saturated admission refusals (429)"
        )
        self._m_up = self.registry.gauge(
            "router_backend_up", "1 while the backend is routable",
            labelnames=("backend",),
        )
        self._m_inflight = self.registry.gauge(
            "router_backend_inflight",
            "Router-side in-flight forwards per backend",
            labelnames=("backend",),
        )
        self.registry.gauge(
            "router_sessions", "Client sessions with a step pin"
        ).set_function(lambda: len(self._sessions))
        self._m_pin_waits = self.registry.counter(
            "router_step_pin_waits_total",
            "Requests that waited out a swap window for a pinned backend",
        )
        self.latency = self.registry.histogram(
            "router_request_latency_seconds", "End-to-end routed latency"
        )
        for name in self._backends:
            self._m_up.labels(backend=name).set(0.0)
            self._m_inflight.labels(backend=name).set(0.0)

    # ------------------------------------------------------------------ #
    # fleet state: scrape sync + per-request outcomes

    def poll_once(self):
        """One scrape cycle + state sync (the poll thread's body; tests
        call it directly under synthetic fetch/clock)."""
        self.collector.poll_once()
        status = self.collector.status_payload()["instances"]
        for name, entry in status.items():
            backend = self._backends.get(name)
            if backend is None:
                continue
            if entry["up"]:
                body = entry["status"] if isinstance(entry["status"], dict) else {}
                self._mark_up(backend, body)
            elif entry["stale"]:
                # ever seen, now missing scrapes: an explicit down
                self._mark_down(backend, "scrape_misses")

    def _mark_up(self, backend, status_body):
        with self._lock:
            recovered = backend.alive is False
            backend.alive = True
            backend.status = status_body
            step = status_body.get("weights_step")
            if isinstance(step, int) and (backend.known_step is None
                                          or step > backend.known_step):
                backend.known_step = step
            draining = bool(status_body.get("draining"))
            began_drain = draining and not backend.draining
            in_flight = backend.in_flight
            backend.draining = draining
        self._m_up.labels(backend=backend.name).set(0.0 if draining else 1.0)
        if recovered:
            obs_events.emit("router_backend_up", backend=backend.name)
        if began_drain:
            record = obs_events.emit("router_drain", backend=backend.name,
                                     in_flight=in_flight)
            with self._lock:
                backend.drain_event = record

    def _mark_down(self, backend, reason):
        """Latch a backend out; returns the ``router_backend_down`` record
        (None when already down or journaling is off) — the cause the
        re-route / retry it triggers will cite."""
        with self._lock:
            was_alive = backend.alive
            backend.alive = False
            backend.failures += 1
        self._m_up.labels(backend=backend.name).set(0.0)
        if was_alive or was_alive is None:
            record = obs_events.emit("router_backend_down",
                                     backend=backend.name, reason=reason)
            with self._lock:
                backend.down_event = record
            return record
        return None

    # ------------------------------------------------------------------ #
    # views + sessions

    def views(self, exclude=()):
        """Immutable :class:`BackendView` rows for the policy."""
        with self._lock:
            rows = []
            for backend in self._backends.values():
                if backend.name in exclude:
                    continue
                status = backend.status
                bound = status.get("queue_bound")
                rows.append(BackendView(
                    name=backend.name,
                    up=bool(backend.alive),
                    draining=backend.draining,
                    in_flight=backend.in_flight,
                    queue_depth=int(status.get("queue_depth") or 0),
                    queue_bound=int(bound) if isinstance(bound, int) else None,
                    at_ceiling=bool(status.get("at_ceiling")),
                    known_step=backend.known_step,
                ))
            return rows

    def _session(self, client_id):
        if client_id is None:
            return None
        with self._lock:
            session = self._sessions.get(client_id)
            if session is None:
                session = self._sessions[client_id] = _Session()
            return session

    def _note_assignment(self, client_id, session, choice, pin,
                         inbound_cause=None):
        """Journal a client's backend assignment when it changes FOR A
        CAUSE (first contact, the previous backend down/draining, or the
        step pin excluding it).  Steady-state least-in-flight moves
        between equally-healthy backends are the calm case and stay off
        the timeline (the journal's calm-rounds discipline); a 3-backend fleet
        under closed-loop load would otherwise write hundreds of route
        lines per second that replay nothing.

        Returns the emitted ``router_route`` record (None for steady-state
        moves or with journaling off) — the latest causal event for this
        dispatch, stamped onto the forward as :data:`CAUSAL_HEADER`.  The
        route cites ITS cause: the down/drain event that evicted the
        previous backend, or the step-pin advance that excluded it
        (the inbound client token for first contact)."""
        if session is None:
            return None
        cause = None
        with self._lock:
            previous = session.backend
            if previous == choice:
                return None
            session.backend = choice
            if previous is None:
                reason = "initial"
                cause = inbound_cause
            else:
                old = self._backends.get(previous)
                if old is None or not old.alive:
                    reason = "backend_down"
                    if old is not None and old.down_event is not None:
                        cause = obs_events.cause_of(old.down_event)
                elif old.draining:
                    reason = "drain"
                    if old.drain_event is not None:
                        cause = obs_events.cause_of(old.drain_event)
                elif pin is not None and (old.known_step is None
                                          or old.known_step < pin):
                    reason = "step_pin"
                    if session.pin_event is not None:
                        cause = obs_events.cause_of(session.pin_event)
                else:
                    reason = "rebalance"
        if reason != "rebalance":
            return obs_events.emit("router_route", client=client_id,
                                   backend=choice, previous=previous,
                                   reason=reason, step_pin=pin, cause=cause)
        return None

    def _observe_step(self, name, client_id, session, step):
        """A 200 response reported its served ``weights_step``: raise the
        backend's known lower bound and (for pinned clients) advance the
        session pin — the advancement is the journaled decision."""
        if not isinstance(step, int):
            return
        advanced = None
        with self._lock:
            backend = self._backends.get(name)
            if backend is not None and (backend.known_step is None
                                        or step > backend.known_step):
                backend.known_step = step
            if session is not None and (session.pin is None
                                        or step > session.pin):
                advanced = (session.pin, step)
                session.pin = step
        if advanced is not None:
            record = obs_events.emit("router_step_pin", client=client_id,
                                     backend=name, previous=advanced[0],
                                     pin=advanced[1])
            with self._lock:
                if session is not None:
                    session.pin_event = record

    # ------------------------------------------------------------------ #
    # the request path

    def handle_predict(self, body, client_id=None, causal_id=None):
        """Route one ``/predict`` body; returns ``(code, payload_dict)``.

        The loop either returns, excludes a backend (shed this request /
        died mid-flight), or waits out a swap window bounded by
        ``step_wait_s`` — so it terminates.  A transport death is retried
        EXACTLY once; ``/predict`` is idempotent (pure inference), so the
        re-dispatch cannot double-apply anything.

        ``causal_id`` is the request's inbound :data:`CAUSAL_HEADER` token
        (None when absent).  The forward carries the router's latest
        journal event for this dispatch as the header — a caused
        ``router_route`` or a ``router_retry`` — falling back to the
        inbound token unchanged; a garbled inbound token is dropped, never
        a request failure (observability must not shed traffic).
        """
        started = self.clock()
        session = self._session(client_id)
        deadline = started + self.step_wait_s
        excluded = set()
        retried = False
        waited = False
        inbound_cause = None
        forward_token = None
        if causal_id is not None:
            try:
                inbound_cause = obs_events.parse_cause(causal_id)
                forward_token = causal_id
            except ValueError:
                pass
        while True:
            views = self.views(exclude=excluded)
            if not any(v.up and not v.draining for v in views):
                return self._answer(503, {
                    "error": "no live backend",
                    "detail": "every backend is down or draining",
                })
            if not self.policy.admit(views):
                self._m_sheds.inc()
                obs_events.emit("router_shed", client=client_id,
                                excluded=sorted(excluded),
                                detail="fleet saturated")
                return self._answer(429, {"error": "shed",
                                          "detail": "fleet saturated"})
            pin = session.pin if session is not None else None
            choice = self.policy.route(views, pin)
            if choice is None:
                # capacity exists but nobody is known at >= pin yet: a
                # swap window — wait for the fleet to catch up instead of
                # serving a step that could read backwards
                if not waited:
                    waited = True
                    self._m_pin_waits.inc()
                if self.clock() >= deadline:
                    return self._answer(503, {
                        "error": "no backend at pinned step",
                        "detail": "fleet did not reach weights_step >= %r "
                                  "within %.1fs" % (pin, self.step_wait_s),
                    })
                self._sleep(0.02)
                self.poll_once()
                continue
            backend = self._backends[choice]
            route_event = self._note_assignment(client_id, session, choice,
                                               pin, inbound_cause)
            if route_event is not None:
                forward_token = obs_events.format_cause(
                    obs_events.cause_of(route_event, self.instance_name))
            headers = ({CAUSAL_HEADER: forward_token}
                       if forward_token is not None else {})
            with self._lock:
                backend.in_flight += 1
                backend.dispatched += 1
            self._m_inflight.labels(backend=choice).set(backend.in_flight)
            self._m_forwards.labels(backend=choice).inc()
            try:
                code, payload = self._post(
                    backend.url + "/predict", body, self.request_timeout_s,
                    headers,
                )
            except (OSError, ValueError) as exc:
                # transport death (URLError/ConnectionError/timeout are
                # all OSError; ValueError covers a torn chunked read):
                # latch the backend out NOW — ahead of the scrape — and
                # re-dispatch exactly once
                down_event = self._mark_down(
                    backend, "request_failure: %s" % type(exc).__name__)
                excluded.add(choice)
                if retried:
                    return self._answer(502, {
                        "error": "backend lost",
                        "detail": "two backends died mid-flight",
                    })
                retried = True
                self._m_retries.inc()
                # the second attempt cites the first attempt's failure
                retry_event = obs_events.emit(
                    "router_retry", client=client_id, backend=choice,
                    reason=type(exc).__name__,
                    cause=(obs_events.cause_of(down_event)
                           if down_event is not None else inbound_cause))
                if retry_event is not None:
                    forward_token = obs_events.format_cause(
                        obs_events.cause_of(retry_event, self.instance_name))
                continue
            finally:
                with self._lock:
                    backend.in_flight -= 1
                self._m_inflight.labels(backend=choice).set(backend.in_flight)
            if isinstance(payload, (bytes, str)):
                try:
                    payload = json.loads(payload or b"{}")
                except ValueError:
                    payload = {"error": "unparseable backend response"}
            if code == 429:
                # the backend shed in the race window since the scrape:
                # per-request outcome feeds back into the fleet decision —
                # try the rest of the fleet before answering 429
                excluded.add(choice)
                continue
            if code == 200:
                self._observe_step(choice, client_id, session,
                                   payload.get("weights_step"))
                self.latency.record(max(0.0, self.clock() - started))
            return self._answer(code, payload, routed=choice)

    def _answer(self, code, payload, routed=None):
        self._m_requests.labels(code=str(code)).inc()
        if routed is not None and isinstance(payload, dict):
            payload = dict(payload, backend=routed)
        return code, payload

    # ------------------------------------------------------------------ #
    # introspection

    def status_payload(self):
        """The router's own ``/status`` body — scraped by an outer
        FleetCollector like any other instance."""
        with self._lock:
            backends = {}
            for backend in self._backends.values():
                backends[backend.name] = {
                    "url": backend.url,
                    "up": bool(backend.alive),
                    "draining": backend.draining,
                    "in_flight": backend.in_flight,
                    "dispatched": backend.dispatched,
                    "failures": backend.failures,
                    "known_step": backend.known_step,
                    "queue_depth": backend.status.get("queue_depth"),
                    "queue_bound": backend.status.get("queue_bound"),
                    "at_ceiling": backend.status.get("at_ceiling"),
                }
            sessions = len(self._sessions)
        return {
            "role": "router",
            "backends": backends,
            "sessions": sessions,
            "polls": self.collector.polls_total,
        }

    # ------------------------------------------------------------------ #
    # lifecycle

    def start(self):
        """One immediate scrape (so the first request sees the fleet),
        then poll on a daemon thread every ``poll_interval`` seconds."""
        if self._thread is not None:
            return
        self.poll_once()

        def run():
            while not self._stop.wait(self.poll_interval):
                self.poll_once()

        self._thread = threading.Thread(
            target=run, daemon=True, name="fleet-router-poll"
        )
        self._thread.start()

    def close(self):
        """Stop the poll loop and release this router's instruments."""
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(5.0)
        for name in self._metric_names:
            self.registry.unregister(name)


def _default_post(url, body, timeout, headers=None):
    """(code, body_bytes) for a JSON POST; transport errors raise (the
    router's retry-once path), HTTP error codes return normally.
    ``headers`` are extra request headers (the causal-plane stamp)."""
    merged = {"Content-Type": "application/json"}
    if headers:
        merged.update(headers)
    request = urllib.request.Request(url, data=body, headers=merged)
    try:
        with urllib.request.urlopen(request, timeout=timeout) as response:
            return response.status, response.read()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read()


# --------------------------------------------------------------------- #
# the one-port HTTP face


class _RouterHandler(BaseHTTPRequestHandler):
    server_version = "aggregathor-router/1"
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # scrapes must not spam stderr
        pass

    def _reply(self, code, body, content_type="application/json"):
        body = body.encode() if isinstance(body, str) else body
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_POST(self):
        path = urllib.parse.urlsplit(self.path).path
        if path != "/predict":
            self._reply(404, json.dumps({"error": "unknown path %r" % path}))
            return
        try:
            length = int(self.headers.get("Content-Length", "0") or 0)
        except ValueError:
            self._reply(400, json.dumps({"error": "bad Content-Length"}))
            return
        if length < 0 or length > MAX_BODY_BYTES:
            self._reply(400, json.dumps(
                {"error": "unacceptable Content-Length %d" % length}))
            return
        body = self.rfile.read(length) if length else b""
        client_id = self.headers.get(CLIENT_HEADER)
        causal_id = self.headers.get(CAUSAL_HEADER)
        try:
            code, payload = self.server.router.handle_predict(
                body, client_id=client_id, causal_id=causal_id
            )
        except Exception as exc:  # a request must never kill the router
            code, payload = 500, {"error": "%s: %s"
                                  % (type(exc).__name__, exc)}
        self._reply(code, json.dumps(payload))

    def do_GET(self):
        parsed = urllib.parse.urlsplit(self.path)
        router = self.server.router
        if parsed.path == "/metrics":
            fmt = urllib.parse.parse_qs(parsed.query).get("format", [None])[0]
            if fmt == "json":
                self._reply(200, json.dumps(router.registry.snapshot()))
            elif fmt in (None, "prometheus"):
                self._reply(200, router.registry.render_prometheus(),
                            obs_metrics.PROMETHEUS_CONTENT_TYPE)
            else:
                self._reply(400, json.dumps(
                    {"error": "unknown metrics format %r" % fmt}))
        elif parsed.path == "/status":
            self._reply(200, json.dumps(router.status_payload()))
        elif parsed.path == "/healthz":
            self._reply(200, json.dumps({"status": "ok", "role": "router"}))
        else:
            self._reply(404, json.dumps(
                {"error": "unknown path %r" % parsed.path}))


class RouterServer(ThreadingHTTPServer):
    """The router's HTTP face (``serve_background`` / ``shutdown_all``,
    the LiveExporter lifecycle): ``POST /predict`` routed through the
    fleet, ``GET /metrics`` + ``/status`` + ``/healthz`` for the scrape
    plane."""

    daemon_threads = True

    def __init__(self, router, host="127.0.0.1", port=0):
        super().__init__((host, int(port)), _RouterHandler)
        self.router = router
        self._serve_thread = None

    def serve_background(self):
        self._serve_thread = threading.Thread(
            target=self.serve_forever, daemon=True, name="fleet-router"
        )
        self._serve_thread.start()
        host, port = self.server_address[:2]
        info("Fleet router on http://%s:%d (/predict, /metrics, /status)"
             % (host, port))
        return host, port

    def shutdown_all(self):
        self.shutdown()
        self.server_close()
        if self._serve_thread is not None:
            self._serve_thread.join(5.0)
            self._serve_thread = None
