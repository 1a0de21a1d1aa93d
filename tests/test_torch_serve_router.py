"""The port's traffic plane: the counterparts of the JAX package's
``tests/test_router.py`` (the pure RoutingPolicy, the synthetic-clock
FleetRouter: staggered swaps with a pinned client that never observes
weights_step go backwards, backend-death retry-once, fleet-decision shed,
drain re-routing; the serve /status pressure fields and /metrics formats;
real-socket RouterServer round trips) on ``aggregathor_tpu_torch.serve``
and ``obs.fleet``, and the two packages' routing decisions, fleet merge
and causal postmortem on the same inputs."""

import json
import threading
import urllib.error
import urllib.request

import pytest

from aggregathor_tpu_torch.obs import events
from aggregathor_tpu_torch.obs.fleet import FleetCollector
from aggregathor_tpu_torch.obs.metrics import MetricsRegistry, parse_prometheus
from aggregathor_tpu_torch.serve import (
    BackendView,
    FleetRouter,
    RouterServer,
    RoutingPolicy,
)
from aggregathor_tpu_torch.utils import UserException


@pytest.fixture
def journal(tmp_path):
    """A process-installed journal torn down afterwards."""
    path = str(tmp_path / "router.journal.jsonl")
    events.install(path, run_id="rtest")
    yield path
    events.uninstall()


@pytest.fixture(autouse=True)
def _no_journal_leak():
    yield
    events.uninstall()


def _view(**kw):
    base = dict(name="a", up=True, draining=False, in_flight=0,
                queue_depth=0, queue_bound=8, at_ceiling=False,
                known_step=None)
    base.update(kw)
    return BackendView(**base)


# --------------------------------------------------------------------- #
# the pure policy (clockless, socketless)


def test_policy_least_in_flight_with_name_tiebreak():
    policy = RoutingPolicy()
    assert policy.route([_view(name="a", in_flight=3),
                         _view(name="b", in_flight=1)]) == "b"
    # deterministic tie-break: lexical name
    assert policy.route([_view(name="b"), _view(name="a")]) == "a"
    assert policy.route([]) is None


def test_policy_admission_is_a_fleet_verdict():
    policy = RoutingPolicy()
    saturated = _view(name="a", queue_depth=8, queue_bound=8)
    free = _view(name="b")
    # one free backend admits the fleet
    assert policy.admit([saturated, free])
    # every path to refusal: saturated, down, draining
    assert not policy.admit([saturated])
    assert not policy.admit([_view(up=False)])
    assert not policy.admit([_view(draining=True)])
    # unknown bound reads as unbounded (a pre-16 backend mid-rollout)
    assert policy.admit([_view(queue_depth=10**6, queue_bound=None)])


def test_policy_step_pin_gates_eligibility():
    policy = RoutingPolicy()
    behind = _view(name="a", known_step=3)
    ahead = _view(name="b", known_step=7, in_flight=5)
    # unpinned: least in-flight wins regardless of step
    assert policy.route([behind, ahead]) == "a"
    # pinned: only backends KNOWN at >= pin are eligible, load second
    assert policy.route([behind, ahead], pin=5) == "b"
    # an unobserved step (None) can never satisfy a pin
    assert policy.route([_view(known_step=None)], pin=1) is None
    # pin starvation: capacity exists, nobody is at the pin -> None
    assert policy.route([behind], pin=5) is None


# --------------------------------------------------------------------- #
# the synthetic fleet: scripted fetch/post, hand-cranked clock


class _FakeBackend:
    def __init__(self, step=0, queue_bound=8):
        self.step = step
        self.queue_bound = queue_bound
        self.queue_depth = 0
        self.draining = False
        self.dead = False          # scrape AND forwards refuse
        self.die_next_posts = 0    # forwards die mid-flight, scrape fine
        self.shed_next_posts = 0   # forwards answer 429, scrape fine
        self.posts = 0
        self.seen_headers = {}     # headers of the last forward seen


class _FakeNet:
    """The wire, scripted: the router's fetch (scrape) and post (forward)
    both resolve http://NAME/... against these backends."""

    def __init__(self, backends):
        self.backends = dict(backends)

    def _named(self, url):
        return self.backends[url.split("//")[1].split("/")[0]]

    def fetch(self, url, timeout):
        backend = self._named(url)
        if backend.dead:
            raise OSError("connection refused")
        if "/metrics" in url:
            return "serve_compile_count 3\n"
        return json.dumps({
            "weights_step": backend.step,
            "queue_depth": backend.queue_depth,
            "queue_bound": backend.queue_bound,
            "in_flight": 0, "draining": backend.draining,
            "at_ceiling": False,
        })

    def post(self, url, body, timeout, headers=None):
        backend = self._named(url)
        backend.posts += 1
        backend.seen_headers = dict(headers or {})
        if backend.dead:
            raise ConnectionError("connection refused")
        if backend.die_next_posts > 0:
            backend.die_next_posts -= 1
            raise ConnectionError("died mid-flight")
        if backend.shed_next_posts > 0:
            backend.shed_next_posts -= 1
            return 429, b'{"error": "shed"}'
        return 200, json.dumps({
            "predictions": [1], "weights_step": backend.step,
        }).encode()


def _make_router(net, names, clock=None, **kwargs):
    clock = clock if clock is not None else {"now": 0.0}

    def sleep(seconds):
        clock["now"] += seconds

    router = FleetRouter(
        {name: name for name in names}, registry=MetricsRegistry(),
        fetch=net.fetch, post=net.post, down_after=1,
        clock=lambda: clock["now"], sleep=sleep, **kwargs,
    )
    return router, clock


def _types(path):
    return [r["type"] for r in events.load_journal(path)]


def test_pinned_client_never_observes_step_regression(journal):
    """THE traffic-plane guarantee, on staggered swaps: backend b swaps
    ahead while a lags; a client pushed onto b (a died) is pinned there —
    a's revival at the OLD step cannot pull the client backwards, and the
    pin releases only once a catches up."""
    net = _FakeNet({"a": _FakeBackend(step=10), "b": _FakeBackend(step=10)})
    router, _clock = _make_router(net, ("a", "b"))
    router.poll_once()
    observed = []

    def ask(client="c1"):
        code, payload = router.handle_predict(b"{}", client_id=client)
        assert code == 200, payload
        observed.append(payload["weights_step"])
        return payload["backend"]

    assert ask() == "a"                      # tie-break: both @10
    net.backends["b"].step = 11              # b swaps first (staggered)
    net.backends["a"].dead = True            # a dies
    router.poll_once()
    assert ask() == "b"                      # pushed forward: pin -> 11
    net.backends["a"].dead = False           # a revives STILL AT 10
    router.poll_once()
    assert ask() == "b"                      # pin excludes the stale a
    assert ask() == "b"
    net.backends["a"].step = 12              # a leapfrogs (its own swap)
    router.poll_once()
    assert ask() == "a"                      # eligible again, least name
    assert observed == sorted(observed), observed  # never backwards
    assert observed == [10, 11, 11, 11, 12]

    types = _types(journal)
    assert "router_backend_down" in types and "router_backend_up" in types
    pins = [r for r in events.load_journal(journal)
            if r["type"] == "router_step_pin"]
    assert [p["pin"] for p in pins] == [10, 11, 12]
    routes = [r for r in events.load_journal(journal)
              if r["type"] == "router_route"]
    # only CAUSED assignment changes journal; the final least-in-flight
    # move back to the caught-up a is steady-state and stays off the
    # timeline (the journal's calm-rounds discipline)
    assert [r["reason"] for r in routes] == ["initial", "backend_down"]


def test_supervised_restart_readmits_backend_same_address(journal):
    """The supervisor leg of the traffic plane (docs/operations.md): a
    SIGKILLed backend restarted on the SAME host:port re-enters rotation
    on the next successful scrape — the down-latch clears only through
    poll_once, never through a lucky forward — and the restarted replica
    (restored from the same snapshot dir, so at the same step) serves
    pinned clients with no weights_step regression."""
    net = _FakeNet({"a": _FakeBackend(step=10), "b": _FakeBackend(step=10)})
    router, _clock = _make_router(net, ("a", "b"))
    router.poll_once()
    observed = []

    def ask(client="c1"):
        code, payload = router.handle_predict(b"{}", client_id=client)
        assert code == 200, payload
        observed.append(payload["weights_step"])
        return payload["backend"]

    assert ask() == "a"                      # tie-break: both @10
    net.backends["a"].dead = True            # SIGKILL (scrape AND posts die)
    router.poll_once()                       # down_after=1: latch immediately
    assert not router.status_payload()["backends"]["a"]["up"]
    assert ask() == "b"                      # traffic flows around the hole
    # the supervisor respawns serve on the same address; until the router
    # SCRAPES it, the latch holds — revival alone moves no traffic
    net.backends["a"].dead = False           # restart: same addr, same step
    posts_before = net.backends["a"].posts
    assert ask() == "b"
    assert net.backends["a"].posts == posts_before  # latch never probed it
    router.poll_once()                       # the re-admitting scrape
    assert router.status_payload()["backends"]["a"]["up"]
    assert ask() == "a"                      # back in rotation, least name
    assert observed == [10, 10, 10, 10]      # pinned: never backwards
    types = _types(journal)
    assert types.count("router_backend_down") == 1
    assert types.count("router_backend_up") >= 1
    # the re-admission is CAUSED and journaled; serving again is not a
    # new assignment for the pinned client beyond the latch flip
    last_up = max(i for i, t in enumerate(types)
                  if t == "router_backend_up")
    last_down = max(i for i, t in enumerate(types)
                    if t == "router_backend_down")
    assert last_up > last_down               # the timeline ends re-admitted


def test_swap_window_waits_then_serves_consistent(journal):
    """A pinned request arriving mid-swap (nobody yet at the pin) waits
    for the fleet to catch up instead of serving a step that could read
    backwards."""
    net = _FakeNet({"a": _FakeBackend(step=10), "b": _FakeBackend(step=10)})
    router, clock = _make_router(net, ("a", "b"), step_wait_s=5.0)
    router.poll_once()
    code, payload = router.handle_predict(b"{}", client_id="c1")
    assert code == 200 and payload["weights_step"] == 10
    # force the pin ahead of the whole fleet (as if the client's previous
    # backend served 11 then vanished): simulate by a quick b swap+death
    net.backends["b"].step = 11
    net.backends["a"].dead = True
    router.poll_once()
    assert router.handle_predict(b"{}", client_id="c1")[1]["weights_step"] == 11
    net.backends["b"].dead = True
    net.backends["a"].dead = False           # only the STALE backend lives
    router.poll_once()

    # the swap window resolves: a reaches 11 after ~0.1s of waiting
    release_at = clock["now"] + 0.1
    real_fetch = net.fetch

    def fetch(url, timeout):
        if clock["now"] >= release_at:
            net.backends["a"].step = 11
        return real_fetch(url, timeout)

    router.collector.fetch = fetch
    code, payload = router.handle_predict(b"{}", client_id="c1")
    assert code == 200
    assert payload["weights_step"] == 11 and payload["backend"] == "a"


def test_swap_window_timeout_prefers_consistency(journal):
    """If the fleet NEVER reaches the pin inside step_wait_s, the router
    answers 503 rather than break the monotone guarantee (consistency
    over availability, bounded)."""
    net = _FakeNet({"a": _FakeBackend(step=10), "b": _FakeBackend(step=11)})
    router, _clock = _make_router(net, ("a", "b"), step_wait_s=1.0)
    net.backends["a"].dead = True            # pin the client on b @11
    router.poll_once()
    assert router.handle_predict(b"{}", client_id="c1")[1]["weights_step"] == 11
    net.backends["a"].dead = False           # the stale a is all that's left
    net.backends["b"].dead = True            # the only >=11 backend dies
    router.poll_once()
    code, payload = router.handle_predict(b"{}", client_id="c1")
    assert code == 503 and "pinned step" in payload["error"]
    # an UNpinned client is untouched: a serves it at 10
    code, payload = router.handle_predict(b"{}", client_id="fresh")
    assert code == 200 and payload["weights_step"] == 10


def test_backend_death_mid_flight_retries_exactly_once(journal):
    """A forward that dies on the wire re-dispatches onto a live backend
    exactly once (idempotent /predict), latches the dead backend out
    ahead of the scrape, and the client sees ONE 200."""
    net = _FakeNet({"a": _FakeBackend(step=5), "b": _FakeBackend(step=5)})
    router, _clock = _make_router(net, ("a", "b"))
    router.poll_once()
    net.backends["a"].die_next_posts = 1
    code, payload = router.handle_predict(b"{}", client_id="c1")
    assert code == 200 and payload["backend"] == "b"
    assert net.backends["a"].posts == 1 and net.backends["b"].posts == 1
    # the dead backend is OUT immediately — no scrape needed
    assert not [v for v in router.views() if v.name == "a" and v.up]
    types = _types(journal)
    assert types.count("router_retry") == 1
    assert "router_backend_down" in types
    # and exactly once means ONCE: a second mid-flight death -> 502
    net.backends["a"].dead = True
    net.backends["b"].die_next_posts = 1
    router.poll_once()
    net.backends["b"].dead = True
    net.backends["b"].die_next_posts = 0
    code, payload = router.handle_predict(b"{}", client_id="c2")
    assert code in (502, 503)


def test_shed_is_a_fleet_decision(journal):
    """One saturated backend does NOT shed the fleet; 429 fires only when
    every healthy backend is at its bound — and a per-request backend 429
    (the race since the last scrape) re-routes before giving up."""
    net = _FakeNet({"a": _FakeBackend(step=1, queue_bound=4),
                    "b": _FakeBackend(step=1, queue_bound=4)})
    router, _clock = _make_router(net, ("a", "b"))
    router.poll_once()
    net.backends["a"].queue_depth = 4        # a saturated
    router.poll_once()
    code, payload = router.handle_predict(b"{}", client_id="c1")
    assert code == 200 and payload["backend"] == "b"
    net.backends["b"].queue_depth = 4        # whole fleet saturated
    router.poll_once()
    code, payload = router.handle_predict(b"{}", client_id="c1")
    assert code == 429 and payload["error"] == "shed"
    assert _types(journal).count("router_shed") == 1
    # the race: scrape says free, the forward sheds -> other backend wins
    net.backends["a"].queue_depth = net.backends["b"].queue_depth = 0
    router.poll_once()
    net.backends["a"].shed_next_posts = 1
    net.backends["b"].shed_next_posts = 0
    codes = {router.handle_predict(b"{}", client_id="c%d" % i)[0]
             for i in range(2)}
    assert codes == {200}


def test_drain_reroutes_new_traffic(journal):
    """A draining backend (SIGTERM'd serve) takes no NEW traffic; its
    clients re-route with reason=drain; recovery re-admits it."""
    net = _FakeNet({"a": _FakeBackend(step=2), "b": _FakeBackend(step=2)})
    router, _clock = _make_router(net, ("a", "b"))
    router.poll_once()
    assert router.handle_predict(b"{}", client_id="c1")[1]["backend"] == "a"
    net.backends["a"].draining = True
    router.poll_once()
    assert router.handle_predict(b"{}", client_id="c1")[1]["backend"] == "b"
    assert net.backends["a"].posts == 1      # no new traffic to a
    journal_types = _types(journal)
    assert journal_types.count("router_drain") == 1
    routes = [r for r in events.load_journal(journal)
              if r["type"] == "router_route"]
    assert routes[-1]["reason"] == "drain"
    # both draining/down -> 503, not a hang
    net.backends["b"].dead = True
    router.poll_once()
    assert router.handle_predict(b"{}", client_id="c1")[0] == 503


def test_router_status_payload_shape():
    net = _FakeNet({"a": _FakeBackend(step=4)})
    router, _clock = _make_router(net, ("a",))
    router.poll_once()
    router.handle_predict(b"{}", client_id="c1")
    payload = router.status_payload()
    assert payload["role"] == "router"
    assert payload["sessions"] == 1 and payload["polls"] == 1
    entry = payload["backends"]["a"]
    assert set(entry) == {"url", "up", "draining", "in_flight",
                          "dispatched", "failures", "known_step",
                          "queue_depth", "queue_bound", "at_ceiling"}
    assert entry["up"] is True and entry["known_step"] == 4
    assert entry["dispatched"] == 1 and entry["in_flight"] == 0
    # constructor validation while we are here
    with pytest.raises(UserException):
        FleetRouter({})
    router.close()


def test_router_metrics_registered_and_released():
    net = _FakeNet({"a": _FakeBackend(step=1)})
    registry = MetricsRegistry()
    router = FleetRouter({"a": "a"}, registry=registry, fetch=net.fetch,
                         post=net.post, down_after=1,
                         clock=lambda: 0.0, sleep=lambda s: None)
    router.poll_once()
    router.handle_predict(b"{}", client_id="c1")
    parsed = parse_prometheus(registry.render_prometheus())
    for name in ("router_requests_total", "router_forwards_total",
                 "router_retries_total", "router_sheds_total",
                 "router_backend_up", "router_backend_inflight",
                 "router_sessions", "router_step_pin_waits_total",
                 "router_request_latency_seconds"):
        assert any(key.startswith(name) for key in parsed), name
    router.close()
    assert "router_requests_total" not in registry.render_prometheus()


# --------------------------------------------------------------------- #
# serve /status pressure fields + the /metrics format unification
# (the serve exporter's routing surface, shape pinned here)


def _serve_server():
    from aggregathor_tpu_torch import models
    from aggregathor_tpu_torch.serve import InferenceEngine, InferenceServer

    exp = models.instantiate("digits", ["batch-size:16"])
    params = exp.init(0)
    engine = InferenceEngine(exp, [params], max_batch=4, buckets=(4,), device="cpu")
    engine.warmup()
    return InferenceServer(engine, port=0, queue_bound=16, lanes=1,
                           max_lanes=2, registry=MetricsRegistry())


def test_serve_status_pressure_shape_and_shed_delta():
    """The router routes on these fields: their presence and types are a
    wire contract, pinned exactly."""
    server = _serve_server()
    try:
        payload = server.status_payload()
        assert set(payload) == {
            "weights_step", "active_replicas", "lanes", "max_lanes",
            "in_flight", "queue_depth", "queue_bound", "batch_count",
            "compile_count", "custody_verified", "at_ceiling",
            "shed_count", "shed_delta", "draining",
        }
        assert payload["queue_bound"] == 16
        assert payload["at_ceiling"] is False  # 1 lane < max 2
        assert payload["draining"] is False
        assert payload["shed_count"] == 0 and payload["shed_delta"] == 0
        # shed_delta is per-read (the scrape's per-tick shed rate)
        server.scheduler.shed_count += 3
        assert server.status_payload()["shed_delta"] == 3
        assert server.status_payload()["shed_delta"] == 0
        assert server.status_payload()["shed_count"] == 3
        server.begin_drain()
        assert server.status_payload()["draining"] is True
        assert server.is_quiescent()
    finally:
        server.shutdown_all()


def test_serve_metrics_format_unification():
    """Bare /metrics answers Prometheus text on the serve exporter too;
    explicit format=json keeps the JSON payload; the fleet scrape's
    explicit ?format=prometheus keeps working."""
    server = _serve_server()
    host, port = server.serve_background()
    base = "http://%s:%d" % (host, port)
    try:
        def get(path):
            with urllib.request.urlopen(base + path, timeout=10) as response:
                return response.headers.get("Content-Type", ""), response.read()

        ctype, body = get("/metrics")
        assert ctype.startswith("text/plain")
        assert "serve_compile_count" in parse_prometheus(body.decode())
        ctype, body = get("/metrics?format=prometheus")
        assert ctype.startswith("text/plain")
        ctype, body = get("/metrics?format=json")
        assert ctype.startswith("application/json")
        snapshot = json.loads(body)
        for key in ("queue_depth", "compile_count", "lanes", "shed_count"):
            assert key in snapshot, key
        with pytest.raises(urllib.error.HTTPError) as caught:
            get("/metrics?format=yaml")
        assert caught.value.code == 400
        # the fleet collector reads the NEW default end to end
        fc = FleetCollector({"serve": "%s:%d" % (host, port)})
        fc.poll_once()
        assert fc.instance_up("serve")
        assert fc.status_payload()["instances"]["serve"]["status"][
            "queue_bound"] == 16
    finally:
        server.shutdown_all()


# --------------------------------------------------------------------- #
# one real-socket round trip: RouterServer in front of live HTTP backends


class _HTTPBackend:
    """A minimal live /predict+/status+/metrics process stand-in."""

    def __init__(self, name, step):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        backend = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                pass

            def _reply(self, code, body):
                body = body.encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path.startswith("/metrics"):
                    self._reply(200, "serve_compile_count 3\n")
                else:
                    self._reply(200, json.dumps({
                        "weights_step": backend.step, "queue_depth": 0,
                        "queue_bound": 8, "in_flight": 0,
                        "draining": False, "at_ceiling": False,
                    }))

            def do_POST(self):
                length = int(self.headers.get("Content-Length", 0))
                self.rfile.read(length)
                token = self.headers.get("X-Causal-Id")
                backend.seen.append(token)
                payload = {"predictions": [backend.name],
                           "weights_step": backend.step}
                if token is not None:
                    # the real frontend's causal echo (serve/frontend.py)
                    payload["causal_id"] = token
                self._reply(200, json.dumps(payload))

        self.name, self.step = name, step
        self.seen = []                  # X-Causal-Id header per request
        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()

    @property
    def address(self):
        return "127.0.0.1:%d" % self.httpd.server_address[1]

    def kill(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def test_router_server_round_trip_with_backend_kill():
    """The one-port face over real sockets: routed /predict with the
    X-Client-Id pin, /metrics + /status scrapeable, and a killed backend
    that loses zero requests."""
    backends = [_HTTPBackend("a", 7), _HTTPBackend("b", 7)]
    router = FleetRouter({b.name: b.address for b in backends},
                         registry=MetricsRegistry(), poll_interval=0.05,
                         down_after=1, step_wait_s=2.0)
    server = RouterServer(router)
    router.start()
    host, port = server.serve_background()
    base = "http://%s:%d" % (host, port)
    try:
        def post(client):
            request = urllib.request.Request(
                base + "/predict", data=b'{"rows": []}',
                headers={"Content-Type": "application/json",
                         "X-Client-Id": client},
            )
            try:
                with urllib.request.urlopen(request, timeout=10) as response:
                    return response.status, json.loads(response.read())
            except urllib.error.HTTPError as exc:
                return exc.code, json.loads(exc.read())

        code, payload = post("c1")
        assert code == 200 and payload["weights_step"] == 7

        with urllib.request.urlopen(base + "/metrics", timeout=10) as resp:
            assert resp.headers["Content-Type"].startswith("text/plain")
            assert "router_requests_total" in resp.read().decode()
        with urllib.request.urlopen(base + "/status", timeout=10) as resp:
            status = json.loads(resp.read())
        assert status["role"] == "router" and status["backends"]["a"]["up"]
        with urllib.request.urlopen(base + "/healthz", timeout=10) as resp:
            assert json.loads(resp.read())["role"] == "router"
        with pytest.raises(urllib.error.HTTPError) as caught:
            urllib.request.urlopen(base + "/nope", timeout=10)
        assert caught.value.code == 404

        backends[0].kill()  # mid-run: every request must still answer 200
        outcomes = [post("k%d" % i)[0] for i in range(6)]
        assert outcomes == [200] * 6
    finally:
        server.shutdown_all()
        router.close()
        for backend in backends[1:]:
            backend.kill()


def test_router_causal_header_survives_socket_round_trip(journal):
    """Satellite: the causal plane over real sockets.  The router stamps
    its latest journal event for the dispatch as ``X-Causal-Id``; the
    backend echoes it into the response; a mid-flight retry's forward
    carries the ``router_retry`` token, and that retry event cites the
    first attempt's ``router_backend_down`` failure.  A steady-state
    forward (no new route event) passes the client's inbound token
    through unchanged."""
    backends = [_HTTPBackend("a", 7), _HTTPBackend("b", 7)]
    # down_after is huge on purpose: the scrape loop must NOT win the race
    # to mark the killed backend down — the REQUEST failure has to, so the
    # retry deterministically cites the request-driven down event
    router = FleetRouter({b.name: b.address for b in backends},
                         registry=MetricsRegistry(), poll_interval=0.2,
                         down_after=100, step_wait_s=2.0,
                         instance_name="router-1")
    server = RouterServer(router)
    router.start()
    host, port = server.serve_background()
    base = "http://%s:%d" % (host, port)

    def post(client, causal_id=None):
        headers = {"Content-Type": "application/json",
                   "X-Client-Id": client}
        if causal_id is not None:
            headers["X-Causal-Id"] = causal_id
        request = urllib.request.Request(base + "/predict",
                                         data=b'{"rows": []}',
                                         headers=headers)
        with urllib.request.urlopen(request, timeout=10) as response:
            return response.status, json.loads(response.read())

    try:
        # --- initial assignment: the router_route event IS the token ---
        code, payload = post("c1")
        assert code == 200
        token = payload["causal_id"]
        ref = events.parse_cause(token)
        assert ref["instance"] == "router-1" and ref["run_id"] == "rtest"
        routed = payload["backend"]
        chosen = next(b for b in backends if b.name == routed)
        assert chosen.seen[-1] == token

        # --- steady state: the inbound token passes through unchanged --
        inbound = events.format_cause(
            {"instance": "trainer", "run_id": "ext", "seq": 9})
        code, payload = post("c1", causal_id=inbound)
        assert code == 200 and payload["causal_id"] == inbound
        assert chosen.seen[-1] == inbound
        # a garbled inbound token is dropped, never a request failure
        code, payload = post("c1", causal_id="not a token")
        assert code == 200 and "causal_id" not in payload

        # --- the kill: the second attempt cites the first's failure ----
        chosen.kill()
        survivor = next(b for b in backends if b.name != routed)
        code, payload = post("c1")
        assert code == 200 and payload["backend"] == survivor.name
        reroute_token = payload["causal_id"]
        reroute_ref = events.parse_cause(reroute_token)
        assert survivor.seen[-1] == reroute_token
    finally:
        server.shutdown_all()
        router.close()
        for backend in backends:
            try:
                backend.kill()
            except Exception:
                pass
    events.uninstall()
    records = events.load_journal(journal)
    by_seq = {r["seq"]: r for r in records}
    # the echoed tokens name real journal events of the right types
    assert by_seq[ref["seq"]]["type"] == "router_route"
    assert by_seq[ref["seq"]]["reason"] == "initial"
    # the forwarded token after the death is the re-assignment event,
    # whose cause is the failure that evicted the first backend...
    reroute_record = by_seq[reroute_ref["seq"]]
    assert reroute_record["type"] == "router_route"
    assert reroute_record["reason"] == "backend_down"
    down_ref = reroute_record["cause"]
    assert down_ref["instance"] is None      # same journal
    down_record = by_seq[down_ref["seq"]]
    assert down_record["type"] == "router_backend_down"
    assert down_record["backend"] == routed
    assert "request_failure" in down_record["reason"]
    # ...and the router_retry of the second attempt cites it too
    retries = [r for r in records if r["type"] == "router_retry"]
    assert len(retries) == 1 and retries[0]["backend"] == routed
    assert retries[0]["cause"]["seq"] == down_record["seq"]


# --------------------------------------------------------------------- #
# the two packages on the same inputs


def test_routing_decisions_are_the_jax_package_s():
    import random

    from aggregathor_tpu.serve import BackendView as JaxView
    from aggregathor_tpu.serve import RoutingPolicy as JaxPolicy

    rng = random.Random(20261018)
    ours, theirs = RoutingPolicy(), JaxPolicy()
    for _ in range(500):
        fields = [dict(name=name, up=rng.random() < 0.8, draining=rng.random() < 0.2,
                       in_flight=rng.randrange(4), queue_depth=rng.randrange(10), queue_bound=8,
                       at_ceiling=rng.random() < 0.3, known_step=rng.choice([None, 1, 2, 3]))
                  for name in ("a", "b", "c")]
        pin = rng.choice([None, 1, 2, 3])
        got = ours.route([BackendView(**f) for f in fields], pin=pin)
        want = theirs.route([JaxView(**f) for f in fields], pin=pin)
        assert got == want, (fields, pin)


def test_fleet_merge_and_postmortem_are_the_jax_package_s(tmp_path):
    """The same synthetic expositions merge into the same fleet text, and
    the same journals (two instances, one clock behind) replay to the same
    postmortem report and story."""
    from aggregathor_tpu.obs import causal as jcausal
    from aggregathor_tpu.obs import events as jevents
    from aggregathor_tpu.obs.fleet import FleetCollector as JaxCollector
    from aggregathor_tpu_torch.obs import causal

    texts = {
        "train": "# TYPE train_steps_total counter\ntrain_steps_total 7\n# TYPE train_loss gauge\ntrain_loss 0.5\n",
        "serve": "# TYPE serve_batches_total counter\nserve_batches_total 3\n# TYPE train_steps_total counter\n"
                 "train_steps_total 2\n",
    }

    def fetch(url, timeout):
        name = url.split("/")[0]
        if "/status" in url:
            return json.dumps({"name": name})
        return texts[name]

    merged = []
    for cls in (FleetCollector, JaxCollector):
        ticks = iter(float(t) for t in range(100))
        collector = cls({"train": "train", "serve": "serve"}, fetch=fetch, clock=lambda: next(ticks))
        collector.poll_once()
        merged.append(collector.render_metrics())
    assert merged[0] == merged[1]

    paths = {}
    for name, shift in (("router", 0.0), ("serve", -0.5)):
        path = str(tmp_path / ("%s.jsonl" % name))
        wall = iter(1000.0 + shift + 0.1 * i for i in range(100))
        mono = iter(10.0 + 0.1 * i for i in range(100))
        journal = jevents.Journal(path, run_id="run-" + name, wall_clock=lambda: next(wall),
                                  mono_clock=lambda: next(mono))
        journal.emit("run_start", role=name, cause=None)
        if name == "router":
            journal.emit("router_backend_down", backend="a", cause=None)
        else:
            journal.emit("serve_weight_swap", step=4, previous=2, forced=False)
        journal.emit("run_end", role=name)
        journal.close()
        paths[name] = path
    ours = causal.run_postmortem(dict(paths))
    theirs = jcausal.run_postmortem(dict(paths))
    assert json.loads(json.dumps(ours)) == json.loads(json.dumps(theirs))
    assert causal.render_story(ours) == jcausal.render_story(theirs)


def test_the_router_cli_has_the_jax_options_and_defaults():
    from aggregathor_tpu.cli import router as jax_router_cli
    from aggregathor_tpu_torch.cli import router as router_cli

    ours, theirs = router_cli.build_parser(), jax_router_cli.build_parser()
    options = [sorted(s for a in p._actions for s in a.option_strings) for p in (ours, theirs)]
    assert options[0] == options[1]
    for action in theirs._actions:
        assert ours.get_default(action.dest) == theirs.get_default(action.dest), action.dest
