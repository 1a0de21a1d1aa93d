"""The port's serving server: the counterparts of the JAX package's
``tests/test_serve.py`` server and autoscaler cases, on the port's engine on
the CPU.

The autoscaler climbs lanes then retires then recovers, a stale p99 reads
as unmeasured, the feasibility floor blocks retirement, the front end sheds
(429), times out (504, the queued rows cancelled) and closes on an oversize
body, the levers compose with ``compile_count`` unchanged, and an HTTP
round trip serves the vote over a NaN replica.  The overload case wedges
the one lane and fills the queue through the scheduler before the HTTP
request, so no wall-clock race decides it (the JAX package's own overload
test is load-sensitive).
"""

import json
import socket
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from aggregathor_tpu_torch import gars, models
from aggregathor_tpu_torch.obs.metrics import MetricsRegistry
from aggregathor_tpu_torch.serve import (
    AutoscaleConfig,
    InferenceEngine,
    InferenceServer,
    LoadShed,
    PoolAutoscaler,
    choose_bucket,
)
from aggregathor_tpu_torch.serve.frontend import MAX_BODY_BYTES
from conftest import assert_zero_recompiles
from serve_parity import two_threads  # noqa: F401  (a fixture)

from torch_threads import pinned_threads  # noqa: F401  (a fixture: the xdist worker's intra-op pool)

pytestmark = pytest.mark.usefixtures("two_threads")

_DIGITS = None


def _digits():
    global _DIGITS
    if _DIGITS is None:
        exp = models.instantiate("digits", ["batch-size:16"])
        _DIGITS = (exp, exp.init(0))
    return _DIGITS


def _make_server(engine, **kwargs):
    """An InferenceServer on a PRIVATE registry, scheduler only."""
    registry = MetricsRegistry()
    return InferenceServer(engine, port=0, registry=registry, **kwargs), registry


def _post(base, path, payload, timeout=30):
    req = urllib.request.Request(base + path, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as response:
            return response.status, json.loads(response.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


def _get(base, path, timeout=10):
    with urllib.request.urlopen(base + path, timeout=timeout) as response:
        return json.loads(response.read())


def test_engine_runs_each_bucket_once_over_reused_buckets():
    exp, params = _digits()
    engine = InferenceEngine(exp, [params], max_batch=16, device="cpu")
    assert engine.buckets == (1, 2, 4, 8, 16)
    engine.warmup()
    assert_zero_recompiles(engine, expect=5)
    x = np.asarray(exp.dataset.x_test[:16], np.float32)
    for size in (1, 3, 5, 8, 16, 2, 7, 16, 1, 11):
        out = engine.predict(x[:size])
        assert out["predictions"].shape == (size,)
        assert out["bucket"] == choose_bucket(size, engine.buckets)
    big = engine.predict(np.concatenate([x, x]))
    assert big["predictions"].shape == (32,)
    assert_zero_recompiles(engine, expect=5)


def test_autoscaler_climbs_lanes_then_retires_then_recovers():
    exp, params = _digits()
    engine = InferenceEngine(exp, [params] * 3, gar=gars.instantiate("median", 3, 1), max_batch=4, buckets=(4,),
                             device="cpu")
    engine.warmup()
    server, registry = _make_server(engine, lanes=1, max_lanes=2)
    try:
        config = AutoscaleConfig(["up-patience:1", "down-patience:1", "cooldown:0", "fault-reserve:0"])
        scaler = PoolAutoscaler(server, config, registry=registry, clock=lambda: 0.0)
        assert [scaler.ladder.rung(i) for i in range(len(scaler.ladder))] == [(1, 0), (2, 0), (2, 1)]
        with server._lock:
            server._last_disagreement = [0.0, 9.0, 0.0]
        pressure = {"queue_rows": 999.0, "p99_s": None, "shed_rate": 0.0}
        calm = {"queue_rows": 0.0, "p99_s": None, "shed_rate": 0.0}
        sample = pressure
        scaler.sample = lambda now: (sample["queue_rows"], sample["p99_s"], sample["shed_rate"])
        assert scaler.tick(now=1.0) == "expand"
        assert server.scheduler.nb_lanes == 2 and engine.active_replicas == [0, 1, 2]
        assert scaler.tick(now=2.0) == "expand"
        assert engine.active_replicas == [0, 2], "most-suspect not retired"
        assert scaler.tick(now=3.0) is None
        families = {f.name: f for f in registry.families()}
        assert families["serve_autoscale_at_ceiling"].value == 1.0
        sample = calm
        assert scaler.tick(now=4.0) == "shrink"
        assert engine.active_replicas == [0, 1, 2] and server.scheduler.nb_lanes == 2
        assert scaler.tick(now=5.0) == "shrink"
        assert server.scheduler.nb_lanes == 1
        assert scaler.tick(now=6.0) is None
        assert families["serve_autoscale_at_ceiling"].value == 0.0
        assert_zero_recompiles(engine, expect=1)
        scaler.close()
    finally:
        server.shutdown_all()


def test_autoscaler_stale_p99_reads_as_unmeasured():
    exp, params = _digits()
    engine = InferenceEngine(exp, [params], max_batch=4, buckets=(4,), device="cpu")
    server, registry = _make_server(engine, lanes=1, max_lanes=2)
    try:
        scaler = PoolAutoscaler(server, AutoscaleConfig([]), registry=registry, clock=lambda: 0.0)
        server.latency.record(9.0)
        assert scaler.sample(now=1.0)[1] == pytest.approx(9.0)
        assert scaler.sample(now=2.0)[1] is None
        server.latency.record(0.01)
        assert scaler.sample(now=3.0)[1] is not None
        scaler.close()
    finally:
        server.shutdown_all()


def test_autoscaler_feasibility_floor_blocks_retirement():
    exp, params = _digits()
    for rule, reserve in (("median", "fault-reserve:1"), ("average", "fault-reserve:0")):
        engine = InferenceEngine(exp, [params] * 3, gar=gars.instantiate(rule, 3, 1), max_batch=4, buckets=(4,),
                                 device="cpu")
        server, registry = _make_server(engine, lanes=1, max_lanes=2)
        try:
            scaler = PoolAutoscaler(server, AutoscaleConfig([reserve]), registry=registry, clock=lambda: 0.0)
            assert scaler.ladder.rungs == ((1, 0), (2, 0)), rule
            scaler.close()
        finally:
            server.shutdown_all()


def _wedged_server(queue_bound, request_timeout_s=60.0):
    """A one-lane server whose lane blocks inside its first batch until
    ``release`` is set; ``entered`` is set once it does."""
    exp, params = _digits()
    engine = InferenceEngine(exp, [params], max_batch=4, buckets=(4,), device="cpu")
    engine.warmup()
    server = InferenceServer(engine, port=0, queue_bound=queue_bound, request_timeout_s=request_timeout_s,
                             registry=MetricsRegistry())
    release, entered = threading.Event(), threading.Event()
    inner = server.scheduler.runner

    def wedged(rows):
        entered.set()
        release.wait(10.0)
        return inner(rows)

    server.scheduler.runner = wedged
    return server, release, entered


def test_server_sheds_over_the_queue_bound_without_a_race():
    server, release, entered = _wedged_server(queue_bound=2)
    host, port = server.serve_background()
    base = "http://%s:%d" % (host, port)
    x0 = np.zeros((1, 8, 8, 1), np.float32)
    try:
        first = server.scheduler.submit(x0)  # the wedged lane takes it
        assert entered.wait(10.0)
        queued = [server.scheduler.submit(x0), server.scheduler.submit(x0)]  # the bound: 2 rows
        assert server.scheduler.queue_depth == 2
        with pytest.raises(LoadShed):
            server.scheduler.submit(x0)
        code, out = _post(base, "/predict", {"inputs": x0.tolist()})
        assert code == 429 and out["error"] == "shed"
        release.set()
        for ticket in [first] + queued:
            assert ticket.wait(10.0)["predictions"].shape == (1,)
        code, _ = _post(base, "/predict", {"inputs": x0.tolist()})
        assert code == 200
        metrics = _get(base, "/metrics?format=json")
        assert metrics["shed_count"] == 2 and metrics["shed_rows"] == 1
    finally:
        release.set()
        server.shutdown_all()


def test_server_times_out_and_cancels_stuck_requests():
    server, release, entered = _wedged_server(queue_bound=64, request_timeout_s=0.3)
    host, port = server.serve_background()
    base = "http://%s:%d" % (host, port)
    x0 = np.zeros((1, 8, 8, 1), np.float32).tolist()
    try:
        wedge = threading.Thread(target=_post, args=(base, "/predict", {"inputs": x0}))
        wedge.start()
        assert entered.wait(5.0)
        code, out = _post(base, "/predict", {"inputs": x0})
        assert code == 504, out
        release.set()
        wedge.join()
        assert _get(base, "/metrics?format=json")["cancelled_count"] >= 1
    finally:
        release.set()
        server.shutdown_all()


def test_refused_oversize_body_closes_the_connection():
    exp, params = _digits()
    engine = InferenceEngine(exp, [params], max_batch=4, buckets=(4,), device="cpu")
    engine.warmup()
    server = InferenceServer(engine, port=0, registry=MetricsRegistry())
    host, port = server.serve_background()
    try:
        with socket.create_connection((host, port), timeout=10) as sock:
            sock.sendall(("POST /predict HTTP/1.1\r\nContent-Length: %d\r\n\r\n" % (MAX_BODY_BYTES + 1)).encode())
            data = b""
            while True:
                chunk = sock.recv(4096)
                if not chunk:
                    break
                data += chunk
        head = data.decode("latin1")
        assert head.startswith("HTTP/1.1 400") and "connection: close" in head.lower(), head
    finally:
        server.shutdown_all()


def test_serving_levers_compose_with_no_new_bucket_shape():
    exp, params = _digits()
    fresh = exp.init(3)
    engine = InferenceEngine(exp, [params] * 3, gar=gars.instantiate("median", 3, 1), max_batch=8, weights_step=1,
                             device="cpu")
    engine.warmup()
    compiled = len(engine.buckets)
    server = InferenceServer(engine, port=0, queue_bound=256, lanes=1, max_lanes=3, registry=MetricsRegistry())
    x = np.asarray(exp.dataset.x_test[:8], np.float32)
    try:
        def burst():
            tickets = [server.scheduler.submit(x[:k]) for k in (1, 3, 8, 5, 2)]
            return [t.wait(30.0) for t in tickets]

        assert {r["weights_step"] for r in burst()} == {1}
        server.scheduler.set_lanes(3)
        engine.set_active_replicas([0, 2])
        mid = burst()
        engine.swap_replicas([fresh] * 3, step=2)
        last = burst()
        assert {r["weights_step"] for r in last} == {2}
        assert all(r["active_replicas"] == [0, 2] for r in last)
        server.scheduler.set_lanes(1)
        assert len(mid) == len(last) == 5
        assert_zero_recompiles(engine, expect=compiled)
    finally:
        server.shutdown_all()


def test_http_round_trip_serves_the_vote_over_a_nan_replica():
    """The JAX round trip's HTTP half: /predict's vote equals the clean
    replica's predictions, /healthz flags the NaN replica, /status and
    /metrics report the serving state, malformed input is 400 and a request
    above the ladder top is 400 (split it client-side)."""
    from aggregathor_tpu_torch.chaos.replica_faults import corrupt_params

    exp, params = _digits()
    replicas = [params, corrupt_params(params, "nan"), params]
    engine = InferenceEngine(exp, replicas, gar=gars.instantiate("median", 3, 1), max_batch=8, weights_step=30,
                             device="cpu")
    engine.warmup()
    server = InferenceServer(engine, port=0, queue_bound=64, lanes=2, max_lanes=2, registry=MetricsRegistry())
    host, port = server.serve_background()
    base = "http://%s:%d" % (host, port)
    try:
        x = np.asarray(exp.dataset.x_test[:8], np.float32)
        expected = InferenceEngine(exp, [params], max_batch=8, device="cpu").predict(x)["predictions"]
        code, out = _post(base, "/predict", {"inputs": x.tolist()})
        assert code == 200
        np.testing.assert_array_equal(np.asarray(out["predictions"]), expected)
        assert out["disagreement"][1] is None and out["weights_step"] == 30 and out["active_replicas"] == [0, 1, 2]
        health = _get(base, "/healthz")
        assert health["status"] == "ok" and health["suspect_replicas"] == [1] and health["weights_step"] == 30
        status = _get(base, "/status")
        assert status["lanes"] == 2 and status["compile_count"] == len(engine.buckets)
        metrics = _get(base, "/metrics?format=json")
        assert metrics["served_rows"] >= 8 and metrics["latency_ms"]["p95"] is not None
        assert "serve_batches_total" in urllib.request.urlopen(base + "/metrics", timeout=10).read().decode()
        assert _post(base, "/predict", {"inputs": [[1.0, 2.0]]})[0] == 400
        assert _post(base, "/predict", {"wrong": []})[0] == 400
        code, out = _post(base, "/predict", {"inputs": np.zeros((9, 64), np.float32).tolist()})
        assert code == 400 and "ladder top" in out["error"]
    finally:
        server.shutdown_all()
