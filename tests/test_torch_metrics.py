"""The port's metrics plane against the JAX package's, on the CPU.

- ``obs/metrics.py``: the same operations on the JAX registry and on the
  port's render the same Prometheus text and the same snapshot, and each
  parser reads the other's exposition; refusals, label escaping and
  concurrent updates behave as in JAX ``tests/test_obs.py``;
- ``obs/trace.py``: under an injected clock the same spans give the same
  Chrome events, pid and tid aside; nesting, the decorator, error
  annotation, the disabled no-op, thread safety, the event cap and the
  validator as in JAX ``tests/test_obs.py:217-316``;
- ``obs/live.py``: a scrape round trip on 127.0.0.1:0 (JAX
  ``tests/test_flight.py:339-374``);
- ``obs/perf.py``: a registry-backed report exports the JAX report's
  histogram and counters;
- ``RobustEngine.build_gar_probe``: on rows injected into both, the probe
  equals the JAX rule's ``_call_aggregate`` (krum, median, bulyan) within
  1e-6 relative, and repeats itself at a step (the rows are torch draws, not
  ``jax.random`` ones, so they are injected).
"""

import json
import threading
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aggregathor_tpu import gars as jgars
from aggregathor_tpu.gars.common import pairwise_sq_distances as jax_distances
from aggregathor_tpu.obs import metrics as jmetrics
from aggregathor_tpu.obs import perf as jperf
from aggregathor_tpu.obs import trace as jtrace
from aggregathor_tpu_torch import gars
from aggregathor_tpu_torch.obs import live, metrics, perf, trace
from aggregathor_tpu_torch.parallel import RobustEngine
from aggregathor_tpu_torch.utils import UserException

from torch_threads import pinned_threads  # noqa: F401  (a fixture: the xdist worker's intra-op pool)


def _exercise(module):
    """One operation sequence on a fresh registry of ``module``: counters,
    gauges (set, inc/dec, a scrape-time function), labelled families with
    nasty label values, histograms with and without labels, an unregister."""
    reg = module.MetricsRegistry()
    c = reg.counter("requests_total", "Requests\nserved")
    c.inc()
    c.inc(2.5)
    g = reg.gauge("depth", "Queue depth")
    g.set(7)
    g.dec(2)
    reg.gauge("live_value", "A callback").set_function(lambda: 4.25)
    fam = reg.gauge("worker_dist", "Distance", labelnames=("worker", "note"))
    fam.labels(worker="3", note='a"b\\c\nd').set(1.5)
    fam.labels("4", "plain").set(float("inf"))
    fam.labels("5", "nan").set(float("nan"))
    h = reg.histogram("lat_seconds", "Latency", buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 5.0, 0.1):
        h.observe(v)
    hl = reg.histogram("phase_seconds", "By phase", labelnames=("phase",))
    for i in range(20):
        hl.labels(phase="gather" if i % 3 else "put").observe(0.001 * i)
    reg.counter("gone_total", "dropped").inc()
    reg.unregister("gone_total")
    return reg


def _snapshot_text(reg):
    return json.dumps(reg.snapshot(), sort_keys=True, default=str)


def test_registry_renders_the_jax_text_and_snapshot():
    ours, theirs = _exercise(metrics), _exercise(jmetrics)
    assert ours.render_prometheus() == theirs.render_prometheus()
    assert _snapshot_text(ours) == _snapshot_text(theirs)
    assert metrics.PROMETHEUS_CONTENT_TYPE == jmetrics.PROMETHEUS_CONTENT_TYPE
    assert metrics.DEFAULT_BUCKETS == jmetrics.DEFAULT_BUCKETS


def test_each_parser_reads_the_others_exposition():
    ours, theirs = _exercise(metrics).render_prometheus(), _exercise(jmetrics).render_prometheus()

    def canon(parsed):
        return json.dumps(parsed, sort_keys=True, default=str)

    assert canon(metrics.parse_prometheus(theirs)) == canon(jmetrics.parse_prometheus(ours))
    parsed = metrics.parse_prometheus(theirs)
    samples = {(labels["worker"], labels["note"]): value
               for _, labels, value in parsed["worker_dist"]["samples"]}
    assert samples[("3", 'a"b\\c\nd')] == 1.5 and samples[("4", "plain")] == float("inf")
    for bad in ("this is not { exposition\n", 'm{a="1";;;b="2"} 3\n'):
        for module in (metrics, jmetrics):
            with pytest.raises(ValueError):
                module.parse_prometheus(bad)


@pytest.mark.parametrize("module", [metrics, jmetrics], ids=["port", "jax"])
def test_registry_refusals(module):
    reg = module.MetricsRegistry()
    assert reg.counter("shared_total") is reg.counter("shared_total")
    error = UserException if module is metrics else jmetrics.UserException
    for make in (lambda: reg.gauge("shared_total"),
                 lambda: reg.counter("shared_total", labelnames=("worker",)),
                 lambda: reg.counter("bad name!"),
                 lambda: reg.counter("shared_total").inc(-1.0),
                 lambda: reg.gauge("lbl", labelnames=("w",)).set(1.0),
                 lambda: reg.gauge("lbl", labelnames=("w",)).labels("1", "2")):
        with pytest.raises(error):
            make()
    hist = reg.histogram("h_seconds", buckets=(1.0, 0.1))
    assert reg.histogram("h_seconds", buckets=(0.1, 1)) is hist
    with pytest.raises(error):
        reg.histogram("h_seconds", buckets=(5.0, 50.0))


def test_registry_concurrency_exact_totals():
    reg = metrics.MetricsRegistry()
    counter = reg.counter("hits_total")
    hist = reg.histogram("obs_seconds", buckets=(0.5,))
    fam = reg.counter("labelled_total", labelnames=("t",))

    def pound(tid):
        for i in range(500):
            counter.inc()
            hist.observe(0.25 if i % 2 else 0.75)
            fam.labels(t=str(tid % 2)).inc()

    threads = [threading.Thread(target=pound, args=(t,)) for t in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert counter.value == 8 * 500 and hist.count == 8 * 500
    assert sum(c.value for c in fam.children().values()) == 8 * 500
    metrics.parse_prometheus(reg.render_prometheus())


# --------------------------------------------------------------------- #
# the span tracer


class _Clock:
    def __init__(self):
        self.now = 100.0

    def __call__(self):
        self.now += 0.001
        return self.now


def _spans(module, path):
    tracer = module.install(str(path), run_id="run-1", clock=_Clock())
    try:
        with module.span("outer", cat="train", step=3):
            with module.span("inner", cat="train"):
                pass
            module.instant("tick", cat="obs", k=1)

        @module.span("work", cat="checkpoint")
        def work(x):
            return x + 1

        work(1)
        with pytest.raises(ValueError):
            with module.span("broken"):
                raise ValueError("boom")
        gap = module.span("host_gap", cat="train").start()
        gap.stop()
        tracer.counter("bytes", 12.0, cat="wire")
        tracer.complete_at("lane", 5.0, 2.0, tracer.track("worker-0"))
        module.traced("step.dispatch", lambda: 1)()
    finally:
        written = module.uninstall(save=True)
    return json.load(open(written))


def test_tracer_events_are_the_jax_events(tmp_path):
    ours, theirs = _spans(trace, tmp_path / "port.json"), _spans(jtrace, tmp_path / "jax.json")

    def strip(event):
        return {key: value for key, value in event.items() if key not in ("pid", "tid")}

    assert [strip(e) for e in ours["traceEvents"]] == [strip(e) for e in theirs["traceEvents"]]
    assert ours["displayTimeUnit"] == theirs["displayTimeUnit"]
    for key in ("run_id", "dropped_events"):
        assert ours["otherData"][key] == theirs["otherData"][key]
    assert ours["otherData"]["producer"] == "aggregathor_tpu_torch.obs.trace"
    trace.validate_chrome_trace(ours)
    jtrace.validate_chrome_trace(ours)


@pytest.fixture
def tracer(tmp_path):
    installed = trace.install(str(tmp_path / "out.trace.json"), run_id="test-run")
    yield installed
    trace.uninstall(save=False)


def test_span_nesting_and_chrome_schema(tracer):
    with trace.span("outer", cat="test", step=3):
        with trace.span("inner", cat="test"):
            pass
        trace.instant("tick", cat="test", k=1)
    payload = json.load(open(trace.save()))
    events = trace.validate_chrome_trace(payload)
    assert payload["otherData"]["run_id"] == "test-run"
    by_name = {e["name"]: e for e in events if e["ph"] in ("X", "i")}
    assert by_name["inner"]["args"] == {"parent": "outer", "depth": 1}
    assert by_name["outer"]["args"] == {"step": 3}
    assert by_name["tick"]["ph"] == "i" and by_name["tick"]["args"] == {"k": 1}
    outer, inner = by_name["outer"], by_name["inner"]
    assert outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1e-6


def test_span_decorator_and_error_annotation(tracer):
    @trace.span("work", cat="test")
    def work(x):
        return x + 1

    assert work(1) == 2
    with pytest.raises(ValueError):
        with trace.span("broken", cat="test"):
            raise ValueError("boom")
    events = {e["name"]: e for e in json.load(open(trace.save()))["traceEvents"]}
    assert events["work"]["ph"] == "X"
    assert events["broken"]["args"]["error"] == "ValueError"


def test_span_disabled_is_noop():
    assert trace.installed() is None
    with trace.span("nothing"):
        pass
    trace.instant("nothing")
    assert trace.save() is None and trace.uninstall() is None


def test_span_thread_safety(tracer):
    errors = []

    def worker(tid):
        try:
            for _ in range(50):
                with trace.span("outer-%d" % tid, cat="t"):
                    with trace.span("inner-%d" % tid, cat="t"):
                        pass
        except Exception as exc:  # pragma: no cover
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert not errors
    spans = [e for e in trace.validate_chrome_trace(json.load(open(trace.save()))) if e["ph"] == "X"]
    assert len(spans) == 8 * 50 * 2
    for event in spans:
        if event["name"].startswith("inner-"):
            assert event["args"]["parent"] == "outer-%s" % event["name"].split("-")[1]


def test_trace_event_cap_counts_drops(tmp_path, monkeypatch):
    monkeypatch.setattr(trace, "MAX_EVENTS", 10)
    tracer = trace.Tracer(str(tmp_path / "cap.json"))
    for i in range(50):
        tracer.instant("e%d" % i)
    assert tracer.nb_events <= 10
    payload = json.load(open(tracer.save()))
    assert payload["otherData"]["dropped_events"] > 0
    trace.validate_chrome_trace(payload)


@pytest.mark.parametrize("payload", [
    {"notTraceEvents": []},
    {"traceEvents": [{"ph": "X", "name": "x"}]},
    {"traceEvents": [{"ph": "X", "name": "x", "pid": 1, "tid": 1, "ts": 0.0, "dur": -5.0}]},
    {"traceEvents": [{"ph": "C", "name": "c", "pid": 1, "tid": 0, "ts": 0.0, "args": {}}]},
    {"traceEvents": [{"ph": "i", "name": "i", "pid": 1, "tid": 0, "ts": 1.0}]},
], ids=["no-events", "missing-keys", "negative-dur", "empty-counter", "valid-instant"])
def test_validate_chrome_trace_agrees_with_jax(payload):
    def verdict(validate):
        try:
            validate(payload)
            return "ok"
        except ValueError:
            return "refused"

    assert verdict(trace.validate_chrome_trace) == verdict(jtrace.validate_chrome_trace)


def test_two_tracers_on_one_path_do_not_clobber(tmp_path):
    path = str(tmp_path / "shared.json")
    first = trace.Tracer(path, run_id="a")
    second = trace.Tracer(path, run_id="b")
    assert first.path == path and second.path != path


# --------------------------------------------------------------------- #
# the live exporter


def test_live_exporter_scrape_roundtrip():
    reg = metrics.MetricsRegistry()
    reg.counter("fl_test_total", "x").inc(3)
    server = live.LiveExporter(registry=reg, run_id="live-test",
                               status_provider=lambda: {"step": 12, "flight": {"rows": 4}})
    host, port = server.serve_background()
    base = "http://%s:%d" % (host, port)
    try:
        text = urllib.request.urlopen(base + "/metrics", timeout=10).read().decode()
        samples = dict((n, v) for n, _, v in metrics.parse_prometheus(text)["fl_test_total"]["samples"])
        assert samples["fl_test_total"] == 3.0
        snap = json.loads(urllib.request.urlopen(base + "/metrics?format=json", timeout=10).read())
        assert snap["fl_test_total"] == 3.0
        status = json.loads(urllib.request.urlopen(base + "/status", timeout=10).read())
        assert status["run_id"] == "live-test" and status["step"] == 12 and status["flight"] == {"rows": 4}
        assert json.loads(urllib.request.urlopen(base + "/healthz", timeout=10).read())["status"] == "ok"
        for bad in ("/nope", "/metrics?format=xml"):
            with pytest.raises(urllib.error.HTTPError):
                urllib.request.urlopen(base + bad, timeout=10)
        scrapes = reg.counter("live_scrapes_total", labelnames=("endpoint",))
        assert scrapes.labels(endpoint="metrics").value == 3.0
    finally:
        server.shutdown_all()
    assert "live_scrapes_total" not in reg.snapshot()


def test_live_exporter_status_provider_error_degrades():
    def broken():
        raise RuntimeError("loop state gone")

    server = live.LiveExporter(registry=metrics.MetricsRegistry(), status_provider=broken)
    host, port = server.serve_background()
    try:
        status = json.loads(urllib.request.urlopen("http://%s:%d/status" % (host, port), timeout=10).read())
        assert status["error"] == "loop state gone"
    finally:
        server.shutdown_all()


# --------------------------------------------------------------------- #
# the registry-backed perf report


def test_perf_report_exports_the_jax_instruments(monkeypatch):
    class Clock:
        now = 0.0

    def run(module, registry):
        monkeypatch.setattr(module.time, "monotonic", lambda: Clock.now)
        Clock.now = 0.0
        report = module.PerfReport(registry=registry)
        for elapsed, steps in ((2.0, 1), (0.04, 4), (0.4, 4), (0.02, 1)):
            report.step_begin()
            Clock.now += elapsed
            report.step_end(steps)
        return report

    ours, theirs = metrics.MetricsRegistry(), jmetrics.MetricsRegistry()
    first = run(perf, ours)
    run(jperf, theirs)
    assert ours.render_prometheus() == theirs.render_prometheus()
    assert ours.snapshot()["train_steps_total"] == 10.0
    assert ours.histogram("train_step_latency_seconds").count == 3  # the first call left out
    second = perf.PerfReport(registry=ours)
    assert second.latency.count == 0 and first.latency.count == 3  # a fresh reservoir a run


# --------------------------------------------------------------------- #
# the GAR probe


@pytest.mark.parametrize("rule, n, f", [("krum", 8, 2), ("median", 8, 2), ("bulyan", 11, 2)])
def test_gar_probe_matches_the_jax_rule(rule, n, f):
    d = 257
    engine = RobustEngine(gars.instantiate(rule, n, f), n, device="cpu")
    probe = engine.build_gar_probe(d, seed=3)
    assert probe.rows.shape == (n, d) and probe.rows.dtype == torch.float32
    rows = np.random.default_rng(7).normal(size=(n, d)).astype(np.float32)
    probe.rows = torch.from_numpy(rows)
    jgar = jgars.instantiate(rule, n, f)
    block = jnp.asarray(rows)
    dist2 = jnp.maximum(jax_distances(block), 0.0) if jgar.needs_distances else None
    want = np.asarray(jgar._call_aggregate(block, dist2))
    got = probe(5).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_gar_probe_is_deterministic_per_step():
    engine = RobustEngine(gars.instantiate("krum", 8, 2), 8, device="cpu")
    probe = engine.build_gar_probe(96)
    again = engine.build_gar_probe(96)
    assert torch.equal(probe.rows, again.rows)  # the same seeded draw
    assert torch.equal(probe(3), probe(3)) and torch.equal(probe(3), again(3))
    assert bool(torch.all(torch.isfinite(probe(0))))
    assert not torch.equal(engine.build_gar_probe(96, seed=1).rows, probe.rows)
