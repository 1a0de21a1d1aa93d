"""The port's deadline controller and host straggler model against the JAX package's.

- ``parallel/deadline.DeadlineController`` on the traces of JAX
  ``tests/test_deadline.py`` (steady, spiked, censored, grouped into units,
  clamped, a regime switch) and on seeded random and censored traces: the
  windows bit for bit, ``at_ceiling``, the censored and observed counts,
  the ``deadline_window`` journal byte for byte (injected clocks) and the
  registry's families and values equal the JAX controller's.
- ``parallel/bounded.HostStragglerModel.delay`` bit for bit over a grid of
  (seed, step, worker, rate, jitter), and under straggler schedules built by
  both packages; the same refusals.
"""

import itertools

import numpy as np
import pytest

from aggregathor_tpu.chaos import ChaosSchedule as JaxSchedule
from aggregathor_tpu.obs import events as jevents
from aggregathor_tpu.obs.metrics import MetricsRegistry as JaxRegistry
from aggregathor_tpu.parallel.bounded import HostStragglerModel as JaxModel
from aggregathor_tpu.parallel.deadline import ARRIVAL_BUCKETS as JAX_BUCKETS
from aggregathor_tpu.parallel.deadline import DeadlineController as JaxController
from aggregathor_tpu.utils import UserException as JaxUserException
from aggregathor_tpu_torch.chaos import ChaosSchedule
from aggregathor_tpu_torch.obs import events as tevents
from aggregathor_tpu_torch.obs.metrics import MetricsRegistry
from aggregathor_tpu_torch.parallel.bounded import HostStragglerModel
from aggregathor_tpu_torch.parallel.deadline import ARRIVAL_BUCKETS, DeadlineController
from aggregathor_tpu_torch.utils import UserException

from torch_threads import pinned_threads  # noqa: F401  (a fixture: the xdist worker's intra-op pool)


@pytest.fixture(autouse=True)
def _no_journal_leak():
    yield
    jevents.uninstall()
    tevents.uninstall()


def _steady(n=8, base=0.02, spread=0.01):
    return base + spread * np.arange(n) / n


def _censored(trace, workers):
    trace = np.array(trace, np.float64)
    trace[list(workers)] = np.inf
    return trace


def _random_traces(seed, rounds=60, n=8):
    """Seeded lognormal arrivals, a random share of them censored (inf or
    NaN), with a regime switch half way."""
    rng = np.random.default_rng(seed)
    traces = []
    for r in range(rounds):
        scale = 0.02 if r < rounds // 2 else 0.2
        trace = scale * np.exp(0.7 * rng.standard_normal(n))
        lost = rng.random(n) < 0.2
        trace[lost] = np.where(rng.random(lost.sum()) < 0.5, np.inf, np.nan)
        traces.append(trace)
    return traces


# (controller kwargs, the traces it observes, unit_size)
SCENARIOS = {
    "steady": (dict(initial=0.5, percentile=75.0, floor=0.001, ema=0.4), [_steady()] * 40, 1),
    "spike": (dict(initial=0.1, percentile=90.0, floor=0.001, ceiling=10.0, ema=0.25),
              [_steady()] * 50 + [_steady() * 100.0] + [_steady()] * 50, 1),
    "censored-ceiling": (dict(initial=0.1, percentile=90.0, floor=0.001, ceiling=0.4, ema=1.0),
                         [_censored(_steady(), (6, 7))], 1),
    "censored-below": (dict(initial=0.1, percentile=70.0, floor=0.001, ceiling=0.4, ema=1.0),
                       [_censored(_steady(), (6, 7))], 1),
    "units": (dict(initial=0.1, percentile=60.0, floor=0.001, ceiling=0.4, ema=1.0),
              [np.repeat([0.02, 0.03, 0.04, np.inf], 2)] * 3, 2),
    "units-censored": (dict(initial=0.1, percentile=80.0, floor=0.001, ceiling=0.4, ema=1.0),
                       [np.repeat([0.02, 0.03, 0.04, np.inf], 2)], 2),
    "demand": (dict(initial=0.3, percentile=90.0, floor=0.001, ceiling=0.3, ema=0.3),
               [_steady(base=0.01, spread=0.005)] * 20 + [_censored(_steady(), (6, 7)),
                                                          _steady(base=0.01, spread=0.005)], 1),
    "clamps": (dict(initial=0.1, percentile=50.0, floor=0.05, ceiling=0.2, ema=1.0),
               [np.full(8, 1e-4), np.full(8, 50.0)], 1),
    "regime-switch": (dict(initial=0.3, percentile=75.0, floor=0.005, ceiling=0.3, ema=0.4),
                      [_steady(base=0.01, spread=0.005)] * 20 + [_steady(base=0.15, spread=0.05)] * 20
                      + [_steady(base=0.01, spread=0.005)] * 20, 1),
    "random-71.4": (dict(initial=0.5, percentile=71.4, floor=0.02, ema=0.3), _random_traces(1), 1),
    "random-95": (dict(initial=0.25, percentile=95.0, floor=0.01, ceiling=1.0, ema=0.6), _random_traces(2), 1),
    "random-10": (dict(initial=0.05, percentile=10.0, floor=0.001, ema=1.0), _random_traces(3), 1),
}


def _clocks():
    wall = itertools.count(1_792_000_000.25, 0.125)
    mono = itertools.count(100.0, 0.0625)
    return (lambda: next(wall)), (lambda: next(mono))


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_controller_windows_events_and_registry_are_jax_bits(name, tmp_path):
    kwargs, traces, unit_size = SCENARIOS[name]
    runs = {}
    for label, controller_cls, registry_cls, events in (("jax", JaxController, JaxRegistry, jevents),
                                                        ("port", DeadlineController, MetricsRegistry, tevents)):
        path = str(tmp_path / ("%s.jsonl" % label))
        wall, mono = _clocks()
        events.install(path, run_id="deadline", wall_clock=wall, mono_clock=mono)
        registry = registry_cls()
        controller = controller_cls(registry=registry, **kwargs)
        trajectory = [(controller.window, controller.at_ceiling)]
        for step, trace in enumerate(traces):
            window = controller.observe_round(trace, step=step, unit_size=unit_size)
            trajectory.append((window, controller.at_ceiling, controller.censored_rounds,
                               controller.rounds_observed))
        events.uninstall()
        runs[label] = (trajectory, open(path, "rb").read(), registry.snapshot(), registry.render_prometheus())
    (want, want_journal, want_snapshot, want_text), (got, got_journal, got_snapshot, got_text) = (
        runs["jax"], runs["port"])
    assert [np.float64(entry[0]).view(np.int64) for entry in got] == [
        np.float64(entry[0]).view(np.int64) for entry in want]
    assert got == want
    assert got_journal == want_journal and got_journal.count(b"deadline_window") >= 1
    assert got_snapshot == want_snapshot
    assert got_text == want_text


def test_arrival_buckets_and_controller_refusals_are_jax():
    assert ARRIVAL_BUCKETS == JAX_BUCKETS
    for kwargs in (dict(initial=0.0), dict(initial=None), dict(initial=0.3, percentile=0.0),
                   dict(initial=0.3, percentile=101.0), dict(initial=0.3, floor=0.0),
                   dict(initial=0.3, floor=0.2, ceiling=0.1), dict(initial=0.3, ema=0.0),
                   dict(initial=0.3, ema=1.5)):
        with pytest.raises(UserException):
            DeadlineController(**kwargs)
        with pytest.raises(JaxUserException):
            JaxController(**kwargs)
    for controller in (DeadlineController(0.1), JaxController(0.1)):
        with pytest.raises((UserException, JaxUserException), match="units"):
            controller.observe_round(np.zeros(7), unit_size=2)


def test_straggler_delays_are_jax_bits_over_a_grid():
    for rate, jitter, eligible in itertools.product((0.0, 0.3, 0.5, 1.0), (0.0, 0.7, 2.0), (0, 3)):
        for seed in (0, 7, 2**31 + 5):
            model = HostStragglerModel(8, 0.5, rate=rate, nb_eligible=eligible, seed=seed, jitter=jitter)
            jmodel = JaxModel(8, 0.5, rate=rate, nb_eligible=eligible, seed=seed, jitter=jitter)
            got = np.array([model.delay(s, w) for s in range(12) for w in range(8)])
            want = np.array([jmodel.delay(s, w) for s in range(12) for w in range(8)])
            assert np.array_equal(got.view(np.int64), want.view(np.int64)), (rate, jitter, eligible, seed)
    # both outcomes and the lognormal tail occur
    model = HostStragglerModel(8, 0.5, rate=0.5, jitter=1.0, seed=7)
    draws = {model.delay(s, w) for s in range(20) for w in range(8)}
    assert 0.0 in draws and len(draws) > 20


@pytest.mark.parametrize("spec, args", [
    ("0:calm 10:straggle=1.0", ["straggle-workers:2"]),
    ("0:straggle=1.0 10:straggle=1.0,jitter=2.0", []),
    ("0:straggle=0.3,jitter=0.5 5:calm 9:straggle=0.8,straggle-mode=stale", ["straggle-workers:5"]),
])
def test_straggler_delays_under_a_schedule_are_jax_bits(spec, args):
    model = HostStragglerModel(8, 0.25, chaos=ChaosSchedule(spec, 8, args=args), seed=3)
    jmodel = JaxModel(8, 0.25, chaos=JaxSchedule(spec, 8, args=args), seed=3)
    assert model.nb_eligible == jmodel.nb_eligible
    got = np.array([model.delay(s, w) for s in range(30) for w in range(8)])
    want = np.array([jmodel.delay(s, w) for s in range(30) for w in range(8)])
    assert np.array_equal(got.view(np.int64), want.view(np.int64))
    assert np.any(got > 0)


@pytest.mark.parametrize("spec, kwargs", [
    ("0:attack=empire", dict(nb_real_byz=1)),   # attack regimes stay in the step
    ("0:drop=0.3", {}),                         # so does the drop storm
    ("0:forge=0.5", dict(nb_real_byz=1)),       # and forgery
    ("0:calm", {}),                             # no straggler regime at all
])
def test_straggler_model_refuses_like_jax(spec, kwargs):
    with pytest.raises(UserException):
        HostStragglerModel(4, 1.0, chaos=ChaosSchedule(spec, 4, **kwargs))
    with pytest.raises(JaxUserException):
        JaxModel(4, 1.0, chaos=JaxSchedule(spec, 4, **kwargs))


@pytest.mark.parametrize("kwargs", [dict(stall_seconds=0.0, rate=0.5), dict(stall_seconds=-1.0),
                                    dict(stall_seconds=1.0, rate=1.5), dict(stall_seconds=1.0, rate=0.5, jitter=-1.0)])
def test_straggler_model_argument_refusals_like_jax(kwargs):
    with pytest.raises(UserException):
        HostStragglerModel(4, **kwargs)
    with pytest.raises(JaxUserException):
        JaxModel(4, **kwargs)
