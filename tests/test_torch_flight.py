"""The port's flight recorder against the JAX package's ``obs/flight.py``.

- The ring holds, bit for bit, what the per-step metrics hold, at
  ``--unroll`` 1 and 8 (the recorder copies the metrics' own values).
- Fed the same per-step values, the port's ring and the JAX package's
  fetch the same window: partial fill, wraparound, empty slots dropped.
- Beside the JAX engine on the same run (the MLP, ``hidden:16``, n = 8,
  krum under a deviation-100 gaussian attack, which is caught and
  quarantined): the step lanes identical, the integer lanes identical, the
  float lanes rtol 1e-5 (the losses and distances in another summation
  order).
- ``dump_window``/``load_window`` round-trip non-finite values as the JAX
  package's tagged strings, ``summarize_window`` gives the JAX package's
  view, and the recorder refuses the lanes whose sources the engine lacks.
- A restore empties the ring and resets the other side buffers; the runner
  dumps the ring when a run diverges.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aggregathor_tpu import gars as jgars
from aggregathor_tpu import models as jmodels
from aggregathor_tpu.core import build_optimizer as jax_optimizer
from aggregathor_tpu.core import build_schedule as jax_schedule
from aggregathor_tpu.obs import flight as jflight
from aggregathor_tpu.parallel import RobustEngine as JaxEngine
from aggregathor_tpu.parallel import attacks as jattacks
from aggregathor_tpu.parallel import make_mesh
from aggregathor_tpu_torch import gars as tgars
from aggregathor_tpu_torch import models as tmodels
from aggregathor_tpu_torch.cli import runner
from aggregathor_tpu_torch.core import build_optimizer, build_schedule, host_snapshot, load_snapshot
from aggregathor_tpu_torch.guardian.probe import EMA_UNSET
from aggregathor_tpu_torch.models.common import params_from_jax
from aggregathor_tpu_torch.obs import flight
from aggregathor_tpu_torch.parallel import RobustEngine, attacks
from aggregathor_tpu_torch.utils import UserException

from torch_threads import pinned_threads  # noqa: F401  (a fixture: the xdist worker's intra-op pool)

MLP = ("mnist", ["hidden:16", "batch-size:16"])


def _engine(capacity, n=8, **options):
    recorder = flight.FlightRecorder(capacity, n, worker_metrics=True)
    engine = RobustEngine(tgars.instantiate("krum", n, 2), n, nb_real_byz=2,
                          attack=attacks.instantiate("gaussian", n, 2, ["deviation:100"]), worker_metrics=True,
                          reputation_decay=0.5, quarantine_threshold=0.4, flight=recorder, device="cpu", **options)
    exp = tmodels.instantiate(*MLP)
    tx = build_optimizer("sgd", build_schedule("fixed", ["initial-rate:0.05"]))
    return exp, engine, tx, engine.init_state(exp.init(0), tx, seed=1)


def _lanes_of(metrics):
    """The lanes' sources in a step's (or a chunk's stacked) metrics."""
    probe = metrics["probe"]
    return {"loss": metrics["total_loss"], "update_norm": metrics["grad_norm"], "spike": probe["spike"],
            "loss_finite": probe["loss_finite"], "worker_nan": probe["worker_nan_rows"],
            "worker_sq_dist": metrics["worker_sq_dist"]}


@pytest.mark.parametrize("unroll", [1, 8])
def test_ring_rows_are_the_step_metrics_bit_for_bit(unroll):
    exp, engine, tx, state = _engine(16)
    it = exp.make_train_iterator(8, seed=2)
    if unroll == 1:
        step = engine.build_step(exp.loss, tx)
        per_step = []
        for _ in range(8):
            state, metrics = step(state, engine.put_batch(next(it)))
            per_step.append(metrics)
        stacked = {name: torch.stack([value[name] for value in map(_lanes_of, per_step)])
                   for name in _lanes_of(per_step[0])}
    else:
        multi = engine.build_multi_step(exp.loss, tx)
        state, metrics = multi(state, engine.put_batches(it.next_many(8)))
        stacked = _lanes_of(metrics)
    window = engine.flight.fetch(state.flight)
    np.testing.assert_array_equal(window["step"], np.arange(8))
    for name, value in stacked.items():
        want = value.numpy()
        assert window[name].dtype == want.dtype, name
        np.testing.assert_array_equal(window[name].view(np.uint32) if want.dtype == np.float32 else window[name],
                                      want.view(np.uint32) if want.dtype == np.float32 else want, err_msg=name)
    assert int(window["worker_nan"].sum()) == 0 and np.isnan(window["worker_sq_dist"][-1, :2]).all()


def _synthetic_metrics(step, n):
    gen = np.random.default_rng(step)
    loss = np.float32(np.nan if step == 5 else gen.standard_normal())
    return {"total_loss": loss, "grad_norm": np.float32(np.inf if step == 6 else gen.random()),
            "probe": {"spike": np.float32(gen.random()), "loss_finite": np.int32(step != 5),
                      "worker_nan_rows": (gen.random(n) < 0.3).astype(np.int32)},
            "worker_sq_dist": gen.random(n).astype(np.float32)}


@pytest.mark.parametrize("steps", [0, 3, 7, 19])
def test_fetch_follows_jax_through_partial_fill_and_wraparound(steps):
    n, capacity = 4, 7
    jrec = jflight.FlightRecorder(capacity, n, worker_metrics=True)
    trec = flight.FlightRecorder(capacity, n, worker_metrics=True)
    jbuf, tbuf = jrec.init_buffers(), trec.init_buffers()
    for s in range(steps):
        metrics = _synthetic_metrics(s, n)
        jbuf = jrec.record(jbuf, jnp.int32(s), jax.tree_util.tree_map(jnp.asarray, metrics))
        trec.record(tbuf, s, jax.tree_util.tree_map(torch.as_tensor, metrics))
    want, got = jrec.fetch(jbuf), trec.fetch(tbuf)
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    assert got["step"].size == min(steps, capacity)
    assert flight.summarize_window(got) == jflight.summarize_window(want)


def test_ring_follows_the_jax_engine(monkeypatch):
    monkeypatch.setenv("GRAFT_GAR_TIER", "pallas")
    n, capacity = 8, 4
    jexp, texp = jmodels.instantiate(*MLP), tmodels.instantiate(*MLP)
    jtx = jax_optimizer("sgd", jax_schedule("fixed", ["initial-rate:0.05"]))
    ttx = build_optimizer("sgd", build_schedule("fixed", ["initial-rate:0.05"]))
    options = dict(nb_real_byz=2, worker_metrics=True, reputation_decay=0.5, quarantine_threshold=0.4)
    jengine = JaxEngine(make_mesh(nb_workers=1), jgars.instantiate("krum", n, 2), nb_workers=n,
                        attack=jattacks.instantiate("signflip", n, 2),
                        flight=jflight.FlightRecorder(capacity, n, worker_metrics=True), **options)
    tengine = RobustEngine(tgars.instantiate("krum", n, 2), n, attack=attacks.instantiate("signflip", n, 2),
                           flight=flight.FlightRecorder(capacity, n, worker_metrics=True), device="cpu", **options)
    init = jexp.init(jax.random.PRNGKey(11))
    jstep, tstep = jengine.build_step(jexp.loss, jtx), tengine.build_step(texp.loss, ttx)
    jstate = jengine.init_state(init, jtx, seed=1)
    tstate = tengine.init_state(params_from_jax(jax.tree_util.tree_map(np.asarray, init)), ttx, seed=1)
    it = jexp.make_train_iterator(n, seed=2)
    for _ in range(6):
        batch = next(it)
        jstate, _ = jstep(jstate, jengine.shard_batch(batch))
        tstate, _ = tstep(tstate, tengine.put_batch(batch))
    want, got = jengine.flight.fetch(jstate.flight), tengine.flight.fetch(tstate.flight)
    assert sorted(got) == sorted(want)
    np.testing.assert_array_equal(got["step"], [2, 3, 4, 5])
    for name in want:
        if want[name].dtype == np.int32:
            np.testing.assert_array_equal(got[name], want[name], err_msg=name)
        else:
            np.testing.assert_allclose(got[name], want[name], rtol=1e-5, err_msg=name)


def test_dump_and_load_round_trip_non_finite_values(tmp_path):
    window = {"step": np.arange(3, dtype=np.int32), "loss": np.array([1.5, np.nan, np.inf], np.float32),
              "update_norm": np.array([-np.inf, 2.0, 3.0], np.float32),
              "worker_nan": np.array([[0, 1], [1, 1], [0, 0]], np.int32),
              "worker_sq_dist": np.array([[np.nan, 1.0], [2.0, np.inf], [0.5, 0.25]], np.float32)}
    path = str(tmp_path / "sub" / "flight.json")
    doc = flight.dump_window(path, window, run_id="r", reason="divergence", capacity=8, extra={"at_step": 3})
    loaded = flight.load_window(path)
    assert loaded == json.loads(json.dumps(doc))
    assert loaded["schema"] == "aggregathor.obs.flight.v1" == jflight.SCHEMA
    assert loaded["lanes"]["loss"] == [1.5, "nan", "inf"] and loaded["lanes"]["update_norm"][0] == "-inf"
    assert loaded["lanes"]["worker_sq_dist"][1] == [2.0, "inf"] and loaded["step_range"] == [0, 2]
    assert jflight.load_window(path)["lanes"] == loaded["lanes"]
    jdoc = jflight.dump_window(str(tmp_path / "jax.json"), window, run_id="r", reason="divergence", capacity=8,
                               extra={"at_step": 3})
    assert {k: v for k, v in jdoc.items() if k != "written_at"} == {k: v for k, v in doc.items() if k != "written_at"}
    with open(path, "w") as fd:
        json.dump({"schema": "other", "lanes": {}}, fd)
    with pytest.raises(ValueError):
        flight.load_window(path)


def test_recorder_refuses_lanes_without_a_source():
    gar = tgars.instantiate("krum", 8, 2)
    for recorder, options in ((flight.FlightRecorder(4, 8, chaos=True), {}),
                              (flight.FlightRecorder(4, 8, secure=True), {}),
                              (flight.FlightRecorder(4, 8, worker_metrics=True), {}),
                              (flight.FlightRecorder(4, 7), {}),
                              (flight.FlightRecorder(4, 8), {"health_probe": False})):
        with pytest.raises(UserException):
            RobustEngine(gar, 8, flight=recorder, device="cpu", **options)
    for bad in ((0, 8), (4, 0)):
        with pytest.raises(UserException):
            flight.FlightRecorder(*bad)
    assert RobustEngine(gar, 8, flight=flight.FlightRecorder(4, 8), device="cpu").flight.capacity == 4


def test_restore_empties_the_ring_and_resets_the_side_buffers():
    exp, engine, tx, state = _engine(4, worker_momentum=0.9)
    step = engine.build_step(exp.loss, tx)
    it = exp.make_train_iterator(8, seed=2)
    snapshot = host_snapshot(state)
    assert sorted(snapshot) == ["opt_state", "params", "seed", "step"]
    for _ in range(3):
        state, _ = step(state, engine.put_batch(next(it)))
    assert engine.flight.fetch(state.flight)["step"].size == 3 and float(state.reputation.min()) < 1.0
    load_snapshot(state, snapshot)
    assert engine.flight.fetch(state.flight)["step"].size == 0
    assert float(state.loss_ema) == EMA_UNSET and bool(torch.all(state.reputation == 1.0))
    assert state.momentum_steps == 0 and not bool(torch.any(state.momentum)) and state.step == 0
    fresh = engine.init_state(exp.init(0), tx, seed=1)
    for name, lane in fresh.flight.items():
        assert torch.equal(lane.isnan(), state.flight[name].isnan()), name
        assert torch.equal(torch.nan_to_num(lane), torch.nan_to_num(state.flight[name])), name


def test_runner_dumps_the_ring_when_the_run_diverges(tmp_path):
    path = str(tmp_path / "post.json")
    sum_dir = str(tmp_path / "sum")
    with pytest.raises(UserException, match="diverged"):
        runner.main(["--experiment", "mnist", "--experiment-args", "hidden:16", "batch-size:16",
                     "--aggregator", "average", "--nb-workers", "8", "--UDP", "1",
                     "--UDP-args", "drop-rate:1.0", "min-coords:0", "--flight", "16", "--flight-dump", path,
                     "--summary-dir", sum_dir, "--max-step", "6", "--evaluation-period", "-1", "--device", "cpu"])
    doc = flight.load_window(path)
    assert doc["reason"] == "divergence" and doc["capacity"] == 16 and doc["rows"] >= 2
    assert doc["lanes"]["loss_finite"][0] == 1 and doc["lanes"]["loss_finite"][-1] == 0
    assert doc["lanes"]["spike"][-1] == "inf" and doc["lanes"]["worker_nan"][0][0] == 1
    [name] = os.listdir(sum_dir)
    assert doc["run_id"] == json.loads(open(os.path.join(sum_dir, name)).readline())["run_id"]


def test_runner_summaries_count_the_ring_rows(tmp_path):
    sum_dir = str(tmp_path / "sum")
    runner.main(["--experiment", "mnist", "--experiment-args", "hidden:16", "batch-size:16", "--aggregator", "krum",
                 "--nb-workers", "8", "--nb-decl-byz-workers", "2", "--nb-real-byz-workers", "2",
                 "--attack", "gaussian", "--attack-args", "deviation:100", "--worker-metrics",
                 "--reputation-decay", "0.5", "--quarantine-threshold", "0.4", "--flight", "6",
                 "--summary-dir", sum_dir, "--summary-delta", "4", "--unroll", "2", "--max-step", "10",
                 "--evaluation-delta", "-1", "--evaluation-period", "-1", "--device", "cpu"])
    [name] = os.listdir(sum_dir)
    events = [json.loads(line) for line in open(os.path.join(sum_dir, name))]
    assert [event["step"] for event in events] == [2, 6, 10]
    assert [event["flight_rows"] for event in events] == [2, 6, 6]
    last = events[-1]
    assert last["nb_quarantined"] == 2 and last["worker_participation"][:2] == [0.0, 0.0]
    assert max(last["worker_reputation"][:2]) < 0.1 and min(last["worker_reputation"][2:]) > 0.9
