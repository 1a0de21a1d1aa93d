"""The port's observability modules against the JAX package's, on the CPU.

Each JAX object and its port are fed the same scripted steps and clock
readings (``time.monotonic`` replaced by a script both modules read), and
their decisions are compared one by one:

- ``CadenceTrigger``: step delta, wall period, both, disabled, first fire;
- ``Checkpoints``: which snapshots exist after each save and prune under a
  pin, ``discard_after``; the port's own round trip (params, optimizer
  state, step and seed come back bit for bit, in place), the CLEVER carry
  left out, background writes equal to foreground ones, a failing write
  surfacing at ``wait``, ``wait(shutdown=True)`` retiring its thread, and a
  restore into a state of other names, shapes, dtypes or optimizer raising
  ``UserException``;
- ``EvalFile`` rows and ``truncate_after``; ``SummaryWriter`` lines
  (non-finite values as ``null``, the ``run_id`` stamped on every line);
- ``LatencyHistogram`` percentiles and ``PerfReport``'s accounting, per run,
  and its registry export (the JAX report's histogram and counters).
"""

import json
import os
import time

import numpy as np
import pytest
import torch

from aggregathor_tpu.obs import cadence as jcadence
from aggregathor_tpu.obs import checkpoint as jcheckpoint
from aggregathor_tpu.obs import evalfile as jevalfile
from aggregathor_tpu.obs import perf as jperf
from aggregathor_tpu.obs import summaries as jsummaries
from aggregathor_tpu_torch.core import TrainState, build_optimizer, build_schedule
from aggregathor_tpu_torch.obs import cadence, checkpoint, evalfile, perf, summaries
from aggregathor_tpu_torch.utils import UserException

from torch_threads import pinned_threads  # noqa: F401  (a fixture: the xdist worker's intra-op pool)


class Clock:
    """A scripted ``time.monotonic``."""

    def __init__(self):
        self.now = 100.0

    def __call__(self):
        return self.now


@pytest.fixture
def clock(monkeypatch):
    c = Clock()
    monkeypatch.setattr(time, "monotonic", c)
    return c


@pytest.mark.parametrize("delta, period", [(10, -1.0), (-1, 5.0), (3, 2.5), (-1, -1.0), (0, -1.0), (-1, 0.0)])
def test_cadence_decisions_match_jax(clock, delta, period):
    ours, theirs = cadence.CadenceTrigger(delta, period), jcadence.CadenceTrigger(delta, period)
    assert ours.enabled == theirs.enabled
    rng = np.random.default_rng(delta * 7 + int(period * 4) + 50)
    decisions = []
    step = 0
    for _ in range(200):
        step += int(rng.integers(0, 3))
        clock.now += float(rng.uniform(0.0, 1.5))
        a, b = ours.should_fire(step), theirs.should_fire(step)
        assert a == b, (step, clock.now)
        decisions.append(a)
        if a:
            ours.fired(step)
            theirs.fired(step)
        assert ours.last_step == theirs.last_step
    if ours.enabled:
        assert decisions[0]  # the first check fires
        assert 1 < sum(decisions) < len(decisions) or delta == 0 or period == 0.0
    else:
        assert not any(decisions)


def test_cadence_delta_and_period():
    trig = cadence.CadenceTrigger(delta=10, period=-1.0)
    assert trig.should_fire(0)
    trig.fired(0)
    assert not trig.should_fire(9) and trig.should_fire(10)
    trig.fired(10)
    assert not trig.should_fire(19) and trig.should_fire(25)
    trig = cadence.CadenceTrigger(delta=-1, period=0.0)
    trig.fired(0)
    assert trig.should_fire(1)
    assert not cadence.CadenceTrigger().enabled and not cadence.CadenceTrigger().should_fire(0)


def _state(value=0.0, hidden=3, optimizer="adam", dtype=torch.float32, carry=None):
    params = {"hidden.weight": torch.full((hidden, 4), value, dtype=dtype).requires_grad_(True),
              "hidden.bias": torch.zeros(hidden, dtype=dtype).requires_grad_(True)}
    tx = build_optimizer(optimizer, build_schedule("fixed", []))
    state = TrainState(params=params, opt_state=tx.init(params), step=0, seed=0, carry=carry)
    return state, tx


def _take_step(state, tx, value):
    grads = {name: torch.full_like(p, value) for name, p in state.params.items()}
    tx.apply(state.params, grads, state.opt_state)
    state.step += 1


def _equal_trees(a, b):
    assert a.keys() == b.keys()
    for key in a:
        if isinstance(a[key], dict):
            _equal_trees(a[key], b[key])
        elif isinstance(a[key], torch.Tensor):
            assert a[key].dtype == b[key].dtype and torch.equal(a[key], b[key])
        else:
            assert a[key] == b[key]


def test_checkpoint_round_trip_is_bit_exact_and_in_place(tmp_path):
    state, tx = _state(1.5)
    state.seed = 7
    for g in (0.25, -1.0, 3.0):
        _take_step(state, tx, g)
    ckpts = checkpoint.Checkpoints(str(tmp_path), "model", max_to_keep=2)
    assert not ckpts.can_restore()
    with pytest.raises(UserException):
        ckpts.restore(state)
    ckpts.save(state, 3)
    saved_params = {k: v.detach().clone() for k, v in state.params.items()}
    _take_step(state, tx, 5.0)  # the live state moves on after the save

    fresh, _ = _state(9.9)
    live = fresh.params["hidden.weight"]
    restored, step = ckpts.restore(fresh)
    assert step == 3 and restored is fresh and restored.step == 3 and restored.seed == 7
    assert restored.params["hidden.weight"] is live and live.requires_grad  # loaded in place
    _equal_trees({k: v.detach() for k, v in restored.params.items()}, saved_params)
    assert restored.opt_state["count"] == 3
    snapshot = torch.load(os.path.join(str(tmp_path), "model-3.ckpt"), weights_only=True)
    assert set(snapshot) == {"step", "seed", "params", "opt_state"}
    _equal_trees(restored.opt_state, snapshot["opt_state"])


def test_checkpoint_excludes_the_clever_carry(tmp_path):
    big = torch.ones((4, 1 << 16))
    state, _ = _state(2.5, carry=big)
    path = checkpoint.Checkpoints(str(tmp_path)).save(state, 3)
    assert os.path.getsize(path) < big.numel() * 4 // 2, "carry leaked into the snapshot"
    template, _ = _state(0.0, carry=torch.zeros_like(big))
    restored, _ = checkpoint.Checkpoints(str(tmp_path)).restore(template)
    assert torch.all(restored.params["hidden.weight"] == 2.5) and torch.all(restored.carry == 0)
    restored, _ = checkpoint.Checkpoints(str(tmp_path)).restore(_state(0.0)[0])
    assert restored.carry is None


def _jax_state():
    import optax

    from aggregathor_tpu.core import TrainState as JaxTrainState

    return JaxTrainState.create({"w": np.zeros(3, np.float32)}, optax.sgd(0.1))


@pytest.mark.parametrize("background", [False, True])
def test_checkpoint_prune_pin_and_discard_match_jax(tmp_path, background):
    ours = checkpoint.Checkpoints(str(tmp_path / "ours"), "model", max_to_keep=2, background=background)
    theirs = jcheckpoint.Checkpoints(str(tmp_path / "theirs"), "model", max_to_keep=2, background=background)
    state, jstate = _state()[0], _jax_state()
    script = [("save", 3), ("pin", 3), ("save", 7), ("save", 11), ("save", 15), ("pin", 15), ("save", 19),
              ("save", 23), ("discard", 19), ("save", 21), ("pin", None), ("save", 30)]
    for action, step in script:
        if action == "save":
            ours.save(state, step)
            theirs.save(jstate, step)
            ours.wait()
            theirs.wait()
        elif action == "pin":
            ours.pin(step)
            theirs.pin(step)
        else:
            assert ours.discard_after(step) == theirs.discard_after(step)
        assert ours.steps() == theirs.steps(), (action, step)
        assert ours.pinned_step() == theirs.pinned_step()
    assert ours.steps() == [21, 30]
    assert ours.restore(state)[1] == 30 and ours.restore(state, 21)[1] == 21
    with pytest.raises(UserException):
        ours.restore(state, 3)
    ours.wait(shutdown=True)
    theirs.wait(shutdown=True)


def test_background_checkpoints_equal_foreground_ones(tmp_path):
    state, tx = _state(0.5)
    _take_step(state, tx, 1.0)
    checkpoint.Checkpoints(str(tmp_path / "sync")).save(state, 7)
    bg = checkpoint.Checkpoints(str(tmp_path / "bg"), background=True)
    bg.save(state, 7)
    _take_step(state, tx, 100.0)  # the copy was taken in save(): this step must not reach the file
    bg.wait()
    a = open(os.path.join(str(tmp_path / "sync"), "model-7.ckpt"), "rb").read()
    b = open(os.path.join(str(tmp_path / "bg"), "model-7.ckpt"), "rb").read()
    assert a == b
    # a failing write surfaces at wait(), not silently
    bad_dir = str(tmp_path / "bad")
    bad = checkpoint.Checkpoints(bad_dir, background=True)
    os.rmdir(bad_dir)
    open(bad_dir, "w").close()
    bad.save(state, 9)
    with pytest.raises((OSError, RuntimeError)):  # torch.save reports a missing directory as RuntimeError
        bad.wait()
    bad.wait(shutdown=True)


def test_checkpoint_wait_shutdown_retires_its_thread(tmp_path):
    state, _ = _state()
    ckpt = checkpoint.Checkpoints(str(tmp_path / "c"), background=True)
    ckpt.save(state, 1)
    ckpt.wait()
    assert ckpt._pool is not None
    pool = ckpt._pool
    ckpt.save(state, 2)
    ckpt.wait(shutdown=True)
    assert ckpt._pool is None and all(not t.is_alive() for t in pool._threads)
    assert ckpt.steps() == [1, 2]


@pytest.mark.parametrize("other", [dict(hidden=5), dict(dtype=torch.float64), dict(optimizer="sgd"),
                                   dict(rename=True), dict(garbage=True), dict(torn=True)])
def test_restore_into_a_mismatched_state_raises(tmp_path, other):
    state, _ = _state(1.0)
    ckpts = checkpoint.Checkpoints(str(tmp_path))
    path = ckpts.save(state, 4)
    if other.pop("garbage", False):
        with open(path, "wb") as fd:
            fd.write(b"not a checkpoint")
    if other.pop("torn", False):
        data = open(path, "rb").read()
        with open(path, "wb") as fd:
            fd.write(data[: len(data) // 2])
    template, _ = _state(-1.0, **{k: v for k, v in other.items() if k != "rename"})
    if other.get("rename"):
        template.params["logits.bias"] = template.params.pop("hidden.bias")
    before = {k: v.detach().clone() for k, v in template.params.items()}
    with pytest.raises(UserException):
        ckpts.restore(template)
    _equal_trees({k: v.detach() for k, v in template.params.items()}, before)  # nothing loaded


def test_unported_checkpoint_options_refuse(tmp_path):
    """A snapshot saved without a tag, encryption or a custody manifest is
    refused by a manager that expects one (fail-closed, as in JAX), and
    nothing is loaded."""
    from aggregathor_tpu_torch.parallel.auth import GradientAuthenticator
    from aggregathor_tpu_torch.parallel.crypto import SnapshotCipher
    from aggregathor_tpu_torch.secure import ChainOfCustody

    state, _ = _state(1.0)
    checkpoint.Checkpoints(str(tmp_path)).save(state, 4)
    for name, value, message in (
            ("authenticator", GradientAuthenticator(b"s", 1, context=b"ckpt"), "no authentication tag"),
            ("cipher", SnapshotCipher(b"s"), "not encrypted"),
            ("custody", ChainOfCustody(b"s"), "no custody manifest")):
        template, _ = _state(-1.0)
        before = {k: v.detach().clone() for k, v in template.params.items()}
        with pytest.raises(UserException, match=message):
            checkpoint.Checkpoints(str(tmp_path), **{name: value}).restore(template)
        _equal_trees({k: v.detach() for k, v in template.params.items()}, before)


def test_eval_file_rows_match_jax(tmp_path):
    rows = []
    for module, name in ((evalfile, "ours"), (jevalfile, "theirs")):
        path = str(tmp_path / name)
        ef = module.EvalFile(path)
        for step in (1, 5, 9):
            ef.append(step, {"accuracy": step / 10.0, "cross-entropy": 1.25, "regime": 2})
        assert ef.truncate_after(5) == 1
        ef.append(6, {"accuracy": 0.5, "cross-entropy": 1.0, "regime": 0})
        ef.close()
        rows.append([line.split("\t")[1:] for line in open(path).read().splitlines()])
        for line in open(path):
            float(line.split("\t")[0])  # the wall time parses
    assert rows[0] == rows[1]
    assert [row[0] for row in rows[0]] == ["1", "5", "6"]
    assert "accuracy:0.5" in rows[0][2] and "regime:0" in rows[0][2]


def test_summary_lines_match_jax(tmp_path):
    values = {"loss": float("nan"), "grad_norm": 2.0, "worker_sq_dist": np.array([1.0, np.nan, np.inf, 4.0]),
              "suspect_worker": np.int64(3), "steps_per_s": float("inf")}
    lines = []
    for module, name in ((summaries, "ours"), (jsummaries, "theirs")):
        writer = module.SummaryWriter(str(tmp_path / name), run_name="t", run_id="rid")
        writer.scalars(3, values)
        writer.event(4, "chaos_regime_switch", {"run_id": "spoofed", "spec": "calm"})
        writer.close()
        text = open(writer.path).read()
        parsed = [json.loads(line, parse_constant=lambda s: pytest.fail("bare %s token" % s))
                  for line in text.splitlines()]
        for line in parsed:
            line.pop("wall")
        lines.append(parsed)
    assert lines[0] == lines[1]
    assert lines[0][0]["loss"] is None and lines[0][0]["worker_sq_dist"] == [1.0, None, None, 4.0]
    assert lines[0][0]["suspect_worker"] == 3 and [line["run_id"] for line in lines[0]] == ["rid", "rid"]
    auto = summaries.SummaryWriter(str(tmp_path / "auto"))
    assert auto.run_id and auto.run_id != summaries.make_run_id()
    auto.close()
    disabled = summaries.SummaryWriter(None)
    disabled.scalars(1, {"loss": 1.0})  # no-op
    assert disabled.path is None


def test_latency_histogram_matches_jax():
    ours, theirs = perf.LatencyHistogram(capacity=16, seed=3), jperf.LatencyHistogram(capacity=16, seed=3)
    assert ours.percentiles() is None and theirs.percentiles() is None
    rng = np.random.default_rng(1)
    for value in rng.exponential(size=500):
        ours.record(value)
        theirs.record(value)
        assert ours.percentiles() == theirs.percentiles()
    assert ours.count == theirs.count == 500
    with pytest.raises(ValueError):
        perf.LatencyHistogram(capacity=0)


def test_perf_report_accounting_matches_jax(clock, capsys):
    ours, theirs = perf.PerfReport(), jperf.PerfReport()
    durations = [2.0, 0.01, 0.02, 0.015, 0.5, 0.01]
    for i, seconds in enumerate(durations):
        clock.now += 0.003  # off-graph: batches between steps
        ours.step_begin()
        theirs.step_begin()
        clock.now += seconds
        ours.step_end()
        theirs.step_end()
        if i == 2:
            clock.now += 1.0  # an evaluation
    for name in ("nb_steps", "first_step_s", "in_graph_s"):
        assert getattr(ours, name) == getattr(theirs, name)
    assert ours.latency.percentiles() == theirs.latency.percentiles()
    assert ours.steps_per_s_excl_first() == theirs.steps_per_s_excl_first()
    summary = ours.report()
    assert summary["in_graph_s"] + summary["off_graph_s"] == pytest.approx(summary["total_s"])
    assert summary["first_step_s"] == 2.0 and summary["latency"]["p99"] == 0.5
    out = capsys.readouterr().out
    theirs.report()
    assert capsys.readouterr().out == out  # the same report, line for line
    assert "in-graph time" in out and "off-graph time" in out and "steps/s (excl. 1st)" in out


def test_perf_percentiles_are_per_run(clock):
    first = perf.PerfReport()
    for _ in range(3):
        first.step_begin()
        clock.now += 0.1
        first.step_end()
    assert first.latency.count == 2  # the first step is left out
    assert perf.PerfReport().latency.count == 0  # a fresh reservoir a run
    # registry-backed: the JAX report's histogram and counters, cumulative
    # over the process while each report keeps its own reservoir
    from aggregathor_tpu.obs.metrics import MetricsRegistry as JaxRegistry
    from aggregathor_tpu_torch.obs.metrics import MetricsRegistry

    ours, theirs = MetricsRegistry(), JaxRegistry()
    for module, registry in ((perf, ours), (jperf, theirs)):
        for _ in range(2):
            report = module.PerfReport(registry=registry)
            for _ in range(3):
                report.step_begin()
                clock.now += 0.1
                report.step_end()
            assert report.latency.count == 2
    assert ours.render_prometheus() == theirs.render_prometheus()
    assert ours.histogram("train_step_latency_seconds").count == 4
    assert ours.counter("train_steps_total").value == 6.0
