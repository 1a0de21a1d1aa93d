"""The port's chaos package (``chaos/``) against the JAX package's.

- The schedule grammar (JAX ``tests/test_chaos.py:53-205``): the same
  regimes, host arrays and family flags for a list of specs, the same
  refusals, gates (process and topology keys), ``regime_at``,
  ``describe``, ``transitions()`` and ``process_faults()``.
- ``replica_faults``: ``parse_poison`` and ``parse_process_targets`` as
  JAX's; ``corrupt_params`` bit for bit on the MLP's weights (the noise
  drawn in JAX's leaf order and layout).
- Stragglers: ``apply`` as JAX's given the same verdict; ``draw_late`` at
  rates 0 and 1 and its share at 0.3, keyed per (seed, step, worker).
- Engine steps against the JAX engine with the JAX drop and late masks
  injected (``ChaosSchedule.draw_drops``, ``StragglerModel.draw_late``):
  ``0:drop=0.2 4:attack=empire,epsilon=4.0 8:straggle=0.4,straggle-mode=stale``
  with average-nan, 12 steps, losses within rtol 1e-5 and the regime index
  identical every step; a local-attack regime (signflip) too.
- ``straggle=1.0,stale`` equals a CLEVER lossy link at drop-rate 1.0, carry
  included, bit for bit; the calm -> ``straggle=1.0,drop`` switch poisons
  plain average at exactly step 3 (JAX ``tests/test_chaos.py:207-227``);
  f always-late stragglers are absorbed by median and krum.
- The engine's refusals (with ``--attack``/``--UDP``, n and coalition
  mismatches; a forge/tamper schedule builds) and the flight recorder's
  ``chaos_regime`` lane.
- The runner: refusals as JAX's, and a ``--chaos`` run whose eval TSV
  ``chaos_regime`` column, summary regimes and ``chaos_regime_switch``
  events equal the JAX runner's (``--nb-devices 1``).
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from aggregathor_tpu import gars as jgars
from aggregathor_tpu import models as jmodels
from aggregathor_tpu.chaos import ChaosSchedule as JaxSchedule
from aggregathor_tpu.chaos import replica_faults as jfaults
from aggregathor_tpu.core import build_optimizer as jax_optimizer
from aggregathor_tpu.core import build_schedule as jax_schedule
from aggregathor_tpu.parallel import RobustEngine as JaxEngine
from aggregathor_tpu.parallel import make_mesh
from aggregathor_tpu.utils import UserException as JaxUserException
from aggregathor_tpu_torch import gars as tgars
from aggregathor_tpu_torch import models as tmodels
from aggregathor_tpu_torch.chaos import ChaosSchedule, StragglerModel
from aggregathor_tpu_torch.chaos import replica_faults
from aggregathor_tpu_torch.core import build_optimizer, build_schedule
from aggregathor_tpu_torch.models.common import params_from_jax
from aggregathor_tpu_torch.obs import metrics as obs_metrics
from aggregathor_tpu_torch.obs.flight import FlightRecorder
from aggregathor_tpu_torch.parallel import RobustEngine, attacks
from aggregathor_tpu_torch.parallel.lossy import LossyLink
from aggregathor_tpu_torch.utils import UserException

GOOD_SPECS = [
    ("0:calm 500:drop=0.3 1000:attack=empire,epsilon=4.0 1500:straggle=0.25,straggle-mode=stale", 8, 2, []),
    ("40:attack=signflip,scale=2.0 0:calm", 4, 1, []),
    ("0:calm 10:straggle=0.5,jitter=1.5 20:straggle=1.0", 8, 0, []),
    ("100:drop=0.5", 4, 0, ["packet-coords:64", "min-coords:10", "straggle-workers:2"]),
    ("0:attack=little 3:attack=gaussian,deviation=5.0 7:calm", 8, 2, []),
]


@pytest.mark.parametrize("spec, n, r, args", GOOD_SPECS)
def test_schedule_parses_as_jax(spec, n, r, args):
    mine, theirs = ChaosSchedule(spec, n, nb_real_byz=r, args=args), JaxSchedule(spec, n, nb_real_byz=r, args=args)
    assert len(mine) == len(theirs) and mine.transitions() == theirs.transitions()
    for name in ("_starts", "_drop_rates", "_straggler_rates", "_straggler_stale", "_straggler_jitter",
                 "_forge_rates", "_tamper_rates"):
        assert np.array_equal(getattr(mine, name), getattr(theirs, name)), name
        assert getattr(mine, name).dtype == getattr(theirs, name).dtype, name
    for flag in ("has_drop", "has_stragglers", "has_forgery", "needs_carry", "has_local_attacks",
                 "has_omniscient_attacks", "has_attacks", "has_process_faults", "has_topology_faults"):
        assert getattr(mine, flag) == getattr(theirs, flag), flag
    for a, b in zip(mine.regimes, theirs.regimes):
        assert (a.start, a.spec, type(a.attack).__name__ if a.attack else None) == (
            b.start, b.spec, type(b.attack).__name__ if b.attack else None)
        if a.attack is not None:
            assert a.attack.args == b.attack.args
    for step in range(0, 2000, 37):
        assert mine.regime_at(step) == theirs.regime_at(step)
        assert mine.describe(mine.regime_at(step)) == theirs.describe(theirs.regime_at(step))
    assert (mine.link is None) == (theirs.link is None)
    if mine.link is not None:
        assert (mine.link.packet_coords, mine.link.min_coords) == (theirs.link.packet_coords, theirs.link.min_coords)
    assert mine.stragglers.nb_eligible == theirs.stragglers.nb_eligible


def test_schedule_regime_boundaries_like_jax():
    mine, theirs = (cls("0:calm 5:drop=0.5 10:drop=1.0", 4) for cls in (ChaosSchedule, JaxSchedule))
    for step, want in {0: 0, 4: 0, 5: 1, 9: 1, 10: 2, 11: 2, 1000: 2}.items():
        assert mine.regime_at(step) == want == theirs.regime_at(step), step
        assert int(theirs.regime_index(np.int32(step))) == mine.regime_at(step)
    assert mine.describe(1) == "5:drop=0.5"
    assert mine.transitions() == [(0, "calm"), (5, "drop=0.5"), (10, "drop=1.0")]
    assert (mine.drop_rate(2), mine.straggler_rate(0), mine.straggler_stale(1)) == (1.0, 0.0, False)
    assert ChaosSchedule("100:drop=0.5", 4).regimes[0].spec == "calm"


BAD_SPECS = [
    ("", 0), ("   ", 0), ("calm", 0), ("x:calm", 0), ("-5:calm", 0), ("0:calm 0:drop=0.1", 0), ("0:bogus", 0),
    ("0:drop=1.5", 0), ("0:drop=abc", 0), ("0:straggle=2", 0), ("0:straggle-mode=stale", 0),
    ("0:straggle=0.5,straggle-mode=late", 0), ("0:jitter=1.0", 0), ("0:straggle=0.5,jitter=-0.5", 0),
    ("0:straggle=0.5,jitter=abc", 0), ("0:attack=nosuchattack", 2), ("0:epsilon=1.0", 0), ("0:attack=empire", 0),
    ("0:drop=0.1,drop=0.2", 0), ("0:attack=empire,dorp=0.3", 2), ("0:attack=empire,epsilom=9.0", 2),
    ("0:attack=zero,scale=2.0", 2), ("0:forge=0.5", 0), ("0:tamper=2", 2),
    # the gates: process and topology keys without their opt-in
    ("0:calm 10:kill=train", 0), ("0:hang=backend-a", 0), ("0:corrupt-agg=1.0", 0), ("5:straggle-agg=1.0+2.1", 0),
]


@pytest.mark.parametrize("spec, nb_byz", BAD_SPECS)
def test_schedule_rejects_like_jax(spec, nb_byz):
    with pytest.raises(UserException):
        ChaosSchedule(spec, 8, nb_real_byz=nb_byz)
    with pytest.raises(JaxUserException):
        JaxSchedule(spec, 8, nb_real_byz=nb_byz)


@pytest.mark.parametrize("args", [["bogus:1"], ["straggle-workers:9"], ["packet-coords:x"]])
def test_schedule_rejects_bad_args_like_jax(args):
    with pytest.raises(UserException):
        ChaosSchedule("0:straggle=0.5", 8, args=args)
    with pytest.raises(JaxUserException):
        JaxSchedule("0:straggle=0.5", 8, args=args)


@pytest.mark.parametrize("spec", ["0:kill=", "0:kill=a+", "0:kill=+a", "0:kill=a++b", "0:kill=a+a", "0:kill=a b",
                                  "0:hang=a,hang=b", "0:corrupt-agg=1", "0:corrupt-agg=0.1", "0:straggle-agg=1.-1"])
def test_process_and_topology_targets_reject_like_jax(spec):
    for cls, error in ((ChaosSchedule, UserException), (JaxSchedule, JaxUserException)):
        with pytest.raises(error):
            cls(spec, 4, allow_process_faults=True, allow_topology_faults=True)


def test_process_and_topology_faults_parse_like_jax():
    spec = "0:calm 10:kill=train 20:hang=backend-a+backend-b,kill=router 30:corrupt-agg=1.0+2.1"
    mine = ChaosSchedule(spec, 4, allow_process_faults=True, allow_topology_faults=True)
    theirs = JaxSchedule(spec, 4, allow_process_faults=True, allow_topology_faults=True)
    assert mine.process_faults() == theirs.process_faults() == [
        (10, ("train",), ()), (20, ("router",), ("backend-a", "backend-b"))]
    assert [r.agg_corrupt for r in mine.regimes] == [r.agg_corrupt for r in theirs.regimes]
    assert mine.has_process_faults and mine.has_topology_faults
    with pytest.raises(UserException, match="fleet plane"):
        ChaosSchedule("0:hang=backend-a", 4)
    for key, value in (("kill", "train"), ("hang", "a+b-2+c.3")):
        assert replica_faults.parse_process_targets(key, value) == jfaults.parse_process_targets(key, value)
    for key, value in (("stop", "train"), ("kill", " train"), ("kill", "a:b")):
        with pytest.raises(UserException):
            replica_faults.parse_process_targets(key, value)


@pytest.mark.parametrize("spec", ["1:nan", "2:scale=50", "0:stale", "3:noise", "0:zero", "1:scale",
                                  "x:nan", "-1:nan", "1:bogus", "1:nan=2", "1:scale=abc", "nan"])
def test_parse_poison_like_jax(spec):
    try:
        want = jfaults.parse_poison(spec)
    except JaxUserException:
        with pytest.raises(UserException):
            replica_faults.parse_poison(spec)
        return
    assert replica_faults.parse_poison(spec) == want


@pytest.mark.parametrize("mode, value", [("nan", None), ("zero", None), ("scale", 3.0), ("noise", None),
                                         ("noise", 0.5)])
def test_corrupt_params_is_bit_identical_to_jax(mode, value):
    jexp = jmodels.instantiate("mnist", ["hidden:16"])
    init = jax.tree_util.tree_map(np.asarray, jexp.init(jax.random.PRNGKey(3)))
    want = params_from_jax(jfaults.corrupt_params(init, mode, value, seed=7))
    got = replica_faults.corrupt_params(params_from_jax(init), mode, value, seed=7)
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].shape == want[name].shape
        assert np.array_equal(got[name].numpy().view(np.int32), want[name].numpy().view(np.int32)), name
    with pytest.raises(UserException):
        replica_faults.corrupt_params(params_from_jax(init), "stale")


def test_stragglers_apply_and_draw_like_jax():
    model, jmodel = StragglerModel(8, nb_eligible=2), jax_stragglers(8, 2)
    g, previous = torch.arange(5.0), torch.full((5,), 7.0)
    for late in (False, True):
        for stale in (False, True):
            for prev in (None, previous):
                want = np.asarray(jmodel.apply(g.numpy(), late, stale, None if prev is None else prev.numpy()))
                got = model.apply(g, late, stale, previous=prev).numpy()
                np.testing.assert_array_equal(got, want)
    # rate 0: never late, rate 1: always (eligible workers only)
    assert not any(model.draw_late(1, s, w, 0.0) for s in range(5) for w in range(8))
    assert [model.draw_late(1, 3, w, 1.0) for w in range(8)] == [True, True] + [False] * 6
    every = StragglerModel(8)
    draws = [every.draw_late(seed, s, w, 0.3) for seed in range(3) for s in range(50) for w in range(8)]
    assert abs(np.mean(draws) - 0.3) <= 4 * (0.3 * 0.7 / len(draws)) ** 0.5
    assert every.draw_late(1, 2, 3, 0.5) == every.draw_late(1, 2, 3, 0.5)
    with pytest.raises(UserException):
        StragglerModel(8, nb_eligible=9)


def jax_stragglers(n, eligible):
    from aggregathor_tpu.chaos.stragglers import StragglerModel as JaxStragglers

    return JaxStragglers(n, eligible)


# --------------------------------------------------------------------------- #
# engine steps

def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _inject_jax_draws(schedule, jschedule, seed):
    """The port's drop storm and lateness draw from the JAX engine's threefry
    keys: fold_in(fold_in(fold_in(PRNGKey(seed), step), w), tag)."""
    def wkey(step, w):
        return jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed), step), w)

    def drops(d, _seed, step, w, ridx):
        nb = schedule.link.nb_packets(d)
        return torch.from_numpy(np.array(jax.random.bernoulli(jax.random.fold_in(wkey(step, w), 2),
                                                              jschedule.drop_rate(ridx), (nb,))))

    def late(_seed, step, w, rate):
        return bool(jschedule.stragglers.is_late(wkey(step, w), w, np.float32(rate)))

    schedule.draw_drops = drops
    schedule.stragglers.draw_late = late


def _chaos_run_both(spec, rule, n, f, r, args, steps):
    exp_args = ["hidden:16", "batch-size:16"]
    jexp, texp = jmodels.instantiate("mnist", exp_args), tmodels.instantiate("mnist", exp_args)
    jtx = jax_optimizer("sgd", jax_schedule("fixed", ["initial-rate:0.05"]))
    ttx = build_optimizer("sgd", build_schedule("fixed", ["initial-rate:0.05"]))
    jchaos, tchaos = JaxSchedule(spec, n, nb_real_byz=r, args=args), ChaosSchedule(spec, n, nb_real_byz=r, args=args)
    _inject_jax_draws(tchaos, jchaos, seed=1)
    jengine = JaxEngine(make_mesh(nb_workers=1), jgars.instantiate(rule, n, f), nb_workers=n, nb_real_byz=r,
                        chaos=jchaos)
    tengine = RobustEngine(tgars.instantiate(rule, n, f), n, nb_real_byz=r, chaos=tchaos, device="cpu")
    init = jexp.init(jax.random.PRNGKey(42))
    jstep, tstep = jengine.build_step(jexp.loss, jtx), tengine.build_step(texp.loss, ttx)
    jstate = jengine.init_state(init, jtx, seed=1)
    tstate = tengine.init_state(params_from_jax(_host(init)), ttx, seed=1)
    it = jexp.make_train_iterator(n, seed=3)
    out = {"jax": [], "port": [], "jregime": [], "regime": [], "nan_rows": []}
    for _ in range(steps):
        batch = next(it)
        jstate, jm = jstep(jstate, jengine.shard_batch(batch))
        tstate, tm = tstep(tstate, tengine.put_batch(batch))
        out["jax"].append(float(jm["total_loss"]))
        out["port"].append(float(tm["total_loss"]))
        out["jregime"].append(int(jm["chaos_regime"]))
        out["regime"].append(int(tm["chaos_regime"]))
        assert np.array_equal(np.asarray(jm["probe"]["worker_nan_rows"]) != 0,
                              tm["probe"]["worker_nan_rows"].numpy() != 0)
    out["params"] = (params_from_jax(_host(jstate.params)), tstate.params)
    return out


@pytest.mark.parametrize("spec, rule, r", [
    ("0:drop=0.2 4:attack=empire,epsilon=4.0 8:straggle=0.4,straggle-mode=stale", "average-nan", 2),
    ("0:calm 3:attack=signflip,scale=3.0 6:drop=0.5,straggle=0.3", "median", 2),
], ids=["drop-empire-stale", "signflip-storm"])
def test_chaos_steps_match_the_jax_engine_with_its_masks(spec, rule, r):
    out = _chaos_run_both(spec, rule, 8, 2, r, ["packet-coords:1024"], 12)
    assert out["regime"] == out["jregime"]
    np.testing.assert_allclose(out["port"], out["jax"], rtol=1e-5)
    want, got = out["params"]
    for key in want:
        np.testing.assert_allclose(got[key].detach().numpy(), want[key].numpy(), rtol=1e-4, atol=1e-5, err_msg=key)


def _setup(rule, n=8, f=0, chaos=None, r=0, lossy=None):
    exp = tmodels.instantiate("mnist", ["hidden:16", "batch-size:16"])
    tx = build_optimizer("sgd", build_schedule("fixed", ["initial-rate:0.05"]))
    engine = RobustEngine(tgars.instantiate(rule, n, f), n, nb_real_byz=r, chaos=chaos, lossy_link=lossy,
                          device="cpu")
    return exp, engine, engine.build_step(exp.loss, tx), engine.init_state(exp.init(42), tx, seed=1)


def _flat(state):
    return torch.cat([p.detach().reshape(-1) for p in state.params.values()])


def test_stale_straggler_rate_one_is_clever_full_loss():
    stale = ChaosSchedule("0:straggle=1.0,straggle-mode=stale", 8)
    exp, eng_chaos, step_chaos, s_chaos = _setup("average", chaos=stale)
    assert eng_chaos.carries_gradients and s_chaos.carry is not None
    link = LossyLink(8, ["drop-rate:1.0", "packet-coords:1024", "min-coords:0", "clever:true"])
    _, _, step_clever, s_clever = _setup("average", lossy=link)
    it1, it2 = exp.make_train_iterator(8, seed=3), exp.make_train_iterator(8, seed=3)
    for _ in range(4):
        s_chaos, _ = step_chaos(s_chaos, eng_chaos.put_batch(next(it1)))
        s_clever, _ = step_clever(s_clever, eng_chaos.put_batch(next(it2)))
    assert torch.equal(_flat(s_chaos), _flat(s_clever)) and torch.equal(s_chaos.carry, s_clever.carry)


def test_regime_switch_poisons_average_at_exactly_its_step():
    exp, engine, step, state = _setup("average", chaos=ChaosSchedule("0:calm 3:straggle=1.0,straggle-mode=drop", 8))
    it = exp.make_train_iterator(8, seed=3)
    regimes = []
    for _ in range(3):
        state, metrics = step(state, engine.put_batch(next(it)))
        regimes.append(int(metrics["chaos_regime"]))
    assert bool(torch.all(torch.isfinite(_flat(state))))
    state, metrics = step(state, engine.put_batch(next(it)))
    regimes.append(int(metrics["chaos_regime"]))
    assert not bool(torch.all(torch.isfinite(_flat(state)))) and regimes == [0, 0, 0, 1]
    assert metrics["chaos_regime"].dtype == torch.int32


@pytest.mark.parametrize("rule", ["median", "krum"])
def test_always_late_stragglers_are_absorbed_by_robust_rules(rule):
    chaos = ChaosSchedule("0:straggle=1.0,straggle-mode=drop", 8, args=["straggle-workers:2"])
    exp, engine, step, state = _setup(rule, f=2, chaos=chaos)
    it = exp.make_train_iterator(8, seed=3)
    losses = []
    for _ in range(15):
        state, metrics = step(state, engine.put_batch(next(it)))
        losses.append(float(metrics["total_loss"]))
        assert metrics["probe"]["worker_nan_rows"].tolist()[:3] == [1, 1, 0]
    assert bool(torch.all(torch.isfinite(_flat(state)))) and losses[-1] < losses[0]


def test_chaos_engine_validation_and_flight_lane():
    gar = tgars.instantiate("average", 4, 0)
    chaos = ChaosSchedule("0:drop=0.1", 4)
    with pytest.raises(UserException):  # chaos + a static attack
        RobustEngine(gar, 4, nb_real_byz=1, chaos=chaos, attack=attacks.instantiate("zero", 4, 1), device="cpu")
    with pytest.raises(UserException):  # chaos + a static lossy link
        RobustEngine(gar, 4, chaos=chaos, lossy_link=LossyLink(2, ["drop-rate:0.1"]), device="cpu")
    with pytest.raises(UserException):  # worker-count mismatch
        RobustEngine(gar, 4, chaos=ChaosSchedule("0:calm", 8), device="cpu")
    with pytest.raises(UserException):  # attack regimes need a coalition
        RobustEngine(gar, 4, chaos=ChaosSchedule("0:attack=zero", 4, nb_real_byz=1), device="cpu")
    with pytest.raises(UserException):  # coalition-size mismatch
        RobustEngine(gar, 4, nb_real_byz=2, chaos=ChaosSchedule("0:attack=zero", 4, nb_real_byz=1), device="cpu")
    # forge/tamper regimes build, with and without secure submission (test_torch_secure.py runs them)
    for secure in (False, True):
        assert RobustEngine(gar, 4, nb_real_byz=1, chaos=ChaosSchedule("0:calm 2:tamper=0.5", 4, nb_real_byz=1),
                            secure=secure, device="cpu").chaos.has_forgery
    recorder = FlightRecorder(8, 8, chaos=True)
    chaos = ChaosSchedule("0:calm 2:straggle=0.5", 8)
    exp, engine, step, state = _setup("average-nan", chaos=chaos)
    engine.flight = recorder
    state.flight = recorder.init_buffers("cpu")
    it = exp.make_train_iterator(8, seed=3)
    for _ in range(4):
        state, _ = step(state, engine.put_batch(next(it)))
    assert recorder.fetch(state.flight)["chaos_regime"].tolist() == [0, 0, 1, 1]


# --------------------------------------------------------------------------- #
# the runner

RUN = ["--experiment", "mnist", "--experiment-args", "batch-size:16", "--aggregator", "krum", "--nb-workers", "8",
       "--nb-decl-byz-workers", "2", "--nb-real-byz-workers", "2"]


@pytest.mark.parametrize("extra", [
    ["--attack", "zero", "--chaos", "0:drop=0.1"], ["--UDP", "2", "--chaos", "0:drop=0.1"],
    ["--chaos", "0:kill=train"], ["--chaos", "0:corrupt-agg=1.0"], ["--chaos", "0:calm", "--chaos-args", "bogus:1"],
    ["--chaos", "0:forge=0.5", "--secure"],
], ids=["attack", "udp", "kill", "topology", "args", "forge"])
def test_runner_chaos_refusals_like_jax(extra):
    from aggregathor_tpu.cli import runner as jrunner
    from aggregathor_tpu_torch.cli import runner

    argv = RUN + ["--max-step", "1", "--evaluation-period", "-1"] + extra
    with pytest.raises(UserException):
        runner.main(argv + ["--device", "cpu"])
    with pytest.raises(JaxUserException):
        jrunner.main(argv + ["--nb-devices", "1"])


def _eval_regimes(path):
    out = {}
    for line in open(path):
        fields = line.rstrip("\n").split("\t")
        out[int(fields[1])] = dict(field.split(":", 1) for field in fields[2:])["chaos_regime"]
    return out


def _events(directory):
    (name,) = os.listdir(directory)
    return [json.loads(line) for line in open(os.path.join(directory, name))]


def test_runner_chaos_columns_and_events_equal_the_jax_runners(tmp_path, monkeypatch):
    from aggregathor_tpu.cli import runner as jrunner
    from aggregathor_tpu.obs import metrics as jmetrics
    from aggregathor_tpu_torch.cli import runner

    monkeypatch.setattr(jmetrics, "REGISTRY", jmetrics.MetricsRegistry())
    monkeypatch.setattr(obs_metrics, "REGISTRY", obs_metrics.MetricsRegistry())
    argv = RUN + ["--chaos", "0:calm 6:attack=signflip,scale=10.0 9:straggle=0.5,straggle-mode=stale",
                  "--max-step", "12", "--learning-rate-args", "initial-rate:0.05", "--evaluation-delta", "5",
                  "--evaluation-period", "-1", "--summary-delta", "4", "--prefetch", "0"]
    runner.main(argv + ["--evaluation-file", str(tmp_path / "p.tsv"), "--summary-dir", str(tmp_path / "ps"),
                        "--device", "cpu", "--metrics-file", str(tmp_path / "m.prom")])
    jrunner.main(argv + ["--evaluation-file", str(tmp_path / "j.tsv"), "--summary-dir", str(tmp_path / "js"),
                         "--nb-devices", "1"])
    assert _eval_regimes(tmp_path / "p.tsv") == _eval_regimes(tmp_path / "j.tsv") == {
        1: "0", 6: "0", 11: "2", 12: "2"}
    mine, theirs = _events(tmp_path / "ps"), _events(tmp_path / "js")

    def switches(events):
        return [(e["step"], e["regime"], e["spec"]) for e in events if e.get("event") == "chaos_regime_switch"]

    assert switches(mine) == switches(theirs) == [(6, 1, "6:attack=signflip,scale=10.0"),
                                                  (9, 2, "9:straggle=0.5,straggle-mode=stale")]
    assert ([(e["step"], e["chaos_regime"]) for e in mine if "chaos_regime" in e]
            == [(e["step"], e["chaos_regime"]) for e in theirs if "chaos_regime" in e])
    families = obs_metrics.parse_prometheus(open(tmp_path / "m.prom").read())
    assert families["train_chaos_regime"]["samples"][0][2] == 2.0
