"""Bounded-wait on the sharded engine (``parallel/bounded.py`` grouped mode,
``RobustEngine.build_group_grad``/``build_submesh_grad`` and the sharded
bounded aggregate), against JAX's ``BoundedWaitStep`` on its sharded
engine and against the port's one-rank flat bounded engine, on the CPU.

A submission unit is one worker-axis index: its k = n/W workers arrive, or
forfeit their rows, together.  Every case runs on the injected rows of a
small transformer's parameter tree (``tests/torch_injected.py``'s linear
loss; on the port's grid its local partial,
``torch_rank_cases.sharded_injected_loss``), n = 8, granularity global,
worker 5's unit stalled far beyond the run from step 1 on: round 1 waits
the deadline, later rounds skip the unit, so the masks do not depend on
the clock.  Two spawns, started on threads by the module fixture beside
the one-rank runs and JAX's: four gloo ranks serving the grids (4, 1, 1)
(k = 2, units of one rank) and (2, 1, 2) (k = 4, units of two ranks with
the model axis inside, their collectives on groups of their own), two
serving (2, 1, 1).

- The timeout and stale masks, the coefficients, krum's participation
  (its selections), the counters and the journal (``bounded_round`` with
  the skipped unit, ``submesh_timeout`` with its group and forfeited
  count, ``stale_reweight``) JAX's exactly; losses and parameters within
  1e-5 relative; the parameters bit-identical across the ranks; a missed
  unit forfeits exactly its k rows.
- The same masks, losses and parameters as the one-rank flat engine with
  the unit's workers late.
- The adaptive window: every rank's the same, and JAX's controller fed the
  gathered arrivals with ``unit_size = k``.
- ``secure``: the whole rows' digests JAX's bit for bit.
- l2 folded into each worker's loss (the runner's ``make_regularized_loss``,
  each leaf's term scaled by 1/(its replication) on the grid), as JAX's
  runner folds it into the plain loss: counted once.
- The runner: ``--mesh 2,1,1 --step-deadline 0.5 --straggler-stall 30``
  on the transformer, its journal held against JAX's step on the same
  flags (JAX's runner fails on this path: ROADMAP queue 3); ``--microbatches``
  under a sharded ``--step-deadline`` refused as JAX refuses it.
"""

import concurrent.futures
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

import torch_rank_cases as cases_module
from aggregathor_tpu import gars as jgars
from aggregathor_tpu import models as jmodels
from aggregathor_tpu.chaos import ChaosSchedule as JaxChaos
from aggregathor_tpu.cli import runner as jrunner
from aggregathor_tpu.core import build_optimizer as jax_optimizer
from aggregathor_tpu.core import build_schedule as jax_schedule
from aggregathor_tpu.models import transformer as jtfm
from aggregathor_tpu.obs import events as jevents
from aggregathor_tpu.parallel import RobustEngine as JaxEngine
from aggregathor_tpu.parallel import make_mesh as jax_mesh
from aggregathor_tpu.parallel.bounded import BoundedWaitStep as JaxStep
from aggregathor_tpu.parallel.bounded import HostStragglerModel as JaxStragglers
from aggregathor_tpu.parallel.deadline import DeadlineController as JaxController
from aggregathor_tpu.utils import UserException as JaxUserException
from aggregathor_tpu_torch.cli import runner
from aggregathor_tpu_torch.models.common import params_from_jax
from aggregathor_tpu_torch.obs import events as tevents
from aggregathor_tpu_torch.obs import metrics as tmetrics
from aggregathor_tpu_torch.parallel import mesh
from aggregathor_tpu_torch.parallel.mesh import WorkerAxis
from aggregathor_tpu_torch.utils import UserException

from torch_threads import pinned_threads  # noqa: F401  (a fixture: the xdist worker's intra-op pool)

N = 8
LATE = 5  # its unit is stalled
DEADLINE = 1.0
CFG = dict(vocab_size=17, d_model=16, n_heads=2, n_layers=2)
JCFG = jtfm.TransformerConfig(**CFG)
MASKS = ("straggler_timeout", "stale_infill", "nb_timeouts", "nb_stale", "worker_nan")
EXACT = ("stale_reweight_coeff", "worker_participation")
JOURNAL_KINDS = ("bounded_round", "submesh_timeout", "stale_reweight")


def _case(rule, f, steps=4, stragglers=(LATE,), options=None, **step):
    return {"n": N, "f": f, "rule": rule, "cfg": CFG, "stragglers": stragglers, "steps": steps,
            "options": options or {}, "step": step}


CASES = {
    "krum": _case("krum", 2, options={"worker_metrics": True}, deadline=DEADLINE),
    "stale-reweight": _case("median", 2, steps=5, deadline=DEADLINE, stale_infill=True, stale_max_age=2,
                            stale_reweight=True),
    "adaptive": dict(_case("average-nan", 2, steps=5),
                     controller=dict(initial=DEADLINE, percentile=50.0, floor=0.05, ema=0.3)),
    "average-nan": _case("average-nan", 4, deadline=DEADLINE),
    "krum-sync": _case("krum", 2, steps=3, stragglers=(), options={"worker_metrics": True}),
    "secure": _case("average-nan", 4, steps=3, options={"secure": True}, deadline=DEADLINE),
    # l2 folded into each worker's loss (the runner's make_regularized_loss):
    # a model-sharded leaf's term once, a replicated one's split over the unit
    "l2": dict(_case("krum", 2, steps=3, stragglers=(), options={"worker_metrics": True}), l2=0.1),
}
#: grid shape (W, PP, TP) -> its cases; the first two share a spawn of four ranks
SHAPES = {(4, 1, 1): ("krum", "stale-reweight", "adaptive"),
          (2, 1, 2): ("average-nan", "krum-sync", "secure", "l2"), (2, 1, 1): ("average-nan", "krum-sync")}
PAIRS = [(shape, name) for shape, names in SHAPES.items() for name in names]
JAX_PAIRS = [pair for pair in PAIRS if pair[1] != "adaptive"]


def _tag(shape):
    return "x".join(str(v) for v in shape)


def _unit(shape):
    """The workers of the stalled unit at this grid shape."""
    k = N // shape[0]
    return tuple(range(LATE // k * k, LATE // k * k + k))


@functools.lru_cache(maxsize=None)
def _inputs():
    """JAX's transformer weights (numpy), the port's, and the injected rows
    of every step (global, worker-major), the same for both packages."""
    jparams = {k: np.asarray(v) for k, v in jtfm.init_params(JCFG, jax.random.PRNGKey(7)).items()}
    rng = np.random.default_rng(6)
    scales = (np.arange(N) + 1.0) / 2.0
    batches = []
    for _ in range(max(case["steps"] for case in CASES.values())):
        batch = {}
        for name, value in sorted(jparams.items()):
            noise = rng.normal(size=(N,) + value.shape) * scales.reshape((N,) + (1,) * value.ndim)
            batch["g_" + name] = (rng.normal(size=value.shape) + noise).astype(np.float32)
        batches.append(batch)
    weights = {name: value.numpy() for name, value in params_from_jax(jparams).items()}
    return jparams, weights, batches


def _grids(shapes):
    _, weights, batches = _inputs()
    return [(shape, [(name, CASES[name], weights, batches[:CASES[name]["steps"]]) for name in SHAPES[shape]])
            for shape in shapes]


def _jax_loss(params, batch):
    return sum(jnp.sum(params[name] * batch["g_" + name]) for name in sorted(params))


def _jax_l2(l2):
    """JAX's runner's regularized loss (``make_regularized_loss``) of the
    linear loss."""
    return lambda params, batch: _jax_loss(params, batch) + l2 * sum(
        jnp.sum(p * p) for p in jax.tree_util.tree_leaves(params))


def _jax_run(shape, name, journal):
    """JAX's ``BoundedWaitStep`` on its sharded engine over a (W, 1, TP)
    mesh of the virtual devices: per round its masks, counts, coefficients,
    participation and loss; the parameters; the timeouts."""
    jparams, _, batches = _inputs()
    case = CASES[name]
    W, _, TP = shape
    engine = JaxEngine(jax_mesh(nb_workers=W, model_parallelism=TP), jgars.instantiate(case["rule"], N, case["f"]),
                       N, sharding="sharded", granularity="global", **case["options"])
    tx = jax_optimizer("sgd", jax_schedule("fixed", ["initial-rate:0.05"]))
    # replicated specs: JAX's submission body cannot flatten a leaf sharded
    # over pipe or model (a ShardingTypeError in its reshape, ROADMAP queue
    # 3); the rule's rows, and so every number, do not depend on the layout
    state = engine.init_state(lambda key: jparams, {name: P() for name in jparams}, tx, seed=1)
    model = cases_module.ChosenStragglers(case["stragglers"], 30.0) if case["stragglers"] else None
    jevents.install(journal, run_id="sharded-bounded")
    loss = _jax_l2(case["l2"]) if case.get("l2") else _jax_loss
    step = JaxStep(engine, loss, tx, jax.device_get(state.params), straggler_model=model, **case["step"])
    rounds = []
    try:
        for batch in batches[:case["steps"]]:
            state, metrics = step(state, batch)
            metrics = jax.device_get(metrics)
            got = {key: np.asarray(metrics[key]) for key in MASKS[:4] + ("total_loss",) + EXACT if key in metrics}
            got["worker_nan"] = np.asarray(metrics["probe"]["worker_nan_rows"])
            if "secure" in metrics:
                got["secure"] = {key: np.asarray(value) for key, value in metrics["secure"].items()}
            rounds.append(got)
    finally:
        step.close()
        jevents.uninstall()
    assert (step.nb_units, step.group_size) == (W, N // W)
    return {"rounds": rounds, "params": params_from_jax(jax.device_get(state.params)),
            "timeouts_total": np.asarray(step.timeouts_total)}


def _one_rank(shape, name):
    """The port's one-rank flat bounded engine on the same rows, the stalled
    unit's workers late."""
    _, weights, batches = _inputs()
    case = dict(CASES[name], stragglers=_unit(shape) if CASES[name]["stragglers"] else ())
    return cases_module.bounded_case(WorkerAxis(N, 1, 0, "cpu"), case, weights, batches[:case["steps"]])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``(ranks by spawn, one-rank results, JAX results, journal directory)``,
    futures on threads: the two spawns, the one-rank runs and JAX's."""
    journals = tmp_path_factory.mktemp("sharded-bounded")
    pool = concurrent.futures.ThreadPoolExecutor(4)
    spawns = {4: pool.submit(mesh.spawn, cases_module.sharded_bounded_cases, 4, 4,
                             (_grids([(4, 1, 1), (2, 1, 2)]), str(journals)), device="cpu", timeout=600),
              2: pool.submit(mesh.spawn, cases_module.sharded_bounded_cases, 2, 2,
                             (_grids([(2, 1, 1)]), str(journals)), device="cpu", timeout=600)}
    one = pool.submit(lambda: {(shape, name): _one_rank(shape, name) for shape, name in PAIRS})
    theirs = pool.submit(lambda: {(shape, name): _jax_run(shape, name, str(journals / ("%s-%s-jax.jsonl"
                                                                                         % (name, _tag(shape)))))
                                  for shape, name in JAX_PAIRS})
    yield spawns, one, theirs, journals
    pool.shutdown(wait=True)


def _ranks(runs, shape, name):
    size = shape[0] * shape[1] * shape[2]
    return [rank[_tag(shape)][name] for rank in runs[0][size].result()]


def _journal(path, module):
    return [{k: v for k, v in record.items() if k not in ("t_wall", "t_mono", "run_id", "schema", "pid", "seq")}
            for record in module.load_journal(str(path)) if record["type"] in JOURNAL_KINDS]


def _same_rounds(ours, want, what):
    assert len(ours) == len(want), what
    for i, (a, b) in enumerate(zip(ours, want)):
        for key in MASKS:
            assert np.array_equal(a[key], b[key]), (what, i, key)
        for key in EXACT:
            assert (key in a) == (key in b) and (key not in a or np.array_equal(a[key], b[key])), (what, i, key)
        np.testing.assert_allclose(a["total_loss"], b["total_loss"], rtol=1e-5, err_msg="%s round %d" % (what, i))


def _same_params(ours, want, what):
    for key, value in want.items():
        np.testing.assert_allclose(np.reshape(ours[key], np.shape(value)), value, rtol=1e-5, atol=1e-6,
                                   err_msg="%s %s" % (what, key))


@pytest.mark.parametrize("shape,name", PAIRS, ids=["%s-%s" % (_tag(s), n) for s, n in PAIRS])
def test_units_forfeit_their_rows_together_on_every_rank(runs, shape, name):
    ranks = _ranks(runs, shape, name)
    lead = ranks[0]
    W, k = shape[0], N // shape[0]
    assert (lead["nb_units"], lead["group_size"]) == (W, k)
    for other in ranks[1:]:
        for key, value in lead["params"].items():
            assert np.array_equal(other["params"][key], value), (other["rank"], key)
        for a, b in zip(lead["rounds"], other["rounds"]):
            for key in MASKS + ("total_loss", "arrivals"):
                assert np.array_equal(a[key], b[key]), (other["rank"], key)
            assert a["window"] == b["window"]
    late = np.isin(np.arange(N), _unit(shape)) if CASES[name]["stragglers"] else np.zeros(N, bool)
    assert [r["straggler_timeout"].tolist() for r in lead["rounds"]] == [[False] * N] + [late.tolist()] * (
        len(lead["rounds"]) - 1)
    # a unit's k members share one arrival instant, as JAX's grouped rounds
    for r in lead["rounds"]:
        assert np.array_equal(r["arrivals"].reshape(W, k), np.repeat(r["arrivals"][::k, None], k, axis=1))
    assert lead["timeouts_total"].tolist() == (late * (len(lead["rounds"]) - 1)).tolist()


@pytest.mark.parametrize("shape,name", PAIRS, ids=["%s-%s" % (_tag(s), n) for s, n in PAIRS])
def test_the_grid_is_the_one_rank_flat_engine(runs, shape, name):
    lead = _ranks(runs, shape, name)[0]
    want = runs[1].result()[shape, name]
    _same_rounds(lead["rounds"], want["rounds"], "%s %s" % (shape, name))
    _same_params(lead["params"], want["params"], "%s %s" % (shape, name))
    if name == "secure":
        for a, b in zip(lead["rounds"], want["rounds"]):
            for key, value in b["secure"].items():
                assert np.array_equal(a["secure"][key], value), key


@pytest.mark.parametrize("shape,name", JAX_PAIRS, ids=["%s-%s" % (_tag(s), n) for s, n in JAX_PAIRS])
def test_rounds_journal_and_parameters_match_jax(runs, shape, name):
    journals = runs[3]
    lead = _ranks(runs, shape, name)[0]
    theirs = runs[2].result()[shape, name]
    _same_rounds(lead["rounds"], theirs["rounds"], "%s %s" % (shape, name))
    _same_params(lead["params"], {k: v.numpy() for k, v in theirs["params"].items()}, "%s %s" % (shape, name))
    assert np.array_equal(lead["timeouts_total"], theirs["timeouts_total"])
    ours = _journal(journals / ("%s-%s.jsonl" % (name, _tag(shape))), tevents)
    assert ours == _journal(journals / ("%s-%s-jax.jsonl" % (name, _tag(shape))), jevents)
    if CASES[name]["stragglers"]:
        W, k = shape[0], N // shape[0]
        unit = LATE // k
        forfeits = [r for r in ours if r["type"] == "submesh_timeout"]
        assert forfeits == [{"type": "submesh_timeout", "step": 1, "group": unit, "forfeited": k}]
        rounds = [r for r in ours if r["type"] == "bounded_round"]
        assert [r["skipped_units"] for r in rounds] == [[]] + [[unit]] * (len(rounds) - 1)
        assert all(r["timed_out"] == list(_unit(shape)) for r in rounds)
    if name == "stale-reweight":
        rounds = lead["rounds"]
        assert [bool(r["stale_infill"][LATE]) for r in rounds] == [False, True, True, False, False]
        assert [float(r["stale_reweight_coeff"][LATE]) for r in rounds[1:3]] == [np.float32(0.5), np.float32(1 / 3)]
    if name == "secure":
        for i, (a, b) in enumerate(zip(lead["rounds"], theirs["rounds"])):
            for key in ("digest_sent", "digest_recv", "forged", "rejected"):
                assert np.array_equal(a["secure"][key], b["secure"][key]), (i, key)


def test_the_adaptive_window_votes_over_units_as_jax_s_controller(runs):
    ranks = _ranks(runs, (4, 1, 1), "adaptive")
    k = N // 4
    replay = JaxController(**CASES["adaptive"]["controller"])
    for i, got in enumerate(ranks[0]["rounds"]):
        if i:  # round 0 builds: not observed
            replay.observe_round(got["arrivals"], step=i, unit_size=k)
        assert all(rank["rounds"][i]["window"] == replay.window for rank in ranks), i
    assert ranks[0]["rounds"][-1]["window"] < DEADLINE  # it adapted


# --------------------------------------------------------------------------- #
# the runner


RUNNER = ["--experiment", "transformer", "--experiment-args", "d-model:16", "heads:2", "layers:2", "seq:8",
          "batch-size:2", "vocab:17", "--aggregator", "average-nan", "--nb-workers", "4", "--nb-decl-byz-workers",
          "2", "--chaos", "0:calm 1:straggle=1.0", "--chaos-args", "straggle-workers:2", "--straggler-stall", "30",
          "--step-deadline", "0.5", "--max-step", "4", "--evaluation-delta", "-1", "--evaluation-period", "-1",
          "--prefetch", "0", "--seed", "1"]


def _jax_runner_step(journal):
    """JAX's step on the runner leg's flags: its sharded engine at (2, 1, 1),
    the transformer's loss, the straggler model of the schedule."""
    exp = jmodels.instantiate("transformer", ["d-model:16", "heads:2", "layers:2", "seq:8", "batch-size:2",
                                              "vocab:17"])
    engine = JaxEngine(jax_mesh(nb_workers=2), jgars.instantiate("average-nan", 4, 2), 4, sharding="sharded",
                       granularity="global")
    tx = jax_optimizer("sgd", jax_schedule("fixed", []))
    state = engine.init_state(exp.sharded_init(1), {name: P() for name in exp.sharded_specs()}, tx, seed=1)
    model = JaxStragglers(4, 30.0, chaos=JaxChaos("0:calm 1:straggle=1.0", 4, args=["straggle-workers:2"]), seed=1)
    jevents.install(journal, run_id="runner")
    step = JaxStep(engine, exp.loss, tx, jax.device_get(state.params), deadline=0.5, straggler_model=model)
    it = exp.make_train_iterator(4, seed=1)
    try:
        for _ in range(4):
            state, metrics = step(state, next(it))
        return float(jax.device_get(metrics["total_loss"]))
    finally:
        step.close()
        jevents.uninstall()


def test_the_runner_s_sharded_bounded_path_journals_as_jax_s_step(tmp_path, monkeypatch):
    monkeypatch.setattr(tmetrics, "REGISTRY", tmetrics.MetricsRegistry())
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        theirs = pool.submit(_jax_runner_step, str(tmp_path / "jax.jsonl"))
        try:
            result = runner.main(RUNNER + ["--mesh", "2,1,1", "--device", "cpu", "--journal", str(tmp_path / "j.jsonl"),
                                           "--forensics", str(tmp_path / "f.json")])
        finally:
            tevents.uninstall()
        jax_loss = theirs.result()
    assert result["steps"] == 4 and np.isfinite(result["final_loss"]) and np.isfinite(jax_loss)
    ours = _journal(tmp_path / "j.jsonl", tevents)
    assert ours == _journal(tmp_path / "jax.jsonl", jevents)
    assert [r["type"] for r in ours] == ["bounded_round", "submesh_timeout", "bounded_round", "bounded_round"]
    assert ours[1] == {"type": "submesh_timeout", "step": 1, "group": 0, "forfeited": 2}
    import json

    assert json.load(open(tmp_path / "f.json"))["stragglers"] == [0, 1]


def test_microbatches_under_a_sharded_deadline_is_refused_as_jax_refuses_it():
    argv = RUNNER[:RUNNER.index("--max-step")] + ["--max-step", "1", "--mesh", "1,1,1", "--microbatches", "2"]
    with pytest.raises(JaxUserException, match="microbatches"):
        jrunner.main(argv)
    with pytest.raises(UserException, match="microbatches"):
        runner.main(argv + ["--device", "cpu"])
