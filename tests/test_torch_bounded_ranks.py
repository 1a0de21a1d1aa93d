"""Bounded-wait over a worker axis of W ranks (``parallel/bounded.py``),
against the port's one-rank run and JAX's ``BoundedWaitStep``, on the CPU.

JAX's flat bounded mode is one process, so the port's W-rank run must be
its one-rank run.  One spawn a W (2 and 4 gloo ranks, every case batched
into it; the rank target is ``tests/torch_rank_cases.py``'s
``bounded_cases``) runs each case on the injected rows of
``tests/torch_injected.py`` (mnist hidden:16's parameter tree, n = 8), with
persistent stragglers chosen by a test-side model that both packages
accept (``ChosenStragglers``): workers 2 and 5, each on a non-lead rank at
W = 4 and worker 5 on rank 1 at W = 2, stalled far beyond the run from
step 1 on, so round 1 waits the deadline and later rounds skip them: the
masks do not depend on the clock.  The module's fixture starts both spawns
on threads beside the one-rank runs and JAX's.

- krum, median, average-nan and trimmed-mean (f = 2): the arrival, stale
  and skipped masks, the counters, the journal (``bounded_round``) and
  forensics' ``stragglers`` identical to the one-rank run's and to JAX's;
  krum's selections identical; losses and parameters within 1e-5
  relative; the parameters bit-identical across the ranks.
- ``--stale-infill --stale-max-age 2 --stale-reweight`` under median (JAX
  ``test_bounded.py:283-321``): stale at rounds 1-2, NaN after,
  coefficients 1/2 and 1/3, the ``stale_reweight`` events JAX's.
- The adaptive window (``DeadlineController``): every rank's window equal
  bit for bit after each round, and equal to a controller fed the
  gathered arrival vectors.
- ``int8:ef``, stacked and incremental: every submission's payload the
  one-rank run's bit for bit (a submission encodes its worker's whole row,
  ROADMAP trap az), the residuals too, and incremental equal to stacked.
- Worker momentum: the momentum rows bit for bit.  ``secure``: the
  gathered digests the one-rank run's bit for bit; the host authenticator
  verifies every row and rejects a row signed without the secret.
- ``topology`` (``tree:g=2,rules=median>average-nan``, f = 1, unit 1.1
  forged without a shadow, median levels: trap aw): the lead's tree masks
  every rank's, and the one-rank run's.
- A submission that raises (worker 4 at step 1): its rank names the unit,
  every other rank the failed rank, all after the round's gather (the
  spawn returns: no rank is left in a collective).
"""

import concurrent.futures
import functools

import jax
import numpy as np
import pytest

import torch_rank_cases as cases_module
from aggregathor_tpu import gars as jgars
from aggregathor_tpu import models as jmodels
from aggregathor_tpu.core import build_optimizer as jax_optimizer
from aggregathor_tpu.core import build_schedule as jax_schedule
from aggregathor_tpu.obs import events as jevents
from aggregathor_tpu.obs.forensics import ForensicsLedger as JaxLedger
from aggregathor_tpu.parallel import RobustEngine as JaxEngine
from aggregathor_tpu.parallel import make_mesh
from aggregathor_tpu.parallel.bounded import BoundedWaitStep as JaxStep
from aggregathor_tpu_torch.models.common import params_from_jax
from aggregathor_tpu_torch.obs import events as tevents
from aggregathor_tpu_torch.obs.forensics import ForensicsLedger
from aggregathor_tpu_torch.parallel import mesh
from aggregathor_tpu_torch.parallel.deadline import DeadlineController
from aggregathor_tpu_torch.parallel.mesh import WorkerAxis
from aggregathor_tpu_torch.secure import SubmissionAuthenticator

from torch_injected import injected
from torch_threads import pinned_threads  # noqa: F401  (a fixture: the xdist worker's intra-op pool)

N = 8
STRAGGLERS = (2, 5)
DEADLINE = 1.0
SIZES = (2, 4)
MASKS = ("straggler_timeout", "stale_infill", "nb_timeouts", "nb_stale", "worker_nan")


def _case(rule, f=2, steps=4, options=None, **step):
    return {"n": N, "f": f, "rule": rule, "stragglers": STRAGGLERS, "steps": steps, "options": options or {},
            "step": step or {"deadline": DEADLINE}}


#: id -> case; the first five are held against JAX too
CASES = {
    "krum": _case("krum", options={"worker_metrics": True}),
    "median": _case("median"),
    "average-nan": _case("average-nan"),
    "trimmed-mean": _case("trimmed-mean"),
    "stale-reweight": _case("median", steps=5, deadline=DEADLINE, stale_infill=True, stale_max_age=2,
                            stale_reweight=True),
    "adaptive": dict(_case("average-nan", steps=5),
                     controller=dict(initial=DEADLINE, percentile=71.4, floor=0.05, ema=0.3)),
    "int8-ef": _case("krum", options={"exchange": "int8:ef"}, deadline=DEADLINE, stale_infill=True),
    "int8-ef-incremental": _case("krum", options={"exchange": "int8:ef"}, deadline=DEADLINE, stale_infill=True,
                                 incremental=True),
    "momentum": _case("krum", options={"worker_momentum": 0.9, "worker_metrics": True}),
    "secure": _case("median", options={"secure": True}),
    "topology": dict(_case("tree:g=2,rules=median>average-nan", f=1),
                     topology=("tree:g=2,rules=median>average-nan", "0:corrupt-agg=1.1")),
    "failure": dict(_case("median", steps=2), fail=(1, 4)),
}
JAX_CASES = ("krum", "median", "average-nan", "trimmed-mean", "stale-reweight")


@functools.lru_cache(maxsize=None)
def _inputs():
    """mnist hidden:16's JAX weights, the injected losses and batches."""
    init = jax.device_get(jmodels.instantiate("mnist", ["hidden:16"]).init(jax.random.PRNGKey(11)))
    jax_loss, _, batches = injected(init, N, max(case["steps"] for case in CASES.values()))
    weights = {name: value.numpy() for name, value in params_from_jax(init).items()}
    return init, jax_loss, batches, weights


def _jobs():
    _, _, batches, weights = _inputs()
    return [(name, case, weights, [port for _, port in batches[:case["steps"]]]) for name, case in CASES.items()]


def _port_one_rank(journal_dir):
    return cases_module.bounded_cases(WorkerAxis(N, 1, 0, "cpu"), _jobs(), journal_dir)


def _jax_run(name, journal):
    """JAX's ``BoundedWaitStep`` on the same case: per round its masks,
    counts, coefficients, loss and participation; the parameters."""
    init, jax_loss, batches, _ = _inputs()
    case = CASES[name]
    options = dict(case["options"])
    engine = JaxEngine(make_mesh(nb_workers=1), jgars.instantiate(case["rule"], N, case["f"]), nb_workers=N,
                       **options)
    tx = jax_optimizer("sgd", jax_schedule("fixed", ["initial-rate:0.05"]))
    state = engine.init_state(init, tx, seed=1)
    model = cases_module.ChosenStragglers(case["stragglers"], 30.0)
    jevents.install(journal, run_id="bounded")
    step = JaxStep(engine, jax_loss, tx, jax.device_get(state.params), straggler_model=model, **case["step"])
    rounds = []
    try:
        for batch, _ in batches[:case["steps"]]:
            state, metrics = step(state, batch)
            metrics = jax.device_get(metrics)
            got = {key: np.asarray(metrics[key]) for key in MASKS[:4] + ("total_loss", "stale_reweight_coeff",
                                                                          "worker_participation")
                   if key in metrics}
            got["worker_nan"] = np.asarray(metrics["probe"]["worker_nan_rows"])
            rounds.append(got)
    finally:
        step.close()
        jevents.uninstall()
    return {"rounds": rounds, "params": params_from_jax(jax.device_get(state.params)),
            "timeouts_total": np.asarray(step.timeouts_total)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``(ranks by W, one-rank results, JAX results, journal directory)``,
    futures on threads: the two spawns, the one-rank run and JAX's."""
    journals = tmp_path_factory.mktemp("bounded-ranks")
    jobs = _jobs()
    pool = concurrent.futures.ThreadPoolExecutor(4)
    ranks = {size: pool.submit(mesh.spawn, cases_module.bounded_cases, size, N, (jobs, str(journals)),
                               device="cpu", timeout=600) for size in SIZES}
    one = pool.submit(_port_one_rank, str(journals))
    theirs = pool.submit(lambda: {name: _jax_run(name, str(journals / ("%s-jax.jsonl" % name))) for name in JAX_CASES})
    yield ranks, one, theirs, journals
    pool.shutdown(wait=True)


def _journal(path, module):
    return [{k: v for k, v in record.items() if k not in ("t_wall", "t_mono", "run_id", "schema", "pid")}
            for record in module.load_journal(str(path))]


def _stragglers(rounds, ledger):
    for i, got in enumerate(rounds):
        ledger.observe(i + 1, timeout=got["straggler_timeout"], stale=got["stale_infill"])
    return ledger.report()["stragglers"]


def _held_to_one_rank(ranks, one, name):
    """Every rank's rounds and parameters against each other (bit for bit)
    and against the one-rank run (masks exact, loss and parameters 1e-5)."""
    lead = ranks[0][name]
    for other in ranks[1:]:
        got = other[name]
        for name_, value in lead["params"].items():
            assert np.array_equal(got["params"][name_], value), (name, got["rank"], name_)
        for a, b in zip(lead["rounds"], got["rounds"]):
            for key in MASKS + ("total_loss", "arrivals"):
                assert np.array_equal(a[key], b[key]), (name, got["rank"], key)
            assert a["window"] == b["window"], (name, got["rank"])
    want = one[name]
    assert len(lead["rounds"]) == len(want["rounds"])
    for i, (a, b) in enumerate(zip(lead["rounds"], want["rounds"])):
        for key in MASKS:
            assert np.array_equal(a[key], b[key]), (name, i, key)
        for key in ("stale_reweight_coeff", "worker_participation"):
            assert (key in a) == (key in b) and (key not in a or np.array_equal(a[key], b[key])), (name, i, key)
        np.testing.assert_allclose(a["total_loss"], b["total_loss"], rtol=1e-5, err_msg="%s round %d" % (name, i))
    for key, value in want["params"].items():
        np.testing.assert_allclose(lead["params"][key], value, rtol=1e-5, atol=1e-6, err_msg="%s %s" % (name, key))
    assert np.array_equal(lead["timeouts_total"], want["timeouts_total"])
    assert np.array_equal(lead["stale_total"], want["stale_total"])
    # the fold families count a rank's own folds; every other family is the run's
    folds = ("exchange_folds_total", "exchange_overlapped_folds_total", "exchange_overlap_fraction")
    assert {k: v for k, v in lead["registry"].items() if k not in folds} == {
        k: v for k, v in want["registry"].items() if k not in folds}, name
    if "exchange_folds_total" in want["registry"]:
        assert sum(rank[name]["registry"]["exchange_folds_total"] for rank in ranks) == want["registry"][
            "exchange_folds_total"]
    return lead, want


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("name", JAX_CASES)
def test_rules_match_one_rank_and_jax(runs, name, size):
    ranks, one, theirs, journals = runs
    lead, want = _held_to_one_rank(ranks[size].result(), one.result(), name)
    jax_run = theirs.result()[name]
    for i, (a, b) in enumerate(zip(lead["rounds"], jax_run["rounds"])):
        for key in MASKS:
            assert np.array_equal(a[key], b[key]), (name, i, key)
        for key in ("stale_reweight_coeff", "worker_participation"):
            assert (key in a) == (key in b) and (key not in a or np.array_equal(a[key], b[key])), (name, i, key)
        np.testing.assert_allclose(a["total_loss"], b["total_loss"], rtol=1e-5)
    for key, value in jax_run["params"].items():
        np.testing.assert_allclose(lead["params"][key], value.numpy(), rtol=1e-5, atol=1e-6, err_msg=key)
    assert np.array_equal(lead["timeouts_total"], jax_run["timeouts_total"])
    # the round 1 waits the deadline for the stalls, the later ones skip them
    late = np.isin(np.arange(N), STRAGGLERS)
    assert [r["straggler_timeout"].tolist() for r in lead["rounds"]] == [[False] * N] + [late.tolist()] * (
        len(lead["rounds"]) - 1)
    ours = _journal(journals / ("%s-W%d.jsonl" % (name, size)), tevents)
    assert ours == _journal(journals / ("%s-W1.jsonl" % name), tevents)
    assert ours == _journal(journals / ("%s-jax.jsonl" % name), jevents)
    rounds = [r for r in ours if r["type"] == "bounded_round"]
    assert [r["skipped_units"] for r in rounds] == [[]] + [list(STRAGGLERS)] * (len(rounds) - 1)
    assert _stragglers(lead["rounds"], ForensicsLedger(N)) == _stragglers(jax_run["rounds"], JaxLedger(N)) == list(
        STRAGGLERS)
    if name == "stale-reweight":
        assert [bool(r["stale_infill"][5]) for r in lead["rounds"]] == [False, True, True, False, False]
        assert [float(r["stale_reweight_coeff"][5]) for r in lead["rounds"][1:3]] == [np.float32(0.5),
                                                                                   np.float32(1 / 3)]
        reweights = [(r["step"], r["worker"], r["age"]) for r in ours if r["type"] == "stale_reweight"]
        assert reweights == [(1, 2, 1), (1, 5, 1), (2, 2, 2), (2, 5, 2)]


@pytest.mark.parametrize("size", SIZES)
def test_the_adaptive_window_is_every_rank_s_and_the_gathered_vector_s(runs, size):
    ranks = runs[0][size].result()
    lead = ranks[0]["adaptive"]
    for other in ranks[1:]:
        assert [r["window"] for r in other["adaptive"]["rounds"]] == [r["window"] for r in lead["rounds"]]
        assert all(np.array_equal(a["arrivals"], b["arrivals"]) for a, b in zip(lead["rounds"],
                                                                               other["adaptive"]["rounds"]))
    replay = DeadlineController(**CASES["adaptive"]["controller"])
    for i, got in enumerate(lead["rounds"]):
        if i:  # round 0 builds: not observed
            replay.observe_round(got["arrivals"], step=i)
        assert got["window"] == replay.window, i
    assert lead["rounds"][-1]["window"] < DEADLINE  # it adapted
    assert all(np.isinf(r["arrivals"][list(STRAGGLERS)]).all() for r in lead["rounds"][1:])


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("name", ["int8-ef", "int8-ef-incremental"])
def test_int8_payloads_and_residuals_are_one_rank_s_bit_for_bit(runs, name, size):
    ranks, one = runs[0][size].result(), runs[1].result()
    lead, want = _held_to_one_rank(ranks, one, name)
    payloads = {}
    for rank in ranks:
        mine = rank[name]["payloads"]
        assert all(w // (N // size) == rank[name]["rank"] for _, w in mine)  # each rank submits its own workers
        payloads.update(mine)
    assert sorted(payloads) == sorted(want["payloads"])
    for key, payload in want["payloads"].items():
        for part, value in payload.items():
            assert payloads[key][part].tobytes() == value.tobytes(), (key, part)
    assert lead["ef"].tobytes() == want["ef"].tobytes()
    if name == "int8-ef-incremental":
        stacked = ranks[0]["int8-ef"]
        for key, value in stacked["params"].items():
            assert np.array_equal(lead["params"][key], value), key


@pytest.mark.parametrize("size", SIZES)
def test_worker_momentum_rows_are_one_rank_s(runs, size):
    lead, want = _held_to_one_rank(runs[0][size].result(), runs[1].result(), "momentum")
    assert lead["momentum"].tobytes() == want["momentum"].tobytes()
    assert lead["momentum"].any(axis=1).all()  # every worker arrived in round 0
    assert [r["worker_participation"].tolist() for r in lead["rounds"]] == [
        r["worker_participation"].tolist() for r in want["rounds"]]


@pytest.mark.parametrize("size", SIZES)
def test_secure_digests_are_gathered_and_verified(runs, size):
    lead, want = _held_to_one_rank(runs[0][size].result(), runs[1].result(), "secure")
    auth = SubmissionAuthenticator(b"s3cret", N)
    forged = np.zeros(N, bool)
    forged[5] = True
    for i, (a, b) in enumerate(zip(lead["rounds"], want["rounds"])):
        for key, value in b["secure"].items():
            assert np.array_equal(a["secure"][key], value), (i, key)
        assert np.array_equal(a["secure"]["digest_sent"], a["secure"]["digest_recv"])
        assert auth.process_step(2 * i, a["secure"]["digest_sent"], a["secure"]["digest_recv"]).all()
        verdict = auth.process_step(2 * i + 1, a["secure"]["digest_sent"], a["secure"]["digest_recv"], forged=forged)
        assert verdict.tolist() == (~forged).tolist()


@pytest.mark.parametrize("size", SIZES)
def test_the_lead_s_tree_masks_are_every_rank_s(runs, size):
    ranks, one, _, journals = runs
    _held_to_one_rank(ranks[size].result(), one.result(), "topology")
    lead = ranks[size].result()[0]["topology"]
    out = np.isin(np.arange(N), (2, 3) + STRAGGLERS)  # unit 1.1's leaves excluded, the stragglers late
    assert lead["rounds"][0]["straggler_timeout"].tolist() == np.isin(np.arange(N), (2, 3)).tolist()
    assert all(r["straggler_timeout"].tolist() == out.tolist() for r in lead["rounds"][1:])
    assert all(np.isfinite(r["total_loss"]) for r in lead["rounds"])
    kinds = {r["type"] for r in _journal(journals / ("topology-W%d.jsonl" % size), tevents)}
    assert kinds == {r["type"] for r in _journal(journals / "topology-W1.jsonl", tevents)}
    assert "topology_corruption_verdict" in kinds


@pytest.mark.parametrize("size", SIZES)
def test_a_failed_submission_fails_every_rank_after_the_gather(runs, size):
    ranks, one = runs[0][size].result(), runs[1].result()
    assert one["failure"]["error"] == "bounded-wait: submission unit 4 died mid-round at step 1"
    owner = 4 // (N // size)
    for rank in ranks:
        got = rank["failure"]
        assert len(got["rounds"]) == 1, got["rank"]
        want = (one["failure"]["error"] if got["rank"] == owner
                else "bounded-wait: a submission of rank %d failed at step 1" % owner)
        assert got["error"] == want, got["rank"]

