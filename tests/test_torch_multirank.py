"""The port's worker axis against the JAX engine's, on the CPU.

- W = 2 and W = 4 gloo ranks (``parallel/mesh.py``, spawned once per W with
  every case batched into the one spawn; the rank target lives in
  ``tests/torch_rank_cases.py``, which imports no jax) against the JAX
  engine on the conftest's virtual mesh (``make_mesh(nb_workers=W)``) from
  the same MLP weights and batches: krum n=8 f=2 r=2 signflip, median,
  bulyan n=8 f=1, centered-clip, dnc, ``hier(g=2,inner=centered-clip,
  outer=krum)`` n=16 f=1 and ``--UDP 2`` (drop-rate 1.0) + average-nan.
  Each step's participation support and worker NaN rows are identical,
  losses within rtol 1e-5, the final parameters within rtol 1e-5 and atol
  1e-6 (JAX's own device-count tolerance, ``tests/test_engine.py:60-80``);
  every rank ends with the same parameters, bit for bit.
- The port at W in {1, 2, 4} against itself on the same cases (the same
  tolerance), and at W = 2 against W = 1 under granularity:leaf (the
  per-leaf loop, and bucketed: one all_gather a leaf size), worker
  momentum with the bf16 wire, reputation with quarantine, the lossy link's
  CLEVER carry (the port's own drop draws, keyed by the global worker) and
  the device-sampled trainer (``--input-source device``, 2 calls of 2
  steps).
- The GAR probe over the axis is the one-rank probe's aggregate, block by
  block; the collectives keep bfloat16 and bool bits.
- A checkpoint written at W = 2 restores at W = 4 and W = 1, each
  continuing to the uninterrupted W = 1 run's parameters (rtol 1e-5, atol
  1e-6; the momentum re-zeroes on restore, so the runs carry none).
- Chaos and the wire codec over the axis: a schedule of drop storms, an
  empire coalition and stale stragglers (each rank draws its workers'
  masks from the global worker's streams) and ``int8:ef`` at W = 2 follow
  W = 1, regimes identical and the error-feedback residuals within the
  same tolerance; an ``int8:ef`` snapshot written at W = 2 (the residuals
  gathered from both ranks) restores bit for bit at W = 4 and W = 1 (each
  rank gets its rows by ``broadcast_state``) and continues to the
  uninterrupted W = 1 run.
"""

import jax
import numpy as np
import pytest
import torch

import torch_rank_cases as cases_module
from aggregathor_tpu import gars as jgars
from aggregathor_tpu import models as jmodels
from aggregathor_tpu.core import build_optimizer as jax_optimizer
from aggregathor_tpu.core import build_schedule as jax_schedule
from aggregathor_tpu.parallel import RobustEngine as JaxEngine
from aggregathor_tpu.parallel import attacks as jattacks
from aggregathor_tpu.parallel import lossy as jlossy
from aggregathor_tpu.parallel import make_mesh
from aggregathor_tpu_torch.models.common import params_from_jax
from aggregathor_tpu_torch.parallel import mesh

from torch_threads import pinned_threads  # noqa: F401  (a fixture: the xdist worker's intra-op pool)

STEPS = 3
EXP_ARGS = ["hidden:16", "batch-size:8"]
CHAOS_SPEC = "0:drop=0.3 1:attack=empire,epsilon=4.0 2:straggle=0.5,straggle-mode=stale"

#: (id, rule, n, f, r, attack, udp args)
JAX_CASES = [
    ("krum", "krum", 8, 2, 2, "signflip", None),
    ("median", "median", 8, 2, 2, "signflip", None),
    ("bulyan", "bulyan", 8, 1, 1, "signflip", None),
    ("centered-clip", "centered-clip", 8, 2, 2, "signflip", None),
    ("dnc", "dnc", 8, 2, 2, "signflip", None),
    ("hier", "hier(g=2,inner=centered-clip,outer=krum)", 16, 1, 1, "signflip", None),
    ("udp-average-nan", "average-nan", 8, 2, 0, None, ["drop-rate:1.0", "packet-coords:64", "min-coords:0"]),
]
#: port-only cases at W = 2 against W = 1: (id, rule, n, f, r, attack, engine options, udp args)
OPTION_CASES = [
    ("leaf", "krum", 8, 2, 2, "signflip", {"granularity": "leaf"}, None),
    ("momentum-bf16", "krum", 8, 2, 2, "empire", {"worker_momentum": 0.9, "exchange_dtype": "bfloat16"}, None),
    ("quarantine", "average-nan", 8, 2, 2, "signflip", {"reputation_decay": 0.5, "quarantine_threshold": 0.6}, None),
    # CLEVER's carry of the lossy workers' last rows, on their owning rank
    ("clever", "average", 8, 2, 0, None, {}, ["drop-rate:0.5", "packet-coords:64", "min-coords:0", "clever:true"]),
    # the port's own chaos draws, keyed by the global worker, on its owning rank
    ("chaos", "average-nan", 8, 2, 2, None, {"chaos": CHAOS_SPEC, "chaos_args": ["packet-coords:64"]}, None),
    ("int8-ef", "krum", 8, 2, 2, "signflip", {"exchange": "int8:ef"}, None),
    # the bucketed leaf path: one all_gather a leaf size, (W, L, k, size) to
    # (L, n, size); hidden:10's two 10-wide biases make a bucket of two
    ("leaf-bucketed", "krum", 8, 2, 2, "signflip",
     {"granularity": "leaf", "leaf_bucketing": True, "exp_args": ["hidden:10", "batch-size:8"]}, None),
]
#: codec cases at W = 2 against the JAX engine at W = 2, not against W = 1:
#: the forged matrix crosses the wire again as (n, blk) column blocks, so
#: its int8 scale is a block's, not a row's: (id, rule, n, f, r, attack, exchange)
JAX_CODEC_CASES = [
    ("int8-ef-empire", "krum", 8, 2, 2, "empire", "int8:ef"),
]


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _data(n, exp_args=EXP_ARGS):
    """The MLP's flax weights (as the port's numpy dict) and STEPS global batches."""
    jexp = jmodels.instantiate("mnist", exp_args)
    init = jexp.init(jax.random.PRNGKey(11))
    weights = {k: v.numpy() for k, v in params_from_jax(_host(init)).items()}
    it = jexp.make_train_iterator(n, seed=2)
    return init, weights, [next(it) for _ in range(STEPS)]


def _port_case(case_id, rule, n, f, r, attack, udp=None, options=None):
    options = dict(options or {})
    exp_args = options.pop("exp_args", EXP_ARGS)
    _, weights, batches = _data(n, exp_args)
    case = {"id": case_id, "experiment": "mnist", "exp_args": exp_args, "rule": rule, "n": n, "f": f, "r": r,
            "attack": attack, "chaos": options.pop("chaos", None), "chaos_args": options.pop("chaos_args", []),
            "options": options}
    if udp:
        case.update(udp=2, udp_args=udp)
    return case, weights, batches


PORT_CASES = [_port_case(c, rule, n, f, r, attack, udp=udp) for c, rule, n, f, r, attack, udp in JAX_CASES]
OPTIONS = [_port_case(c, rule, n, f, r, attack, udp=udp, options=opts)
           for c, rule, n, f, r, attack, opts, udp in OPTION_CASES]
CODECS = [_port_case(c, rule, n, f, r, attack, options={"exchange": spec})
          for c, rule, n, f, r, attack, spec in JAX_CODEC_CASES]


def _jax_run(W, rule, n, f, r, attack, udp, exchange=None):
    init, _, batches = _data(n)
    jexp = jmodels.instantiate("mnist", EXP_ARGS)
    jtx = jax_optimizer("sgd", jax_schedule("fixed", ["initial-rate:0.05"]))
    engine = JaxEngine(make_mesh(nb_workers=W), jgars.instantiate(rule, n, f), nb_workers=n, nb_real_byz=r,
                       attack=jattacks.instantiate(attack, n, r) if attack else None,
                       lossy_link=jlossy.LossyLink(2, udp) if udp else None, worker_metrics=True, exchange=exchange)
    step = engine.build_step(jexp.loss, jtx)
    state = engine.init_state(init, jtx, seed=1)
    out = {"loss": [], "participation": [], "worker_nan": []}
    for batch in batches:
        state, metrics = step(state, engine.shard_batch(batch))
        out["loss"].append(float(metrics["total_loss"]))
        part = metrics.get("worker_participation")
        out["participation"].append(None if part is None else np.asarray(part))
        out["worker_nan"].append(np.asarray(metrics["probe"]["worker_nan_rows"]))
    out["params"] = {k: v.numpy() for k, v in params_from_jax(_host(state.params)).items()}
    out["ef"] = None if state.ef is None else np.asarray(state.ef)
    return out


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    """{W: [every rank's results a case]} and the other checks' results:
    one spawn a width, W = 1 in this process.  W = 2 also runs the option
    cases, the GAR probe and the collectives' check and saves a snapshot;
    W = 4 resumes from it."""
    snapshots = str(tmp_path_factory.mktemp("snapshots"))
    (krum, weights, batches), = [c for c in PORT_CASES if c[0]["id"] == "krum"]
    (int8, _, _), = [c for c in OPTIONS if c[0]["id"] == "int8-ef"]
    int8 = dict(int8, snapshot="ef")
    one = mesh.WorkerAxis(8, 1, 0, "cpu")
    runs = {1: [[run] for run in cases_module.run_cases(one, PORT_CASES + OPTIONS)]}
    extra = {"probe1": cases_module.probe_blocks(one, "krum", 8, 2, 1001)[0]}
    extra["sampled1"] = cases_module.run_sampled(one, krum, weights, 4)
    cases = PORT_CASES + OPTIONS + CODECS
    jobs2 = [("run_case", case) for case in cases] + [
        ("probe_blocks", ("krum", 8, 2, 1001)), ("save_after", (krum, weights, batches[:2], snapshots)),
        ("save_after", (int8, weights, batches[:2], snapshots)), ("run_sampled", (krum, weights, 4))]
    ranks = mesh.spawn(cases_module.run_jobs, 2, 8, (jobs2,), device="cpu")
    runs[2] = [[rank[i] for rank in ranks] for i in range(len(cases))]
    extra["probe2"] = [rank[len(cases)] for rank in ranks]
    extra["sampled2"] = ranks[0][-1]
    jobs4 = [("run_case", case) for case in PORT_CASES] + [("resume_from", (krum, weights, batches[2:], snapshots)),
                                                           ("resume_from", (int8, weights, batches[2:], snapshots))]
    ranks = mesh.spawn(cases_module.run_jobs, 4, 8, (jobs4,), device="cpu")
    runs[4] = [[rank[i] for rank in ranks] for i in range(len(PORT_CASES))]
    extra["resume4"] = ranks[0][-2]
    extra["resume_ef4"] = [rank[-1] for rank in ranks]
    extra["resume1"] = cases_module.resume_from(one, krum, weights, batches[2:], snapshots)
    # the residuals the W = 2 snapshot holds, and a W = 1 resume of it
    extra["ef_after2"] = cases_module.run_case(one, int8, weights, batches[:2])["ef"]
    extra["resume_ef1"] = cases_module.resume_from(one, int8, weights, batches[2:], snapshots)
    extra["snapshots"] = snapshots
    return runs, extra


def _assert_residuals_close(got, want, tag):
    """Error-feedback residuals of runs whose parameters agree to rounding:
    within rtol 1e-5 / atol 1e-6, except where a rounding difference moved
    an int8 quantum (at most 1e-4 of the coordinates, each within one
    quantum of its row: twice the row's largest residual)."""
    got, want = np.asarray(got), np.asarray(want)
    off = ~np.isclose(got, want, rtol=1e-5, atol=1e-6)
    assert off.mean() <= 1e-4, (tag, int(off.sum()))
    quantum = 2.0 * np.max(np.abs(want), axis=1, keepdims=True)
    assert np.all(np.abs(got - want)[off] <= np.broadcast_to(quantum, want.shape)[off] * (1 + 1e-5)), tag


def _support(part):
    return None if part is None else (np.asarray(part) > 0).astype(int).tolist()


def _assert_same_run(got, want, tag):
    for s in range(STEPS):
        assert _support(got["participation"][s]) == _support(want["participation"][s]), (tag, s)
        assert np.array_equal(np.asarray(got["worker_nan"][s]) != 0, np.asarray(want["worker_nan"][s]) != 0), (tag, s)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5, err_msg=tag)
    for name in want["params"]:
        np.testing.assert_allclose(got["params"][name], want["params"][name], rtol=1e-5, atol=1e-6,
                                   err_msg="%s %s" % (tag, name))


@pytest.mark.parametrize("W", [2, 4])
@pytest.mark.parametrize("index", range(len(JAX_CASES)), ids=[c[0] for c in JAX_CASES])
def test_port_matches_the_jax_engine_at_the_same_width(port_runs, W, index):
    case_id, rule, n, f, r, attack, udp = JAX_CASES[index]
    ranks = port_runs[0][W][index]
    assert [rank["rank"] for rank in ranks] == list(range(W))
    for rank in ranks[1:]:  # the parameters stay replicated, bit for bit
        assert np.array_equal(cases_module.flat(rank["params"]), cases_module.flat(ranks[0]["params"]))
        assert rank["loss"] == ranks[0]["loss"]
    _assert_same_run(ranks[0], _jax_run(W, rule, n, f, r, attack, udp), "%s W=%d" % (case_id, W))


@pytest.mark.parametrize("W", [2, 4])
@pytest.mark.parametrize("index", range(len(JAX_CASES)), ids=[c[0] for c in JAX_CASES])
def test_port_widths_agree(port_runs, W, index):
    runs = port_runs[0]
    _assert_same_run(runs[W][index][0], runs[1][index][0], "%s W=%d vs 1" % (JAX_CASES[index][0], W))


@pytest.mark.parametrize("index", range(len(OPTION_CASES)), ids=[c[0] for c in OPTION_CASES])
def test_engine_options_at_two_ranks_follow_one(port_runs, index):
    at = len(JAX_CASES) + index
    runs = port_runs[0]
    ranks = runs[2][at]
    assert np.array_equal(cases_module.flat(ranks[1]["params"]), cases_module.flat(ranks[0]["params"]))
    _assert_same_run(ranks[0], runs[1][at][0], OPTION_CASES[index][0])
    assert ranks[0]["regime"] == ranks[1]["regime"] == runs[1][at][0]["regime"]
    if runs[1][at][0]["ef"] is not None:  # every worker's residuals, gathered from both ranks
        _assert_residuals_close(ranks[0]["ef"], runs[1][at][0]["ef"], OPTION_CASES[index][0])


@pytest.mark.parametrize("index", range(len(JAX_CODEC_CASES)), ids=[c[0] for c in JAX_CODEC_CASES])
def test_codec_at_two_ranks_matches_the_jax_engine(port_runs, index):
    case_id, rule, n, f, r, attack, spec = JAX_CODEC_CASES[index]
    ranks = port_runs[0][2][len(PORT_CASES) + len(OPTIONS) + index]
    assert np.array_equal(cases_module.flat(ranks[1]["params"]), cases_module.flat(ranks[0]["params"]))
    want = _jax_run(2, rule, n, f, r, attack, None, exchange=spec)
    _assert_same_run(ranks[0], want, case_id)
    _assert_residuals_close(ranks[0]["ef"], want["ef"], case_id)


def test_gar_probe_and_collectives_over_the_axis(port_runs):
    extra = port_runs[1]
    # the ranks' aggregate blocks, joined and cut to d, are the one-rank aggregate
    joined = np.concatenate([block for block, _ in extra["probe2"]])[:1001]
    np.testing.assert_allclose(joined, extra["probe1"], rtol=1e-6, atol=1e-7)
    for rank, (_, gathered) in enumerate(extra["probe2"]):
        assert gathered["bf16"].tolist() == [[0.5, -1.5], [1.5, -2.5]]  # bf16 exact, rank order
        assert gathered["bool"].tolist() == [[True, False], [False, True]]
        assert gathered["a2a"].tolist() == [float(rank), 10.0 + rank]


def test_checkpoint_written_at_two_ranks_restores_at_any_width(port_runs):
    extra = port_runs[1]
    (case, weights, batches), = [c for c in PORT_CASES if c[0]["id"] == "krum"]
    straight = cases_module.run_case(mesh.WorkerAxis(8, 1, 0, "cpu"), case, weights, batches)
    for W, got in ((4, extra["resume4"]), (1, extra["resume1"])):
        assert got["step"] == 3
        for name in straight["params"]:
            np.testing.assert_allclose(got["params"][name], straight["params"][name], rtol=1e-5, atol=1e-6,
                                       err_msg="W=%d %s" % (W, name))


def test_error_feedback_snapshot_at_two_ranks_restores_at_any_width(port_runs):
    extra = port_runs[1]
    (case, weights, batches), = [c for c in OPTIONS if c[0]["id"] == "int8-ef"]
    straight = cases_module.run_case(mesh.WorkerAxis(8, 1, 0, "cpu"), case, weights, batches)
    saved = torch.load("%s/ef-2.ckpt" % extra["snapshots"], weights_only=True)["ef"].numpy()
    for W, got in ((4, extra["resume_ef4"][0]), (1, extra["resume_ef1"])):
        assert got["step"] == 3
        assert np.array_equal(got["restored_ef"], saved), W  # bit for bit, every rank's rows
        # the W = 2 residuals, restored on every rank's rows
        _assert_residuals_close(got["restored_ef"], extra["ef_after2"], "W=%d restored" % W)
        _assert_residuals_close(got["ef"], straight["ef"], "W=%d" % W)
        for name in straight["params"]:
            np.testing.assert_allclose(got["params"][name], straight["params"][name], rtol=1e-5, atol=1e-6,
                                       err_msg="W=%d %s" % (W, name))
    for rank in extra["resume_ef4"][1:]:
        assert np.array_equal(rank["restored_ef"], extra["resume_ef4"][0]["restored_ef"])


def test_device_sampled_trainer_at_two_ranks_follows_one(port_runs):
    extra = port_runs[1]
    got, want = extra["sampled2"], extra["sampled1"]
    assert len(got["loss"]) == 4
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    for name in want["params"]:
        np.testing.assert_allclose(got["params"][name], want["params"][name], rtol=1e-5, atol=1e-6, err_msg=name)


def test_wider_axis_than_cards_is_refused():
    from aggregathor_tpu_torch.utils import UserException

    with pytest.raises(UserException):
        mesh.WorkerAxis(8, 3, 0, "cpu")  # W must divide n
    with pytest.raises(UserException):  # W ranks on CUDA need W cards (here none)
        mesh.choose_backend("cuda", torch.cuda.device_count() + 1)
    assert mesh.choose_backend("cuda", 2, shared_card=True) == mesh.choose_backend("cpu", 2) == "gloo"
    assert mesh.factor_devices(8) == (2, 2, 2) and mesh.factor_devices(6) == (3, 2, 1)
