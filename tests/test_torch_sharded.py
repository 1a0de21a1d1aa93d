"""The port's sharded engine (``RobustEngine(sharding="sharded")``) against
the JAX package's ``ShardedRobustEngine`` on a one-device (1, 1, 1) mesh.

Both engines start from JAX's transformer weights (``params_from_jax``) and
take the same numpy batches; two steps each.  Selections must be identical
(the rule's participation, a mean of 0/1 choices over the buckets, within
1e-6, so a single flipped choice fails) and the parameters and losses agree
within rtol 1e-4 (float32 gradients summed in another order, two steps).

The transformer's own loss drives the signflip and quarantine cases (the k
workers' vmapped gradients through the sharded step).  The other cases hold
the aggregation, so they take the linear loss sum_leaf <p, g_leaf>: its
gradient is the batch's injected per-worker rows ``g_leaf``, the same for
both engines, and JAX compiles it in less than half the transformer's time.

- granularity layer, leaf and global x krum, median and average;
- l1/l2 applied analytically (the reported loss carries the norms once);
- worker momentum; the signflip attack;
- the worker metrics and the quarantine (an inf attacker masked);
- ``secure`` under a chaos forge + tamper schedule at rate 1: the
  verdicts, the probe's NaN rows and the parameters equal JAX's; the
  digests, which hash gradient bits, are held on injected rows;
- ``build_multi_step`` equals the per-step calls bit for bit;
- the constructor's refusals are JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aggregathor_tpu import gars as jgars
from aggregathor_tpu.chaos import ChaosSchedule as JaxChaos
from aggregathor_tpu.core import build_optimizer as jax_optimizer
from aggregathor_tpu.core import build_schedule as jax_schedule
from aggregathor_tpu.models import transformer as jtfm
from aggregathor_tpu.parallel import RobustEngine as JaxEngine
from aggregathor_tpu.parallel import ShardedRobustEngine as JaxSharded
from aggregathor_tpu.parallel import attacks as jattacks
from aggregathor_tpu.parallel import make_mesh as jax_mesh
from aggregathor_tpu.utils import UserException as JaxUserException
from aggregathor_tpu_torch import gars as tgars
from aggregathor_tpu_torch.chaos import ChaosSchedule
from aggregathor_tpu_torch.core import build_optimizer, build_schedule
from aggregathor_tpu_torch.models import transformer as tfm
from aggregathor_tpu_torch.models.common import params_from_jax
from aggregathor_tpu_torch.parallel import RobustEngine, attacks
from aggregathor_tpu_torch.parallel.sharded_engine import ShardedRobustEngine
from aggregathor_tpu_torch.utils import UserException

JCFG = jtfm.TransformerConfig(vocab_size=17, d_model=16, n_heads=2, n_layers=2)
CFG = tfm.TransformerConfig(vocab_size=17, d_model=16, n_heads=2, n_layers=2)
N, BATCH, SEQ = 5, 2, 8
RTOL = 1e-4


@pytest.fixture(autouse=True)
def _two_threads():
    """Two intra-op threads: the tiny model's many small ops stall on a full
    pool when the suite's workers share the cores."""
    previous = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(previous)


def _batches(steps, seed=5):
    rng = np.random.default_rng(seed)
    return [{"tokens": rng.integers(0, 17, size=(N, BATCH, SEQ)).astype(np.int32),
             "targets": rng.integers(0, 17, size=(N, BATCH, SEQ)).astype(np.int32)} for _ in range(steps)]


def _gradient_batches(params, steps, seed=6):
    """Per-worker rows ``g_<leaf>`` for the linear loss: a shared direction
    plus worker i's noise at scale (i + 1) / 2, so the rules' scores stand
    apart."""
    rng = np.random.default_rng(seed)
    scales = (np.arange(N) + 1.0) / 2.0
    out = []
    for _ in range(steps):
        batch = {}
        for name, value in sorted(params.items()):
            base = rng.normal(size=value.shape)
            noise = rng.normal(size=(N,) + value.shape) * scales.reshape((N,) + (1,) * value.ndim)
            batch["g_" + name] = (base + noise).astype(np.float32)
        out.append(batch)
    return out


def _jax_linear(params, batch):
    return sum(jnp.sum(params[name] * batch["g_" + name]) for name in sorted(params))


def _linear(params, batch, grid):
    return sum(torch.sum(params[name] * batch["g_" + name]) for name in sorted(params))


def _run_both(rule, f, steps=2, attack=None, r=0, chaos=None, loss="linear", leaves=None, **options):
    """(JAX params, JAX metrics, port params, port metrics) after ``steps``
    under the ``linear`` or the ``transformer`` loss; the linear loss may
    keep only the named ``leaves`` of the model."""
    jparams = {k: np.asarray(v) for k, v in jtfm.init_params(JCFG, jax.random.PRNGKey(7)).items()
               if leaves is None or k in leaves}
    jspecs = {k: v for k, v in jtfm.param_specs(JCFG).items() if k in jparams}
    tspecs = {k: v for k, v in tfm.param_specs(CFG).items() if k in jparams}
    jtx = jax_optimizer("sgd", jax_schedule("fixed", ["initial-rate:0.1"]))
    ttx = build_optimizer("sgd", build_schedule("fixed", ["initial-rate:0.1"]))
    jeng = JaxSharded(jax_mesh(nb_workers=1), jgars.instantiate(rule, N, f), nb_workers=N, nb_real_byz=r,
                      attack=None if attack is None else jattacks.instantiate(attack, N, r),
                      chaos=None if chaos is None else JaxChaos(chaos, N, nb_real_byz=r), **options)
    teng = RobustEngine(tgars.instantiate(rule, N, f), N, sharding="sharded", device="cpu", nb_real_byz=r,
                        attack=None if attack is None else attacks.instantiate(attack, N, r),
                        chaos=None if chaos is None else ChaosSchedule(chaos, N, nb_real_byz=r), **options)
    jstate = jeng.init_state(lambda key: jparams, jspecs, jtx, seed=1)
    tstate = teng.init_state(lambda seed: params_from_jax(jparams), tspecs, ttx, seed=1)
    if loss == "linear":
        jloss, tloss, batches = _jax_linear, _linear, _gradient_batches(jparams, steps)
    else:
        jloss, tloss, batches = jtfm.make_pipeline_loss(JCFG, 1, 2), tfm.make_pipeline_loss(CFG, 1, 2), _batches(steps)
    jstep = jeng.build_step(jloss, jtx, jstate)
    tstep = teng.build_step(tloss, ttx)
    jmetrics, tmetrics = [], []
    for batch in batches:
        jstate, jm = jstep(jstate, jeng.shard_batch(batch))
        tstate, tm = tstep(tstate, teng.put_batch(batch))
        jmetrics.append(jax.tree_util.tree_map(np.asarray, jm))
        tmetrics.append(tm)
    return ({k: np.asarray(v) for k, v in jax.device_get(jstate.params).items()}, jmetrics,
            {k: v.detach().numpy() for k, v in tstate.params.items()}, tmetrics)


def _close_params(jp, tp):
    for name, value in jp.items():
        np.testing.assert_allclose(tp[name], value, rtol=RTOL, atol=1e-6 * max(1.0, np.abs(value).max()),
                                   err_msg=name)


@pytest.mark.parametrize("rule,f", [("krum", 1), ("median", 1), ("average", 0)])
@pytest.mark.parametrize("granularity", ["layer", "leaf", "global"])
def test_granularity_and_rule_match_jax(granularity, rule, f):
    jp, jm, tp, tm = _run_both(rule, f, granularity=granularity, worker_metrics=True)
    _close_params(jp, tp)
    for want, got in zip(jm, tm):
        np.testing.assert_allclose(float(got["total_loss"]), float(want["total_loss"]), rtol=RTOL)
        np.testing.assert_allclose(float(got["grad_norm"]), float(want["grad_norm"]), rtol=RTOL)
        np.testing.assert_allclose(got["worker_sq_dist"].numpy(), want["worker_sq_dist"], rtol=1e-3)
        if "worker_participation" in want:
            np.testing.assert_allclose(got["worker_participation"].numpy(), want["worker_participation"],
                                       atol=1e-6)
        else:
            assert "worker_participation" not in got


@pytest.mark.parametrize("case", ["l1l2", "momentum", "signflip", "quarantine"])
def test_engine_options_match_jax(case):
    options = {
        "l1l2": dict(rule="average", f=0, granularity="global", l1_regularize=1e-3, l2_regularize=1e-2),
        "momentum": dict(rule="krum", f=1, worker_momentum=0.9),
        "signflip": dict(rule="krum", f=1, attack="signflip", r=1, loss="transformer"),
        "quarantine": dict(rule="krum", f=1, attack="inf", r=1, steps=3, worker_metrics=True,
                           reputation_decay=0.5, quarantine_threshold=0.4, loss="transformer"),
    }[case]
    jp, jm, tp, tm = _run_both(**options)
    _close_params(jp, tp)
    for want, got in zip(jm, tm):
        np.testing.assert_allclose(float(got["total_loss"]), float(want["total_loss"]), rtol=RTOL)
        np.testing.assert_array_equal(got["probe"]["worker_nan_rows"].numpy(), want["probe"]["worker_nan_rows"])
        if case == "quarantine":
            np.testing.assert_allclose(got["worker_reputation"].numpy(), want["worker_reputation"], rtol=1e-6)
            assert int(got["nb_quarantined"]) == int(want["nb_quarantined"])
    if case == "quarantine":
        assert int(tm[-1]["nb_quarantined"]) == 1
    if case == "l1l2":
        # the norms ride the loss once a worker (no replication double count):
        # the first step's loss less the plain one is n (l1 |p| + l2 p^2), as
        # JAX tests/test_transformer.py:141-155 reckons it
        tx = build_optimizer("sgd", build_schedule("fixed", ["initial-rate:0.1"]))
        plain = RobustEngine(tgars.instantiate("average", N, 0), N, sharding="sharded", device="cpu",
                             granularity="global")
        weights = {k: np.asarray(v) for k, v in jtfm.init_params(JCFG, jax.random.PRNGKey(7)).items()}
        state = plain.init_state(lambda seed: params_from_jax(weights), tfm.param_specs(CFG), tx, seed=1)
        _, metrics = plain.build_step(_linear, tx)(state, plain.put_batch(_gradient_batches(weights, 1)[0]))
        norms = sum(1e-3 * np.abs(v).sum() + 1e-2 * (v.astype(np.float64) ** 2).sum() for v in weights.values())
        np.testing.assert_allclose(float(tm[0]["total_loss"]) - float(metrics["total_loss"]), N * norms, rtol=1e-3)


def test_secure_forge_and_tamper_verdicts_match_jax():
    """Four of the leaves, stacked and not: JAX compiles the secure lanes
    once a leaf, so four compile in under half the time of twelve."""
    jp, jm, tp, tm = _run_both("krum", 1, attack=None, r=1, chaos="0:forge=1.0,tamper=1.0", secure=True,
                               leaves=("embed", "final_norm", "w_up", "wq"))
    _close_params(jp, tp)
    for want, got in zip(jm, tm):
        for field in ("forged", "rejected"):
            np.testing.assert_array_equal(got["secure"][field].numpy(), want["secure"][field])
        assert got["secure"]["forged"].tolist() == [True, False, False, False, False]
        np.testing.assert_array_equal(got["probe"]["worker_nan_rows"].numpy(), want["probe"]["worker_nan_rows"])
        assert got["secure"]["digest_sent"].dtype == torch.uint32


def test_secure_digests_on_injected_rows_match_jax():
    """The digest sums over the leaves, leaf i salted i * 0x9E3779B1, on the
    same rows (JAX's ``_submission_pipeline`` with secure and no forgery)."""
    rng = np.random.default_rng(3)
    leaves = [rng.normal(size=(N, 2, 3)).astype(np.float32), rng.normal(size=(N, 7)).astype(np.float32)]
    jeng = JaxSharded(jax_mesh(nb_workers=1), jgars.instantiate("krum", N, 1), nb_workers=N, secure=True)
    teng = RobustEngine(tgars.instantiate("krum", N, 1), N, sharding="sharded", device="cpu", secure=True)
    _, want = jeng._submission_pipeline([jnp.asarray(x) for x in leaves], jax.random.PRNGKey(0), 0, None)
    out, got = teng._sharded_submission([torch.from_numpy(x.copy()) for x in leaves], 1, 0, None)
    for field in ("digest_sent", "digest_recv"):
        np.testing.assert_array_equal(got[field].numpy().astype(np.uint32), np.asarray(want[field]))
    for x, y in zip(out, leaves):
        np.testing.assert_array_equal(x.numpy(), y)


def test_multi_step_equals_per_step():
    exp_params = params_from_jax({k: np.asarray(v) for k, v in jtfm.init_params(JCFG, jax.random.PRNGKey(7)).items()})
    batches = _batches(3)

    def run(multi):
        tx = build_optimizer("sgd", build_schedule("fixed", ["initial-rate:0.1"]))
        eng = ShardedRobustEngine(None, tgars.instantiate("krum", N, 1), nb_workers=N, device="cpu",
                                  worker_momentum=0.5)
        state = eng.init_state(lambda seed: exp_params, tfm.param_specs(CFG), tx, seed=1)
        loss = tfm.make_pipeline_loss(CFG, 1, 2)
        if multi:
            chunk = eng.put_batches({k: np.stack([b[k] for b in batches]) for k in batches[0]})
            state, metrics = eng.build_multi_step(loss, tx)(state, chunk)
            losses = metrics["total_loss"].tolist()
        else:
            step, losses = eng.build_step(loss, tx), []
            for batch in batches:
                state, metrics = step(state, eng.put_batch(batch))
                losses.append(float(metrics["total_loss"]))
        return {k: v.detach().clone() for k, v in state.params.items()}, losses

    (p1, l1), (p2, l2) = run(True), run(False)
    assert l1 == l2
    for name in p1:
        assert torch.equal(p1[name], p2[name]), name


@pytest.mark.parametrize("kwargs", [
    dict(granularity="vector"), dict(granularity="global", rule="hier:g=5,inner=median,outer=average"),
    dict(exchange="int8"), dict(nb_gar=4),
], ids=["vector", "global-iterative", "codec", "gar-n"])
def test_refusals_match_jax(kwargs):
    kwargs = dict(kwargs)
    rule, nb_gar = kwargs.pop("rule", "krum"), kwargs.pop("nb_gar", N)
    with pytest.raises(JaxUserException):
        JaxEngine(jax_mesh(nb_workers=1), jgars.instantiate(rule, nb_gar, 1), nb_workers=N, sharding="sharded",
                  **kwargs)
    with pytest.raises(UserException):
        RobustEngine(tgars.instantiate(rule, nb_gar, 1), N, sharding="sharded", device="cpu", **kwargs)


@pytest.mark.parametrize("transport", ["straggle-drop", "straggle-stale", "lossy-clever", "storm", "empire"])
def test_transport_faults_reach_the_sharded_rows(transport):
    """The per-(worker, leaf) perturbation's transport: a late worker's
    every leaf reads NaN (``straggle-mode=drop``) or its previous
    submission (``stale``: finite, the carry), a fully lossy link under
    CLEVER infills the carry, a drop storm reaches every worker; the
    coalition's omniscient attack keeps the rows finite.  The probe's NaN
    rows say which (port-only: the streams are the port's, trap aq)."""
    tx = build_optimizer("sgd", build_schedule("fixed", ["initial-rate:0.1"]))
    chaos, lossy, r = None, None, 0
    if transport.startswith("straggle"):
        mode = transport.split("-")[1]
        chaos = ChaosSchedule("0:straggle=1.0,straggle-mode=%s" % mode, N, args=["straggle-workers:2"])
    elif transport == "storm":
        chaos = ChaosSchedule("0:drop=0.5", N, args=["packet-coords:64", "min-coords:0"])
    elif transport == "empire":
        r = 2
        chaos = ChaosSchedule("0:attack=empire,epsilon=4.0", N, nb_real_byz=r)
    else:
        from aggregathor_tpu_torch.parallel.lossy import LossyLink

        lossy = LossyLink(1, ["drop-rate:1.0", "min-coords:0", "packet-coords:4", "clever:true"])
    engine = RobustEngine(tgars.instantiate("average-nan", N, 2), N, sharding="sharded", device="cpu", chaos=chaos,
                          lossy_link=lossy, nb_real_byz=r)
    weights = params_from_jax({k: np.asarray(v) for k, v in jtfm.init_params(JCFG, jax.random.PRNGKey(7)).items()})
    state = engine.init_state(lambda seed: weights, tfm.param_specs(CFG), tx, seed=1)
    step = engine.build_step(tfm.make_pipeline_loss(CFG, 1, 2), tx)
    for batch in _batches(2):
        state, metrics = step(state, engine.put_batch(batch))
        nan_rows = metrics["probe"]["worker_nan_rows"].tolist()
        want = {"straggle-drop": [1, 1, 0, 0, 0], "storm": [1] * N}.get(transport, [0] * N)
        assert nan_rows == want
        if transport != "storm":  # a storm at 0.5 leaves a coordinate no row holds
            assert np.isfinite(float(metrics["grad_norm"]))
    if transport in ("straggle-stale", "lossy-clever"):
        # the carry holds what arrived: the stale/infilled rows are finite
        assert all(bool(torch.isfinite(v).all()) for v in state.carry.values())
