"""The port's bounded-wait protocol (``parallel/bounded.py`` and the engine's
bounded-wait builders) against the JAX package's, on the CPU.

- ``build_worker_grad``: each worker's submission from the same weights and
  batch as JAX's: loss and row within 1e-6 (relative, and 1e-6 of the
  row's largest magnitude), under worker momentum (the momentum row too)
  and a local signflip coalition; under ``int8:ef`` the payload is the JAX
  codec's bits on the port's own row, the residual row its error.
- ``build_bounded_aggregate`` on injected rows, masks and ages, against
  JAX's: krum, median, trimmed-mean, average-nan and average, naive and age
  reweighted, on the f32 and the int8 wire, with momentum and residual
  write-back: krum's selection identical, parameters within 1e-6, the
  masks, counts and coefficients exact.
- The incremental fold against the stacked path, bit for bit; a sequential
  run of the submissions against the step's threads, bit for bit.
- The synchronous protocol against JAX's ``BoundedWaitStep`` and the port's
  fused step (rtol 1e-5); persistent stragglers, stale infill with its
  maximum age, and the average's breakdown: masks equal to JAX's,
  parameters within 1e-5; the trace's per-worker tracks and counters.
- ``close()`` (idempotent, bounded, refuses a new round), a failure inside
  a round at its barrier, one after it at the unit's next dispatch; the
  refusals.

The straggling runs use a calm step 0 (``0:calm 1:straggle=1.0``) and a
stall far beyond the run, so the round that builds has no stall to wait
for and a straggler never lands: the masks do not depend on the clock.
"""

import json
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aggregathor_tpu import gars as jgars
from aggregathor_tpu import models as jmodels
from aggregathor_tpu.chaos import ChaosSchedule as JaxSchedule
from aggregathor_tpu.core import build_optimizer as jax_optimizer
from aggregathor_tpu.core import build_schedule as jax_schedule
from aggregathor_tpu.parallel import RobustEngine as JaxEngine
from aggregathor_tpu.parallel import attacks as jattacks
from aggregathor_tpu.parallel import make_mesh
from aggregathor_tpu.parallel.bounded import BoundedWaitStep as JaxStep
from aggregathor_tpu.parallel.bounded import HostStragglerModel as JaxModel
from aggregathor_tpu.utils import UserException as JaxUserException
from aggregathor_tpu_torch import gars as tgars
from aggregathor_tpu_torch import models as tmodels
from aggregathor_tpu_torch.chaos import ChaosSchedule
from aggregathor_tpu_torch.core import build_optimizer, build_schedule
from aggregathor_tpu_torch.models.common import params_from_jax
from aggregathor_tpu_torch.obs import trace as ttrace
from aggregathor_tpu_torch.obs.metrics import MetricsRegistry
from aggregathor_tpu_torch.parallel import RobustEngine, attacks
from aggregathor_tpu_torch.parallel.bounded import BoundedWaitStep, HostStragglerModel
from aggregathor_tpu_torch.parallel.lossy import LossyLink
from aggregathor_tpu_torch.parallel.mesh import WorkerAxis
from aggregathor_tpu_torch.utils import UserException

from torch_threads import pinned_threads  # noqa: F401  (a fixture: the xdist worker's intra-op pool)

EXP_ARGS = ["hidden:16", "batch-size:16"]
LR = ["initial-rate:0.05"]


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat_jax(tree):
    return np.concatenate([np.ravel(np.asarray(leaf)) for leaf in jax.tree_util.tree_leaves(tree)])


def _params_close(tparams, jparams, rtol, atol):
    want = params_from_jax(_host(jparams))
    for key in want:
        np.testing.assert_allclose(tparams[key].detach().numpy(), want[key].numpy(), rtol=rtol, atol=atol,
                                   err_msg=key)


def _pair(gar="krum", n=8, f=2, r=0, attack=None, **engine_kw):
    """A JAX and a port engine of one configuration on mnist (hidden 16), their
    experiments, optimizers and the JAX weights."""
    jexp, texp = jmodels.instantiate("mnist", EXP_ARGS), tmodels.instantiate("mnist", EXP_ARGS)
    jtx, ttx = jax_optimizer("sgd", jax_schedule("fixed", LR)), build_optimizer("sgd", build_schedule("fixed", LR))
    jengine = JaxEngine(make_mesh(nb_workers=1), jgars.instantiate(gar, n, f), nb_workers=n, nb_real_byz=r,
                        attack=jattacks.instantiate(attack, n, r) if attack else None, **engine_kw)
    tengine = RobustEngine(tgars.instantiate(gar, n, f), n, nb_real_byz=r,
                           attack=attacks.instantiate(attack, n, r) if attack else None, device="cpu", **engine_kw)
    init = _host(jexp.init(jax.random.PRNGKey(11)))  # host arrays: a JAX step donates its state
    return jexp, texp, jtx, ttx, jengine, tengine, init


# --------------------------------------------------------------------- #
# the submission


@pytest.mark.parametrize("options", [
    {}, {"worker_momentum": 0.9}, {"attack": "signflip", "r": 2, "worker_momentum": 0.9},
    {"exchange": "int8:ef"}, {"exchange": "topk:frac=0.05,ef", "attack": "signflip", "r": 2},
    {"exchange_dtype": "bfloat16"},
], ids=["plain", "momentum", "signflip-momentum", "int8-ef", "topk-ef-signflip", "bf16"])
def test_worker_submission_matches_jax(options):
    options = dict(options)
    attack, r = options.pop("attack", None), options.pop("r", 0)
    n = 8
    jexp, texp, jtx, ttx, jengine, tengine, init = _pair(r=r, attack=attack, **options)
    jstate = jengine.init_state(init, jtx, seed=1)
    jgrad, tgrad = jengine.build_worker_grad(jexp.loss), tengine.build_worker_grad(texp.loss)
    tparams = params_from_jax(_host(init))
    batch = next(jexp.make_train_iterator(n, seed=2))
    d = sum(int(np.prod(np.shape(x))) for x in jax.tree_util.tree_leaves(init))
    rng = np.random.default_rng(5)
    momentum = (rng.normal(size=(n, d)) * 0.01).astype(np.float32)
    ef = (rng.normal(size=(n, d)) * 0.001).astype(np.float32)
    codec = tengine.codec
    for w in (0, 1, 5):
        jextra, textra = [], {}
        if "worker_momentum" in options:
            jextra += [jnp.asarray(momentum), jnp.asarray(3, jnp.int32)]
            textra.update(momentum=torch.from_numpy(momentum), momentum_steps=3)
        if tengine.carries_ef:
            jextra += [jnp.asarray(ef)]
            textra["ef"] = torch.from_numpy(ef)
        want = jax.device_get(jgrad(jstate.params, {k: v[w] for k, v in batch.items()}, jstate.rng, 4, w, *jextra))
        got = tgrad(tparams, {k: torch.from_numpy(np.ascontiguousarray(v[w])) for k, v in batch.items()}, 1, 4, w,
                    **textra)
        np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-6)
        assert sorted(got) == sorted(k for k in want if k != "digest")
        if "momentum" in want:
            scale = np.abs(want["momentum"]).max()
            np.testing.assert_allclose(got["momentum"].numpy(), want["momentum"], rtol=1e-6, atol=1e-6 * scale)
        if codec is None:
            row = got["row"].to(torch.float32).numpy()
            want_row = np.asarray(jnp.asarray(want["row"], jnp.float32))
            assert got["row"].dtype == (torch.bfloat16 if "exchange_dtype" in options else torch.float32)
            np.testing.assert_allclose(row, want_row, rtol=1e-6 if "exchange_dtype" not in options else 1e-2,
                                       atol=1e-6 * np.abs(want_row).max())
            if w < r:
                assert np.all(np.sign(row) == np.sign(want_row))
            continue
        # under a codec: the JAX codec's payload bits on the port's own
        # pre-wire row (the submission without the codec), its residual
        # that row's error
        plain = RobustEngine(tgars.instantiate("krum", n, 2), n, nb_real_byz=r,
                             attack=attacks.instantiate(attack, n, r) if attack else None, device="cpu")
        pre = plain.build_worker_grad(texp.loss)(
            tparams, {k: torch.from_numpy(np.ascontiguousarray(v[w])) for k, v in batch.items()}, 1, 4, w)["row"]
        jcodec = jengine.codec
        jpayload, jimage, jnew = jcodec.ef_encode(jnp.asarray(pre.numpy()), jnp.asarray(ef[w]))
        for key in got["row"]:
            assert np.array_equal(got["row"][key].numpy().reshape(-1).view(np.uint8),
                                  np.asarray(jpayload[key]).reshape(-1).view(np.uint8)), key
        assert np.array_equal(got["ef"].numpy().view(np.int32), np.asarray(jnew).view(np.int32))
        # and the JAX submission's own payload decodes to within a quantum
        image = codec.decode(got["row"], d).numpy()
        want_image = np.asarray(jcodec.decode({k: jnp.asarray(v) for k, v in want["row"].items()}, d))
        np.testing.assert_allclose(image, want_image, rtol=0, atol=2.1 * np.abs(want_image).max() / 127)


# --------------------------------------------------------------------- #
# the aggregate


AGG_CASES = [
    ("krum", {}, False), ("krum", {"worker_metrics": True}, True), ("median", {}, True),
    ("trimmed-mean", {}, False), ("average-nan", {}, True), ("average", {}, False),
    ("krum", {"exchange": "int8:ef", "worker_metrics": True}, True), ("average-nan", {"exchange": "int8"}, False),
    ("median", {"worker_momentum": 0.9}, True), ("krum", {"exchange_dtype": "bfloat16"}, False),
]


@pytest.mark.parametrize("gar, options, reweight", AGG_CASES,
                         ids=["%s-%s-%s" % (g, "-".join(sorted("%s" % v for v in o.values())) or "f32",
                                            "reweight" if rw else "naive") for g, o, rw in AGG_CASES])
def test_bounded_aggregate_matches_jax(gar, options, reweight):
    n, f = 8, 2
    jexp, texp, jtx, ttx, jengine, tengine, init = _pair(gar=gar, n=n, f=f, **options)
    jstate = jengine.init_state(init, jtx, seed=1)
    tstate = tengine.init_state(params_from_jax(_host(init)), ttx, seed=1)
    template = _host(init)
    d = _flat_jax(template).size
    rng = np.random.default_rng(7)
    rows = (rng.normal(size=(n, d)) * rng.uniform(0.01, 1.0, size=(n, 1))).astype(np.float32)
    rows[3] *= 50.0  # an outlier krum must leave out
    losses = rng.uniform(1.0, 3.0, size=n).astype(np.float32)
    # workers 0 and 1 timed out, 1 stale at age 3, 6 stale at age 1 (late
    # this round, a carry of last round); the rest arrived
    arrived = np.array([False, False, True, True, True, True, False, True])
    stale = np.array([False, True, False, False, False, False, True, False])
    ages = np.array([2, 3, 0, 0, 0, 0, 1, 0], np.int32)
    jextra, textra = {}, {}
    if reweight:
        jextra["stale_age"], textra["stale_age"] = jnp.asarray(ages), torch.from_numpy(ages)
    if "worker_momentum" in options:
        mom = (rng.normal(size=(n, d)) * 0.1).astype(np.float32)
        jextra["momentum"], textra["momentum"] = jnp.asarray(mom), torch.from_numpy(mom)
    if tengine.carries_ef:
        ef = (rng.normal(size=(n, d)) * 0.01).astype(np.float32)
        jextra["ef"], textra["ef"] = jnp.asarray(ef), torch.from_numpy(ef)
    if tengine.codec is not None:
        # the JAX codec's payloads, stacked, in both (the codecs' bits are
        # held equal by tests/test_torch_codec.py)
        payloads = [jax.device_get(jengine.codec.encode(jnp.asarray(row))) for row in rows]
        jrows = {k: jnp.stack([p[k] for p in payloads]) for k in payloads[0]}
        trows = {k: torch.from_numpy(np.stack([np.asarray(p[k]) for p in payloads])) for k in payloads[0]}
    elif tengine.exchange_dtype is not None:
        jrows = jnp.asarray(rows).astype(jnp.bfloat16)
        trows = torch.from_numpy(rows).to(torch.bfloat16)
    else:
        jrows, trows = jnp.asarray(rows), torch.from_numpy(rows)
    jagg = jengine.build_bounded_aggregate(jtx, template, stale_reweight=reweight)
    tagg = tengine.build_bounded_aggregate(ttx, params_from_jax(template), stale_reweight=reweight)
    for _ in range(2):  # twice: momentum_steps, the state's step and the key move
        jstate, jm = jagg(jstate, jrows, jnp.asarray(losses), jnp.asarray(arrived), jnp.asarray(stale), jextra)
        tstate, tm = tagg(tstate, trows, torch.from_numpy(losses), torch.from_numpy(arrived),
                          torch.from_numpy(stale), textra)
        jm = jax.device_get(jm)
        np.testing.assert_allclose(float(tm["total_loss"]), float(jm["total_loss"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["total_loss"]), float(losses[arrived].sum()), rtol=1e-6)
        for key in ("straggler_timeout", "stale_infill", "nb_timeouts", "nb_stale"):
            assert np.array_equal(tm[key].numpy(), np.asarray(jm[key])), key
        assert int(tm["nb_timeouts"]) == 3 and int(tm["nb_stale"]) == 2
        if reweight:
            assert np.array_equal(tm["stale_reweight_coeff"].numpy(), np.asarray(jm["stale_reweight_coeff"]))
            np.testing.assert_array_equal(tm["stale_reweight_coeff"].numpy(), [1, 0.25, 1, 1, 1, 1, 0.5, 1])
        else:
            assert "stale_reweight_coeff" not in tm and "stale_reweight_coeff" not in jm
        assert np.array_equal(tm["probe"]["worker_nan_rows"].numpy(), np.asarray(jm["probe"]["worker_nan_rows"]))
        if "worker_participation" in jm:
            assert np.array_equal(tm["worker_participation"].numpy(), np.asarray(jm["worker_participation"]))
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
    _params_close(tstate.params, jstate.params, rtol=1e-6, atol=1e-7)
    if gar == "average":
        assert not np.isfinite(float(tm["grad_norm"]))  # a NaN row poisons the plain mean
    assert tstate.step == int(jstate.step) == 2
    if "worker_momentum" in options:
        assert tstate.momentum_steps == int(jstate.momentum_steps) == 2
        np.testing.assert_array_equal(tstate.momentum.numpy(), np.asarray(jstate.momentum))
        assert not np.any(tstate.momentum.numpy()[~arrived])  # never arrived: the zero buffer stays
    if tengine.carries_ef:
        np.testing.assert_array_equal(tstate.ef.numpy(), np.asarray(jstate.ef))


def test_reweight_coefficients_and_damped_mean_are_jax():
    """JAX ``test_bounded.py::test_stale_reweight_coefficient_math``'s numbers:
    average-nan over [1, 2, 3, 100] with the last row stale at age 3 is
    7.75 a coordinate, at age 1 14.0; naive 26.5."""
    n, f = 4, 1
    jexp, texp, jtx, ttx, jengine, tengine, init = _pair(gar="average-nan", n=n, f=f)
    template = _host(init)
    d = _flat_jax(template).size
    rows = torch.from_numpy(np.broadcast_to(np.array([1.0, 2.0, 3.0, 100.0], np.float32)[:, None], (n, d)).copy())
    arrived, stale = torch.tensor([True, True, True, False]), torch.tensor([False, False, False, True])
    for reweight, ages, mean in ((True, [0, 0, 0, 3], 7.75), (True, [0, 0, 0, 1], 14.0), (False, None, 26.5)):
        agg = tengine.build_bounded_aggregate(ttx, params_from_jax(template), stale_reweight=reweight)
        state = tengine.init_state(params_from_jax(template), ttx, seed=1)
        extras = {"stale_age": torch.tensor(ages, dtype=torch.int32)} if reweight else {}
        state, m = agg(state, rows, torch.zeros(n), arrived, stale, extras)
        np.testing.assert_allclose(float(m["grad_norm"]), mean * np.sqrt(d), rtol=1e-5)
        assert bool(m["stale_infill"][3]) and int(m["nb_stale"]) == 1 and int(m["nb_timeouts"]) == 1
        if reweight:
            assert m["stale_reweight_coeff"].tolist() == [1.0, 1.0, 1.0, 1.0 / (1 + ages[3])]


# --------------------------------------------------------------------- #
# the protocol


def _batches(exp, n, steps, seed=3):
    it = exp.make_train_iterator(n, seed=seed)
    return [next(it) for _ in range(steps)]


def _straggler_models(n=8, eligible=2, stall=30.0):
    spec, args = "0:calm 1:straggle=1.0", ["straggle-workers:%d" % eligible]
    return (HostStragglerModel(n, stall, chaos=ChaosSchedule(spec, n, args=args)),
            JaxModel(n, stall, chaos=JaxSchedule(spec, n, args=args)))


def _run_port(tengine, texp, ttx, init, batches, **step_kw):
    tstate = tengine.init_state(params_from_jax(_host(init)), ttx, seed=1)
    step = BoundedWaitStep(tengine, texp.loss, ttx, params_from_jax(_host(init)), **step_kw)
    metrics = []
    try:
        for batch in batches:
            tstate, m = step(tstate, tengine.put_batch(batch))
            metrics.append({k: (v.numpy().copy() if k != "probe" else v["worker_nan_rows"].numpy().copy())
                            for k, v in m.items()})
    finally:
        step.close()
    return tstate, metrics, step


def _run_jax(jengine, jexp, jtx, init, batches, **step_kw):
    jstate = jengine.init_state(init, jtx, seed=1)
    step = JaxStep(jengine, jexp.loss, jtx, jax.device_get(jstate.params), **step_kw)
    metrics = []
    try:
        for batch in batches:
            jstate, m = step(jstate, batch)
            m = jax.device_get(m)
            metrics.append({k: (np.asarray(v) if k != "probe" else np.asarray(v["worker_nan_rows"]))
                            for k, v in m.items()})
    finally:
        step.close()
    return jstate, metrics, step


def test_synchronous_protocol_matches_jax_and_the_fused_step():
    n = 8
    jexp, texp, jtx, ttx, jengine, tengine, init = _pair(gar="median", n=n, f=2)
    batches = _batches(jexp, n, 3)
    tstate, tm, _ = _run_port(tengine, texp, ttx, init, batches)
    jstate, jm, _ = _run_jax(jengine, jexp, jtx, init, batches)
    fstate = tengine.init_state(params_from_jax(_host(init)), ttx, seed=1)
    fused = tengine.build_step(texp.loss, ttx)
    for i, batch in enumerate(batches):
        fstate, fm = fused(fstate, tengine.put_batch(batch))
        assert not tm[i]["straggler_timeout"].any() and not jm[i]["straggler_timeout"].any()
        np.testing.assert_allclose(tm[i]["total_loss"], jm[i]["total_loss"], rtol=1e-5)
        np.testing.assert_allclose(tm[i]["total_loss"], float(fm["total_loss"]), rtol=1e-5)
    _params_close(tstate.params, jstate.params, rtol=1e-5, atol=1e-6)
    for key, value in fstate.params.items():
        np.testing.assert_allclose(tstate.params[key].detach().numpy(), value.detach().numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=key)


@pytest.mark.parametrize("gar, step_kw, eligible", [
    ("krum", {"deadline": 0.5}, 2),
    ("median", {"deadline": 0.5, "stale_infill": True, "stale_max_age": 2}, 2),
    ("trimmed-mean", {"deadline": 0.5, "stale_infill": True, "stale_max_age": 2, "stale_reweight": True}, 2),
    ("average", {"deadline": 0.5}, 1),
], ids=["krum-timeouts", "median-stale", "trimmed-reweight", "average-breakdown"])
def test_stragglers_masks_and_parameters_match_jax(gar, step_kw, eligible):
    n, steps = 8, 5
    jexp, texp, jtx, ttx, jengine, tengine, init = _pair(gar=gar, n=n, f=2)
    batches = _batches(jexp, n, steps)
    tmodel, jmodel = _straggler_models(n, eligible)
    registry = MetricsRegistry()
    tstate, tm, tstep = _run_port(tengine, texp, ttx, init, batches, straggler_model=tmodel, registry=registry,
                                  **step_kw)
    jstate, jm, jstep = _run_jax(jengine, jexp, jtx, init, batches, straggler_model=jmodel, **step_kw)
    for i in range(steps):
        for key in ("straggler_timeout", "stale_infill", "probe", "nb_timeouts", "nb_stale"):
            assert np.array_equal(tm[i][key], jm[i][key]), (i, key)
        late = np.arange(n) < eligible
        assert np.array_equal(tm[i]["straggler_timeout"], late if i else np.zeros(n, bool)), i
    assert np.array_equal(tstep.timeouts_total, jstep.timeouts_total)
    assert np.array_equal(tstep.stale_total, jstep.stale_total)
    if step_kw.get("stale_infill"):
        # a carry of age 1 and 2 re-enters, then the NaN drop (JAX test_bounded.py:283-321)
        assert [bool(m["stale_infill"][0]) for m in tm] == [False, True, True, False, False]
        assert [bool(m["probe"][0]) for m in tm] == [False, False, False, True, True]
        assert registry.snapshot()["stale_infill_rows_total"] == {"worker=0": 2.0, "worker=1": 2.0}
    if step_kw.get("stale_reweight"):
        for i, coeff in ((1, 0.5), (2, 1.0 / 3.0)):
            np.testing.assert_array_equal(tm[i]["stale_reweight_coeff"], jm[i]["stale_reweight_coeff"])
            assert tm[i]["stale_reweight_coeff"][0] == np.float32(coeff)
    if gar == "average":
        # the majority rule is poisoned by the first timeout (JAX test_bounded.py:132-150)
        assert not np.isfinite(tm[-1]["total_loss"]) and not np.isfinite(jm[-1]["total_loss"])
        return
    losses = [float(m["total_loss"]) for m in tm]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    _params_close(tstate.params, jstate.params, rtol=1e-5, atol=1e-6)
    snapshot = registry.snapshot()
    assert snapshot["bounded_wait_rounds_total"] == steps
    assert snapshot["straggler_timeouts_total"] == {"worker=%d" % w: float(steps - 1) for w in range(eligible)}
    assert snapshot["straggler_skipped_rounds_total"] == {"worker=%d" % w: float(steps - 2) for w in range(eligible)}
    assert snapshot["bounded_wait_deadline_seconds"] == 0.5


def test_incremental_fold_is_the_stacked_path_bit_for_bit():
    n = 8
    _, texp, _, ttx, _, tengine, init = _pair(gar="krum", n=n, f=2, exchange="int8:ef", worker_momentum=0.9)
    batches = _batches(texp, n, 4)
    runs = []
    for incremental in (False, True):
        tmodel, _ = _straggler_models(n, 2)
        registry = MetricsRegistry()
        state, metrics, step = _run_port(tengine, texp, ttx, init, batches, deadline=0.5, straggler_model=tmodel,
                                         stale_infill=True, incremental=incremental, registry=registry)
        runs.append((state, metrics, step, registry.snapshot()))
    (a, am, _, _), (b, bm, bstep, snapshot) = runs
    assert [m["total_loss"].tobytes() for m in am] == [m["total_loss"].tobytes() for m in bm]
    for key, value in a.params.items():
        assert torch.equal(value, b.params[key]), key
    assert torch.equal(a.ef.view(torch.int32), b.ef.view(torch.int32))
    assert torch.equal(a.momentum, b.momentum)
    # every arrived row and every stale carry went through the fold
    assert bstep.folds_total == 8 + 3 * 8 and snapshot["exchange_folds_total"] == bstep.folds_total
    assert 0.0 <= snapshot["exchange_overlap_fraction"] <= 1.0
    assert snapshot["exchange_overlapped_folds_total"] == bstep.overlapped_folds_total


def test_concurrent_submissions_equal_sequential_ones():
    """The step's threads against the same submissions run one at a time:
    the rows, and so the parameters, bit for bit."""
    n = 8
    _, texp, _, ttx, _, tengine, init = _pair(gar="krum", n=n, f=2, worker_momentum=0.9, worker_metrics=True)
    batches = _batches(texp, n, 3)
    threaded, _, _ = _run_port(tengine, texp, ttx, init, batches)
    state = tengine.init_state(params_from_jax(_host(init)), ttx, seed=1)
    grad_fn = tengine.build_worker_grad(texp.loss)
    agg_fn = tengine.build_bounded_aggregate(ttx, params_from_jax(_host(init)))
    for batch in batches:
        batch = tengine.put_batch(batch)
        params = {k: v.detach().clone() for k, v in state.params.items()}
        outs = [grad_fn(params, {k: v[w] for k, v in batch.items()}, state.seed, state.step, w,
                        momentum=state.momentum, momentum_steps=state.momentum_steps) for w in range(n)]
        state, _ = agg_fn(state, torch.stack([o["row"] for o in outs]), torch.stack([o["loss"] for o in outs]),
                          torch.ones(n, dtype=torch.bool), torch.zeros(n, dtype=torch.bool),
                          {"momentum": torch.stack([o["momentum"] for o in outs])})
    for key, value in state.params.items():
        assert torch.equal(threaded.params[key], value), key
    assert torch.equal(threaded.momentum, state.momentum)


def test_round_timeline_tracks_and_counters(tmp_path):
    n = 8
    _, texp, _, ttx, _, tengine, init = _pair(gar="median", n=n, f=2, exchange="int8")
    tmodel = HostStragglerModel(n, 0.3, chaos=ChaosSchedule("0:calm 1:straggle=1.0", n,
                                                            args=["straggle-workers:2"]))
    path = str(tmp_path / "t.json")
    ttrace.install(path, run_id="bounded")
    try:
        _run_port(tengine, texp, ttx, init, _batches(texp, n, 3), deadline=0.05, straggler_model=tmodel,
                  stale_infill=True, incremental=True)
        time.sleep(0.4)  # the stalls end (poisoned): no "stall" span without its end
    finally:
        ttrace.uninstall(save=True)
    trace = json.load(open(path))
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    names = {e["args"]["name"] for e in events if e.get("ph") == "M" and e.get("name") == "thread_name"}
    assert {"worker %d" % w for w in range(n)} <= names
    spans = {e["name"] for e in events if e.get("ph") == "X" and e.get("cat") == "bounded"}
    assert {"submit", "stale_infill", "skipped_round", "fold"} <= spans
    counters = {e["name"] for e in events if e.get("ph") == "C"}
    assert {"bounded.arrivals", "bounded.timeouts", "bounded.stale_rows", "bounded.bytes_on_wire",
            "bounded.deadline_window_s", "bounded.overlap_fraction"} <= counters
    assert {"bounded_wait.collect", "bounded_wait.aggregate"} <= {e["name"] for e in events if e.get("ph") == "X"}


# --------------------------------------------------------------------- #
# shutdown, failures, refusals


def _small_step(deadline=0.5, stall=0.6, **kw):
    n = 8
    texp = tmodels.instantiate("mnist", EXP_ARGS)
    ttx = build_optimizer("sgd", build_schedule("fixed", LR))
    engine = RobustEngine(tgars.instantiate("krum", n, 2), n, device="cpu")
    params = texp.init(0)
    model = HostStragglerModel(n, stall, rate=1.0, nb_eligible=2) if stall else None
    step = BoundedWaitStep(engine, texp.loss, ttx, params, deadline=deadline, straggler_model=model, **kw)
    state = engine.init_state(params, ttx, seed=1)
    batches = iter([engine.put_batch(b) for b in _batches(texp, n, 4)])
    return step, state, batches


def test_close_is_idempotent_bounded_and_final():
    step, state, batches = _small_step(stall=30.0)
    step._warm = True  # no round without a deadline: the stalls start in round 1
    state, m = step(state, next(batches))
    assert m["straggler_timeout"].tolist() == [True, True] + [False] * 6
    begin = time.monotonic()
    step.close()
    assert time.monotonic() - begin < 1.0  # the stalled threads wake within a slice
    step.close()
    assert all(fut is None or fut.done() for fut in step._in_flight)
    with pytest.raises(RuntimeError, match="closed"):
        step(state, next(batches))


def test_failures_surface_at_the_barrier_and_at_the_next_dispatch():
    step, state, batches = _small_step(deadline=0.3, stall=0.0)
    original = step.grad_fn

    def poisoned(*args, **kwargs):
        if args[4] == 3:
            raise ValueError("injected submission failure")
        return original(*args, **kwargs)

    step.grad_fn = poisoned
    try:
        with pytest.raises(RuntimeError, match="unit 3 died mid-round"):
            step(state, next(batches))
    finally:
        step.close()
    step, state, batches = _small_step(stall=0.0)
    state, _ = step(state, next(batches))  # round 0: no deadline
    original = step.grad_fn
    released = threading.Event()

    def late(*args, **kwargs):
        if args[4] == 3:
            released.wait(5.0)
            raise ValueError("device fell over")
        return original(*args, **kwargs)

    step.grad_fn = late
    try:
        state, m = step(state, next(batches))
        assert m["straggler_timeout"].tolist() == [False] * 3 + [True] + [False] * 4
        released.set()
        step._in_flight[3].exception(timeout=5.0)
        step.grad_fn = original
        with pytest.raises(RuntimeError, match="unit 3 died after its round closed"):
            step(state, next(batches))
    finally:
        step.close()


def test_refusals_like_jax():
    n = 8
    gar, jgar = tgars.instantiate("krum", n, 2), jgars.instantiate("krum", n, 2)
    mesh = make_mesh(nb_workers=1)
    refused = [
        (RobustEngine(gar, n, granularity="leaf", device="cpu"), JaxEngine(mesh, jgar, n, granularity="leaf")),
        (RobustEngine(gar, n, lossy_link=LossyLink(2, []), device="cpu"), None),
        (RobustEngine(gar, n, chaos=ChaosSchedule("0:straggle=0.5", n), device="cpu"), None),
        # the port's W ranks are processes: one rank only
        (RobustEngine(gar, n, axis=WorkerAxis(n, 2, 0, "cpu")), None),
    ]
    for engine, jengine in refused:
        with pytest.raises(UserException):
            engine.build_worker_grad(lambda p, b: 0.0)
        with pytest.raises(UserException):
            engine.build_bounded_aggregate(None, {"w.bias": torch.zeros(3)})
        if jengine is not None:
            with pytest.raises(JaxUserException):
                jengine.build_worker_grad(lambda p, b: 0.0)
    engine, jengine = RobustEngine(gar, n, device="cpu"), JaxEngine(mesh, jgar, n)
    params = tmodels.instantiate("mnist", EXP_ARGS).init(0)
    with pytest.raises(UserException):
        engine.build_bounded_aggregate(None, params, rows_form="encoded")
    for kwargs in (dict(deadline=-1.0), dict(stale_infill=True), dict(deadline=0.2, stale_reweight=True),
                   dict(deadline=0.2, stale_infill=True, stale_max_age=0)):
        with pytest.raises(UserException):
            BoundedWaitStep(engine, lambda p, b: 0.0, None, params, **kwargs)
        with pytest.raises(JaxUserException):
            JaxStep(jengine, lambda p, b: 0.0, None, {}, **kwargs)
    # the tree's host plane signs the stacked wire rows, which the
    # incremental fold never materializes: both packages refuse the pair
    from aggregathor_tpu.topology import TreeAggregator as JaxTree, parse_topology_spec as jparse
    from aggregathor_tpu_torch.topology import TreeAggregator, parse_topology_spec

    tree = "tree:g=2,rules=median>average-nan"
    with pytest.raises(UserException, match="topology"):
        BoundedWaitStep(engine, lambda p, b: 0.0, None, params, deadline=0.2, incremental=True,
                        topology=TreeAggregator(parse_topology_spec(tree, n, 1)))
    with pytest.raises(JaxUserException, match="topology"):
        JaxStep(jengine, lambda p, b: 0.0, None, {}, deadline=0.2, incremental=True,
                topology=JaxTree(jparse(tree, n, 1)))
    # the placeholder is gone: the engine takes no step_deadline keyword, as JAX's
    with pytest.raises(TypeError):
        RobustEngine(gar, n, device="cpu", step_deadline=1.0)
    with pytest.raises(TypeError):
        JaxEngine(mesh, jgar, n, step_deadline=1.0)
