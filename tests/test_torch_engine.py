"""The port's engine, optimizers and attacks against the JAX package's.

- From the same weights and batches, 3 robust steps of the MLP
  (``hidden:16``, n = 8) per rule: krum under signflip r=2, bulyan (on
  injected rows, ``torch_injected.py``: trap ay), median, trimmed-mean,
  averaged-median (and krum under the omniscient empire attack).  The JAX engine runs with ``GRAFT_GAR_TIER=pallas``
  (tests/test_pallas.py's force) so its GARs take the Pallas kernel path in
  interpret mode.  Parameters after each step: atol 1e-5 (float32 gradient
  and aggregate sums in another order, scaled by the 0.05 step size).
- One step of cnnet at its full width (d = 1,756,682) with krum under the
  JAX package's default tier: atol 1e-5.
- The five optimizers and three schedules against optax (rtol 1e-6: the
  same formulas in float32, rounded at other places).
- The attacks against the JAX ones (the gaussian attack in distribution,
  since its torch generator cannot reproduce threefry draws).
- The lossy link (``--UDP``): fed the JAX package's own drop draws,
  ``LossyLink.apply`` is bit-identical to JAX's; the port's own draws hit
  the drop rate; ``average-nan`` absorbs the NaN runs, plain ``average`` is
  poisoned by them, and CLEVER's carry keeps ``average`` finite; two steps
  at ``drop-rate:1.0 clever:true`` (every mask deterministic) match the JAX
  engine within rtol 1e-4 / atol 1e-5, carry included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import scipy.stats
import torch

from aggregathor_tpu import gars as jgars
from aggregathor_tpu import models as jmodels
from aggregathor_tpu.core import build_optimizer as jax_optimizer
from aggregathor_tpu.core import build_schedule as jax_schedule
from aggregathor_tpu.parallel import RobustEngine as JaxEngine
from aggregathor_tpu.parallel import attacks as jattacks
from aggregathor_tpu.parallel import lossy as jlossy
from aggregathor_tpu.parallel import make_mesh
from aggregathor_tpu_torch import gars as tgars
from aggregathor_tpu_torch import models as tmodels
from aggregathor_tpu_torch.chaos import ChaosSchedule
from aggregathor_tpu_torch.core import build_optimizer, build_schedule
from aggregathor_tpu_torch.models.common import params_from_jax
from aggregathor_tpu_torch.obs.flight import FlightRecorder
from aggregathor_tpu_torch.parallel import RobustEngine, attacks
from aggregathor_tpu_torch.parallel.lossy import LossyLink
from aggregathor_tpu_torch.utils import UserException

from torch_injected import injected
from torch_threads import pinned_threads  # noqa: F401  (a fixture: the xdist worker's intra-op pool)


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _run_both(experiment, exp_args, rule, n, f, r, attack, steps, lr=0.05, rows=False):
    """Parameters (port dict) after each step of both engines from one init;
    with ``rows`` the model's gradients are injected rows (``torch_injected``)."""
    jexp, texp = jmodels.instantiate(experiment, exp_args), tmodels.instantiate(experiment, exp_args)
    jtx = jax_optimizer("sgd", jax_schedule("fixed", ["initial-rate:%s" % lr]))
    ttx = build_optimizer("sgd", build_schedule("fixed", ["initial-rate:%s" % lr]))
    jatk = jattacks.instantiate(attack, n, r) if attack else None
    tatk = attacks.instantiate(attack, n, r) if attack else None
    jengine = JaxEngine(make_mesh(nb_workers=1), jgars.instantiate(rule, n, f), nb_workers=n,
                        nb_real_byz=r, attack=jatk)
    tengine = RobustEngine(tgars.instantiate(rule, n, f), n, nb_real_byz=r, attack=tatk, device="cpu")
    init = jexp.init(jax.random.PRNGKey(11))
    jstep = jengine.build_step(jexp.loss, jtx)
    tstep = tengine.build_step(texp.loss, ttx)
    jstate = jengine.init_state(init, jtx, seed=1)
    tstate = tengine.init_state(params_from_jax(_host(init)), ttx, seed=1)
    it = jexp.make_train_iterator(n, seed=2)
    if rows:
        jloss, tloss, pairs = injected(_host(init), n, steps)
        jstep, tstep = jengine.build_step(jloss, jtx), tengine.build_step(tloss, ttx)
        it = iter(pairs)
    out = []
    for _ in range(steps):
        jbatch = tbatch = next(it)
        if rows:
            jbatch, tbatch = jbatch
        jstate, jmetrics = jstep(jstate, jengine.shard_batch(jbatch))
        tstate, tmetrics = tstep(tstate, tengine.put_batch(tbatch))
        want = params_from_jax(_host(jstate.params))
        got = {k: v.detach().clone() for k, v in tstate.params.items()}
        out.append((got, want, float(tmetrics["total_loss"]), float(jmetrics["total_loss"])))
    return out


ENGINE_CASES = [
    ("krum", 8, 2, 2, "signflip"),
    ("bulyan", 8, 1, 1, "signflip"),
    ("median", 8, 2, 2, "signflip"),
    ("trimmed-mean", 8, 2, 2, "signflip"),
    ("averaged-median", 8, 2, 2, "zero"),
    ("krum", 8, 2, 2, "empire"),
]


@pytest.mark.parametrize("case", ENGINE_CASES, ids=["%s-%s" % (c[0], c[4]) for c in ENGINE_CASES])
def test_three_steps_match_the_jax_kernel_tier(monkeypatch, case):
    monkeypatch.setenv("GRAFT_GAR_TIER", "pallas")
    rule, n, f, r, attack = case
    # Bulyan on injected rows: its averaged median flips a per-coordinate
    # near-tie (a gap of 4e-9) with the rounding of the MLP's gradients at
    # some intra-op pool sizes (trap ay, torch_injected.py)
    for got, want, tloss, jloss in _run_both("mnist", ["hidden:16", "batch-size:16"], rule, n, f, r, attack, 3,
                                             rows=rule == "bulyan"):
        assert abs(tloss - jloss) <= 1e-5 * max(1.0, abs(jloss))
        for key in want:
            np.testing.assert_allclose(got[key].numpy(), want[key].numpy(), rtol=1e-5, atol=1e-5, err_msg=key)


def test_one_full_width_cnnet_krum_step_matches_the_default_tier():
    (got, want, tloss, jloss), = _run_both("cnnet", ["batch-size:2"], "krum", 8, 2, 2, "signflip", 1)
    assert sum(v.numel() for v in got.values()) == 1756682
    assert abs(tloss - jloss) <= 1e-4 * abs(jloss)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(), rtol=1e-5, atol=1e-5, err_msg=key)


def test_eval_means_match_jax():
    n = 4
    jexp, texp = jmodels.instantiate("mnist", ["hidden:16"]), tmodels.instantiate("mnist", ["hidden:16"])
    jtx = jax_optimizer("sgd", jax_schedule("fixed", []))
    ttx = build_optimizer("sgd", build_schedule("fixed", []))
    jengine = JaxEngine(make_mesh(nb_workers=1), jgars.instantiate("average", n, 0), nb_workers=n)
    tengine = RobustEngine(tgars.instantiate("average", n, 0), n, device="cpu")
    init = jexp.init(jax.random.PRNGKey(5))
    jstate = jengine.init_state(init, jtx, seed=0)
    tstate = tengine.init_state(params_from_jax(_host(init)), ttx, seed=0)
    batch = next(jexp.make_eval_iterator(n))
    want = jengine.build_eval(jexp.metrics)(jstate, jengine.shard_batch(batch))
    got = tengine.build_eval(texp.metrics)(tstate, tengine.put_batch(batch))
    assert set(got) == set(want) == {"accuracy", "cross-entropy"}
    for name in want:
        assert abs(float(got[name]) - float(want[name])) <= 1e-5, name


OPTIMIZERS = [
    ("sgd", []), ("sgd", ["momentum:0.9"]), ("sgd", ["momentum:0.9", "nesterov:true"]),
    ("adam", []), ("adadelta", []), ("adagrad", []), ("rmsprop", []), ("rmsprop", ["momentum:0.5"]),
]
SCHEDULES = [("fixed", ["initial-rate:0.1"]),
             ("polynomial", ["initial-rate:0.1", "end-rate:0.01", "decay-step:3", "power:2"]),
             ("exponential", ["initial-rate:0.1", "decay-step:2", "decay-rate:0.5"])]


@pytest.mark.parametrize("opt, args", OPTIMIZERS, ids=["%s%s" % (o, "-".join(a)) for o, a in OPTIMIZERS])
@pytest.mark.parametrize("schedule, sargs", SCHEDULES, ids=[s[0] for s in SCHEDULES])
def test_optimizers_follow_optax(opt, args, schedule, sargs):
    rng = np.random.default_rng(3)
    shapes = {"a.weight": (4, 3), "a.bias": (4,), "b.weight": (2, 4)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()} for _ in range(5)]
    grads[2]["a.bias"][:] = 0.0  # adagrad's zero-accumulator branch stays reachable
    jtx = jax_optimizer(opt, jax_schedule(schedule, sargs), args)
    ttx = build_optimizer(opt, build_schedule(schedule, sargs), args)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jtx.init(jparams)
    tparams = {k: torch.tensor(v) for k, v in params.items()}
    tstate = ttx.init(tparams)
    for g in grads:
        updates, jstate = jtx.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        ttx.apply(tparams, {k: torch.tensor(v) for k, v in g.items()}, tstate)
        for k in params:
            np.testing.assert_allclose(tparams[k].numpy(), np.asarray(jparams[k]), rtol=1e-6, atol=1e-7)
    assert tstate["count"] == len(grads)


def test_schedules_count_from_zero_like_optax():
    for name, args in SCHEDULES:
        jsched, tsched = jax_schedule(name, args), build_schedule(name, args)
        for count in range(7):
            assert abs(tsched(count) - float(jsched(count))) <= 1e-7, (name, count)


@pytest.mark.parametrize("name", ["signflip", "zero", "inf"])
def test_local_attacks_match(name):
    g = np.random.default_rng(4).normal(size=257).astype(np.float32)
    want = np.asarray(jattacks.instantiate(name, 8, 2).apply_local(jnp.asarray(g), jax.random.PRNGKey(0)))
    got = attacks.instantiate(name, 8, 2).apply_local(torch.tensor(g), torch.Generator()).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name, args", [("empire", []), ("little", []), ("little", ["z:1.5", "negative:false"])])
def test_omniscient_attacks_match(name, args):
    rows = np.random.default_rng(5).normal(size=(8, 300)).astype(np.float32)
    mask = np.arange(8) < 3
    want = np.asarray(jattacks.instantiate(name, 8, 3, args).apply_matrix(
        jnp.asarray(rows), jnp.asarray(mask), jax.random.PRNGKey(0)))
    tattack = attacks.instantiate(name, 8, 3, args)
    got = tattack.apply_matrix(torch.tensor(rows), torch.tensor(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    if name == "little":
        assert abs(tattack.z - jattacks.instantiate(name, 8, 3, args).z) < 1e-6


def test_gaussian_attack_matches_in_distribution():
    d, deviation = 20000, 7.0
    want = np.asarray(jattacks.instantiate("gaussian", 8, 2, ["deviation:%s" % deviation]).apply_local(
        jnp.zeros(d), jax.random.PRNGKey(1)))
    gen = torch.Generator().manual_seed(1)
    got = attacks.instantiate("gaussian", 8, 2, ["deviation:%s" % deviation]).apply_local(
        torch.zeros(d), gen).numpy()
    assert scipy.stats.ks_2samp(got, want).pvalue > 1e-3
    assert abs(np.std(got) / deviation - 1.0) < 0.03 and abs(np.mean(got)) < 0.3


def test_gaussian_streams_are_per_step_and_per_worker():
    from aggregathor_tpu_torch.parallel.engine import stream_generator

    draw = lambda *key: torch.randn(64, generator=stream_generator(*key, torch.device("cpu")))  # noqa: E731
    assert torch.equal(draw(1, 3, 0, 1), draw(1, 3, 0, 1))
    for other in ((1, 4, 0, 1), (1, 3, 1, 1), (2, 3, 0, 1), (1, 3, 0, 2)):
        assert not torch.equal(draw(1, 3, 0, 1), draw(*other))


@pytest.mark.parametrize("option", [
    # a forge regime without its coalition, a secure lane without secure submission
    {"chaos": ChaosSchedule("0:forge=0.5", 8, nb_real_byz=2)},
    {"flight": FlightRecorder(4, 8, secure=True)},
    # the sharded mode is ported: its vector granularity refuses, as JAX's
    {"l1_regularize": 0.1}, {"sharding": "sharded", "granularity": "vector"},
    {"flight": FlightRecorder(4, 8, chaos=True)},
])
def test_unported_engine_features_refuse(option):
    with pytest.raises(UserException):
        RobustEngine(tgars.instantiate("krum", 8, 2), 8, device="cpu", **option)


def test_engine_checks_like_jax():
    gar = tgars.instantiate("krum", 8, 2)
    with pytest.raises(UserException):
        RobustEngine(gar, 8, nb_real_byz=9, device="cpu")
    with pytest.raises(UserException):
        RobustEngine(gar, 8, attack=attacks.instantiate("signflip", 8, 0), device="cpu")
    with pytest.raises(TypeError):
        RobustEngine(gar, 8, device="cpu", no_such_option=1)


# --------------------------------------------------------------------------- #
# The lossy link (--UDP)

LOSSY_CASES = [
    # (nb_lossy, args, worker, d, with previous)
    (4, ["drop-rate:0.3", "packet-coords:64", "min-coords:0"], 1, 1000, False),
    (4, ["drop-rate:0.5", "packet-coords:100", "min-coords:0", "clever:true"], 3, 1001, True),
    (2, ["drop-rate:0.9", "packet-coords:64", "min-coords:0"], 5, 700, False),  # worker >= nb_lossy
    (4, ["drop-rate:0.9", "packet-coords:64", "min-coords:5000"], 0, 4999, False),  # under min-coords
    (4, ["drop-rate:0.01"], 2, 300000, False),  # the defaults: 16,250-coordinate packets
]


@pytest.mark.parametrize("case", LOSSY_CASES, ids=["nan", "clever", "not-lossy", "short-row", "defaults"])
def test_lossy_apply_is_bit_identical_given_the_jax_drops(case):
    nb_lossy, args, worker, d, with_previous = case
    rng = np.random.default_rng(d)
    grad = rng.normal(size=d).astype(np.float32)
    previous = rng.normal(size=d).astype(np.float32) if with_previous else None
    jlink, tlink = jlossy.LossyLink(nb_lossy, args), LossyLink(nb_lossy, args)
    key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(3), worker), 2)
    want = np.asarray(jlink.apply(jnp.asarray(grad), key, worker,
                                  previous=None if previous is None else jnp.asarray(previous)))
    drops = np.array(jax.random.bernoulli(key, jlink.drop_rate, (tlink.nb_packets(d),)))
    got = tlink.apply_rows(torch.from_numpy(grad)[None], [worker], torch.from_numpy(drops)[None],
                           previous=None if previous is None else torch.from_numpy(previous)[None])[0].numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    changed = np.flatnonzero(got.view(np.int32) != grad.view(np.int32))
    if worker < nb_lossy and d >= tlink.min_coords and drops.any():
        assert changed.size and set(changed // tlink.packet_coords) <= set(np.flatnonzero(drops))
    else:
        assert changed.size == 0


def test_lossy_clever_without_previous_refuses_like_jax():
    args = ["min-coords:0", "clever:true"]
    with pytest.raises(UserException):
        LossyLink(2, args).apply_rows(torch.zeros(1, 100), [0], torch.zeros(1, 1, dtype=torch.bool))
    with pytest.raises(Exception, match="previous"):
        jlossy.LossyLink(2, args).apply(jnp.zeros(100), jax.random.PRNGKey(0), 0)


def test_lossy_drop_share_is_the_rate():
    link = LossyLink(8, ["drop-rate:0.07", "packet-coords:16", "min-coords:0"])
    draws = torch.stack([link.draw_drops(16 * 50, seed, step, worker)
                         for seed in range(4) for step in range(10) for worker in range(8)])
    total = draws.numel()
    share = float(draws.sum()) / total
    assert abs(share - 0.07) <= 4 * (0.07 * 0.93 / total) ** 0.5
    assert torch.equal(link.draw_drops(800, 1, 2, 3), link.draw_drops(800, 1, 2, 3))
    assert not torch.equal(link.draw_drops(800, 1, 2, 3), link.draw_drops(800, 1, 3, 3))
    assert link.draw_drops(800, 1, 2, 3).device.type == "cpu"


def _lossy_run(rule, udp_args, steps, clever=False):
    exp = tmodels.instantiate("mnist", ["batch-size:16"])
    tx = build_optimizer("sgd", build_schedule("fixed", ["initial-rate:0.05"]))
    link = LossyLink(4, list(udp_args) + (["clever:true"] if clever else []))
    engine = RobustEngine(tgars.instantiate(rule, 8, 0), 8, lossy_link=link, device="cpu")
    state = engine.init_state(exp.init(42), tx, seed=1)
    step = engine.build_step(exp.loss, tx)
    it = exp.make_train_iterator(8, seed=3)
    losses = []
    for _ in range(steps):
        state, metrics = step(state, engine.put_batch(next(it)))
        losses.append(float(metrics["total_loss"]))
    flat = torch.cat([p.detach().reshape(-1) for p in state.params.values()])
    return engine, state, losses, flat


LOSSY_ARGS = ("drop-rate:0.3", "packet-coords:1024", "min-coords:0")


def test_lossy_link_with_average_nan():
    _, _, losses, flat = _lossy_run("average-nan", LOSSY_ARGS, 25)
    assert losses[-1] < losses[0]
    assert bool(torch.all(torch.isfinite(flat)))


def test_lossy_link_breaks_plain_average():
    _, _, _, flat = _lossy_run("average", LOSSY_ARGS, 3)
    assert not bool(torch.all(torch.isfinite(flat)))


def test_lossy_clever_stale_infill():
    engine, state, losses, flat = _lossy_run("average", LOSSY_ARGS, 25, clever=True)
    assert engine.carries_gradients
    assert state.carry is not None and tuple(state.carry.shape) == (8, flat.numel())
    assert bool(torch.all(torch.isfinite(flat))) and losses[-1] < losses[0]


def test_lossy_clever_steps_match_the_jax_engine():
    n, args = 8, ["drop-rate:1.0", "packet-coords:512", "min-coords:0", "clever:true"]
    jexp, texp = jmodels.instantiate("mnist", ["hidden:16", "batch-size:16"]), tmodels.instantiate(
        "mnist", ["hidden:16", "batch-size:16"])
    jtx = jax_optimizer("sgd", jax_schedule("fixed", ["initial-rate:0.05"]))
    ttx = build_optimizer("sgd", build_schedule("fixed", ["initial-rate:0.05"]))
    jengine = JaxEngine(make_mesh(nb_workers=1), jgars.instantiate("average", n, 0), nb_workers=n,
                        lossy_link=jlossy.LossyLink(3, args))
    tengine = RobustEngine(tgars.instantiate("average", n, 0), n, lossy_link=LossyLink(3, args), device="cpu")
    init = jexp.init(jax.random.PRNGKey(11))
    jstep, tstep = jengine.build_step(jexp.loss, jtx), tengine.build_step(texp.loss, ttx)
    jstate = jengine.init_state(init, jtx, seed=1)
    tstate = tengine.init_state(params_from_jax(_host(init)), ttx, seed=1)
    it = jexp.make_train_iterator(n, seed=2)
    for _ in range(2):
        batch = next(it)
        jstate, _ = jstep(jstate, jengine.shard_batch(batch))
        tstate, _ = tstep(tstate, tengine.put_batch(batch))
        want = params_from_jax(_host(jstate.params))
        for key in want:
            np.testing.assert_allclose(tstate.params[key].detach().numpy(), want[key].numpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=key)
        carry = tstate.carry.numpy()
        np.testing.assert_allclose(carry, np.asarray(jstate.carry), rtol=1e-4, atol=1e-5)
        assert not carry[:3].any()  # every packet of the 3 lossy rows lost: the zero carry stays
