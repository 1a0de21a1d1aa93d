"""The bucketed granularity:leaf path and the kernels' batched forms.

The flat engine's ``leaf_bucketing=True`` (and "auto" on a card) stacks the
same-sized parameter leaves into one (L, n, size) tensor and runs one
``torch.func.vmap`` of the rule over it; every kernel wrapper is a custom op
whose batching rule runs the kernel's batched form once
(``ops/kernels.py``).  Here, on the CPU, the batched forms are their plain
versions, held:

- against L calls of the unbatched plain version, bit for bit, and against
  ``jax.vmap`` of the Pallas functions in interpret mode, at the unbatched
  tests' tolerances (tests/test_torch_kernels.py): the median exact, the
  means rtol 1e-6 / atol 1e-6, K1 rtol 1e-5, K2 rtol and atol 1e-4, K6 rtol
  1e-5 / atol 1e-6, the centring within 1 ulp of ``np.nanmedian``;
- the bucketed engine against the port's per-leaf loop for all 31 rule
  names, on injected rows over leaves in buckets {10: 3, 64: 2, 257: 1}: the
  parameters, participation and worker distances at rtol 1e-5 / atol 1e-6,
  the tolerance of JAX's ``test_leaf_bucketed_matches_unrolled``
  (tests/test_engine.py), and the selections (the participation's support)
  identical;
- the bucketed engine against JAX's engine with ``leaf_bucketing=True`` on
  ``mnist`` with ``hidden:10`` (its two 10-wide biases one bucket), on
  injected rows (``torch_injected.py``): the parameters, worker distances,
  participation and reputation at rtol 1e-5 / atol 1e-6.
W = 2 against W = 1 runs in tests/test_torch_multirank.py's two-rank spawn
(its "leaf-bucketed" case); the batched CUDA kernels in
tests/test_torch_gpu.py and chip_smoke.py.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch
from torch.func import vmap

from aggregathor_tpu import gars as jgars
from aggregathor_tpu import models as jmodels
from aggregathor_tpu.core import build_optimizer as jax_optimizer
from aggregathor_tpu.core import build_schedule as jax_schedule
from aggregathor_tpu.ops import pallas_kernels as pk
from aggregathor_tpu.parallel import RobustEngine as JaxEngine
from aggregathor_tpu.parallel import attacks as jattacks
from aggregathor_tpu.parallel import make_mesh
from aggregathor_tpu_torch import gars as tgars
from aggregathor_tpu_torch.cli import runner
from aggregathor_tpu_torch.core import build_optimizer, build_schedule
from aggregathor_tpu_torch.models.common import params_from_jax
from aggregathor_tpu_torch.ops import kernels
from aggregathor_tpu_torch.parallel import RobustEngine, attacks

from torch_injected import injected
from torch_threads import pinned_threads  # noqa: F401  (a fixture: the xdist worker's intra-op pool)

RTOL_MEAN, ATOL_MEAN = 1e-6, 1e-6
RTOL_DIST = 1e-5
RTOL_GRAM = ATOL_GRAM = 1e-4
RTOL_ENGINE, ATOL_ENGINE = 1e-5, 1e-6

#: kernel name -> its integer arguments
INTS = {"coordinate_averaged_median": (6,), "coordinate_trimmed_mean": (2, 4)}


def _stack(L, n, d, seed):
    """(L, n, d) float32 leaves with a NaN row in the first and, in every
    leaf, rows 1 and 2 tied on their first columns."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(L, n, d)).astype(np.float32)
    x[:, 1, : min(d, 5)] = x[:, 2, : min(d, 5)]
    x[0, n // 2] = np.nan
    return x


def _same(got, want):
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))


def _close(got, want, rtol, atol=0.0):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    finite = np.isfinite(want)
    np.testing.assert_array_equal(got[~finite & ~np.isnan(want)], want[~finite & ~np.isnan(want)])
    np.testing.assert_allclose(got[finite], want[finite], rtol=rtol, atol=atol)


@pytest.mark.parametrize("d", [10, 64, 257])
@pytest.mark.parametrize("L", [1, 2, 6])
def test_batched_plain_versions_are_unbatched_calls_bit_for_bit(L, d):
    x = torch.from_numpy(_stack(L, 8, d, L * 1000 + d))
    wide = torch.from_numpy(_stack(L, 70, d, L * 1000 + d + 1))  # beyond 64 rows: the centring and K2
    for name, (_, plain) in kernels.BATCHED.items():
        ints = INTS.get(name, ())
        for rows in (x, wide):
            if name == "pairwise_sq_distances_gram":
                centre = kernels.nanmedian_columns_plain(rows)
                want = torch.stack([kernels.PLAIN[name](rows[b], centre[b]) for b in range(L)])
                _same(plain(rows, centre), want)
            else:
                want = torch.stack([kernels.PLAIN[name](rows[b], *ints) for b in range(L)])
                _same(plain(rows, *ints), want)


@pytest.mark.parametrize("d", [10, 64, 257])
@pytest.mark.parametrize("L", [1, 2, 6])
def test_batched_forms_match_jax_vmap_of_the_pallas_functions(L, d):
    x = _stack(L, 8, d, L * 1000 + d)
    xt = torch.from_numpy(x)
    batched = {name: form for name, (form, _) in kernels.BATCHED.items()}
    np.testing.assert_array_equal(batched["coordinate_median"](xt).numpy(),
                                  np.asarray(jax.vmap(pk.coordinate_median)(x)))
    _close(batched["coordinate_averaged_median"](xt, 6), jax.vmap(lambda g: pk.coordinate_averaged_median(g, 6))(x),
           RTOL_MEAN, ATOL_MEAN)
    _close(batched["coordinate_trimmed_mean"](xt, 2, 4), jax.vmap(lambda g: pk.coordinate_trimmed_mean(g, 2, 4))(x),
           RTOL_MEAN, ATOL_MEAN)
    _close(batched["average_nan_columns"](xt), jax.vmap(pk.average_nan_columns)(x), 1e-5, 1e-6)
    _close(batched["pairwise_sq_distances"](xt),
           jax.vmap(lambda g: pk.pairwise_sq_distances(g, use_mxu=False))(x), RTOL_DIST)
    # the centring: numpy's nanmedian per leaf, within 1 ulp
    want = np.nan_to_num(np.nanmedian(np.where(np.isfinite(x), x, np.nan), axis=1)).astype(np.float32)
    got = batched["nanmedian_columns"](xt).numpy()
    np.testing.assert_array_less(np.abs(got - want), np.spacing(np.abs(want)) + 1e-30)
    # K2 beyond 64 rows, on finite rows (its NaN convention is the kernel's
    # own); the Pallas diagonal is only ~0, as tests/test_torch_kernels.py sets it
    wide = np.random.default_rng(d).normal(size=(L, 70, d)).astype(np.float32)
    want = np.array(jax.vmap(lambda g: pk.pairwise_sq_distances(g, block_d=128))(wide))
    want[:, np.arange(70), np.arange(70)] = 0.0
    _close(batched["pairwise_sq_distances"](torch.from_numpy(wide)), want, RTOL_GRAM, ATOL_GRAM)


@pytest.mark.parametrize("name", sorted(kernels.BATCHED))
def test_vmap_of_a_wrapper_is_one_batched_call(monkeypatch, name):
    """Under ``torch.func.vmap`` each wrapper runs its batched form once, on
    the whole (L, n, d) stack (its plain version on the CPU), and counts no
    unbatched launch."""
    calls = []
    plain = kernels.PLAIN[name]

    def spy(rows, *args):
        calls.append(tuple(rows.shape))
        return plain(rows, *args)

    monkeypatch.setattr(kernels, plain.__name__, spy)
    x = torch.from_numpy(_stack(6, 70 if name == "pairwise_sq_distances_gram" else 8, 33, 5))
    before = kernels.launch_counts()
    wrapper = getattr(kernels, name)
    if name == "pairwise_sq_distances_gram":
        centre = kernels.nanmedian_columns_plain(x)
        got = vmap(wrapper)(x, centre)
        want = torch.stack([plain(x[b], centre[b]) for b in range(6)])
    else:
        ints = INTS.get(name, ())
        got = vmap(lambda rows: wrapper(rows, *ints))(x)
        want = torch.stack([plain(x[b], *ints) for b in range(6)])
    _same(got, want)
    assert calls == [tuple(x.shape)]
    assert kernels.launch_counts() == before


# --------------------------------------------------------------------------- #
# The bucketed engine against the per-leaf loop, every rule name

N = 8
#: leaves in buckets {10: 3, 64: 2, 257: 1}, sizes interleaved so the
#: aggregate's way back to flattening order matters
SHAPES = {"a": (10,), "b": (64,), "c": (2, 5), "d": (257,), "e": (8, 8), "f": (10,)}
#: the meta-rules' specs at n = 8, f = 1
SPECS = {"bucketing": "bucketing:s=2,inner=krum", "hier": "hier:g=2,inner=median,outer=krum",
         "tree": "tree:g=2,rules=median>krum"}


def _injected(steps, seed=6):
    """Per-worker rows ``g_<leaf>`` of the linear loss: a shared direction
    plus worker i's noise at scale (i + 1) / 2, so the scores stand apart."""
    rng = np.random.default_rng(seed)
    scales = (np.arange(N) + 1.0) / 2.0
    out = []
    for _ in range(steps):
        batch = {}
        for name, shape in sorted(SHAPES.items()):
            noise = rng.normal(size=(N,) + shape) * scales.reshape((N,) + (1,) * len(shape))
            batch["g_" + name] = (rng.normal(size=shape) + noise).astype(np.float32)
        out.append(batch)
    return out


def _linear(params, batch):
    return sum(torch.sum(params[name] * batch["g_" + name]) for name in sorted(params))


def _injected_run(rule, bucketing, steps=2):
    rng = np.random.default_rng(1)
    params = {name: torch.from_numpy(rng.normal(size=shape).astype(np.float32)) for name, shape in SHAPES.items()}
    tx = build_optimizer("sgd", build_schedule("fixed", ["initial-rate:0.1"]))
    engine = RobustEngine(tgars.instantiate(SPECS.get(rule, rule), N, 1), N, granularity="leaf",
                          leaf_bucketing=bucketing, worker_metrics=True, device="cpu")
    state = engine.init_state(params, tx, seed=3)
    step = engine.build_step(_linear, tx)
    metrics = []
    for batch in _injected(steps):
        state, m = step(state, engine.put_batch(batch))
        metrics.append(m)
    return torch.cat([p.detach().reshape(-1) for p in state.params.values()]), metrics


@pytest.mark.parametrize("rule", sorted(tgars.itemize()))
def test_bucketed_leaves_match_the_per_leaf_loop(monkeypatch, rule):
    calls = []
    bucketed = RobustEngine._aggregate_per_leaf_bucketed
    monkeypatch.setattr(RobustEngine, "_aggregate_per_leaf_bucketed",
                        lambda self, *args: calls.append(1) or bucketed(self, *args))
    got, got_metrics = _injected_run(rule, True)
    assert len(calls) == 2  # one bucketed aggregation a step
    want, want_metrics = _injected_run(rule, False)
    assert len(calls) == 2
    torch.testing.assert_close(got, want, rtol=RTOL_ENGINE, atol=ATOL_ENGINE)
    for mine, theirs in zip(got_metrics, want_metrics):
        assert sorted(mine) == sorted(theirs)
        torch.testing.assert_close(mine["worker_sq_dist"], theirs["worker_sq_dist"], rtol=RTOL_ENGINE,
                                   atol=ATOL_ENGINE)
        if "worker_participation" in theirs:
            assert torch.equal(mine["worker_participation"] > 0, theirs["worker_participation"] > 0)
            torch.testing.assert_close(mine["worker_participation"], theirs["worker_participation"],
                                       rtol=RTOL_ENGINE, atol=ATOL_ENGINE)


# --------------------------------------------------------------------------- #
# Against JAX's engine with leaf_bucketing=True

MLP = ("mnist", ["hidden:10", "batch-size:16"])
JAX_RULES = ["krum", "median", "bulyan", "average-nan", "trimmed-mean", "averaged-median"]


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("rule", JAX_RULES)
def test_bucketed_steps_match_the_jax_bucketed_engine(rule):
    """Three steps of JAX's bucketed-leaf test setup (n = 8, f = 2, ``little``
    on 2 rows, worker metrics, reputation 0.5; quarantine 0.4 where the rule
    excludes NaN rows), both engines bucketed; Bulyan at f = 1 (n >= 4f + 3).
    The gradients are injected rows over the MLP's leaves (torch_injected.py:
    a model's gradients round with the intra-op pool, trap ay)."""
    f = 1 if rule == "bulyan" else 2
    tolerant = tgars.instantiate(rule, N, f).nan_row_tolerant
    options = dict(granularity="leaf", leaf_bucketing=True, worker_metrics=True, reputation_decay=0.5,
                   quarantine_threshold=0.4 if tolerant else 0.0)
    jexp = jmodels.instantiate(*MLP)
    jtx = jax_optimizer("sgd", jax_schedule("fixed", ["initial-rate:0.05"]))
    ttx = build_optimizer("sgd", build_schedule("fixed", ["initial-rate:0.05"]))
    jengine = JaxEngine(make_mesh(nb_workers=1), jgars.instantiate(rule, N, f), nb_workers=N, nb_real_byz=2,
                        attack=jattacks.instantiate("little", N, 2), **options)
    tengine = RobustEngine(tgars.instantiate(rule, N, f), N, nb_real_byz=2, attack=attacks.instantiate("little", N, 2),
                           device="cpu", **options)
    init = jexp.init(jax.random.PRNGKey(7))
    jloss, tloss, batches = injected(_host(init), N, 3)
    jstep, tstep = jengine.build_step(jloss, jtx), tengine.build_step(tloss, ttx)
    jstate = jengine.init_state(init, jtx, seed=5)
    tstate = tengine.init_state(params_from_jax(_host(init)), ttx, seed=5)
    for jbatch, tbatch in batches:
        jstate, jm = jstep(jstate, jengine.shard_batch(jbatch))
        tstate, tm = tstep(tstate, tengine.put_batch(tbatch))
        jm = _host(jm)
        for key in ("worker_sq_dist", "worker_participation", "worker_reputation"):
            assert (key in tm) == (key in jm), key
            if key in jm:
                np.testing.assert_allclose(tm[key].numpy(), jm[key], rtol=RTOL_ENGINE, atol=ATOL_ENGINE, err_msg=key)
        if "worker_participation" in jm:
            np.testing.assert_array_equal(tm["worker_participation"].numpy() > 0, jm["worker_participation"] > 0)
        want = params_from_jax(_host(jstate.params))
        for key in want:
            np.testing.assert_allclose(tstate.params[key].detach().numpy(), want[key].numpy(), rtol=RTOL_ENGINE,
                                       atol=ATOL_ENGINE, err_msg=key)


def test_bucketed_bucketing_over_krum_matches_jax_with_its_permutations(monkeypatch):
    """The randomized meta-rule under bucketing: each leaf's permutation is
    the one JAX's bucketed engine draws from that leaf's key (trap c), given
    to the port's ``seed_permutation`` for the seed of the same (step, leaf)."""
    from aggregathor_tpu.gars import GAR_KEY_TAG
    from aggregathor_tpu_torch.gars import bucketing
    from aggregathor_tpu_torch.parallel.engine import gar_key
    from aggregathor_tpu_torch.utils import fold_in_seed

    leaf_of = {fold_in_seed(gar_key(5, step), i): (step, i) for step in range(3) for i in range(4)}

    def jax_permutation(seed, n):
        step, i = leaf_of[seed]
        key = jax.random.fold_in(jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(5), step), GAR_KEY_TAG), i)
        return torch.from_numpy(np.asarray(jax.random.permutation(key, n)).astype(np.int64))

    monkeypatch.setattr(bucketing, "seed_permutation", jax_permutation)
    spec, options = "bucketing:s=2,inner=krum", dict(granularity="leaf", leaf_bucketing=True, worker_metrics=True)
    jexp = jmodels.instantiate(*MLP)
    jtx = jax_optimizer("sgd", jax_schedule("fixed", ["initial-rate:0.05"]))
    ttx = build_optimizer("sgd", build_schedule("fixed", ["initial-rate:0.05"]))
    jengine = JaxEngine(make_mesh(nb_workers=1), jgars.instantiate(spec, N, 1), nb_workers=N, **options)
    tengine = RobustEngine(tgars.instantiate(spec, N, 1), N, device="cpu", **options)
    init = jexp.init(jax.random.PRNGKey(7))
    jloss, tloss, batches = injected(_host(init), N, 3)
    jstep, tstep = jengine.build_step(jloss, jtx), tengine.build_step(tloss, ttx)
    jstate = jengine.init_state(init, jtx, seed=5)
    tstate = tengine.init_state(params_from_jax(_host(init)), ttx, seed=5)
    for jbatch, tbatch in batches:
        jstate, jm = jstep(jstate, jengine.shard_batch(jbatch))
        tstate, tm = tstep(tstate, tengine.put_batch(tbatch))
        jm = _host(jm)
        np.testing.assert_array_equal(tm["worker_participation"].numpy() > 0, jm["worker_participation"] > 0)
        np.testing.assert_allclose(tm["worker_participation"].numpy(), jm["worker_participation"], rtol=RTOL_ENGINE,
                                   atol=ATOL_ENGINE)
        want = params_from_jax(_host(jstate.params))
        for key in want:
            np.testing.assert_allclose(tstate.params[key].detach().numpy(), want[key].numpy(), rtol=RTOL_ENGINE,
                                       atol=ATOL_ENGINE, err_msg=key)


# --------------------------------------------------------------------------- #
# The runner's --leaf-bucketing

def _summary_losses(directory):
    events = [json.loads(line) for name in sorted(os.listdir(directory))
              for line in open(os.path.join(directory, name))]
    return {event["step"]: event["total_loss"] for event in events if "total_loss" in event}


RUN = ["--experiment", "mnist", "--experiment-args", "hidden:10", "batch-size:16", "--aggregator", "krum",
       "--nb-workers", "8", "--nb-decl-byz-workers", "2", "--nb-real-byz-workers", "2", "--attack", "little",
       "--granularity", "leaf", "--max-step", "4", "--evaluation-delta", "-1", "--evaluation-period", "-1",
       "--summary-delta", "1", "--checkpoint-period", "-1", "--device", "cpu"]


def test_runner_leaf_bucketing_on_matches_the_per_leaf_loop(tmp_path, monkeypatch):
    """``--leaf-bucketing on`` runs the bucketed path (every step) with the
    losses of ``off``, the per-leaf loop, within rtol 1e-5; ``auto`` on the
    CPU keeps the loop."""
    calls = []
    bucketed = RobustEngine._aggregate_per_leaf_bucketed
    monkeypatch.setattr(RobustEngine, "_aggregate_per_leaf_bucketed",
                        lambda self, *args: calls.append(1) or bucketed(self, *args))
    losses = {}
    for mode in ("on", "off", "auto"):
        before = len(calls)
        runner.main(RUN + ["--leaf-bucketing", mode, "--summary-dir", str(tmp_path / mode)])
        losses[mode] = _summary_losses(tmp_path / mode)
        assert len(calls) - before == (4 if mode == "on" else 0), mode
    assert sorted(losses["on"]) == sorted(losses["off"]) == [1, 2, 3, 4]
    np.testing.assert_allclose([losses["on"][s] for s in range(1, 5)], [losses["off"][s] for s in range(1, 5)],
                               rtol=RTOL_ENGINE)
    assert losses["auto"] == losses["off"]


def test_leaf_bucketing_auto_is_the_loop_on_the_cpu_and_true_is_accepted_for_every_rule():
    for rule in tgars.itemize():
        gar = tgars.instantiate(SPECS.get(rule, rule), N, 1)
        assert RobustEngine(gar, N, granularity="leaf", leaf_bucketing=True, device="cpu").leaf_bucketed
    gar = tgars.instantiate("krum", N, 1)
    assert not RobustEngine(gar, N, granularity="leaf", device="cpu").leaf_bucketed
    assert not RobustEngine(gar, N, granularity="leaf", leaf_bucketing=False, device="cpu").leaf_bucketed
