"""The engine's robustness options in the port against the JAX package's.

From the same weights (``params_from_jax``) and batches, the JAX engine
(``GRAFT_GAR_TIER=pallas``: its GARs take the Pallas kernels in interpret
mode) and the port on the CPU train the MLP (``hidden:16``, n = 8) and
compare, step by step:

- worker momentum (krum under signflip, 3 steps): parameters atol 1e-5
  (float32 sums in another order, scaled by the 0.05 step size), the
  momentum buffer within 1e-6 of its largest entry (the gradients differ by
  a few ulps of their scale, so entries near 0 differ more, relatively;
  measured 2.3e-7 to 3.8e-7 over the 3 steps); the closed form
  (the first momentum step is a plain step) and the restart of the bias
  correction on restore;
- worker metrics: ``worker_participation`` identical (krum, bulyan on injected rows
  (``torch_injected.py``: trap ay); absent
  for median), ``worker_sq_dist`` rtol 1e-5; the runner's summaries carry
  the vectors and an integer ``suspect_worker``;
- reputation and quarantine (krum and average-nan under ``empire``, and
  krum per leaf, 8 steps): ``worker_reputation``, ``nb_quarantined`` and
  the masked rows identical, parameters atol 1e-5; the refusals and the
  budget cap;
- the bf16 wire: ``wire_roundtrip`` bit for bit against ``astype`` (NaN
  as NaN: torch returns another payload) and 3 steps on each granularity;
- ``granularity:leaf`` (krum, bulyan, average): per-leaf selections and
  participation identical, parameters atol 1e-5, leaf ``average`` equal to
  vector ``average``;
- the health probe with a NaN row from ``--UDP`` and with a non-finite
  loss: integer fields identical, float fields rtol 1e-6; the probe under
  ``--unroll`` gains a leading K;
- ``--trace-ops``: the JAX runner's TRACE lines, values aside;
- cnnet ``dtype:bfloat16``: the loss within the JAX package's bound of the
  float32 loss and within 3e-2 relative of the JAX package's bfloat16 loss;
- the runner's new flags: the JAX defaults and choices, and its refusals.

Selections are compared on inputs with no ties: the per-leaf distances
differ in form (the JAX leaf path's direct difference form, the port's K1
plain version) and agree to float tolerance only.
"""

import json
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aggregathor_tpu import gars as jgars
from aggregathor_tpu import models as jmodels
from aggregathor_tpu.cli.runner import build_parser as jax_parser
from aggregathor_tpu.core import build_optimizer as jax_optimizer
from aggregathor_tpu.core import build_schedule as jax_schedule
from aggregathor_tpu.gars.common import pairwise_sq_distances as jax_distances
from aggregathor_tpu.parallel import RobustEngine as JaxEngine
from aggregathor_tpu.parallel import attacks as jattacks
from aggregathor_tpu.parallel import lossy as jlossy
from aggregathor_tpu.parallel import make_mesh
from aggregathor_tpu_torch import gars as tgars
from aggregathor_tpu_torch import models as tmodels
from aggregathor_tpu_torch.cli import runner
from aggregathor_tpu_torch.core import FlatMap, build_optimizer, build_schedule, host_snapshot, load_snapshot
from aggregathor_tpu_torch.models.common import params_from_jax
from aggregathor_tpu_torch.ops import kernels
from aggregathor_tpu_torch.parallel import RobustEngine, attacks
from aggregathor_tpu_torch.parallel.compress import bytes_per_row, wire_roundtrip
from aggregathor_tpu_torch.parallel.engine import quarantine_mask
from aggregathor_tpu_torch.parallel.lossy import LossyLink
from aggregathor_tpu_torch.utils import UserException

from torch_injected import injected
from torch_threads import pinned_threads  # noqa: F401  (a fixture: the xdist worker's intra-op pool)

MLP = ("mnist", ["hidden:16", "batch-size:16"])


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _numpy(metrics):
    """Metrics of either engine as nested dicts of numpy arrays."""
    return {name: _numpy(value) if isinstance(value, dict)
            else (value.detach().cpu().numpy() if isinstance(value, torch.Tensor) else np.asarray(value))
            for name, value in metrics.items()}


class Pair:
    """The JAX engine and the port's, built alike from one init, stepped on
    the same batches."""

    def __init__(self, rule, n=8, f=2, r=0, attack=None, attack_args=(), udp=None, lr=0.05, experiment=MLP,
                 rows=False, **options):
        self.jexp, self.texp = jmodels.instantiate(*experiment), tmodels.instantiate(*experiment)
        jtx = jax_optimizer("sgd", jax_schedule("fixed", ["initial-rate:%s" % lr]))
        self.ttx = build_optimizer("sgd", build_schedule("fixed", ["initial-rate:%s" % lr]))
        links = {}
        if udp is not None:
            links = {"j": jlossy.LossyLink(udp[0], udp[1]), "t": LossyLink(udp[0], udp[1])}
        self.jengine = JaxEngine(make_mesh(nb_workers=1), jgars.instantiate(rule, n, f), nb_workers=n,
                                 nb_real_byz=r,
                                 attack=jattacks.instantiate(attack, n, r, list(attack_args)) if attack else None,
                                 lossy_link=links.get("j"), **options)
        self.tengine = RobustEngine(tgars.instantiate(rule, n, f), n, nb_real_byz=r,
                                    attack=attacks.instantiate(attack, n, r, list(attack_args)) if attack else None,
                                    lossy_link=links.get("t"), device="cpu", **options)
        init = self.jexp.init(jax.random.PRNGKey(11))
        self.jstep = self.jengine.build_step(self.jexp.loss, jtx)
        self.jmulti = self.jengine.build_multi_step(self.jexp.loss, jtx)
        self.tstep = self.tengine.build_step(self.texp.loss, self.ttx)
        self.tmulti = self.tengine.build_multi_step(self.texp.loss, self.ttx)
        self.jstate = self.jengine.init_state(init, jtx, seed=1)
        self.tstate = self.tengine.init_state(params_from_jax(_host(init)), self.ttx, seed=1)
        self.it = self.jexp.make_train_iterator(n, seed=2)
        self.rows = None
        if rows:  # the model's gradients are injected rows (torch_injected.py), step() only
            jloss, tloss, pairs = injected(_host(init), n, 8)
            self.jstep, self.tstep = self.jengine.build_step(jloss, jtx), self.tengine.build_step(tloss, self.ttx)
            self.rows = iter(pairs)

    def step(self):
        jbatch, tbatch = next(self.rows) if self.rows is not None else (next(self.it),) * 2
        self.jstate, jmetrics = self.jstep(self.jstate, self.jengine.shard_batch(jbatch))
        self.tstate, tmetrics = self.tstep(self.tstate, self.tengine.put_batch(tbatch))
        return _numpy(jmetrics), _numpy(tmetrics)

    def multi_step(self, count):
        batches = [next(self.it) for _ in range(count)]
        stacked = {key: np.stack([b[key] for b in batches]) for key in batches[0]}
        self.jstate, jmetrics = self.jmulti(self.jstate, self.jengine.shard_batches(stacked))
        self.tstate, tmetrics = self.tmulti(self.tstate, self.tengine.put_batches(stacked))
        return _numpy(jmetrics), _numpy(tmetrics)

    def assert_params_close(self, atol=1e-5):
        want = params_from_jax(_host(self.jstate.params))
        for key in want:
            np.testing.assert_allclose(self.tstate.params[key].detach().numpy(), want[key].numpy(),
                                       rtol=1e-5, atol=atol, err_msg=key)


def _assert_probe_matches(jprobe, tprobe):
    assert sorted(jprobe) == sorted(tprobe)
    for name in ("loss_finite", "worker_nan_rows"):
        assert tprobe[name].dtype == np.int32
        np.testing.assert_array_equal(tprobe[name], jprobe[name], err_msg=name)
    for name in ("update_norm", "spike"):
        np.testing.assert_allclose(tprobe[name], jprobe[name], rtol=1e-6, err_msg=name)


@pytest.fixture(autouse=True)
def _pallas_tier(monkeypatch):
    monkeypatch.setenv("GRAFT_GAR_TIER", "pallas")


# --------------------------------------------------------------------------- #
# Worker momentum

def test_worker_momentum_steps_match_the_jax_engine():
    pair = Pair("krum", r=2, attack="signflip", worker_momentum=0.9)
    for k in range(3):
        jm, tm = pair.step()
        assert abs(float(tm["total_loss"]) - float(jm["total_loss"])) <= 1e-5 * abs(float(jm["total_loss"]))
        pair.assert_params_close()
        assert pair.tstate.momentum_steps == int(pair.jstate.momentum_steps) == k + 1
        got, want = pair.tstate.momentum.numpy(), np.asarray(pair.jstate.momentum)
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def _one_step_params(worker_momentum, device="cpu"):
    exp = tmodels.instantiate("mnist", ["hidden:16", "batch-size:8"])
    tx = build_optimizer("sgd", build_schedule("fixed", ["initial-rate:0.1"]))
    engine = RobustEngine(tgars.instantiate("average", 1, 0), 1, worker_momentum=worker_momentum, device=device)
    state = engine.init_state(exp.init(0), tx)
    state, _ = engine.build_step(exp.loss, tx)(state, engine.put_batch(next(exp.make_train_iterator(1, seed=5))))
    return torch.cat([p.detach().reshape(-1) for p in state.params.values()])


def test_worker_momentum_matches_closed_form():
    # the bias correction makes the first momentum step a plain SGD step
    torch.testing.assert_close(_one_step_params(0.9), _one_step_params(None), rtol=1e-5, atol=1e-6)


def test_worker_momentum_multi_step_matches_single():
    exp = tmodels.instantiate("mnist", ["hidden:16", "batch-size:16"])
    tx = build_optimizer("sgd", build_schedule("fixed", ["initial-rate:0.05"]))
    engine = RobustEngine(tgars.instantiate("average", 4, 0), 4, worker_momentum=0.8, device="cpu")
    it = exp.make_train_iterator(4, seed=9)
    batches = [next(it) for _ in range(4)]
    single = engine.init_state(exp.init(0), tx)
    step = engine.build_step(exp.loss, tx)
    for batch in batches:
        single, _ = step(single, engine.put_batch(batch))
    multi = engine.init_state(exp.init(0), tx)
    multi, _ = engine.build_multi_step(exp.loss, tx)(
        multi, engine.put_batches({key: np.stack([b[key] for b in batches]) for key in batches[0]}))
    for key in single.params:
        assert torch.equal(single.params[key], multi.params[key]), key
    assert torch.equal(single.momentum, multi.momentum) and single.momentum_steps == multi.momentum_steps == 4


def test_worker_momentum_bias_correction_restarts_on_restore():
    """A restore zeroes the momentum and its update count, so the first step
    after it is a plain step on the restored parameters (JAX
    ``test_worker_momentum_bias_correction_restarts_on_restore``)."""
    exp = tmodels.instantiate("mnist", ["hidden:16", "batch-size:8"])
    tx = build_optimizer("sgd", build_schedule("fixed", ["initial-rate:0.1"]))
    engine = RobustEngine(tgars.instantiate("average", 4, 0), 4, worker_momentum=0.9, device="cpu")
    step = engine.build_step(exp.loss, tx)
    state = engine.init_state(exp.init(0), tx)
    it = exp.make_train_iterator(4, seed=1)
    for _ in range(3):
        state, _ = step(state, engine.put_batch(next(it)))
    snapshot = host_snapshot(state)
    for _ in range(2):
        state, _ = step(state, engine.put_batch(next(it)))
    load_snapshot(state, snapshot)
    assert state.momentum_steps == 0 and not bool(torch.any(state.momentum))
    batch = next(it)
    state, _ = step(state, engine.put_batch(batch))
    plain = RobustEngine(tgars.instantiate("average", 4, 0), 4, device="cpu")
    pstate = plain.init_state(snapshot["params"], tx)
    pstate, _ = plain.build_step(exp.loss, tx)(pstate, plain.put_batch(batch))
    for key in state.params:
        torch.testing.assert_close(state.params[key], pstate.params[key], rtol=1e-4, atol=1e-6)


# --------------------------------------------------------------------------- #
# Worker metrics

@pytest.mark.parametrize("rule,f", [("krum", 2), ("bulyan", 1), ("median", 2)])
def test_worker_metrics_match_the_jax_engine(rule, f):
    # Bulyan on injected rows: the MLP's gradients flip one of its averaged
    # median's near-ties at some intra-op pool sizes (trap ay, torch_injected.py)
    pair = Pair(rule, f=f, r=f, attack="signflip", worker_metrics=True, rows=rule == "bulyan")
    for _ in range(3):
        jm, tm = pair.step()
        assert sorted(tm) == sorted(jm)
        np.testing.assert_allclose(tm["worker_sq_dist"], jm["worker_sq_dist"], rtol=1e-5)
        if rule == "median":
            assert "worker_participation" not in tm
        else:
            np.testing.assert_array_equal(tm["worker_participation"], jm["worker_participation"])
            np.testing.assert_allclose(tm["worker_participation"].sum(), 1.0, rtol=1e-6)
        pair.assert_params_close()


def test_worker_metrics_summaries(tmp_path):
    """The summary JSONL carries the per-worker vectors and the deviation-100
    attacker as an integer ``suspect_worker`` (JAX ``test_cli.py``)."""
    sum_dir = str(tmp_path / "sum")
    runner.main(["--experiment", "mnist", "--experiment-args", "hidden:16", "batch-size:8", "--aggregator", "krum",
                 "--nb-workers", "4", "--nb-decl-byz-workers", "1", "--nb-real-byz-workers", "1",
                 "--attack", "gaussian", "--attack-args", "deviation:100", "--worker-metrics", "--max-step", "6",
                 "--evaluation-delta", "-1", "--evaluation-period", "-1", "--summary-dir", sum_dir,
                 "--summary-delta", "2", "--device", "cpu"])
    [name] = os.listdir(sum_dir)
    events = [json.loads(line) for line in open(os.path.join(sum_dir, name))]
    assert [event["step"] for event in events] == [1, 3, 5, 6]
    for event in events:
        assert len(event["worker_sq_dist"]) == 4 and len(event["worker_participation"]) == 4
        assert event["suspect_worker"] == 0 and isinstance(event["suspect_worker"], int)
        assert event["worker_participation"][0] == 0.0


# --------------------------------------------------------------------------- #
# Reputation and quarantine

@pytest.mark.parametrize("rule,granularity", [("krum", "vector"), ("average-nan", "vector"), ("krum", "leaf")])
def test_reputation_and_quarantine_match_the_jax_engine(rule, granularity):
    pair = Pair(rule, r=2, attack="empire", attack_args=["epsilon:4.0"], worker_metrics=True, reputation_decay=0.5,
                quarantine_threshold=0.4, granularity=granularity)
    quarantined_steps = 0
    for _ in range(8):
        before = pair.tstate.reputation.clone()
        jm, tm = pair.step()
        assert sorted(tm) == sorted(jm)
        np.testing.assert_array_equal(tm["worker_reputation"], jm["worker_reputation"])
        assert int(tm["nb_quarantined"]) == int(jm["nb_quarantined"])
        masked = quarantine_mask(before, 0.4, 2).numpy()
        quarantined_steps += bool(masked.any())
        # the masked rows are the ones the rule saw as NaN
        np.testing.assert_array_equal(np.isnan(tm["worker_sq_dist"]), masked)
        np.testing.assert_array_equal(np.isnan(jm["worker_sq_dist"]), masked)
        finite = ~masked
        np.testing.assert_allclose(tm["worker_sq_dist"][finite], jm["worker_sq_dist"][finite], rtol=1e-5)
        if "worker_participation" in jm:
            np.testing.assert_array_equal(tm["worker_participation"], jm["worker_participation"])
        _assert_probe_matches(jm["probe"], tm["probe"])
        pair.assert_params_close()
    reputation = pair.tstate.reputation.numpy()
    assert reputation[:2].max() < 0.1 and reputation[2:].min() > 0.9, reputation
    assert quarantined_steps >= 5


def test_quarantine_refusals_follow_jax():
    with pytest.raises(UserException):  # plain average propagates NaN
        RobustEngine(tgars.instantiate("average", 4, 0), 4, reputation_decay=0.5, quarantine_threshold=0.5,
                     device="cpu")
    # median shifts under NaN rows rather than excluding them; the message names the rules that do
    with pytest.raises(UserException, match="NaN-excluding rule: average-nan, "):
        RobustEngine(tgars.instantiate("median", 4, 1), 4, reputation_decay=0.5, quarantine_threshold=0.5,
                     device="cpu")
    with pytest.raises(UserException):  # threshold without decay
        RobustEngine(tgars.instantiate("krum", 4, 1), 4, quarantine_threshold=0.5, device="cpu")
    with pytest.raises(UserException):  # decay out of bounds
        RobustEngine(tgars.instantiate("krum", 4, 1), 4, reputation_decay=1.5, device="cpu")
    with pytest.raises(UserException):  # f = 0: the mask budget is empty
        RobustEngine(tgars.instantiate("average-nan", 4, 0), 4, reputation_decay=0.5, quarantine_threshold=0.5,
                     device="cpu")
    with pytest.raises(UserException):
        RobustEngine(tgars.instantiate("krum", 4, 1), 4, worker_momentum=1.0, device="cpu")


def test_quarantine_is_capped_at_the_declared_budget():
    """Four reputations below the threshold, f = 2: two rows are masked and
    krum stays finite, as in the JAX engine."""
    pair = Pair("krum", worker_metrics=True, reputation_decay=0.9, quarantine_threshold=0.5)
    low = np.asarray([0.1, 0.2, 0.3, 0.4, 1, 1, 1, 1], np.float32)
    pair.tstate.reputation = torch.tensor(low)
    pair.jstate = pair.jengine.put_state(pair.jstate.replace(reputation=low))
    jm, tm = pair.step()
    assert int(tm["nb_quarantined"]) == int(jm["nb_quarantined"]) == 2
    np.testing.assert_array_equal(np.isnan(tm["worker_sq_dist"]), [1, 1, 0, 0, 0, 0, 0, 0])
    np.testing.assert_array_equal(tm["worker_reputation"], jm["worker_reputation"])
    pair.assert_params_close()


def test_quarantined_worker_is_really_excluded():
    """average-nan with worker 3 quarantined: exactly SGD on the mean of
    workers 0-2's gradients."""
    exp = tmodels.instantiate("mnist", ["hidden:16", "batch-size:8"])
    tx = build_optimizer("sgd", build_schedule("fixed", ["initial-rate:0.1"]))
    engine = RobustEngine(tgars.instantiate("average-nan", 4, 1), 4, reputation_decay=0.9,
                          quarantine_threshold=0.5, device="cpu")
    state = engine.init_state(exp.init(0), tx)
    params0 = {key: value.detach().clone() for key, value in state.params.items()}
    state.reputation = torch.tensor([1.0, 1.0, 1.0, 0.1])
    batch = next(exp.make_train_iterator(4, seed=5))
    state, _ = engine.build_step(exp.loss, tx)(state, engine.put_batch(batch))
    grads = [torch.func.grad(exp.loss)(params0, {k: torch.as_tensor(v[i]) for k, v in batch.items()})
             for i in range(3)]
    for key in params0:
        want = params0[key] - 0.1 * sum(g[key] for g in grads) / 3.0
        torch.testing.assert_close(state.params[key].detach(), want, rtol=1e-5, atol=1e-6)


def test_participation_maps_non_finite_distances():
    """K2 on the card writes NaN for every non-finite distance where the
    plain version keeps +inf: the selection and participation must not
    change (a quarantined NaN row at n > 64)."""
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((72, 257), generator=gen) * (1.0 + 0.03 * torch.arange(72.0))[:, None]
    x[5] = float("nan")
    x[9, 3] = float("inf")
    dist2 = kernels.pairwise_sq_distances(x)
    as_card = torch.where(torch.isfinite(dist2), dist2, torch.nan)
    assert bool(torch.any(torch.isinf(dist2))) and not bool(torch.any(torch.isinf(as_card)))
    for rule in ("krum", "bulyan"):
        gar = tgars.instantiate(rule, 72, 8)
        assert torch.equal(gar.worker_participation(dist2), gar.worker_participation(as_card))
        assert float(gar.worker_participation(dist2)[5]) == 0.0
        agg, part = gar.aggregate_block_and_participation(x, dist2)
        assert torch.equal(part, gar.worker_participation(dist2))
        torch.testing.assert_close(agg, gar.aggregate_block(x, dist2), rtol=0, atol=0, equal_nan=True)


# --------------------------------------------------------------------------- #
# The bf16 wire

def test_wire_roundtrip_is_bit_identical_to_jax():
    special = np.array([np.inf, -np.inf, np.nan, -np.nan, 0.0, -0.0, 1.0,
                        1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8, -(1.0 + 2.0 ** -8),  # rounding ties (to even)
                        1e-40, -1e-40, 1.1754942e-38, 1e-45, 3.4e38, 3.3961776e38], np.float32)
    gen = np.random.default_rng(4)
    x = np.concatenate([special, gen.standard_normal(4096).astype(np.float32),
                        (gen.standard_normal(256) * 1e-39).astype(np.float32)]).reshape(4, -1)
    got = wire_roundtrip(torch.from_numpy(x), torch.bfloat16).numpy()
    want = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got.view(np.uint32)[~nan], want.view(np.uint32)[~nan])
    rows = torch.from_numpy(x)
    assert wire_roundtrip(rows, None) is rows  # the float32 wire is the identity
    assert bytes_per_row(10, torch.bfloat16) == 20 and bytes_per_row(10) == 40


@pytest.mark.parametrize("granularity", ["vector", "leaf"])
@pytest.mark.parametrize("attack", ["signflip", "empire"])
def test_bf16_wire_steps_match_the_jax_engine(granularity, attack):
    pair = Pair("krum", r=2, attack=attack, exchange_dtype="bfloat16", granularity=granularity,
                worker_metrics=True)
    for _ in range(3):
        jm, tm = pair.step()
        np.testing.assert_array_equal(tm["worker_participation"], jm["worker_participation"])
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
        pair.assert_params_close()


# --------------------------------------------------------------------------- #
# granularity:leaf

@pytest.mark.parametrize("rule,f,r,attack", [("krum", 2, 2, "signflip"), ("bulyan", 1, 1, "signflip"),
                                             ("average", 0, 0, None), ("krum", 2, 2, "little")])
def test_leaf_granularity_matches_the_jax_engine(rule, f, r, attack):
    pair = Pair(rule, f=f, r=r, attack=attack, granularity="leaf", worker_metrics=True)
    for _ in range(3):
        jm, tm = pair.step()
        assert sorted(tm) == sorted(jm)
        if "worker_participation" in jm:
            np.testing.assert_array_equal(tm["worker_participation"], jm["worker_participation"])
        np.testing.assert_allclose(tm["worker_sq_dist"], jm["worker_sq_dist"], rtol=1e-5)
        pair.assert_params_close()


@pytest.mark.parametrize("rule,f", [("krum", 2), ("bulyan", 1)])
def test_per_leaf_selections_are_identical(rule, f):
    """On the same (n, d) rows, each leaf's selection from the port's leaf
    path equals the JAX rule's on that leaf's JAX distances."""
    n = 8
    exp = tmodels.instantiate(*MLP)
    flatmap = FlatMap(exp.init(0))
    gen = torch.Generator().manual_seed(5)
    rows = torch.randn((n, flatmap.size), generator=gen) * (1.0 + 0.1 * torch.arange(float(n)))[:, None]
    engine = RobustEngine(tgars.instantiate(rule, n, f), n, worker_metrics=True, granularity="leaf", device="cpu")
    seen = []
    inner = engine.gar.aggregate_block_and_participation

    def record(block, dist2=None):
        agg, part = inner(block, dist2)
        seen.append(part)
        return agg, part

    engine.gar.aggregate_block_and_participation = record
    engine._aggregate_per_leaf(rows, flatmap, None)
    jgar = jgars.instantiate(rule, n, f)
    assert len(seen) == len(flatmap.slices) == 4
    for part, (_, _, offset, size, _, _) in zip(seen, flatmap.slices):
        leaf = jnp.asarray(rows[:, offset:offset + size].numpy())
        want = np.asarray(jgar.worker_participation(jnp.maximum(jax_distances(leaf), 0.0)))
        np.testing.assert_array_equal(part.numpy(), want)


def test_leaf_average_equals_vector_average():
    exp = tmodels.instantiate(*MLP)
    tx = build_optimizer("sgd", build_schedule("fixed", ["initial-rate:0.05"]))
    out = {}
    for granularity in ("vector", "leaf"):
        engine = RobustEngine(tgars.instantiate("average", 8, 0), 8, granularity=granularity, device="cpu")
        state = engine.init_state(exp.init(0), tx)
        step = engine.build_step(exp.loss, tx)
        it = exp.make_train_iterator(8, seed=2)
        for _ in range(3):
            state, _ = step(state, engine.put_batch(next(it)))
        out[granularity] = torch.cat([p.detach().reshape(-1) for p in state.params.values()])
    torch.testing.assert_close(out["leaf"], out["vector"], rtol=1e-5, atol=1e-6)


def test_leaf_options_refuse_like_jax():
    gar = tgars.instantiate("krum", 8, 2)
    for granularity in ("layer", "global", "nope"):
        with pytest.raises(UserException):
            RobustEngine(gar, 8, granularity=granularity, device="cpu")
    with pytest.raises(UserException):
        RobustEngine(gar, 8, granularity="leaf", leaf_bucketing=1, device="cpu")
    for bucketing in ("auto", False, True):
        assert RobustEngine(gar, 8, granularity="leaf", leaf_bucketing=bucketing, device="cpu").granularity == "leaf"


# --------------------------------------------------------------------------- #
# The health probe

UDP_DEAD_ROW = (1, ["drop-rate:1.0", "packet-coords:64", "min-coords:0"])


@pytest.mark.parametrize("rule", ["average-nan", "average"])
def test_probe_matches_the_jax_engine(rule):
    """Worker 0's every packet is lost (a NaN row each step): average-nan
    stays finite, average turns the parameters NaN after step 1, so steps 2
    and 3 have a non-finite loss (spike +inf, every row NaN)."""
    pair = Pair(rule, f=0, udp=UDP_DEAD_ROW)
    losses = []
    for _ in range(3):
        jm, tm = pair.step()
        assert sorted(tm) == sorted(jm) == ["grad_norm", "probe", "total_loss"]
        _assert_probe_matches(jm["probe"], tm["probe"])
        assert tm["probe"]["update_norm"] == tm["grad_norm"] or np.isnan(tm["grad_norm"])
        losses.append(float(tm["total_loss"]))
    np.testing.assert_array_equal(tm["probe"]["worker_nan_rows"][0], 1)
    assert np.isfinite(losses).all() == (rule == "average-nan")
    np.testing.assert_allclose(float(pair.tstate.loss_ema), float(pair.jstate.loss_ema), rtol=1e-6)


def test_probe_under_unroll_matches_the_jax_engine():
    pair = Pair("average-nan", f=0, udp=UDP_DEAD_ROW, worker_metrics=True)
    jm, tm = pair.multi_step(4)
    assert tm["probe"]["worker_nan_rows"].shape == jm["probe"]["worker_nan_rows"].shape == (4, 8)
    assert tm["probe"]["spike"].shape == (4,) and tm["worker_sq_dist"].shape == (4, 8)
    _assert_probe_matches(jm["probe"], tm["probe"])
    pair.assert_params_close()


def test_probe_can_be_turned_off():
    engine = RobustEngine(tgars.instantiate("average", 8, 0), 8, health_probe=False, device="cpu")
    exp = tmodels.instantiate(*MLP)
    tx = build_optimizer("sgd", build_schedule("fixed", []))
    state = engine.init_state(exp.init(0), tx)
    assert state.loss_ema is None
    _, metrics = engine.build_step(exp.loss, tx)(state, engine.put_batch(next(exp.make_train_iterator(8))))
    assert sorted(metrics) == ["grad_norm", "total_loss"]


# --------------------------------------------------------------------------- #
# --trace-ops, cnnet in bfloat16, the runner's flags

def _trace_lines(text):
    """The TRACE lines with their trailing value dropped."""
    return [line.rsplit(" ", 1)[0] for line in text.splitlines() if line.startswith("TRACE step ")]


def test_trace_ops_prints_the_jax_runners_lines(capsys):
    argv = ["--experiment", "mnist", "--experiment-args", "batch-size:8", "--aggregator", "krum",
            "--nb-workers", "4", "--nb-decl-byz-workers", "1", "--max-step", "2", "--trace-ops",
            "--evaluation-delta", "-1", "--evaluation-period", "-1"]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-m", "aggregathor_tpu.cli.runner", "--platform", "cpu",
                           "--nb-devices", "1"] + argv, capture_output=True, text=True, timeout=300, cwd=root)
    assert proc.returncode == 0, proc.stderr[-2000:]
    want = _trace_lines(proc.stdout)
    runner.main(argv + ["--device", "cpu"])
    got = _trace_lines(capsys.readouterr().out)
    # the JAX package's callbacks are unordered within a step: compare the lines as sets
    assert len(want) == 6 and sorted(got) == sorted(want), (got, want)
    assert re.fullmatch(r"TRACE step 1 dev 0 apply done: \|p0\|", got[-1])


def test_cnnet_bfloat16_loss_follows_the_jax_package():
    losses = {}
    for dtype in ("float32", "bfloat16"):
        jexp = jmodels.instantiate("cnnet", ["batch-size:4", "dtype:%s" % dtype])
        texp = tmodels.instantiate("cnnet", ["batch-size:4", "dtype:%s" % dtype])
        params = jexp.init(jax.random.PRNGKey(0))
        batch = next(jexp.make_train_iterator(1, seed=0))
        one = {"image": batch["image"][0], "label": batch["label"][0]}
        tparams = params_from_jax(_host(params))
        assert all(value.dtype == torch.float32 for value in tparams.values())
        losses[dtype] = (float(jax.jit(jexp.loss)(params, one)),
                         float(texp.loss(tparams, {key: torch.as_tensor(value) for key, value in one.items()})))
    (jf32, tf32), (jbf16, tbf16) = losses["float32"], losses["bfloat16"]
    assert np.isfinite(tbf16)
    assert abs(tf32 - tbf16) < 0.1 * abs(tf32) + 0.1  # JAX test_models.py's bound
    assert abs(tbf16 - jbf16) <= 3e-2 * abs(jbf16)


def test_cnnet_bfloat16_engine_step_is_finite():
    pair = Pair("krum", r=2, attack="signflip", experiment=("cnnet", ["batch-size:2", "dtype:bfloat16"]))
    jm, tm = pair.step()
    assert np.isfinite(float(tm["total_loss"])) and np.isfinite(float(tm["grad_norm"]))
    assert abs(float(tm["total_loss"]) - float(jm["total_loss"])) <= 3e-2 * abs(float(jm["total_loss"]))


NEW_FLAGS = ("exchange_dtype", "worker_momentum", "granularity", "leaf_bucketing", "reputation_decay",
             "quarantine_threshold", "worker_metrics", "flight", "flight_dump", "trace_ops")


def test_new_flags_take_the_jax_defaults_and_choices():
    argv = ["--experiment", "mnist", "--aggregator", "krum", "--nb-workers", "8"]
    ours, theirs = runner.build_parser().parse_args(argv), jax_parser().parse_args(argv)
    choices = {}
    for name, parser in (("ours", runner.build_parser()), ("theirs", jax_parser())):
        choices[name] = {action.dest: action.choices for action in parser._actions if action.dest in NEW_FLAGS}
    for flag in NEW_FLAGS:
        assert getattr(ours, flag) == getattr(theirs, flag), flag
        assert choices["ours"][flag] == choices["theirs"][flag], flag
    full = argv + ["--exchange-dtype", "bfloat16", "--worker-momentum", "0.9", "--granularity", "leaf",
                   "--leaf-bucketing", "off", "--reputation-decay", "0.5", "--quarantine-threshold", "0.4",
                   "--worker-metrics", "--flight", "8", "--flight-dump", "f.json", "--trace-ops"]
    ours, theirs = runner.build_parser().parse_args(full), jax_parser().parse_args(full)
    for flag in NEW_FLAGS:
        assert getattr(ours, flag) == getattr(theirs, flag), flag


@pytest.mark.parametrize("extra,message", [
    (["--granularity", "layer"], "sharded"),
    (["--flight-dump", "f.json"], "--flight"),
    (["--flight", "-1"], "nonnegative"),
    (["--quarantine-threshold", "0.5"], "reputation_decay"),
])
def test_runner_refuses_like_jax(extra, message):
    with pytest.raises(UserException, match=message):
        runner.main(["--experiment", "mnist", "--experiment-args", "hidden:16", "--aggregator", "krum",
                     "--nb-workers", "8", "--nb-decl-byz-workers", "2", "--max-step", "1", "--device", "cpu"] + extra)
