"""The aggregation tree's host protocol (``topology/``) against the JAX package.

- The spec's host-protocol helpers (``leaf_span``, ``shadows``,
  ``unit_index``, ``total_units``, ``validate_fault_target``) on the same
  specs.
- ``TreeAggregator.resolve_round``: every synthetic-clock case of JAX's
  ``tests/test_topology.py`` (a live shadow, exclusion, a faulted shadow, no
  cascade, pipelined early arrivals) gives JAX's verdicts.
- ``process_round`` on injected float32 rows under ``corrupt-agg`` and
  ``straggle-agg`` schedules, median levels and no level deadline (only the
  injected faults decide, not the wall clock): the masks, the journal, the
  forensics' sub-aggregator surface and ``chain()`` after five rounds equal
  JAX's bit for bit (the digests are held on injected rows, trap w).
- The emissions are the port's in-step ``tree`` levels bit for bit, and
  ``cache_size`` does not grow after the first round.
- The runner: 4 steps of ``--topology`` under a fault schedule on mnist from
  JAX's weights, losses and journal against the JAX runner (``--nb-devices
  1``).
"""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aggregathor_tpu.chaos import ChaosSchedule as JaxChaosSchedule
from aggregathor_tpu.obs import events as jevents
from aggregathor_tpu.obs.forensics import ForensicsLedger as JaxForensicsLedger
from aggregathor_tpu.obs.metrics import MetricsRegistry as JaxRegistry
from aggregathor_tpu.topology import TreeAggregator as JaxTreeAggregator, parse_topology_spec as jparse
from aggregathor_tpu.utils import UserException as JaxUserException
from aggregathor_tpu_torch import gars as tgars
from aggregathor_tpu_torch.chaos import ChaosSchedule
from aggregathor_tpu_torch.gars.common import sub_rule_distances
from aggregathor_tpu_torch.gars.tree import level_pass
from aggregathor_tpu_torch.obs import events as tevents
from aggregathor_tpu_torch.obs.forensics import ForensicsLedger
from aggregathor_tpu_torch.obs.metrics import MetricsRegistry
from aggregathor_tpu_torch.secure.submit import row_digest
from aggregathor_tpu_torch.topology import TreeAggregator, parse_topology_spec
from aggregathor_tpu_torch.utils import UserException

from torch_threads import pinned_threads  # noqa: F401  (a fixture: the xdist worker's intra-op pool)


@pytest.fixture(autouse=True)
def _no_journal_leak():
    yield
    jevents.uninstall()
    tevents.uninstall()


# --------------------------------------------------------------------- #
# the spec's host-protocol helpers


@pytest.mark.parametrize("text,n,f", [
    ("tree:g=4x2,rules=median>average-nan>average-nan,redundancy=2", 32, 1),
    ("tree:g=2,rules=average-nan>average-nan,redundancy=3", 8, 1),
    ("tree:g=4x2,rules=median>median>krum,redundancy=2", 32, 1),
    ("tree:g=2x2x2,rules=median>median>median>average-nan", 16, 0),
])
def test_spec_helpers_match_jax(text, n, f):
    ours, theirs = parse_topology_spec(text, n, f), jparse(text, n, f)
    assert ours.total_units == theirs.total_units
    for level in range(1, ours.nb_levels + 1):
        for unit in range(ours.nb_units[level - 1]):
            assert list(ours.leaf_span(level, unit)) == list(theirs.leaf_span(level, unit))
            assert ours.shadows(level, unit) == theirs.shadows(level, unit)
            assert ours.unit_index(level, unit) == theirs.unit_index(level, unit)
            ours.validate_fault_target(level, unit)
    for level, unit in ((0, 0), (ours.nb_levels + 1, 0), (1, ours.nb_units[0]), (1, -1)):
        with pytest.raises(UserException) as mine:
            ours.validate_fault_target(level, unit)
        with pytest.raises(JaxUserException) as ref:
            theirs.validate_fault_target(level, unit)
        assert str(mine.value) == str(ref.value)


# --------------------------------------------------------------------- #
# the pure decision core, on JAX's synthetic-clock cases

RESOLVE_CASES = {
    "live-shadow": ("tree:g=2,rules=average-nan>average-nan,redundancy=2", 8,
                    dict(child_arrivals=np.full(8, 0.1), compute_seconds=[0.01], straggle_units=[(1, 2)],
                         windows=[0.5])),
    "exclusion": ("tree:g=2,rules=average-nan>average-nan", 8,
                  dict(child_arrivals=np.full(8, 0.1), compute_seconds=[0.01], straggle_units=[(1, 2)],
                       windows=[0.5])),
    "faulted-shadow": ("tree:g=2,rules=average-nan>average-nan,redundancy=2", 8,
                       dict(child_arrivals=np.full(8, 0.1), compute_seconds=[0.01],
                            straggle_units=[(1, 2), (1, 3)], windows=[0.5])),
    "no-cascade": ("tree:g=2x2,rules=average-nan>average-nan>average-nan", 8,
                   dict(child_arrivals=np.full(8, 0.1), compute_seconds=[0.01, 0.01], straggle_units=[(1, 2)],
                        windows=[0.5, 0.5])),
    "pipelined": ("tree:g=2,rules=average-nan>average-nan,redundancy=2", 8,
                  dict(child_arrivals=np.linspace(0.0, 0.4, 8), compute_seconds=[0.01], windows=[0.5])),
    "corrupt-and-late": ("tree:g=2x2,rules=average-nan>average-nan>average-nan,redundancy=2", 16,
                         dict(child_arrivals=np.linspace(0.0, 0.3, 16), compute_seconds=[0.05, 0.2],
                              corrupt_units=[(1, 1), (2, 0)], straggle_units=[(1, 2)], windows=[0.1, 0.1])),
    "no-windows": ("tree:g=4x2,rules=average-nan>average-nan>average-nan", 32,
                   dict(child_arrivals=np.full(32, 0.2), compute_seconds=[0.01, 0.02], straggle_units=[(2, 1)],
                        windows=[None, None])),
}


def _verdict_view(verdicts):
    return [{key: (value.tolist() if isinstance(value, np.ndarray) else value) for key, value in v.items()}
            for v in verdicts]


@pytest.mark.parametrize("case", sorted(RESOLVE_CASES))
def test_resolve_round_gives_the_jax_verdicts(case):
    text, n, kwargs = RESOLVE_CASES[case]
    ours = TreeAggregator(parse_topology_spec(text, n, 1)).resolve_round(0, **kwargs)
    theirs = JaxTreeAggregator(jparse(text, n, 1)).resolve_round(0, **kwargs)
    assert _verdict_view(ours) == _verdict_view(theirs)


# --------------------------------------------------------------------- #
# the per-round protocol on injected rows

PROTOCOL_CASES = {
    # a forged unit reconstructed by its shadow; a forged unit excluded
    "corrupt-reconstructed": ("tree:g=2,rules=median>median,redundancy=2", 8, "0:corrupt-agg=1.0"),
    "corrupt-excluded": ("tree:g=2,rules=median>median", 8, "0:corrupt-agg=1.1"),
    # a straggling unit reconstructed; two levels with both faults
    "straggle-reconstructed": ("tree:g=2,rules=median>median,redundancy=2", 8, "0:straggle-agg=1.3"),
    "two-levels": ("tree:g=2x2,rules=median>median>median", 16,
                   "0:calm 1:corrupt-agg=2.0 3:straggle-agg=1.1+1.6,corrupt-agg=1.2"),
}
#: the workers each case's five rounds leave out of the aggregate (worker 5
#: misses the odd rounds at the leaves)
CLEARED = {
    "corrupt-reconstructed": [[], [5], [], [5], []],
    "corrupt-excluded": [[2, 3], [2, 3, 5], [2, 3], [2, 3, 5], [2, 3]],
    "straggle-reconstructed": [[], [5], [], [5], []],
    "two-levels": [[], [0, 1, 2, 3, 5], [0, 1, 2, 3], [2, 3, 4, 5, 12, 13], [2, 3, 4, 5, 12, 13]],
}
ROUNDS = 5
D = 24


def _journal_view(path, module):
    view = []
    for record in module.load_journal(path):
        fields = {k: v for k, v in record.items() if k not in ("t_wall", "t_mono", "pid", "path", "schema")}
        view.append(fields)
    return view


def _drive(package, text, n, schedule, tmp_path):
    """``ROUNDS`` rounds of one package's tree on the same injected rows:
    worker 5 misses every other round, the masks returned each round."""
    if package == "jax":
        aggregator = JaxTreeAggregator(jparse(text, n, 1), registry=JaxRegistry())
        aggregator.schedule = JaxChaosSchedule(schedule, n, allow_topology_faults=True)
        aggregator.ledger = ledger = JaxForensicsLedger(n)
        events, make_rows = jevents, jnp.asarray
    else:
        aggregator = TreeAggregator(parse_topology_spec(text, n, 1), registry=MetricsRegistry())
        aggregator.schedule = ChaosSchedule(schedule, n, allow_topology_faults=True)
        aggregator.ledger = ledger = ForensicsLedger(n)
        events, make_rows = tevents, torch.from_numpy
    aggregator.bind(n, D)
    path = str(tmp_path / ("%s.jsonl" % package))
    events.install(path, run_id="topology")
    rng = np.random.default_rng(7)
    masks = []
    for step in range(ROUNDS):
        rows = rng.normal(size=(n, D)).astype(np.float32)
        arrived = np.ones(n, bool)
        arrived[5] = step % 2 == 0
        arrival = np.where(arrived, 0.01 * np.arange(n), np.inf)
        masks.append(aggregator.process_round(step, arrived, np.zeros(n, bool), arrival, make_rows(rows),
                                              leaf_window=0.5))
    events.uninstall()
    return aggregator, ledger, masks, _journal_view(path, events)


@pytest.mark.parametrize("case", sorted(PROTOCOL_CASES))
def test_process_round_matches_jax_bit_for_bit(case, tmp_path):
    text, n, schedule = PROTOCOL_CASES[case]
    ours, our_ledger, our_masks, our_journal = _drive("port", text, n, schedule, tmp_path)
    theirs, their_ledger, their_masks, their_journal = _drive("jax", text, n, schedule, tmp_path)
    for (a, s), (ja, js) in zip(our_masks, their_masks):
        np.testing.assert_array_equal(a, ja)
        np.testing.assert_array_equal(s, js)
    assert [np.nonzero(~a)[0].tolist() for a, _ in our_masks] == CLEARED[case]
    assert our_journal == their_journal
    assert any(r["type"].startswith("topology_") for r in our_journal)
    report, want = our_ledger.report(), their_ledger.report()
    assert report["corrupt_subaggregators"] == want["corrupt_subaggregators"]
    assert report["sub_aggregators"] == want["sub_aggregators"]
    assert ours.chain() == theirs.chain()
    assert ours.chain()["steps"] == ROUNDS and ours.rounds_total == ROUNDS


def test_emissions_are_the_in_step_tree_levels_bit_for_bit():
    """Each level's emission is ``gars.tree.level_pass`` on the masked leaf
    rows with the step's key, and the in-step rule's root reads the last
    level's summaries: the chain signs what the aggregate consumes."""
    text = "tree:g=4x2,rules=krum>median>krum,link=bf16"
    n, key = 32, 11
    aggregator = TreeAggregator(parse_topology_spec(text, n, 1))
    aggregator.bind(n, D)
    rows = torch.from_numpy(np.random.default_rng(3).normal(size=(n, D)).astype(np.float32))
    valid = np.ones(n, bool)
    valid[[2, 9]] = False
    emitted = aggregator.emissions(rows, valid, key)
    masked = torch.where(torch.from_numpy(valid)[:, None], rows, torch.nan)
    rule = tgars.instantiate(text, n, 1)
    summaries, _ = rule._levels(masked, key, False)
    assert torch.equal(emitted[-1][0], summaries)
    rows_in = masked
    for level, (got, digests, seconds) in enumerate(emitted):
        rows_in, _ = level_pass(rule.spec, level, rows_in, key)
        assert torch.equal(got, rows_in) and seconds >= 0.0
        np.testing.assert_array_equal(digests, row_digest(rows_in).numpy())
    root = rule.spec.root_rule
    assert torch.equal(rule.aggregate(masked, key=key),
                       root._call_aggregate(summaries, sub_rule_distances(root, summaries), key=rule._root_key(key)))


def test_cache_size_stays_after_the_first_round():
    aggregator = TreeAggregator(parse_topology_spec("tree:g=2x2,rules=median>median>average-nan", 8, 1))
    assert aggregator.cache_size() == 0
    aggregator.bind(8, D)
    rng = np.random.default_rng(1)
    for step in range(4):
        aggregator.process_round(step, np.ones(8, bool), np.zeros(8, bool), np.full(8, 0.1),
                                 torch.from_numpy(rng.normal(size=(8, D)).astype(np.float32)))
        assert aggregator.cache_size() == 1
    assert aggregator.rounds_total == 4


def test_refusals_match_jax():
    text = "tree:g=2,rules=average-nan>average-nan,redundancy=2"
    ours, theirs = TreeAggregator(parse_topology_spec(text, 8, 1)), JaxTreeAggregator(jparse(text, 8, 1))
    with pytest.raises(UserException, match="bind"):
        ours.process_round(0, np.ones(8, bool), np.zeros(8, bool), np.full(8, 0.1), torch.zeros((8, 4)))
    with pytest.raises(UserException) as mine:
        ours.bind(4, 16)
    with pytest.raises(JaxUserException) as ref:
        theirs.bind(4, 16)
    assert str(mine.value) == str(ref.value) and "n=4" in str(mine.value)


# --------------------------------------------------------------------- #
# the runner's --topology against the JAX runner

RUN = ["--experiment", "mnist", "--experiment-args", "hidden:16", "batch-size:8", "--nb-workers", "8",
       "--nb-decl-byz-workers", "1", "--aggregator", "tree", "--topology", "tree:g=2,rules=median>average-nan",
       "--chaos", "0:corrupt-agg=1.1 2:calm 3:straggle-agg=1.2", "--learning-rate-args", "initial-rate:0.05",
       "--evaluation-delta", "-1", "--evaluation-period", "-1", "--summary-delta", "1", "--summary-period", "-1",
       "--max-step", "4", "--prefetch", "0", "--run-id", "topology"]


def _losses(directory):
    events = [json.loads(line) for name in sorted(os.listdir(directory))
              for line in open(os.path.join(directory, name))]
    return {e["step"]: e["total_loss"] for e in events if "total_loss" in e}


def test_runner_topology_matches_the_jax_runner(tmp_path, monkeypatch):
    """Both runners from JAX's weights: the same exclusions (the journal,
    the forensics' corrupt sub-aggregators) and the same losses."""
    import jax

    from aggregathor_tpu import models as jmodels
    from aggregathor_tpu.cli import runner as jrunner
    from aggregathor_tpu.obs import metrics as jmetrics
    from aggregathor_tpu_torch.cli import runner
    from aggregathor_tpu_torch.models import mnist
    from aggregathor_tpu_torch.models.common import params_from_jax
    from aggregathor_tpu_torch.obs import metrics as tmetrics

    jexp = jmodels.instantiate("mnist", ["hidden:16", "batch-size:8"])
    monkeypatch.setattr(mnist.MNISTExperiment, "init", lambda self, seed: params_from_jax(
        jax.tree_util.tree_map(np.asarray, jexp.init(jax.random.PRNGKey(seed)))))
    monkeypatch.setattr(jmetrics, "REGISTRY", jmetrics.MetricsRegistry())
    monkeypatch.setattr(tmetrics, "REGISTRY", tmetrics.MetricsRegistry())
    out = {}
    for label, main, extra in (("jax", jrunner.main, ["--nb-devices", "1"]),
                               ("port", runner.main, ["--device", "cpu"])):
        where = tmp_path / label
        out[label] = main(RUN + extra + ["--summary-dir", str(where / "sum"), "--journal", str(where / "j.jsonl"),
                                         "--forensics", str(where / "f.json")])
    journals = {label: [{k: v for k, v in r.items() if k not in ("t_wall", "t_mono", "pid", "path", "schema",
                                                                 "forensics")}
                        for r in module.load_journal(str(tmp_path / label / "j.jsonl"))]
                for label, module in (("jax", jevents), ("port", tevents))}
    topology = [r for r in journals["port"] if r["type"].startswith("topology_")]
    assert [(r["type"], r["step"], r["level"], r["unit"], r["excluded"]) for r in topology] == [
        ("topology_corruption_verdict", 0, 1, 1, True), ("topology_corruption_verdict", 1, 1, 1, True),
        ("topology_level_timeout", 3, 1, 2, True)]
    assert topology == [r for r in journals["jax"] if r["type"].startswith("topology_")]
    reports = {label: json.load(open(tmp_path / label / "f.json")) for label in ("jax", "port")}
    assert reports["port"]["corrupt_subaggregators"] == reports["jax"]["corrupt_subaggregators"] == ["1.1"]
    assert reports["port"]["sub_aggregators"] == reports["jax"]["sub_aggregators"]
    want, got = _losses(tmp_path / "jax" / "sum"), _losses(tmp_path / "port" / "sum")
    assert sorted(got) == sorted(want) == [1, 2, 3, 4] and out["port"]["steps"] == 4
    np.testing.assert_allclose([got[k] for k in (1, 2, 3, 4)], [want[k] for k in (1, 2, 3, 4)], rtol=1e-4)


def test_bounded_step_aggregates_the_tree_s_masks():
    """A ``BoundedWaitStep`` driving the tree: the aggregate reads the masks
    the protocol returns (unit 1.1 forged with no shadow: workers 2 and 3
    out, as ``straggler_timeout``), the step's compile surface folds in the
    tree's ``cache_size``, and the tree refuses to ride the incremental
    fold."""
    from aggregathor_tpu_torch import models as tmodels
    from aggregathor_tpu_torch.core import build_optimizer, build_schedule
    from aggregathor_tpu_torch.parallel import RobustEngine
    from aggregathor_tpu_torch.parallel.bounded import BoundedWaitStep

    n, spec = 8, "tree:g=2,rules=median>average-nan"
    exp = tmodels.instantiate("mnist", ["hidden:8", "batch-size:4"])
    tx = build_optimizer("sgd", build_schedule("fixed", ["initial-rate:0.05"]))
    engine = RobustEngine(tgars.instantiate(spec, n, 1), n, device="cpu")
    params = exp.init(0)
    tree = TreeAggregator(parse_topology_spec(spec, n, 1))
    tree.schedule = ChaosSchedule("0:corrupt-agg=1.1", n, allow_topology_faults=True)
    step = BoundedWaitStep(engine, exp.loss, tx, params, topology=tree)
    try:
        state = engine.init_state(params, tx, seed=1)
        it = exp.make_train_iterator(n, seed=2)
        for _ in range(3):
            state, metrics = step(state, engine.put_batch(next(it)))
            assert metrics["straggler_timeout"].tolist() == [False, False, True, True, False, False, False, False]
            assert np.isfinite(float(metrics["total_loss"]))
        assert step._cache_size() == 1 and tree.rounds_total == 3
    finally:
        step.close()
    with pytest.raises(UserException, match="incremental"):
        BoundedWaitStep(engine, exp.loss, tx, params, deadline=0.5, incremental=True,
                        topology=TreeAggregator(parse_topology_spec(spec, n, 1)))
