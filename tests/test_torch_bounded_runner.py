"""The port's runner under bounded-wait against the JAX runner (``--nb-devices 1``).

On ``digits`` (n = 8, f = 2), each runner with a fresh registry:

- C, persistent stragglers: krum, ``--chaos "0:calm 1:straggle=1.0"
  --chaos-args straggle-workers:2 --straggler-stall 30 --step-deadline
  0.5``;
- D, stale infill: median, the same stragglers, ``--stale-infill
  --stale-max-age 2 --stale-reweight``;
- G, the guardian: median, three stragglers (``straggle-workers:3``, beyond
  f = 2), ``--guardian``.

Step 0 is calm and the stall outlasts the run, so round 0 (which builds)
waits for nobody and no straggler ever lands: every mask, every skipped
unit and every journal field but the clocks is the same in both runs.
Held equal: the evaluation TSV's columns and the summaries' keys, the
journal event for event (times, run ids, paths and pids aside), the
forensics ``stragglers``, the bounded-wait families of the metrics file
and their values; G's guardian timeline (a rollback for
``straggler_timeouts``, the ``f+1`` escalation).  Each invalid flag
combination is refused by both runners; ``--nb-devices 2`` by the port
(its W ranks are processes).
"""

import json
import math
import os

import pytest

from aggregathor_tpu.cli import runner as jrunner
from aggregathor_tpu.obs import events as jevents, metrics as jmetrics
from aggregathor_tpu.utils import UserException as JaxUserException
from aggregathor_tpu_torch.cli import runner
from aggregathor_tpu_torch.obs import events as tevents, metrics as tmetrics
from aggregathor_tpu_torch.utils import UserException

from torch_threads import pinned_threads  # noqa: F401  (a fixture: the xdist worker's intra-op pool)

BASE = ["--experiment", "digits", "--nb-workers", "8", "--nb-decl-byz-workers", "2", "--prefetch", "0",
        "--checkpoint-period", "-1", "--evaluation-period", "-1", "--summary-delta", "2", "--seed", "1"]
STRAGGLERS = ["--chaos", "0:calm 1:straggle=1.0", "--straggler-stall", "30", "--step-deadline", "0.5"]
LEGS = {
    "C": BASE + STRAGGLERS + ["--chaos-args", "straggle-workers:2", "--aggregator", "krum", "--max-step", "6",
                              "--evaluation-delta", "3"],
    "D": BASE + STRAGGLERS + ["--chaos-args", "straggle-workers:2", "--aggregator", "median", "--max-step", "6",
                              "--evaluation-delta", "3", "--stale-infill", "--stale-max-age", "2",
                              "--stale-reweight"],
    "G": BASE + ["--chaos", "0:calm 1:straggle=1.0", "--chaos-args", "straggle-workers:3", "--straggler-stall", "1.5",
                 "--step-deadline", "0.5", "--aggregator", "median", "--max-step", "8", "--evaluation-delta", "-1",
                 "--guardian", "--guardian-args", "patience:2", "recover:2", "--checkpoint-delta", "1"],
}
BOUNDED_FAMILIES = ("straggler_timeouts_total", "straggler_skipped_rounds_total", "stale_infill_rows_total",
                    "bounded_wait_rounds_total", "bounded_wait_deadline_seconds")


@pytest.fixture(autouse=True)
def _no_journal_leak():
    yield
    jevents.uninstall()
    tevents.uninstall()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("bounded")
    results = {}
    with pytest.MonkeyPatch.context() as mp:
        for leg, argv in LEGS.items():
            for label, main, extra in (("jax", jrunner.main, ["--nb-devices", "1"]),
                                       ("port", runner.main, ["--device", "cpu"])):
                mp.setattr(jmetrics, "REGISTRY", jmetrics.MetricsRegistry())
                mp.setattr(tmetrics, "REGISTRY", tmetrics.MetricsRegistry())
                where = out / leg / label
                where.mkdir(parents=True)
                results[leg, label] = main(argv + extra + [
                    "--checkpoint-dir", str(where / "ckpt"), "--summary-dir", str(where / "sum"),
                    "--journal", str(where / "j.jsonl"), "--metrics-file", str(where / "m.prom"),
                    "--forensics", str(where / "f.json"), "--evaluation-file", str(where / "e.tsv")])
    return out, results


def _journal(path, module, skip=()):
    view = []
    for record in module.load_journal(path):
        fields = {k: v for k, v in record.items()
                  if k not in {"t_wall", "t_mono", "run_id", "path", "pid", "schema", "forensics"} | set(skip)}
        if fields.get("cause"):
            fields["cause"] = fields["cause"]["seq"]
        view.append(fields)
    return view


def _summaries(directory):
    return [json.loads(line) for name in sorted(os.listdir(directory)) for line in open(os.path.join(directory, name))]


def _tsv_columns(path):
    """Each evaluation row's step and column names (the values are each
    package's: the weights differ)."""
    rows = [line.rstrip("\n").split("\t") for line in open(path)]
    return [(row[1], [field.split(":")[0] for field in row[2:]]) for row in rows]


def _families(path, module):
    families = module.parse_prometheus(open(path).read())
    return {name: sorted(families[name]["samples"], key=repr) for name in BOUNDED_FAMILIES if name in families}


@pytest.mark.parametrize("leg", ["C", "D"])
def test_timeline_forensics_and_registry_match_the_jax_runner(runs, leg):
    out, results = runs
    port, jax_dir = out / leg / "port", out / leg / "jax"
    ours, theirs = _journal(str(port / "j.jsonl"), tevents), _journal(str(jax_dir / "j.jsonl"), jevents)
    assert ours == theirs
    rounds = [r for r in ours if r["type"] == "bounded_round"]
    assert [r["step"] for r in rounds] == [1, 2, 3, 4, 5]
    assert all(r["timed_out"] == [0, 1] and r["nb_arrived"] == 6 and r["deadline_s"] == 0.5 for r in rounds)
    assert [r["skipped_units"] for r in rounds] == [[]] + [[0, 1]] * 4
    if leg == "D":
        # a carry of age 1 and 2 re-enters, damped by 1/2 and 1/3; then the NaN drop
        assert [r["stale_infill"] for r in rounds] == [[0, 1], [0, 1], [], [], []]
        reweights = [(r["step"], r["worker"], r["age"], r["coefficient"]) for r in ours if r["type"] == "stale_reweight"]
        assert reweights == [(1, 0, 1, 0.5), (1, 1, 1, 0.5), (2, 0, 2, 1 / 3), (2, 1, 2, 1 / 3)]
    for label, directory in (("port", port), ("jax", jax_dir)):
        assert json.load(open(directory / "f.json"))["stragglers"] == [0, 1], label
    assert _families(port / "m.prom", tmetrics) == _families(jax_dir / "m.prom", jmetrics)
    families = _families(port / "m.prom", tmetrics)
    assert set(families) == set(BOUNDED_FAMILIES)
    assert _tsv_columns(port / "e.tsv") == _tsv_columns(jax_dir / "e.tsv") == [
        (step, ["accuracy", "chaos_regime", "cross-entropy"]) for step in ("1", "4", "6")]
    keys = [sorted(e) for e in _summaries(port / "sum") if "total_loss" in e]
    assert keys == [sorted(e) for e in _summaries(jax_dir / "sum") if "total_loss" in e]
    summary = [e for e in _summaries(port / "sum") if "total_loss" in e][-1]
    assert summary["straggler_timeouts"] == 2 and summary["stale_infill_rows"] == 0
    assert math.isfinite(results[leg, "port"]["final_loss"])
    assert all(math.isfinite(e["total_loss"]) for e in _summaries(jax_dir / "sum") if "total_loss" in e)


def test_guardian_escalates_for_straggler_timeouts_like_the_jax_runner(runs):
    out, results = runs
    guardian = ("guardian_rollback_decision", "guardian_rollback", "guardian_escalation", "guardian_recovered")
    views = {}
    for label, module in (("port", tevents), ("jax", jevents)):
        views[label] = [r for r in _journal(str(out / "G" / label / "j.jsonl"), module) if r["type"] in guardian]
    assert views["port"] == views["jax"]
    decision = views["port"][0]
    assert decision["type"] == "guardian_rollback_decision" and decision["reason"] == "straggler_timeouts"
    assert decision["nb_timeouts"] == 3 and decision["budget"] == 2
    assert results["G", "port"]["escalations"] == ["f+1"]
    assert results["G", "port"]["rollbacks"][0]["reason"].startswith("straggler timeouts (3)")


@pytest.mark.parametrize("flags", [
    ["--step-deadline", "0"],
    ["--step-deadline", "0.2", "--unroll", "2"],
    ["--step-deadline", "0.2", "--input-source", "device"],
    ["--step-deadline", "0.2", "--UDP", "2"],
    ["--straggler-stall", "0.1", "--incremental-aggregation"],
    ["--incremental-aggregation"],
    ["--straggler-stall", "0.1", "--deadline-percentile", "70"],
    ["--deadline-percentile", "70"],
    ["--step-deadline", "0.2", "--deadline-percentile", "120"],
    ["--straggler-stall", "0.1", "--stale-infill"],
    ["--step-deadline", "0.2", "--stale-reweight"],
    ["--step-deadline", "0.2", "--stale-infill", "--stale-max-age", "0"],
    ["--step-deadline", "0.2", "--straggler-jitter", "0.5"],
    ["--step-deadline", "0.2", "--chaos", "0:straggle=0.5"],
    ["--step-deadline", "0.2", "--straggler-stall", "0.1", "--chaos", "0:attack=empire",
     "--nb-real-byz-workers", "1"],
    ["--step-deadline", "0.2", "--straggler-stall", "0.1", "--chaos", "0:drop=0.3"],
    ["--step-deadline", "0.2", "--straggler-rate", "1.5", "--straggler-stall", "0.1"],
], ids=lambda flags: " ".join(flags))
def test_invalid_combinations_refuse_in_both_runners(flags, tmp_path):
    argv = BASE + ["--aggregator", "krum", "--max-step", "2", "--evaluation-delta", "-1"] + flags
    with pytest.raises(UserException):
        runner.main(argv + ["--device", "cpu"])
    with pytest.raises(JaxUserException):
        jrunner.main(argv + ["--nb-devices", "1"])


def test_the_port_refuses_bounded_wait_over_ranks():
    argv = BASE + ["--aggregator", "krum", "--max-step", "2", "--evaluation-delta", "-1", "--device", "cpu"]
    for flags in (["--step-deadline", "0.2"], ["--straggler-stall", "0.1"]):
        with pytest.raises(UserException, match="single-process"):
            runner.main(argv + flags + ["--nb-devices", "2"])
