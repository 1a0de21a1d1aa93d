"""The regression sentinel (``obs/slo.py``) and the runner's ``--slo-*``
against the JAX package.

- The documents cross-load: JAX's ``Sentinel`` reads the port's capture and
  the port's reads JAX's, with equal verdicts on the same current values
  (PASS, REGRESS in either direction, a skipped metric); ``collect_current``
  reads the same values off either registry; the refusals match.
- The runner: a capture run, then a run judged against it (PASS, the
  verdict file's schema, the ``slo_verdict`` summary event) and against a
  baseline whose ``steps_per_s`` is ×10 (REGRESS); ``--slo-verdict`` without
  ``--slo-baseline`` and a garbled baseline are refused at startup by both
  runners.
"""

import json
import os

import pytest

from aggregathor_tpu.obs import metrics as jmetrics, slo as jslo
from aggregathor_tpu.utils import UserException as JaxUserException
from aggregathor_tpu_torch.obs import metrics as tmetrics, slo
from aggregathor_tpu_torch.utils import UserException

from torch_threads import pinned_threads  # noqa: F401  (a fixture: the xdist worker's intra-op pool)

CAPTURED = {"steps_per_s": 40.0, "gar_seconds_total": 0.5, "input_overlap_fraction": 0.8}
CURRENT = {
    "same": dict(CAPTURED),
    "slower": dict(CAPTURED, steps_per_s=20.0),
    "gar-slower": dict(CAPTURED, gar_seconds_total=0.9),
    "within-tolerance": dict(CAPTURED, steps_per_s=31.0, gar_seconds_total=0.6),
    "skipped": {"steps_per_s": 45.0},
}


def _view(verdict):
    return {k: v for k, v in verdict.items() if k not in ("judged_at", "baseline_captured_at")}


@pytest.mark.parametrize("current", sorted(CURRENT))
def test_documents_cross_load_with_equal_verdicts(current, tmp_path):
    ours, theirs = str(tmp_path / "ours.json"), str(tmp_path / "theirs.json")
    slo.capture(ours, CAPTURED, run_id="r", tolerances={"gar_seconds_total": 0.5})
    jslo.capture(theirs, CAPTURED, run_id="r", tolerances={"gar_seconds_total": 0.5})
    for path in (ours, theirs):
        verdicts = [_view(sentinel.verdict(CURRENT[current], run_id="now"))
                    for sentinel in (slo.Sentinel(path), jslo.Sentinel(path))]
        assert verdicts[0] == verdicts[1]
        assert slo.describe_verdict(verdicts[0]) == jslo.describe_verdict(verdicts[1])
    assert verdicts[0]["verdict"] == ("REGRESS" if current in ("slower", "gar-slower") else "PASS")
    assert verdicts[0]["schema"] == "aggregathor.obs.slo.v1.verdict"
    doc = {k: v for k, v in json.load(open(ours)).items() if k != "captured_at"}
    assert doc == {k: v for k, v in json.load(open(theirs)).items() if k != "captured_at"}


def test_collect_current_reads_the_same_values():
    class Perf:
        nb_steps = 5

        def steps_per_s_excl_first(self):
            return 12.5

    values = []
    for module in (tmetrics, jmetrics):
        registry = module.MetricsRegistry()
        registry.counter("gar_seconds_total", "").inc(0.25)
        registry.gauge("input_overlap_fraction", "").set(0.75)
        values.append(registry)
    assert slo.collect_current(values[0], Perf()) == jslo.collect_current(values[1], Perf()) == {
        "steps_per_s": 12.5, "gar_seconds_total": 0.25, "input_overlap_fraction": 0.75}
    assert slo.collect_current(tmetrics.MetricsRegistry(), None) == {}


@pytest.mark.parametrize("document", ["missing", "not-json", "list", "schema", "no-metrics"])
def test_sentinel_refusals_match_jax(document, tmp_path):
    path = str(tmp_path / "baseline.json")
    body = {"not-json": "{", "list": "[1]", "schema": json.dumps({"schema": "other", "metrics": {"a": 1}}),
            "no-metrics": json.dumps({"schema": slo.SCHEMA, "metrics": {}})}.get(document)
    if body is not None:
        open(path, "w").write(body)
    with pytest.raises(UserException) as mine:
        slo.Sentinel(path)
    with pytest.raises(JaxUserException) as ref:
        jslo.Sentinel(path)
    assert str(mine.value) == str(ref.value)


RUN = ["--experiment", "mnist", "--experiment-args", "hidden:8", "batch-size:8", "--aggregator", "average",
       "--nb-workers", "4", "--max-step", "6", "--evaluation-delta", "-1", "--evaluation-period", "-1",
       "--prefetch", "0", "--device", "cpu"]


def _events(directory):
    return [json.loads(line) for name in sorted(os.listdir(directory)) for line in open(os.path.join(directory, name))]


def test_runner_captures_then_passes_then_regresses(tmp_path, monkeypatch):
    from aggregathor_tpu_torch.cli import runner

    monkeypatch.setattr(tmetrics, "REGISTRY", tmetrics.MetricsRegistry())
    baseline = str(tmp_path / "slo.json")
    runner.main(RUN + ["--slo-capture", baseline])
    doc = json.load(open(baseline))
    assert doc["schema"] == "aggregathor.obs.slo.v1" and doc["metrics"]["steps_per_s"] > 0
    # judged against its own capture at a tolerance nothing on this box misses
    doc["tolerances"]["steps_per_s"] = 0.999
    json.dump(doc, open(baseline, "w"))
    verdict = str(tmp_path / "v.json")
    runner.main(RUN + ["--slo-baseline", baseline, "--slo-verdict", verdict, "--summary-dir", str(tmp_path / "a")])
    judged = json.load(open(verdict))
    assert judged["schema"] == "aggregathor.obs.slo.v1.verdict" and judged["verdict"] == "PASS"
    (event,) = [e for e in _events(tmp_path / "a") if e.get("event") == "slo_verdict"]
    assert event["step"] == 6 and event["verdict"] == "PASS" and event["checks"] == judged["checks"]
    # a baseline ten times faster than this run: REGRESS
    doc["metrics"]["steps_per_s"] *= 10.0
    doc["tolerances"]["steps_per_s"] = 0.25
    json.dump(doc, open(baseline, "w"))
    runner.main(RUN + ["--slo-baseline", baseline, "--slo-verdict", verdict])
    judged = json.load(open(verdict))
    assert judged["verdict"] == "REGRESS" and judged["regressed"] == 1


@pytest.mark.parametrize("flags", [["--slo-verdict", "v.json"], ["--slo-baseline", "missing.json"]])
def test_runner_refusals_match_jax(flags, tmp_path, monkeypatch):
    from aggregathor_tpu.cli import runner as jrunner
    from aggregathor_tpu_torch.cli import runner

    monkeypatch.chdir(tmp_path)
    argv = RUN[:-2] + flags
    with pytest.raises(UserException) as mine:
        runner.main(argv + ["--device", "cpu"])
    with pytest.raises(JaxUserException) as ref:
        jrunner.main(argv + ["--nb-devices", "1"])
    assert str(mine.value) == str(ref.value)
