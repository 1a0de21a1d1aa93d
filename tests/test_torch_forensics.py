"""The port's ``obs/forensics`` and ``obs/profiler`` against the JAX package's.

- ``--forensics``: the port's runner and the JAX runner (``--nb-devices
  1``) from the same MLP weights write the same report on mnist + krum
  under a coalition of two gaussian workers (n = 8, f = 2): the same
  suspects, evidence kinds and counts, suspect steps and intervals, numeric
  fields within rtol 1e-5, the wall-clock and path fields left out.  The
  gaussian draw is injected (trap c: threefry draws cannot be reproduced):
  both packages' attack returns ``deviation`` times one fixed N(0, 1)
  vector.  The same under ``--unroll 4`` (one ledger row a scanned step),
  and after the guardian's rollbacks under the inf attack, whose verdicts
  do not depend on the retry's draws: the guardian notes (rollback,
  escalation, recovered) and the journal's counts by type match too.
- ``obs/forensics`` is a copy: the module's functions give the JAX
  module's results on the same evidence (``binom_sf``, the markdown).
- ``ProfilerWindow`` parses and refuses ``A:B`` as JAX's does
  (``tests/test_flight.py:246-290``), opens, annotates and closes one
  ``torch.profiler`` window; the runner's ``--xprof 2:4`` writes one trace
  whose events hold the ``train step`` annotations of steps 2 and 3 (under
  ``--unroll 2`` the one chunk's, annotated with its first step), and
  ``--xprof`` with ``--trace`` is refused.
- ``CompileWatch`` counts a build-cache miss of ``ops/build.py`` by source
  and emits its ``compile_cache_miss`` event; the backend gauges count the
  finished build; the memory gauges hold no sample on the CPU.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aggregathor_tpu import models as jmodels
from aggregathor_tpu.cli import runner as jrunner
from aggregathor_tpu.obs import forensics as jforensics
from aggregathor_tpu.obs import metrics as jmetrics
from aggregathor_tpu.parallel import attacks as jattacks
from aggregathor_tpu_torch.cli import runner
from aggregathor_tpu_torch.models import mnist
from aggregathor_tpu_torch.models.common import params_from_jax
from aggregathor_tpu_torch.obs import forensics, metrics, profiler
from aggregathor_tpu_torch.ops import build
from aggregathor_tpu_torch.parallel import attacks
from aggregathor_tpu_torch.utils import UserException

from torch_threads import pinned_threads  # noqa: F401  (a fixture: the xdist worker's intra-op pool)

EXP = ["--experiment", "mnist", "--experiment-args", "hidden:16", "batch-size:8", "--nb-workers", "8",
       "--learning-rate-args", "initial-rate:0.05", "--evaluation-delta", "-1", "--evaluation-period", "-1",
       "--summary-period", "-1", "--checkpoint-period", "-1", "--prefetch", "0"]
GAUSSIAN = EXP + ["--aggregator", "krum", "--nb-decl-byz-workers", "2", "--nb-real-byz-workers", "2",
                  "--attack", "gaussian", "--attack-args", "deviation:100", "--max-step", "12"]
ROLLBACK = EXP + ["--aggregator", "average", "--nb-decl-byz-workers", "2", "--nb-real-byz-workers", "2",
                  "--attack", "inf", "--guardian", "--guardian-args", "recover:5", "--checkpoint-delta", "4",
                  "--max-step", "30", "--summary-delta", "5", "--flight", "8"]

#: fields that hold a wall clock, an id or a path of the run
UNCOMPARED = {"generated_at", "run_id", "path", "wall", "monotonic"}


def _noise(d, deviation=100.0):
    return (deviation * np.random.default_rng(7).standard_normal(d)).astype(np.float32)


@pytest.fixture
def same_start(monkeypatch):
    """Both runners from the JAX package's weights, the gaussian attack's
    draw one fixed vector in both packages, fresh registries."""
    jexp = jmodels.instantiate("mnist", ["hidden:16", "batch-size:8"])
    monkeypatch.setattr(mnist.MNISTExperiment, "init", lambda self, seed: params_from_jax(
        jax.tree_util.tree_map(np.asarray, jexp.init(jax.random.PRNGKey(seed)))))
    monkeypatch.setattr(jattacks.GaussianAttack, "apply_local",
                        lambda self, grad, key: jnp.asarray(_noise(grad.shape[0], self.deviation), grad.dtype))
    monkeypatch.setattr(attacks.GaussianAttack, "apply_local",
                        lambda self, grad, generator: torch.as_tensor(_noise(grad.shape[0], self.deviation)))
    monkeypatch.setattr(jmetrics, "REGISTRY", jmetrics.MetricsRegistry())
    monkeypatch.setattr(metrics, "REGISTRY", metrics.MetricsRegistry())


def _both(tmp_path, argv):
    """Run the JAX runner and the port's on ``argv`` with ``--forensics``
    and a journal; returns their reports."""
    reports = {}
    for label, main, extra in (("jax", jrunner.main, ["--nb-devices", "1"]), ("port", runner.main,
                                                                                ["--device", "cpu"])):
        where = tmp_path / label
        where.mkdir()
        more = ["--checkpoint-dir", str(where / "ckpt")] if "--guardian" in argv else []
        main(argv + extra + more + ["--forensics", str(where / "f.json"), "--journal", str(where / "j.jsonl")])
        reports[label] = json.load(open(where / "f.json"))
        assert (where / "f.md").exists()
    return reports["jax"], reports["port"]


def _assert_close(got, want, where="report"):
    """Equal structure and values; floats within rtol 1e-5."""
    if isinstance(want, dict):
        keys = set(want) - UNCOMPARED
        assert set(got) - UNCOMPARED == keys, where
        for key in keys:
            _assert_close(got[key], want[key], "%s.%s" % (where, key))
    elif isinstance(want, list):
        assert len(got) == len(want), where
        for i, (a, b) in enumerate(zip(got, want)):
            _assert_close(a, b, "%s[%d]" % (where, i))
    elif isinstance(want, float) and not isinstance(want, bool):
        np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=where)
    else:
        assert got == want, where


@pytest.mark.parametrize("unroll", [1, 4])
def test_forensics_report_is_the_jax_runners(tmp_path, same_start, unroll):
    want, got = _both(tmp_path, GAUSSIAN + ["--unroll", str(unroll)])
    assert got["suspects"] == want["suspects"] == [0, 1]
    assert got["steps_observed"] == 12 and got["schema"] == forensics.SCHEMA
    for worker in got["workers"][:2]:
        assert worker["evidence"].get("distance", 0) == 12 and worker["intervals"], worker
    _assert_close(got, want)


def test_forensics_report_after_guardian_rollbacks_is_the_jax_runners(tmp_path, same_start):
    want, got = _both(tmp_path, ROLLBACK)
    kinds = [event["kind"] for event in got["guardian_events"]]
    assert kinds == ["rollback", "escalation", "rollback", "escalation", "recovered"]
    assert got["suspects"] == want["suspects"] == [0, 1]
    assert [w["evidence"].get("nan_row", 0) for w in got["workers"][:2]] == [
        w["evidence"].get("nan_row", 0) for w in want["workers"][:2]]
    assert len(got["flight_postmortems"]) == 2
    assert got["journal"]["events_by_type"] == want["journal"]["events_by_type"]
    _assert_close(got, want)


def test_forensics_module_is_a_copy():
    for total, successes, p in ((40, 12, 0.125), (10, 0, 0.5), (64, 64, 0.01)):
        assert forensics.binom_sf(total, successes, p) == jforensics.binom_sf(total, successes, p)
    rng = np.random.default_rng(3)
    ledgers = [module.ForensicsLedger(6, run_id="r", window=8) for module in (forensics, jforensics)]
    for step in range(1, 21):
        dist = rng.random(6).astype(np.float32)
        dist[2] *= 50.0 if step > 5 else 1.0
        nan = np.zeros(6, bool)
        nan[4] = step % 3 == 0
        for ledger in ledgers:
            ledger.observe(step, worker_sq_dist=dist, worker_nan=nan, reputation=None)
    for ledger in ledgers:
        ledger.note_guardian(9, "rollback", {"reason": "x"})
        ledger.truncate_after(15)
    ours, theirs = (ledger.report() for ledger in ledgers)
    _assert_close(ours, theirs)
    assert forensics.render_markdown(ours).split("\n")[2:] == jforensics.render_markdown(theirs).split("\n")[2:]


# --------------------------------------------------------------------- #
# the profiler


def test_profiler_window_parses_and_rejects(tmp_path):
    reg = metrics.MetricsRegistry()
    window = profiler.ProfilerWindow("4:8", str(tmp_path / "nowhere"), registry=reg)
    assert (window.begin, window.end) == (4, 8)
    assert not window.maybe_start(3)  # outside the window
    assert reg.snapshot()["profiler_window_active"] == 0.0
    for bad in ("8:4", "4", "a:b", "-1:3", "4:4"):
        with pytest.raises(UserException):
            profiler.ProfilerWindow(bad, str(tmp_path / "nowhere"))


def test_profiler_window_captures_one_window(tmp_path):
    window = profiler.ProfilerWindow("1:2", str(tmp_path / "prof"))
    assert not window.maybe_start(0)
    assert window.maybe_start(1) and window.active
    with window.annotate(1):
        torch.ones(4).mul(2)
    assert not window.maybe_stop(1)
    assert window.maybe_stop(2)
    assert window.done and not window.active
    assert not window.maybe_start(1)  # never reopens
    names = {event["name"] for event in json.load(open(window.path))["traceEvents"]}
    assert "train step 1" in names


def test_runner_xprof_writes_one_annotated_trace(tmp_path, monkeypatch):
    monkeypatch.setattr(metrics, "REGISTRY", metrics.MetricsRegistry())
    result = runner.main(EXP + ["--aggregator", "median", "--nb-decl-byz-workers", "1", "--max-step", "6",
                                "--device", "cpu", "--xprof", "2:4", "--trace-dir", str(tmp_path / "prof"),
                                "--metrics-file", str(tmp_path / "m.prom")])
    assert os.listdir(tmp_path / "prof") == [os.path.basename(result["xprof_trace"])]
    names = {event["name"] for event in json.load(open(result["xprof_trace"]))["traceEvents"]}
    assert {"train step 2", "train step 3"} <= names and "train step 4" not in names
    families = metrics.parse_prometheus(open(tmp_path / "m.prom").read())
    assert families["profiler_window_active"]["samples"][0][2] == 0.0
    # under --unroll the window's edges land on chunk boundaries: steps 2-3 are one chunk
    chunked = runner.main(EXP + ["--aggregator", "median", "--nb-decl-byz-workers", "1", "--max-step", "6",
                                 "--device", "cpu", "--unroll", "2", "--xprof", "2:4", "--trace-dir",
                                 str(tmp_path / "chunked")])
    names = {event["name"] for event in json.load(open(chunked["xprof_trace"]))["traceEvents"]}
    assert "train step 2" in names and "train step 3" not in names and "train step 4" not in names
    with pytest.raises(UserException, match="--xprof and --trace"):
        runner.main(EXP + ["--aggregator", "median", "--max-step", "2", "--device", "cpu", "--xprof", "0:1",
                           "--trace"])


def test_build_telemetry_counts_a_cache_miss(tmp_path):
    reg = metrics.MetricsRegistry()
    events = []

    class FakeSummaries:
        def event(self, step, tag, payload):
            events.append((step, tag, payload))

    before = dict(build.BUILD_STATS)
    watch = profiler.CompileWatch(reg, summaries=FakeSummaries(), step_provider=lambda: 7)
    profiler.install_compile_listener(reg)
    assert profiler.install_memory_gauges(reg, "cpu") == 0
    source = tmp_path / "one.c"
    source.write_text("int one(void) { return 1; }\n")
    target = str(tmp_path / ".build-0123abcd" / "libone.so")
    try:
        code, _, err = build.start_build("cc", ("-shared", "-fPIC"), str(source), target)()
    finally:
        watch.close()
    assert code == 0 and os.path.exists(target), err
    assert build.BUILD_STATS["builds"] == before["builds"] + 1
    assert [m[1] for m in watch.misses] == ["0123abcd"]
    (step, tag, payload), = events
    assert (step, tag, payload["hash"], payload["exit_code"]) == (7, "compile_cache_miss", "0123abcd", 0)
    snap = reg.snapshot()
    assert snap["compile_backend_total"] == float(build.BUILD_STATS["builds"])
    assert snap["compile_backend_seconds_total"] >= payload["seconds"] > 0
    families = metrics.parse_prometheus(reg.render_prometheus())
    (_, labels, value), = families["compile_cache_misses_total"]["samples"]
    assert labels == {"executable": payload["executable"]} and value == 1.0
    assert families["device_memory_live_bytes"]["samples"] == []
