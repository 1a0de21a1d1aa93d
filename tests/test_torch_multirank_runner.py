"""The port's runner and deploy over the worker axis, on the CPU.

- ``runner --nb-devices 2 --device cpu --gar-probe`` (the lead spawns the
  second rank) against the JAX runner at ``--nb-devices 2`` on the same
  arguments (without the probe, which raises on the JAX runner's
  multi-device mesh, a reference red): the
  evaluation TSV, the summaries, the checkpoints and ``--metrics-file``
  are written once, by the lead, at the JAX runner's steps with its
  columns, keys and families; the losses are the port's one-rank run's
  (rtol 1e-5).
- A wall-clock evaluation cadence (``--evaluation-period``) read on the
  lead's clock alone, and a SIGTERM sent to the non-lead rank: every rank
  stops at the same step and the run exits 0 with its final files.
- A rank that dies (SIGKILL) fails the run: the lead exits non-zero.
- ``cli.deploy --local-simulate 2`` forms a two-rank gloo group through
  the environment and writes the lead's files once; the cluster-spec
  resolution (``utils/cluster``) gives the JAX package's triple on
  ``tests/test_cluster.py``'s inputs.
"""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from aggregathor_tpu.cli import runner as jrunner
from aggregathor_tpu.obs import metrics as jmetrics
from aggregathor_tpu.utils import cluster as jcluster
from aggregathor_tpu_torch.cli import deploy, runner
from aggregathor_tpu_torch.obs import metrics
from aggregathor_tpu_torch.utils import UserException
from aggregathor_tpu_torch.utils import cluster

from torch_threads import pinned_threads  # noqa: F401  (a fixture: the xdist worker's intra-op pool)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN = ["--experiment", "mnist", "--experiment-args", "hidden:16", "batch-size:8", "--aggregator", "krum",
       "--nb-workers", "8", "--nb-decl-byz-workers", "2", "--nb-real-byz-workers", "2", "--attack", "signflip",
       "--learning-rate-args", "initial-rate:0.05", "--prefetch", "0"]
FILES = ["--max-step", "8", "--evaluation-delta", "3", "--evaluation-period", "-1", "--summary-delta", "2",
         "--summary-period", "-1", "--checkpoint-delta", "4", "--checkpoint-period", "-1"]
#: the GAR probe over the axis (the JAX runner's raises on a multi-device
#: mesh, a red of the reference: ROADMAP queue 3)
PROBE = ["--gar-probe"]


def _env():
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("XLA_FLAGS", None)
    return env


def _outputs(where):
    return ["--evaluation-file", str(where / "eval.tsv"), "--summary-dir", str(where / "sum"),
            "--checkpoint-dir", str(where / "ckpt"), "--metrics-file", str(where / "m.prom")]


def _port(argv, **kwargs):
    return subprocess.Popen([sys.executable, "-m", "aggregathor_tpu_torch.cli.runner"] + argv, env=_env(),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, **kwargs)


def _eval_steps(path):
    return [int(line.split("\t")[1]) for line in open(path)]


def _summaries(directory):
    names = os.listdir(directory)
    assert len(names) == 1, names  # one writer
    return [json.loads(line) for line in open(os.path.join(directory, names[0]))]


def _ranks_of(pid):
    """The pids of the ranks the lead ``pid`` spawned."""
    found = []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open("/proc/%s/stat" % entry) as fd:
                ppid = int(fd.read().rsplit(")", 1)[1].split()[1])
            with open("/proc/%s/cmdline" % entry, "rb") as fd:
                cmdline = fd.read()
        except OSError:
            continue
        if ppid == pid and b"spawn_main" in cmdline:
            found.append(int(entry))
    return found


def _wait_for(predicate, proc, timeout=120.0):
    deadline = time.monotonic() + timeout
    while not predicate():
        assert proc.poll() is None, proc.communicate()[0][-3000:]
        assert time.monotonic() < deadline, "timed out"
        time.sleep(0.1)


def test_two_ranks_write_what_the_jax_runner_writes_once(tmp_path, monkeypatch):
    monkeypatch.setattr(jmetrics, "REGISTRY", jmetrics.MetricsRegistry())
    monkeypatch.setattr(metrics, "REGISTRY", metrics.MetricsRegistry())
    for label in ("jax", "two", "one"):
        (tmp_path / label).mkdir()
    proc = _port(RUN + FILES + PROBE + _outputs(tmp_path / "two") + ["--device", "cpu", "--nb-devices", "2"])
    jrunner.main(RUN + FILES + _outputs(tmp_path / "jax") + ["--nb-devices", "2"])
    one = runner.main(RUN + FILES + PROBE + _outputs(tmp_path / "one") + ["--device", "cpu"])
    out, _ = proc.communicate(timeout=300)
    assert proc.returncode == 0, out[-3000:]
    assert "Rank 0 of 2 stopped at step 8" in out and "Rank 1 of 2 stopped at step 8" in out
    assert one["nb_devices"] == 1
    jax_dir, two, one_dir = tmp_path / "jax", tmp_path / "two", tmp_path / "one"
    assert _eval_steps(two / "eval.tsv") == _eval_steps(jax_dir / "eval.tsv") == [1, 4, 7, 8]
    assert sorted(os.listdir(two / "ckpt")) == sorted(os.listdir(jax_dir / "ckpt"))
    theirs, ours, single = _summaries(jax_dir / "sum"), _summaries(two / "sum"), _summaries(one_dir / "sum")
    assert [e["step"] for e in ours] == [e["step"] for e in theirs]
    for mine, want in zip(ours, theirs):
        assert set(want) - set(mine) <= {"chaos_regime"}, set(want) - set(mine)
    np.testing.assert_allclose([e["total_loss"] for e in ours], [e["total_loss"] for e in single], rtol=1e-5)
    families = metrics.parse_prometheus(open(two / "m.prom").read())
    assert set(families) == set(jmetrics.parse_prometheus(open(jax_dir / "m.prom").read()))
    assert families["train_steps_total"]["samples"][0][2] == 8.0
    rows = [line.split("\t")[2:] for line in open(two / "eval.tsv")]
    single_rows = [line.split("\t")[2:] for line in open(one_dir / "eval.tsv")]
    for mine, want in zip(rows, single_rows):
        np.testing.assert_allclose([float(v.split(":")[1]) for v in mine], [float(v.split(":")[1]) for v in want],
                                   rtol=1e-5)


def test_sigterm_on_a_non_lead_rank_stops_every_rank_at_one_step(tmp_path):
    proc = _port(RUN + ["--max-step", "100000", "--evaluation-delta", "-1", "--evaluation-period", "0.3",
                        "--evaluation-file", str(tmp_path / "eval.tsv"), "--summary-period", "-1",
                        "--checkpoint-period", "-1", "--device", "cpu", "--nb-devices", "2"])
    try:
        _wait_for(lambda: os.path.exists(tmp_path / "eval.tsv") and len(_eval_steps(tmp_path / "eval.tsv")) >= 2,
                  proc)
        ranks = _ranks_of(proc.pid)
        assert len(ranks) == 1, ranks
        os.kill(ranks[0], signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, out[-3000:]
    stops = sorted(line.split("Rank ", 1)[1] for line in out.splitlines() if "stopped at step" in line)
    assert len(stops) == 2, stops
    (lead_step,), (other_step,) = [[int(s.rsplit(" ", 1)[1])] for s in stops]
    assert lead_step == other_step < 100000
    steps = _eval_steps(tmp_path / "eval.tsv")
    assert steps == sorted(set(steps)) and steps[-1] == lead_step  # once a step; the final evaluation


def test_a_dead_rank_fails_the_run(tmp_path):
    proc = _port(RUN + ["--max-step", "100000", "--evaluation-delta", "5", "--evaluation-period", "-1",
                        "--evaluation-file", str(tmp_path / "eval.tsv"), "--summary-period", "-1",
                        "--checkpoint-period", "-1", "--device", "cpu", "--nb-devices", "2"])
    try:
        _wait_for(lambda: os.path.exists(tmp_path / "eval.tsv") and len(_eval_steps(tmp_path / "eval.tsv")) >= 1,
                  proc)
        ranks = _ranks_of(proc.pid)
        assert len(ranks) == 1, ranks
        os.kill(ranks[0], signal.SIGKILL)
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode != 0, out[-3000:]


def test_deploy_local_simulate_forms_a_two_rank_group(tmp_path):
    argv = [sys.executable, "-m", "aggregathor_tpu_torch.cli.deploy", "--local-simulate", "2", "--"] + RUN + [
        "--max-step", "4", "--evaluation-delta", "2", "--evaluation-period", "-1", "--summary-period", "-1",
        "--checkpoint-period", "-1", "--evaluation-file", str(tmp_path / "eval.tsv")]
    done = subprocess.run(argv, env=_env(), capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stdout[-3000:] + done.stderr[-3000:]
    assert "Worker axis: 2 ranks over gloo (cpu)" in done.stdout + done.stderr
    assert _eval_steps(tmp_path / "eval.tsv") == [1, 3, 4]
    with pytest.raises(UserException):
        deploy.main(["--devices-per-process", "2", "--"] + RUN)
    with pytest.raises(UserException):
        deploy.main(["--cluster", '["a"]', "--num-processes", "2", "--"] + RUN)


@pytest.mark.parametrize("spec, port, rank", [
    ('["h0", "h1", "h2"]', None, 1), ('{"hosts": ["h0", "h1"], "port": 9000}', None, 0),
    ('{"hosts": ["h0", "h1"], "port": 9000}', 4321, 1), ('["h0:555", "h1"]', None, 0)])
def test_cluster_spec_is_the_jax_packages(monkeypatch, spec, port, rank):
    monkeypatch.setenv("AGGREGATHOR_PROCESS_ID", str(rank))
    assert cluster.cluster_spec(spec, port=port) == jcluster.cluster_spec(spec, port=port)


def test_cluster_files_and_refusals_are_the_jax_packages(tmp_path, monkeypatch):
    monkeypatch.setenv("AGGREGATHOR_PROCESS_ID", "0")
    nodes = tmp_path / "nodes"
    nodes.write_text("n0\nn0\nn1\n")
    spec = tmp_path / "spec.json"
    spec.write_text('{"hosts": ["j0", "j1"], "port": 7171}')
    monkeypatch.setenv("OAR_FILE_NODES", str(nodes))
    for argument in (str(nodes), str(spec), "G5k"):
        assert cluster.cluster_spec(argument) == jcluster.cluster_spec(argument)
    assert cluster.parse_nodefile(str(nodes)) == jcluster.parse_nodefile(str(nodes)) == ["n0", "n1"]
    for bad in ("not a spec", "[]", "{bad json"):
        with pytest.raises(UserException):
            cluster.cluster_spec(bad)
    monkeypatch.setenv("AGGREGATHOR_PROCESS_ID", "x")
    with pytest.raises(UserException):
        cluster.cluster_spec('["a", "b"]')


GUARDIAN = ["--experiment", "mnist", "--experiment-args", "batch-size:16", "hidden:16", "--evaluation-delta", "-1",
            "--evaluation-period", "-1", "--checkpoint-period", "-1", "--prefetch", "0", "--aggregator", "average",
            "--nb-workers", "8", "--nb-decl-byz-workers", "2", "--nb-real-byz-workers", "2", "--attack", "inf",
            "--guardian", "--guardian-args", "recover:5", "--checkpoint-delta", "4", "--max-step", "30",
            "--summary-delta", "5", "--learning-rate-args", "initial-rate:0.05"]


def test_guardian_rollbacks_at_two_ranks_follow_one_rank(tmp_path, monkeypatch):
    """The lead's watchdog decides and every rank rolls back with it: the
    two-rank run's guardian timeline and forensics verdicts are the one-rank
    run's."""
    monkeypatch.setattr(metrics, "REGISTRY", metrics.MetricsRegistry())
    timelines, reports = {}, {}
    for label in ("one", "two"):
        where = tmp_path / label
        argv = GUARDIAN + ["--device", "cpu", "--checkpoint-dir", str(where / "ckpt"), "--summary-dir",
                           str(where / "sum"), "--forensics", str(where / "f.json")]
        if label == "one":
            runner.main(argv)
        else:
            proc = _port(argv + ["--nb-devices", "2"])
            out, _ = proc.communicate(timeout=300)
            assert proc.returncode == 0, out[-3000:]
        timelines[label] = [(e["event"], e["step"]) for e in _summaries(where / "sum") if "event" in e]
        reports[label] = json.load(open(where / "f.json"))
    assert [event for event, _ in timelines["two"]] == ["guardian_rollback", "guardian_escalation",
                                                        "guardian_rollback", "guardian_escalation",
                                                        "guardian_recovered"]
    assert timelines["two"] == timelines["one"]
    assert reports["two"]["suspects"] == reports["one"]["suspects"] == [0, 1]
    assert reports["two"]["guardian_events"] == reports["one"]["guardian_events"]
