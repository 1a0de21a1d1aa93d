"""The port's runner, device policy and package boundary.

- ``--device cpu`` trains a few steps end to end and prints steps/s
  (excluding the first step), the final evaluation and the launch counts;
- ``--UDP`` runs: ``average-nan`` ends with a finite loss, plain
  ``average`` stops with the divergence error (NaN reaches the
  parameters), CLEVER infill keeps ``average`` finite;
- without ``--device cpu`` and without a GPU the runner fails loudly
  instead of falling back to the CPU;
- the cadence, checkpoint and summary flags take the JAX runner's
  defaults; a run resumed from its checkpoint (10 steps, then an
  auto-restore and 10 more; or a restore to an older snapshot after a
  simulated kill) ends with the same parameters, optimizer state and
  evaluations, bit for bit, as an uninterrupted run, and its evaluation
  TSV has no duplicate step rows; the summary JSONL carries the run id and
  the four scalars; a diverging run writes no final checkpoint;
- the input path: ``--unroll``, ``--prefetch`` and ``--input-source`` take
  the JAX runner's defaults and choices; the final parameters are the same
  bits with ``--prefetch 0`` and ``--prefetch 2``, per step and under
  ``--unroll 10``; ``--input-source device`` refuses the poisoning
  experiments, moves cnnet's host augmentation in-step, and resumes bit
  for bit (10 + 10 steps against 20); the evaluation rows fall where the JAX
  runner's cadence puts them, at every step with ``--unroll 1`` and at chunk
  boundaries with ``--unroll 10``, and the evaluations they share agree;
- the port imports nothing of JAX, flax, optax or the JAX package (AST
  scan of every module, of ``chip_smoke.py`` and of the GPU tests, which
  run on a machine without JAX).
"""

import ast
import json
import os

import pytest
import torch

from aggregathor_tpu_torch.cli import runner
from aggregathor_tpu_torch.utils import UserException, resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "aggregathor_tpu")

MNIST = ["--experiment", "mnist", "--experiment-args", "hidden:16", "batch-size:8",
         "--nb-workers", "8", "--nb-decl-byz-workers", "2"]


def test_cpu_run_prints_steps_per_second(capsys, tmp_path):
    tsv = tmp_path / "eval.tsv"
    result = runner.main(MNIST + [
        "--aggregator", "krum", "--nb-real-byz-workers", "2", "--attack", "signflip",
        "--max-step", "6", "--evaluation-delta", "3", "--evaluation-file", str(tsv),
        "--learning-rate-args", "initial-rate:0.05", "--device", "cpu",
    ])
    out = capsys.readouterr().out
    assert "steps/s (excl. 1st)" in out and "kernel launches" in out and "final evaluation" in out
    assert result["steps"] == 6 and result["steps_per_s"] > 0 and result["device"] == "cpu"
    assert result["final_loss"] == result["final_loss"]  # finite, not NaN
    assert 0.0 <= result["evaluation"]["accuracy"] <= 1.0
    # the CPU path runs the plain versions: no kernel launch
    assert set(result["launches"].values()) == {0}
    rows = tsv.read_text().splitlines()
    # the JAX runner's cadence: a first fire at the first check, then every
    # 3 steps, then the last step
    assert [row.split("\t")[1] for row in rows] == ["1", "4", "6"]
    assert "in-graph time" in out and "off-graph time" in out and "step latency p50/p95/p99" in out


@pytest.mark.parametrize("rule", ["median", "bulyan", "trimmed-mean", "averaged-median", "average"])
def test_cpu_run_every_rule(rule):
    f = ["--nb-decl-byz-workers", "1"] if rule == "bulyan" else []  # bulyan: n >= 4f + 3
    result = runner.main(MNIST + f + ["--aggregator", rule, "--max-step", "2", "--device", "cpu"])
    assert result["steps"] == 2 and result["evaluation"] is not None


@pytest.mark.parametrize("experiment, args", [
    ("digits", ["hidden:16"]), ("digits-conv", ["batch-size:2"]),
    ("mnistAttack", ["hidden:16", "severity:1"]), ("digitsAttack", ["hidden:16", "severity:1"]),
])
def test_cpu_run_every_experiment(experiment, args):
    result = runner.main(["--experiment", experiment, "--experiment-args", *args, "--aggregator", "krum",
                          "--nb-workers", "8", "--nb-decl-byz-workers", "2", "--max-step", "2", "--device", "cpu"])
    assert result["steps"] == 2 and result["final_loss"] == result["final_loss"]
    assert 0.0 <= result["evaluation"]["accuracy"] <= 1.0


def test_divergence_is_loud():
    with pytest.raises(UserException, match="diverged"):
        runner.main(MNIST + ["--aggregator", "average", "--nb-decl-byz-workers", "0",
                             "--nb-real-byz-workers", "1", "--attack", "inf",
                             "--max-step", "4", "--device", "cpu"])


UDP = ["--UDP", "4", "--UDP-args", "drop-rate:0.3", "packet-coords:1024", "min-coords:0"]


def test_udp_run_with_average_nan_stays_finite():
    result = runner.main(MNIST + UDP + ["--aggregator", "average-nan", "--nb-decl-byz-workers", "0",
                                        "--max-step", "8", "--device", "cpu"])
    assert result["steps"] == 8 and result["final_loss"] == result["final_loss"]
    assert abs(result["final_loss"]) != float("inf")


def test_udp_run_with_plain_average_diverges():
    with pytest.raises(UserException, match="diverged"):
        runner.main(MNIST + UDP + ["--aggregator", "average", "--nb-decl-byz-workers", "0",
                                   "--max-step", "8", "--device", "cpu"])


def test_udp_clever_run_with_plain_average_stays_finite():
    result = runner.main(MNIST + UDP + ["clever:true", "--aggregator", "average", "--nb-decl-byz-workers", "0",
                                        "--max-step", "4", "--device", "cpu"])
    assert result["final_loss"] == result["final_loss"] and abs(result["final_loss"]) != float("inf")


def test_cadence_flags_take_the_jax_defaults():
    from aggregathor_tpu import config as jconfig
    from aggregathor_tpu.cli.runner import build_parser as jax_parser
    from aggregathor_tpu_torch import config

    argv = ["--experiment", "digits", "--aggregator", "krum", "--nb-workers", "8"]
    ours, theirs = runner.build_parser().parse_args(argv), jax_parser().parse_args(argv)
    for flag in CADENCE_FLAGS:
        assert getattr(ours, flag) == getattr(theirs, flag), flag
    for name in ("evaluation_delta", "evaluation_period", "checkpoint_base_name", "checkpoint_delta",
                 "checkpoint_period", "summary_delta", "summary_period"):
        assert getattr(config, "default_" + name) == getattr(jconfig, "default_" + name), name


CADENCE_FLAGS = ("evaluation_file", "evaluation_delta", "evaluation_period", "checkpoint_dir",
                 "checkpoint_base_name", "checkpoint_delta", "checkpoint_period", "checkpoint_keep",
                 "summary_dir", "summary_delta", "summary_period")
DIGITS = ["--experiment", "digits", "--experiment-args", "hidden:16", "batch-size:8", "--aggregator", "krum",
          "--nb-workers", "8", "--nb-decl-byz-workers", "2", "--nb-real-byz-workers", "2", "--attack", "gaussian",
          "--optimizer", "adam", "--learning-rate-args", "initial-rate:0.01", "--evaluation-period", "-1",
          "--summary-period", "-1", "--checkpoint-period", "-1", "--device", "cpu"]


def _snapshot(directory, step):
    return torch.load(os.path.join(str(directory), "model-%d.ckpt" % step), weights_only=True)


def _assert_same_bits(a, b):
    assert a.keys() == b.keys()
    for key in a:
        if isinstance(a[key], dict):
            _assert_same_bits(a[key], b[key])
        elif isinstance(a[key], torch.Tensor):
            assert torch.equal(a[key].view(torch.int32), b[key].view(torch.int32)), key
        else:
            assert a[key] == b[key], key


def _rows(path):
    """{step: the row's metric fields}, after checking no step repeats."""
    rows = [line.split("\t") for line in open(path).read().splitlines()]
    steps = [int(row[1]) for row in rows]
    assert len(steps) == len(set(steps)) and steps == sorted(steps), steps
    return {int(row[1]): row[2:] for row in rows}


def test_resume_is_bit_identical_to_an_uninterrupted_run(tmp_path):
    whole, split = tmp_path / "whole", tmp_path / "split"
    common = DIGITS + ["--evaluation-delta", "5"]
    full = runner.main(common + ["--max-step", "20", "--checkpoint-dir", str(whole),
                                 "--evaluation-file", str(whole / "eval.tsv"), "--summary-dir", str(whole),
                                 "--summary-delta", "10"])
    first = runner.main(common + ["--max-step", "10", "--checkpoint-dir", str(split), "--checkpoint-delta", "10",
                                  "--evaluation-file", str(split / "eval.tsv")])
    second = runner.main(common + ["--max-step", "20", "--checkpoint-dir", str(split), "--checkpoint-delta", "10",
                                   "--evaluation-file", str(split / "eval.tsv")])
    assert (first["steps"], first["restored_step"], second["steps"], second["restored_step"]) == (10, 0, 10, 10)
    saved = _snapshot(split, 10)
    assert saved["step"] == 10 and saved["opt_state"]["count"] == 10
    _assert_same_bits(_snapshot(whole, 20), _snapshot(split, 20))
    assert second["final_loss"] == full["final_loss"]
    rows, full_rows = _rows(split / "eval.tsv"), _rows(whole / "eval.tsv")
    assert sorted(rows) == [1, 6, 10, 11, 16, 20] and sorted(full_rows) == [1, 6, 11, 16, 20]
    for step in (1, 6, 11, 16, 20):
        assert rows[step] == full_rows[step]  # the same evaluations, to the printed digit
    # the summary stream: the run id and the four scalars on every line
    (path,) = [p for p in os.listdir(str(whole)) if p.endswith(".jsonl")]
    events = [json.loads(line) for line in open(os.path.join(str(whole), path))]
    assert [e["step"] for e in events] == [1, 11, 20]
    for event in events:
        assert {"run_id", "step", "total_loss", "grad_norm", "learning_rate", "steps_per_s"} <= set(event)
        assert event["run_id"] == events[0]["run_id"] and event["learning_rate"] == 0.01


def test_resume_after_a_kill_trims_the_tsv_and_realigns_the_streams(tmp_path):
    whole, killed = tmp_path / "whole", tmp_path / "killed"
    common = DIGITS + ["--evaluation-delta", "1", "--checkpoint-delta", "4"]
    runner.main(common + ["--max-step", "12", "--checkpoint-dir", str(whole)])
    runner.main(common + ["--max-step", "10", "--checkpoint-dir", str(killed),
                          "--evaluation-file", str(killed / "eval.tsv")])
    for step in (9, 10):  # the run was killed after step 8, before these reached the disk
        os.remove(os.path.join(str(killed), "model-%d.ckpt" % step))
    resumed = runner.main(common + ["--max-step", "12", "--checkpoint-dir", str(killed),
                                    "--evaluation-file", str(killed / "eval.tsv")])
    assert resumed["restored_step"] == 5 and resumed["steps"] == 7
    assert sorted(_rows(killed / "eval.tsv")) == list(range(1, 13))
    _assert_same_bits(_snapshot(whole, 12), _snapshot(killed, 12))


def test_a_diverging_run_writes_no_final_checkpoint(tmp_path):
    from aggregathor_tpu_torch.obs.checkpoint import Checkpoints

    with pytest.raises(UserException, match="diverged"):
        runner.main(MNIST + ["--aggregator", "average", "--nb-decl-byz-workers", "0", "--nb-real-byz-workers", "1",
                             "--attack", "inf", "--max-step", "4", "--checkpoint-dir", str(tmp_path),
                             "--checkpoint-delta", "100", "--checkpoint-period", "-1",
                             "--evaluation-file", str(tmp_path / "eval.tsv"), "--device", "cpu"])
    # the first check's snapshot only: no fire after the divergence, and no final one
    assert Checkpoints(str(tmp_path)).steps() == [1]
    assert [row.split("\t")[1] for row in open(tmp_path / "eval.tsv").read().splitlines()] == ["1"]


def test_cuda_without_a_gpu_fails_instead_of_falling_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(UserException, match="no GPU"):
        runner.main(MNIST + ["--aggregator", "krum", "--max-step", "1"])
    with pytest.raises(UserException):
        resolve_device("cuda")
    monkeypatch.setattr("sys.argv", ["runner"] + MNIST + ["--aggregator", "krum", "--max-step", "1"])
    assert runner.cli() == 1
    assert resolve_device("cpu") == torch.device("cpu")


def test_argument_errors_are_user_errors():
    with pytest.raises(UserException):
        runner.main(MNIST + ["--aggregator", "krum", "--nb-real-byz-workers", "9", "--device", "cpu"])
    with pytest.raises(UserException):
        runner.main(MNIST + ["--aggregator", "bulyan", "--device", "cpu"])  # n=8 < 4f+3
    with pytest.raises(SystemExit):
        runner.main(MNIST + ["--aggregator", "krum", "--device", "tpu"])


INPUT_FLAGS = ("unroll", "prefetch", "input_source")


def test_input_flags_take_the_jax_defaults_and_choices():
    from aggregathor_tpu.cli.runner import build_parser as jax_parser

    argv = ["--experiment", "digits", "--aggregator", "krum", "--nb-workers", "8"]
    ours, theirs = runner.build_parser().parse_args(argv), jax_parser().parse_args(argv)
    assert ours.prefetch == 2
    actions = {a.dest: a for a in runner.build_parser()._actions}
    jax_actions = {a.dest: a for a in jax_parser()._actions}
    for flag in INPUT_FLAGS:
        assert getattr(ours, flag) == getattr(theirs, flag), flag
        assert (actions[flag].type, actions[flag].choices) == (jax_actions[flag].type, jax_actions[flag].choices)
    with pytest.raises(SystemExit):
        runner.build_parser().parse_args(argv + ["--input-source", "disk"])


#: the JAX runner's options the port still lacks (later slices shrink it)
CLI_GAP = {"--mesh", "--microbatches", "--l1-regularize", "--l2-regularize", "--slo-baseline", "--slo-capture",
           "--slo-verdict", "--topology"}


def test_the_cli_gap_is_the_known_eight_options():
    from aggregathor_tpu.cli.runner import build_parser as jax_parser

    def options(parser):
        return {option for action in parser._actions for option in action.option_strings}

    ours, theirs = options(runner.build_parser()), options(jax_parser())
    assert theirs - ours == CLI_GAP
    assert ours - theirs == {"--device"}


def _final_params(directory, argv):
    result = runner.main(argv + ["--checkpoint-dir", str(directory), "--checkpoint-delta", "1000",
                                 "--checkpoint-period", "-1"])
    return result, _snapshot(directory, result["restored_step"] + result["steps"])


@pytest.mark.parametrize("unroll", ["1", "10"])
def test_prefetch_does_not_change_training(tmp_path, unroll):
    argv = DIGITS + ["--max-step", "23", "--unroll", unroll, "--evaluation-delta", "10"]
    got = [_final_params(tmp_path / depth, argv + ["--prefetch", depth]) for depth in ("0", "2")]
    assert got[0][0]["steps"] == got[1][0]["steps"] == 23
    _assert_same_bits(got[0][1], got[1][1])
    assert got[0][0]["evaluation"] == got[1][0]["evaluation"]


def test_unroll_chunks_are_the_steps_and_cadences_fire_at_chunk_boundaries(tmp_path):
    from aggregathor_tpu.obs.cadence import CadenceTrigger as JaxTrigger

    def jax_rows(boundaries, delta):
        trigger, rows = JaxTrigger(delta, -1.0), []
        for step in boundaries:
            if trigger.should_fire(step):
                rows.append(step)
                trigger.fired(step)
        return rows if rows[-1] == boundaries[-1] else rows + [boundaries[-1]]

    rows, finals = {}, {}
    for unroll in (1, 10):
        tsv = tmp_path / ("eval-%d.tsv" % unroll)
        result, finals[unroll] = _final_params(tmp_path / str(unroll), DIGITS + [
            "--max-step", "30", "--unroll", str(unroll), "--evaluation-delta", "10", "--evaluation-file", str(tsv)])
        rows[unroll] = _rows(tsv)
        assert sorted(rows[unroll]) == jax_rows(list(range(unroll, 31, unroll)), 10)
    assert sorted(rows[1]) == [1, 11, 21, 30] and sorted(rows[10]) == [10, 20, 30]
    # the K-step trainer is K steps: the same final bits and evaluation
    _assert_same_bits(finals[1], finals[10])
    assert rows[1][30] == rows[10][30]


def test_device_input_refuses_the_poisoning_experiments():
    for experiment in ("mnistAttack", "digitsAttack"):
        with pytest.raises(UserException, match="train_arrays"):
            runner.main(["--experiment", experiment, "--experiment-args", "hidden:16", "--aggregator", "average",
                         "--nb-workers", "2", "--max-step", "1", "--input-source", "device", "--device", "cpu"])


def test_device_input_routes_cnnet_augmentation_in_step(capsys):
    result = runner.main(["--experiment", "cnnet", "--experiment-args", "batch-size:2", "--aggregator", "average",
                          "--nb-workers", "2", "--max-step", "2", "--input-source", "device", "--device", "cpu",
                          "--evaluation-delta", "-1", "--evaluation-period", "-1"])
    assert "routing 'cifarnet' augmentation through the in-step device tier" in capsys.readouterr().out
    assert result["steps"] == 2 and result["final_loss"] == result["final_loss"]


def test_device_input_resume_is_bit_identical(tmp_path):
    whole, split = tmp_path / "whole", tmp_path / "split"
    common = DIGITS + ["--input-source", "device", "--unroll", "4", "--evaluation-delta", "5",
                       "--checkpoint-delta", "10"]
    full = runner.main(common + ["--max-step", "20", "--checkpoint-dir", str(whole),
                                 "--evaluation-file", str(whole / "eval.tsv")])
    first = runner.main(common + ["--max-step", "10", "--checkpoint-dir", str(split),
                                  "--evaluation-file", str(split / "eval.tsv")])
    second = runner.main(common + ["--max-step", "20", "--checkpoint-dir", str(split),
                                   "--evaluation-file", str(split / "eval.tsv")])
    assert (first["steps"], second["restored_step"], second["steps"]) == (10, 10, 10)
    _assert_same_bits(_snapshot(whole, 20), _snapshot(split, 20))
    assert second["final_loss"] == full["final_loss"]
    assert _rows(split / "eval.tsv")[20] == _rows(whole / "eval.tsv")[20]


def _imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    paths = [os.path.join(REPO, "chip_smoke.py"), os.path.join(REPO, "tests", "test_torch_gpu.py"),
             os.path.join(REPO, "tests", "torch_rank_cases.py")]  # what spawned ranks import
    for root, _, files in os.walk(os.path.join(REPO, "aggregathor_tpu_torch")):
        paths += [os.path.join(root, name) for name in files if name.endswith(".py")]
    assert len(paths) > 20
    for module in ("models/datasets.py", "models/digits.py", "models/mnist_attack.py", "gars/oracle.py",
                   "obs/cadence.py", "obs/checkpoint.py", "obs/summaries.py", "obs/perf.py",
                   "core/train_state.py", "cli/runner.py", "core/flatten.py", "models/preprocessing.py",
                   "models/__init__.py", "models/cnnet.py", "parallel/engine.py", "obs/metrics.py",
                   "obs/trace.py", "obs/live.py", "obs/events.py", "guardian/escalate.py", "guardian/watchdog.py",
                   "utils/access.py", "utils/plugins.py", "cli/__init__.py", "parallel/mesh.py", "obs/profiler.py",
                   "obs/forensics.py", "utils/cluster.py", "cli/deploy.py", "chaos/__init__.py",
                   "chaos/schedule.py", "chaos/stragglers.py", "chaos/campaign.py", "chaos/replica_faults.py",
                   "parallel/compress.py", "models/zoo.py", "models/resnet.py", "models/vgg.py",
                   "models/classic.py", "models/mobilenet.py", "models/inception.py", "models/nasnet.py",
                   "models/tfrecord.py", "models/common.py", "ops/native/__init__.py"):
        assert os.path.join(REPO, "aggregathor_tpu_torch", module) in paths, module
    offenders = [
        (os.path.relpath(path, REPO), module)
        for path in paths for module in _imports(path)
        if module.split(".")[0] in FORBIDDEN
    ]
    assert offenders == []
