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
- ``--l1-regularize``/``--l2-regularize`` on the flat engine give the JAX
  runner's losses (from JAX's weights, ``--nb-devices 1`` there);
  ``--mesh 1,1,1`` (the sharded engine) trains the transformer with
  evaluation (the sharded loss and the dense metrics) and checkpoints, and
  a run resumed from its snapshot ends with the uninterrupted run's bits;
  the JAX runner's refusals of ``--mesh`` are the port's;
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

from torch_threads import pinned_threads  # noqa: F401  (a fixture: the xdist worker's intra-op pool)

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


#: the last four JAX options the port lacked, ported with the fleet planes
CLI_GAP = {"--slo-baseline", "--slo-capture", "--slo-verdict", "--topology"}


def _options(parser):
    return {option: action for action in parser._actions for option in action.option_strings}


def test_the_cli_gap_is_the_known_four_options():
    """The four options the gap held now parse as JAX's: the same defaults,
    metavars and types."""
    from aggregathor_tpu.cli.runner import build_parser as jax_parser

    ours, theirs = _options(runner.build_parser()), _options(jax_parser())
    for option in sorted(CLI_GAP):
        assert (ours[option].default, ours[option].metavar, ours[option].type) == (
            theirs[option].default, theirs[option].metavar, theirs[option].type), option


def test_the_cli_gap_is_empty_but_the_port_s_device():
    from aggregathor_tpu.cli.runner import build_parser as jax_parser

    ours, theirs = set(_options(runner.build_parser())), set(_options(jax_parser()))
    assert theirs - ours == set()
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
                   "models/tfrecord.py", "models/common.py", "ops/native/__init__.py", "models/transformer.py",
                   "parallel/collectives.py", "parallel/sharded_engine.py", "serve/__init__.py",
                   "serve/engine.py", "serve/continuous.py", "serve/weights.py", "serve/autoscale.py",
                   "serve/frontend.py", "serve/campaign.py", "cli/serve.py", "serve/router.py", "cli/router.py",
                   "obs/fleet.py", "obs/causal.py", "obs/slo.py", "topology/__init__.py", "topology/spec.py",
                   "topology/tree.py", "supervisor/__init__.py", "supervisor/policy.py", "supervisor/actuator.py",
                   "cli/supervise.py", "cli/postmortem.py", "analysis/__init__.py", "analysis/__main__.py",
                   "analysis/core.py", "analysis/baseline.py", "analysis/report.py", "analysis/retrace.py",
                   "analysis/prng.py", "analysis/concurrency.py", "analysis/events_check.py",
                   "analysis/gar_contract.py"):
        assert os.path.join(REPO, "aggregathor_tpu_torch", module) in paths, module
    offenders = [
        (os.path.relpath(path, REPO), module)
        for path in paths for module in _imports(path)
        if module.split(".")[0] in FORBIDDEN
    ]
    assert offenders == []


# --------------------------------------------------------------------- #
# l1/l2 and the sharded engine (--mesh)


def _summary_losses(directory):
    events = [json.loads(line) for name in sorted(os.listdir(directory))
              for line in open(os.path.join(directory, name))]
    return {e["step"]: e["total_loss"] for e in events if "total_loss" in e}


def test_l1_l2_regularize_matches_the_jax_runner(tmp_path, monkeypatch):
    import jax
    import numpy as np

    from aggregathor_tpu import models as jmodels
    from aggregathor_tpu.cli import runner as jrunner
    from aggregathor_tpu_torch.models import mnist
    from aggregathor_tpu_torch.models.common import params_from_jax

    jexp = jmodels.instantiate("mnist", ["hidden:16", "batch-size:8"])
    monkeypatch.setattr(mnist.MNISTExperiment, "init", lambda self, seed: params_from_jax(
        jax.tree_util.tree_map(np.asarray, jexp.init(jax.random.PRNGKey(seed)))))
    argv = MNIST + ["--aggregator", "krum", "--l1-regularize", "1e-3", "--l2-regularize", "1e-2", "--max-step", "3",
                    "--learning-rate-args", "initial-rate:0.05", "--evaluation-delta", "-1", "--evaluation-period",
                    "-1", "--summary-delta", "1", "--summary-period", "-1", "--prefetch", "0"]
    jrunner.main(argv + ["--summary-dir", str(tmp_path / "jax"), "--nb-devices", "1"])
    runner.main(argv + ["--summary-dir", str(tmp_path / "port"), "--device", "cpu"])
    plain = tmp_path / "plain"
    runner.main([a for a in argv if a not in ("--l1-regularize", "1e-3", "--l2-regularize", "1e-2")]
                + ["--summary-dir", str(plain), "--device", "cpu"])
    want, got = _summary_losses(tmp_path / "jax"), _summary_losses(tmp_path / "port")
    assert sorted(got) == sorted(want) == [1, 2, 3]
    np.testing.assert_allclose([got[k] for k in (1, 2, 3)], [want[k] for k in (1, 2, 3)], rtol=1e-4)
    assert got[1] > _summary_losses(plain)[1]  # the norms ride the loss


MESH = ["--experiment", "transformer", "--experiment-args", "d-model:16", "heads:2", "layers:2", "seq:16",
        "batch-size:4", "vocab:32", "corpus:4096", "--aggregator", "krum", "--nb-workers", "5",
        "--nb-decl-byz-workers", "1", "--mesh", "1,1,1", "--granularity", "layer", "--optimizer", "adam",
        "--evaluation-delta", "100", "--evaluation-period", "-1", "--checkpoint-delta", "3", "--checkpoint-period",
        "-1", "--device", "cpu"]


@pytest.fixture
def two_threads():
    """Two intra-op threads: the tiny transformer's many small ops stall on a
    full pool when the suite's workers share the cores."""
    previous = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(previous)


@pytest.mark.usefixtures("two_threads")
def test_mesh_run_evaluates_checkpoints_and_resumes_bit_for_bit(tmp_path):
    whole = runner.main(MESH + ["--max-step", "6", "--checkpoint-dir", str(tmp_path / "whole")])
    runner.main(MESH + ["--max-step", "3", "--checkpoint-dir", str(tmp_path / "split")])
    resumed = runner.main(MESH + ["--max-step", "6", "--checkpoint-dir", str(tmp_path / "split")])
    assert resumed["restored_step"] == 3 and resumed["steps"] == 3 and whole["steps"] == 6
    assert set(whole["evaluation"]) == {"loss", "accuracy", "nll"}
    # one rank holds every block: the dense replica's nll is the sharded loss
    assert abs(whole["evaluation"]["loss"] - whole["evaluation"]["nll"]) < 1e-5
    assert whole["evaluation"] == resumed["evaluation"]
    a, b = (torch.load(tmp_path / name / "model-6.ckpt", weights_only=True) for name in ("whole", "split"))
    assert a["params"]["wq"].shape == (1, 2, 16, 16)
    for tree in ("params", "opt_state"):
        for name, value in a[tree].items():
            if isinstance(value, dict):
                for leaf, tensor in value.items():
                    assert torch.equal(tensor, b[tree][name][leaf]), (tree, name, leaf)
            else:
                assert value == b[tree][name] if not isinstance(value, torch.Tensor) else torch.equal(
                    value, b[tree][name])


@pytest.mark.parametrize("argv", [
    ["--experiment", "mnist", "--mesh", "1,1,1", "--aggregator", "median", "--nb-workers", "2"],
    ["--experiment", "transformer", "--mesh", "2,1,1", "--aggregator", "median", "--nb-workers", "3"],
    ["--experiment", "transformer", "--mesh", "2,2", "--aggregator", "median", "--nb-workers", "2"],
    ["--experiment", "mnist", "--granularity", "layer", "--aggregator", "median", "--nb-workers", "2"],
    ["--experiment", "transformer", "--mesh", "1,1,1", "--aggregator", "median", "--nb-workers", "2",
     "--input-source", "device"],
    ["--experiment", "transformer", "--mesh", "1,1,1", "--aggregator", "median", "--nb-workers", "2",
     "--exchange", "int8"],
], ids=["no-hooks", "w-divides-n", "malformed", "layer-flat", "input-device", "codec"])
def test_mesh_refusals_match_the_jax_runner(argv):
    from aggregathor_tpu.cli import runner as jrunner
    from aggregathor_tpu.utils import UserException as JaxUserException

    argv = argv + ["--max-step", "1", "--evaluation-period", "-1"]
    with pytest.raises(JaxUserException):
        jrunner.main(argv)
    with pytest.raises(UserException):
        runner.main(argv + ["--device", "cpu"])
