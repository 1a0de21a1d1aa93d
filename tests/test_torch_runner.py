"""The port's runner, device policy and package boundary.

- ``--device cpu`` trains a few steps end to end and prints steps/s
  (excluding the first step), the final evaluation and the launch counts;
- ``--UDP`` runs: ``average-nan`` ends with a finite loss, plain
  ``average`` stops with the divergence error (NaN reaches the
  parameters), CLEVER infill keeps ``average`` finite;
- without ``--device cpu`` and without a GPU the runner fails loudly
  instead of falling back to the CPU;
- the port imports nothing of JAX, flax, optax or the JAX package (AST
  scan of every module, of ``chip_smoke.py`` and of the GPU tests, which
  run on a machine without JAX).
"""

import ast
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
    assert [row.split("\t")[1] for row in rows] == ["3", "6"]


@pytest.mark.parametrize("rule", ["median", "bulyan", "trimmed-mean", "averaged-median", "average"])
def test_cpu_run_every_rule(rule):
    f = ["--nb-decl-byz-workers", "1"] if rule == "bulyan" else []  # bulyan: n >= 4f + 3
    result = runner.main(MNIST + f + ["--aggregator", rule, "--max-step", "2", "--device", "cpu"])
    assert result["steps"] == 2 and result["evaluation"] is not None


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


def _imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    paths = [os.path.join(REPO, "chip_smoke.py"), os.path.join(REPO, "tests", "test_torch_gpu.py")]
    for root, _, files in os.walk(os.path.join(REPO, "aggregathor_tpu_torch")):
        paths += [os.path.join(root, name) for name in files if name.endswith(".py")]
    assert len(paths) > 20
    offenders = [
        (os.path.relpath(path, REPO), module)
        for path in paths for module in _imports(path)
        if module.split(".")[0] in FORBIDDEN
    ]
    assert offenders == []
