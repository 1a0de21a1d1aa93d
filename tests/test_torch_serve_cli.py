"""The port's serve CLI, custody and hot swap, and the replica campaign.

- ``cli/serve.py``'s options are the JAX CLI's, ``--device`` in place of
  ``--platform``;
- the counterpart of JAX's ``test_secure.py::test_serve_custody_and_hot_swap``
  on a checkpoint that the port's ``Checkpoints`` signs;
- ``load_replicas``: poison specs, stale replicas, refusals;
- the CLI end to end in a subprocess on the CPU: train with ``--secure``,
  serve three replicas (one NaN) with a ready file and a journal, a SIGHUP
  reload to a newer step, a SIGTERM drain;
- without a GPU and without ``--device cpu`` the CLI raises;
- the counterpart of JAX's ``test_replica_campaign_matrix_and_verdicts``
  with the same arguments and verdicts.
"""

import json
import os
import signal
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest
import torch

from aggregathor_tpu_torch import models
from aggregathor_tpu_torch.cli import runner
from aggregathor_tpu_torch.cli import serve as serve_cli
from aggregathor_tpu_torch.utils import UserException
from serve_parity import two_threads  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("two_threads")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN = ["--experiment", "digits", "--aggregator", "average", "--nb-workers", "4", "--checkpoint-delta", "10",
         "--checkpoint-period", "-1", "--evaluation-delta", "-1", "--evaluation-period", "-1", "--prefetch", "0",
         "--device", "cpu"]


def _options(parser):
    return {s for action in parser._actions for s in action.option_strings}


def test_the_serve_cli_gap_is_platform_for_device():
    from aggregathor_tpu.cli import serve as jax_serve_cli

    ours, theirs = _options(serve_cli.build_parser()), _options(jax_serve_cli.build_parser())
    assert theirs - ours == {"--platform"}
    assert ours - theirs == {"--device"}
    assert serve_cli.build_parser().get_default("device") == "cuda"
    for name in ("max_batch", "lanes", "queue_bound", "gar", "follow_interval", "request_timeout", "drain_timeout"):
        assert serve_cli.build_parser().get_default(name) == jax_serve_cli.build_parser().get_default(name), name


def test_serve_custody_and_hot_swap(tmp_path):
    """train -> sign -> serve: load_replicas verifies the manifests under
    --session-secret, /healthz carries the verdict, swap_replicas hot-swaps
    with compile_count unchanged, a topology change refuses, and an unsigned
    checkpoint needs --allow-unsigned."""
    from aggregathor_tpu_torch.core import TrainState, build_optimizer, build_schedule
    from aggregathor_tpu_torch.obs.checkpoint import Checkpoints
    from aggregathor_tpu_torch.obs.metrics import MetricsRegistry
    from aggregathor_tpu_torch.parallel.auth import GradientAuthenticator
    from aggregathor_tpu_torch.secure import ChainOfCustody, manifest_path
    from aggregathor_tpu_torch.serve import InferenceEngine, InferenceServer

    experiment = models.instantiate("digits", ["batch-size:16"])
    tx = build_optimizer("sgd", build_schedule("fixed", ["initial-rate:0.01"]))
    params = experiment.init(0)
    state = TrainState(params=params, opt_state=tx.init(params), step=0, seed=0)
    auth = GradientAuthenticator(b"s3", 1, context=b"ckpt")
    custody = ChainOfCustody(b"s3", run_id="r", experiment="digits")
    Checkpoints(str(tmp_path), authenticator=auth, custody=custody).save(state, step=5)

    argv = ["--experiment", "digits", "--experiment-args", "batch-size:16", "--ckpt-dir", str(tmp_path),
            "--replicas", "2", "--gar", "median", "--session-secret", "s3", "--max-batch", "4", "--device", "cpu"]
    args = serve_cli.build_parser().parse_args(argv)
    replicas, sources, verified, served_step = serve_cli.load_replicas(args, experiment)
    assert verified is True and len(replicas) == 2 and served_step == 5
    assert all(torch.equal(replicas[0][k], params[k]) for k in params)

    engine = InferenceEngine(experiment, replicas, max_batch=4, device="cpu")
    compiles = engine.warmup()
    server = InferenceServer(engine, port=0, custody_verified=verified, registry=MetricsRegistry())
    server.serve_background()
    try:
        assert server.health_payload()["custody_verified"] is True
        engine.swap_replicas(replicas)
        assert engine.compile_count == compiles
        server.set_custody_verified(False)
        assert server.health_payload()["custody_verified"] is False
        with pytest.raises(UserException):
            engine.swap_replicas(replicas[:1])
    finally:
        server.shutdown_all()

    os.remove(manifest_path(os.path.join(str(tmp_path), "model-5.ckpt")))
    with pytest.raises(UserException, match="custody manifest"):
        serve_cli.load_replicas(args, experiment)
    args = serve_cli.build_parser().parse_args(argv + ["--allow-unsigned"])
    assert serve_cli.load_replicas(args, experiment)[2] is False
    # a wrong secret is refused at the tag
    args = serve_cli.build_parser().parse_args(argv[:-4] + ["--session-secret", "wrong", "--device", "cpu"])
    with pytest.raises(UserException):
        serve_cli.load_replicas(args, experiment)


def test_load_replicas_poisons_and_stales_as_jax_does(tmp_path):
    from aggregathor_tpu_torch.chaos.replica_faults import corrupt_params

    ckpt = str(tmp_path / "ck")
    runner.main(TRAIN + ["--max-step", "20", "--checkpoint-dir", ckpt])
    experiment = models.instantiate("digits", [])
    base = ["--experiment", "digits", "--ckpt-dir", ckpt, "--device", "cpu"]
    args = serve_cli.build_parser().parse_args(base + ["--replicas", "4", "--poison-replica", "1:nan",
                                                       "--poison-replica", "2:noise=0.5", "--poison-replica",
                                                       "3:stale"])
    replicas, sources, verified, served_step = serve_cli.load_replicas(args, experiment)
    from aggregathor_tpu_torch.obs.checkpoint import Checkpoints

    oldest = Checkpoints(ckpt).steps()[0]  # the checkpoint cadence fires at its first check
    assert verified is None and served_step == 20 and oldest < 20
    assert sources == ["%s@20" % ckpt, "%s@20 (poisoned: nan)" % ckpt, "%s@20 (poisoned: noise)" % ckpt,
                       "%s@%d (stale)" % (ckpt, oldest)]
    clean = replicas[0]
    noisy = corrupt_params(clean, "noise", 0.5, seed=0 + 31 * 2)
    assert all(torch.equal(replicas[2][k], noisy[k]) for k in clean)
    assert all(torch.isnan(v).all() for v in replicas[1].values())
    assert not all(torch.equal(replicas[3][k], clean[k]) for k in clean)
    for bad in (["--replicas", "2", "--poison-replica", "2:nan"],
                ["--replicas", "2", "--poison-replica", "1:nan", "--poison-replica", "1:zero"],
                ["--replicas", "0"]):
        with pytest.raises(UserException):
            serve_cli.load_replicas(serve_cli.build_parser().parse_args(base + bad), experiment)
    with pytest.raises(UserException):  # a pinned step that is not on disk
        serve_cli.load_replicas(serve_cli.build_parser().parse_args(base + ["--ckpt-step", "15"]), experiment)


def test_serve_refuses_the_cpu_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    with pytest.raises(UserException, match="CUDA"):
        serve_cli.main(["--experiment", "digits", "--ckpt-dir", "/nonexistent"])


def _wait_for(predicate, timeout=60.0, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        value = predicate()
        if value:
            return value
        time.sleep(0.05)
    raise AssertionError("timed out waiting for %s" % what)


def _get(base, path):
    with urllib.request.urlopen(base + path, timeout=30) as response:
        return json.loads(response.read())


def _predict(base, rows):
    request = urllib.request.Request(base + "/predict", data=json.dumps({"inputs": rows.tolist()}).encode())
    with urllib.request.urlopen(request, timeout=30) as response:
        return json.loads(response.read())


def test_serve_cli_end_to_end_with_a_reload_and_a_drain(tmp_path):
    """Train digits with --secure, serve three replicas (replica 1 NaN)
    under custody from a subprocess: the ready file appears after the
    warmup, the vote equals the clean replica's predictions, /healthz
    reports custody verified, SIGHUP reloads a newer step without a failed
    request, SIGTERM drains and exits 0, and the journal holds
    run_start, serve_weight_swap, serve_drain and run_end."""
    from aggregathor_tpu_torch.serve import InferenceEngine

    ckpt, ready, journal = str(tmp_path / "ck"), str(tmp_path / "ready"), str(tmp_path / "serve.jsonl")
    secure = ["--secure", "--session-secret", "s"]
    runner.main(TRAIN + ["--max-step", "10", "--checkpoint-dir", ckpt] + secure)
    log = open(str(tmp_path / "serve.log"), "w")
    child = subprocess.Popen(
        [sys.executable, "-m", "aggregathor_tpu_torch.cli.serve", "--experiment", "digits", "--ckpt-dir", ckpt,
         "--replicas", "3", "--gar", "median", "--poison-replica", "1:nan", "--port", "0", "--ready-file", ready,
         "--max-batch", "8", "--journal", journal, "--device", "cpu", "--session-secret", "s"],
        cwd=REPO, stdout=log, stderr=subprocess.STDOUT, env=dict(os.environ, OMP_NUM_THREADS="2"))
    try:
        _wait_for(lambda: os.path.exists(ready) or child.poll() is not None, what="the ready file")
        assert child.poll() is None, open(str(tmp_path / "serve.log")).read()
        host, port, pid = open(ready).read().split()
        assert int(pid) == child.pid
        base = "http://%s:%s" % (host, port)
        health = _get(base, "/healthz")
        assert health["custody_verified"] is True and health["weights_step"] == 10
        experiment = models.instantiate("digits", [])
        x = np.asarray(experiment.dataset.x_test[:8], np.float32).reshape(8, -1)
        out = _predict(base, x)
        args = serve_cli.build_parser().parse_args(["--experiment", "digits", "--ckpt-dir", ckpt, "--device", "cpu",
                                                    "--session-secret", "s"])
        clean = serve_cli.load_replicas(args, experiment)[0][0]
        want = InferenceEngine(experiment, [clean], max_batch=8, device="cpu").predict(x.reshape(8, 8, 8, 1))
        assert out["predictions"] == want["predictions"].tolist()
        assert out["disagreement"][1] is None and out["weights_step"] == 10
        # a newer step lands; SIGHUP swaps it in while requests keep flowing
        runner.main(TRAIN + ["--max-step", "20", "--checkpoint-dir", ckpt] + secure)
        child.send_signal(signal.SIGHUP)
        steps = []
        for _ in range(400):
            steps.append(_predict(base, x[:3])["weights_step"])
            if steps[-1] == 20:
                break
            time.sleep(0.05)
        assert steps[-1] == 20 and steps == sorted(steps), steps
        assert _get(base, "/status")["weights_step"] == 20
        # the vote ran on the CPU (no kernel launched) and nothing was built,
        # as chip_smoke.py's serve phase reads them on the card
        from chip_smoke import _serve_metrics

        metrics = _serve_metrics(base)
        assert metrics[("serve_kernel_builds", None)] == 0
        assert metrics[("serve_kernel_launches", "coordinate_median")] == 0
        child.send_signal(signal.SIGTERM)
        assert child.wait(60) == 0
    finally:
        if child.poll() is None:
            child.kill()
            child.wait(10)
        log.close()
    kinds = [json.loads(line)["type"] for line in open(journal)]
    assert kinds[0] == "run_start" and kinds[-1] == "run_end"
    assert "serve_weight_swap" in kinds and kinds.count("serve_drain") == 2


def test_replica_campaign_matrix_and_verdicts(tmp_path):
    """The JAX campaign test's arguments and verdicts: median masks a NaN
    replica at the clean bar, average does not, the faulty replica is named,
    the 64 rows coalesce, the v2 schema round-trips."""
    from aggregathor_tpu_torch.serve import campaign

    args = campaign.build_parser().parse_args([
        "--experiment", "digits", "--experiment-args", "batch-size:16", "--train-steps", "25", "--eval-rows", "64",
        "--replicas", "3", "--gars", "median", "average", "--faults", "nan", "--device", "cpu",
    ])
    matrix = campaign.run_campaign(args)
    path = str(tmp_path / "matrix.json")
    with open(path, "w") as fd:
        json.dump(matrix, fd)
    assert campaign.load(path)["schema"] == campaign.SCHEMA == "aggregathor.serve.replica-matrix.v2"
    for cell in matrix["cells"]:
        assert all(key in cell for key in campaign.CELL_KEYS)
        assert cell["compile_count"] <= cell["nb_buckets"] and cell["batches"] >= 1
    by = {(c["gar"], c["fault"]): c for c in matrix["cells"]}
    assert by[("median", "nan")]["masked"] and by[("median", "clean")]["masked"]
    assert not by[("average", "nan")]["masked"]
    assert by[("median", "nan")]["suspects"] == [2]
    assert by[("median", "clean")]["batches"] <= 4
    campaign.write_report(matrix, str(tmp_path / "report.md"))
    assert "MASKED" in open(str(tmp_path / "report.md")).read()
    bad = json.loads(json.dumps(matrix))
    del bad["cells"][0]["batches"]
    with pytest.raises(ValueError):
        campaign.validate(bad)
