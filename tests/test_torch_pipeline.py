"""The port's chunk input pipeline against the JAX package's, on the CPU.

Mirrors JAX ``tests/test_input_pipeline.py:67-264`` on the same inputs
(numpy draws from a seed):

- ``sharded_take`` with the pool forced (``AGGREGATHOR_GATHER_THREADS`` and
  a lowered ``_GATHER_POOL_MIN_ROWS``) is the fancy index, bit for bit, as
  the JAX one is;
- ``next_many(k, out=)`` is bit-identical to sequential ``next`` and to the
  JAX iterator's ``next_many(k, out=)``, a stateful transform keeping the
  sequential path; ``alloc_chunk`` has the JAX buffers' shapes and dtypes;
- ``split_chunk`` cuts where the JAX one does over a grid of (K, S);
- ``ChunkPipeline``: the stream is the sequential one with every chunk held
  (the ping-pong buffers reused under it), it hands the iterator back after
  exhaustion, closes mid-stream and restarts, surfaces a producer error,
  exports the ``input_*`` family; ``assemble_batches`` equals one
  monolithic ``put_batches``;
- the runner: ``--unroll 4 --prefetch 2 --input-slices 3`` on ``digits``
  goes through the pipeline and gives the per-step losses of ``--prefetch
  0`` bit for bit, and the JAX runner's from the same weights within the
  runner parity tolerance (rtol 1e-4, ``test_torch_digits.py``); its
  ``--metrics-file`` holds the JAX runner's families but those of
  ``WAITING``; the span trace, the live exporter and ``--trace`` (three
  steps after the first chunk) work there.
"""

import json
import os
import threading
import urllib.request

import jax
import numpy as np
import pytest
import torch

from aggregathor_tpu import models as jmodels
from aggregathor_tpu.cli import runner as jrunner
from aggregathor_tpu.models import datasets as jdatasets
from aggregathor_tpu.models.preprocessing import instantiate as jax_preprocessing
from aggregathor_tpu.obs import metrics as jmetrics
from aggregathor_tpu.parallel import RobustEngine as JaxEngine
from aggregathor_tpu_torch import gars
from aggregathor_tpu_torch import models as tmodels
from aggregathor_tpu_torch.cli import runner
from aggregathor_tpu_torch.models import datasets
from aggregathor_tpu_torch.models.common import params_from_jax
from aggregathor_tpu_torch.models.datasets import (
    ChunkPipeline, WorkerBatchIterator, sharded_take, split_chunk)
from aggregathor_tpu_torch.models.preprocessing import instantiate as make_preprocessing
from aggregathor_tpu_torch.obs import live, metrics, trace
from aggregathor_tpu_torch.parallel import RobustEngine
from aggregathor_tpu_torch.utils import UserException


@pytest.fixture
def corpus(rng):
    x = rng.normal(size=(512, 8, 8, 1)).astype(np.float32)
    y = rng.integers(0, 10, size=512).astype(np.int32)
    return x, y


@pytest.fixture
def forced_pool(monkeypatch):
    """The sharded gather down the pool path at any size, in both packages,
    with fresh pools so the thread count is read again."""
    monkeypatch.setenv("AGGREGATHOR_GATHER_THREADS", "4")
    for module in (datasets, jdatasets):
        monkeypatch.setattr(module, "_GATHER_POOL_MIN_ROWS", 1)
        monkeypatch.setattr(module, "_gather_pool", None)
    yield
    datasets._gather_pool = jdatasets._gather_pool = None


def _engine(n=4):
    return RobustEngine(gars.instantiate("average", n, 0), n, device="cpu")


def _pipeline(iterator, unroll, nb_chunks, **kw):
    engine = _engine(iterator.nb_workers)
    return ChunkPipeline(iterator, unroll, nb_chunks, put=engine.put_batches, assemble=engine.assemble_batches,
                         device="cpu", **kw)


def _same_chunk(got, want):
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_array_equal(np.asarray(got[name]), np.asarray(want[name]))


# --------------------------------------------------------------------- #
# the sharded gather


def test_sharded_take_matches_fancy_index(corpus, forced_pool, rng):
    x, _ = corpus
    idx = rng.integers(0, x.shape[0], size=1000)
    ours, theirs = np.empty((1000,) + x.shape[1:], x.dtype), np.empty((1000,) + x.shape[1:], x.dtype)
    assert sharded_take(x, idx, ours) is ours
    jdatasets.sharded_take(x, idx, theirs)
    np.testing.assert_array_equal(ours, x[idx])
    np.testing.assert_array_equal(ours, theirs)
    assert datasets._gather_pool is not None  # the pool path ran


def test_gather_threads_reads_the_jax_variable(monkeypatch):
    for value in ("0", "1", "6"):
        monkeypatch.setenv("AGGREGATHOR_GATHER_THREADS", value)
        assert datasets.gather_threads() == jdatasets.gather_threads() == int(value)
    monkeypatch.delenv("AGGREGATHOR_GATHER_THREADS")
    assert datasets.gather_threads() == jdatasets.gather_threads()
    monkeypatch.setenv("AGGREGATHOR_GATHER_THREADS", "four")
    with pytest.raises(UserException):
        datasets.gather_threads()


def _scale(module):
    """A stateless transform (as the poisoning experiments' is), declared with
    ``module``'s ``stateless``."""
    return module.stateless(lambda bx, by: (bx * np.float32(-2.0), (by + 3) % 10))


@pytest.mark.parametrize("transform", [None, "stateless", "cifarnet"])
def test_next_many_out_is_sequential_next_and_the_jax_chunk(corpus, forced_pool, transform):
    x, y = corpus
    if transform == "stateless":
        from aggregathor_tpu.models import preprocessing as jpre
        from aggregathor_tpu_torch.models import preprocessing as tpre

        ours_t, theirs_t, seq_t = _scale(tpre), _scale(jpre), _scale(tpre)
    elif transform == "cifarnet":  # stateful: per-worker augmentation streams
        ours_t, theirs_t, seq_t = (make_preprocessing("cifarnet", seed=3), jax_preprocessing("cifarnet", seed=3),
                                   make_preprocessing("cifarnet", seed=3))
    else:
        ours_t = theirs_t = seq_t = None
    a = WorkerBatchIterator(x, y, 4, 16, seed=5, transform=ours_t)
    b = jdatasets.WorkerBatchIterator(x, y, 4, 16, seed=5, transform=theirs_t)
    c = WorkerBatchIterator(x, y, 4, 16, seed=5, transform=seq_t)
    buf = a.alloc_chunk(6)
    for _ in range(2):  # the second fill refills the same buffer with the next chunk
        out = a.next_many(6, out=buf)
        assert out is buf
        _same_chunk(out, b.next_many(6, out=b.alloc_chunk(6)))
        for step in range(6):
            ref = next(c)
            _same_chunk({name: out[name][step] for name in ref}, ref)
    _same_chunk(next(a), next(c))  # the streams advanced alike


def test_alloc_chunk_matches_jax(corpus):
    x, y = corpus
    ours = WorkerBatchIterator(x, y, 4, 16).alloc_chunk(5)
    theirs = jdatasets.WorkerBatchIterator(x, y, 4, 16).alloc_chunk(5)
    assert {k: (v.shape, v.dtype) for k, v in ours.items()} == {k: (v.shape, v.dtype) for k, v in theirs.items()}


def test_split_chunk_boundaries_match_jax(corpus):
    x, y = corpus
    for k in (1, 2, 3, 4, 5, 7, 10, 16):
        chunk = WorkerBatchIterator(x, y, 2, 4, seed=1).next_many(k)
        for slices in (1, 2, 3, 4, 5, 8, 99):
            ours, theirs = split_chunk(chunk, slices), jdatasets.split_chunk(chunk, slices)
            assert [p["image"].shape for p in ours] == [p["image"].shape for p in theirs], (k, slices)
            np.testing.assert_array_equal(np.concatenate([p["label"] for p in ours]), chunk["label"])
            assert all(p["image"].base is not None for p in ours)  # views, not copies


# --------------------------------------------------------------------- #
# the pipeline


def test_pipeline_stream_is_bit_identical_with_every_chunk_held(corpus, forced_pool):
    x, y = corpus
    pipe = _pipeline(WorkerBatchIterator(x, y, 4, 16, seed=9), unroll=5, nb_chunks=6, depth=2, slices=3)
    ref = WorkerBatchIterator(x, y, 4, 16, seed=9)
    try:
        held = [next(pipe) for _ in range(6)]  # more than two buffers: each is refilled under a held chunk
        for chunk in held:
            assert chunk["image"].shape == (5, 4, 16, 8, 8, 1)
            _same_chunk(chunk, ref.next_many(5))
    finally:
        pipe.close()


def test_pipeline_exhaustion_hands_iterator_back(corpus):
    x, y = corpus
    it = WorkerBatchIterator(x, y, 4, 16, seed=11)
    ref = WorkerBatchIterator(x, y, 4, 16, seed=11)
    pipe = _pipeline(it, unroll=4, nb_chunks=3, depth=2, slices=2)
    for _ in range(3):
        next(pipe)
    for _ in range(2):  # terminal, and stays so
        with pytest.raises(StopIteration):
            next(pipe)
    pipe.close()
    assert not pipe._thread.is_alive()
    ref.skip(12)
    _same_chunk(next(it), next(ref))


def test_pipeline_close_midstream_then_restart(corpus):
    x, y = corpus
    before = threading.active_count()
    pipe = _pipeline(WorkerBatchIterator(x, y, 4, 16, seed=13), unroll=4, nb_chunks=50, depth=2, slices=2)
    next(pipe)
    pipe.close()
    pipe.close()  # idempotent
    assert not pipe._thread.is_alive()
    pipe2 = _pipeline(WorkerBatchIterator(x, y, 4, 16, seed=14), unroll=4, nb_chunks=2, depth=2, slices=2)
    try:
        _same_chunk(next(pipe2), WorkerBatchIterator(x, y, 4, 16, seed=14).next_many(4))
    finally:
        pipe2.close()
    assert threading.active_count() <= before + 1


def test_pipeline_surfaces_producer_error(corpus):
    x, y = corpus

    class Boom(WorkerBatchIterator):
        def next_many(self, k, out=None):
            raise RuntimeError("gather exploded")

    pipe = _pipeline(Boom(x, y, 4, 16, seed=1), 4, 3)
    with pytest.raises(RuntimeError, match="gather exploded"):
        next(pipe)
    with pytest.raises(RuntimeError, match="gather exploded"):  # terminal
        next(pipe)
    pipe.close()


def test_pipeline_exports_overlap_metrics(corpus):
    x, y = corpus
    registry = metrics.MetricsRegistry()
    pipe = _pipeline(WorkerBatchIterator(x, y, 4, 16, seed=21), unroll=4, nb_chunks=3, depth=2, slices=2,
                     registry=registry)
    try:
        for _ in range(3):
            next(pipe)
    finally:
        pipe.close()
    snap = registry.snapshot()
    assert snap["input_chunks_total"] == 3.0
    assert snap["input_gather_seconds_total"] > 0.0 and snap["input_put_seconds_total"] > 0.0
    assert 0.0 <= snap["input_overlap_fraction"] <= 1.0
    assert snap["input_queue_depth"] == 0.0
    assert pipe.wait_seconds == pytest.approx(snap["input_wait_seconds_total"])


def test_assemble_batches_matches_monolithic_put(corpus):
    x, y = corpus
    engine = _engine()
    chunk = WorkerBatchIterator(x, y, 4, 16, seed=17).next_many(8)
    whole = engine.put_batches(chunk)
    joined = engine.assemble_batches([engine.put_batches(part) for part in split_chunk(chunk, 3)])
    for name in whole:
        assert torch.equal(joined[name], whole[name])
    before = joined["image"].clone()
    chunk["image"][...] = 0.0  # a fresh buffer: refilling the host chunk leaves it alone
    assert torch.equal(joined["image"], before) and float(before.abs().sum()) > 0
    with pytest.raises(UserException):  # a slice still leads with the workers
        engine.put_batches({"image": chunk["image"][:, :3]})


# --------------------------------------------------------------------- #
# the runner

EXP_ARGS = ["hidden:16", "batch-size:8"]
BASE = ["--experiment", "digits", "--experiment-args", *EXP_ARGS, "--aggregator", "krum", "--nb-workers", "8",
        "--nb-decl-byz-workers", "2", "--unroll", "4", "--input-slices", "3",
        "--learning-rate-args", "initial-rate:0.1", "--gar-probe", "--summary-delta", "4",
        "--evaluation-period", "-1", "--summary-period", "-1", "--checkpoint-period", "-1"]
ARGV = BASE + ["--max-step", "12"]

#: the JAX runner's families the port's --metrics-file lacks, each with the
#: module it waits for
WAITING = {
    "compile_backend_total": "obs/profiler (--xprof, the compile listener)",
    "compile_backend_seconds_total": "obs/profiler (the compile listener)",
    "compile_cache_misses_total": "obs/profiler (CompileWatch)",
    "device_memory_live_bytes": "obs/profiler (the memory gauges)",
    "device_memory_peak_bytes": "obs/profiler (the memory gauges)",
}


def _record_losses(monkeypatch, engine_class, into):
    """Wrap ``engine_class.build_multi_step`` so every call's per-step
    losses land in ``into``."""
    build = engine_class.build_multi_step

    def wrapped(self, *args, **kwargs):
        multi = build(self, *args, **kwargs)

        def call(state, batches):
            state, many = multi(state, batches)
            into.extend(float(v) for v in np.asarray(many["total_loss"]))
            return state, many

        return call

    monkeypatch.setattr(engine_class, "build_multi_step", wrapped)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX runner, then the port's runner pipelined and synchronous, from
    the same flax weights, each process-wide registry fresh."""
    out = tmp_path_factory.mktemp("runs")
    losses = {"jax": [], "pipelined": [], "sync": []}
    results = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmetrics, "REGISTRY", jmetrics.MetricsRegistry())
        mp.setattr(metrics, "REGISTRY", metrics.MetricsRegistry())
        jexp = jmodels.instantiate("digits", EXP_ARGS)
        mp.setattr(tmodels.digits.DigitsExperiment, "init", lambda self, seed: params_from_jax(
            jax.tree_util.tree_map(np.asarray, jexp.init(jax.random.PRNGKey(seed)))))
        _record_losses(mp, JaxEngine, losses["jax"])
        # on one device, as the port runs (the JAX probe on the 8-device
        # virtual mesh is a known red: test_gar_scaling.py's sharded probe)
        jrunner.main(ARGV + ["--nb-devices", "1", "--metrics-file", str(out / "jax.prom")])
        for label, extra in (("pipelined", ["--prefetch", "2"]), ("sync", ["--prefetch", "0"])):
            with pytest.MonkeyPatch.context() as inner:
                _record_losses(inner, RobustEngine, losses[label])
                results[label] = runner.main(ARGV + extra + ["--device", "cpu",
                                                             "--metrics-file", str(out / ("%s.prom" % label))])
    return losses, results, out


def test_pipelined_runner_losses_are_the_synchronous_ones_and_follow_jax(runs):
    losses, results, _ = runs
    assert results["pipelined"]["input_pipeline"] == "ChunkPipeline"
    assert results["sync"]["input_pipeline"] is None
    assert len(losses["pipelined"]) == len(losses["sync"]) == len(losses["jax"]) == 12
    assert losses["pipelined"] == losses["sync"]  # bit for bit
    np.testing.assert_allclose(losses["pipelined"], losses["jax"], rtol=1e-4)
    assert results["pipelined"]["gar_probe_calls"] == 1 + 3  # the warm-up, then a fire a chunk


def test_metrics_file_families_are_the_jax_runners(runs):
    _, _, out = runs
    theirs = jmetrics.parse_prometheus(open(out / "jax.prom").read())
    ours = metrics.parse_prometheus(open(out / "pipelined.prom").read())
    assert set(ours) == set(theirs) - set(WAITING)
    assert set(WAITING) <= set(theirs)
    for name in ours:
        assert ours[name]["type"] == theirs[name]["type"], name
    values = {name: family["samples"][0][2] for name, family in ours.items()
              if family["samples"] and family["type"] != "histogram"}
    assert values["gar_probe_seconds"] > 0 and values["input_chunks_total"] == 3.0
    assert values["train_steps_total"] == 12.0 and values["bytes_on_wire_total"] == 12 * 8 * 4 * 1210
    for name in ("guardian_rollbacks_total", "guardian_escalations_total", "guardian_recoveries_total"):
        assert values[name] == theirs[name]["samples"][0][2] == 0.0, name  # registered unconditionally


NEW_FLAGS = ("input_slices", "gar_probe", "metrics_file", "trace", "trace_dir", "trace_file", "live_port",
             "live_host", "live_ready_file", "run_id")


def test_plane_flags_take_the_jax_defaults():
    argv = ["--experiment", "digits", "--aggregator", "krum", "--nb-workers", "8"]
    ours, theirs = runner.build_parser().parse_args(argv), jrunner.build_parser().parse_args(argv)
    actions = {a.dest: a for a in runner.build_parser()._actions}
    jax_actions = {a.dest: a for a in jrunner.build_parser()._actions}
    for flag in NEW_FLAGS:
        assert getattr(ours, flag) == getattr(theirs, flag), flag
        assert (actions[flag].type, actions[flag].choices, actions[flag].nargs) == (
            jax_actions[flag].type, jax_actions[flag].choices, jax_actions[flag].nargs), flag
    with pytest.raises(UserException):
        runner.main(argv + ["--live-ready-file", "x", "--device", "cpu"])
    with pytest.raises(SystemExit):  # the profiler window of obs/profiler is not ported
        runner.build_parser().parse_args(argv + ["--xprof", "2:4"])


def test_runner_plane_end_to_end(tmp_path, monkeypatch, capsys):
    """Span trace, live exporter (scraped as the run ends, while it still
    serves), summaries stamped with --run-id and a --trace profile."""
    scraped = {}
    shutdown = live.LiveExporter.shutdown_all

    def scrape_then_shut(self):
        host, port = self.server_address[:2]
        base = "http://%s:%d" % (host, port)
        for path in ("/healthz", "/status", "/metrics"):
            scraped[path] = urllib.request.urlopen(base + path, timeout=10).read().decode()
        shutdown(self)

    monkeypatch.setattr(live.LiveExporter, "shutdown_all", scrape_then_shut)
    ready = tmp_path / "ready"
    result = runner.main(BASE + [
        "--max-step", "12", "--device", "cpu", "--run-id", "plane-1", "--trace-file", str(tmp_path / "t.json"),
        "--live-port", "0", "--live-ready-file", str(ready), "--summary-dir", str(tmp_path / "s"),
        "--flight", "8", "--checkpoint-dir", str(tmp_path / "ck"), "--checkpoint-delta", "8",
        "--evaluation-delta", "8"])
    assert result["run_id"] == "plane-1" and trace.installed() is None
    host, port = ready.read_text().split()
    assert json.loads(scraped["/healthz"]) == {"status": "ok", "run_id": "plane-1"}
    status = json.loads(scraped["/status"])
    assert status["step"] == 12 and status["flight"]["rows"] == 8 and status["slo"] is None
    assert "train_loss" in metrics.parse_prometheus(scraped["/metrics"])
    payload = json.load(open(tmp_path / "t.json"))
    names = {e["name"] for e in trace.validate_chrome_trace(payload)}
    assert {"host_gap", "input", "input.gather", "input.put", "block.loss_fetch", "eval", "summaries",
            "flight.fetch", "gar.probe_build", "gar.aggregate", "checkpoint.fetch", "checkpoint.write"} <= names
    assert payload["otherData"]["run_id"] == "plane-1"
    [summary] = os.listdir(tmp_path / "s")
    lines = [json.loads(line) for line in open(tmp_path / "s" / summary)]
    assert all(line["run_id"] == "plane-1" for line in lines) and "gar_seconds" in lines[-1]
    profiled = runner.main(BASE + ["--max-step", "8", "--device", "cpu", "--trace", "--trace-dir",
                                        str(tmp_path / "prof"), "--run-id", "prof-1"])
    assert profiled["input_pipeline"] is None  # --trace keeps the synchronous chunk path, as in JAX
    assert "Profiler trace of steps 5-7 written" in capsys.readouterr().out  # three steps after the first chunk
    events = json.load(open(tmp_path / "prof" / "prof-1.pt.trace.json"))["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
