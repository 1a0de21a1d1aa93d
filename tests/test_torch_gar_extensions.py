"""The port's GAR extensions against the JAX package's rules, on the same
numpy inputs (the port on the CPU, i.e. through its kernels' plain
versions; the JAX package through its jnp tier).

- the registries hold the same 31 names;
- centered-clip, geometric-median/rfa and the hier and tree specs (inner
  and outer rules of every kind, the bf16 link) aggregate poisoned rows
  (a dead row, a row with +-inf coordinates, two loud attackers) as the
  JAX rule does: the same NaN pattern, aggregates within rtol/atol 1e-5
  (float32 sums and norms in another order), the participation within
  1e-5 and its support identical;
- bucketing, plain, ragged and nested over hier, with JAX's permutation
  injected (trap c: torch cannot draw Threefry's), and the port's own
  key: a permutation of an int seed, the identity without one;
- hier's transposed inner pass is the per-group loop bit for bit, and
  ``tree:g=2x2,rules=median>median>average-nan`` is the nested hier bit for
  bit (as JAX ``tests/test_topology.py:117-130`` requires);
- ``TREE_ARG_DEFAULTS`` equals ``TreeGAR.ARG_DEFAULTS``; ``link=int8`` and
  ``topk(...)`` links aggregate as JAX's do (each level's summaries through
  the codec's round trip) with JAX's link bytes; the spec checks refuse
  what JAX's refuse (a link with error feedback among them);
- dnc where a colluding signal makes its selection decisive (JAX
  ``tests/test_gars.py:377-420``): the JAX aggregate within rtol 1e-4 /
  atol 1e-5, the same rows dropped;
- the runner: 3 steps of centered-clip, rfa, dnc, hier and tree on mnist
  give the JAX runner's losses (``--nb-devices 1``) within rtol 1e-4; a
  bucketing run repeats its bits and a resumed one ends with the bits of
  the uninterrupted one; the engine's GAR key follows (seed, step);
- SIGTERM: the port's runner and the JAX runner, each in a subprocess
  signalled at the same step, stop at that step and leave the same
  checkpoints, evaluation rows, journal end and metrics file.
"""

import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from aggregathor_tpu import gars as jgars
from aggregathor_tpu.utils import UserException as JaxUserException
from aggregathor_tpu_torch import gars as tgars
from aggregathor_tpu_torch.cli import runner
from aggregathor_tpu_torch.gars.hierarchical import group_pass
from aggregathor_tpu_torch.utils import UserException

from torch_threads import pinned_threads  # noqa: F401  (a fixture: the xdist worker's intra-op pool)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rows(n, d, seed):
    """Unit normals with a dead (NaN) row, a row with +-inf coordinates and
    two loud attackers."""
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(n, d)).astype(np.float32)
    g[0] *= -50.0
    g[1] += 40.0
    g[n // 2] = np.nan
    g[n - 1, 3::11] = np.inf
    g[n - 1, 5::13] = -np.inf
    return g


def _close(got, want, rtol=1e-5, atol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    finite = np.isfinite(want)
    np.testing.assert_allclose(got[finite], want[finite], rtol=rtol, atol=atol)


def _same_participation(got, want):
    if want is None:
        assert got is None
        return
    got, want = got.numpy(), np.asarray(want)
    np.testing.assert_array_equal(got > 0, want > 0)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got.sum(), 1.0, rtol=1e-5)


def test_registry_holds_the_jax_packages_31_names():
    assert sorted(tgars.itemize()) == sorted(jgars.itemize())
    assert len(tgars.itemize()) == 31
    assert tgars.GAR_KEY_TAG == jgars.GAR_KEY_TAG


#: (spec, n, f): every new rule and meta-rule form, with inner and outer
#: rules of each kind (coordinate-wise, selecting, iterative, NaN-tolerant)
SPECS = [
    ("centered-clip", 11, 2),
    ("centered-clip:tau=0.5,iters=5", 11, 2),
    ("geometric-median", 11, 2),
    ("rfa:iters=3", 11, 2),
    ("hier:g=4,inner=median,outer=krum", 32, 2),
    ("hier:g=4,inner=averaged-median,outer=krum", 32, 2),
    ("hier:g=4,inner=krum,outer=bulyan", 32, 1),
    ("hier:g=4,inner=centered-clip,outer=median", 16, 1),
    ("hier:g=2,inner=average,outer=average-nan", 8, 1),
    ("tree:g=4x2,rules=median>average-nan>krum", 32, 1),
    ("tree:g=4x2,rules=trimmed-mean>average-nan>krum", 32, 1),
    ("tree:g=2x2,rules=median>median>krum,link=bf16", 32, 1),
    ("tree:g=4x2,rules=krum>rfa>median", 32, 0),
]


@pytest.mark.parametrize("spec, n, f", SPECS, ids=[s for s, _, _ in SPECS])
def test_rule_matches_jax(spec, n, f):
    g = _rows(n, 96, n + f)
    jgar, tgar = jgars.instantiate(spec, n, f), tgars.instantiate(spec, n, f)
    assert tgar.nan_row_tolerant == jgar.nan_row_tolerant
    assert (tgar.uses_key, tgar.uses_axis) == (jgar.uses_key, jgar.uses_axis)
    x = torch.from_numpy(g)
    got = tgar.aggregate(x)
    assert got.dtype == torch.float32 and got.shape == (96,)
    _close(got.numpy(), jgar.aggregate(g))
    agg, part = tgar.aggregate_block_and_participation(x)
    jagg, jpart = jgar.aggregate_block_and_participation(g)
    _close(agg.numpy(), jagg)
    _same_participation(part, jpart)


def _jax_permutation(seed, n):
    import jax

    key = jax.random.PRNGKey(seed)
    return key, np.asarray(jax.random.permutation(key, n))


BUCKETING = [("bucketing:s=2,inner=krum", 16, 2), ("bucketing:s=3,inner=krum", 16, 2),
             ("bucketing:s=2,inner=hier(g=4,outer=krum)", 32, 1), ("bucketing:s=4,inner=median", 16, 1)]


@pytest.mark.parametrize("spec, n, f", BUCKETING, ids=[s for s, _, _ in BUCKETING])
def test_bucketing_matches_jax_with_its_permutation(spec, n, f, monkeypatch):
    from aggregathor_tpu_torch.gars import bucketing

    g = _rows(n, 64, n)
    key, perm = _jax_permutation(n, n)
    jgar, tgar = jgars.instantiate(spec, n, f), tgars.instantiate(spec, n, f)
    assert (tgar.nb_buckets, tgar.nb_padded, tgar.nan_row_tolerant) == (
        jgar.nb_buckets, jgar.nb_padded, jgar.nan_row_tolerant)
    x, tperm = torch.from_numpy(g), torch.from_numpy(perm.astype(np.int64))
    buckets, used = tgar._buckets(x, None, perm=tperm)
    jbuckets, _ = jgar._buckets(g, key)
    assert torch.equal(used, tperm)
    _close(buckets.numpy(), jbuckets, rtol=1e-6, atol=1e-6)
    # every draw of the step's key gives JAX's permutation
    monkeypatch.setattr(bucketing, "key_permutation", lambda key, n, device: tperm)
    _close(tgar.aggregate(x, key=1).numpy(), jgar.aggregate_block(g, key=key))
    agg, part = tgar.aggregate_block_and_participation(x, key=1)
    jagg, jpart = jgar.aggregate_block_and_participation(g, key=key)
    _close(agg.numpy(), jagg)
    _same_participation(part, jpart)


def test_bucketing_key_is_a_seed_and_none_is_the_identity():
    gar = tgars.instantiate("bucketing:s=2,inner=krum", 16, 2)
    x = torch.from_numpy(_rows(16, 32, 1))
    _, identity = gar._buckets(x, None)
    assert torch.equal(identity, torch.arange(16))
    _, a = gar._buckets(x, 7)
    _, b = gar._buckets(x, 7)
    _, c = gar._buckets(x, 8)
    want = torch.randperm(16, generator=torch.Generator("cpu").manual_seed(7))
    assert torch.equal(a, want) and torch.equal(a, b) and not torch.equal(a, c)
    buckets, _ = gar._buckets(x, None, perm=want)
    assert torch.equal(gar.aggregate(x, key=7), gar.inner.aggregate(buckets))
    # the JAX identity without a key: the same aggregate as JAX's keyless call
    _close(gar.aggregate(x).numpy(), jgars.instantiate("bucketing:s=2,inner=krum", 16, 2).aggregate(x.numpy()))


def test_bucketing_refusals_match_jax():
    for spec, n, f in (("bucketing:s=3,inner=median", 16, 1), ("bucketing:s=0", 8, 1),
                       ("bucketing:s=2,inner=krum", 8, 2)):
        with pytest.raises(JaxUserException):
            jgars.instantiate(spec, n, f)
        with pytest.raises(UserException):
            tgars.instantiate(spec, n, f)


@pytest.mark.parametrize("inner", ["median", "averaged-median", "trimmed-mean", "average", "average-nan"])
def test_hier_transposed_pass_is_the_group_loop_bit_for_bit(inner):
    g, nb_groups, d = 4, 8, 40
    x = torch.from_numpy(_rows(g * nb_groups, d, 3))
    rule = tgars.instantiate(inner, g, 1)
    summaries, part = group_pass(rule, x, g, None, True)
    loop = torch.stack([rule.aggregate(x[i * g:(i + 1) * g].contiguous()) for i in range(nb_groups)])
    assert torch.equal(summaries.view(torch.int32), loop.view(torch.int32))
    assert torch.equal(part, torch.full((nb_groups, g), 0.25))


def test_tree_is_the_nested_hier_bit_for_bit():
    x = torch.from_numpy(_rows(8, 50, 5))
    tree = tgars.instantiate("tree:g=2x2,rules=median>median>average-nan", 8, 1)
    hier = tgars.instantiate("hier:g=2,inner=median,outer=hier(g=2,inner=median,outer=average-nan)", 8, 1)
    a, b = tree.aggregate(x, key=3), hier.aggregate(x, key=3)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    _close(a.numpy(), jgars.instantiate("tree:g=2x2,rules=median>median>average-nan", 8, 1).aggregate(x.numpy()))


def test_tree_spec_matches_jax_and_refuses_the_codecs():
    from aggregathor_tpu.topology import spec as jspec
    from aggregathor_tpu_torch.gars.tree import TreeGAR
    from aggregathor_tpu_torch.topology import spec as tspec

    assert tspec.TREE_ARG_DEFAULTS == TreeGAR.ARG_DEFAULTS == jspec.TREE_ARG_DEFAULTS
    x = np.random.default_rng(5).normal(size=(32, 40)).astype(np.float32)
    for link in ("int8", "topk(k=4)"):
        spec = "tree:g=4x2,rules=median>median>krum,link=%s" % link
        tree, jtree = tgars.instantiate(spec, 32, 1), jgars.instantiate(spec, 32, 1)
        assert tree.spec.link_bytes_per_round(1000) == jtree.spec.link_bytes_per_round(1000)
        assert tree.spec.link_ratio(1000) == jtree.spec.link_ratio(1000)
        _close(tree.aggregate(torch.from_numpy(x), key=3).numpy(), jtree.aggregate(x))
    t, j = (module.parse_topology_spec("tree:g=4x2,rules=median>median>krum,agg-f=1", 64, 2)
            for module in (tspec, jspec))
    assert (t.group_sizes, t.nb_units, t.row_budgets, t.inner_fs, t.describe()) == (
        j.group_sizes, j.nb_units, j.row_budgets, j.inner_fs, j.describe())
    assert t.link_bytes_per_round(1000) == j.link_bytes_per_round(1000)
    bf16 = tgars.instantiate("tree:g=4x2,rules=median>median>krum,link=bf16", 32, 1)
    assert bf16.spec.link_dtype == torch.bfloat16 and bf16.spec.link_ratio(1000) == 2.0
    for spec, n, f in (("tree:g=4x4,rules=median>krum", 32, 1), ("tree:g=3,rules=median>krum", 32, 1),
                       ("tree:g=4,rules=median>krum,redundancy=9", 32, 1), ("tree:g=2,rules=median>krum", 8, 2),
                       ("tree:g=1,rules=median>median", 8, 1), ("tree:g=4,rules=median>krum,link=int8:ef", 32, 1)):
        with pytest.raises(JaxUserException):
            jgars.instantiate(spec, n, f)
        with pytest.raises(UserException):
            tgars.instantiate(spec, n, f)


def test_exchange_specs_match_jax():
    from aggregathor_tpu.parallel import compress as jcompress
    from aggregathor_tpu_torch.parallel import compress as tcompress

    for spec in ("f32", "float32", "bf16", "bfloat16", None):
        dtype, codec = tcompress.parse_exchange_spec(spec)
        jdtype, jcodec = jcompress.parse_exchange_spec(spec)
        assert codec is None and jcodec is None and (dtype is None) == (jdtype is None)
        assert tcompress.bytes_per_row(1000, dtype) == jcompress.bytes_per_row(1000, jdtype)
    for spec in ("int8", "int8:ef", "topk:k=4", "topk:frac=0.01,ef"):
        (dtype, codec), (jdtype, jcodec) = tcompress.parse_exchange_spec(spec), jcompress.parse_exchange_spec(spec)
        assert dtype is None and jdtype is None and codec.spec() == jcodec.spec() and codec.uses_ef == jcodec.uses_ef
        assert tcompress.bytes_per_row(1000, codec=codec) == jcompress.bytes_per_row(1000, codec=jcodec)
        assert tcompress.compression_ratio(1000, codec=codec) == jcompress.compression_ratio(1000, codec=jcodec)
    for spec in ("f32:ef", "banana"):
        with pytest.raises(UserException):
            tcompress.parse_exchange_spec(spec)


def test_dnc_under_a_colluding_signal_matches_jax():
    rng = np.random.default_rng(11)
    n, f = 12, 3
    g = rng.normal(size=(n, 257)).astype(np.float32)
    g[:f] += 50.0 * rng.normal(size=(1, 257)).astype(np.float32)  # a common direction
    g[5, 7] = np.nan
    for args in ([], ["remove:5"]):
        jgar, tgar = jgars.instantiate("dnc", n, f, args), tgars.instantiate("dnc", n, f, args)
        agg, part = tgar.aggregate_block_and_participation(torch.from_numpy(g))
        jagg, jpart = jgar.aggregate_block_and_participation(g)
        _close(agg.numpy(), jagg, rtol=1e-4, atol=1e-5)
        np.testing.assert_array_equal(part.numpy() > 0, np.asarray(jpart) > 0)
        np.testing.assert_allclose(part.numpy(), np.asarray(jpart), rtol=1e-6)
    assert float(part[:f].sum()) == 0.0 and float(part[5]) == 0.0
    # more dead rows than the budget keeps: nothing is averaged, as in JAX
    dead = g.copy()
    dead[:8] = np.nan
    _close(tgars.instantiate("dnc", n, f, ["remove:5"]).aggregate(torch.from_numpy(dead)).numpy(),
           jgars.instantiate("dnc", n, f, ["remove:5"]).aggregate(dead))


def test_iterative_rules_start_from_numpys_median():
    """An even count of live rows: the centre starts at numpy's midpoint
    (trap a), so one clipped step from it equals JAX's."""
    g = np.arange(24, dtype=np.float32).reshape(6, 4) ** 1.5
    g[2] = np.nan  # 5 live rows, then an even 4 with a second dead row
    g[4, 1] = np.inf
    for spec in ("centered-clip:iters=1,tau=100.0", "geometric-median:iters=1"):
        _close(tgars.instantiate(spec, 6, 1).aggregate(torch.from_numpy(g)).numpy(),
               jgars.instantiate(spec, 6, 1).aggregate(g), rtol=1e-6, atol=1e-6)


# --------------------------------------------------------------------- #
# the engine and the runner

def test_engine_gar_key_follows_seed_and_step():
    from aggregathor_tpu_torch.parallel import RobustEngine
    from aggregathor_tpu_torch.parallel.engine import gar_key
    from aggregathor_tpu_torch.utils import fold_in_seed

    assert gar_key(3, 5) == fold_in_seed(fold_in_seed(3, 5), tgars.GAR_KEY_TAG)
    assert len({gar_key(3, 5), gar_key(3, 6), gar_key(4, 5)}) == 3
    engine = RobustEngine(tgars.instantiate("bucketing:s=2,inner=krum", 8, 1), 8, device="cpu")
    probe = engine.build_gar_probe(40, seed=2)
    assert torch.equal(probe(9), engine.gar.aggregate(probe.rows, key=gar_key(2, 9)))
    assert not torch.equal(probe(9), probe(10))


EXP = ["--experiment", "mnist", "--experiment-args", "hidden:16", "batch-size:8", "--nb-workers", "8",
       "--nb-decl-byz-workers", "1", "--nb-real-byz-workers", "1", "--attack", "signflip",
       "--learning-rate-args", "initial-rate:0.05", "--evaluation-delta", "-1", "--evaluation-period", "-1",
       "--summary-delta", "1", "--summary-period", "-1", "--max-step", "3", "--prefetch", "0"]


def _losses(directory):
    events = [json.loads(line) for name in sorted(os.listdir(directory))
              for line in open(os.path.join(directory, name))]
    return {e["step"]: e["total_loss"] for e in events if "total_loss" in e}


@pytest.mark.parametrize("rule", ["centered-clip", "rfa", "dnc", "hier:g=2,inner=median,outer=krum",
                                  "tree:g=2x2,rules=median>median>average-nan"])
def test_runner_losses_match_the_jax_runner(rule, tmp_path, monkeypatch):
    import jax

    from aggregathor_tpu import models as jmodels
    from aggregathor_tpu.cli import runner as jrunner
    from aggregathor_tpu_torch.models import mnist
    from aggregathor_tpu_torch.models.common import params_from_jax

    # both runners from the JAX package's initial weights
    jexp = jmodels.instantiate("mnist", ["hidden:16", "batch-size:8"])
    monkeypatch.setattr(mnist.MNISTExperiment, "init", lambda self, seed: params_from_jax(
        jax.tree_util.tree_map(np.asarray, jexp.init(jax.random.PRNGKey(seed)))))
    jrunner.main(EXP + ["--aggregator", rule, "--summary-dir", str(tmp_path / "jax"), "--nb-devices", "1"])
    result = runner.main(EXP + ["--aggregator", rule, "--summary-dir", str(tmp_path / "port"), "--device", "cpu"])
    want, got = _losses(tmp_path / "jax"), _losses(tmp_path / "port")
    assert sorted(got) == sorted(want) == [1, 2, 3] and result["steps"] == 3
    np.testing.assert_allclose([got[k] for k in (1, 2, 3)], [want[k] for k in (1, 2, 3)], rtol=1e-4)


BUCKET_RUN = ["--experiment", "digits", "--experiment-args", "hidden:16", "batch-size:8", "--aggregator",
              "bucketing:s=2,inner=krum", "--nb-workers", "16", "--nb-decl-byz-workers", "2",
              "--nb-real-byz-workers", "2", "--attack", "signflip", "--evaluation-period", "-1",
              "--checkpoint-period", "-1", "--summary-period", "-1", "--worker-metrics", "--device", "cpu"]


def test_bucketing_run_repeats_and_resumes_bit_for_bit(tmp_path):
    def final(name, max_step, extra=()):
        directory = tmp_path / name
        runner.main(BUCKET_RUN + ["--max-step", str(max_step), "--checkpoint-dir", str(directory),
                                  "--checkpoint-delta", "3", *extra])
        return torch.load(os.path.join(directory, "model-%d.ckpt" % max_step), weights_only=True)

    a, b = final("a", 6), final("b", 6, ("--unroll", "3"))
    final("split", 3)
    resumed = final("split", 6)
    for other in (b, resumed):
        for name, value in a["params"].items():
            assert torch.equal(value.view(torch.int32), other["params"][name].view(torch.int32)), name
    # the key moves with the step: two steps of one run do not permute alike
    from aggregathor_tpu_torch.gars.bucketing import key_permutation
    from aggregathor_tpu_torch.parallel.engine import gar_key

    assert not torch.equal(key_permutation(gar_key(1, 0), 16, "cpu"), key_permutation(gar_key(1, 1), 16, "cpu"))


# --------------------------------------------------------------------- #
# SIGTERM

STOPPER = r"""
import os, signal, sys
import {package}.obs.summaries as summaries
from {package}.cli import runner
scalars = summaries.SummaryWriter.scalars

def stop_at(self, step, values):
    scalars(self, step, values)
    if step == int(os.environ["STOP_AT"]):
        os.kill(os.getpid(), signal.SIGTERM)

summaries.SummaryWriter.scalars = stop_at
runner.main(sys.argv[1:])
"""


def test_sigterm_stops_at_a_step_boundary_like_the_jax_runner(tmp_path):
    argv = ["--experiment", "mnist", "--experiment-args", "hidden:16", "batch-size:8", "--aggregator", "krum",
            "--nb-workers", "8", "--nb-decl-byz-workers", "2", "--max-step", "1000", "--summary-delta", "1",
            "--summary-period", "-1", "--evaluation-delta", "100", "--evaluation-period", "-1",
            "--checkpoint-delta", "100", "--checkpoint-period", "-1", "--prefetch", "0"]
    env = dict(os.environ, STOP_AT="5", JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    leaves = {}
    for package, extra in (("aggregathor_tpu", ["--nb-devices", "1"]), ("aggregathor_tpu_torch", ["--device", "cpu"])):
        out = tmp_path / package
        files = ["--checkpoint-dir", str(out / "ckpt"), "--evaluation-file", str(out / "eval.tsv"),
                 "--summary-dir", str(out / "sum"), "--journal", str(out / "journal.jsonl"),
                 "--metrics-file", str(out / "m.prom")]
        proc = subprocess.run([sys.executable, "-c", STOPPER.format(package=package), *argv, *extra, *files],
                              env=env, cwd=str(tmp_path), capture_output=True, text=True, timeout=240)
        assert proc.returncode == 0, proc.stderr[-2000:]
        assert "Interrupted: finishing current step" in proc.stderr + proc.stdout
        journal = [json.loads(line) for line in open(out / "journal.jsonl")]
        metrics = open(out / "m.prom").read()
        leaves[package] = {
            "checkpoints": sorted(name for name in os.listdir(out / "ckpt") if name.endswith(".ckpt")),
            "eval_steps": [line.split("\t")[1] for line in open(out / "eval.tsv").read().splitlines()],
            "summary_steps": sorted(_losses(out / "sum")),
            "run_end": [(e["step"], e["diverged"], e["aborting"]) for e in journal if e["type"] == "run_end"],
            "train_loss": any(line.startswith("train_loss ") for line in metrics.splitlines()),
        }
    assert leaves["aggregathor_tpu_torch"] == leaves["aggregathor_tpu"]
    assert leaves["aggregathor_tpu_torch"]["checkpoints"][-1] == "model-5.ckpt"
    assert leaves["aggregathor_tpu_torch"]["run_end"] == [(5, False, False)]


def test_stop_handlers_are_restored_and_absent_off_the_main_thread():
    import threading

    before = signal.getsignal(signal.SIGTERM), signal.getsignal(signal.SIGINT)
    runner.main(["--experiment", "mnist", "--experiment-args", "hidden:8", "--aggregator", "average",
                 "--nb-workers", "2", "--max-step", "1", "--device", "cpu", "--evaluation-delta", "-1",
                 "--evaluation-period", "-1"])
    assert (signal.getsignal(signal.SIGTERM), signal.getsignal(signal.SIGINT)) == before
    with pytest.raises(UserException):  # a refusal restores them too
        runner.main(["--experiment", "mnist", "--aggregator", "no-such-rule", "--nb-workers", "2",
                     "--device", "cpu"])
    assert (signal.getsignal(signal.SIGTERM), signal.getsignal(signal.SIGINT)) == before
    errors = []

    def embedded():
        try:
            runner.main(["--experiment", "mnist", "--experiment-args", "hidden:8", "--aggregator", "average",
                         "--nb-workers", "2", "--max-step", "1", "--device", "cpu", "--evaluation-delta", "-1",
                         "--evaluation-period", "-1"])
        except Exception as exc:  # surfaced below
            errors.append(exc)

    thread = threading.Thread(target=embedded)
    thread.start()
    thread.join()
    assert not errors
