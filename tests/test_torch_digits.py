"""The port's real-data path against the JAX package's, on the CPU.

- ``load_digits8x8`` and ``load_digits_upscaled`` give the same arrays, bit
  for bit, in both packages: by scikit-learn's bundled corpus, and by the
  port's committed ``data/digits.npz`` (``AGGREGATHOR_DATA`` pointed at it),
  which must also equal what the JAX package loads from scikit-learn -- the
  file's provenance;
- the ``WorkerBatchIterator`` streams agree, and ``skip(k)`` then ``next()``
  equals k + 1 ``next()`` calls, under a stateless transform (the
  ``digitsAttack`` poison, none) and a stateful one (the ``cifarnet``
  augmentation);
- ``mnistAttack`` and ``digitsAttack`` poison the same batches the same way;
- end to end: ``digits`` + Multi-Krum, n = 8, f = 2, r = 2 under the
  deterministic ``little`` attack, SGD at 0.1, from the same flax weights
  and batches for 300 steps.  Per-step losses over the first 50 steps
  within a relative 1e-4 (float32 sums in another order; measured within
  2.5e-7 over all 300 steps), final test accuracies within 0.02;
- the port alone clears 0.85 real test accuracy at 300 steps, as the JAX
  package's ``tests/test_data.py::test_digits_real_accuracy_under_krum``
  asks of the reference.
"""

import jax
import numpy as np
import pytest
import torch

from aggregathor_tpu import gars as jgars
from aggregathor_tpu import models as jmodels
from aggregathor_tpu.core import build_optimizer as jax_optimizer
from aggregathor_tpu.core import build_schedule as jax_schedule
from aggregathor_tpu.models import datasets as jdatasets
from aggregathor_tpu.models import preprocessing as jpre
from aggregathor_tpu.parallel import RobustEngine as JaxEngine
from aggregathor_tpu.parallel import attacks as jattacks
from aggregathor_tpu.parallel import make_mesh
from aggregathor_tpu_torch import gars as tgars
from aggregathor_tpu_torch import models as tmodels
from aggregathor_tpu_torch.cli import runner
from aggregathor_tpu_torch.core import build_optimizer, build_schedule
from aggregathor_tpu_torch.models import datasets as tdatasets
from aggregathor_tpu_torch.models import preprocessing as tpre
from aggregathor_tpu_torch.models.common import params_from_jax
from aggregathor_tpu_torch.parallel import RobustEngine, attacks

SPLITS = ("x_train", "y_train", "x_test", "y_test")
LOADERS = ("load_digits8x8", "load_digits_upscaled")


def _same(a, b):
    assert a.synthetic == b.synthetic and a.nb_classes == b.nb_classes
    for split in SPLITS:
        x, y = getattr(a, split), getattr(b, split)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


@pytest.fixture
def sklearn_path(monkeypatch, tmp_path):
    """No digits.npz on the search path: both loaders read scikit-learn."""
    pytest.importorskip("sklearn")
    monkeypatch.delenv("AGGREGATHOR_DATA", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.chdir(tmp_path)


@pytest.mark.parametrize("loader", LOADERS)
def test_digits_loaders_agree_by_sklearn(sklearn_path, loader):
    a, b = getattr(jdatasets, loader)(), getattr(tdatasets, loader)()
    assert not a.synthetic
    _same(a, b)
    assert a.x_train.shape[1:] == ((8, 8, 1) if loader == "load_digits8x8" else (32, 32, 1))
    assert a.x_train.shape[0] + a.x_test.shape[0] == 1797


@pytest.mark.parametrize("loader", LOADERS)
def test_digits_loaders_agree_by_the_committed_npz(sklearn_path, monkeypatch, loader):
    from_sklearn = getattr(jdatasets, loader)()
    monkeypatch.setenv("AGGREGATHOR_DATA", tdatasets.DIGITS_DIR)
    assert tdatasets._find_npz("digits.npz") == jdatasets._find_npz("digits.npz") is not None
    a, b = getattr(jdatasets, loader)(), getattr(tdatasets, loader)()
    _same(a, b)
    _same(b, from_sklearn)  # the file is the scikit-learn corpus, shuffled and split as the loader does


def test_digits_loader_falls_back_to_the_synthetic_stand_in(sklearn_path, monkeypatch):
    import builtins

    real_import = builtins.__import__

    def no_sklearn(name, *args, **kwargs):
        if name.startswith("sklearn"):
            raise ImportError(name)
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_sklearn)
    a, b = jdatasets.load_digits8x8(), tdatasets.load_digits8x8()
    assert a.synthetic and b.synthetic
    _same(a, b)


def _iterators(transform_name, nb_workers=3, batch=5, seed=4):
    """(JAX, port) iterators over the digits upscaled to 16x16 with the
    named transform: None, "poison" (stateless) or "cifarnet" (stateful)."""
    data = tdatasets.load_digits_upscaled(size=16)
    out = []
    for datasets, pre in ((jdatasets, jpre), (tdatasets, tpre)):
        if transform_name == "poison":
            transform = pre.stateless(lambda bx, by: (bx * np.float32(-2.0), by[:, ::-1]))
        elif transform_name is None:
            transform = None
        else:
            transform = pre.instantiate(transform_name, seed=seed)
        out.append(datasets.WorkerBatchIterator(data.x_train, data.y_train, nb_workers, batch, seed=seed,
                                                transform=transform))
    return out


def _batches_equal(a, b):
    assert set(a) == set(b)
    for key in a:
        assert a[key].dtype == b[key].dtype
        np.testing.assert_array_equal(a[key], b[key])


@pytest.mark.parametrize("transform", [None, "none", "poison", "cifarnet"])
def test_worker_batches_agree(transform):
    jit, tit = _iterators(transform)
    for _ in range(3):
        _batches_equal(next(jit), next(tit))


@pytest.mark.parametrize("transform", [None, "poison", "cifarnet"])
@pytest.mark.parametrize("k", [1, 7])
def test_skip_then_next_equals_k_plus_one_nexts(transform, k):
    jskipped, skipped = _iterators(transform)
    walked = _iterators(transform)[1]
    for _ in range(k):
        next(walked)
    skipped.skip(k)
    jskipped.skip(k)
    want = next(walked)
    _batches_equal(next(skipped), want)
    _batches_equal(next(jskipped), want)


def test_stateless_transforms_are_marked_as_in_jax():
    assert tdatasets.transform_is_stateless(None)
    for name in ("none", "lenet", "cifarnet", "vgg"):
        assert (tdatasets.transform_is_stateless(tpre.instantiate(name))
                == jdatasets.transform_is_stateless(jpre.instantiate(name)))
    assert not tdatasets.transform_is_stateless(tpre.instantiate("cifarnet"))
    exp = tmodels.instantiate("digitsAttack", [])
    assert tdatasets.transform_is_stateless(exp.make_train_iterator(2).transform)


@pytest.mark.parametrize("name, severity", [("digitsAttack", 1), ("digitsAttack", 2), ("mnistAttack", 2)])
def test_poisoned_batches_agree(name, severity):
    args = ["batch-size:6", "severity:%d" % severity]
    jexp, texp = jmodels.instantiate(name, args), tmodels.instantiate(name, args)
    assert texp.dataset.synthetic == jexp.dataset.synthetic
    jit, tit = jexp.make_train_iterator(4, seed=3), texp.make_train_iterator(4, seed=3)
    clean = tdatasets.WorkerBatchIterator(texp.dataset.x_train, texp.dataset.y_train, 4, 6, seed=3)
    for _ in range(2):
        a, b, c = next(jit), next(tit), next(clean)
        _batches_equal(a, b)
        assert not np.array_equal(b["image"], c["image"])  # poisoned
    # the eval split stays clean
    _batches_equal(next(jexp.make_eval_iterator(4)), next(texp.make_eval_iterator(4)))


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _accuracy(eval_sums, state, put, batches):
    hits = total = 0.0
    for batch in batches:
        sums = eval_sums(state, put(batch))
        hits, total = hits + float(sums["accuracy"][0]), total + float(sums["accuracy"][1])
    return hits / total


@pytest.fixture
def one_thread():
    """One intra-op thread for the 300-step runs: the digits MLP's ops are
    tiny, and a full pool of spinning threads per process stalls when the
    suite's workers share the cores (8 threads: 128 s for the runner's 300
    steps beside five busy cores; 1 thread: 8.5 s, the same accuracy)."""
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


@pytest.mark.usefixtures("one_thread")
def test_digits_krum_under_little_attack_matches_the_jax_package(sklearn_path):
    n, f, r, steps = 8, 2, 2, 300
    jexp, texp = jmodels.instantiate("digits", []), tmodels.instantiate("digits", [])
    assert not jexp.dataset.synthetic and not texp.dataset.synthetic
    jtx = jax_optimizer("sgd", jax_schedule("fixed", ["initial-rate:0.1"]))
    ttx = build_optimizer("sgd", build_schedule("fixed", ["initial-rate:0.1"]))
    jengine = JaxEngine(make_mesh(nb_workers=1), jgars.instantiate("krum", n, f), nb_workers=n,
                        nb_real_byz=r, attack=jattacks.instantiate("little", n, r))
    tengine = RobustEngine(tgars.instantiate("krum", n, f), n, nb_real_byz=r,
                           attack=attacks.instantiate("little", n, r), device="cpu")
    init = jexp.init(jax.random.PRNGKey(0))
    jstep, tstep = jengine.build_step(jexp.loss, jtx), tengine.build_step(texp.loss, ttx)
    jstate = jengine.init_state(init, jtx, seed=1)
    tstate = tengine.init_state(params_from_jax(_host(init)), ttx, seed=1)
    it = jexp.make_train_iterator(n, seed=2)
    jloss, tloss = [], []
    for _ in range(steps):
        batch = next(it)
        jstate, jm = jstep(jstate, jengine.shard_batch(batch))
        tstate, tm = tstep(tstate, tengine.put_batch(batch))
        jloss.append(float(jm["total_loss"]))
        tloss.append(float(tm["total_loss"]))
    np.testing.assert_allclose(tloss[:50], jloss[:50], rtol=1e-4)
    jacc = _accuracy(jengine.build_eval_sums(jexp.metrics), jstate, jengine.shard_batch, jexp.make_eval_iterator(n))
    tacc = _accuracy(tengine.build_eval_sums(texp.metrics), tstate, tengine.put_batch, texp.make_eval_iterator(n))
    assert abs(tacc - jacc) <= 0.02, (tacc, jacc)
    assert tacc > 0.8


@pytest.mark.usefixtures("one_thread")
def test_digits_real_accuracy_under_krum_through_the_runner(sklearn_path):
    result = runner.main(["--experiment", "digits", "--aggregator", "krum", "--nb-workers", "8",
                          "--nb-decl-byz-workers", "2", "--max-step", "300", "--evaluation-delta", "300",
                          "--evaluation-period", "-1", "--learning-rate-args", "initial-rate:0.1",
                          "--device", "cpu"])
    assert result["steps"] == 300
    assert result["evaluation"]["accuracy"] > 0.85, result["evaluation"]
