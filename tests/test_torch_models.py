"""The port's models and input pipelines against the JAX package's.

- ``params_from_jax`` carries flax parameters into the port and
  ``params_to_jax`` back, bit for bit;
- from the same weights, cnnet (full published width), the MLP, and the
  ``digits`` and ``digits-conv`` experiments (the MLP at 64 inputs, cnnet at
  32x32x1: its padding and norms on one channel) give the same logits
  (the conv stacks: atol 1e-4 — float32 convolutions and GroupNorm
  statistics summed in another order; the MLPs: atol 1e-5), and each
  worker's flat gradient row equals the JAX engine's ``_worker_gradients``
  row in the JAX coordinate order (same tolerances, same reason);
- the synthetic datasets, the ``WorkerBatchIterator`` streams with the
  ``cifarnet`` augmentation, and the eval batches are bit-identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aggregathor_tpu import gars as jgars
from aggregathor_tpu import models as jmodels
from aggregathor_tpu.core.flatten import FlatMap as JaxFlatMap
from aggregathor_tpu.models import datasets as jdatasets
from aggregathor_tpu.parallel import RobustEngine as JaxEngine
from aggregathor_tpu.parallel import make_mesh
from aggregathor_tpu_torch import gars as tgars
from aggregathor_tpu_torch import models as tmodels
from aggregathor_tpu_torch.core import FlatMap
from aggregathor_tpu_torch.models import datasets as tdatasets
from aggregathor_tpu_torch.models.common import params_from_jax, params_to_jax
from aggregathor_tpu_torch.parallel import RobustEngine

MODELS = [("mnist", ["hidden:16", "batch-size:4"], 1e-5), ("cnnet", ["batch-size:2"], 1e-4),
          ("digits", ["batch-size:4"], 1e-5), ("digits-conv", ["batch-size:2"], 1e-4)]
#: the flat gradient's width at the published sizes: cnnet, and the digits
#: MLP (64-100-10) and cnnet at 32x32x1 (its first kernel 3,200 narrower)
WIDTHS = {"cnnet": 1756682, "digits": 7510, "digits-conv": 1753482}


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def pairs():
    """name -> (jax experiment, port experiment, flax params, port params)."""
    out = {}
    for name, args, _ in MODELS:
        jexp, texp = jmodels.instantiate(name, args), tmodels.instantiate(name, args)
        jparams = jexp.init(jax.random.PRNGKey(3))
        out[name] = (jexp, texp, jparams, params_from_jax(_host(jparams)))
    return out


@pytest.mark.parametrize("name", [m[0] for m in MODELS])
def test_weight_bridge_round_trips(pairs, name):
    _, texp, jparams, tparams = pairs[name]
    back = params_to_jax(tparams)
    flat_jax = jax.tree_util.tree_leaves_with_path(_host(jparams))
    flat_back = jax.tree_util.tree_leaves_with_path(back)
    assert [jax.tree_util.keystr(p) for p, _ in flat_jax] == [jax.tree_util.keystr(p) for p, _ in flat_back]
    for (_, a), (_, b) in zip(flat_jax, flat_back):
        np.testing.assert_array_equal(a, b)
    # the bridged dict has exactly the torch module's names and shapes
    assert {k: tuple(v.shape) for k, v in tparams.items()} == {
        k: tuple(v.shape) for k, v in texp.model.named_parameters()
    }


@pytest.mark.parametrize("name", [m[0] for m in MODELS])
def test_flat_layout_is_the_jax_coordinate_order(pairs, name):
    _, _, jparams, tparams = pairs[name]
    jmap, tmap = JaxFlatMap(jparams), FlatMap(tparams)
    assert tmap.size == jmap.size
    assert [(s[2], s[3], s[4]) for s in tmap.slices] == [(s[1], s[2], s[3]) for s in jmap.slices]
    # flatten in the port == ravel_pytree order of the JAX package
    want = np.concatenate([np.ravel(leaf) for leaf in jax.tree_util.tree_leaves(_host(jparams))])
    np.testing.assert_array_equal(tmap.flatten(tparams).numpy(), want)
    inflated = tmap.inflate(torch.from_numpy(want))
    for key, value in tparams.items():
        assert torch.equal(inflated[key], value)
    if name in WIDTHS:
        assert tmap.size == WIDTHS[name]


@pytest.mark.parametrize("name, tol", [(m[0], m[2]) for m in MODELS])
def test_logits_match(pairs, name, tol):
    jexp, texp, jparams, tparams = pairs[name]
    batch = next(jexp.make_train_iterator(1, seed=5))
    want = np.asarray(jexp.model.apply(jparams, batch["image"][0]))
    with torch.no_grad():
        got = texp.logits(tparams, torch.from_numpy(batch["image"][0])).numpy()
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("name, tol", [(m[0], m[2]) for m in MODELS])
def test_worker_gradients_match_in_jax_coordinate_order(pairs, name, tol):
    jexp, texp, jparams, tparams = pairs[name]
    n = 2
    batch = next(jexp.make_train_iterator(n, seed=6))
    jengine = JaxEngine(make_mesh(nb_workers=1), jgars.instantiate("average", n, 0), nb_workers=n)
    losses, rows, _ = jengine._worker_gradients(
        jparams, jax.tree_util.tree_map(jnp.asarray, batch), jexp.loss
    )
    engine = RobustEngine(tgars.instantiate("average", n, 0), n, device="cpu")
    params = {k: v.clone().requires_grad_(True) for k, v in tparams.items()}
    tlosses, trows = engine._worker_gradients(params, engine.put_batch(batch), texp.loss, FlatMap(params))
    np.testing.assert_allclose(tlosses.numpy(), np.asarray(losses), rtol=tol, atol=tol)
    np.testing.assert_allclose(trows.numpy(), np.asarray(rows), rtol=tol, atol=tol)


def test_synthetic_cifar10_is_bit_identical():
    jdata, tdata = jdatasets.load_cifar10(), tdatasets.load_cifar10()
    assert jdata.synthetic and tdata.synthetic and jdata.nb_classes == tdata.nb_classes == 10
    for split in ("x_train", "y_train", "x_test", "y_test"):
        a, b = getattr(jdata, split), getattr(tdata, split)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert tdata.x_train.shape == (8192, 32, 32, 3)


def test_cifarnet_worker_batches_are_bit_identical(pairs):
    jexp, texp, _, _ = pairs["cnnet"]
    jit, tit = jexp.make_train_iterator(4, seed=9), texp.make_train_iterator(4, seed=9)
    for _ in range(3):
        a, b = next(jit), next(tit)
        assert set(a) == set(b) == {"image", "label"}
        for key in a:
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])


@pytest.mark.parametrize("preprocessing", ["none", "cifarnet", "vgg"])
def test_host_preprocessing_matches(preprocessing):
    from aggregathor_tpu.models import preprocessing as jpre
    from aggregathor_tpu_torch.models import preprocessing as tpre

    rng = np.random.default_rng(2)
    images = rng.normal(size=(3, 5, 8, 8, 3)).astype(np.float32)
    labels = rng.integers(0, 10, size=(3, 5)).astype(np.int32)
    a, b = jpre.instantiate(preprocessing, seed=4), tpre.instantiate(preprocessing, seed=4)
    for _ in range(2):
        (ja, jl), (ta, tl) = a(images.copy(), labels), b(images.copy(), labels)
        np.testing.assert_array_equal(ja, ta)
        np.testing.assert_array_equal(jl, tl)


def test_eval_batches_and_mnist_match():
    jdata, tdata = jdatasets.load_mnist(), tdatasets.load_mnist()
    np.testing.assert_array_equal(jdata.x_test, tdata.x_test)
    pairs = zip(jdatasets.eval_batches(jdata.x_test, jdata.y_test, 3, 256),
                tdatasets.eval_batches(tdata.x_test, tdata.y_test, 3, 256))
    count = 0
    for a, b in pairs:
        for key in ("image", "label", "valid"):
            np.testing.assert_array_equal(a[key], b[key])
        count += 1
    assert count == -(-2048 // (3 * 256))


def test_unported_experiment_options_refuse():
    from aggregathor_tpu_torch.utils import UserException

    # augment:device and dtype:bfloat16 are ported; an unknown augment or
    # dtype value refuses as in JAX
    for args in (["augment:nope"], ["dtype:bf16"], ["preprocessing:nope"]):
        with pytest.raises(UserException):
            tmodels.instantiate("cnnet", args)
