"""Whole zoo nets against the JAX package's, on digits32 at batch 2.

- the weight bridge round-trips bit for bit on a net of every family (the
  aux heads included, depthwise kernels ``(h, w, 1, C)`` <-> ``(C, 1, h,
  w)``), the torch module has the flax tree's names and shapes, and the
  flat layout is JAX's ``ravel_pytree`` order;
- from the same weights and batch: the logits within atol 1e-4 and the loss
  within rtol 1e-5 in float32, and the gradient of the cross-entropy in
  JAX's coordinate order in float64 (flax ``dtype=float64`` under
  ``jax.enable_x64``, the port's layers in float64) within 1e-5 of its
  largest entry (flax keeps the logits layer in float32), for vgg_a,
  lenet, cifarnet, alexnet_v2, overfeat and mobilenet_v1_025 (in float32
  a ReLU whose input lies within rounding of 0 flips between the packages
  and moves a few coordinates by up to 4e-2 of the largest);
  the Inception nets, mobilenet_v2_035, nasnet_cifar and pnasnet_mobile
  run the same test marked slow, where the JAX package marks its own
  forward tests of them slow (their blocks and cells are held in tier-1 by
  ``test_torch_zoo_blocks.py`` and ``test_torch_zoo_cells.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from aggregathor_tpu import models as jmodels
from aggregathor_tpu.models import zoo as jzoo
from aggregathor_tpu_torch import models as tmodels
from aggregathor_tpu_torch.core import FlatMap
from aggregathor_tpu_torch.models.common import params_from_jax, params_to_jax

from torch_threads import pinned_threads  # noqa: F401  (a fixture: the xdist worker's intra-op pool)

#: a net of every family (the aux-capable ones build their aux head)
FAMILIES = ["resnet_v1_18", "resnet_v2_50", "vgg_a", "lenet", "cifarnet", "alexnet_v2", "overfeat",
            "mobilenet_v1_025", "mobilenet_v2_035", "inception_v1", "inception_v2", "inception_v3", "inception_v4",
            "inception_resnet_v2", "nasnet_cifar", "pnasnet_mobile"]


@pytest.mark.parametrize("name", FAMILIES)
def test_weight_bridge_round_trips_on_every_family(name):
    jexp = jmodels.instantiate("slim-%s-digits32" % name, [])
    texp = tmodels.instantiate("slim-%s-digits32" % name, [])
    shapes = jax.eval_shape(jexp.init, jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    tree = jax.tree_util.tree_map(lambda s: rng.standard_normal(s.shape, dtype=np.float32), shapes)
    params = params_from_jax(tree)
    assert {k: tuple(v.shape) for k, v in params.items()} == {
        k: tuple(v.shape) for k, v in texp.model.named_parameters()}
    back = params_to_jax(params)
    flat, flat_back = jax.tree_util.tree_leaves_with_path(tree), jax.tree_util.tree_leaves_with_path(back)
    assert [jax.tree_util.keystr(p) for p, _ in flat] == [jax.tree_util.keystr(p) for p, _ in flat_back]
    for (_, a), (_, b) in zip(flat, flat_back):
        assert np.array_equal(a, b)
    want = np.concatenate([np.ravel(leaf) for _, leaf in flat])
    assert np.array_equal(FlatMap(params).flatten(params).numpy(), want)


def _slow(name):
    return pytest.param(name, marks=pytest.mark.slow)


def _float64(module):
    """``module`` computing in float64 (its parameters and every layer's
    compute dtype)."""
    module = module.double()
    for m in module.modules():
        if isinstance(getattr(m, "dtype", None), torch.dtype):
            m.dtype = torch.float64
    return module


@pytest.mark.parametrize("name", ["vgg_a", "lenet", "cifarnet", "alexnet_v2", "overfeat", "mobilenet_v1_025",
                                  _slow("inception_v1"), _slow("inception_v2"), _slow("inception_v3"),
                                  _slow("inception_v4"), _slow("inception_resnet_v2"), _slow("mobilenet_v2_035"),
                                  _slow("nasnet_cifar"), _slow("pnasnet_mobile")])
def test_whole_net_logits_and_gradient_match_jax(name):
    # without the aux heads (held by the bridge test above, the aux loss in
    # test_torch_zoo.py and the head in test_torch_zoo_blocks.py)
    args = ["batch-size:2", "preprocessing:none", "aux-weight:0.0"]
    jexp = jmodels.instantiate("slim-%s-digits32" % name, args)
    texp = tmodels.instantiate("slim-%s-digits32" % name, args)
    jparams = jax.jit(jexp.init)(jax.random.PRNGKey(2))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    batch = jax.tree_util.tree_map(lambda x: x[0], next(jexp.make_train_iterator(1, seed=4)))
    want = np.asarray(jax.jit(jexp.model.apply)(jparams, batch["image"]))
    images, labels = torch.from_numpy(np.asarray(batch["image"])), torch.from_numpy(np.asarray(batch["label"]))
    with torch.no_grad():
        got = texp.logits(tparams, images).numpy()
        loss = float(texp.loss(tparams, {"image": images, "label": labels}))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    np.testing.assert_allclose(loss, float(jax.jit(jexp.loss)(jparams, batch)), rtol=1e-5)
    # the gradient in float64 on both sides: in float32 a ReLU whose input
    # lies within rounding of 0 flips between the two packages (images
    # upsampled by two bilinear implementations differ in their last bits)
    with jax.enable_x64(True):
        jmodel = jzoo.MODEL_FACTORY[name](10, True, jnp.float64)
        params64 = jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a), jnp.float64), jparams)
        x64 = jnp.asarray(np.asarray(batch["image"]), jnp.float64)

        def jloss(p):
            logits = jmodel.apply(p, x64)
            return jnp.mean(optax.softmax_cross_entropy_with_integer_labels(logits, jnp.asarray(batch["label"])))

        jgrad = jax.jit(jax.grad(jloss))(params64)
        want = np.concatenate([np.ravel(np.asarray(leaf)) for leaf in jax.tree_util.tree_leaves(jgrad)])
    model = _float64(texp.model)
    params = {k: v.double().requires_grad_(True) for k, v in tparams.items()}
    logits = torch.func.functional_call(model, params, (images.double(),))
    loss = torch.nn.functional.cross_entropy(logits, labels.long())
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    got = FlatMap(grads).flatten(grads).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
