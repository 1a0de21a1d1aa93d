"""The port's ResNets (``models/resnet.py``) against the JAX package's.

From the same flax weights (``params_from_jax``) and inputs drawn from a
seed with numpy, at batch 2: ``resnet_v1_18``, ``resnet_v1_50`` and
``resnet_v2_50`` on digits32 (the 3x3/1 stem) and ``resnet_v1_50`` at 64x64
with the ImageNet stem (7x7/2, the 3x3/2 "SAME" max-pool):

- the weight bridge round-trips bit for bit, and the flat layout is JAX's
  coordinate order (``FlatMap`` against ``ravel_pytree``);
- the logits agree within atol 1e-4 (float32 convolutions and GroupNorm
  statistics summed in another order);
- the vmapped worker gradients (n = 2) agree in JAX's coordinate order,
  each row within 1e-2 of its largest magnitude: in float32 a ReLU whose
  input lies within rounding of 0 flips between two summation orders and
  moves a few coordinates by up to 4e-3 of the largest; so the same
  gradients are also held in float64 (flax ``dtype=float64`` under
  ``jax.enable_x64``, the port's layers in float64), within 1e-5 of the
  largest (flax keeps the logits layer in float32);
- in bfloat16 compute the logits are float32 and within 0.1 of JAX's
  (bfloat16 rounding in both packages, not the same roundings);
- the slice as a whole: the port's runner (``--device cpu``) against the
  JAX runner (``--nb-devices 1``) on ``slim-resnet_v1_18-digits32``,
  Bulyan at n = 7, f = 1 (signflip), batch 2, 3 steps from the JAX
  package's weights and, each step, the JAX runner's worker-gradient rows:
  the losses and the aggregate's norms within rtol 1e-4, Bulyan's
  selections (the workers' participation) identical at every step.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.func import functional_call

from aggregathor_tpu import gars as jgars
from aggregathor_tpu import models as jmodels
from aggregathor_tpu.core.flatten import FlatMap as JaxFlatMap
from aggregathor_tpu.models.resnet import ResNet as JaxResNet
from aggregathor_tpu.parallel import RobustEngine as JaxEngine
from aggregathor_tpu.parallel import make_mesh
from aggregathor_tpu_torch import gars as tgars
from aggregathor_tpu_torch.core import FlatMap
from aggregathor_tpu_torch.models.common import params_from_jax, params_to_jax
from aggregathor_tpu_torch.models.resnet import ResNet
from aggregathor_tpu_torch.parallel import RobustEngine

from torch_threads import pinned_threads  # noqa: F401  (a fixture: the xdist worker's intra-op pool)

#: case -> (flax module, port module, input shape (H, W, C))
CASES = {
    "resnet_v1_18": (dict(depth=18, classes=10, small_inputs=True), dict(preact=False), (32, 32, 1)),
    "resnet_v1_50": (dict(depth=50, classes=10, small_inputs=True), dict(preact=False), (32, 32, 1)),
    "resnet_v2_50": (dict(depth=50, classes=10, small_inputs=True, preact=True), dict(preact=True), (32, 32, 1)),
    "resnet_v1_50-imagenet-stem": (dict(depth=50, classes=10, small_inputs=False), dict(preact=False), (64, 64, 3)),
}
#: the flat widths (digits32's one channel; 3 at 64x64)
WIDTHS = {"resnet_v1_18": 11172810, "resnet_v1_50": 23519690, "resnet_v2_50": 23512010,
          "resnet_v1_50-imagenet-stem": 23528522}


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def cases():
    out = {}
    rng = np.random.default_rng(17)
    for name, (jkw, tkw, shape) in CASES.items():
        jmodel = JaxResNet(**jkw)
        tmodel = ResNet(jkw["depth"], jkw["classes"], small_inputs=jkw["small_inputs"], channels=shape[2], **tkw)
        x = rng.normal(size=(2, 2) + shape).astype(np.float32)  # (n = 2 workers, batch 2)
        y = rng.integers(0, 10, size=(2, 2)).astype(np.int32)
        # jitted: flax's eager init of a ResNet-50 takes most of a minute
        jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(7), jnp.zeros((1,) + shape, jnp.float32))
        out[name] = (jmodel, tmodel, jparams, params_from_jax(_host(jparams)), x, y)
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_weight_bridge_and_flat_layout(cases, name):
    _, tmodel, jparams, tparams, _, _ = cases[name]
    back = params_to_jax(tparams)
    flat_jax = jax.tree_util.tree_leaves_with_path(_host(jparams))
    flat_back = jax.tree_util.tree_leaves_with_path(back)
    assert [jax.tree_util.keystr(p) for p, _ in flat_jax] == [jax.tree_util.keystr(p) for p, _ in flat_back]
    for (_, a), (_, b) in zip(flat_jax, flat_back):
        assert np.array_equal(a, b)
    assert {k: tuple(v.shape) for k, v in tparams.items()} == {k: tuple(v.shape) for k, v in tmodel.named_parameters()}
    jmap, tmap = JaxFlatMap(jparams), FlatMap(tparams)
    assert tmap.size == jmap.size == WIDTHS[name]
    assert [(s[2], s[3], s[4]) for s in tmap.slices] == [(s[1], s[2], s[3]) for s in jmap.slices]
    want = np.concatenate([np.ravel(leaf) for leaf in jax.tree_util.tree_leaves(_host(jparams))])
    assert np.array_equal(tmap.flatten(tparams).numpy(), want)


@pytest.mark.parametrize("name", list(CASES))
def test_logits_match(cases, name):
    jmodel, tmodel, jparams, tparams, x, _ = cases[name]
    want = np.asarray(jmodel.apply(jparams, x[0]))
    with torch.no_grad():
        got = functional_call(tmodel, tparams, (torch.from_numpy(x[0]),)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("name", list(CASES))
def test_vmapped_worker_gradients_match_in_jax_order(cases, name):
    jmodel, tmodel, jparams, tparams, x, y = cases[name]

    def jloss(params, batch):
        logits = jmodel.apply(params, batch["image"])
        return jnp.mean(optax.softmax_cross_entropy_with_integer_labels(logits, batch["label"]))

    def tloss(params, batch):
        logits = functional_call(tmodel, params, (batch["image"],))
        return torch.nn.functional.cross_entropy(logits, batch["label"].long())

    jengine = JaxEngine(make_mesh(nb_workers=1), jgars.instantiate("average", 2, 0), nb_workers=2)
    losses, rows, _ = jengine._worker_gradients(jparams, {"image": jnp.asarray(x), "label": jnp.asarray(y)}, jloss)
    engine = RobustEngine(tgars.instantiate("average", 2, 0), 2, device="cpu")
    params = {k: v.clone().requires_grad_(True) for k, v in tparams.items()}
    tlosses, trows = engine._worker_gradients(params, engine.put_batch({"image": x, "label": y}), tloss,
                                              FlatMap(params))
    np.testing.assert_allclose(tlosses.numpy(), np.asarray(losses), rtol=1e-5)
    want = np.asarray(rows)
    err = np.abs(trows.numpy() - want).max(axis=1) / np.abs(want).max(axis=1)
    assert np.all(err <= 1e-2), err


def _float64(module):
    """``module`` computing in float64 (its parameters and every layer's
    compute dtype)."""
    module = module.double()
    for m in module.modules():
        if hasattr(m, "dtype") and isinstance(getattr(m, "dtype"), torch.dtype):
            m.dtype = torch.float64
    return module


@pytest.mark.parametrize("name", ["resnet_v1_18", "resnet_v1_50-imagenet-stem"])
def test_gradients_agree_in_float64(cases, name):
    jkw, tkw, shape = CASES[name]
    _, _, jparams, tparams, x, y = cases[name]
    tmodel = _float64(ResNet(jkw["depth"], jkw["classes"], small_inputs=jkw["small_inputs"], channels=shape[2],
                             **tkw))
    with jax.enable_x64(True):
        jmodel = JaxResNet(dtype=jnp.float64, **jkw)
        params = jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a), jnp.float64), jparams)

        def jloss(p):
            logits = jmodel.apply(p, jnp.asarray(x[0], jnp.float64))
            return jnp.mean(optax.softmax_cross_entropy_with_integer_labels(logits, jnp.asarray(y[0])))

        want = np.concatenate([np.ravel(np.asarray(leaf))
                               for leaf in jax.tree_util.tree_leaves(jax.jit(jax.grad(jloss))(params))])
    params = {k: v.double().requires_grad_(True) for k, v in tparams.items()}
    logits = functional_call(tmodel, params, (torch.from_numpy(x[0]).double(),))
    loss = torch.nn.functional.cross_entropy(logits, torch.from_numpy(y[0]).long())
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    got = FlatMap(grads).flatten(grads).numpy()  # float32 rows, JAX's order
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_bfloat16_forward():
    jmodel = JaxResNet(depth=18, classes=10, small_inputs=True, dtype=jnp.bfloat16)
    tmodel = ResNet(18, 10, small_inputs=True, channels=1, dtype=torch.bfloat16)
    x = np.random.default_rng(4).normal(size=(2, 32, 32, 1)).astype(np.float32)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(1), x)
    tparams = params_from_jax(_host(jparams))
    assert all(v.dtype == torch.float32 for v in tparams.values())
    want = np.asarray(jmodel.apply(jparams, x))
    with torch.no_grad():
        got = functional_call(tmodel, tparams, (torch.from_numpy(x),))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=0.1)
    # the bfloat16 path is not the float32 one
    exact = functional_call(ResNet(18, 10, small_inputs=True, channels=1), tparams, (torch.from_numpy(x),))
    assert not torch.equal(got, exact.detach())


RUN = ["--experiment", "slim-resnet_v1_18-digits32", "--experiment-args", "batch-size:2", "preprocessing:none",
       "--aggregator", "bulyan", "--nb-workers", "7", "--nb-decl-byz-workers", "1", "--nb-real-byz-workers", "1",
       "--attack", "signflip", "--learning-rate-args", "initial-rate:0.01", "--evaluation-delta", "-1",
       "--evaluation-period", "-1", "--summary-delta", "1", "--summary-period", "-1", "--worker-metrics",
       "--max-step", "3", "--prefetch", "0"]


def _summaries(directory):
    events = [json.loads(line) for name in sorted(os.listdir(directory))
              for line in open(os.path.join(directory, name))]
    return {e["step"]: e for e in events if "total_loss" in e}


def test_the_runner_matches_the_jax_runner(tmp_path, monkeypatch):
    from aggregathor_tpu.cli import runner as jrunner
    from aggregathor_tpu.parallel import engine as jengine
    from aggregathor_tpu_torch.cli import runner
    from aggregathor_tpu_torch.models import zoo
    from aggregathor_tpu_torch.parallel import engine as tengine

    # both runners from the JAX package's initial weights
    jexp = jmodels.instantiate("slim-resnet_v1_18-digits32", ["batch-size:2"])
    monkeypatch.setattr(zoo.ZooExperiment, "init", lambda self, seed: params_from_jax(
        _host(jexp.init(jax.random.PRNGKey(seed)))))
    # a test-only seam: the port's steps run on the JAX runner's own float32
    # worker-gradient rows, captured each step (in float32 a ReLU whose
    # input lies within rounding of 0 flips between the two backwards and
    # moves a worker's row by up to 1e-2 of its largest entry, which a
    # Bulyan selection three steps on amplifies; the backward itself is
    # held above, in float64)
    captured = []
    jax_gradients, port_gradients = jengine.RobustEngine._worker_gradients, tengine.RobustEngine._worker_gradients

    def capturing(self, params, batch, loss_fn):
        losses, rows, flatmap = jax_gradients(self, params, batch, loss_fn)
        jax.debug.callback(lambda r: captured.append(np.array(r)), rows, ordered=True)
        return losses, rows, flatmap

    def injected(self, params, batch, loss_fn, flatmap):
        losses, _ = port_gradients(self, params, batch, loss_fn, flatmap)
        return losses, torch.from_numpy(captured.pop(0))

    monkeypatch.setattr(jengine.RobustEngine, "_worker_gradients", capturing)
    monkeypatch.setattr(tengine.RobustEngine, "_worker_gradients", injected)
    jrunner.main(RUN + ["--summary-dir", str(tmp_path / "jax"), "--nb-devices", "1"])
    jax.effects_barrier()
    assert len(captured) == 3
    result = runner.main(RUN + ["--summary-dir", str(tmp_path / "port"), "--device", "cpu"])
    assert captured == []
    want, got = _summaries(tmp_path / "jax"), _summaries(tmp_path / "port")
    assert sorted(got) == sorted(want) == [1, 2, 3] and result["steps"] == 3
    for key in ("total_loss", "grad_norm"):
        np.testing.assert_allclose([got[k][key] for k in (1, 2, 3)], [want[k][key] for k in (1, 2, 3)], rtol=1e-4)
    for k in (1, 2, 3):
        selected = np.asarray(got[k]["worker_participation"]) > 0
        assert np.array_equal(selected, np.asarray(want[k]["worker_participation"]) > 0), k
        np.testing.assert_allclose(got[k]["worker_participation"], want[k]["worker_participation"], rtol=1e-6)
