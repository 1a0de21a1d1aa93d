"""The port's input path and batched step against the JAX package's.

- ``FlatMap.flatten_rows`` equals n calls of ``flatten_into``, bit for bit.
- The vmapped worker gradients equal the JAX engine's vmapped
  ``_worker_gradients`` from the same weights and batches (cnnet at batch 4,
  the ``hidden:16`` MLP, weights from seed 4): within 1e-5 of each row's
  largest entry (float32 sums in another order; the per-worker loop and the
  vmap differ by up to 1.9e-6 there), and equal a per-worker loop kept here
  within the same bound; with warnings as errors, vmap takes no
  batching-rule fallback.  From seed 3's weights one cnnet worker's JAX
  gradient lies percent-level off the float64 gradient while the port's
  lies within 1e-5 of it, so there the port's vmapped rows are held
  against its float64 loop instead.
- cnnet's CUDA convolution route (``common.ConvF64WeightGrad``, its weight
  gradient in float64) has the native convolution's gradients under vmap and grad on
  the CPU, within 1e-12 in float64 and 1e-5 of the largest entry in float32.
- The in-step augmentation: given the JAX package's offsets and flips, the
  port's apply equals ``_device_cifarnet`` and ``_device_flip`` bit for bit
  (pure data movement); the port's draws pass a chi-square test on the 9 x 9
  offsets and a binomial test on the flip rate (p > 1e-3); worker w's
  stream does not depend on n; evaluation never augments.
- An engine step with ``batch_transform``, the JAX draws injected, follows
  the JAX engine within the engine tests' tolerances (rtol/atol 1e-5).
- The multi-step trainers: ``build_multi_step`` equals K calls of the step
  bit for bit on the CPU; ``build_sampled_multi_step`` with the JAX
  package's tag-4 indices injected follows JAX's within rtol/atol 1e-5; a
  sampled tail is an exact prefix of a longer sampled run.
- ``WorkerBatchIterator.next_many`` equals k calls of ``next`` bit for bit;
  the ``DevicePrefetcher`` keeps the order, surfaces a producer error and
  leaves no thread after a close mid-stream.
"""

import threading
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from aggregathor_tpu import gars as jgars
from aggregathor_tpu import models as jmodels
from aggregathor_tpu.core import build_optimizer as jax_optimizer
from aggregathor_tpu.core import build_schedule as jax_schedule
from aggregathor_tpu.models import preprocessing as jpre
from aggregathor_tpu.parallel import RobustEngine as JaxEngine
from aggregathor_tpu.parallel import make_mesh
from aggregathor_tpu_torch import gars as tgars
from aggregathor_tpu_torch import models as tmodels
from aggregathor_tpu_torch.core import FlatMap, build_optimizer, build_schedule
from aggregathor_tpu_torch.models import preprocessing
from aggregathor_tpu_torch.models.common import params_from_jax
from aggregathor_tpu_torch.models.datasets import DevicePrefetcher, WorkerBatchIterator
from aggregathor_tpu_torch.parallel import RobustEngine
from aggregathor_tpu_torch.parallel.engine import AUGMENT_TAG, SAMPLE_TAG

from torch_threads import pinned_threads  # noqa: F401  (a fixture: the xdist worker's intra-op pool)

TOL = 1e-5


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _tensors(batch):
    return {key: torch.as_tensor(np.ascontiguousarray(value)) for key, value in batch.items()}


def _rows_close(got, want, rtol=TOL):
    """Each row within ``rtol`` of that row's largest magnitude."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = np.max(np.abs(want), axis=1, keepdims=True)
    assert np.all(np.abs(got - want) <= rtol * scale), float(np.max(np.abs(got - want) / scale))


# --------------------------------------------------------------------------- #
# Batched flatten and the vmapped gradients

GRAD_CASES = [("cnnet", ["batch-size:4"], 3), ("mnist", ["hidden:16", "batch-size:8"], 4)]


@pytest.mark.parametrize("experiment, args, n", GRAD_CASES, ids=[c[0] for c in GRAD_CASES])
def test_flatten_rows_is_flatten_into_row_by_row(experiment, args, n):
    params = tmodels.instantiate(experiment, args).init(0)
    gen = torch.Generator().manual_seed(1)
    stacked = {name: torch.randn((n,) + tuple(value.shape), generator=gen) for name, value in params.items()}
    flatmap = FlatMap(params)
    rows = flatmap.flatten_rows(stacked)
    for w in range(n):
        want = flatmap.flatten({name: value[w] for name, value in stacked.items()})
        assert torch.equal(rows[w].view(torch.int32), want.view(torch.int32))


def _worker_loop(params, batch, loss_fn, flatmap, n):
    """The per-worker loop the engine ran before it vmapped."""
    rows, losses = torch.empty((n, flatmap.size)), torch.empty(n)
    leaves = {name: value.detach().clone().requires_grad_(True) for name, value in params.items()}
    for w in range(n):
        loss = loss_fn(leaves, {key: value[w] for key, value in batch.items()})
        grads = torch.autograd.grad(loss, list(leaves.values()))
        flatmap.flatten_into(rows[w], dict(zip(leaves, grads)))
        losses[w] = loss.detach()
    return losses, rows


@pytest.mark.parametrize("experiment, args, n", GRAD_CASES, ids=[c[0] for c in GRAD_CASES])
def test_vmapped_gradients_match_jax_and_the_loop(experiment, args, n):
    jexp, texp = jmodels.instantiate(experiment, args), tmodels.instantiate(experiment, args)
    jengine = JaxEngine(make_mesh(nb_workers=1), jgars.instantiate("average", n, 0), nb_workers=n)
    tengine = RobustEngine(tgars.instantiate("average", n, 0), n, device="cpu")
    init = jexp.init(jax.random.PRNGKey(4))
    batch = next(jexp.make_train_iterator(n, seed=5))
    jlosses, jrows = jax.jit(lambda p, b: jengine._worker_gradients(p, b, jexp.loss)[:2])(init, batch)
    params = tengine.init_state(params_from_jax(_host(init)), build_optimizer("sgd", build_schedule("fixed", [])))
    params = params.params
    flatmap = FlatMap(params)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # a batching-rule fallback warns: fail on it
        losses, rows = tengine._worker_gradients(params, _tensors(batch), texp.loss, flatmap)
    assert rows.shape == (n, flatmap.size) and rows.dtype == torch.float32
    _rows_close(rows.numpy(), np.asarray(jrows))
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), rtol=TOL)
    loop_losses, loop_rows = _worker_loop(params, _tensors(batch), texp.loss, flatmap, n)
    _rows_close(rows.numpy(), loop_rows.numpy())
    np.testing.assert_allclose(losses.numpy(), loop_losses.numpy(), rtol=TOL)


def test_vmapped_cnnet_gradients_follow_the_float64_loop():
    n = 3
    jexp, texp = jmodels.instantiate("cnnet", ["batch-size:4"]), tmodels.instantiate("cnnet", ["batch-size:4"])
    params = params_from_jax(_host(jexp.init(jax.random.PRNGKey(3))))
    batch = _tensors(next(jexp.make_train_iterator(n, seed=4)))
    flatmap = FlatMap(params)
    engine = RobustEngine(tgars.instantiate("average", n, 0), n, device="cpu")
    losses, rows = engine._worker_gradients(params, batch, texp.loss, flatmap)
    texp.model.double()
    try:
        exact = _worker_loop({k: v.double() for k, v in params.items()},
                             {"image": batch["image"].double(), "label": batch["label"]}, texp.loss, flatmap, n)
    finally:
        texp.model.float()
    _rows_close(rows.numpy(), exact[1].numpy())
    np.testing.assert_allclose(losses.numpy(), exact[0].numpy(), rtol=TOL)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_the_cuda_convolution_route_has_the_convolutions_gradients(dtype):
    """cnnet's convolutions take ``ConvF64WeightGrad`` on CUDA (its weight gradient
    computed in float64): here, on the CPU, its gradients under vmap and
    grad are the native convolution's, within 1e-12 in float64 and 1e-5 of
    the largest entry in float32."""
    from torch.func import grad, vmap

    from aggregathor_tpu_torch.models.cnnet import conv_weight_grad
    from aggregathor_tpu_torch.models.common import ConvF64WeightGrad

    gen = torch.Generator().manual_seed(0)
    x = torch.randn((3, 10, 4, 12, 12), generator=gen, dtype=dtype)
    probe = torch.randn((3, 10, 6, 12, 12), generator=gen, dtype=dtype)
    weight = torch.randn((6, 4, 5, 5), generator=gen, dtype=dtype)
    bias = torch.randn(6, generator=gen, dtype=dtype)
    tol = 1e-12 if dtype == torch.float64 else 1e-5

    def loss(conv):
        return lambda w, b, xi, pi: torch.sum(torch.sin(conv(xi, w, b)) * pi)

    native = loss(lambda xi, w, b: torch.nn.functional.conv2d(xi, w, b, padding=2))
    route = loss(lambda xi, w, b: ConvF64WeightGrad.apply(xi, w, b, (1, 1), (2, 2), 1))
    grads = [vmap(grad(f, argnums=(0, 1, 2)), in_dims=(None, None, 0, 0))(weight, bias, x, probe)
             for f in (native, route)]
    for want, got in zip(*grads):
        assert got.dtype == dtype and float(torch.max(torch.abs(got - want))) <= tol * float(torch.max(torch.abs(want)))
    direct = conv_weight_grad(x[0], probe[0], weight)
    want = torch.nn.grad.conv2d_weight(x[0].double(), weight.shape, probe[0].double(), padding=2)
    assert direct.dtype == dtype and float(torch.max(torch.abs(direct - want))) <= tol * float(torch.max(torch.abs(want)))


def test_vmapped_eval_sums_take_no_fallback_and_match_the_loop():
    n = 3
    texp = tmodels.instantiate("digits-conv", ["batch-size:2"])
    engine = RobustEngine(tgars.instantiate("average", n, 0), n, device="cpu")
    state = engine.init_state(texp.init(5), build_optimizer("sgd", build_schedule("fixed", [])))
    batch = _tensors(next(texp.make_eval_iterator(n)))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = engine.build_eval_sums(texp.metrics)(state, batch)
    with torch.no_grad():
        per_worker = [texp.metrics(state.params, {k: v[w] for k, v in batch.items()}) for w in range(n)]
    for name, (total, count) in got.items():
        assert float(count) == sum(float(m[name][1]) for m in per_worker)
        assert abs(float(total) - sum(float(m[name][0]) for m in per_worker)) <= TOL * max(1.0, float(total))


# --------------------------------------------------------------------------- #
# The in-step augmentation


def _jax_draws(key, b, pad=4):
    """The offsets and flips ``_device_cifarnet`` draws from ``key``."""
    kc, kf = jax.random.split(key)
    return (np.asarray(jax.random.randint(kc, (b, 2), 0, 2 * pad + 1)),
            np.asarray(jax.random.bernoulli(kf, 0.5, (b,))))


@pytest.mark.parametrize("channels", [3, 1])
def test_cifarnet_apply_is_bit_identical_given_the_jax_draws(channels):
    rng = np.random.default_rng(channels)
    images = rng.normal(size=(16, 32, 32, channels)).astype(np.float32)
    key = jax.random.PRNGKey(7 + channels)
    want = np.asarray(jpre._device_cifarnet(4)({"image": jnp.asarray(images)}, key)["image"])
    offsets, flips = _jax_draws(key, 16)
    assert flips.any() and not flips.all()
    got = preprocessing.DeviceCifarnet(4).apply(torch.as_tensor(images), torch.as_tensor(offsets),
                                               torch.as_tensor(flips))
    np.testing.assert_array_equal(got.numpy(), want)
    # the same on a worker-major (n, b, ...) block
    block = preprocessing.DeviceCifarnet(4).apply(torch.as_tensor(images).reshape(2, 8, 32, 32, channels),
                                                 torch.as_tensor(offsets).reshape(2, 8, 2),
                                                 torch.as_tensor(flips).reshape(2, 8))
    np.testing.assert_array_equal(block.reshape(16, 32, 32, channels).numpy(), want)


def test_flip_apply_is_bit_identical_given_the_jax_draws():
    images = np.random.default_rng(2).normal(size=(12, 8, 8, 3)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    want = np.asarray(jpre._device_flip()({"image": jnp.asarray(images)}, key)["image"])
    flips = np.asarray(jax.random.bernoulli(key, 0.5, (12,)))
    got = preprocessing.DeviceFlip().apply(torch.as_tensor(images), torch.as_tensor(flips))
    np.testing.assert_array_equal(got.numpy(), want)


def test_device_registry_matches_jax():
    assert set(preprocessing.DEVICE_PREPROCESSING) == set(jpre.DEVICE_PREPROCESSING)
    for name in jpre.DEVICE_PREPROCESSING:
        assert (preprocessing.device_transform(name) is None) == (jpre.device_transform(name) is None), name
    with pytest.raises(Exception, match="Unknown preprocessing"):
        preprocessing.device_transform("nope")


def test_cifarnet_draws_are_uniform_offsets_and_fair_flips():
    transform = preprocessing.DeviceCifarnet(4)
    draws = transform.draw(8100, torch.Generator().manual_seed(0))
    offsets, flips = draws["offsets"].numpy(), draws["flips"].numpy()
    assert offsets.min() == 0 and offsets.max() == 8
    cells = np.bincount(offsets[:, 0] * 9 + offsets[:, 1], minlength=81)
    assert scipy.stats.chisquare(cells).pvalue > 1e-3
    assert scipy.stats.binomtest(int(flips.sum()), flips.size, 0.5).pvalue > 1e-3


def test_worker_augmentation_does_not_depend_on_n():
    images = torch.as_tensor(np.random.default_rng(0).normal(size=(4, 6, 32, 32, 3)).astype(np.float32))
    out = {}
    for n in (2, 4):
        engine = RobustEngine(tgars.instantiate("average", n, 0), n, device="cpu",
                              batch_transform=preprocessing.DeviceCifarnet(4))
        out[n] = engine._augment({"image": images[:n], "label": torch.zeros(n, 6)}, seed=3, step=5)["image"]
    assert torch.equal(out[2], out[4][:2])
    assert not torch.equal(out[4][:2], images[:2])


def test_evaluation_never_augments():
    n = 2
    texp = tmodels.instantiate("cnnet", ["batch-size:2", "augment:device"])
    assert isinstance(texp.device_transform(), preprocessing.DeviceCifarnet)

    class Refuse:
        def draw(self, batch_size, generator):
            raise AssertionError("an evaluation drew augmentation")

    plain = RobustEngine(tgars.instantiate("average", n, 0), n, device="cpu")
    augmenting = RobustEngine(tgars.instantiate("average", n, 0), n, device="cpu", batch_transform=Refuse())
    state = plain.init_state(texp.init(0), build_optimizer("sgd", build_schedule("fixed", [])))
    batch = _tensors(next(texp.make_eval_iterator(n)))
    batch = {key: value[:, :4] for key, value in batch.items()}
    want = plain.build_eval_sums(texp.metrics)(state, batch)
    got = augmenting.build_eval_sums(texp.metrics)(state, batch)
    assert {k: (float(a), float(b)) for k, (a, b) in got.items()} == \
        {k: (float(a), float(b)) for k, (a, b) in want.items()}


# --------------------------------------------------------------------------- #
# Engine steps against the JAX engine, the JAX draws injected


def _inject_jax_draws(monkeypatch, engine, seed, pad=4):
    """Replace the port's per-worker draws by the JAX engine's: tag 3 (the
    offsets and flips of ``_device_cifarnet``) and tag 4 (the sampled rows)
    from fold_in(fold_in(fold_in(PRNGKey(seed), step), w), tag)."""
    captured = {}

    def draws(draw, seed_, step, tag):
        assert seed_ == seed
        probe = draw(torch.Generator().manual_seed(0))
        key = jax.random.fold_in(jax.random.PRNGKey(seed), step)
        out = []
        for w in range(engine.nb_workers):
            wkey = jax.random.fold_in(jax.random.fold_in(key, w), tag)
            if tag == AUGMENT_TAG:
                offsets, flips = _jax_draws(wkey, probe["offsets"].shape[0], pad)
                out.append({"offsets": torch.as_tensor(offsets), "flips": torch.as_tensor(flips)})
            else:
                assert tag == SAMPLE_TAG
                count = captured["nb_examples"]
                index = jax.random.randint(wkey, (probe["index"].shape[0],), 0, count)
                out.append({"index": torch.as_tensor(np.asarray(index)).long()})
        return {key: torch.stack([d[key] for d in out]) for key in out[0]}

    original = engine._sample_indices

    def sample_indices(seed_, step, nb_examples, batch_size):
        captured["nb_examples"] = nb_examples
        return original(seed_, step, nb_examples, batch_size)

    monkeypatch.setattr(engine, "_worker_draws", draws)
    monkeypatch.setattr(engine, "_sample_indices", sample_indices)


def _pair(experiment, args, n, transform=False, rule="krum", f=1):
    jexp, texp = jmodels.instantiate(experiment, args), tmodels.instantiate(experiment, args)
    jtx = jax_optimizer("sgd", jax_schedule("fixed", ["initial-rate:0.05"]))
    ttx = build_optimizer("sgd", build_schedule("fixed", ["initial-rate:0.05"]))
    jengine = JaxEngine(make_mesh(nb_workers=1), jgars.instantiate(rule, n, f), nb_workers=n,
                        batch_transform=jpre._device_cifarnet(4) if transform else None)
    tengine = RobustEngine(tgars.instantiate(rule, n, f), n, device="cpu",
                           batch_transform=preprocessing.DeviceCifarnet(4) if transform else None)
    init = jexp.init(jax.random.PRNGKey(11))
    jstate = jengine.init_state(init, jtx, seed=1)
    tstate = tengine.init_state(params_from_jax(_host(init)), ttx, seed=1)
    return jexp, texp, jtx, ttx, jengine, tengine, jstate, tstate


def _assert_params_close(tstate, jstate):
    want = params_from_jax(_host(jstate.params))
    for key in want:
        np.testing.assert_allclose(tstate.params[key].detach().numpy(), want[key].numpy(), rtol=TOL, atol=TOL,
                                   err_msg=key)


def test_augmented_steps_follow_the_jax_engine(monkeypatch):
    n = 4
    jexp, texp, jtx, ttx, jengine, tengine, jstate, tstate = _pair("mnist", ["hidden:16", "batch-size:8"], n,
                                                                   transform=True)
    _inject_jax_draws(monkeypatch, tengine, seed=1)
    jstep, tstep = jengine.build_step(jexp.loss, jtx), tengine.build_step(texp.loss, ttx)
    it = jexp.make_train_iterator(n, seed=2)
    for _ in range(3):
        batch = next(it)
        jstate, jm = jstep(jstate, jengine.shard_batch(batch))
        tstate, tm = tstep(tstate, tengine.put_batch(batch))
        assert abs(float(tm["total_loss"]) - float(jm["total_loss"])) <= TOL * abs(float(jm["total_loss"]))
        _assert_params_close(tstate, jstate)


def test_sampled_multi_step_follows_the_jax_engine(monkeypatch):
    n, k = 4, 3
    jexp, texp, jtx, ttx, jengine, tengine, jstate, tstate = _pair("digits", ["hidden:16", "batch-size:8"], n)
    _inject_jax_draws(monkeypatch, tengine, seed=1)
    jmulti = jengine.build_sampled_multi_step(jexp.loss, jtx, repeat_steps=k, batch_size=8)
    tmulti = tengine.build_sampled_multi_step(texp.loss, ttx, k, 8)
    jstate, jm = jmulti(jstate, jengine.replicate(jexp.train_arrays()))
    tstate, tm = tmulti(tstate, tengine.replicate(texp.train_arrays()))
    assert tstate.step == k and tm["total_loss"].shape == (k,)
    np.testing.assert_allclose(tm["total_loss"].numpy(), np.asarray(jm["total_loss"]), rtol=TOL)
    _assert_params_close(tstate, jstate)


def _fresh(n=4, transform=False):
    exp = tmodels.instantiate("digits", ["hidden:16", "batch-size:8"])
    tx = build_optimizer("sgd", build_schedule("fixed", ["initial-rate:0.05"]))
    engine = RobustEngine(tgars.instantiate("krum", n, 1), n, device="cpu",
                          batch_transform=preprocessing.DeviceCifarnet(2) if transform else None)
    return exp, tx, engine, engine.init_state(exp.init(0), tx, seed=1)


def _same_state(a, b):
    assert a.step == b.step
    for key in a.params:
        assert torch.equal(a.params[key].view(torch.int32), b.params[key].view(torch.int32)), key


@pytest.mark.parametrize("transform", [False, True], ids=["plain", "augmented"])
def test_multi_step_is_k_steps_bit_for_bit(transform):
    k = 4
    exp, tx, engine, state = _fresh(transform=transform)
    _, _, _, twin = _fresh(transform=transform)
    chunk = exp.make_train_iterator(4, seed=2).next_many(k)
    state, many = engine.build_multi_step(exp.loss, tx)(state, engine.put_batches(chunk))
    step = engine.build_step(exp.loss, tx)
    losses = []
    for j in range(k):
        twin, metrics = step(twin, engine.put_batch({key: value[j] for key, value in chunk.items()}))
        losses.append(metrics["total_loss"])
    _same_state(state, twin)
    assert torch.equal(many["total_loss"], torch.stack(losses)) and many["grad_norm"].shape == (k,)
    # one resident batch, k times
    _, _, _, again = _fresh(transform=transform)
    _, _, _, twin = _fresh(transform=transform)
    batch = engine.put_batch({key: value[0] for key, value in chunk.items()})
    again, _ = engine.build_multi_step(exp.loss, tx, repeat_steps=k)(again, batch)
    for _ in range(k):
        twin, _ = step(twin, batch)
    _same_state(again, twin)


def test_sampled_tail_is_an_exact_prefix_of_a_longer_run():
    exp, tx, engine, state = _fresh(transform=True)
    _, _, _, other = _fresh(transform=True)
    data = engine.replicate(exp.train_arrays())
    _, long_run = engine.build_sampled_multi_step(exp.loss, tx, 6, exp.batch_size)(state, data)
    other, tail = engine.build_sampled_multi_step(exp.loss, tx, 2, exp.batch_size)(other, data)
    assert torch.equal(tail["total_loss"], long_run["total_loss"][:2])
    # and the chunking does not matter: 2 + 4 steps are the 6
    _, rest = engine.build_sampled_multi_step(exp.loss, tx, 4, exp.batch_size)(other, data)
    assert torch.equal(torch.cat([tail["total_loss"], rest["total_loss"]]), long_run["total_loss"])


def test_sampled_indices_are_per_worker_and_uniform():
    exp, tx, engine, state = _fresh(n=4)
    index = engine._sample_indices(1, 7, 50, 4000)
    assert index.shape == (4, 4000) and index.dtype == torch.int64
    assert torch.equal(index[:2], RobustEngine(tgars.instantiate("average", 2, 0), 2, device="cpu")
                       ._sample_indices(1, 7, 50, 4000))
    assert not torch.equal(index, engine._sample_indices(1, 8, 50, 4000))
    assert scipy.stats.chisquare(np.bincount(index.numpy().ravel(), minlength=50)).pvalue > 1e-3


def test_experiment_hooks_match_jax():
    for name, args in (("mnist", ["hidden:16"]), ("digits", []), ("digits-conv", []),
                       ("mnistAttack", ["hidden:16"]), ("digitsAttack", [])):
        jexp, texp = jmodels.instantiate(name, args), tmodels.instantiate(name, args)
        jarrays, tarrays = jexp.train_arrays(), texp.train_arrays()
        assert (jarrays is None) == (tarrays is None), name
        if tarrays is not None:
            np.testing.assert_array_equal(tarrays["image"], jarrays["image"])
        assert texp.device_transform() is None and not texp.route_augmentation_to_device(), name
    for args in (["augment:host"], ["augment:device"], ["augment:host", "preprocessing:none"]):
        jexp, texp = jmodels.instantiate("cnnet", args), tmodels.instantiate("cnnet", args)
        assert (jexp.train_arrays() is None) == (texp.train_arrays() is None), args
        assert jexp.route_augmentation_to_device() == texp.route_augmentation_to_device()
        assert texp.augment == jexp.augment and texp.train_arrays() is not None
        assert type(texp.device_transform()).__name__ == {"cifarnet": "DeviceCifarnet"}.get(
            texp.preprocessing, "NoneType")
        if args == ["augment:device"]:
            assert texp.make_train_iterator(2).transform is None


# --------------------------------------------------------------------------- #
# next_many and the prefetcher


def _iterators(transform=None):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(300, 8, 8, 1)).astype(np.float32)
    y = rng.integers(0, 10, size=300).astype(np.int32)
    return [WorkerBatchIterator(x, y, 3, 5, seed=4, transform=transform() if transform else None) for _ in (0, 1)]


@pytest.mark.parametrize("transform", [
    None, lambda: preprocessing.instantiate("inception", seed=1),
    lambda: preprocessing.stateless(lambda bx, by: (bx * np.float32(-2.0), by[:, ::-1].copy())),
], ids=["plain", "stateful", "stateless"])
def test_next_many_is_k_calls_of_next(transform):
    a, b = _iterators(transform)
    many = a.next_many(6)
    assert many["image"].shape == (6, 3, 5, 8, 8, 1)
    for step in range(6):
        ref = next(b)
        np.testing.assert_array_equal(many["image"][step], ref["image"])
        np.testing.assert_array_equal(many["label"][step], ref["label"])
    np.testing.assert_array_equal(next(a)["image"], next(b)["image"])


def test_prefetcher_keeps_the_order_and_ends():
    a, b = _iterators()
    batches = [next(b) for _ in range(5)]

    def five():
        for _ in range(5):
            yield next(a)

    got = list(DevicePrefetcher(five(), lambda batch: _tensors(batch), depth=2))
    assert len(got) == 5
    for g, want in zip(got, batches):
        assert torch.equal(g["image"], torch.as_tensor(want["image"]))


def test_prefetcher_surfaces_a_producer_error():
    def failing():
        yield {"x": np.zeros(2)}
        raise ValueError("the producer broke")

    prefetcher = DevicePrefetcher(failing(), _tensors, depth=2)
    next(prefetcher)
    with pytest.raises(ValueError, match="the producer broke"):
        next(prefetcher)
    with pytest.raises(ValueError):  # and stays terminal
        next(prefetcher)
    prefetcher.close()
    assert not prefetcher._thread.is_alive()


def test_prefetcher_close_mid_stream_leaves_no_thread():
    a, _ = _iterators()
    before = threading.active_count()
    prefetcher = DevicePrefetcher(a, _tensors, depth=2)  # an infinite producer
    next(prefetcher)
    prefetcher.close()
    assert not prefetcher._thread.is_alive() and threading.active_count() == before
    with pytest.raises(StopIteration):
        next(prefetcher)
