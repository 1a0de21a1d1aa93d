"""The port's transformer (``models/transformer.py``) against the JAX package's.

Weights come from JAX's ``init_params`` and cross with ``params_from_jax``
(copied, never transposed); inputs are drawn with numpy from a seed; the
JAX side runs jitted (one compile, not one an operation).
Float32 values agree within rtol 2e-5 (the same products summed in another
order); the gradient is taken with float64 parameters on both sides (trap
ah), where the model's own float32 islands (the attention scores and
weights, the RMS variance, the RoPE angles) leave the two paths within rtol
1e-4 and 1e-5 of the leaf's largest entry.

- the bridge: names, shapes and bits round-trip, stage-stacked too; the
  flattened order is JAX's sorted-key pytree order;
- ``rms_norm``, ``rope`` (interleaved pairs), ``_attend_block`` (finite
  mask), the dense ``ring_attention``, ``mlp_block``, ``moe_block``
  (capacity overflow included: the same tokens dropped);
- ``forward_dense``, ``loss_dense`` (dense and MoE) and their gradient;
  ``sharded_to_dense_params``;
- ``synthetic_corpus`` and ``code_corpus`` bit-identical to JAX's; the
  train iterator's windows (``skip``, ``next_many``) and the eval windows;
- the experiment's ``metrics`` and its argument surface.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aggregathor_tpu.models import transformer as jtfm
from aggregathor_tpu_torch import models as tmodels
from aggregathor_tpu_torch.core.flatten import FlatMap
from aggregathor_tpu_torch.models import transformer as tfm
from aggregathor_tpu_torch.models.common import params_from_jax, params_to_jax

JCFG = jtfm.TransformerConfig(vocab_size=17, d_model=16, n_heads=2, n_layers=2)
CFG = tfm.TransformerConfig(vocab_size=17, d_model=16, n_heads=2, n_layers=2)
JMOE = jtfm.TransformerConfig(vocab_size=17, d_model=16, n_heads=2, n_layers=2, n_experts=4, capacity_factor=0.5)
MOE = tfm.TransformerConfig(vocab_size=17, d_model=16, n_heads=2, n_layers=2, n_experts=4, capacity_factor=0.5)
RTOL = 2e-5


@pytest.fixture(autouse=True)
def _two_threads():
    """Two intra-op threads: the tiny model's many small ops stall on a full
    pool when the suite's workers share the cores."""
    previous = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(previous)


@functools.lru_cache(maxsize=None)
def _jax_params(cfg, seed=3, n_stages=1):
    """JAX's weights, drawn once a (config, seed, stages) for the module
    (read-only: ``params_from_jax`` copies)."""
    init = jax.jit(lambda key: jtfm.init_params(cfg, key, n_stages=n_stages))
    out = {k: np.asarray(v) for k, v in init(jax.random.PRNGKey(seed)).items()}
    for value in out.values():
        value.flags.writeable = False
    return out


def _batch(rng, bsz=2, seq=8, vocab=17):
    return {"tokens": rng.integers(0, vocab, size=(bsz, seq)).astype(np.int32),
            "targets": rng.integers(0, vocab, size=(bsz, seq)).astype(np.int32)}


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("n_stages", [1, 2])
def test_bridge_round_trip_and_sorted_flat_order(n_stages):
    jparams = _jax_params(JCFG, n_stages=n_stages)
    params = params_from_jax(jparams)
    assert sorted(params) == sorted(jparams)
    for name, value in jparams.items():
        assert tuple(params[name].shape) == value.shape
        np.testing.assert_array_equal(params[name].numpy(), value)
    back = params_to_jax(params)["params"]
    for name, value in jparams.items():
        np.testing.assert_array_equal(back[name], value)
    # the flattened row is ravel_pytree's: leaves in sorted-key order
    flat_jax = np.asarray(jax.flatten_util.ravel_pytree(jparams)[0])
    flatmap = FlatMap(params)
    assert [entry[0] for entry in flatmap.slices] == sorted(jparams)
    np.testing.assert_array_equal(flatmap.flatten(params).numpy(), flat_jax)
    # the port's own init draws the JAX shapes, norm scales one
    own = tfm.init_params(CFG, torch.Generator().manual_seed(0), n_stages=n_stages)
    assert {k: tuple(v.shape) for k, v in own.items()} == {k: v.shape for k, v in jparams.items()}
    assert torch.all(own["attn_norm"] == 1.0) and torch.all(own["final_norm"] == 1.0)
    assert tfm.param_specs(CFG) == {k: tuple(v) for k, v in jtfm.param_specs(JCFG).items()}
    assert tfm.param_specs(MOE) == {k: tuple(v) for k, v in jtfm.param_specs(JMOE).items()}
    assert tfm.NON_STACKED_LEAVES == jtfm.NON_STACKED_LEAVES


def test_blocks_match_jax(rng):
    x = rng.normal(size=(2, 8, 2, 8)).astype(np.float32)
    scale = rng.normal(size=(8,)).astype(np.float32)
    np.testing.assert_allclose(tfm.rms_norm(_t(x), _t(scale), 1e-5).numpy(),
                               np.asarray(jax.jit(lambda a, b: jtfm.rms_norm(a, b, 1e-5))(x, scale)), rtol=RTOL, atol=1e-6)
    positions = np.arange(3, 11)
    np.testing.assert_allclose(tfm.rope(_t(x), _t(positions), 10000.0).numpy(),
                               np.asarray(jax.jit(lambda a, b: jtfm.rope(a, b, 10000.0))(x, positions)),
                               rtol=RTOL, atol=1e-6)
    # one online-softmax step from a non-trivial carry, a block fully masked
    q, k, v = (rng.normal(size=(2, 4, 2, 8)).astype(np.float32) for _ in range(3))
    num = rng.normal(size=(2, 2, 4, 8)).astype(np.float32)
    den = rng.random(size=(2, 2, 4)).astype(np.float32)
    mx = rng.normal(size=(2, 2, 4)).astype(np.float32)
    for q_pos, k_pos in ((np.arange(4, 8), np.arange(4)), (np.arange(4), np.arange(4, 8))):
        got = tfm._attend_block(_t(q), _t(k), _t(v), _t(q_pos), _t(k_pos), _t(num), _t(den), _t(mx))
        want = jax.jit(jtfm._attend_block)(q, k, v, q_pos, k_pos, num, den, mx)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=1e-6)
    q, k, v = (rng.normal(size=(2, 16, 2, 8)).astype(np.float32) for _ in range(3))
    np.testing.assert_allclose(tfm.ring_attention(_t(q), _t(k), _t(v), torch.arange(16), None).numpy(),
                               np.asarray(jax.jit(lambda a, b, c: jtfm.ring_attention(a, b, c, jnp.arange(16), None))(q, k, v)), rtol=RTOL, atol=1e-6)
    h = rng.normal(size=(2, 8, 16)).astype(np.float32)
    wg, wu = (rng.normal(size=(16, 64)).astype(np.float32) / 4 for _ in range(2))
    wd = rng.normal(size=(64, 16)).astype(np.float32) / 8
    np.testing.assert_allclose(tfm.mlp_block(_t(h), _t(wg), _t(wu), _t(wd), None).numpy(),
                               np.asarray(jax.jit(lambda *a: jtfm.mlp_block(*a, None))(h, wg, wu, wd)), rtol=RTOL, atol=1e-5)


def test_moe_block_matches_jax_with_capacity_overflow(rng):
    p = _jax_params(JMOE)
    h = rng.normal(size=(2, 8, 16)).astype(np.float32)
    args = [p[name][0, 0] for name in ("router", "we_gate", "we_up", "we_down")]
    want_out, want_aux = jax.jit(lambda *a: jtfm.moe_block(*a, JMOE, None))(h, *args)
    got_out, got_aux = tfm.moe_block(_t(h), *map(_t, args), MOE, None)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out), rtol=RTOL, atol=1e-5)
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=RTOL)
    # capacity 0.5 * 16 / 4 = 2 slots an expert for 16 tokens: some tokens
    # overflow, and the same ones come out zero on both sides
    dropped = np.all(np.asarray(want_out).reshape(16, 16) == 0.0, axis=1)
    assert dropped.any() and not dropped.all()
    np.testing.assert_array_equal(np.all(got_out.numpy().reshape(16, 16) == 0.0, axis=1), dropped)


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_forward_loss_and_gradient_match_jax(rng, moe):
    jcfg, cfg = (JMOE, MOE) if moe else (JCFG, CFG)
    jparams = _jax_params(jcfg)
    params = params_from_jax(jparams)
    batch = _batch(rng)
    tbatch = {k: _t(v) for k, v in batch.items()}
    logits, aux = tfm.forward_dense(params, tbatch["tokens"], cfg)
    jlogits, jaux, jloss = jax.jit(
        lambda p, b: jtfm.forward_dense(p, b["tokens"], jcfg) + (jtfm.loss_dense(p, b, jcfg),))(jparams, batch)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=RTOL, atol=1e-5)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=RTOL, atol=1e-7)
    np.testing.assert_allclose(float(tfm.loss_dense(params, tbatch, cfg)), float(jloss), rtol=RTOL)
    # the gradient in float64 on both sides
    import dataclasses

    j64 = dataclasses.replace(jcfg, dtype=jnp.float64)
    c64 = dataclasses.replace(cfg, dtype=torch.float64)
    with jax.enable_x64(True):
        jp64 = {k: jnp.asarray(v, jnp.float64) for k, v in jparams.items()}
        jgrad = jax.jit(jax.grad(lambda p: jtfm.loss_dense(p, batch, j64)))(jp64)
        jgrad = {k: np.asarray(v) for k, v in jgrad.items()}
    p64 = {k: v.to(torch.float64).requires_grad_(True) for k, v in params.items()}
    grads = torch.autograd.grad(tfm.loss_dense(p64, tbatch, c64), list(p64.values()))
    for (name, _), g in zip(p64.items(), grads):
        want = jgrad[name]
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-4, atol=1e-5 * np.abs(want).max(), err_msg=name)


def test_sharded_to_dense_params_collapses_the_stage_dim():
    jparams = _jax_params(JCFG, n_stages=2)
    from aggregathor_tpu import models as jmodels

    exp, jexp = tmodels.instantiate("transformer", ["corpus:2048"]), jmodels.instantiate("transformer", ["corpus:2048"])
    got = exp.sharded_to_dense_params(params_from_jax(jparams))
    want = jexp.sharded_to_dense_params(jparams)
    for name, value in want.items():
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(value))


def test_corpora_are_bit_identical():
    np.testing.assert_array_equal(tfm.synthetic_corpus(17, 3000, seed=5), jtfm.synthetic_corpus(17, 3000, seed=5))
    np.testing.assert_array_equal(tfm.code_corpus(200_000), jtfm.code_corpus(200_000))


def test_experiment_windows_metrics_and_arguments():
    from aggregathor_tpu import models as jmodels

    args = ["vocab:17", "d-model:16", "heads:2", "layers:2", "seq:8", "batch-size:2", "corpus:2048"]
    exp, jexp = tmodels.instantiate("transformer", args), jmodels.instantiate("transformer", args)
    assert exp.cfg.vocab_size == jexp.cfg.vocab_size == 17 and exp.synthetic and jexp.synthetic
    np.testing.assert_array_equal(exp.corpus, jexp.corpus)
    ours, theirs = exp.make_train_iterator(3, seed=7), jexp.make_train_iterator(3, seed=7)
    for _ in range(2):
        mine, want = next(ours), next(theirs)
        for name in ("tokens", "targets"):
            np.testing.assert_array_equal(mine[name], want[name])
    ours.skip(2)
    chunk = ours.next_many(2)
    for step in range(4):
        want = next(theirs)
        if step >= 2:
            for name in ("tokens", "targets"):
                np.testing.assert_array_equal(chunk[name][step - 2], want[name])
    for mine, want in zip(exp.make_eval_iterator(3), jexp.make_eval_iterator(3)):
        np.testing.assert_array_equal(mine["tokens"], want["tokens"])
    code = tmodels.instantiate("transformer", ["corpus-source:code", "corpus:100000", "seq:16"])
    jcode = jmodels.instantiate("transformer", ["corpus-source:code", "corpus:100000", "seq:16"])
    assert code.cfg.vocab_size == 256 and not code.synthetic
    np.testing.assert_array_equal(code.eval_corpus, jcode.eval_corpus)
    # metrics from the same weights and batch
    jparams = jax.jit(jexp.init)(jax.random.PRNGKey(1))
    batch = next(jexp.make_train_iterator(1, seed=0))
    batch = {k: v[0] for k, v in batch.items()}
    want = jax.jit(jexp.metrics)(jparams, batch)
    got = exp.metrics(params_from_jax({k: np.asarray(v) for k, v in jparams.items()}),
                      {k: _t(v) for k, v in batch.items()})
    for name in ("accuracy", "nll"):
        np.testing.assert_allclose(float(got[name][0]), float(want[name][0]), rtol=RTOL)
        assert float(got[name][1]) == float(want[name][1])
