"""The zoo's building blocks against flax's, at narrow widths.

Each block of the Inception family (the MobileNet and NASNet blocks and
cells: ``test_torch_zoo_cells.py``, with this file's harness), the shared
layers (``resize_min``, the "SAME" conv at strides 1 and 2, both "SAME"
pools) and the Inception aux head, from the same flax weights
(``params_from_jax``) on inputs drawn from a seed with numpy, at an odd
and an even spatial size: the forward output and the gradient with
respect to the input (of the output's dot product with a fixed random
tensor) within atol 1e-4 + rtol 1e-4 (float32 sums in another order;
GroupNorm statistics over few values).  These carry the whole-net tests of
the families whose nets are marked slow (``test_torch_zoo_families.py``).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

from aggregathor_tpu.models import common as jcommon
from aggregathor_tpu.models import inception as jinc
from aggregathor_tpu_torch.models import common
from aggregathor_tpu_torch.models import inception as inc
from aggregathor_tpu_torch.models.common import params_from_jax

from torch_threads import pinned_threads  # noqa: F401  (a fixture: the xdist worker's intra-op pool)


class _JaxAux(fnn.Module):
    """flax's aux head, called in a module's scope as the nets call it."""

    @fnn.compact
    def __call__(self, x):
        return jinc._aux_head(x, 5, jnp.float32)


class _PortAux(torch.nn.Module):
    def __init__(self, cin):
        super().__init__()
        inc._add_aux_head(self, cin, 5, torch.float32)

    def forward(self, x):
        return inc._aux_head(self, x)


#: name -> (flax module, port module of the input channels, input channels)
BLOCKS = {
    "ConvNorm-3x3/2": (lambda: jinc.ConvNorm(6, (3, 3), 2), lambda c: inc.ConvNorm(c, 6, 3, 2), 4),
    "ConvNorm-1x7": (lambda: jinc.ConvNorm(6, (1, 7)), lambda c: inc.ConvNorm(c, 6, (1, 7)), 4),
    "InceptionBlockV1": (lambda: jinc.InceptionBlockV1(4, (4, 6), (2, 4), 4),
                         lambda c: inc.InceptionBlockV1(c, 4, (4, 6), (2, 4), 4), 6),
    "MixedA": (lambda: jinc._MixedA(8), lambda c: inc._MixedA(c, 8), 6),
    "MixedB": (lambda: jinc._MixedB(8), lambda c: inc._MixedB(c, 8), 6),
    "MixedC": (lambda: jinc._MixedC(), lambda c: inc._MixedC(c), 6),
    "ReductionA": (lambda: jinc._ReductionA(), lambda c: inc._ReductionA(c), 6),
    "ReductionB": (lambda: jinc._ReductionB(), lambda c: inc._ReductionB(c), 6),
    "MixedV2-avg": (lambda: jinc._MixedV2(4, (4, 6), (2, 4), 4, "avg"),
                    lambda c: inc._MixedV2(c, 4, (4, 6), (2, 4), 4, "avg"), 6),
    "MixedV2-max": (lambda: jinc._MixedV2(4, (4, 6), (2, 4), 4, "max"),
                    lambda c: inc._MixedV2(c, 4, (4, 6), (2, 4), 4, "max"), 6),
    "ReductionV2": (lambda: jinc._ReductionV2((4, 6), (2, 4)), lambda c: inc._ReductionV2(c, (4, 6), (2, 4)), 6),
    "V4InceptionA": (lambda: jinc._V4InceptionA(), lambda c: inc._V4InceptionA(c), 6),
    "V4InceptionB": (lambda: jinc._V4InceptionB(), lambda c: inc._V4InceptionB(c), 6),
    "V4InceptionC": (lambda: jinc._V4InceptionC(), lambda c: inc._V4InceptionC(c), 6),
    "V4ReductionA": (lambda: jinc._V4ReductionA(), lambda c: inc._V4ReductionA(c), 6),
    "V4ReductionB": (lambda: jinc._V4ReductionB(), lambda c: inc._V4ReductionB(c), 6),
    "ResBlock": (lambda: jinc._ResBlock(8, 0.17, (((4, (1, 1)),), ((4, (1, 1)), (6, (1, 3)), (4, (3, 1))))),
                 lambda c: inc._ResBlock(c, 0.17, (((4, 1),), ((4, 1), (6, (1, 3)), (4, (3, 1))))), 8),
    "aux-head": (lambda: _JaxAux(), lambda c: _PortAux(c), 6),
}
SIZES = (7, 8)
TOL = 1e-4


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(x), -1, 1)))


def _nhwc(x):
    return np.moveaxis(x.detach().numpy(), 1, -1)


def _compare(jmodule, tmodule, inputs, seed):
    """Forward and input gradients of flax's ``jmodule`` (NHWC) and the
    port's ``tmodule`` (NCHW) on ``inputs`` (NHWC numpy arrays)."""
    params = jax.jit(jmodule.init)(jax.random.PRNGKey(seed), *[jnp.asarray(x) for x in inputs])
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    assert {k: tuple(v.shape) for k, v in tparams.items()} == {k: tuple(v.shape) for k, v in tmodule.named_parameters()}

    def both(params, probe, *xs):
        out = jmodule.apply(params, *xs)
        return out, jax.grad(lambda *ys: jnp.sum(jmodule.apply(params, *ys) * probe),
                             argnums=tuple(range(len(xs))))(*xs)

    shape = jax.eval_shape(jmodule.apply, params, *inputs).shape
    probe = np.random.default_rng(seed + 1).normal(size=shape).astype(np.float32)
    want, jgrads = jax.jit(both)(params, probe, *[jnp.asarray(x) for x in inputs])
    want = np.asarray(want)
    xs = [_nchw(x).requires_grad_(True) for x in inputs]
    out = functional_call(tmodule, tparams, tuple(xs))
    got = out.detach().numpy() if out.dim() == 2 else _nhwc(out)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    tprobe = torch.from_numpy(probe) if out.dim() == 2 else _nchw(probe)
    grads = torch.autograd.grad(torch.sum(out * tprobe), xs)
    for g, jg in zip(grads, jgrads):
        np.testing.assert_allclose(_nhwc(g), np.asarray(jg), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("name", list(BLOCKS))
def test_block_matches_flax(name, size):
    jfactory, tfactory, channels = BLOCKS[name]
    x = np.random.default_rng(size).normal(size=(2, size, size, channels)).astype(np.float32)
    _compare(jfactory(), tfactory(channels), [x], seed=size)


class _JaxOp(fnn.Module):
    """One of the shared layers, on NHWC."""

    op: str
    stride: int = 1

    @fnn.compact
    def __call__(self, x):
        if self.op == "conv":
            return fnn.Conv(5, (3, 3), (self.stride, self.stride), padding="SAME")(x)
        if self.op == "max":
            return fnn.max_pool(x, (3, 3), (self.stride, self.stride), padding="SAME")
        if self.op == "avg":
            return fnn.avg_pool(x, (3, 3), (self.stride, self.stride), padding="SAME")
        if self.op == "avg5/3":
            return fnn.avg_pool(x, (5, 5), (3, 3), padding="SAME")
        return jcommon.resize_min(x, 64 if self.op == "resize64" else 96)


class _PortOp(torch.nn.Module):
    def __init__(self, op, stride=1):
        super().__init__()
        self.op, self.stride = op, stride
        if op == "conv":
            self.Conv_0 = common.Conv(3, 5, 3, stride)

    def forward(self, x):
        if self.op == "conv":
            return self.Conv_0(x)
        if self.op == "max":
            return common.max_pool(x, 3, self.stride, "SAME")
        if self.op == "avg":
            return common.avg_pool(x, 3, self.stride, "SAME")
        if self.op == "avg5/3":
            return common.avg_pool(x, 5, 3, "SAME")
        return common.resize_min(x, 64 if self.op == "resize64" else 96)


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("op, stride", [("conv", 1), ("conv", 2), ("max", 1), ("max", 2), ("avg", 1), ("avg", 2),
                                        ("avg5/3", 3)])
def test_same_layers_match_flax(op, stride, size):
    x = np.random.default_rng(size).normal(size=(2, size, size, 3)).astype(np.float32)
    _compare(_JaxOp(op, stride), _PortOp(op, stride), [x], seed=3)


@pytest.mark.parametrize("target", ["resize64", "resize96"])
def test_resize_min_matches_jax_image_resize(target):
    x = np.random.default_rng(5).normal(size=(2, 32, 32, 3)).astype(np.float32)
    _compare(_JaxOp(target), _PortOp(target), [x], seed=4)
    assert common.resize_min(torch.zeros(1, 3, 64, 64), 64).shape == (1, 3, 64, 64)  # no-op at the size


def test_same_pads_are_xla_rule():
    # 3x3/2: (0, 1) on even inputs, (1, 1) on odd ones; 1x1/2: none
    assert common.same_pads(8, 3, 2) == (0, 1) and common.same_pads(7, 3, 2) == (1, 1)
    assert common.same_pads(32, 1, 2) == (0, 0) and common.same_pads(224, 7, 2) == (2, 3)
    assert common.same_pads(5, 5, 3) == (1, 2) and common.same_pads(5, 3, 1) == (1, 1)
    assert [common.group_count(c) for c in (64, 48, 24, 20, 8, 1, 144)] == [32, 24, 24, 20, 8, 1, 24]
