"""Shared pieces of the image models: initialization, the flax weight bridge
and the layers of the model zoo.

``params_from_jax`` turns a flax parameter tree (given as numpy arrays, with
or without its top-level ``"params"`` key) into the port's parameter dict;
``params_to_jax`` is its inverse.  Names and layouts follow the bridge in
``core/flatten.py``: ``<module>/kernel`` HWIO <-> ``<module>.weight`` OIHW,
``<module>/kernel`` (in, out) <-> ``<module>.weight`` (out, in),
``<module>/scale`` <-> ``<module>.weight``, ``<module>/bias`` <-> ``<module>.bias``.

The zoo's layers (``Conv``, ``GroupNorm``, ``LayerNorm``, ``Dense`` and the
pools) are flax's on NCHW tensors, with the traps of the translation:

- "SAME" is XLA's rule, from the runtime size: ``total = max((out - 1) s +
  k - in, 0)`` split ``lo = total // 2``, ``hi = total - lo``, so a 3x3/2
  conv pads (0, 1) on an even input and (1, 1) on an odd one (torch's
  ``padding=1`` is wrong on even inputs, ``padding="same"`` refuses
  stride 2);
- ``max_pool`` pads with -inf; ``avg_pool`` pads zeros and divides by the
  whole window (flax's ``count_include_pad=True``);
- ``GroupNorm`` and ``LayerNorm`` have eps 1e-6; ``LayerNorm`` normalises
  the channel axis only (the last axis of NHWC);
- a depthwise kernel is HWIO ``(h, w, 1, C)`` in flax and ``(C, 1, h, w)``
  here, which the bridge's transpose gives;
- in ``bfloat16`` compute the inputs, kernels and biases are cast to
  bfloat16, a norm's statistics are float32 with a bfloat16 result, the
  parameters stay float32 (the logits layer is a float32 ``Dense``).
"""

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.flatten import jax_leaf

#: the compute dtypes experiments accept (parameters always stay float32)
COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def check_dtype(name):
    """The torch dtype of a ``dtype:`` experiment arg, or a UserException
    (never a silent float32)."""
    from ..utils import UserException

    if name not in COMPUTE_DTYPES:
        raise UserException("Unknown dtype %r (accepted: %s)" % (name, ", ".join(sorted(COMPUTE_DTYPES))))
    return COMPUTE_DTYPES[name]


#: flax's default kernel init is lecun_normal: a normal truncated at two
#: standard deviations, rescaled so the variance is 1/fan_in
_TRUNCATED_STDDEV = 0.87962566103423978


def init_params(model, generator):
    """A fresh parameter dict for ``model``, drawn from ``generator`` the way
    flax initializes the JAX models (not the same numbers): kernels
    lecun-normal, biases zero, norm scales one."""
    params = {}
    for name, p in model.named_parameters():
        value = torch.empty(p.shape, dtype=torch.float32)
        path, _ = jax_leaf(name, p.dim())
        if path[-1] == "kernel":
            fan_in = p[0].numel()  # (out, in[, h, w]): everything but the output axis
            std = math.sqrt(1.0 / fan_in) / _TRUNCATED_STDDEV
            torch.nn.init.trunc_normal_(value, std=std, a=-2.0 * std, b=2.0 * std, generator=generator)
        elif path[-1] == "scale":
            value.fill_(1.0)
        else:
            value.zero_()
        params[name] = value
    return params


def _walk(tree, prefix=()):
    for key in sorted(tree):
        value = tree[key]
        if isinstance(value, dict) or hasattr(value, "items"):
            yield from _walk(dict(value), prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(value)


def params_from_jax(tree):
    """flax parameters (nested dict of numpy arrays) -> {torch name: tensor}."""
    tree = dict(tree)
    if set(tree) == {"params"}:
        tree = dict(tree["params"])
    params = {}
    for path, value in _walk(tree):
        module, leaf = ".".join(path[:-1]), path[-1]
        if leaf == "kernel" and value.ndim == 4:
            value = value.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        elif leaf == "kernel" and value.ndim == 2:
            value = value.T  # (in, out) -> (out, in)
        elif leaf not in ("scale", "bias"):
            raise ValueError("no torch counterpart for flax leaf %r" % "/".join(path))
        name = module + "." + ("bias" if leaf == "bias" else "weight")
        params[name] = torch.tensor(np.ascontiguousarray(value), dtype=torch.float32)
    return params


def params_to_jax(params):
    """{torch name: tensor} -> flax parameters {"params": nested numpy dict}."""
    tree = {}
    for name, tensor in params.items():
        path, perm = jax_leaf(name, tensor.dim())
        value = tensor.detach().cpu()
        value = value.permute(perm) if perm else value
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.ascontiguousarray(value.numpy())
    return {"params": tree}


# --------------------------------------------------------------------------- #
# the zoo's layers


def _pair(value):
    return tuple(value) if isinstance(value, (tuple, list)) else (value, value)


def same_pads(size, kernel, stride):
    """XLA's "SAME" padding ``(lo, hi)`` of one spatial axis of ``size``."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def pad_same(x, kernel, stride, value=0.0):
    """``x`` (N, C, H, W) padded as XLA's "SAME" pads it for ``kernel`` and
    ``stride`` (pairs), with ``value``."""
    top, bottom = same_pads(x.shape[-2], kernel[0], stride[0])
    left, right = same_pads(x.shape[-1], kernel[1], stride[1])
    if top or bottom or left or right:
        x = F.pad(x, (left, right, top, bottom), value=value)
    return x


def max_pool(x, window, stride, padding="VALID"):
    """flax ``max_pool`` on NCHW: "SAME" pads with -inf."""
    window, stride = _pair(window), _pair(stride)
    if padding == "SAME":
        x = pad_same(x, window, stride, float("-inf"))
    return F.max_pool2d(x, window, stride)


def avg_pool(x, window, stride, padding="VALID"):
    """flax ``avg_pool`` on NCHW: "SAME" pads zeros and divides every window
    by its full size (``count_include_pad=True``)."""
    window, stride = _pair(window), _pair(stride)
    if padding == "SAME":
        x = pad_same(x, window, stride)
    return F.avg_pool2d(x, window, stride)


def resize_min(x, min_size):
    """flax ``resize_min`` on NCHW: a bilinear upsample to ``min_size`` square
    (half-pixel centres, no antialiasing: ``jax.image.resize`` upsampling)
    when the image is smaller on either side."""
    if x.shape[-2] < min_size or x.shape[-1] < min_size:
        x = F.interpolate(x, size=(min_size, min_size), mode="bilinear", align_corners=False, antialias=False)
    return x


def group_count(channels):
    """The largest group count <= 32 that divides ``channels``."""
    groups = min(32, channels)
    while channels % groups:
        groups -= 1
    return groups


def global_mean(x):
    """The global average pool: the mean over H and W."""
    return x.mean(dim=(-2, -1))


#: the convs ((kh, kw), (sh, sw), in, out) whose weight gradient the card
#: takes in float64 (``ConvF64WeightGrad``), where cuDNN's float32 one errs
#: beyond 1e-5 of the largest entry: ResNet-50's 3x3/1 64 -> 64 at 32x32
#: (2.8e-05 on the H100, n = 32 workers of 16 images) and 128 -> 128 at
#: 16x16 (1.29e-05); its other conv shapes hold (``chip_smoke.py``'s zoo
#: phase measures every one)
F64_WEIGHT_GRAD_SHAPES = frozenset({((3, 3), (1, 1), 64, 64), ((3, 3), (1, 1), 128, 128)})


def conv_weight_grad_f64(x, grad_out, weight, stride=(1, 1), padding=(0, 0), groups=1):
    """The weight gradient of ``F.conv2d(x, weight, None, stride, padding,
    1, groups)`` computed in float64 from the operands, rounded to
    ``weight``'s dtype."""
    return torch.ops.aten.convolution_backward(
        grad_out.double(), x.double(), weight.double(), None, list(stride), list(padding), [1, 1], False, [0, 0],
        groups, [False, True, False])[1].to(weight.dtype)


class ConvF64WeightGrad(torch.autograd.Function):
    """``conv2d`` whose weight gradient is computed in float64 from the
    float32 operands; the forward and the input gradient are cuDNN's
    float32 ones.  vmap batches it by running these bodies under vmap."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x, weight, bias, stride, padding, groups):
        return F.conv2d(x, weight, bias, stride, padding, 1, groups)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, weight, _, stride, padding, groups = inputs
        ctx.save_for_backward(x, weight)
        ctx.conv = (list(stride), list(padding), groups)

    @staticmethod
    def backward(ctx, grad_out):
        x, weight = ctx.saved_tensors
        stride, padding, groups = ctx.conv
        grad_x = grad_w = grad_b = None
        if ctx.needs_input_grad[0]:
            grad_x = torch.ops.aten.convolution_backward(
                grad_out, x, weight, None, stride, padding, [1, 1], False, [0, 0], groups, [True, False, False])[0]
        if ctx.needs_input_grad[1]:
            grad_w = conv_weight_grad_f64(x, grad_out, weight, stride, padding, groups)
        if ctx.needs_input_grad[2]:
            grad_b = grad_out.sum((0, 2, 3))
        return grad_x, grad_w, grad_b, None, None, None


def conv2d(x, weight, bias, stride, padding, groups=1, f64_weight_grad=False):
    """``F.conv2d`` with flax's padding: ``padding`` "SAME" (XLA's rule on
    the runtime size: symmetric pads go to the conv, asymmetric ones to an
    explicit zero pad first), "VALID", or ((top, bottom), (left, right)).
    ``f64_weight_grad`` on a CUDA float32 input takes the weight gradient
    in float64 (``ConvF64WeightGrad``)."""
    kernel = tuple(weight.shape[-2:])
    if padding == "SAME":
        pads = (same_pads(x.shape[-2], kernel[0], stride[0]), same_pads(x.shape[-1], kernel[1], stride[1]))
    elif padding == "VALID":
        pads = ((0, 0), (0, 0))
    else:
        pads = padding
    if pads[0][0] == pads[0][1] and pads[1][0] == pads[1][1]:
        sym = (pads[0][0], pads[1][0])
    else:
        x = F.pad(x, (pads[1][0], pads[1][1], pads[0][0], pads[0][1]))
        sym = (0, 0)
    if f64_weight_grad and x.device.type == "cuda" and x.dtype == torch.float32:
        return ConvF64WeightGrad.apply(x, weight, bias, stride, sym, groups)
    return F.conv2d(x, weight, bias, stride, sym, 1, groups)


class Conv(nn.Module):
    """flax ``nn.Conv`` on NCHW: ``kernel`` and ``stride`` ints or pairs,
    ``padding`` "SAME", "VALID" or ((top, bottom), (left, right)),
    ``groups`` flax's ``feature_group_count``, ``dtype`` the compute dtype."""

    def __init__(self, cin, cout, kernel, stride=1, padding="SAME", groups=1, bias=True, dtype=torch.float32):
        super().__init__()
        kh, kw = _pair(kernel)
        self.stride = _pair(stride)
        self.padding = padding
        self.groups = groups
        self.dtype = dtype
        self.f64_weight_grad = ((kh, kw), self.stride, cin, cout) in F64_WEIGHT_GRAD_SHAPES
        self.weight = nn.Parameter(torch.empty(cout, cin // groups, kh, kw))
        if bias:
            self.bias = nn.Parameter(torch.empty(cout))
        else:
            self.register_parameter("bias", None)

    def forward(self, x):
        weight, bias = self.weight, self.bias
        if self.dtype != torch.float32:
            x, weight = x.to(self.dtype), weight.to(self.dtype)
            bias = None if bias is None else bias.to(self.dtype)
        return conv2d(x, weight, bias, self.stride, self.padding, self.groups, self.f64_weight_grad)


class GroupNorm(nn.GroupNorm):
    """flax ``nn.GroupNorm`` (eps 1e-6); ``groups`` None takes the largest
    count <= 32 that divides the channels.  Statistics in float32 (float64
    for a float64 input), the result in the input's dtype."""

    def __init__(self, channels, groups=None):
        super().__init__(group_count(channels) if groups is None else groups, channels, eps=1e-6)

    def forward(self, x):
        if x.dtype in (torch.float32, torch.float64):
            return super().forward(x)
        return F.group_norm(x.to(torch.float32), self.num_groups, self.weight, self.bias, self.eps).to(x.dtype)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` (eps 1e-6) over the channel axis of NCHW."""

    def __init__(self, channels):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        y = x.to(torch.promote_types(x.dtype, torch.float32)).movedim(1, -1)
        y = F.layer_norm(y, (x.shape[1],), self.weight.to(y.dtype), self.bias.to(y.dtype), 1e-6)
        return y.movedim(-1, 1).to(x.dtype)


class Dense(nn.Linear):
    """flax ``nn.Dense``: computes in ``dtype`` (the input cast to it)."""

    def __init__(self, cin, cout, dtype=torch.float32):
        super().__init__(cin, cout)
        self.dtype = dtype

    def forward(self, x):
        if self.dtype == torch.float32:
            return F.linear(x.to(torch.float32), self.weight, self.bias)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), self.bias.to(self.dtype))


def flatten_nhwc(x):
    """(N, C, H, W) -> (N, H * W * C), in flax's NHWC flattening order."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


def to_nchw(x, dtype=None):
    """An NHWC image batch as NCHW, in ``dtype`` when given (else its own)."""
    x = x.permute(0, 3, 1, 2)
    return x if dtype is None else x.to(dtype)
