"""Inception v1 (GoogLeNet), v2 (BN-Inception), v3, v4 and Inception-ResNet-v2.

Counterpart of ``aggregathor_tpu/models/inception.py`` on NCHW tensors,
with the same module and parameter names: GroupNorm in place of
BatchNorm, "SAME" padding by XLA's rule (the stride-2 reductions pad
asymmetrically on even sizes), the pools "SAME" (max with -inf, average
over the whole window, zeros included), images below the stem's minimum
upsampled bilinearly.  The nets of ``AUX_CAPABLE`` build their auxiliary
head when made with ``aux=True`` (flax's ``init(..., with_aux=True)``),
and ``forward(x, with_aux=True)`` returns ``(logits, aux_logits)``.
Each block knows its output channels (``out``): flax infers a layer's
input channels, torch needs them at construction.
"""

import torch
import torch.nn.functional as F
from torch import nn

from .common import Conv, Dense, GroupNorm, avg_pool, global_mean, max_pool, resize_min, to_nchw


class ConvNorm(nn.Module):
    """Conv (no bias) + GroupNorm + ReLU, the inception unit."""

    def __init__(self, cin, features, kernel, stride=1, dtype=torch.float32):
        super().__init__()
        self.conv = Conv(cin, features, kernel, stride, bias=False, dtype=dtype)
        self.norm = GroupNorm(features)
        self.out = features

    def forward(self, x):
        return F.relu(self.norm(self.conv(x)))


def _cat(*xs):
    return torch.cat(xs, dim=1)


class InceptionBlockV1(nn.Module):
    """The 4-branch mixed block (1x1 / 3x3 / 5x5 / pool-proj)."""

    def __init__(self, cin, b0, b1, b2, b3, dtype=torch.float32):
        super().__init__()
        self.b0 = ConvNorm(cin, b0, 1, dtype=dtype)
        self.b1_reduce = ConvNorm(cin, b1[0], 1, dtype=dtype)
        self.b1 = ConvNorm(b1[0], b1[1], 3, dtype=dtype)
        self.b2_reduce = ConvNorm(cin, b2[0], 1, dtype=dtype)
        self.b2 = ConvNorm(b2[0], b2[1], 5, dtype=dtype)
        self.b3 = ConvNorm(cin, b3, 1, dtype=dtype)
        self.out = b0 + b1[1] + b2[1] + b3

    def forward(self, x):
        return _cat(self.b0(x), self.b1(self.b1_reduce(x)), self.b2(self.b2_reduce(x)),
                    self.b3(max_pool(x, 3, 1, "SAME")))


#: GoogLeNet's mixed-block channel table (inception 3a..5b)
_V1_BLOCKS = [
    (64, (96, 128), (16, 32), 32),
    (128, (128, 192), (32, 96), 64),
    "pool",
    (192, (96, 208), (16, 48), 64),
    (160, (112, 224), (24, 64), 64),
    (128, (128, 256), (24, 64), 64),
    (112, (144, 288), (32, 64), 64),
    (256, (160, 320), (32, 128), 128),
    "pool",
    (256, (160, 320), (32, 128), 128),
    (384, (192, 384), (48, 128), 128),
]


class InceptionV1(nn.Module):
    """GoogLeNet; the aux head after 4d (block 6), as GoogLeNet's second."""

    def __init__(self, classes=1000, channels=3, dtype=torch.float32, aux=False, min_size=64):
        super().__init__()
        self.dtype, self.min_size = dtype, min_size
        self.stem1 = ConvNorm(channels, 64, 7, 2, dtype)
        self.stem2 = ConvNorm(64, 64, 1, dtype=dtype)
        self.stem3 = ConvNorm(64, 192, 3, dtype=dtype)
        cin = 192
        for i, spec in enumerate(_V1_BLOCKS):
            if spec != "pool":
                block = InceptionBlockV1(cin, *spec, dtype=dtype)
                setattr(self, "mixed_%d" % i, block)
                cin = block.out
                if i == 6 and aux:
                    self.aux_proj = ConvNorm(cin, 128, 1, dtype=dtype)
                    self.aux_logits = Dense(128, classes)
        self.logits = Dense(cin, classes)

    def forward(self, x, with_aux=False):
        x = resize_min(to_nchw(x), self.min_size).to(self.dtype)
        x = max_pool(self.stem1(x), 3, 2, "SAME")
        x = max_pool(self.stem3(self.stem2(x)), 3, 2, "SAME")
        aux = None
        for i, spec in enumerate(_V1_BLOCKS):
            if spec == "pool":
                x = max_pool(x, 3, 2, "SAME")
                continue
            x = getattr(self, "mixed_%d" % i)(x)
            if i == 6 and with_aux:
                a = self.aux_proj(avg_pool(x, 5, 3, "SAME"))
                aux = self.aux_logits(global_mean(a))
        logits = self.logits(global_mean(x))
        return (logits, aux) if with_aux else logits


def _add_aux_head(net, cin, classes, dtype):
    """The 17x17 auxiliary-logits head of v3, v4 and Inception-ResNet-v2,
    whose layers attach to the net itself, as in flax (``aux_proj1``,
    ``aux_proj2``, ``aux_logits``)."""
    net.aux_proj1 = ConvNorm(cin, 128, 1, dtype=dtype)
    net.aux_proj2 = ConvNorm(128, 768, 5, dtype=dtype)
    net.aux_logits = Dense(768, classes)


def _aux_head(net, x):
    a = net.aux_proj1(avg_pool(x, 5, 3, "SAME"))
    return net.aux_logits(global_mean(net.aux_proj2(a)))


class _MixedA(nn.Module):
    """35x35 block: 1x1 / 5x5 / double-3x3 / pool branches."""

    def __init__(self, cin, pool_features, dtype=torch.float32):
        super().__init__()
        self.b0 = ConvNorm(cin, 64, 1, dtype=dtype)
        self.b1_1 = ConvNorm(cin, 48, 1, dtype=dtype)
        self.b1_2 = ConvNorm(48, 64, 5, dtype=dtype)
        self.b2_1 = ConvNorm(cin, 64, 1, dtype=dtype)
        self.b2_2 = ConvNorm(64, 96, 3, dtype=dtype)
        self.b2_3 = ConvNorm(96, 96, 3, dtype=dtype)
        self.b3 = ConvNorm(cin, pool_features, 1, dtype=dtype)
        self.out = 64 + 64 + 96 + pool_features

    def forward(self, x):
        return _cat(self.b0(x), self.b1_2(self.b1_1(x)), self.b2_3(self.b2_2(self.b2_1(x))),
                    self.b3(avg_pool(x, 3, 1, "SAME")))


class _MixedB(nn.Module):
    """17x17 block: factorized 7x7 branches."""

    def __init__(self, cin, c, dtype=torch.float32):
        super().__init__()
        self.b0 = ConvNorm(cin, 192, 1, dtype=dtype)
        self.b1_1 = ConvNorm(cin, c, 1, dtype=dtype)
        self.b1_2 = ConvNorm(c, c, (1, 7), dtype=dtype)
        self.b1_3 = ConvNorm(c, 192, (7, 1), dtype=dtype)
        self.b2_1 = ConvNorm(cin, c, 1, dtype=dtype)
        self.b2_2 = ConvNorm(c, c, (7, 1), dtype=dtype)
        self.b2_3 = ConvNorm(c, c, (1, 7), dtype=dtype)
        self.b2_4 = ConvNorm(c, c, (7, 1), dtype=dtype)
        self.b2_5 = ConvNorm(c, 192, (1, 7), dtype=dtype)
        self.b3 = ConvNorm(cin, 192, 1, dtype=dtype)
        self.out = 4 * 192

    def forward(self, x):
        b1 = self.b1_3(self.b1_2(self.b1_1(x)))
        b2 = self.b2_5(self.b2_4(self.b2_3(self.b2_2(self.b2_1(x)))))
        return _cat(self.b0(x), b1, b2, self.b3(avg_pool(x, 3, 1, "SAME")))


class _MixedC(nn.Module):
    """8x8 block: expanded filter-bank outputs."""

    def __init__(self, cin, dtype=torch.float32):
        super().__init__()
        self.b0 = ConvNorm(cin, 320, 1, dtype=dtype)
        self.b1_1 = ConvNorm(cin, 384, 1, dtype=dtype)
        self.b1_2a = ConvNorm(384, 384, (1, 3), dtype=dtype)
        self.b1_2b = ConvNorm(384, 384, (3, 1), dtype=dtype)
        self.b2_1 = ConvNorm(cin, 448, 1, dtype=dtype)
        self.b2_2 = ConvNorm(448, 384, 3, dtype=dtype)
        self.b2_3a = ConvNorm(384, 384, (1, 3), dtype=dtype)
        self.b2_3b = ConvNorm(384, 384, (3, 1), dtype=dtype)
        self.b3 = ConvNorm(cin, 192, 1, dtype=dtype)
        self.out = 320 + 768 + 768 + 192

    def forward(self, x):
        b1 = self.b1_1(x)
        b1 = _cat(self.b1_2a(b1), self.b1_2b(b1))
        b2 = self.b2_2(self.b2_1(x))
        b2 = _cat(self.b2_3a(b2), self.b2_3b(b2))
        return _cat(self.b0(x), b1, b2, self.b3(avg_pool(x, 3, 1, "SAME")))


class _ReductionA(nn.Module):
    def __init__(self, cin, dtype=torch.float32):
        super().__init__()
        self.b0 = ConvNorm(cin, 384, 3, 2, dtype)
        self.b1_1 = ConvNorm(cin, 64, 1, dtype=dtype)
        self.b1_2 = ConvNorm(64, 96, 3, dtype=dtype)
        self.b1_3 = ConvNorm(96, 96, 3, 2, dtype)
        self.out = 384 + 96 + cin

    def forward(self, x):
        return _cat(self.b0(x), self.b1_3(self.b1_2(self.b1_1(x))), max_pool(x, 3, 2, "SAME"))


class _ReductionB(nn.Module):
    def __init__(self, cin, dtype=torch.float32):
        super().__init__()
        self.b0_1 = ConvNorm(cin, 192, 1, dtype=dtype)
        self.b0_2 = ConvNorm(192, 320, 3, 2, dtype)
        self.b1_1 = ConvNorm(cin, 192, 1, dtype=dtype)
        self.b1_2 = ConvNorm(192, 192, (1, 7), dtype=dtype)
        self.b1_3 = ConvNorm(192, 192, (7, 1), dtype=dtype)
        self.b1_4 = ConvNorm(192, 192, 3, 2, dtype)
        self.out = 320 + 192 + cin

    def forward(self, x):
        b1 = self.b1_4(self.b1_3(self.b1_2(self.b1_1(x))))
        return _cat(self.b0_2(self.b0_1(x)), b1, max_pool(x, 3, 2, "SAME"))


class InceptionV3(nn.Module):
    def __init__(self, classes=1000, channels=3, dtype=torch.float32, aux=False, min_size=96):
        super().__init__()
        self.dtype, self.min_size = dtype, min_size
        self.stem1 = ConvNorm(channels, 32, 3, 2, dtype)
        self.stem2 = ConvNorm(32, 32, 3, dtype=dtype)
        self.stem3 = ConvNorm(32, 64, 3, dtype=dtype)
        self.stem4 = ConvNorm(64, 80, 1, dtype=dtype)
        self.stem5 = ConvNorm(80, 192, 3, dtype=dtype)
        self.mixed_5b = _MixedA(192, 32, dtype)
        self.mixed_5c = _MixedA(self.mixed_5b.out, 64, dtype)
        self.mixed_5d = _MixedA(self.mixed_5c.out, 64, dtype)
        self.mixed_6a = _ReductionA(self.mixed_5d.out, dtype)
        self.mixed_6b = _MixedB(self.mixed_6a.out, 128, dtype)
        self.mixed_6c = _MixedB(self.mixed_6b.out, 160, dtype)
        self.mixed_6d = _MixedB(self.mixed_6c.out, 160, dtype)
        self.mixed_6e = _MixedB(self.mixed_6d.out, 192, dtype)
        if aux:
            _add_aux_head(self, self.mixed_6e.out, classes, dtype)
        self.mixed_7a = _ReductionB(self.mixed_6e.out, dtype)
        self.mixed_7b = _MixedC(self.mixed_7a.out, dtype)
        self.mixed_7c = _MixedC(self.mixed_7b.out, dtype)
        self.logits = Dense(self.mixed_7c.out, classes)

    def forward(self, x, with_aux=False):
        x = resize_min(to_nchw(x), self.min_size).to(self.dtype)
        x = max_pool(self.stem3(self.stem2(self.stem1(x))), 3, 2, "SAME")
        x = max_pool(self.stem5(self.stem4(x)), 3, 2, "SAME")
        for name in ("mixed_5b", "mixed_5c", "mixed_5d", "mixed_6a", "mixed_6b", "mixed_6c", "mixed_6d", "mixed_6e"):
            x = getattr(self, name)(x)
        aux = _aux_head(self, x) if with_aux else None
        x = self.mixed_7c(self.mixed_7b(self.mixed_7a(x)))
        logits = self.logits(global_mean(x))
        return (logits, aux) if with_aux else logits


class _MixedV2(nn.Module):
    """BN-Inception 4-branch block: 1x1 / 3x3 / double-3x3 / pool-proj,
    ``pool`` avg or max."""

    def __init__(self, cin, b0, b1, b2, b3, pool="avg", dtype=torch.float32):
        super().__init__()
        self.pool = pool
        self.b0 = ConvNorm(cin, b0, 1, dtype=dtype)
        self.b1_reduce = ConvNorm(cin, b1[0], 1, dtype=dtype)
        self.b1 = ConvNorm(b1[0], b1[1], 3, dtype=dtype)
        self.b2_reduce = ConvNorm(cin, b2[0], 1, dtype=dtype)
        self.b2_1 = ConvNorm(b2[0], b2[1], 3, dtype=dtype)
        self.b2_2 = ConvNorm(b2[1], b2[1], 3, dtype=dtype)
        self.b3 = ConvNorm(cin, b3, 1, dtype=dtype)
        self.out = b0 + b1[1] + b2[1] + b3

    def forward(self, x):
        pooled = (avg_pool if self.pool == "avg" else max_pool)(x, 3, 1, "SAME")
        return _cat(self.b0(x), self.b1(self.b1_reduce(x)), self.b2_2(self.b2_1(self.b2_reduce(x))), self.b3(pooled))


class _ReductionV2(nn.Module):
    """BN-Inception stride-2 block (Mixed_4a / Mixed_5a)."""

    def __init__(self, cin, b0, b1, dtype=torch.float32):
        super().__init__()
        self.b0_reduce = ConvNorm(cin, b0[0], 1, dtype=dtype)
        self.b0 = ConvNorm(b0[0], b0[1], 3, 2, dtype)
        self.b1_reduce = ConvNorm(cin, b1[0], 1, dtype=dtype)
        self.b1_1 = ConvNorm(b1[0], b1[1], 3, dtype=dtype)
        self.b1_2 = ConvNorm(b1[1], b1[1], 3, 2, dtype)
        self.out = b0[1] + b1[1] + cin

    def forward(self, x):
        return _cat(self.b0(self.b0_reduce(x)), self.b1_2(self.b1_1(self.b1_reduce(x))), max_pool(x, 3, 2, "SAME"))


#: slim inception_v2's mixed-block channel table (Mixed_3b .. Mixed_5c)
_V2_BLOCKS = [
    (64, (64, 64), (64, 96), 32, "avg"),
    (64, (64, 96), (64, 96), 64, "avg"),
    "reduce_4a",
    (224, (64, 96), (96, 128), 128, "avg"),
    (192, (96, 128), (96, 128), 128, "avg"),
    (160, (128, 160), (128, 160), 96, "avg"),
    (96, (128, 192), (160, 192), 96, "avg"),
    "reduce_5a",
    (352, (192, 320), (160, 224), 128, "avg"),
    (352, (192, 320), (192, 224), 128, "max"),
]


class InceptionV2(nn.Module):
    """BN-Inception: the v1 topology with double-3x3 branches and slim's
    depthwise-separable 7x7/2 stem (8 filters an input channel, then 1x1)."""

    def __init__(self, classes=1000, channels=3, dtype=torch.float32, min_size=64):
        super().__init__()
        self.dtype, self.min_size = dtype, min_size
        self.stem_dw = Conv(channels, channels * 8, 7, 2, groups=channels, bias=False, dtype=dtype)
        self.stem_pw = Conv(channels * 8, 64, 1, bias=False, dtype=dtype)
        self.stem_norm = GroupNorm(64)
        self.stem2 = ConvNorm(64, 64, 1, dtype=dtype)
        self.stem3 = ConvNorm(64, 192, 3, dtype=dtype)
        cin = 192
        self.blocks = []
        for i, spec in enumerate(_V2_BLOCKS):
            if spec == "reduce_4a":
                name, block = "mixed_4a", _ReductionV2(cin, (128, 160), (64, 96), dtype)
            elif spec == "reduce_5a":
                name, block = "mixed_5a", _ReductionV2(cin, (128, 192), (192, 256), dtype)
            else:
                name, block = "mixed_%d" % i, _MixedV2(cin, *spec, dtype=dtype)
            setattr(self, name, block)
            self.blocks.append(name)
            cin = block.out
        self.logits = Dense(cin, classes)

    def forward(self, x):
        x = resize_min(to_nchw(x), self.min_size).to(self.dtype)
        x = F.relu(self.stem_norm(self.stem_pw(self.stem_dw(x))))
        x = max_pool(x, 3, 2, "SAME")
        x = max_pool(self.stem3(self.stem2(x)), 3, 2, "SAME")
        for name in self.blocks:
            x = getattr(self, name)(x)
        return self.logits(global_mean(x))


class _V4InceptionA(nn.Module):
    def __init__(self, cin, dtype=torch.float32):
        super().__init__()
        self.b0 = ConvNorm(cin, 96, 1, dtype=dtype)
        self.b1_1 = ConvNorm(cin, 64, 1, dtype=dtype)
        self.b1_2 = ConvNorm(64, 96, 3, dtype=dtype)
        self.b2_1 = ConvNorm(cin, 64, 1, dtype=dtype)
        self.b2_2 = ConvNorm(64, 96, 3, dtype=dtype)
        self.b2_3 = ConvNorm(96, 96, 3, dtype=dtype)
        self.b3 = ConvNorm(cin, 96, 1, dtype=dtype)
        self.out = 4 * 96

    def forward(self, x):
        return _cat(self.b0(x), self.b1_2(self.b1_1(x)), self.b2_3(self.b2_2(self.b2_1(x))),
                    self.b3(avg_pool(x, 3, 1, "SAME")))


class _V4ReductionA(nn.Module):
    def __init__(self, cin, dtype=torch.float32):
        super().__init__()
        self.b0 = ConvNorm(cin, 384, 3, 2, dtype)
        self.b1_1 = ConvNorm(cin, 192, 1, dtype=dtype)
        self.b1_2 = ConvNorm(192, 224, 3, dtype=dtype)
        self.b1_3 = ConvNorm(224, 256, 3, 2, dtype)
        self.out = 384 + 256 + cin

    def forward(self, x):
        return _cat(self.b0(x), self.b1_3(self.b1_2(self.b1_1(x))), max_pool(x, 3, 2, "SAME"))


class _V4InceptionB(nn.Module):
    def __init__(self, cin, dtype=torch.float32):
        super().__init__()
        self.b0 = ConvNorm(cin, 384, 1, dtype=dtype)
        self.b1_1 = ConvNorm(cin, 192, 1, dtype=dtype)
        self.b1_2 = ConvNorm(192, 224, (1, 7), dtype=dtype)
        self.b1_3 = ConvNorm(224, 256, (7, 1), dtype=dtype)
        self.b2_1 = ConvNorm(cin, 192, 1, dtype=dtype)
        self.b2_2 = ConvNorm(192, 192, (7, 1), dtype=dtype)
        self.b2_3 = ConvNorm(192, 224, (1, 7), dtype=dtype)
        self.b2_4 = ConvNorm(224, 224, (7, 1), dtype=dtype)
        self.b2_5 = ConvNorm(224, 256, (1, 7), dtype=dtype)
        self.b3 = ConvNorm(cin, 128, 1, dtype=dtype)
        self.out = 384 + 256 + 256 + 128

    def forward(self, x):
        b1 = self.b1_3(self.b1_2(self.b1_1(x)))
        b2 = self.b2_5(self.b2_4(self.b2_3(self.b2_2(self.b2_1(x)))))
        return _cat(self.b0(x), b1, b2, self.b3(avg_pool(x, 3, 1, "SAME")))


class _V4ReductionB(nn.Module):
    def __init__(self, cin, dtype=torch.float32):
        super().__init__()
        self.b0_1 = ConvNorm(cin, 192, 1, dtype=dtype)
        self.b0_2 = ConvNorm(192, 192, 3, 2, dtype)
        self.b1_1 = ConvNorm(cin, 256, 1, dtype=dtype)
        self.b1_2 = ConvNorm(256, 256, (1, 7), dtype=dtype)
        self.b1_3 = ConvNorm(256, 320, (7, 1), dtype=dtype)
        self.b1_4 = ConvNorm(320, 320, 3, 2, dtype)
        self.out = 192 + 320 + cin

    def forward(self, x):
        b1 = self.b1_4(self.b1_3(self.b1_2(self.b1_1(x))))
        return _cat(self.b0_2(self.b0_1(x)), b1, max_pool(x, 3, 2, "SAME"))


class _V4InceptionC(nn.Module):
    def __init__(self, cin, dtype=torch.float32):
        super().__init__()
        self.b0 = ConvNorm(cin, 256, 1, dtype=dtype)
        self.b1_1 = ConvNorm(cin, 384, 1, dtype=dtype)
        self.b1_2a = ConvNorm(384, 256, (1, 3), dtype=dtype)
        self.b1_2b = ConvNorm(384, 256, (3, 1), dtype=dtype)
        self.b2_1 = ConvNorm(cin, 384, 1, dtype=dtype)
        self.b2_2 = ConvNorm(384, 448, (3, 1), dtype=dtype)
        self.b2_3 = ConvNorm(448, 512, (1, 3), dtype=dtype)
        self.b2_4a = ConvNorm(512, 256, (1, 3), dtype=dtype)
        self.b2_4b = ConvNorm(512, 256, (3, 1), dtype=dtype)
        self.b3 = ConvNorm(cin, 256, 1, dtype=dtype)
        self.out = 6 * 256

    def forward(self, x):
        b1 = self.b1_1(x)
        b2 = self.b2_3(self.b2_2(self.b2_1(x)))
        return _cat(self.b0(x), self.b1_2a(b1), self.b1_2b(b1), self.b2_4a(b2), self.b2_4b(b2),
                    self.b3(avg_pool(x, 3, 1, "SAME")))


class InceptionV4(nn.Module):
    def __init__(self, classes=1000, channels=3, dtype=torch.float32, aux=False, min_size=96):
        super().__init__()
        self.dtype, self.min_size = dtype, min_size
        self.stem1 = ConvNorm(channels, 32, 3, 2, dtype)
        self.stem2 = ConvNorm(32, 32, 3, dtype=dtype)
        self.stem3 = ConvNorm(32, 64, 3, dtype=dtype)
        self.stem4 = ConvNorm(64, 96, 3, 2, dtype)
        self.stem5a_1 = ConvNorm(160, 64, 1, dtype=dtype)
        self.stem5a_2 = ConvNorm(64, 96, 3, dtype=dtype)
        self.stem5b_1 = ConvNorm(160, 64, 1, dtype=dtype)
        self.stem5b_2 = ConvNorm(64, 64, (7, 1), dtype=dtype)
        self.stem5b_3 = ConvNorm(64, 64, (1, 7), dtype=dtype)
        self.stem5b_4 = ConvNorm(64, 96, 3, dtype=dtype)
        self.stem6 = ConvNorm(192, 192, 3, 2, dtype)
        cin = 384
        self.blocks = []
        for name, cls in ([("mixed_5%c" % (98 + i), _V4InceptionA) for i in range(4)] + [("mixed_6a", _V4ReductionA)]
                          + [("mixed_6%c" % (98 + i), _V4InceptionB) for i in range(7)]):
            setattr(self, name, cls(cin, dtype))
            self.blocks.append(name)
            cin = getattr(self, name).out
        if aux:
            _add_aux_head(self, cin, classes, dtype)
        self.tail = []
        for name, cls in [("mixed_7a", _V4ReductionB)] + [("mixed_7%c" % (98 + i), _V4InceptionC) for i in range(3)]:
            setattr(self, name, cls(cin, dtype))
            self.tail.append(name)
            cin = getattr(self, name).out
        self.logits = Dense(cin, classes)

    def forward(self, x, with_aux=False):
        x = resize_min(to_nchw(x), self.min_size).to(self.dtype)
        x = self.stem3(self.stem2(self.stem1(x)))
        x = _cat(max_pool(x, 3, 2, "SAME"), self.stem4(x))
        y0 = self.stem5a_2(self.stem5a_1(x))
        y1 = self.stem5b_4(self.stem5b_3(self.stem5b_2(self.stem5b_1(x))))
        x = _cat(y0, y1)
        x = _cat(self.stem6(x), max_pool(x, 3, 2, "SAME"))
        for name in self.blocks:
            x = getattr(self, name)(x)
        aux = _aux_head(self, x) if with_aux else None
        for name in self.tail:
            x = getattr(self, name)(x)
        logits = self.logits(global_mean(x))
        return (logits, aux) if with_aux else logits


class _ResBlock(nn.Module):
    """Inception-ResNet unit: branches -> concat -> linear 1x1 (with bias)
    -> scaled residual add -> ReLU."""

    def __init__(self, cin, scale, branches, dtype=torch.float32):
        super().__init__()
        self.scale = scale
        self.chains = []
        width = 0
        for bi, chain in enumerate(branches):
            names, c = [], cin
            for ci, (features, kernel) in enumerate(chain):
                name = "b%d_%d" % (bi, ci)
                setattr(self, name, ConvNorm(c, features, kernel, dtype=dtype))
                names.append(name)
                c = features
            self.chains.append(names)
            width += c
        self.up = Conv(width, cin, 1, dtype=dtype)
        self.out = cin

    def forward(self, x):
        outs = []
        for names in self.chains:
            y = x
            for name in names:
                y = getattr(self, name)(y)
            outs.append(y)
        return F.relu(x + self.scale * self.up(torch.cat(outs, dim=1)))


_BLOCK35 = (((32, 1),), ((32, 1), (32, 3)), ((32, 1), (48, 3), (64, 3)))
_BLOCK17 = (((192, 1),), ((128, 1), (160, (1, 7)), (192, (7, 1))))
_BLOCK8 = (((192, 1),), ((192, 1), (224, (1, 3)), (256, (3, 1))))


class InceptionResNetV2(nn.Module):
    """10 block35 (scale 0.17), 20 block17 (0.10), 10 block8 (0.20) between
    the v4-style reductions."""

    def __init__(self, classes=1000, channels=3, dtype=torch.float32, aux=False, min_size=96):
        super().__init__()
        self.dtype, self.min_size = dtype, min_size
        self.stem1 = ConvNorm(channels, 32, 3, 2, dtype)
        self.stem2 = ConvNorm(32, 32, 3, dtype=dtype)
        self.stem3 = ConvNorm(32, 64, 3, dtype=dtype)
        self.stem4 = ConvNorm(64, 80, 1, dtype=dtype)
        self.stem5 = ConvNorm(80, 192, 3, dtype=dtype)
        self.m5b_b0 = ConvNorm(192, 96, 1, dtype=dtype)
        self.m5b_b1_1 = ConvNorm(192, 48, 1, dtype=dtype)
        self.m5b_b1_2 = ConvNorm(48, 64, 5, dtype=dtype)
        self.m5b_b2_1 = ConvNorm(192, 64, 1, dtype=dtype)
        self.m5b_b2_2 = ConvNorm(64, 96, 3, dtype=dtype)
        self.m5b_b2_3 = ConvNorm(96, 96, 3, dtype=dtype)
        self.m5b_b3 = ConvNorm(192, 64, 1, dtype=dtype)
        for i in range(10):
            setattr(self, "block35_%d" % i, _ResBlock(320, 0.17, _BLOCK35, dtype))
        self.m6a_b0 = ConvNorm(320, 384, 3, 2, dtype)
        self.m6a_b1_1 = ConvNorm(320, 256, 1, dtype=dtype)
        self.m6a_b1_2 = ConvNorm(256, 256, 3, dtype=dtype)
        self.m6a_b1_3 = ConvNorm(256, 384, 3, 2, dtype)
        for i in range(20):
            setattr(self, "block17_%d" % i, _ResBlock(1088, 0.10, _BLOCK17, dtype))
        if aux:
            _add_aux_head(self, 1088, classes, dtype)
        self.m7a_b0_1 = ConvNorm(1088, 256, 1, dtype=dtype)
        self.m7a_b0_2 = ConvNorm(256, 384, 3, 2, dtype)
        self.m7a_b1_1 = ConvNorm(1088, 256, 1, dtype=dtype)
        self.m7a_b1_2 = ConvNorm(256, 288, 3, 2, dtype)
        self.m7a_b2_1 = ConvNorm(1088, 256, 1, dtype=dtype)
        self.m7a_b2_2 = ConvNorm(256, 288, 3, dtype=dtype)
        self.m7a_b2_3 = ConvNorm(288, 320, 3, 2, dtype)
        for i in range(10):
            setattr(self, "block8_%d" % i, _ResBlock(2080, 0.20, _BLOCK8, dtype))
        self.final_conv = ConvNorm(2080, 1536, 1, dtype=dtype)
        self.logits = Dense(1536, classes)

    def forward(self, x, with_aux=False):
        x = resize_min(to_nchw(x), self.min_size).to(self.dtype)
        x = max_pool(self.stem3(self.stem2(self.stem1(x))), 3, 2, "SAME")
        x = max_pool(self.stem5(self.stem4(x)), 3, 2, "SAME")
        x = _cat(self.m5b_b0(x), self.m5b_b1_2(self.m5b_b1_1(x)), self.m5b_b2_3(self.m5b_b2_2(self.m5b_b2_1(x))),
                 self.m5b_b3(avg_pool(x, 3, 1, "SAME")))
        for i in range(10):
            x = getattr(self, "block35_%d" % i)(x)
        x = _cat(self.m6a_b0(x), self.m6a_b1_3(self.m6a_b1_2(self.m6a_b1_1(x))), max_pool(x, 3, 2, "SAME"))
        for i in range(20):
            x = getattr(self, "block17_%d" % i)(x)
        aux = _aux_head(self, x) if with_aux else None
        x = _cat(self.m7a_b0_2(self.m7a_b0_1(x)), self.m7a_b1_2(self.m7a_b1_1(x)),
                 self.m7a_b2_3(self.m7a_b2_2(self.m7a_b2_1(x))), max_pool(x, 3, 2, "SAME"))
        for i in range(10):
            x = getattr(self, "block8_%d" % i)(x)
        logits = self.logits(global_mean(self.final_conv(x)))
        return (logits, aux) if with_aux else logits
