"""MobileNet v1 and v2, with their width multipliers.

Counterpart of ``aggregathor_tpu/models/mobilenet.py`` on NCHW tensors:
depthwise convs are ``groups = C`` convs (flax's ``feature_group_count``;
the flax kernel ``(3, 3, 1, C)`` is ``(C, 1, 3, 3)`` here), the norms
GroupNorm with the largest group count <= 32 that divides the channels,
images below 64 pixels upsampled bilinearly (``resize_min``).
"""

import torch
import torch.nn.functional as F
from torch import nn

from .common import Conv, Dense, GroupNorm, global_mean, resize_min, to_nchw


class SeparableBlock(nn.Module):
    """3x3 depthwise + 1x1 pointwise, each with norm + ReLU."""

    def __init__(self, cin, features, stride=1, dtype=torch.float32):
        super().__init__()
        self.depthwise = Conv(cin, cin, 3, stride, groups=cin, bias=False, dtype=dtype)
        self.dw_norm = GroupNorm(cin)
        self.pointwise = Conv(cin, features, 1, bias=False, dtype=dtype)
        self.pw_norm = GroupNorm(features)

    def forward(self, x):
        x = F.relu(self.dw_norm(self.depthwise(x)))
        return F.relu(self.pw_norm(self.pointwise(x)))


#: (filters, stride) after the stem conv: the v1 body
_V1_BODY = [(64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2), (512, 1), (512, 1), (512, 1), (512, 1),
            (512, 1), (1024, 2), (1024, 1)]

MOBILENET_MULTIPLIERS = {
    "mobilenet_v1": 1.0,
    "mobilenet_v1_075": 0.75,
    "mobilenet_v1_050": 0.5,
    "mobilenet_v1_025": 0.25,
}


class MobileNetV1(nn.Module):
    def __init__(self, classes=1000, multiplier=1.0, channels=3, dtype=torch.float32, min_size=64):
        super().__init__()
        self.dtype, self.min_size = dtype, min_size

        def width(f):
            return max(8, int(f * multiplier))

        cin = width(32)
        self.stem = Conv(channels, cin, 3, 2, bias=False, dtype=dtype)
        self.stem_norm = GroupNorm(cin)
        self.blocks = []
        for i, (filters, stride) in enumerate(_V1_BODY):
            setattr(self, "sep_%d" % i, SeparableBlock(cin, width(filters), stride, dtype))
            self.blocks.append("sep_%d" % i)
            cin = width(filters)
        self.logits = Dense(cin, classes)

    def forward(self, x):
        x = resize_min(to_nchw(x), self.min_size).to(self.dtype)
        x = F.relu(self.stem_norm(self.stem(x)))
        for name in self.blocks:
            x = getattr(self, name)(x)
        return self.logits(global_mean(x))


class InvertedResidual(nn.Module):
    """v2 bottleneck: 1x1 expand -> 3x3 depthwise -> 1x1 linear projection,
    a residual when the stride is 1 and the channels match; ReLU6."""

    def __init__(self, cin, features, stride=1, expand=6, dtype=torch.float32):
        super().__init__()
        hidden = cin * expand
        self.expanded = expand != 1
        if self.expanded:
            self.expand = Conv(cin, hidden, 1, bias=False, dtype=dtype)
            self.expand_norm = GroupNorm(hidden)
        self.depthwise = Conv(hidden, hidden, 3, stride, groups=hidden, bias=False, dtype=dtype)
        self.dw_norm = GroupNorm(hidden)
        self.project = Conv(hidden, features, 1, bias=False, dtype=dtype)
        self.project_norm = GroupNorm(features)
        self.residual = stride == 1 and cin == features

    def forward(self, x):
        y = F.relu6(self.expand_norm(self.expand(x))) if self.expanded else x
        y = F.relu6(self.dw_norm(self.depthwise(y)))
        y = self.project_norm(self.project(y))
        return x + y if self.residual else y


#: (expansion t, channels c, repeats n, first stride s): the v2 body
_V2_BODY = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2), (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]

MOBILENET_V2_MULTIPLIERS = {
    "mobilenet_v2": 1.0,
    "mobilenet_v2_140": 1.4,
    "mobilenet_v2_035": 0.35,
}


class MobileNetV2(nn.Module):
    """The width multiplier scales every layer but the 1280-channel head,
    which only scales up (multiplier > 1)."""

    def __init__(self, classes=1000, multiplier=1.0, channels=3, dtype=torch.float32, min_size=64):
        super().__init__()
        self.dtype, self.min_size = dtype, min_size

        def width(f):
            # slim's make_divisible: round to /8, never below 90% of the target
            v = f * multiplier
            new = max(8, int(v + 4) // 8 * 8)
            return new + 8 if new < 0.9 * v else new

        cin = width(32)
        self.stem = Conv(channels, cin, 3, 2, bias=False, dtype=dtype)
        self.stem_norm = GroupNorm(cin)
        self.blocks = []
        for expand, features, repeats, stride in _V2_BODY:
            for r in range(repeats):
                name = "block_%d" % len(self.blocks)
                setattr(self, name, InvertedResidual(cin, width(features), stride if r == 0 else 1, expand, dtype))
                self.blocks.append(name)
                cin = width(features)
        head = width(1280) if multiplier > 1.0 else 1280
        self.head = Conv(cin, head, 1, bias=False, dtype=dtype)
        self.head_norm = GroupNorm(head)
        self.logits = Dense(head, classes)

    def forward(self, x):
        x = resize_min(to_nchw(x), self.min_size).to(self.dtype)
        x = F.relu6(self.stem_norm(self.stem(x)))
        for name in self.blocks:
            x = getattr(self, name)(x)
        x = F.relu6(self.head_norm(self.head(x)))
        return self.logits(global_mean(x))
