"""ResNet v1 and v2 (pre-activation), the zoo's ``resnet_v1_*`` and ``resnet_v2_*``.

Counterpart of ``aggregathor_tpu/models/resnet.py`` on NCHW tensors, with
the same module and parameter names, so ``params_from_jax`` carries a flax
tree across and ``FlatMap`` lays the gradient out in JAX's order:
GroupNorm in place of BatchNorm (no batch statistics to leak across
Byzantine workers), the stride-2 3x3 convs padded by XLA's "SAME" rule
(asymmetric on even sizes, ``common.conv2d``), the ImageNet stem's 3x3/2
max-pool "SAME" with -inf.
"""

import torch
import torch.nn.functional as F
from torch import nn

from .common import Conv, Dense, GroupNorm, global_mean, max_pool, to_nchw


class BasicBlock(nn.Module):
    """Two 3x3 convs and an identity or projection shortcut (depths 18/34)."""

    expansion = 1

    def __init__(self, cin, filters, stride=1, dtype=torch.float32):
        super().__init__()
        self.conv1 = Conv(cin, filters, 3, stride, bias=False, dtype=dtype)
        self.norm1 = GroupNorm(filters, min(32, filters))
        self.conv2 = Conv(filters, filters, 3, bias=False, dtype=dtype)
        self.norm2 = GroupNorm(filters, min(32, filters))
        # flax projects when the shapes differ: a stride or a channel change
        self.project = stride != 1 or cin != filters
        if self.project:
            self.shortcut = Conv(cin, filters, 1, stride, bias=False, dtype=dtype)
            self.shortcut_norm = GroupNorm(filters, min(32, filters))

    def forward(self, x):
        y = F.relu(self.norm1(self.conv1(x)))
        y = self.norm2(self.conv2(y))
        residual = self.shortcut_norm(self.shortcut(x)) if self.project else x
        return F.relu(residual + y)


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 -> 1x1 (x4) bottleneck (depths 50/101/152/200)."""

    expansion = 4

    def __init__(self, cin, filters, stride=1, dtype=torch.float32):
        super().__init__()
        out = 4 * filters
        self.conv1 = Conv(cin, filters, 1, bias=False, dtype=dtype)
        self.norm1 = GroupNorm(filters, min(32, filters))
        self.conv2 = Conv(filters, filters, 3, stride, bias=False, dtype=dtype)
        self.norm2 = GroupNorm(filters, min(32, filters))
        self.conv3 = Conv(filters, out, 1, bias=False, dtype=dtype)
        self.norm3 = GroupNorm(out, min(32, out))
        self.project = stride != 1 or cin != out
        if self.project:
            self.shortcut = Conv(cin, out, 1, stride, bias=False, dtype=dtype)
            self.shortcut_norm = GroupNorm(out, min(32, out))

    def forward(self, x):
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        y = self.norm3(self.conv3(y))
        residual = self.shortcut_norm(self.shortcut(x)) if self.project else x
        return F.relu(residual + y)


class PreactBottleneckBlock(nn.Module):
    """v2 bottleneck: norm + ReLU before each conv; the projection (when the
    shapes change) reads the pre-activated input, an identity shortcut the
    raw one."""

    expansion = 4

    def __init__(self, cin, filters, stride=1, dtype=torch.float32):
        super().__init__()
        out = 4 * filters
        self.norm1 = GroupNorm(cin, min(32, cin))
        self.project = cin != out or stride != 1
        if self.project:
            self.shortcut = Conv(cin, out, 1, stride, bias=False, dtype=dtype)
        self.conv1 = Conv(cin, filters, 1, bias=False, dtype=dtype)
        self.norm2 = GroupNorm(filters, min(32, filters))
        self.conv2 = Conv(filters, filters, 3, stride, bias=False, dtype=dtype)
        self.norm3 = GroupNorm(filters, min(32, filters))
        self.conv3 = Conv(filters, out, 1, bias=False, dtype=dtype)

    def forward(self, x):
        y = F.relu(self.norm1(x))
        residual = self.shortcut(y) if self.project else x
        y = F.relu(self.norm2(self.conv1(y)))
        y = F.relu(self.norm3(self.conv2(y)))
        return residual + self.conv3(y)


#: depth -> (block class, stage sizes): the v1 family
RESNET_DEPTHS = {
    18: (BasicBlock, (2, 2, 2, 2)),
    34: (BasicBlock, (3, 4, 6, 3)),
    50: (BottleneckBlock, (3, 4, 6, 3)),
    101: (BottleneckBlock, (3, 4, 23, 3)),
    152: (BottleneckBlock, (3, 8, 36, 3)),
    200: (BottleneckBlock, (3, 24, 36, 3)),
}

#: the v2 (pre-activation) family: bottlenecks only, the same stage tables
RESNET_V2_DEPTHS = {
    50: (PreactBottleneckBlock, (3, 4, 6, 3)),
    101: (PreactBottleneckBlock, (3, 4, 23, 3)),
    152: (PreactBottleneckBlock, (3, 8, 36, 3)),
    200: (PreactBottleneckBlock, (3, 24, 36, 3)),
}


class ResNet(nn.Module):
    """ResNet v1/v2 classifier on NHWC input.  ``small_inputs``: a 3x3/1
    stem and no pool (32x32 images), else the ImageNet 7x7/2 stem (padded
    3 each side) and a 3x3/2 "SAME" max-pool; ``preact``: the v2 family (no
    stem norm, a final norm + ReLU before the pool); ``channels``: the
    input's (flax infers them)."""

    def __init__(self, depth=50, classes=1000, small_inputs=False, preact=False, channels=3, dtype=torch.float32):
        super().__init__()
        block_cls, stages = (RESNET_V2_DEPTHS if preact else RESNET_DEPTHS)[depth]
        self.small_inputs, self.preact, self.dtype = small_inputs, preact, dtype
        if small_inputs:
            self.stem = Conv(channels, 64, 3, bias=False, dtype=dtype)
        else:
            self.stem = Conv(channels, 64, 7, 2, padding=((3, 3), (3, 3)), bias=False, dtype=dtype)
        if not preact:
            self.stem_norm = GroupNorm(64, 32)
        cin = 64
        self.blocks = []
        for stage, nb_blocks in enumerate(stages):
            for block in range(nb_blocks):
                stride = 2 if (stage > 0 and block == 0) else 1
                name = "stage%d_block%d" % (stage + 1, block)
                setattr(self, name, block_cls(cin, 64 * 2 ** stage, stride, dtype))
                self.blocks.append(name)
                cin = 64 * 2 ** stage * block_cls.expansion
        if preact:
            self.final_norm = GroupNorm(cin, 32)
        self.logits = Dense(cin, classes)

    def forward(self, x):
        x = self.stem(to_nchw(x, self.dtype))
        if not self.preact:
            x = F.relu(self.stem_norm(x))
        if not self.small_inputs:
            x = max_pool(x, 3, 2, "SAME")
        for name in self.blocks:
            x = getattr(self, name)(x)
        if self.preact:
            x = F.relu(self.final_norm(x))
        return self.logits(global_mean(x))
