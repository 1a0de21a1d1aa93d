"""NASNet-A and PNASNet-5 (``nasnet_cifar``, ``nasnet_mobile``,
``nasnet_large``, ``pnasnet_mobile``, ``pnasnet_large``).

Counterpart of ``aggregathor_tpu/models/nasnet.py`` on NCHW tensors.  A
cell aligns its "previous" input to the current one's size by slim's
factorized reduction when their sizes differ, else by a 1x1 squeeze; the
two have different parameters, and flax decides from the input's size at
init, so the module takes the image size and works the sizes out at
construction (reductions run through odd sizes: "SAME" stride-2 gives
ceil(n / 2), and the alignment's stride is the ceil-div of the sizes, 25
-> 13 at stride 2).  Separable convs apply twice (the stride on the
first), the pools are "SAME" (max with -inf, average over the whole
window), the norms GroupNorm.
"""

import torch
import torch.nn.functional as F
from torch import nn

from .common import Conv, Dense, GroupNorm, avg_pool, global_mean, max_pool, resize_min, to_nchw


class _SepConv(nn.Module):
    """(ReLU -> depthwise kxk -> pointwise 1x1 -> norm) twice; the stride on
    the first."""

    def __init__(self, cin, features, kernel, stride=1, dtype=torch.float32):
        super().__init__()
        for i, (c, s) in enumerate(((cin, stride), (features, 1))):
            setattr(self, "depthwise_%d" % i, Conv(c, c, kernel, s, groups=c, bias=False, dtype=dtype))
            setattr(self, "pointwise_%d" % i, Conv(c, features, 1, bias=False, dtype=dtype))
            setattr(self, "norm_%d" % i, GroupNorm(features))

    def forward(self, x):
        for i in range(2):
            x = getattr(self, "depthwise_%d" % i)(F.relu(x))
            x = getattr(self, "norm_%d" % i)(getattr(self, "pointwise_%d" % i)(x))
        return x


class _FactorizedReduce(nn.Module):
    """slim's factorized reduction: two stride-s 1x1 paths, the second on a
    one-pixel-shifted view, concatenated, then norm."""

    def __init__(self, cin, features, stride, dtype=torch.float32):
        super().__init__()
        self.path1 = Conv(cin, features // 2, 1, stride, bias=False, dtype=dtype)
        self.path2 = Conv(cin, features - features // 2, 1, stride, bias=False, dtype=dtype)
        self.norm = GroupNorm(features)

    def forward(self, x):
        y = F.relu(x)
        shifted = F.pad(y, (0, 1, 0, 1))[:, :, 1:, 1:]
        return self.norm(torch.cat([self.path1(y), self.path2(shifted)], dim=1))


class _Squeeze(nn.Module):
    """ReLU -> 1x1 conv -> norm."""

    def __init__(self, cin, features, dtype=torch.float32):
        super().__init__()
        self.proj = Conv(cin, features, 1, bias=False, dtype=dtype)
        self.norm = GroupNorm(features)

    def forward(self, x):
        return self.norm(self.proj(F.relu(x)))


def _pool(kind, x, stride):
    return (avg_pool if kind == "avg" else max_pool)(x, 3, stride, "SAME")


class _Cell(nn.Module):
    """The alignment shared by both cell types: ``h0`` from the previous
    output (factorized reduction when its size ``prev_size`` differs from
    the current one's ``cur_size``), ``h1`` from the current one."""

    def __init__(self, prev_ch, cur_ch, prev_size, cur_size, filters, reduction, dtype):
        super().__init__()
        self.s = 2 if reduction else 1
        self.reduction = reduction
        self.sizes = (prev_size, cur_size)
        if prev_size != cur_size:
            self.fr_prev = _FactorizedReduce(prev_ch, filters, -(-prev_size // cur_size), dtype)
        else:
            self.sq_prev = _Squeeze(prev_ch, filters, dtype)
        self.sq_cur = _Squeeze(cur_ch, filters, dtype)

    def align(self, prev, cur):
        if (prev.shape[-2], cur.shape[-2]) != self.sizes:
            raise ValueError("cell built for sizes %s, called on %s" % (self.sizes, (prev.shape[-2], cur.shape[-2])))
        h0 = self.fr_prev(prev) if self.sizes[0] != self.sizes[1] else self.sq_prev(prev)
        return h0, self.sq_cur(cur)


class _NasnetCell(_Cell):
    """A NASNet-A cell: 5 combination blocks, the unconsumed outputs concatenated."""

    def __init__(self, prev_ch, cur_ch, prev_size, cur_size, filters, reduction=False, dtype=torch.float32):
        super().__init__(prev_ch, cur_ch, prev_size, cur_size, filters, reduction, dtype)
        f, s = filters, self.s
        if reduction:
            specs = (("b0_l", 7, s), ("b0_r", 5, s), ("b1_r", 7, s), ("b2_r", 5, s), ("b3_r", 3, 1))
            self.out = 4 * f
        else:
            specs = (("b0_l", 3, 1), ("b1_l", 3, 1), ("b1_r", 5, 1), ("b4_l", 5, 1), ("b4_r", 3, 1))
            self.out = 5 * f
        for name, kernel, stride in specs:
            setattr(self, name, _SepConv(f, f, kernel, stride, dtype))

    def forward(self, prev, cur):
        h0, h1 = self.align(prev, cur)
        s = self.s
        if self.reduction:
            b0 = self.b0_l(h0) + self.b0_r(h1)
            b1 = _pool("max", h1, s) + self.b1_r(h0)
            b2 = _pool("avg", h1, s) + self.b2_r(h0)
            b3 = _pool("max", h1, s) + self.b3_r(b0)
            b4 = _pool("avg", b0, 1) + b1
            return torch.cat([b1, b2, b3, b4], dim=1)
        b0 = self.b0_l(h1) + h1
        b1 = self.b1_l(h0) + self.b1_r(h1)
        b2 = _pool("avg", h1, 1) + h0
        b3 = _pool("avg", h0, 1) + _pool("avg", h0, 1)
        b4 = self.b4_l(h0) + self.b4_r(h0)
        return torch.cat([b0, b1, b2, b3, b4], dim=1)


class _PnasnetCell(_Cell):
    """A PNASNet-5 cell (the same op set at stride 1 or 2)."""

    def __init__(self, prev_ch, cur_ch, prev_size, cur_size, filters, reduction=False, dtype=torch.float32):
        super().__init__(prev_ch, cur_ch, prev_size, cur_size, filters, reduction, dtype)
        f, s = filters, self.s
        for name, kernel, stride in (("b0_l", 5, s), ("b1_l", 7, s), ("b2_l", 5, s), ("b2_r", 3, s), ("b3_l", 3, 1),
                                     ("b4_l", 3, s)):
            setattr(self, name, _SepConv(f, f, kernel, stride, dtype))
        self.out = 5 * f

    def forward(self, prev, cur):
        h0, h1 = self.align(prev, cur)
        s = self.s
        b0 = self.b0_l(h0) + _pool("max", h0, s)
        b1 = self.b1_l(h1) + _pool("max", h1, s)
        b2 = self.b2_l(h1) + self.b2_r(h1)
        b3 = self.b3_l(b2) + b1
        b4 = self.b4_l(h0) + (h1 if s == 1 else _pool("max", h1, s))
        return torch.cat([b0, b1, b2, b3, b4], dim=1)


#: name -> (cell class, cells a stack N, first-stack filters F, ImageNet stem)
NASNET_VARIANTS = {
    "nasnet_cifar": (_NasnetCell, 6, 32, False),
    "nasnet_mobile": (_NasnetCell, 4, 44, True),
    "nasnet_large": (_NasnetCell, 6, 168, True),
    "pnasnet_mobile": (_PnasnetCell, 3, 54, True),
    "pnasnet_large": (_PnasnetCell, 4, 216, True),
}


class NASNet(nn.Module):
    """Stem, 3 stacks of N cells separated by reduction cells, global pool,
    logits.  ``size``: the input's height (square images; flax reads it at
    init), ``channels`` its channels."""

    def __init__(self, variant="nasnet_cifar", classes=10, size=32, channels=3, dtype=torch.float32, min_size=32):
        super().__init__()
        cell_cls, n_cells, f, imagenet_stem = NASNET_VARIANTS[variant]
        self.dtype, self.min_size = dtype, min_size
        stride = 2 if imagenet_stem else 1
        self.stem = Conv(channels, 32, 3, stride, bias=False, dtype=dtype)
        self.stem_norm = GroupNorm(32)
        size = -(-max(size, min_size) // stride)
        prev, cur = (32, size), (32, size)
        self.cells = []
        idx = 0
        for stack in range(3):
            names = ["reduce_%d" % stack] if stack > 0 else []
            names += ["cell_%d" % (idx + i) for i in range(n_cells)]
            idx += n_cells
            for name in names:
                reduction = name.startswith("reduce")
                cell = cell_cls(prev[0], cur[0], prev[1], cur[1], f * 2 ** stack, reduction, dtype)
                setattr(self, name, cell)
                self.cells.append(name)
                prev, cur = cur, (cell.out, -(-cur[1] // 2) if reduction else cur[1])
        self.logits = Dense(cur[0], classes)

    def forward(self, x):
        x = resize_min(to_nchw(x), self.min_size).to(self.dtype)
        x = self.stem_norm(self.stem(x))
        prev, cur = x, x
        for name in self.cells:
            prev, cur = cur, getattr(self, name)(prev, cur)
        return self.logits(global_mean(F.relu(cur)))
