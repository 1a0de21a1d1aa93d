"""The MobileNet and NASNet blocks and cells against flax's, at narrow widths.

The harness of ``test_torch_zoo_blocks.py``: from the same flax weights on
inputs drawn from a seed with numpy, at an odd and an even spatial size,
the forward output and the input gradient within atol 1e-4 + rtol 1e-4.
The NASNet-A and PNASNet-5 cells, normal and reduction, align the
previous input by a squeeze (equal sizes) or slim's factorized reduction
at the ceil-div stride (7 -> 4 and 13 -> 7).
"""

import numpy as np
import pytest

from aggregathor_tpu.models import mobilenet as jmob
from aggregathor_tpu.models import nasnet as jnas
from aggregathor_tpu_torch.models import mobilenet as mob
from aggregathor_tpu_torch.models import nasnet as nas
from test_torch_zoo_blocks import SIZES, _compare

from torch_threads import pinned_threads  # noqa: F401  (a fixture: the xdist worker's intra-op pool)

BLOCKS = {
    "SeparableBlock-s1": (lambda: jmob.SeparableBlock(12, 1), lambda c: mob.SeparableBlock(c, 12, 1), 8),
    "SeparableBlock-s2": (lambda: jmob.SeparableBlock(12, 2), lambda c: mob.SeparableBlock(c, 12, 2), 8),
    "InvertedResidual-t1": (lambda: jmob.InvertedResidual(8, 1, 1), lambda c: mob.InvertedResidual(c, 8, 1, 1), 8),
    "InvertedResidual-t6-s2": (lambda: jmob.InvertedResidual(8, 2, 6),
                               lambda c: mob.InvertedResidual(c, 8, 2, 6), 4),
    "SepConv-5x5/2": (lambda: jnas._SepConv(8, 5, 2), lambda c: nas._SepConv(c, 8, 5, 2), 8),
    "SepConv-7x7/1": (lambda: jnas._SepConv(8, 7, 1), lambda c: nas._SepConv(c, 8, 7, 1), 8),
    "FactorizedReduce": (lambda: jnas._FactorizedReduce(9, 2), lambda c: nas._FactorizedReduce(c, 9, 2), 6),
    "Squeeze": (lambda: jnas._Squeeze(8), lambda c: nas._Squeeze(c, 8), 6),
}


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("name", list(BLOCKS))
def test_block_matches_flax(name, size):
    jfactory, tfactory, channels = BLOCKS[name]
    x = np.random.default_rng(size).normal(size=(2, size, size, channels)).astype(np.float32)
    _compare(jfactory(), tfactory(channels), [x], seed=size)


#: (cell, reduction, prev size, cur size): the squeeze alignment, and the
#: factorized reduction with the ceil-div stride (7 -> 4 and 13 -> 7 at 2)
CELLS = [(cell, reduction, prev, cur) for cell in ("nasnet", "pnasnet") for reduction in (False, True)
         for prev, cur in ((7, 7), (8, 8), (7, 4), (13, 7))]


@pytest.mark.parametrize("cell, reduction, prev, cur", CELLS)
def test_cells_match_flax(cell, reduction, prev, cur):
    jcls, tcls = (jnas._NasnetCell, nas._NasnetCell) if cell == "nasnet" else (jnas._PnasnetCell, nas._PnasnetCell)
    rng = np.random.default_rng(prev * 100 + cur)
    inputs = [rng.normal(size=(2, prev, prev, 10)).astype(np.float32),
              rng.normal(size=(2, cur, cur, 6)).astype(np.float32)]
    _compare(jcls(8, reduction=reduction), tcls(10, 6, prev, cur, 8, reduction), inputs, seed=prev + cur)
