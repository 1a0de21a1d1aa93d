"""Plain averaging GAR (not Byzantine-tolerant; the f=0 baseline).

Counterpart of ``aggregathor_tpu/gars/average.py``: the column mean.
"""

import torch

from . import GAR, register


class AverageGAR(GAR):
    coordinate_wise = True

    def aggregate_block(self, block, dist2=None):
        return torch.mean(block, dim=0)


register("average", AverageGAR)
