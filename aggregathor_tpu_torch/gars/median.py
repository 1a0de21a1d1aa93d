"""Coordinate-wise median GAR.

Counterpart of ``aggregathor_tpu/gars/median.py``: per column, the element at
index ``n // 2`` of the ascending order with non-finite treated as +inf (the
upper median for even n), returned as its ORIGINAL value (NaN poison
included).  Served by the K3 kernel on CUDA, its plain version on the CPU.
"""

from ..ops import kernels
from . import GAR, register


class MedianGAR(GAR):
    coordinate_wise = True
    # NOT nan_row_tolerant: NaN values sort last but still occupy order-
    # statistic slots

    def aggregate_block(self, block, dist2=None):
        return kernels.coordinate_median(block)


register("median", MedianGAR)
