"""Coordinate-wise mean ignoring non-finite coordinates.

Counterpart of ``aggregathor_tpu/gars/average_nan.py``: it absorbs the NaN
runs that the lossy link (``parallel/lossy.py``, ``--UDP``) writes where a
packet was lost.  Per coordinate, the mean of the finite values; a column
with no finite value gives 0 (the JAX package's choice: a NaN there would
poison the parameters).  Served by the K6 kernel on CUDA, its plain version
on the CPU.
"""

from ..ops import kernels
from . import GAR, register


class AverageNaNGAR(GAR):
    coordinate_wise = True
    nan_row_tolerant = True

    def aggregate_block(self, block, dist2=None):
        return kernels.average_nan_columns(block)


register("average-nan", AverageNaNGAR)
