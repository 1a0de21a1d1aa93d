"""Averaged-median GAR: per coordinate, average the beta = n - f values
closest to the (upper) median.

Counterpart of ``aggregathor_tpu/gars/averaged_median.py``; non-finite
deviations key +inf, so they are selected only when beta forces it.  Served
by the K4 kernel on CUDA, its plain version on the CPU.
"""

from ..ops import kernels
from . import GAR, register


class AveragedMedianGAR(GAR):
    coordinate_wise = True
    # NOT nan_row_tolerant: with more dead rows than the beta = n - f budget
    # covers, inf-deviation rows are force-selected and the mean goes NaN

    def __init__(self, nb_workers, nb_byz_workers, args=None):
        super().__init__(nb_workers, nb_byz_workers, args)
        self.beta = self.nb_workers - self.nb_byz_workers
        if self.beta < 1:
            from ..utils import UserException

            raise UserException("averaged-median needs n - f >= 1 (got n=%d, f=%d)" % (nb_workers, nb_byz_workers))

    def aggregate_block(self, block, dist2=None):
        return kernels.coordinate_averaged_median(block, self.beta)


register("averaged-median", AveragedMedianGAR)
