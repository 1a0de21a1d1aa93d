"""Coordinate-wise trimmed mean GAR (Yin et al. 2018).

Counterpart of ``aggregathor_tpu/gars/trimmed_mean.py``: per coordinate,
drop the ``b`` largest and ``b`` smallest values (non-finite sorting to the
top end) and average the middle ``n - 2b``; a column whose kept band still
holds an inf comes out NaN.  ``b = f`` by default.  Served by the K5 kernel
on CUDA, its plain version on the CPU.
"""

from ..ops import kernels
from . import GAR, register


class TrimmedMeanGAR(GAR):
    coordinate_wise = True
    ARG_DEFAULTS = {"trim": -1}  # -1: trim f from each end

    def __init__(self, nb_workers, nb_byz_workers, args=None):
        super().__init__(nb_workers, nb_byz_workers, args)
        trim = int(self.args["trim"])
        self.nb_trim = self.nb_byz_workers if trim < 0 else trim
        if self.nb_workers - 2 * self.nb_trim < 1:
            from ..utils import UserException

            raise UserException(
                "trimmed-mean needs n - 2*trim >= 1 (got n=%d, trim=%d)"
                % (self.nb_workers, self.nb_trim)
            )

    def aggregate_block(self, block, dist2=None):
        return kernels.coordinate_trimmed_mean(
            block, self.nb_trim, self.nb_workers - 2 * self.nb_trim
        )


register("trimmed-mean", TrimmedMeanGAR)
