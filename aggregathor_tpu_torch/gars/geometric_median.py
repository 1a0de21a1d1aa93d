"""Geometric-median GAR (RFA: Pillutla, Kakade, Harchaoui 2022).

Counterpart of ``aggregathor_tpu/gars/geometric_median.py``: the point
minimising the sum of Euclidean distances to the rows, approximated by a
fixed number of Weiszfeld iterations from the coordinate-wise median of the
live rows,

    w_i <- 1 / max(|g_i - z|, eps),    z <- sum_i w_i g_i / sum_i w_i.

Breakdown point 1/2, and no pairwise distance matrix.  The start is the
centring kernel (``masked_coordinate_median``) on CUDA and its plain version
on the CPU; the iterations are plain tensor work.  Rows holding a
non-finite value get weight 0 (all rows dead: 0).  The final normalised
weights are the per-worker participation (``--worker-metrics``).
"""

import torch

from . import GAR, register
from .common import alive_rows, global_row_sq_norms, masked_coordinate_median


def geometric_median(rows, iters, eps):
    """``(z, participation)``: the Weiszfeld estimate of the (n, d) rows and
    the (n,) final normalised weights."""
    alive, safe = alive_rows(rows)
    # the coordinate-wise median starts inside the honest cloud; a mean
    # would start |forgery| away from it
    z = masked_coordinate_median(rows, alive)
    weights = alive
    for _ in range(iters):
        sqn = global_row_sq_norms(safe - z[None, :])
        weights = alive / torch.clamp_min(torch.sqrt(sqn), eps)
        total = torch.clamp_min(torch.sum(weights), 1e-30)
        z = torch.sum(weights[:, None] * safe, dim=0) / total
        weights = weights / total
    return z, weights


class GeometricMedianGAR(GAR):
    nan_row_tolerant = True  # dead rows get Weiszfeld weight 0
    uses_axis = True  # the JAX rule's exact blockwise norms (one psum an iteration)
    ARG_DEFAULTS = {"iters": 8, "eps": 1e-6}

    def __init__(self, nb_workers, nb_byz_workers, args=None):
        super().__init__(nb_workers, nb_byz_workers, args)
        from ..utils import UserException

        self.iters = int(self.args["iters"])
        self.eps = float(self.args["eps"])
        if self.iters < 1 or self.eps <= 0:
            raise UserException("geometric-median needs iters >= 1 and eps > 0")
        if self.nb_workers <= 2 * self.nb_byz_workers:
            from ..utils import warning

            warning("geometric-median tolerates f < n/2; n=%d f=%d is out of bound"
                    % (self.nb_workers, self.nb_byz_workers))

    def aggregate_block(self, block, dist2=None):
        return geometric_median(block, self.iters, self.eps)[0]

    def aggregate_block_and_participation(self, block, dist2=None, key=None):
        return geometric_median(block, self.iters, self.eps)


register("geometric-median", GeometricMedianGAR)
register("rfa", GeometricMedianGAR)  # the rule's common literature name
