"""Centered-clipping GAR (Karimireddy, He, Jaggi 2021).

Counterpart of ``aggregathor_tpu/gars/centered_clip.py``: from the
coordinate-wise median of the live rows, a fixed number of iterations of

    v  <-  v + (1/n_alive) sum_i  (g_i - v) * min(1, tau / |g_i - v|).

Honest gradients move the centre; a Byzantine row adds at most ``tau`` of
displacement.  No pairwise distances: each iteration is one row-norm
reduction and one axpy over the (n, d) matrix.  The start is the centring
kernel (``masked_coordinate_median``, numpy's even-count rule) on CUDA and
its plain version on the CPU; the iterations are plain tensor work.

Rows holding a non-finite value are excluded from every iteration (the
average-nan convention): their clipped deviation is zero.
"""

import torch

from . import GAR, register
from .common import alive_rows, global_row_sq_norms, masked_coordinate_median


def centered_clip(rows, tau, iters, axis=None):
    """Iterative clipped-deviation centre of the (n, d) rows; with ``axis``
    the row liveness and norms are completed across the column blocks."""
    alive, safe = alive_rows(rows, axis)
    nb_alive = torch.clamp_min(torch.sum(alive), 1.0)
    center = masked_coordinate_median(rows, alive)
    for _ in range(iters):
        deviation = safe - center[None, :]
        norms = torch.sqrt(global_row_sq_norms(deviation, axis))[:, None]
        scale = torch.clamp_max(tau / torch.clamp_min(norms, 1e-12), 1.0)
        clipped = deviation * scale * alive[:, None]
        center = center + torch.sum(clipped, dim=0) / nb_alive
    return center


class CenteredClipGAR(GAR):
    nan_row_tolerant = True  # dead rows contribute zero clipped deviation
    uses_axis = True  # the JAX rule's exact blockwise norms (one psum an iteration)
    ARG_DEFAULTS = {"tau": 10.0, "iters": 3}

    def __init__(self, nb_workers, nb_byz_workers, args=None):
        super().__init__(nb_workers, nb_byz_workers, args)
        from ..utils import UserException

        self.tau = float(self.args["tau"])
        self.iters = int(self.args["iters"])
        if self.tau <= 0 or self.iters < 1:
            raise UserException("centered-clip needs tau > 0 and iters >= 1")
        if self.nb_workers <= 2 * self.nb_byz_workers:
            from ..utils import warning

            warning("centered-clip tolerates f < n/2; n=%d f=%d is out of bound"
                    % (self.nb_workers, self.nb_byz_workers))

    def aggregate_block(self, block, dist2=None, axis=None):
        return centered_clip(block, self.tau, self.iters, axis)


register("centered-clip", CenteredClipGAR)
