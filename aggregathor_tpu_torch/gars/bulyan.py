"""Bulyan (of Multi-Krum) GAR.

Counterpart of ``aggregathor_tpu/gars/bulyan.py``.  With m = n - f - 2,
t = n - 2f - 2, b = t - 2f:

1. Krum scoring with distance pruning: for each worker i only its
   ``n - f - 2`` smallest distances (ties to the lower column) count toward
   score(i); the others are zeroed so a removal updates scores in O(n).
2. Selection loop, ``t`` rounds: round k emits the average of the ``m - k``
   smallest-scoring gradients, then removes the best-scoring one (``argmin``,
   the first index on ties) and decrements every score by its pruned
   distance to it.  The JAX package's ``lax.scan`` is a Python loop over t
   rounds on (n,) vectors here.
3. Averaged-median over the t selections (the K4 kernel on CUDA): median,
   then the mean of the ``b`` values closest to it.

A worker's participation (``--worker-metrics``) is its weight averaged over
the t rounds.
"""

import torch

from ..ops import kernels
from . import GAR, register
from .common import nonfinite_to_inf, select_combine, selection_mean_weights


class BulyanGAR(GAR):
    needs_distances = True
    nan_row_tolerant = True  # as krum: +inf distances, never selected

    def __init__(self, nb_workers, nb_byz_workers, args=None):
        super().__init__(nb_workers, nb_byz_workers, args)
        n, f = self.nb_workers, self.nb_byz_workers
        self.nb_multikrum = n - f - 2       # m
        self.nb_selections = n - 2 * f - 2  # t
        self.nb_closest = self.nb_selections - 2 * f  # b
        if self.nb_closest < 1:
            from ..utils import UserException

            raise UserException("bulyan needs n >= 4f + 3 (got n=%d, f=%d)" % (n, f))

    def selection_weights(self, dist2):
        """(t, n) weight matrix: row k averages the (m - k) smallest-scoring
        workers after k removals."""
        n, f = self.nb_workers, self.nb_byz_workers
        eye = torch.eye(n, dtype=torch.bool, device=dist2.device)
        clean = torch.where(eye, torch.inf, nonfinite_to_inf(dist2))
        # Row-wise pruning: keep each row's n - f - 2 smallest (stable sort:
        # ties to the lower column index), zero the rest.
        ranks = torch.argsort(torch.argsort(clean, dim=-1, stable=True), dim=-1)
        pruned = torch.where(ranks < n - f - 2, clean, 0.0)
        live = torch.sum(pruned, dim=-1)
        index = torch.arange(n, device=dist2.device)
        rows = []
        for k in range(self.nb_selections):
            rows.append(selection_mean_weights(live, self.nb_multikrum - k))
            # the removal as whole-vector ops (no indexing by a tensor value),
            # so that torch.func.vmap takes it over a bucket of leaves
            best = torch.argmin(nonfinite_to_inf(live))
            live = live - torch.gather(pruned, 1, best.reshape(1, 1).expand(n, 1))[:, 0]
            live = torch.where(index == best, torch.inf, live)
        return torch.stack(rows)

    def aggregate_block(self, block, dist2=None):
        return self.aggregate_block_and_participation(block, dist2)[0]

    def worker_participation(self, dist2):
        # the mean over the t rounds of each worker's weight: a worker every
        # round excludes ends at exactly 0
        return torch.mean(self.selection_weights(dist2), dim=0)

    def aggregate_block_and_participation(self, block, dist2=None, key=None):
        if dist2 is None:
            raise ValueError("bulyan requires the pairwise distance matrix")
        weights = self.selection_weights(dist2)
        selections = select_combine(weights, block)
        aggregate = kernels.coordinate_averaged_median(selections.contiguous(), self.nb_closest)
        return aggregate, torch.mean(weights, dim=0)


register("bulyan", BulyanGAR)
# Reference tier aliases (bulyan-py/co)
register("bulyan-py", BulyanGAR)
register("bulyan-co", BulyanGAR)
