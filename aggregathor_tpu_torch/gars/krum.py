"""Multi-Krum GAR.

Counterpart of ``aggregathor_tpu/gars/krum.py``.  Per worker i: score(i) =
sum of its ``n - f - 2`` smallest pairwise squared distances (a non-finite
distance counts as +inf); the output is the average of the ``m = n - f - 2``
smallest-scoring gradients (ties to the lower index).  The (n, n) distances
come from the K1 kernel; the scoring is O(n^2) tensor work and the final
average a (1, n) x (n, d) product (``select_combine``).  A worker's
participation (``--worker-metrics``) is its selection weight.
"""

import torch

from . import GAR, register
from .common import nonfinite_to_inf, select_combine, selection_mean_weights, smallest_k_sum


def krum_scores(dist2, nb_workers, nb_byz_workers):
    """(n,) Multi-Krum scores from the (n, n) squared-distance matrix."""
    eye = torch.eye(nb_workers, dtype=torch.bool, device=dist2.device)
    clean = torch.where(eye, torch.inf, nonfinite_to_inf(dist2))
    return smallest_k_sum(clean, nb_workers - nb_byz_workers - 2)


class KrumGAR(GAR):
    needs_distances = True
    nan_row_tolerant = True  # NaN row -> +inf distances -> never selected

    def __init__(self, nb_workers, nb_byz_workers, args=None):
        super().__init__(nb_workers, nb_byz_workers, args)
        self.nb_selected = self.nb_workers - self.nb_byz_workers - 2
        if self.nb_selected < 1:
            from ..utils import UserException

            raise UserException("krum needs n >= f + 3 (got n=%d, f=%d)" % (nb_workers, nb_byz_workers))

    def selection_weights(self, dist2):
        """(n,) averaging weights over the m smallest-scoring workers."""
        scores = krum_scores(dist2, self.nb_workers, self.nb_byz_workers)
        return selection_mean_weights(scores, self.nb_selected)

    def aggregate_block(self, block, dist2=None):
        return self.aggregate_block_and_participation(block, dist2)[0]

    def worker_participation(self, dist2):
        return self.selection_weights(dist2)

    def aggregate_block_and_participation(self, block, dist2=None, key=None):
        if dist2 is None:
            raise ValueError("krum requires the pairwise distance matrix")
        weights = self.selection_weights(dist2)
        return select_combine(weights, block), weights


register("krum", KrumGAR)
# Reference tier aliases (krum-py/tf/co): one tier here, the device decides
register("krum-py", KrumGAR)
register("krum-tf", KrumGAR)
register("krum-co", KrumGAR)
