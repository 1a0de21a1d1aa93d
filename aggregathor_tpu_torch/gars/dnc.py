"""Divide-and-Conquer (DnC) GAR (Shejwalkar & Houmansadr, NDSS 2021).

Counterpart of ``aggregathor_tpu/gars/dnc.py``: centre the live rows on
their mean, take the top eigenvector u of their (n, n) Gram K = C C^T by a
fixed number of power-iteration steps started from diag(K) (the ones vector
lies in K's null space), score each row s_i = lambda * u_i^2 = (C_i . v)^2,
drop the ``remove`` largest scores among the live rows and average the
rest.  Deterministic: it draws nothing.

The Gram is one float64 ``torch.matmul`` of the float32 centred rows,
rounded to float32 (trap f: the JAX rule takes ``dot_general(HIGHEST)``
outside any Pallas kernel, full float32 products).  A float32 matmul on the
card would follow the process-wide TF32 flag, which any caller may have
set; a float64 one never uses TF32, so the rule's precision is its own.
On a W-rank engine each column block's float64 Gram is summed across the
ranks (one ``all_reduce_sum``, JAX ``dnc.py:52-53``) before the one rounding
to float32.  The power iteration runs on (n, n).  Rows holding a non-finite value score +inf and
sit outside the removal budget (``remove`` counts live outliers, so the
kept count nb_alive - remove is a tensor).  The final averaging weights are
the per-worker participation.

Without an attack the centred spectrum is flat, and which honest rows are
dropped depends on rounding (the kept mean stays an honest average); under
a colluding signal the selection is stable.
"""

import torch

from . import GAR, register
from .common import alive_rows, smallest_k_mask


def dnc(rows, nb_remove, iters, axis=None):
    """DnC over the (n, d) rows; returns ``(mean, participation)``.  With
    ``axis`` the liveness and the Gram are completed across the blocks."""
    alive, safe = alive_rows(rows, axis)
    nb_alive = torch.clamp_min(torch.sum(alive), 1.0)
    mean = torch.sum(safe, dim=0) / nb_alive  # safe is already zero-filled
    centered = (safe - mean[None, :]) * alive[:, None]
    wide = centered.to(torch.float64)
    gram = wide @ wide.T
    if axis is not None:
        gram = axis.all_reduce_sum(gram)
    gram = gram.to(torch.float32)
    u = torch.diagonal(gram).clone()
    u = u / torch.clamp_min(torch.linalg.vector_norm(u), 1e-30)
    for _ in range(iters):
        u = gram @ u
        u = u / torch.clamp_min(torch.linalg.vector_norm(u), 1e-30)
    lam = u @ (gram @ u)
    scores = torch.where(alive > 0.0, lam * u * u, torch.inf)
    kept = smallest_k_mask(scores, nb_alive - nb_remove).to(torch.float32) * alive
    weights = kept / torch.clamp_min(torch.sum(kept), 1.0)
    return torch.sum(weights[:, None] * safe, dim=0), weights


class DnCGAR(GAR):
    nan_row_tolerant = True  # dead rows excluded outside the removal budget
    uses_axis = True  # the JAX rule's blockwise Gram (one psum)
    ARG_DEFAULTS = {"remove": -1, "iters": 8}

    def __init__(self, nb_workers, nb_byz_workers, args=None):
        super().__init__(nb_workers, nb_byz_workers, args)
        from ..utils import UserException

        self.nb_remove = int(self.args["remove"])
        if self.nb_remove < 0:
            self.nb_remove = self.nb_byz_workers  # the paper's c*f with c = 1
        self.iters = int(self.args["iters"])
        if self.iters < 1:
            raise UserException("dnc needs iters >= 1")
        if not 0 <= self.nb_remove < self.nb_workers:
            raise UserException("dnc must keep at least one worker (n=%d, remove=%d)"
                                % (self.nb_workers, self.nb_remove))
        if self.nb_workers <= 2 * self.nb_byz_workers:
            from ..utils import warning

            warning("dnc tolerates f < n/2; n=%d f=%d is out of bound" % (self.nb_workers, self.nb_byz_workers))

    def aggregate_block(self, block, dist2=None, axis=None):
        return dnc(block, self.nb_remove, self.iters, axis)[0]

    def aggregate_block_and_participation(self, block, dist2=None, key=None, axis=None):
        return dnc(block, self.nb_remove, self.iters, axis)


register("dnc", DnCGAR)
