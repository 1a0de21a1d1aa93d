"""Shared GAR numerics: distances, NaN conventions, rank selections.

Counterpart of ``aggregathor_tpu/gars/common.py``.  A non-finite pairwise
distance counts as +inf for scoring, and non-finite coordinates sort last
(as if +inf) in the coordinate-wise rules; both are explicit ``isfinite``
masks, never NaN comparisons.
"""

import torch

from ..ops import kernels


def nonfinite_to_inf(x):
    """Replace every non-finite entry with +inf (NaN-last ordering convention)."""
    return torch.where(torch.isfinite(x), x, torch.inf)


def pairwise_sq_distances(grads):
    """All-pairs squared L2 distances of the rows of an (n, d) float32 matrix.

    A CUDA matrix goes to K1 (difference form) for n <= 64 and, for n > 64,
    to K2 (Gram form) after centring the rows by their NaN-ignoring column
    median; a CPU matrix to the same forms' plain versions.  The Gram form
    is clamped at 0 inside the wrapper, as in the JAX package, so
    ``GAR.aggregate``'s dense entry gets clamped distances too.  NaN rows
    give NaN entries, which the scoring maps to +inf."""
    return kernels.pairwise_sq_distances(grads)


def centered_gram_sq_distances(rows):
    """(n, n) Gram-form squared distances of the rows centred by their
    NaN-ignoring column median, clamped at 0: the centring
    (``kernels.nanmedian_columns``) then K2 on a CUDA matrix, their plain
    versions on the CPU (JAX ``common.py:106-145``, which leaves the clamp
    to its callers).  The meta-rules' distances over bucket means, group
    summaries and tree levels at any n, 2 rows included.  K2 splits d over
    its blocks itself, so the JAX ``GRAM_CHUNK_BUDGET`` scan over
    coordinate chunks has no counterpart.  A row holding a non-finite value
    gives non-finite distances (all NaN from K2), which scoring maps to
    +inf."""
    return kernels.pairwise_sq_distances_gram(rows, kernels.nanmedian_columns(rows))


def completed_distances(partial, axis=None):
    """A column block's partial (n, n) distances completed across the
    worker axis (one ``all_reduce_sum``; JAX's psum), clamped at 0; the
    block's own on one device (``axis`` None)."""
    if axis is not None:
        partial = axis.all_reduce_sum(partial)
    return torch.clamp_min(partial, 0.0)


def sub_rule_distances(rule, rows, axis=None):
    """A meta-rule's sub-rule distances over ``rows`` (bucket means, a
    group, summaries): ``centered_gram_sq_distances``, completed across the
    worker axis, or None when the sub-rule needs none."""
    if not rule.needs_distances:
        return None
    return completed_distances(centered_gram_sq_distances(rows.contiguous()), axis)


def alive_rows(rows, axis=None):
    """``(alive, safe)``: the (n,) float mask of rows with no non-finite
    coordinate (counted across the column blocks by one ``all_reduce_sum``
    when ``axis`` is given, so every rank agrees), and the rows with the
    dead ones zero-filled (the average-nan convention of the iterative
    rules: dead rows weigh 0)."""
    nb_bad = torch.sum(~torch.isfinite(rows), dim=-1).to(torch.float32)
    if axis is not None:
        nb_bad = axis.all_reduce_sum(nb_bad)
    alive = (nb_bad == 0.0).to(torch.float32)
    return alive, torch.where((alive > 0.0)[:, None], rows, 0.0)


def masked_coordinate_median(rows, alive):
    """(d,) coordinate-wise median of the alive rows, numpy's rule for an
    even count (trap a), 0 where every row is dead: the centring kernel on
    the rows with the dead ones set to NaN (its plain version on the CPU)."""
    return kernels.nanmedian_columns(torch.where((alive > 0.0)[:, None], rows, torch.nan).contiguous())


def global_row_sq_norms(deviation, axis=None):
    """(n,) squared row norms, completed across the column blocks of a
    W-rank engine by one ``all_reduce_sum`` when ``axis`` is given (JAX's
    ``axis_name`` psum); on one device the rows are whole."""
    sqn = torch.sum(deviation * deviation, dim=-1)
    if axis is not None:
        sqn = axis.all_reduce_sum(sqn)
    return sqn


def smallest_k_sum(values, k):
    """Sum of the k smallest entries along the last axis (non-finite = +inf)."""
    return torch.sum(torch.sort(nonfinite_to_inf(values), dim=-1).values[..., :k], dim=-1)


def smallest_k_mask(scores, k):
    """Boolean (n,) mask of the k smallest scores, ties to the lowest index.

    Non-finite scores count as +inf.  rank(i) = #{j : s_j < s_i, or s_j ==
    s_i and j < i}, the rank rule of the JAX package.  ``k`` may be an int
    or a 0-d tensor (DnC's data-dependent count)."""
    clean = nonfinite_to_inf(scores)
    idx = torch.arange(clean.shape[0], device=clean.device)
    smaller = (clean[None, :] < clean[:, None]) | (
        (clean[None, :] == clean[:, None]) & (idx[None, :] < idx[:, None])
    )
    return torch.sum(smaller, dim=1) < k


def selection_mean_weights(scores, k):
    """(n,) weights averaging the k smallest-scoring rows: mask / k."""
    return smallest_k_mask(scores, k).to(torch.float32) / float(k)


def select_combine(weights, block):
    """Weighted row combination that ignores NaNs in *unselected* rows.

    ``weights @ block`` alone would propagate NaN from rows with weight 0
    (0 x NaN = NaN), letting an excluded row poison the output.  So the
    combine runs on the block with non-finite entries zeroed, and exactly
    the coordinates where a row with nonzero weight was non-finite are
    re-poisoned to NaN.

    Args:
      weights: (n,) or (t, n) selection weights.
      block:   (n, d) gradient rows.
    Returns:
      (d,) or (t, d) combined rows, NaN-faithful.
    """
    w = weights if weights.dim() == 2 else weights[None, :]
    finite = torch.isfinite(block)
    out = w.to(torch.float32) @ torch.where(finite, block, 0.0)
    touched = (torch.abs(w) > 0).to(torch.float32) @ (~finite).to(torch.float32)
    out = torch.where(touched > 0, torch.nan, out)
    return out if weights.dim() == 2 else out[0]
