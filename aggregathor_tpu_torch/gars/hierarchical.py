"""Hierarchical (two-level tree) meta-GAR: the large-n path.

Counterpart of ``aggregathor_tpu/gars/hierarchical.py``::

    hier:g=16,inner=median,outer=krum

    groups   = the n workers in n/g contiguous groups of g
    summary  = inner(group)          per group, an O(g d) pass
    output   = outer(summaries)      the expensive rule over n/g rows

so the n^2 d term of Krum/Bulyan shrinks to (n/g)^2 d.  f workers corrupt
at most f groups (a partition), so the outer rule runs over n/g rows with
the same declared f (its feasibility is checked at construction); the
inner rule is within-group damage control with ``inner_f = min(f, g - 1)``
unless ``inner_f=K`` is given.  ``nan_row_tolerant`` holds when either
level's rule is.

The JAX rule vmaps the inner rule over the (n/g, g, d) groups; the port
does not batch the groups (its batched kernels serve the bucketed leaf
path), so :func:`group_pass` takes one of two routes:

- a coordinate-wise inner rule (median, averaged-median, trimmed-mean,
  average, average-nan) runs ONCE on the transposed layout: (n/g, g, d) is
  permuted to (g, n/g, d), made contiguous and viewed as (g, (n/g) d), so
  each column holds one group's g values of one coordinate and the
  per-column selections are exactly the per-group ones: one K3/K4/K5/K6
  launch in place of n/g;
- any other inner rule (krum, bulyan, the iterative rules, a nested meta
  rule) runs once a group, each with its own distances (the centring and
  K2 on that group's rows, as JAX's ``vmap(centered_gram_sq_distances)``
  gives each group its own median) and its own key.

The outer distances are one ``centered_gram_sq_distances`` on the
summaries.  On a W-rank engine (``axis``) each rank runs the levels on its
column block: the per-group distances of a level are stacked and completed
across the ranks by one ``all_reduce_sum`` (JAX psums the vmapped (n/g, g,
g) partials once), the outer ones by another, and every sub-rule gets the
axis.  Keys (int seeds): group i's is ``fold(fold(key, 1), i)``, the
outer rule's ``fold(key, 2)``.  The participation factorises through the
tree: the outer weight of a worker's group times its weight within the
group (1/g for a coordinate-wise inner rule).  With ``masking`` set
(``secure.enable_masking``, ``inner=average``) the group summaries are
``secure.masking.masked_group_mean`` of the (n/g, g, d) groups under the
raw key (and, on a W-rank axis, the rank), each worker's weight in its
group 1/g.
"""

import torch

from . import GAR, instantiate, register, rule_kwargs
from .common import centered_gram_sq_distances, completed_distances, fold_key, sub_rule_distances


def group_pass(rule, rows, g, key, with_participation, axis=None):
    """One level over groups: the (m g, d) ``rows`` in m contiguous groups
    of g through ``rule`` (built for g rows) -> ``(summaries (m, d),
    participation (m, g) or None)``.  ``key`` is the level's base key
    (group i gets ``fold_in_seed(key, i)``) or None; ``axis`` the worker
    axis of a column block (None: whole rows)."""
    nb_groups, d = rows.shape[0] // g, rows.shape[-1]
    if rule.coordinate_wise:
        # the transposed layout: column j * d + c holds group j's coordinate c
        columns = rows.reshape(nb_groups, g, d).transpose(0, 1).contiguous().view(g, nb_groups * d)
        summaries = rule._call_aggregate(columns, None).view(nb_groups, d)
        parts = None
        if with_participation:
            parts = torch.full((nb_groups, g), 1.0 / g, dtype=torch.float32, device=rows.device)
        return summaries, parts
    summaries, parts = [], []
    dist2s = [None] * nb_groups
    if rule.needs_distances:
        # every group's partial distances, completed in one collective
        dist2s = completed_distances(torch.stack([
            centered_gram_sq_distances(rows[i * g:(i + 1) * g].contiguous()) for i in range(nb_groups)]), axis)
    for i in range(nb_groups):
        block = rows[i * g:(i + 1) * g]
        group_key = fold_key(key, i)
        dist2 = dist2s[i]
        if with_participation:
            agg, part = rule.aggregate_block_and_participation(
                block, dist2, **rule_kwargs(rule, key=group_key, axis=axis))
            parts.append(part)
        else:
            agg = rule._call_aggregate(block, dist2, key=group_key, axis=axis)
        summaries.append(agg)
    summaries = torch.stack(summaries)
    if not with_participation:
        return summaries, None
    if any(part is None for part in parts):
        return summaries, torch.full((nb_groups, g), 1.0 / g, dtype=torch.float32, device=rows.device)
    return summaries, torch.stack(parts)


class HierarchicalGAR(GAR):
    uses_axis = True
    uses_key = True
    ARG_DEFAULTS = {"g": 4, "inner": "median", "outer": "krum", "inner_f": -1}
    #: a ``secure.masking.GroupMasking`` (``secure.enable_masking``) or None
    masking = None

    def __init__(self, nb_workers, nb_byz_workers, args=None):
        super().__init__(nb_workers, nb_byz_workers, args)
        from ..utils import UserException

        self.g = int(self.args["g"])
        if self.g < 1 or self.nb_workers % self.g != 0:
            raise UserException("hier needs a group size g >= 1 dividing n (got n=%d, g=%r)"
                                % (self.nb_workers, self.args["g"]))
        self.nb_groups = self.nb_workers // self.g
        # the outer rule's (n/g, f) feasibility, checked here at parse time
        self.outer = instantiate(str(self.args["outer"]), self.nb_groups, self.nb_byz_workers)
        inner_f = int(self.args["inner_f"])
        if inner_f < 0:
            inner_f = min(self.nb_byz_workers, self.g - 1)
        if inner_f > self.g:
            raise UserException("hier inner_f=%d exceeds the group size g=%d" % (inner_f, self.g))
        self.inner_f = inner_f
        self.inner = instantiate(str(self.args["inner"]), self.g, inner_f)
        self.nan_row_tolerant = self.inner.nan_row_tolerant or self.outer.nan_row_tolerant

    def _inner_key(self, key):
        return fold_key(key, 1)

    def _outer_key(self, key):
        # disjoint from the per-group inner streams (fold(key, 1) then i)
        return fold_key(key, 2)

    def _inner_pass(self, block, key, with_participation, axis):
        if self.masking is not None:
            from ..secure.masking import masked_group_mean

            summaries = masked_group_mean(block.reshape(self.nb_groups, self.g, block.shape[-1]), key,
                                          self.masking, axis=axis)
            parts = None
            if with_participation:
                parts = torch.full((self.nb_groups, self.g), 1.0 / self.g, dtype=torch.float32, device=block.device)
            return summaries, parts
        return group_pass(self.inner, block, self.g, self._inner_key(key), with_participation, axis)

    def aggregate_block(self, block, dist2=None, key=None, axis=None):
        summaries, _ = self._inner_pass(block, key, False, axis)
        return self.outer._call_aggregate(summaries, sub_rule_distances(self.outer, summaries, axis),
                                          key=self._outer_key(key), axis=axis)

    def aggregate_block_and_participation(self, block, dist2=None, key=None, axis=None):
        summaries, inner_part = self._inner_pass(block, key, True, axis)
        agg, outer_part = self.outer.aggregate_block_and_participation(
            summaries, sub_rule_distances(self.outer, summaries, axis),
            **rule_kwargs(self.outer, key=self._outer_key(key), axis=axis))
        if outer_part is None:
            return agg, None
        return agg, (outer_part[:, None] * inner_part).reshape(self.nb_workers)


register("hier", HierarchicalGAR)
