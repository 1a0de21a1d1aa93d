"""``tree``: the L-level aggregation-tree meta-GAR (its in-graph numerics).

Counterpart of ``aggregathor_tpu/gars/tree.py``; ``hier`` is its two-level
case.  Spec (``topology/spec.py`` parses and validates it, composing the
Byzantine budgets through the levels at construction)::

    tree:g=4x2,rules=median>average-nan>krum,link=bf16

Each level runs its rule over contiguous groups of its rows
(``hierarchical.group_pass``: one launch on the transposed layout for a
coordinate-wise rule, one call a group otherwise, each group with its own
distances from the centring and K2), then its summaries cross the
inter-level link: the codec's round trip of each summary row for
``link=int8``/``topk(...)`` (JAX ``gars/tree.py:77-85``), the dtype round
trip for ``link=bf16``, the identity for ``f32``.  The
root rule runs over the last level's rows with distances from
``centered_gram_sq_distances``.

Keys (int seeds): level l's group i is ``fold(fold(key, l + 1), i)``, the
root ``fold(key, L + 2)``, as in JAX.  ``nan_row_tolerant`` holds when any
level's rule or the root's is.  The participation composes level by level:
the root weights scattered down through each level's within-group weights
(1/g_l for a coordinate-wise rule), so the (n,) vector sums to 1.  On a
W-rank engine (``axis``) the levels run on each rank's column block, their
distances completed across the ranks as ``hier``'s are.
"""

from ..utils import fold_in_seed
from . import GAR, register, rule_kwargs
from .common import sub_rule_distances
from .hierarchical import group_pass


def level_pass(spec, level, rows, key, with_participation=False, axis=None):
    """Level ``level`` (0-based) of the tree ``spec``: its rule over groups
    of the rows (``group_pass``, group i keyed ``fold(fold(key, level + 1),
    i)``), then the inter-level link, since what a sub-aggregator ships is
    what the next level aggregates -> ``(summaries, participation)``.  The
    in-graph rule and the host protocol's emissions (``topology/tree.py``)
    both run this."""
    from ..parallel.compress import wire_roundtrip

    base = None if key is None else fold_in_seed(key, level + 1)
    rows, part = group_pass(spec.rules[level], rows, spec.group_sizes[level], base, with_participation, axis)
    return wire_roundtrip(rows, spec.link_dtype, codec=spec.link_codec), part


class TreeGAR(GAR):
    uses_axis = True
    uses_key = True
    # equal to topology.spec.TREE_ARG_DEFAULTS (a test holds them equal)
    ARG_DEFAULTS = {
        "g": "4",
        "rules": "median>krum",
        "link": "f32",
        "redundancy": 1,
        "agg-f": "0",
    }

    def __init__(self, nb_workers, nb_byz_workers, args=None):
        super().__init__(nb_workers, nb_byz_workers, args)
        from ..topology.spec import TreeSpec

        self.spec = TreeSpec(nb_workers, nb_byz_workers, self.args)
        self.nan_row_tolerant = (any(rule.nan_row_tolerant for rule in self.spec.rules)
                                 or self.spec.root_rule.nan_row_tolerant)

    def _levels(self, block, key, with_participation, axis=None):
        rows, parts = block, []
        for level in range(self.spec.nb_levels):
            rows, part = level_pass(self.spec, level, rows, key, with_participation, axis)
            parts.append(part)
        return rows, parts

    def _root_key(self, key):
        return None if key is None else fold_in_seed(key, self.spec.nb_levels + 2)

    def aggregate_block(self, block, dist2=None, key=None, axis=None):
        rows, _ = self._levels(block, key, False, axis)
        root = self.spec.root_rule
        return root._call_aggregate(rows, sub_rule_distances(root, rows, axis), key=self._root_key(key), axis=axis)

    def aggregate_block_and_participation(self, block, dist2=None, key=None, axis=None):
        rows, parts = self._levels(block, key, True, axis)
        root = self.spec.root_rule
        agg, weights = root.aggregate_block_and_participation(
            rows, sub_rule_distances(root, rows, axis), **rule_kwargs(root, key=self._root_key(key), axis=axis))
        if weights is None:
            return agg, None
        # a group's weight spreads over its members' within-group weights
        for part in reversed(parts):
            weights = (weights[:, None] * part).reshape(-1)
        return agg, weights


register("tree", TreeGAR)
