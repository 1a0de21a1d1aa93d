"""Declarative aggregation-tree specification (the ``tree:`` grammar).

A copy of ``aggregathor_tpu/topology/spec.py``, cut to what the port's
``gars/tree.py`` needs: the parse, the budgets, the link's dtype or codec
and its byte accounting.  Its lazy imports reach the
port's ``gars`` registry and ``parallel/compress.py``, whose
``parse_exchange_spec`` serves the ``f32``, ``bf16``, ``int8`` and ``topk``
links (a link with error feedback is refused).  The host plane
(``topology/tree.py``: per-level bounded wait, custody, shadows), its
helpers (leaf spans, shadow units, fault targets) and ``--topology`` are
not ported.

The parameter-server star has one trusted aggregator and one GAR call; a
tree replaces it with L levels of *untrusted* sub-aggregators (CodedReduce,
arXiv:1902.01981; efficient meta-aggregation, arXiv:2405.14759).  The spec
is declarative and validated ENTIRELY at parse time — the same discipline
as every ``(n, f)`` feasibility check in ``gars/``: a tree that cannot
honor its Byzantine budget is rejected before a step ever runs.

Grammar (the ``tree:`` GAR spec, also accepted by ``--topology``)::

    tree:g=16x4,rules=median>trimmed-mean>krum,link=int8,redundancy=2,agg-f=1x0

- ``g``          ``x``-separated per-level group sizes: level 1 reduces n
                 workers in groups of 16 to n/16 summaries, level 2 reduces
                 those in groups of 4, ... — each size must divide the rows
                 entering its level;
- ``rules``      ``>``-separated rule specs, one per level PLUS the root
                 (``len(g) + 1`` entries); nested composite specs use the
                 parenthesized form (``bucketing(s=2,inner=krum)``) so their
                 commas stay attached, exactly like ``hier``/``bucketing``;
- ``link``       the wire codec of every inter-level link
                 (``f32``/``bf16``/``int8``/``topk(...)`` —
                 parallel/compress.py; error feedback is refused: a link
                 residual would need per-sub-aggregator state the tree does
                 not carry);
- ``redundancy`` r >= 1: each level-l group's summary is computed by r
                 units — its primary and r-1 *sibling* sub-aggregators at
                 the same level (circular assignment).  Honest shadows
                 compute the identical summary from the identical child
                 rows, so a straggling or forging primary is RECONSTRUCTED
                 for free; with r=1 it is excluded (NaN row) and spends the
                 level's budget;
- ``agg-f``      ``x``-separated per-level Byzantine *sub-aggregator*
                 budgets: how many level-l units may be corrupt parents.

**f-accounting through the levels.**  Rows entering level 1 carry the
declared worker budget ``b_1 = f``.  A level is a *partition* of its input
rows, so ``b_l`` corrupted rows contaminate at most ``min(b_l, m_l)`` of
its ``m_l`` output rows — a Byzantine *parent* corrupts at most ONE outer
row — and ``agg_f_l`` Byzantine sub-aggregators add their own::

    b_{l+1} = min(b_l, m_l) + agg_f_l        (must stay < m_l)

Each level's rule is best-effort damage control within a group
(``inner_f = min(b_l, g_l - 1)``, the ``hier`` convention); the breakdown
property is carried by the levels ABOVE: the root rule is instantiated
with ``(m_L, b_root)`` so its own feasibility check (krum's ``n >= f + 3``,
bulyan's ``n >= 4f + 3``, ...) runs here, at parse time.
"""

from ..utils import UserException

#: spec defaults of the ``tree`` meta-rule (string-typed so the ``x``/``>``
#: grammars stay un-coerced; parse_keyval passes them through verbatim)
TREE_ARG_DEFAULTS = {
    "g": "4",
    "rules": "median>krum",
    "link": "f32",
    "redundancy": 1,
    "agg-f": "0",
}


def _split_top(text, sep):
    """Split on ``sep`` at paren depth 0 only — nested rule specs keep
    their separators (the ``_split_args`` discipline of gars/__init__.py)."""
    parts, depth, cur = [], 0, []
    for ch in text:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        if ch == sep and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    parts.append("".join(cur))
    return [p.strip() for p in parts if p.strip()]


def _normalize_rule_spec(spec):
    """``bucketing(s=2,inner=krum)`` and ``bucketing:s=2,inner=krum`` are
    the same spec; gars.parse_spec accepts both — pass through verbatim."""
    return spec.strip()


class TreeSpec:
    """One parsed + validated aggregation tree.

    Attributes (all fixed at parse time):

    - ``nb_workers`` / ``f``: the leaf plane's (n, declared-f);
    - ``group_sizes``: [g_1..g_L];
    - ``nb_units``: [m_1..m_L] units (groups) per level — m_L rows enter
      the root;
    - ``rule_specs`` / ``rules``: the L instantiated per-level rules
      (level l's rule runs over (g_l, inner_f_l));
    - ``root_spec`` / ``root_rule``: the rule over the m_L top rows,
      instantiated with the COMPOSED budget b_root;
    - ``row_budgets``: [b_1..b_{L+1}] — b_1 = f, b_{L+1} = b_root;
    - ``agg_fs``: per-level Byzantine sub-aggregator budgets;
    - ``redundancy``: shadows-per-group count r;
    - ``link_dtype``: the inter-level wire (parallel/compress.py's
      exchange dtype; None is float32).
    """

    def __init__(self, nb_workers, nb_byz_workers, args):
        from .. import gars
        from ..parallel.compress import parse_exchange_spec

        self.nb_workers = int(nb_workers)
        self.f = int(nb_byz_workers)
        if self.f < 0:
            raise UserException("tree: negative declared Byzantine count")
        if self.f >= self.nb_workers:
            raise UserException(
                "tree: f=%d >= n=%d leaves no honest worker"
                % (self.f, self.nb_workers)
            )

        # ---- per-level group sizes --------------------------------------
        g_text = str(args["g"])
        try:
            self.group_sizes = [int(g) for g in g_text.split("x") if g.strip()]
        except ValueError:
            raise UserException(
                "tree: g=%r wants x-separated integers (e.g. g=16x4)" % g_text
            )
        if not self.group_sizes:
            raise UserException("tree: g=%r declares no levels" % g_text)
        if any(g < 2 for g in self.group_sizes):
            raise UserException(
                "tree: every group size must be >= 2 (got g=%s) — a "
                "1-group level aggregates nothing" % g_text
            )

        # ---- per-level + root rule specs --------------------------------
        rule_specs = [_normalize_rule_spec(s)
                      for s in _split_top(str(args["rules"]), ">")]
        if len(rule_specs) != len(self.group_sizes) + 1:
            raise UserException(
                "tree: g=%s declares %d level(s), so rules wants %d "
                ">-separated entries (one per level plus the root), got %d "
                "(%r)" % (g_text, len(self.group_sizes),
                          len(self.group_sizes) + 1, len(rule_specs),
                          str(args["rules"]))
            )
        self.rule_specs = rule_specs[:-1]
        self.root_spec = rule_specs[-1]

        # ---- the f-composition recurrence (module docstring) ------------
        self.nb_units = []
        self.rules = []
        self.inner_fs = []
        rows = self.nb_workers
        budget = self.f
        self.row_budgets = [budget]
        agg_text = str(args["agg-f"])
        try:
            agg_fs = [int(a) for a in agg_text.split("x") if a.strip()]
        except ValueError:
            raise UserException(
                "tree: agg-f=%r wants x-separated integers (e.g. agg-f=1x0)"
                % agg_text
            )
        if len(agg_fs) == 1:
            agg_fs = agg_fs * len(self.group_sizes)
        if len(agg_fs) != len(self.group_sizes):
            raise UserException(
                "tree: agg-f=%r wants one entry per level (%d), got %d"
                % (agg_text, len(self.group_sizes), len(agg_fs))
            )
        if any(a < 0 for a in agg_fs):
            raise UserException("tree: agg-f entries must be >= 0")
        self.agg_fs = agg_fs
        for level, (g, spec, agg_f) in enumerate(
                zip(self.group_sizes, self.rule_specs, agg_fs), start=1):
            if rows % g != 0:
                raise UserException(
                    "tree: level %d group size g=%d does not divide its %d "
                    "input rows (g=%s over n=%d)"
                    % (level, g, rows, g_text, self.nb_workers)
                )
            units = rows // g
            # within-group damage control: a group may hold up to
            # min(budget, g) corrupted rows; clamp to what any rule admits
            inner_f = min(budget, g - 1)
            self.rules.append(gars.instantiate(spec, g, inner_f))
            self.inner_fs.append(inner_f)
            # a partition: budget corrupted rows contaminate <= min(budget,
            # units) summaries (a Byzantine parent corrupts at most ONE
            # outer row), plus this level's Byzantine sub-aggregators
            budget = min(budget, units) + agg_f
            if budget >= units:
                raise UserException(
                    "tree: the composed Byzantine budget after level %d is "
                    "%d of %d rows (worker f=%d through the partition, plus "
                    "agg-f=%d sub-aggregators) — no rule can tolerate a "
                    "corrupt majority-or-all; widen the groups or lower "
                    "agg-f" % (level, budget, units, self.f, agg_f)
                )
            self.nb_units.append(units)
            self.row_budgets.append(budget)
            rows = units
        # the root rule's OWN feasibility check runs here, at parse time,
        # against the composed budget (krum's n >= f + 3 and friends)
        self.root_rule = gars.instantiate(self.root_spec, rows, budget)

        # ---- redundancy --------------------------------------------------
        self.redundancy = int(args["redundancy"])
        if self.redundancy < 1:
            raise UserException("tree: redundancy must be >= 1")
        if self.redundancy > min(self.nb_units):
            raise UserException(
                "tree: redundancy=%d exceeds the smallest level width %d — "
                "shadows are SIBLING sub-aggregators, a level cannot host "
                "more copies than it has units"
                % (self.redundancy, min(self.nb_units))
            )

        # ---- the inter-level wire ---------------------------------------
        self.link_spec = str(args["link"]).replace("(", ":").replace(")", "")
        self.link_dtype, self.link_codec = parse_exchange_spec(self.link_spec)
        if self.link_codec is not None and self.link_codec.uses_ef:
            raise UserException(
                "tree: link=%s declares error feedback, but an inter-level "
                "link carries no residual state (there is no per-sub-"
                "aggregator TrainState row to persist it in) — drop ef"
                % self.link_spec
            )

    # ------------------------------------------------------------------ #
    # shape helpers

    @property
    def nb_levels(self):
        return len(self.group_sizes)

    # ------------------------------------------------------------------ #
    # wire accounting (static, like parallel/compress.bytes_per_row)

    def link_bytes_per_row(self, d):
        from ..parallel.compress import bytes_per_row

        return bytes_per_row(d, dtype=self.link_dtype, codec=self.link_codec)

    def link_bytes_per_round(self, d):
        """Bytes every inter-level link ships per round: each level's m_l
        summaries cross one link (the root's input is the last link)."""
        return int(sum(self.nb_units)) * self.link_bytes_per_row(d)

    def link_ratio(self, d):
        """Inter-level compression ratio vs an uncompressed f32 link."""
        from ..parallel.compress import bytes_per_row

        return (bytes_per_row(d) * 1.0) / self.link_bytes_per_row(d)

    def describe(self):
        return ("tree: n=%d f=%d g=%s rules=%s root=%s budgets=%s "
                "agg-f=%s redundancy=%d link=%s" % (
                    self.nb_workers, self.f,
                    "x".join(str(g) for g in self.group_sizes),
                    ">".join(self.rule_specs), self.root_spec,
                    self.row_budgets,
                    "x".join(str(a) for a in self.agg_fs),
                    self.redundancy, self.link_spec))


def parse_topology_spec(spec, nb_workers, nb_byz_workers):
    """``--topology tree:...`` -> a validated :class:`TreeSpec`.  The spec
    shares the GAR grammar; the name must be ``tree`` (the one registered
    topology-aware meta-rule)."""
    from .. import gars
    from ..utils import parse_keyval

    name, args = gars.parse_spec(spec)
    if name != "tree":
        raise UserException(
            "--topology wants a tree: spec (got %r); the star topology is "
            "the default — just drop the flag" % (spec,)
        )
    kv = parse_keyval(args, TREE_ARG_DEFAULTS, strict=True)
    return TreeSpec(nb_workers, nb_byz_workers, kv)
