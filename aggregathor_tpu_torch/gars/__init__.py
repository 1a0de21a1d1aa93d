"""Gradient Aggregation Rules (GARs), the heart of the framework.

A GAR reduces the ``(n, d)`` matrix of per-worker flattened gradients to one
``(d,)`` aggregated gradient while tolerating up to ``f`` Byzantine rows.
Counterpart of ``aggregathor_tpu/gars``: the same registry names, the same
``GAR`` contract and the same ``(n, f)`` feasibility checks.

Distance-based rules (Krum, Bulyan) factor into ``selection_weights(dist2)``
(O(n^2), tiny) and a ``(t, n) x (n, d)`` combine; the ``(n, n)`` distance
matrix comes from the distance kernels (``ops/kernels.py``: K1 up to 64
workers, K2 beyond).  Coordinate-wise rules call the rank-selection kernels
K3-K5, and average-nan the finite-mean kernel K6.  Dispatch is by device
alone: a CUDA matrix always goes through the kernel, a CPU matrix through
its plain PyTorch version; there is no column threshold.

The meta-rules (``bucketing``, ``hier``, ``tree``) compose registered
rules through ``instantiate``; the randomized ones take a ``key``, an int
seed (the engine's per-step ``fold_in_seed(fold_in_seed(seed, step),
GAR_KEY_TAG)``), where the JAX package takes a PRNG key, and derive their
children's keys with ``common.fold_key`` where JAX folds.  Under the flat
engine's bucketed granularity:leaf path a rule runs inside
``torch.func.vmap`` over a bucket of leaves and its key is the bucket's
``common.LeafKeys``: each leaf's seed, folded alike, its draws made on the
host and picked by the leaf's batched position.  The
``*-native`` names run the host C++ library (``ops/native``) on their dense
``aggregate``.

Unlike the JAX package the registry does not walk its directory: it imports
the rules this package ports, by name, at the bottom of this module.
"""

from ..utils import ClassRegister

gars = ClassRegister("GAR")

#: the tag the engine folds into the step's seed to derive the per-step GAR
#: key (JAX ``gars/__init__.py``): far above any worker index, so the
#: randomized meta-rules' permutations never collide with the (seed, step,
#: worker, tag) streams of the attacks, the lossy link and the input tier
GAR_KEY_TAG = 0x6AC0BEA7


def register(name, cls):
    return gars.register(name, cls)


def itemize():
    return gars.itemize()


def _split_args(text):
    """Split ``k=v,k=v`` on top-level commas only — a parenthesized value
    (a nested rule spec like ``hier(g=4,outer=krum)``) keeps its commas."""
    parts, depth, cur = [], 0, []
    for ch in text:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    parts.append("".join(cur))
    return [p for p in (p.strip() for p in parts) if p]


def parse_spec(spec):
    """Parse an inline GAR spec into ``(name, [key:value, ...])``.

    Three forms (all equivalent)::

        krum
        hier:g=16,inner=median,outer=krum
        hier(g=16,inner=median,outer=krum)

    Nested composite rules spell their sub-arguments in the parenthesized
    form so the commas stay attached to the inner spec::

        bucketing:s=2,inner=hier(g=8,outer=krum)

    The returned args use the ``key:value`` convention ``parse_keyval``
    expects.  A plain registered name passes through untouched.
    """
    from ..utils import UserException

    spec = str(spec).strip()
    ci, pi = spec.find(":"), spec.find("(")
    if pi != -1 and spec.endswith(")") and (ci == -1 or pi < ci):
        name, _, body = spec.partition("(")
        body = body[:-1]
    elif ci != -1:
        name, _, body = spec.partition(":")
    else:
        return spec, []
    name = name.strip()
    args = []
    for item in _split_args(body):
        if "=" not in item:
            raise UserException(
                "GAR spec argument %r wants key=value (in spec %r)" % (item, spec)
            )
        key, _, value = item.partition("=")
        args.append("%s:%s" % (key.strip(), value.strip()))
    return name, args


def instantiate(name, nb_workers, nb_byz_workers, args=None):
    """Build the GAR registered under ``name`` (or an inline spec, see
    :func:`parse_spec`); spec args and explicit ``args`` concatenate, with
    duplicate keys rejected by ``parse_keyval``."""
    name, spec_args = parse_spec(name)
    return gars.get(name)(nb_workers, nb_byz_workers, spec_args + list(args or []))


class GAR:
    """Base Gradient Aggregation Rule.

    Subclasses implement ``aggregate_block``; ``aggregate`` is the dense
    convenience entry that computes the distance matrix when needed.

    Attributes:
      coordinate_wise: True if the rule treats coordinates independently.
      needs_distances: True if ``aggregate_block`` requires the (n, n)
        pairwise squared-distance matrix (Krum/Bulyan family).
      nan_row_tolerant: True if an all-NaN row is cleanly excluded from the
        aggregate rather than poisoning it.
      uses_key: True if ``aggregate_block`` takes ``key=`` (an int seed, the
        same for the whole step): the randomized meta-rules re-draw their
        permutation each step.
      uses_axis: True if ``aggregate_block`` takes ``axis=`` (a
        ``parallel.mesh.WorkerAxis``, or None on one device): the rules
        whose row norms, row liveness or Gram span the column blocks of a
        W-rank engine complete them with one ``axis.all_reduce_sum`` (JAX's
        ``axis_name`` psum), so a block's result is the whole matrix's.
    """

    coordinate_wise = False
    needs_distances = False
    nan_row_tolerant = False
    uses_key = False
    uses_axis = False
    #: typed key:value argument defaults accepted by this rule (strict: an
    #: unknown key raises instead of being silently ignored)
    ARG_DEFAULTS = {}

    def __init__(self, nb_workers, nb_byz_workers, args=None):
        from ..utils import parse_keyval

        self.nb_workers = int(nb_workers)
        self.nb_byz_workers = int(nb_byz_workers)
        self.args = parse_keyval(args, self.ARG_DEFAULTS, strict=True)
        self.check()

    def check(self):
        """Validate the (n, f) relation; raise UserException when unsatisfiable."""
        from ..utils import UserException

        if self.nb_workers < 1:
            raise UserException("GAR %r needs at least 1 worker" % type(self).__name__)
        if self.nb_byz_workers < 0:
            raise UserException("Negative declared Byzantine count")
        # Universal feasibility floor: no rule can tolerate a Byzantine
        # majority of everyone (f >= n leaves zero honest rows).
        if self.nb_byz_workers >= self.nb_workers:
            raise UserException(
                "GAR %r cannot declare f=%d >= n=%d: at least one worker "
                "must be honest for any aggregate to mean anything"
                % (type(self).__name__, self.nb_byz_workers, self.nb_workers)
            )

    def aggregate(self, grads, key=None):
        """Dense entry: reduce the full (n, d) float32 matrix to (d,)."""
        from .common import pairwise_sq_distances

        dist2 = pairwise_sq_distances(grads) if self.needs_distances else None
        return self._call_aggregate(grads, dist2, key=key)

    def _call_aggregate(self, block, dist2, key=None, axis=None):
        """The single dispatch point the engine uses (``dist2`` already
        clamped at 0 when the rule needs distances, None otherwise); the
        ``key`` reaches only a rule that declares ``uses_key`` and the
        ``axis`` only one that declares ``uses_axis``, so plain rules keep
        their two-argument ``aggregate_block``."""
        return self.aggregate_block(block, dist2, **rule_kwargs(self, key=key, axis=axis))

    def aggregate_block(self, block, dist2=None):
        """Reduce an (n, d) block to (d,); ``dist2`` is the (n, n)
        squared-distance matrix when ``needs_distances`` is set."""
        raise NotImplementedError

    def worker_participation(self, dist2):
        """The (n,) weight each worker's row carried in the aggregate (sums
        to 1), for the rules that select whole workers; None for the rest
        (the coordinate-wise rules select per coordinate, not per worker).
        A non-finite distance counts as +inf, so K2's all-NaN convention and
        the plain version's +inf/NaN mix give the same weights."""
        return None

    def aggregate_block_and_participation(self, block, dist2=None, key=None, axis=None):
        """``(aggregate, worker_participation(dist2))`` in one call; the
        selection rules compute their weights once for both, the iterative
        and meta rules return the weights their own pass computes.  Callers
        hand ``key`` and ``axis`` through ``rule_kwargs``, as
        ``_call_aggregate`` does."""
        return self._call_aggregate(block, dist2, key=key, axis=axis), self.worker_participation(dist2)


def rule_kwargs(rule, key=None, axis=None):
    """The keywords ``rule`` declares: ``key`` for a ``uses_key`` rule,
    ``axis`` for a ``uses_axis`` one."""
    kwargs = {}
    if rule.uses_key:
        kwargs["key"] = key
    if rule.uses_axis:
        kwargs["axis"] = axis
    return kwargs


# The ported rules register themselves on import, in the slices' order.
from . import average, average_nan, krum, median, averaged_median, bulyan, trimmed_mean, pallas_tier  # noqa: E402,F401
from . import centered_clip, geometric_median, dnc, bucketing, hierarchical, tree, native_host  # noqa: E402,F401
