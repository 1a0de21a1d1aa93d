"""Bucketing meta-GAR (Karimireddy, He, Jaggi 2022).

Counterpart of ``aggregathor_tpu/gars/bucketing.py``: permute the n workers,
average disjoint buckets of ``s`` and hand the ceil(n/s) bucket means to an
inner rule (``inner=``, any registered name or inline spec), which runs with
the same declared f (its feasibility is checked at construction).

The permutation comes from the step's key, an int seed:
``torch.randperm(n, generator=torch.Generator("cpu").manual_seed(key))``,
moved to the rows' device, so a CPU and a card run permute alike; the JAX
package draws ``jax.random.permutation`` from its PRNG key, which torch
cannot reproduce (trap c: the tests inject JAX's permutation through
``_buckets(perm=)`` and ``key_permutation``).  ``key=None`` is the
identity, as in JAX.  The inner
rule's key is ``fold_in_seed(key, 1)``.  The inner distances, when the
inner rule needs them, come from ``centered_gram_sq_distances`` on the
bucket means: the centring and K2 on the card.  On a W-rank engine
(``axis``) every rank draws the same permutation and averages its column
block of the buckets; the inner distances are completed across the ranks
and the inner rule gets the axis.

A ragged n (s not dividing n) is padded with NaN rows to a multiple of s,
so the last bucket is NaN: the inner rule then sees f + 1 bad rows and must
be NaN-tolerant (refused at construction otherwise).  The worker
participation is the bucket's scattered back through the permutation,
divided by s.  The JAX rule's ``masking`` hook (bucket means in the masked
integer domain of ``secure/``) is not ported.
"""

import torch

from ..utils import fold_in_seed
from . import GAR, instantiate, register, rule_kwargs
from .common import sub_rule_distances


def key_permutation(key, n, device):
    """The (n,) permutation of a step's key (identity for None), drawn on a
    CPU generator and moved to ``device``."""
    if key is None:
        return torch.arange(n, device=device)
    generator = torch.Generator("cpu").manual_seed(int(key))
    return torch.randperm(n, generator=generator).to(device)


class BucketingGAR(GAR):
    uses_axis = True
    uses_key = True
    ARG_DEFAULTS = {"s": 2, "inner": "krum"}

    def __init__(self, nb_workers, nb_byz_workers, args=None):
        super().__init__(nb_workers, nb_byz_workers, args)
        from ..utils import UserException

        self.s = int(self.args["s"])
        if self.s < 1:
            raise UserException("bucketing needs s >= 1 (got n=%d, s=%r)" % (self.nb_workers, self.args["s"]))
        self.nb_padded = (-self.nb_workers) % self.s
        self.nb_buckets = (self.nb_workers + self.nb_padded) // self.s
        inner_f = self.nb_byz_workers + (1 if self.nb_padded else 0)
        self.inner = instantiate(str(self.args["inner"]), self.nb_buckets, inner_f)
        # a NaN worker makes its whole bucket NaN: the tolerance is the inner's
        self.nan_row_tolerant = self.inner.nan_row_tolerant
        if self.nb_padded and not self.inner.nan_row_tolerant:
            raise UserException(
                "bucketing with s=%d not dividing n=%d pads with a NaN bucket every step, which inner rule %s "
                "does not cleanly exclude; pick a NaN-excluding inner rule or an s dividing n"
                % (self.s, self.nb_workers, type(self.inner).__name__))

    def _buckets(self, block, key, perm=None):
        """``(bucket means, perm)``; ``perm`` overrides the key's draw (the
        tests inject the JAX package's)."""
        n, d = self.nb_workers, block.shape[-1]
        if perm is None:
            perm = key_permutation(key, n, block.device)
        perm = torch.as_tensor(perm, dtype=torch.int64, device=block.device)
        stack = torch.index_select(block, 0, perm)
        if self.nb_padded:
            pad = torch.full((self.nb_padded, d), torch.nan, dtype=block.dtype, device=block.device)
            stack = torch.cat([stack, pad])
        return torch.mean(stack.view(self.nb_buckets, self.s, d), dim=1), perm

    def _inner_key(self, key):
        # a nested randomized inner rule re-draws too, from a derived key
        return None if key is None else fold_in_seed(key, 1)

    def aggregate_block(self, block, dist2=None, key=None, axis=None):
        buckets, _ = self._buckets(block, key)
        return self.inner._call_aggregate(buckets, sub_rule_distances(self.inner, buckets, axis),
                                          key=self._inner_key(key), axis=axis)

    def aggregate_block_and_participation(self, block, dist2=None, key=None, axis=None):
        buckets, perm = self._buckets(block, key)
        agg, bucket_part = self.inner.aggregate_block_and_participation(
            buckets, sub_rule_distances(self.inner, buckets, axis),
            **rule_kwargs(self.inner, key=self._inner_key(key), axis=axis))
        if bucket_part is None:
            return agg, None
        # worker i inherits 1/s of its bucket's weight; under a ragged n the
        # padded slots sit at the end of the permuted stack and are dropped
        per_worker = torch.repeat_interleave(bucket_part / self.s, self.s)[: self.nb_workers]
        participation = torch.zeros(self.nb_workers, dtype=per_worker.dtype, device=per_worker.device)
        return agg, participation.index_copy_(0, perm, per_worker)


register("bucketing", BucketingGAR)
