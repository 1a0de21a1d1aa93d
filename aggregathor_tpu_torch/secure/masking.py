"""Bucket-level pairwise additive masking (Bonawitz et al. 2017 style).

Counterpart of ``aggregathor_tpu/secure/masking.py``.  Masks are exchanged
only inside a group whose reduction is a mean (a ``bucketing`` bucket, a
``hier`` group with ``inner=average``) and cancel inside that group's mean:
the outer rule sees the group means as before, while each row it could
inspect is one-time-padded.

**Exact cancellation.**  The masked mean runs in modular integer
arithmetic: each coordinate is encoded as a signed 64-bit fixed-point
value with 32 fraction bits, held as two limbs ``(hi, lo)``; member ``j``
of a group of ``s`` adds the chain mask ``m_j - m_{(j+1) mod s}`` (each
``m`` uniform mod 2^64), and the group sum is taken mod 2^64, where the
masks cancel exactly.  The decoded mean is the same bits masked and
unmasked (``GroupMasking(enabled=False)``), and the same bits as the JAX
package's.  A group holding a non-finite value reads NaN (its masks
would not cancel without a recovery round): the NaN-tolerant outer rule
absorbs it.

torch has no uint32 arithmetic, so the limbs are int64 tensors holding
values in [0, 2^32) with an explicit carry, as JAX's ``_add64``/
``_neg64``.  The encode saturates as XLA's float32 -> uint32 conversion
does (an integer part of 2^32 or more encodes as 2^32 - 1); the decode
converts each limb to float32 on its own, as JAX does.

**Keys.**  ``GroupMasking.from_secret`` derives an int seed from the
session secret (``SHA-256(b"pairwise-mask:" + secret)``, its first four
bytes little-endian, JAX's seed); the step's pads draw from
``fold_in_seed(seed, fold_in_seed(key, MASK_KEY_TAG))``, ``key`` the
rule's per-step key (``engine.gar_key``), folded with the rank under a
W-rank axis so column blocks on two ranks never share pads, then 0 and 1
for the two limbs, on a ``torch.Generator`` of the rows' device.  The
pads are not JAX's (threefry), which only the pads themselves can show:
the means are the same bits.
"""

import hashlib

import torch

from ..gars.common import draw_keyed
from ..utils import UserException, fold_in_seed

#: fold tag of the mask stream from the rule's per-step key, apart from
#: bucketing's permutation (the raw key), inner (fold 1) and outer (fold 2)
MASK_KEY_TAG = 7

#: fixed-point fraction bits of the masked-mean integer domain
FRACTION_BITS = 32

_M32 = 0xFFFFFFFF


class GroupMasking:
    """Masking configuration of a mean-inner meta-GAR.  ``enabled=False``
    keeps the exact fixed-point arithmetic and adds no masks: the baseline
    a masked run is compared with."""

    def __init__(self, base_seed, enabled=True):
        self.base_seed = int(base_seed)
        self.enabled = bool(enabled)

    @classmethod
    def from_secret(cls, session_secret, enabled=True):
        """The pads' seed from the session secret (apart from every HMAC family)."""
        seed = int.from_bytes(hashlib.sha256(b"pairwise-mask:" + bytes(session_secret)).digest()[:4], "little")
        return cls(seed, enabled=enabled)


# --------------------------------------------------------------------- #
# two-limb arithmetic mod 2^64 on int64 tensors holding [0, 2^32) values


def _neg64(hi, lo):
    nlo = ((_M32 - lo) + 1) & _M32
    nhi = ((_M32 - hi) + (nlo == 0).to(torch.int64)) & _M32
    return nhi, nlo


def _add64(ah, al, bh, bl):
    lo = al + bl
    return (ah + bh + (lo >> 32)) & _M32, lo & _M32


def _sub64(ah, al, bh, bl):
    nh, nl = _neg64(bh, bl)
    return _add64(ah, al, nh, nl)


def _to_u32(x):
    """float32 >= 0 -> int64 in [0, 2^32 - 1], saturating as XLA's
    float32 -> uint32 conversion does."""
    return torch.clamp(torch.clamp(x, max=float(2 ** 32)).to(torch.int64), max=_M32)


def _encode64(x):
    """Finite float32 -> signed 64-bit fixed point, two limbs; the fraction
    truncates to the 2^-32 grid (``x - floor(x)`` is exact)."""
    x = x.to(torch.float32)
    ax = torch.abs(x)
    hi_f = torch.floor(ax)
    frac = ax - hi_f
    hi = _to_u32(hi_f)
    lo = _to_u32(frac * 2.0 ** 32)
    nhi, nlo = _neg64(hi, lo)
    neg = x < 0
    return torch.where(neg, nhi, hi), torch.where(neg, nlo, lo)


def _decode64(hi, lo):
    """Signed 64-bit fixed point -> float32 (one rounding, as JAX's)."""
    neg = hi >= 0x80000000
    mh, ml = _neg64(hi, lo)
    mag_hi = torch.where(neg, mh, hi).to(torch.float32)
    mag_lo = torch.where(neg, ml, lo).to(torch.float32)
    mag = mag_hi * 2.0 ** 32 + mag_lo
    return torch.where(neg, -mag, mag) * 2.0 ** -FRACTION_BITS


# --------------------------------------------------------------------- #


def pad_seed(key, masking, axis=None):
    """The step's pad seed: the masking seed folded with the key's mask
    salt and, on a W-rank axis, the rank."""
    seed = fold_in_seed(masking.base_seed, fold_in_seed(key, MASK_KEY_TAG))
    if axis is not None:
        seed = fold_in_seed(seed, axis.rank)
    return seed


def draw_pads(shape, seed, device):
    """(mask_hi, mask_lo): int64 tensors of ``shape``, uniform in [0, 2^32),
    from the seeds ``fold_in_seed(seed, 0)`` and ``fold_in_seed(seed, 1)``."""
    pads = []
    for limb in (0, 1):
        generator = torch.Generator(device=device).manual_seed(fold_in_seed(seed, limb))
        pads.append(torch.randint(0, 2 ** 32, shape, generator=generator, dtype=torch.int64, device=device))
    return tuple(pads)


def masked_group_mean(grouped, key, masking, axis=None, pads=None):
    """(G, s, d) grouped rows -> (G, d) float32 group means, the pairwise
    masks cancelled exactly mod 2^64; a group holding a non-finite value is
    NaN.  ``key`` is the rule's per-step key (required: the masks redraw
    every step), ``axis`` the worker axis of a column block; ``pads``
    overrides the drawn (mask_hi, mask_lo) pair (the tests inject JAX's)."""
    if key is None:
        raise UserException("bucket-level masking needs the per-step PRNG key (both engines pass it; the keyless "
                            "dense/oracle tier cannot run masked)")
    nb_groups, group_size, dim = grouped.shape
    x = grouped.to(torch.float32)
    finite = torch.isfinite(x)
    group_ok = torch.all(finite.reshape(nb_groups, -1), dim=1)
    hi, lo = _encode64(torch.where(finite, x, 0.0))
    if masking.enabled:
        if pads is None:
            # each leaf's own pads under a bucket's LeafKeys
            pads = draw_keyed(key, lambda seed: draw_pads(x.shape, pad_seed(seed, masking, axis), x.device))
        mask_hi, mask_lo = (torch.as_tensor(p, device=x.device).to(torch.int64) for p in pads)
        # the chain: member j adds m_j and subtracts m_{(j+1) mod s}, so the
        # group's sum of masks telescopes to 0 mod 2^64
        rh, rl = _sub64(mask_hi, mask_lo, torch.roll(mask_hi, -1, dims=1), torch.roll(mask_lo, -1, dims=1))
        hi, lo = _add64(hi, lo, rh, rl)
    acc_hi = torch.zeros((nb_groups, dim), dtype=torch.int64, device=x.device)
    acc_lo = torch.zeros((nb_groups, dim), dtype=torch.int64, device=x.device)
    for member in range(group_size):
        acc_hi, acc_lo = _add64(acc_hi, acc_lo, hi[:, member], lo[:, member])
    # a true division by a device tensor (CUDA divides by a host scalar as a
    # product with its reciprocal)
    mean = _decode64(acc_hi, acc_lo) / torch.full((), float(group_size), dtype=torch.float32, device=x.device)
    return torch.where(group_ok[:, None], mean, float("nan"))


def enable_masking(gar, masking):
    """Attach ``masking`` to a meta-GAR, checking that its groups reduce by
    a mean: ``bucketing`` (s >= 2, any inner rule over the bucket means) or
    ``hier`` with ``inner=average`` (g >= 2).  Returns ``gar``."""
    from ..gars.average import AverageGAR
    from ..gars.bucketing import BucketingGAR
    from ..gars.hierarchical import HierarchicalGAR

    if isinstance(gar, BucketingGAR):
        if gar.s < 2:
            raise UserException("masking over buckets of s=%d hides nothing (each row IS its bucket mean); use "
                                "s >= 2" % gar.s)
    elif isinstance(gar, HierarchicalGAR):
        if not isinstance(gar.inner, AverageGAR):
            raise UserException(
                "bucket-level masking cancels only inside a MEAN group reduction: hier needs inner=average (got "
                "inner=%s); bucketing works with any inner rule (its buckets are means)" % type(gar.inner).__name__)
        if gar.g < 2:
            raise UserException("masking over hier groups of g=%d hides nothing; use g >= 2" % gar.g)
    else:
        raise UserException("bucket-level masking needs a mean-inner meta-GAR spec — 'bucketing:s=...,inner=...' "
                            "or 'hier:g=...,inner=average,outer=...' — got %s" % type(gar).__name__)
    gar.masking = masking
    return gar
