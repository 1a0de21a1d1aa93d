"""The wire's precision: what a row looks like after it crossed the exchange.

Counterpart of the dtype part of ``aggregathor_tpu/parallel/compress.py``
(``parse_exchange_spec``, ``wire_roundtrip``, ``bytes_per_row``,
``compression_ratio``).  ``--exchange-dtype bfloat16`` sends each worker's
row as bfloat16 and the GAR computes in float32 on the values that arrived;
float32 is the identity.  ``tree``'s ``link=`` reads its spec with
``parse_exchange_spec``.  The codecs (``int8``, ``topk``, error feedback)
are not ported: their specs are refused.

The round trip is torch's float32 -> bfloat16 cast (round to nearest, ties
to even) and back: bit for bit the JAX package's ``astype`` on every value,
subnormals included, except NaN, which comes back as a NaN of another sign
and payload (every consumer tests ``isfinite``/``isnan``, never a NaN's
bits).
"""

import torch

from ..utils import UserException

_F32_BYTES = 4


def wire_dtype(dtype):
    """The engine's exchange dtype from a name or a ``torch.dtype``: None
    for the float32 wire (no round trip), else a floating dtype."""
    if dtype is None:
        return None
    resolved = getattr(torch, dtype, None) if isinstance(dtype, str) else dtype
    if not isinstance(resolved, torch.dtype) or not resolved.is_floating_point:
        raise UserException("exchange_dtype wants a floating dtype such as bfloat16, got %r" % (dtype,))
    return None if resolved == torch.float32 else resolved


def parse_exchange_spec(spec):
    """An exchange spec -> ``(exchange_dtype, codec)``: ``(None, None)`` for
    ``f32``/``float32`` (and None), ``(torch.bfloat16, None)`` for
    ``bf16``/``bfloat16``.  The JAX package's ``int8[:ef]`` and
    ``topk:...`` codecs refuse with a UserException: the port has no codec
    yet, and a codec is never replaced by another wire."""
    if spec is None:
        return None, None
    if not isinstance(spec, str):
        raise UserException("an exchange spec is a string such as f32 or bf16 (got %r)" % (spec,))
    name, _, body = spec.partition(":")
    name = name.strip().lower()
    if name in ("f32", "float32", "bf16", "bfloat16"):
        if body.strip():
            raise UserException("exchange %s does not take option(s) %s" % (name, body.strip()))
        return (None if name in ("f32", "float32") else torch.bfloat16), None
    if name in ("int8", "topk"):
        raise UserException(
            "exchange spec %r: the %s wire codec is not available in the PyTorch port yet (ROADMAP.md queue 1 "
            "item 6 brings the codecs of parallel/compress.py); f32 and bf16 are" % (spec, name))
    raise UserException("unknown exchange spec %r (know: f32, bf16; int8 and topk are not ported)" % (spec,))


def wire_roundtrip(rows, dtype=None):
    """``rows`` as they arrive over a ``dtype`` wire, in float32 (``rows``
    itself on the float32 wire)."""
    if dtype is None:
        return rows
    return rows.to(dtype).to(torch.float32)


def bytes_per_row(d, dtype=None):
    """Wire bytes of one (d,) row under the exchange dtype."""
    itemsize = _F32_BYTES if dtype is None else torch.empty((), dtype=dtype).element_size()
    return int(d) * itemsize


def compression_ratio(d, dtype=None):
    """float32-wire bytes of a (d,) row over its bytes under the exchange
    dtype (>= 1): the runner's ``exchange_compression_ratio`` gauge."""
    return bytes_per_row(d) / bytes_per_row(d, dtype)
