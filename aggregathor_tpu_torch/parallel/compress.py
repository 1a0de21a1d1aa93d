"""Wire codecs: what a gradient row looks like after it crossed the exchange.

Counterpart of ``aggregathor_tpu/parallel/compress.py``.  Every worker's
submission is encoded at the sender (after the worker-local attacks: an
attacker forges what it transmits), crosses the simulated transport as the
encoded payload (a dropped packet drops encoded bytes, so the lossy masks
land on the decoded image), and is decoded at the aggregation boundary, so
every rule sees float32 rows.  Specs (``--exchange``,
``parse_exchange_spec``):

- ``f32``/``float32``: the uncompressed wire (no codec, no cast);
- ``bf16``/``bfloat16``: the engine's ``exchange_dtype`` twin, 2x;
- ``int8[:ef]``: per-row symmetric quantization, ``q = clip(round(row /
  safe), -127, 127)`` with ``scale = max|row| * fl(1/127)`` and ``safe`` the scale
  where it is finite and > 0, else 1; a row whose magnitude is non-finite
  decodes to a NaN row (~3.97x at large d);
- ``topk:k=K[,ef]`` / ``topk:frac=F[,ef]``: the k largest magnitudes as
  (float32 value, int32 index) pairs, NaN ranked as +inf, the rest decoded
  to zero (d / 2k x).

``ef`` adds error feedback: the worker sends ``C(g + e)`` and keeps ``e' =
(g + e) - C(g + e)`` coordinate by coordinate where the decoded image is
finite, else 0 (a NaN row must not poison every later send).  The engine
carries the residual in ``TrainState.ef`` (the rank's (k, d) rows), which
the checkpoint saves and restores bit for bit.

Three traps of the translation, held against the JAX package bit for bit
(``tests/test_torch_codec.py``) and the card against the CPU
(``tests/test_torch_gpu.py``, ``chip_smoke.py``):

- int8's scale is ``max|row|`` times the float32 reciprocal of 127: XLA
  rewrites a division by a constant into that multiply, so it is what the
  JAX engine's compiled step computes (a true division differs by an ulp
  on some rows, and the residual carries the ulp into later quotients);
- int8's quotient is a true division by a tensor on the rows' device: a
  multiply by the reciprocal (what CUDA does for a host scalar divisor)
  moves half-way cases by one quantum;
- top-k selects by a stable descending sort of the magnitudes, so equal
  magnitudes (several NaN, zeros, repeated values) keep the lower index, as
  ``jax.lax.top_k`` does; ``torch.topk`` promises no tie order.

``wire_roundtrip`` is the one place that applies the wire to rows that
cross it (the omniscient attack's forged matrix goes through it again, as
in JAX).  The codecs are plain torch on both devices, as they are plain
``jnp`` in JAX: no TPU kernel stands behind them.
"""

import torch

from ..utils import UserException

#: wire bytes of one float32 coordinate / one float32 scalar
_F32_BYTES = 4
#: wire bytes of one int32 coordinate index (top-k payload)
_I32_BYTES = 4


def wire_dtype(dtype):
    """The engine's exchange dtype from a name or a ``torch.dtype``: None
    for the float32 wire (no round trip), else a floating dtype."""
    if dtype is None:
        return None
    resolved = getattr(torch, dtype, None) if isinstance(dtype, str) else dtype
    if not isinstance(resolved, torch.dtype) or not resolved.is_floating_point:
        raise UserException("exchange_dtype wants a floating dtype such as bfloat16, got %r" % (dtype,))
    return None if resolved == torch.float32 else resolved


def _parse_options(body):
    """``k=64,ef`` -> {"k": "64", "ef": True}; bare keys are flags."""
    options = {}
    for part in body.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" in part:
            key, value = part.split("=", 1)
            options[key.strip()] = value.strip()
        else:
            options[part] = True
    return options


def parse_exchange_spec(spec):
    """An exchange spec -> ``(exchange_dtype, codec)``: ``(None, None)`` for
    ``f32`` (and None), ``(torch.bfloat16, None)`` for ``bf16``, ``(None,
    codec)`` for ``int8``/``topk``.  A :class:`WireCodec` passes through."""
    if spec is None:
        return None, None
    if isinstance(spec, WireCodec):
        return None, spec
    if not isinstance(spec, str):
        raise UserException("--exchange wants a spec string or a WireCodec (got %r)" % (spec,))
    name, _, body = spec.partition(":")
    name = name.strip().lower()
    options = _parse_options(body)

    def reject_options(allowed=()):
        unknown = sorted(set(options) - set(allowed))
        if unknown:
            raise UserException("--exchange %s does not take option(s) %s" % (name, ", ".join(unknown)))

    def ef_flag():
        # a bare flag: ef=0 reads as an intent to disable, and enabling it
        # would change the train state's layout behind the operator's back
        ef = options.get("ef", False)
        if ef is not True and ef is not False:
            raise UserException("--exchange %s: ef is a bare flag — write ':...,ef' to enable error feedback, "
                                "omit it to disable (got ef=%s)" % (name, ef))
        return ef

    if name in ("f32", "float32"):
        reject_options()
        return None, None
    if name in ("bf16", "bfloat16"):
        reject_options()
        return torch.bfloat16, None
    if name == "int8":
        reject_options(("ef",))
        return None, Int8Codec(ef=ef_flag())
    if name == "topk":
        reject_options(("k", "frac", "ef"))
        k, frac = options.get("k"), options.get("frac")
        if (k is None) == (frac is None):
            raise UserException("--exchange topk wants exactly one of k=K or frac=F (e.g. topk:k=4096,ef or "
                                "topk:frac=0.0625,ef)")
        try:
            k = None if k is None else int(k)
            frac = None if frac is None else float(frac)
        except ValueError:
            raise UserException("--exchange topk: k wants an int, frac a float")
        return None, TopKCodec(k=k, frac=frac, ef=ef_flag())
    raise UserException("unknown --exchange spec %r (know: f32, bf16, int8[:ef], topk:k=K[,ef], topk:frac=F[,ef])"
                        % (spec,))


class WireCodec:
    """One wire codec: ``encode`` at the sender, ``decode`` at the
    aggregation boundary, ``roundtrip`` for the wire image.  The row
    methods work on the last axis, so a (d,) row and (n, d) rows go
    through the same code, and ``decode`` takes the (n, ...) stack of n
    rows' payloads as it takes one (bounded-wait stacks the payloads that
    arrived); ``payload`` is a dict of tensors."""

    name = "wire"
    uses_ef = False

    def encode(self, row):
        raise NotImplementedError

    def decode(self, payload, d):
        raise NotImplementedError

    def bytes_per_row(self, d):
        """Wire bytes of one encoded (d,) row (payload and side channel)."""
        raise NotImplementedError

    def payload_zeros(self, d, device=None):
        """A zeroed payload of one (d,) row on ``device``: what a slot nobody
        submitted holds under bounded-wait (its content is never read: the
        aggregate masks the slot to NaN after decoding); only its keys,
        shapes and dtypes matter, to stack with the rows that arrived."""
        raise NotImplementedError

    def validate_d(self, d):
        """Refuse an infeasible budget once ``d`` is known."""

    def roundtrip(self, row):
        """The wire image of a row (or of rows): encode then decode."""
        return self.decode(self.encode(row), row.shape[-1])

    def ef_roundtrip(self, row, ef_row):
        """Error-feedback transmit: ``(wire_image, new_ef)``, the image
        ``C(row + ef)`` and the residual the worker keeps."""
        _, decoded, new_ef = self.ef_encode(row, ef_row)
        return decoded, new_ef

    def ef_encode(self, row, ef_row):
        """``(payload, wire_image, new_ef)``; the residual is 0 where the
        image is not finite."""
        target = row.to(torch.float32) + ef_row
        payload = self.encode(target)
        decoded = self.decode(payload, row.shape[-1])
        new_ef = torch.where(torch.isfinite(decoded), target - decoded, torch.zeros_like(target))
        return payload, decoded, new_ef

    def ratio(self, d):
        """Nominal compression ratio against the f32 wire."""
        return (d * _F32_BYTES) / float(self.bytes_per_row(d))

    def validate_for(self, gar=None):
        """Construction-time feasibility: the fixed-point masked path needs
        the exact float32 rows."""
        if gar is not None and getattr(gar, "masking", None) is not None:
            raise UserException(
                "--secure-mask's fixed-point pairwise pads cancel exactly mod 2^64 over the EXACT float32 rows; a "
                "lossy wire codec (%s) would corrupt the cancellation into one-time-pad garbage — run masking on "
                "the f32/bf16 wire" % self.spec())

    def spec(self):
        return self.name


class Int8Codec(WireCodec):
    """Per-row symmetric int8 quantization with a float32 scale riding the
    payload (4 bytes a row).  A row whose magnitude is non-finite cannot
    encode: its image is a NaN row."""

    name = "int8"

    def __init__(self, ef=False):
        self.uses_ef = bool(ef)

    def encode(self, row):
        row = row.to(torch.float32)
        # the scale as XLA compiles ``max / 127``, the quotient a true
        # division by a tensor on the rows' device (module docstring)
        scale = torch.amax(torch.abs(row), dim=-1) * torch.full((), 1.0 / 127.0, device=row.device)
        safe = torch.where((scale > 0) & torch.isfinite(scale), scale, torch.ones_like(scale))
        q = torch.clamp(torch.round(row / safe.unsqueeze(-1)), -127.0, 127.0)
        # a NaN coordinate would cast to an arbitrary int8: 0 (the scale is NaN anyway)
        q = torch.where(torch.isfinite(q), q, torch.zeros_like(q)).to(torch.int8)
        return {"q": q, "scale": scale}

    def decode(self, payload, d):
        scale = payload["scale"].unsqueeze(-1)
        out = payload["q"].to(torch.float32) * scale
        return torch.where(torch.isfinite(scale), out, torch.full_like(out, float("nan")))

    def bytes_per_row(self, d):
        return d + _F32_BYTES  # a byte a coordinate and the float32 scale

    def payload_zeros(self, d, device=None):
        return {"q": torch.zeros((d,), dtype=torch.int8, device=device),
                "scale": torch.zeros((), dtype=torch.float32, device=device)}

    def spec(self):
        return "int8:ef" if self.uses_ef else "int8"


class TopKCodec(WireCodec):
    """Magnitude top-k: the k largest |value| coordinates cross as (float32
    value, int32 index) pairs, the rest decode to zero; ``frac`` resolves to
    ``k = max(1, round(frac * d))``.  NaN ranks as +inf, so a poisoned
    coordinate crosses the wire; equal magnitudes keep the lower index."""

    name = "topk"

    def __init__(self, k=None, frac=None, ef=False):
        if k is not None and k < 1:
            raise UserException("--exchange topk wants k >= 1 (got %d)" % k)
        if frac is not None and not 0.0 < frac <= 1.0:
            raise UserException("--exchange topk wants frac in (0, 1] (got %g)" % frac)
        self.k = None if k is None else int(k)
        self.frac = None if frac is None else float(frac)
        self.uses_ef = bool(ef)

    def _k_for(self, d):
        k = self.k if self.k is not None else max(1, int(round(self.frac * d)))
        if k > d:
            raise UserException("--exchange topk: k=%d exceeds the model dimension d=%d (a sparsifier that keeps "
                                "more than everything is a misconfiguration, not a wire)" % (k, d))
        if k > d // 2:
            raise UserException("--exchange topk: k=%d > d/2 = %d INFLATES the wire (each kept coordinate ships "
                                "value + index, 8 bytes vs 4 raw) — use k <= d/2, or the f32/bf16 wire if you "
                                "want everything" % (k, d // 2))
        return k

    def validate_d(self, d):
        self._k_for(d)

    def encode(self, row):
        row = row.to(torch.float32)
        k = self._k_for(row.shape[-1])
        mag = torch.where(torch.isnan(row), torch.full_like(row, float("inf")), torch.abs(row))
        # stable descending sort: jax.lax.top_k's order, ties to the lower index
        idx = torch.sort(mag, dim=-1, descending=True, stable=True).indices.narrow(-1, 0, k)
        return {"v": torch.gather(row, -1, idx), "i": idx.to(torch.int32)}

    def decode(self, payload, d):
        values = payload["v"]
        out = torch.zeros(values.shape[:-1] + (d,), dtype=torch.float32, device=values.device)
        return out.scatter_(-1, payload["i"].to(torch.int64), values)

    def bytes_per_row(self, d):
        return self._k_for(d) * (_F32_BYTES + _I32_BYTES)

    def payload_zeros(self, d, device=None):
        k = self._k_for(d)
        return {"v": torch.zeros((k,), dtype=torch.float32, device=device),
                "i": torch.zeros((k,), dtype=torch.int32, device=device)}

    def spec(self):
        body = "k=%d" % self.k if self.k is not None else "frac=%g" % self.frac
        return "topk:%s%s" % (body, ",ef" if self.uses_ef else "")


def wire_roundtrip(rows, dtype=None, codec=None):
    """``rows`` as they arrive over the wire, in float32: the codec's image,
    or the ``dtype`` round trip (torch's round to nearest even; a NaN comes
    back a NaN of another payload), or ``rows`` itself on the f32 wire."""
    if codec is not None:
        return codec.roundtrip(rows)
    if dtype is not None:
        return rows.to(dtype).to(torch.float32)
    return rows


def bytes_per_row(d, dtype=None, codec=None):
    """Wire bytes of one (d,) submission row: what ``bytes_on_wire_total``
    counts."""
    if codec is not None:
        return int(codec.bytes_per_row(d))
    itemsize = _F32_BYTES if dtype is None else torch.empty((), dtype=dtype).element_size()
    return int(d) * itemsize


def compression_ratio(d, dtype=None, codec=None):
    """float32-wire bytes of a (d,) row over its bytes under the exchange
    (>= 1): the runner's ``exchange_compression_ratio`` gauge."""
    return (int(d) * _F32_BYTES) / float(bytes_per_row(d, dtype=dtype, codec=codec))

