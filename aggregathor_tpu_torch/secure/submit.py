"""Authenticated gradient submission: row digests on the device, HMAC on the host.

Counterpart of ``aggregathor_tpu/secure/submit.py``.

- **On the rows' device** (the engine's step): each worker's flattened
  row, as submitted and as received, is reduced to a position-sensitive
  checksum (:func:`row_digest`, four multiply-shift lanes over the float32
  bit patterns).  A row whose tag cannot verify (the chaos ``forge``
  regime: the submitter never held the session secret; ``tamper``: bits
  flipped after signing, :func:`tamper_row`) is NaN before the rule sees
  it, so the rules absorb the rejection in the f budget of a lossy row.
  The digests and the verdicts ride ``metrics["secure"]`` to the host.
- **On the host** (:class:`SubmissionAuthenticator`, fed by the runner one
  call behind): each worker's digest bytes are HMAC-tagged under its
  ``b"submit"`` key (``parallel/auth.py``), every tag is verified against
  the received digest, failures are counted, journalled and named to the
  forensics ledger as ``forgery`` evidence, and the verified tags extend
  a tag chain whose head the custody manifest signs (``secure/custody.py``).

The digest arithmetic is 32-bit modular in JAX; torch has no uint32
arithmetic, so it runs in int64 on values in [0, 2^32): every product
splits one factor into 16-bit halves and is reduced mod 2^32, so the lane
sums stay below 2^63 up to d = 2^31 coordinates and the digest equals
JAX's bit for bit.  The result is a uint32 tensor.
"""

import hashlib
import struct
import time

import numpy as np
import torch

from ..obs import events
from ..parallel.auth import GradientAuthenticator

#: uint32 checksum lanes per row digest (16 bytes of tag material)
DIGEST_LANES = 4

#: per-lane odd multipliers and offsets of the multiply-shift family
_LANE_MULT = (0x85EBCA6B, 0xC2B2AE35, 0x27D4EB2F, 0x9E3779B1)
_LANE_ADD = (0x165667B1, 0x5BD1E995, 0x2545F491, 0x61C88647)

#: what a forger without the session secret signs with
FORGER_SECRET = b"forger-without-the-session-secret"

#: scale of a forged (impersonated) submission's Gaussian noise: what an
#: undefended run aggregates when the chaos ``forge`` regime fires without
#: secure submission
FORGE_SCALE = 8.0

_M32 = 0xFFFFFFFF


def _mul32(a, b):
    """``a * b mod 2^32`` for int64 tensors (or ints) holding values in
    [0, 2^32): ``a``'s 16-bit halves keep each product below 2^48."""
    return (((((a >> 16) * b) & 0xFFFF) << 16) + (a & 0xFFFF) * b) & _M32


def lane_weights(d, salt, device):
    """(DIGEST_LANES, d) int64: lane L's weight of coordinate c,
    ``A_L * (c + salt) + B_L mod 2^32``.  The constants stay Python ints:
    a tensor of them made on the host would be a pageable copy to the
    card, which waits for the card to drain."""
    idx = (torch.arange(d, dtype=torch.int64, device=device) + (int(salt) & _M32)) & _M32
    return torch.stack([(_mul32(idx, mult) + add) & _M32 for mult, add in zip(_LANE_MULT, _LANE_ADD)])


def row_digest(rows, salt=0):
    """(..., d) float rows -> (..., DIGEST_LANES) uint32 checksums, on the
    rows' device: lane L = sum_c bits(row[c]) * (A_L (c + salt) + B_L) mod
    2^32 over the float32 bit patterns.  Deterministic, order- and
    value-sensitive; not a cryptographic hash (the HMAC over the digest
    is)."""
    rows = rows.to(torch.float32)
    bits = rows.contiguous().view(torch.int32).to(torch.int64) & _M32
    weights = lane_weights(rows.shape[-1], salt, rows.device)
    high, low = bits >> 16, bits & 0xFFFF
    lanes = []
    for lane in range(DIGEST_LANES):
        weight = weights[lane]
        # bits * weight mod 2^32, as _mul32 with the halves taken once
        term = ((((high * weight) & 0xFFFF) << 16) + low * weight) & _M32
        lanes.append(torch.sum(term, dim=-1) & _M32)
    return torch.stack(lanes, dim=-1).to(torch.uint32)


def tamper_row(row, coord):
    """In-transit bit corruption (the chaos ``tamper`` mode): the lowest
    exponent bit of coordinate ``coord`` flipped (the value doubles or
    halves).  Returns a new float32 row."""
    bits = row.to(torch.float32).contiguous().view(torch.int32).clone()
    bits[int(coord)] ^= 1 << 23
    return bits.view(torch.float32)


def digest_to_bytes(digest):
    """One host digest row ((DIGEST_LANES,) uint32) -> the 16 bytes the
    HMAC signs (little-endian)."""
    if isinstance(digest, torch.Tensor):
        digest = digest.cpu().numpy()
    return np.ascontiguousarray(np.asarray(digest, dtype="<u4")).tobytes()


def _host_digests(digests):
    if isinstance(digests, torch.Tensor):
        digests = digests.cpu().numpy()
    return np.ascontiguousarray(np.asarray(digests, dtype="<u4"))


class SubmissionAuthenticator:
    """Host-side sign and verify of each step's submission digests.

    Per-worker keys derive once from the session secret under
    ``b"submit"``; ``sign_many``/``verify_many`` tag a step's (n,
    DIGEST_LANES) stack.  Workers flagged ``forged`` sign under
    :data:`FORGER_SECRET`'s keys, as an impersonator would, so their tags
    fail; a tampered submission is signed over the digest sent and
    verified against the digest received, and fails too.  Every verified
    step extends ``chain()``: head' = SHA-256(head || step || tags ||
    verdicts).  With a ``registry`` the ``secure_sign_seconds_total``,
    ``secure_verify_seconds_total``, ``secure_submissions_total`` and
    ``secure_forgeries_total{worker}`` counters count the work.
    """

    def __init__(self, session_secret, nb_workers, registry=None):
        self.nb_workers = int(nb_workers)
        self.auth = GradientAuthenticator(session_secret, self.nb_workers, context=b"submit")
        self._forger = GradientAuthenticator(FORGER_SECRET, self.nb_workers, context=b"submit")
        self._chain = hashlib.sha256(b"aggregathor-tag-chain-v1").digest()
        self._chain_steps = 0
        self._c_sign = self._c_verify = self._c_submissions = self._c_forgeries = None
        if registry is not None:
            self._c_sign = registry.counter("secure_sign_seconds_total",
                                            "Cumulative submission-tag signing wall time")
            self._c_verify = registry.counter("secure_verify_seconds_total",
                                              "Cumulative submission-tag verification wall time")
            self._c_submissions = registry.counter("secure_submissions_total", "Worker submissions processed")
            self._c_forgeries = registry.counter("secure_forgeries_total",
                                                 "Submissions whose tag failed verification",
                                                 labelnames=("worker",))

    def sign_step(self, step, sent_digests, forged=None):
        """The (n, 32) uint8 tags of one step's sent digests; ``forged`` an
        optional (n,) bool mask of workers signing without the secret."""
        sent = _host_digests(sent_digests)
        if sent.shape[0] != self.nb_workers:
            raise ValueError("sign_step got %d digest rows for %d workers" % (sent.shape[0], self.nb_workers))
        begin = time.perf_counter()
        tags = self.auth.sign_many(step, sent)
        if forged is not None:
            for worker in np.nonzero(np.asarray(forged).astype(bool))[0]:
                tags[worker] = np.frombuffer(self._forger.sign(int(worker), step, digest_to_bytes(sent[worker])),
                                             np.uint8)
        elapsed = time.perf_counter() - begin
        if self._c_sign is not None:
            self._c_sign.inc(elapsed)
            self._c_submissions.inc(self.nb_workers)
        return tags

    def verify_step(self, step, recv_digests, tags):
        """The (n,) bool verdicts (True: the tag verifies) of one step's
        tags against the received digests; extends the tag chain."""
        recv = _host_digests(recv_digests)
        begin = time.perf_counter()
        ok = self.auth.verify_many(step, recv, tags)
        elapsed = time.perf_counter() - begin
        rejected = np.nonzero(~ok)[0]
        if self._c_verify is not None:
            self._c_verify.inc(elapsed)
            for worker in rejected:
                self._c_forgeries.labels(worker=str(int(worker))).inc()
        if rejected.size:
            # a failed tag is a decision: the row was rejected inside the f
            # budget and the worker named
            events.emit("forgery_verdict", step=step, workers=[int(w) for w in rejected],
                        nb_rejected=int(rejected.size))
        self._chain = hashlib.sha256(self._chain + struct.pack("<q", int(step))
                                     + np.ascontiguousarray(tags).tobytes() + ok.tobytes()).digest()
        self._chain_steps += 1
        return ok

    def process_step(self, step, sent_digests, recv_digests, forged=None):
        """Sign, then verify, one completed step; returns the (n,) verdicts."""
        tags = self.sign_step(step, sent_digests, forged=forged)
        return self.verify_step(step, recv_digests, tags)

    def chain(self):
        """The tag chain's lineage, what the custody manifest signs."""
        return {"head": self._chain.hex(), "steps": self._chain_steps, "nb_workers": self.nb_workers}
