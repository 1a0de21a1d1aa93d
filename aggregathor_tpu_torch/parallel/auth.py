"""Host-level authentication: per-worker HMAC keys and the bring-up handshake.

Counterpart of ``aggregathor_tpu/parallel/auth.py``.  One session secret
derives a family of per-worker keys for each protocol (``context``:
``b"submit"``, ``b"ckpt"``, ``b"ckpt-enc"``, ``b"handshake"``,
``b"handshake-enc"``, ``b"custody"``): key = SHA-256(secret ||
len(context) || context || worker), the lengths and the index as
little-endian int64.  A tag is HMAC-SHA256 under worker w's key over
(w, step) as two little-endian int64 followed by the payload, so a tag
binds its worker and its step; verification compares in constant time.

Two backends make the same bytes: the host C++ library (``ops/native``,
``auth.cpp``), which every call uses, and the standard library's
``hashlib``/``hmac``, which the tests switch to by replacing
``_native_ok``.  When the native library cannot be built the call
raises; it does not switch backends.

``authenticate_processes`` is the handshake of a W-rank run (the port's
worker axis, ``parallel/mesh.py``): every rank encrypts the SHA-256 of its
parameters (``state_digest``) under the ``b"handshake-enc"`` cipher, tags
the ciphertext under its ``b"handshake"`` key, and one ``all_gather`` of
the fixed-length ``ciphertext || tag`` byte rows hands every rank every
other's; each rank verifies every tag, decrypts every payload and, for
the flat engine's replicated parameters, checks that every digest equals
its own.  The JAX package gathers the same rows with
``multihost_utils.process_allgather``; its error messages are kept.
"""

import hashlib
import hmac as _py_hmac
import struct

import numpy as np
import torch

from ..ops import native

def _native_ok():
    """The native backend is the one in use (a failed build raises)."""
    return True


def _sha256(material):
    return native.sha256(material) if _native_ok() else hashlib.sha256(material).digest()


def derive_worker_key(session_secret, worker_index, context=b"gradient"):
    """Worker ``worker_index``'s key of the ``context`` family:
    SHA-256(secret || len(context) || context || index)."""
    material = (bytes(session_secret) + struct.pack("<q", len(context)) + bytes(context)
                + struct.pack("<q", int(worker_index)))
    return _sha256(material)


def derive_worker_key_legacy(session_secret, worker_index):
    """The derivation before contexts (secret || index): verifies, once,
    snapshots tagged under it; never signs."""
    return _sha256(bytes(session_secret) + struct.pack("<q", int(worker_index)))


def _message(worker_index, step, payload):
    # the (worker, step) header binds the tag to its sender and its step
    return struct.pack("<qq", int(worker_index), int(step)) + bytes(payload)


def _hmac(key, message):
    if _native_ok():
        return native.hmac_sha256(key, message)
    return _py_hmac.new(key, message, hashlib.sha256).digest()


def _hmac_verify(key, message, tag):
    if _native_ok():
        return native.hmac_verify(key, message, bytes(tag))
    return _py_hmac.compare_digest(_py_hmac.new(key, message, hashlib.sha256).digest(), bytes(tag))


class GradientAuthenticator:
    """Signs and verifies per-worker byte payloads under per-worker keys of
    one ``context`` family (derived once, at construction)."""

    def __init__(self, session_secret, nb_workers, context=b"gradient"):
        self.nb_workers = int(nb_workers)
        self.keys = [derive_worker_key(session_secret, w, context=context) for w in range(self.nb_workers)]
        # kept only for verify_legacy's one-time migration
        self._secret = bytes(session_secret)

    def sign(self, worker_index, step, payload):
        """The 32-byte tag of ``payload`` from ``worker_index`` at ``step``."""
        if not 0 <= int(worker_index) < self.nb_workers:
            raise ValueError("worker_index %r out of range [0, %d)" % (worker_index, self.nb_workers))
        return _hmac(self.keys[worker_index], _message(worker_index, step, payload))

    def verify(self, worker_index, step, payload, tag):
        """Constant-time check; False for a bad index, another step or a forgery."""
        if not 0 <= int(worker_index) < self.nb_workers:
            return False
        return _hmac_verify(self.keys[worker_index], _message(worker_index, step, payload), tag)

    def sign_many(self, step, rows):
        """(n, ...) rows -> (n, 32) uint8 tags; row w's tag is
        ``sign(w, step, rows[w].tobytes())``.  One message buffer serves
        every row (the header packed in place, the payload copied in)."""
        rows = np.ascontiguousarray(rows)
        if rows.shape[0] != self.nb_workers:
            raise ValueError("sign_many got %d rows for %d workers" % (rows.shape[0], self.nb_workers))
        row_bytes = rows.nbytes // self.nb_workers if self.nb_workers else 0
        flat = rows.reshape(self.nb_workers, -1).view(np.uint8).reshape(self.nb_workers, row_bytes)
        tags = np.empty((self.nb_workers, 32), np.uint8)
        message = bytearray(16 + row_bytes)
        for worker in range(self.nb_workers):
            struct.pack_into("<qq", message, 0, worker, int(step))
            message[16:] = flat[worker].tobytes()
            tags[worker] = np.frombuffer(_hmac(self.keys[worker], bytes(message)), np.uint8)
        return tags

    def verify_many(self, step, rows, tags):
        """(n, ...) rows and (n, 32) tags -> (n,) bool, each row compared in
        constant time."""
        expect = self.sign_many(step, rows)
        tags = np.ascontiguousarray(tags).reshape(self.nb_workers, -1)
        ok = np.empty((self.nb_workers,), bool)
        for worker in range(self.nb_workers):
            ok[worker] = _py_hmac.compare_digest(expect[worker].tobytes(), tags[worker].tobytes())
        return ok

    def verify_legacy(self, worker_index, step, payload, tag):
        """Verify under the derivation before contexts: a restore's one-time
        migration path, never used to sign."""
        if not 0 <= int(worker_index) < self.nb_workers:
            return False
        key = derive_worker_key_legacy(self._secret, worker_index)
        return _hmac_verify(key, _message(worker_index, step, payload), tag)


def state_digest(params):
    """SHA-256 of the float32 parameters' bytes in the JAX package's
    coordinate order (``core.flatten.FlatMap``): the bytes JAX hashes leaf
    by leaf in pytree order, so the digest of carried-over weights equals
    JAX's."""
    from ..core.flatten import FlatMap

    with torch.no_grad():
        flat = FlatMap(params).flatten(params).cpu()
    return hashlib.sha256(flat.numpy().tobytes()).digest()


def authenticate_processes(session_secret, params, step=0, verify_equal=True, axis=None):
    """The bring-up handshake over ``axis`` (a ``parallel.mesh.WorkerAxis``;
    None or W = 1: this process alone).  Every rank calls it.  Raises a
    UserException naming the ranks whose payload does not authenticate (a
    wrong ``--session-secret`` or a tampered payload) or, under
    ``verify_equal``, whose parameters differ from this rank's.  Returns W."""
    from ..utils import UserException
    from .crypto import SnapshotCipher

    nb = 1 if axis is None else axis.size
    pid = 0 if axis is None else axis.rank
    auth = GradientAuthenticator(session_secret, nb, context=b"handshake")
    cipher = SnapshotCipher(session_secret, context=b"handshake-enc")
    digest = state_digest(params)
    ct = cipher.encrypt(step, digest)
    ct_len = len(ct)  # fixed: magic, nonce, sentinel and the 32-byte digest
    mine = np.frombuffer(ct + auth.sign(pid, step, ct), np.uint8)
    if nb == 1:
        gathered = mine[None]
    else:
        row = torch.from_numpy(mine.copy()).to(axis.device)
        gathered = axis.all_gather(row).cpu().numpy()

    def _digest_of(rank):
        """The rank's digest if its payload authenticates and decrypts, else None."""
        row_ct = gathered[rank, :ct_len].tobytes()
        if not auth.verify(rank, step, row_ct, gathered[rank, ct_len:].tobytes()):
            return None
        try:
            return cipher.decrypt(step, row_ct)
        except UserException:
            return None

    digests = {rank: _digest_of(rank) for rank in range(nb)}
    bad = [rank for rank in range(nb) if digests[rank] is None]
    if bad:
        raise UserException(
            "Host authentication FAILED for process(es) %s: payload tampered or "
            "--session-secret mismatch; refusing to train with unauthenticated "
            "hosts (reference parity: mpi_rendezvous_mgr.patch:585-627)"
            % ", ".join(map(str, bad)))
    if verify_equal:
        mismatched = [rank for rank in range(nb) if digests[rank] != digest]
        if mismatched:
            raise UserException(
                "Host state DIVERGED at bring-up: process(es) %s hold different "
                "parameter bytes than process %d (bad restore or nondeterministic "
                "init); collectives would silently corrupt from step one"
                % (", ".join(map(str, mismatched)), pid))
    return nb
