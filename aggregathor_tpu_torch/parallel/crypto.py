"""Payload encryption under the session secret: checkpoints and the handshake.

Counterpart of ``aggregathor_tpu/parallel/crypto.py``, byte for byte the
same container, so a blob either package encrypts the other decrypts:

- key       = ``auth.derive_worker_key(secret, 0, context)`` (``b"ckpt-enc"``
              for snapshots, ``b"handshake-enc"`` for the bring-up payloads)
- nonce     = 16 fresh ``os.urandom`` bytes a blob
- keystream = SHAKE-256(key || nonce || step as little-endian int64)
- blob      = MAGIC || nonce || (SENTINEL || plaintext) XOR keystream

The step seasons the keystream, so two snapshots never share one even
under a repeated nonce.  Integrity is the HMAC tag's job
(``obs.checkpoint.Checkpoints`` tags the ciphertext: encrypt-then-MAC); the
plaintext sentinel makes a wrong secret or step fail loudly when no tag is
checked.
"""

import hashlib
import os
import struct

import numpy as np

from ..utils import UserException
from .auth import derive_worker_key

_MAGIC = b"ATPC1"  # the container's versioned tag
_SENTINEL = b"ATPP"  # plaintext marker: a wrong key cannot produce it
_NONCE_BYTES = 16


def _keystream(key, nonce, step, length):
    return hashlib.shake_256(key + nonce + struct.pack("<q", int(step))).digest(length)


def _xor(data, stream):
    return np.bitwise_xor(np.frombuffer(data, np.uint8), np.frombuffer(stream, np.uint8)).tobytes()


class SnapshotCipher:
    """Encrypts and decrypts byte blobs under a key of the session secret
    (``context`` selects the family: checkpoints by default)."""

    def __init__(self, session_secret, context=b"ckpt-enc"):
        self.key = derive_worker_key(session_secret, 0, context=context)

    def encrypt(self, step, data):
        nonce = os.urandom(_NONCE_BYTES)
        plain = _SENTINEL + bytes(data)
        return _MAGIC + nonce + _xor(plain, _keystream(self.key, nonce, step, len(plain)))

    def decrypt(self, step, blob):
        blob = bytes(blob)
        if not blob.startswith(_MAGIC):
            raise UserException(
                "Snapshot is not encrypted (or predates encryption): missing "
                "the %r container tag. Restore it without --encrypt-checkpoints; "
                "the next save writes an encrypted snapshot" % (_MAGIC,))
        nonce = blob[len(_MAGIC):len(_MAGIC) + _NONCE_BYTES]
        ct = blob[len(_MAGIC) + _NONCE_BYTES:]
        plain = _xor(ct, _keystream(self.key, nonce, step, len(ct)))
        if not plain.startswith(_SENTINEL):
            raise UserException("Snapshot decryption failed: wrong --session-secret or a corrupted snapshot")
        return plain[len(_SENTINEL):]

    @staticmethod
    def is_encrypted(blob):
        return bytes(blob[:len(_MAGIC)]) == _MAGIC
