"""The port's host authentication (``parallel/auth.py``, ``parallel/crypto.py``,
the HMAC of ``ops/native``) and the checkpoints' tags, encryption and
legacy migration, against the JAX package.

Held bit for bit (tolerance: none):

- ``ops/native``'s SHA-256 and HMAC-SHA256 against ``hashlib``/``hmac``;
- ``derive_worker_key`` for every context and the legacy form, ``sign``,
  ``sign_many``, ``verify_many`` and ``verify_legacy`` against the JAX
  package's, under both backends (native and hashlib), which interoperate;
- ``SnapshotCipher``: a blob either package encrypts, the other decrypts;
  a wrong step or secret refuses with JAX's message;
- ``state_digest`` of carried-over weights equals JAX's (trap x).

Behaviour as in JAX's ``tests/test_auth.py``: worker and step binding,
context separation, the checkpoints' tag (a flipped byte refused, a plain
manager still reading it), encrypt-then-MAC (a tampered ciphertext dies at
the tag before a keystream byte is derived), the legacy tag's one-time
migration and ``allow_legacy_tags=False``, and the bring-up handshake's
encrypted payload with a faked two-rank gather (a wrong secret, diverged
parameters and a flipped ciphertext byte named by rank).  The two-rank
handshake over gloo is in ``test_torch_secure.py``'s one spawn.
"""

import hashlib
import hmac
import struct

import jax
import numpy as np
import pytest
import torch

from aggregathor_tpu.parallel import auth as jauth
from aggregathor_tpu.parallel import crypto as jcrypto
from aggregathor_tpu.utils import UserException as JaxUserException
from aggregathor_tpu_torch.core import build_optimizer, build_schedule
from aggregathor_tpu_torch.core.train_state import TrainState
from aggregathor_tpu_torch.obs.checkpoint import Checkpoints
from aggregathor_tpu_torch.ops import native
from aggregathor_tpu_torch.parallel import auth
from aggregathor_tpu_torch.parallel.auth import GradientAuthenticator, derive_worker_key
from aggregathor_tpu_torch.parallel.crypto import _MAGIC, SnapshotCipher
from aggregathor_tpu_torch.utils import UserException

CONTEXTS = (b"gradient", b"submit", b"ckpt", b"ckpt-enc", b"handshake", b"handshake-enc", b"custody")


@pytest.fixture(params=["native", "hashlib"])
def backend(request, monkeypatch):
    """The policy layer over both backends (the port's and JAX's alike)."""
    if request.param == "hashlib":
        monkeypatch.setattr(auth, "_native_ok", lambda: False)
        monkeypatch.setattr(jauth, "_native_ok", lambda: False)
    return request.param


# --------------------------------------------------------------------------- #
# the native library

@pytest.mark.parametrize("size", [0, 1, 55, 56, 63, 64, 65, 1000, 10_000])
def test_native_sha256_and_hmac_match_hashlib(size):
    data = (bytes(range(256)) * (size // 256 + 1))[:size]
    assert native.sha256(data) == hashlib.sha256(data).digest()
    assert native.sha256(np.frombuffer(data, np.uint8)) == hashlib.sha256(data).digest()
    for keylen in (1, 32, 64, 65, 200):
        key = b"k" * keylen
        assert native.hmac_sha256(key, data) == hmac.new(key, data, hashlib.sha256).digest()


def test_native_hmac_verify_is_strict():
    tag = native.hmac_sha256(b"secret", b"payload")
    assert native.hmac_verify(b"secret", b"payload", tag)
    assert not native.hmac_verify(b"secret", b"payload", bytes(32))
    assert not native.hmac_verify(b"secret", b"payload", tag[:31])  # a wrong length


def test_a_failed_native_build_raises(monkeypatch, tmp_path):
    """No fallback: with the native backend chosen and no compiler, a key
    derivation raises instead of switching to hashlib."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "library_path", lambda: str(tmp_path / "libagg_host.so"))
    monkeypatch.setenv("AGTPU_NATIVE_CXX", "no-such-compiler-anywhere")
    with pytest.raises(RuntimeError, match="compiler"):
        derive_worker_key(b"s", 0)


# --------------------------------------------------------------------------- #
# keys and tags against the JAX package

@pytest.mark.parametrize("context", CONTEXTS, ids=[c.decode() for c in CONTEXTS])
def test_derived_keys_equal_jax(backend, context):
    for secret in (b"s", b"session-secret", bytes(range(100))):
        for worker in (0, 1, 7):
            assert derive_worker_key(secret, worker, context=context) == jauth.derive_worker_key(
                secret, worker, context=context)
            assert auth.derive_worker_key_legacy(secret, worker) == jauth.derive_worker_key_legacy(secret, worker)


def test_tags_equal_jax(backend):
    mine, theirs = GradientAuthenticator(b"session-secret", 4), jauth.GradientAuthenticator(b"session-secret", 4)
    rows = np.arange(4 * 8, dtype="<u4").reshape(4, 8)
    tags = mine.sign_many(11, rows)
    assert tags.shape == (4, 32) and tags.dtype == np.uint8
    assert np.array_equal(tags, theirs.sign_many(11, rows))
    for worker in range(4):
        assert mine.sign(worker, 11, rows[worker].tobytes()) == theirs.sign(worker, 11, rows[worker].tobytes())
    assert mine.verify_many(11, rows, tags).all()
    tags[2, 0] ^= 1
    assert mine.verify_many(11, rows, tags).tolist() == theirs.verify_many(11, rows, tags).tolist() == [
        True, True, False, True]
    assert not mine.verify_many(12, rows, mine.sign_many(11, rows)).any()
    empty = np.empty((4, 0), np.uint8)
    assert mine.sign_many(0, empty)[1].tobytes() == mine.sign(1, 0, b"")
    with pytest.raises(ValueError):
        mine.sign_many(0, rows[:2])
    # the legacy scheme: a JAX-minted legacy tag verifies, and no other
    legacy_key = hashlib.sha256(b"session-secret" + struct.pack("<q", 0)).digest()
    legacy_tag = hmac.new(legacy_key, struct.pack("<qq", 0, 5) + b"body", hashlib.sha256).digest()
    assert mine.verify_legacy(0, 5, b"body", legacy_tag) and theirs.verify_legacy(0, 5, b"body", legacy_tag)
    assert not mine.verify_legacy(0, 6, b"body", legacy_tag) and not mine.verify(0, 5, b"body", legacy_tag)


def test_authenticator_binds_worker_and_step(backend):
    a = GradientAuthenticator(b"session-secret", nb_workers=4)
    tag = a.sign(2, 7, b"payload")
    assert a.verify(2, 7, b"payload", tag)
    assert not a.verify(1, 7, b"payload", tag)  # impersonation
    assert not a.verify(2, 8, b"payload", tag)  # a replay at a later step
    assert not a.verify(2, 7, b"tampered", tag)
    assert not a.verify(9, 7, b"payload", tag)  # out of range
    with pytest.raises(ValueError):
        a.sign(4, 0, b"")


def test_backends_interoperate_and_contexts_separate(monkeypatch):
    tag = GradientAuthenticator(b"s", 2).sign(1, 3, b"blob")
    ckpt_tag = GradientAuthenticator(b"secret", 1, context=b"ckpt").sign(0, 5, bytes(32))
    monkeypatch.setattr(auth, "_native_ok", lambda: False)
    assert GradientAuthenticator(b"s", 2).verify(1, 3, b"blob", tag)
    assert GradientAuthenticator(b"secret", 1, context=b"ckpt").verify(0, 5, bytes(32), ckpt_tag)
    assert not GradientAuthenticator(b"secret", 1, context=b"handshake").verify(0, 5, bytes(32), ckpt_tag)
    assert derive_worker_key(b"s", 0, context=b"ab") != derive_worker_key(b"s", 0, context=b"a")


# --------------------------------------------------------------------------- #
# the cipher

def test_cipher_decrypts_across_packages():
    data = bytes(range(256)) * 40
    for step in (0, 7):
        assert jcrypto.SnapshotCipher(b"secret").decrypt(step, SnapshotCipher(b"secret").encrypt(step, data)) == data
        assert SnapshotCipher(b"secret").decrypt(step, jcrypto.SnapshotCipher(b"secret").encrypt(step, data)) == data
    handshake = SnapshotCipher(b"secret", context=b"handshake-enc")
    assert jcrypto.SnapshotCipher(b"secret", context=b"handshake-enc").decrypt(3, handshake.encrypt(3, b"d")) == b"d"
    blob = jcrypto.SnapshotCipher(b"secret").encrypt(5, data)
    assert SnapshotCipher.is_encrypted(blob) and data not in blob
    for secret, step in ((b"secret", 4), (b"wrong", 5)):  # a wrong step, a wrong secret
        with pytest.raises(UserException) as mine:
            SnapshotCipher(secret).decrypt(step, blob)
        with pytest.raises(JaxUserException) as theirs:
            jcrypto.SnapshotCipher(secret).decrypt(step, blob)
        assert str(mine.value) == str(theirs.value)
    with pytest.raises(UserException) as mine:
        SnapshotCipher(b"secret").decrypt(7, b"plain bytes")
    with pytest.raises(JaxUserException) as theirs:
        jcrypto.SnapshotCipher(b"secret").decrypt(7, b"plain bytes")
    assert str(mine.value) == str(theirs.value)


def test_cipher_roundtrip_nonce_and_step_binding():
    cipher = SnapshotCipher(b"secret")
    blob = cipher.encrypt(7, b"state bytes")
    assert cipher.decrypt(7, blob) == b"state bytes" and cipher.encrypt(7, b"state bytes") != blob
    for wrong in (6, 8, 0):
        with pytest.raises(UserException):
            cipher.decrypt(wrong, blob)
    assert cipher.decrypt(9, cipher.encrypt(9, b"")) == b""
    for text in (b"", b"A", _MAGIC[:3], _MAGIC[:-1] + b"X"):
        assert SnapshotCipher.is_encrypted(text) is False
    assert SnapshotCipher.is_encrypted(_MAGIC) is True
    for cut in (1, 4, 5):
        assert SnapshotCipher.is_encrypted(blob[:cut]) is (cut >= 5)


# --------------------------------------------------------------------------- #
# checkpoints

def _state(step, value):
    params = {"dense.bias": torch.arange(4, dtype=torch.float32) * value}
    tx = build_optimizer("sgd", build_schedule("fixed", ["initial-rate:0.1"]))
    return TrainState(params=params, opt_state=tx.init(params), step=step, seed=3)


def _flip(path, offset):
    with open(path, "r+b") as fd:
        fd.seek(offset)
        byte = fd.read(1)
        fd.seek(offset)
        fd.write(bytes([byte[0] ^ 0xFF]))


def test_checkpoint_authentication(tmp_path):
    a = GradientAuthenticator(b"secret", 1)
    ckpt = Checkpoints(str(tmp_path), authenticator=a)
    path = ckpt.save(_state(5, 1.0))
    restored, step = ckpt.restore(_state(0, 0.0))
    assert step == 5 and torch.equal(restored.params["dense.bias"], torch.arange(4.0))
    with open(path, "rb") as fd:
        body = fd.read()
    with open(path + ".tag", "rb") as fd:
        assert a.verify(0, 5, body, fd.read())
    _flip(path, 40)
    with pytest.raises(UserException, match="HMAC"):
        ckpt.restore(_state(0, 0.0))
    import os

    os.remove(path + ".tag")
    with pytest.raises(UserException, match="no authentication tag"):
        ckpt.restore(_state(0, 0.0))


def test_a_plain_manager_reads_a_tagged_snapshot(tmp_path):
    Checkpoints(str(tmp_path), authenticator=GradientAuthenticator(b"secret", 1)).save(_state(5, 2.0))
    restored, _ = Checkpoints(str(tmp_path)).restore(_state(0, 0.0))
    assert torch.equal(restored.params["dense.bias"], torch.arange(4.0) * 2.0)


def test_checkpoint_encryption(tmp_path):
    a = GradientAuthenticator(b"secret", 1, context=b"ckpt")
    ckpt = Checkpoints(str(tmp_path), authenticator=a, cipher=SnapshotCipher(b"secret"))
    path = ckpt.save(_state(5, 1.0))
    with open(path, "rb") as fd:
        on_disk = fd.read()
    assert on_disk.startswith(b"ATPC1") and b"dense.bias" not in on_disk and b"opt_state" not in on_disk
    restored, step = ckpt.restore(_state(0, 0.0))
    assert step == 5 and torch.equal(restored.params["dense.bias"], torch.arange(4.0))
    # the plaintext is a torch.save snapshot
    import io

    snapshot = torch.load(io.BytesIO(SnapshotCipher(b"secret").decrypt(5, on_disk)), weights_only=True)
    assert torch.equal(snapshot["params"]["dense.bias"], torch.arange(4.0))
    _flip(path, 30)
    with pytest.raises(UserException, match="HMAC"):
        ckpt.restore(_state(0, 0.0))
    ckpt.save(_state(5, 1.0))
    with pytest.raises(UserException, match="encrypted"):
        Checkpoints(str(tmp_path), authenticator=a).restore(_state(0, 0.0))


def test_encrypt_then_mac_ordering_guarantee(tmp_path):
    class CountingCipher(SnapshotCipher):
        calls = 0

        def decrypt(self, step, blob):
            CountingCipher.calls += 1
            return super().decrypt(step, blob)

    a = GradientAuthenticator(b"secret", 1, context=b"ckpt")
    ckpt = Checkpoints(str(tmp_path), authenticator=a, cipher=CountingCipher(b"secret"))
    path = ckpt.save(_state(5, 1.0))
    _flip(path, 40)
    CountingCipher.calls = 0
    with pytest.raises(UserException):
        ckpt.restore(_state(0, 0.0))
    assert CountingCipher.calls == 0, "decrypt ran on a tag-rejected blob"


def test_checkpoint_legacy_tag_migration(tmp_path, backend):
    secret = b"secret"
    a = GradientAuthenticator(secret, 1, context=b"ckpt")
    ckpt = Checkpoints(str(tmp_path), authenticator=a)
    path = ckpt.save(_state(5, 1.0))
    with open(path, "rb") as fd:
        body = fd.read()
    legacy_key = hashlib.sha256(secret + struct.pack("<q", 0)).digest()
    legacy_tag = hmac.new(legacy_key, struct.pack("<qq", 0, 5) + body, hashlib.sha256).digest()
    assert legacy_tag != a.sign(0, 5, body)
    with open(path + ".tag", "wb") as fd:
        fd.write(legacy_tag)
    restored, step = ckpt.restore(_state(0, 0.0))
    assert step == 5 and torch.equal(restored.params["dense.bias"], torch.arange(4.0))
    with open(path + ".tag", "rb") as fd:
        assert a.verify(0, 5, body, fd.read())  # re-tagged during the restore
    wrong = hmac.new(hashlib.sha256(b"other" + struct.pack("<q", 0)).digest(), struct.pack("<qq", 0, 5) + body,
                     hashlib.sha256).digest()
    with open(path + ".tag", "wb") as fd:
        fd.write(wrong)
    with pytest.raises(UserException):
        ckpt.restore(_state(0, 0.0))
    with open(path + ".tag", "wb") as fd:
        fd.write(legacy_tag)
    with pytest.raises(UserException):
        Checkpoints(str(tmp_path), authenticator=a, allow_legacy_tags=False).restore(_state(0, 0.0))


# --------------------------------------------------------------------------- #
# the handshake

def _jax_and_port_params(seed=0):
    from aggregathor_tpu import models as jmodels
    from aggregathor_tpu_torch.models.common import params_from_jax

    init = jmodels.instantiate("mnist", ["hidden:16"]).init(jax.random.PRNGKey(seed))
    return init, params_from_jax(jax.tree_util.tree_map(np.asarray, init))


def test_state_digest_equals_jax_for_carried_over_weights():
    for seed in (0, 1):
        jparams, params = _jax_and_port_params(seed)
        assert auth.state_digest(params) == jauth.state_digest(jparams)
    assert auth.state_digest(params) != auth.state_digest({k: v + 1 for k, v in params.items()})


class _FakeAxis:
    """A two-rank axis whose peer row is set by the test (rank 0 here)."""

    size, rank, device = 2, 0, torch.device("cpu")

    def __init__(self):
        self.peer = None
        self.mine = None

    def all_gather(self, tensor):
        self.mine = tensor.numpy().tobytes()
        peer = self.mine if self.peer is None else self.peer
        return torch.from_numpy(np.stack([np.frombuffer(self.mine, np.uint8), np.frombuffer(peer, np.uint8)]))


def test_handshake_payload_encrypted_in_flight():
    _, params = _jax_and_port_params()
    digest = auth.state_digest(params)
    axis = _FakeAxis()
    peer_auth = GradientAuthenticator(b"s3cret", 2, context=b"handshake")
    peer_cipher = SnapshotCipher(b"s3cret", context=b"handshake-enc")
    ct = peer_cipher.encrypt(0, digest)
    axis.peer = ct + peer_auth.sign(1, 0, ct)
    assert auth.authenticate_processes(b"s3cret", params, axis=axis) == 2
    assert digest not in axis.mine and digest not in axis.peer
    # the JAX package decrypts and verifies the port's payload
    jct = axis.mine[:len(ct)]
    assert jauth.GradientAuthenticator(b"s3cret", 2, context=b"handshake").verify(0, 0, jct, axis.mine[len(ct):])
    assert jcrypto.SnapshotCipher(b"s3cret", context=b"handshake-enc").decrypt(0, jct) == digest
    # diverged parameters: decrypted, then refused by the equality check
    other = auth.state_digest({k: torch.ones_like(v) for k, v in params.items()})
    ct = peer_cipher.encrypt(0, other)
    axis.peer = ct + peer_auth.sign(1, 0, ct)
    with pytest.raises(UserException, match="DIVERGED.*1"):
        auth.authenticate_processes(b"s3cret", params, axis=axis)
    assert auth.authenticate_processes(b"s3cret", params, axis=axis, verify_equal=False) == 2
    # a wrong secret: the tag fails
    bad_ct = SnapshotCipher(b"wrong", context=b"handshake-enc").encrypt(0, digest)
    axis.peer = bad_ct + GradientAuthenticator(b"wrong", 2, context=b"handshake").sign(1, 0, bad_ct)
    with pytest.raises(UserException, match="FAILED.*1"):
        auth.authenticate_processes(b"s3cret", params, axis=axis)
    # a flipped ciphertext byte of an honest payload
    ct = peer_cipher.encrypt(0, digest)
    honest = bytearray(ct + peer_auth.sign(1, 0, ct))
    honest[30] ^= 0x01
    axis.peer = bytes(honest)
    with pytest.raises(UserException, match="FAILED.*1"):
        auth.authenticate_processes(b"s3cret", params, axis=axis)
    assert auth.authenticate_processes(b"s3cret", params) == 1  # one process: its own payload


def test_handshake_messages_equal_jax(monkeypatch):
    jparams, params = _jax_and_port_params()
    axis = _FakeAxis()
    bad_ct = SnapshotCipher(b"wrong", context=b"handshake-enc").encrypt(0, auth.state_digest(params))
    axis.peer = bad_ct + GradientAuthenticator(b"wrong", 2, context=b"handshake").sign(1, 0, bad_ct)
    with pytest.raises(UserException) as mine:
        auth.authenticate_processes(b"s3cret", params, axis=axis)
    from jax.experimental import multihost_utils

    monkeypatch.setattr(jax, "process_count", lambda: 2)
    monkeypatch.setattr(jax, "process_index", lambda: 0)
    monkeypatch.setattr(multihost_utils, "process_allgather",
                        lambda row: np.stack([np.asarray(row), np.frombuffer(axis.peer, np.uint8)]))
    with pytest.raises(JaxUserException) as theirs:
        jauth.authenticate_processes(b"s3cret", jparams)
    assert str(mine.value) == str(theirs.value)
