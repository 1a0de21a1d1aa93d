"""Chain of custody: signed lineage manifests beside every checkpoint.

Counterpart of ``aggregathor_tpu/secure/custody.py``; the manifest is the
same document, signed with the same key, so either package verifies the
other's.  The HMAC tag of ``obs/checkpoint.py`` proves a snapshot's bytes
are intact; the manifest says where they came from: run id, step, GAR
spec, experiment and data digest, and the head of the submission tag chain
(``secure/submit.py``), HMAC-signed under the ``b"custody"`` key family of
the session secret.  ``Checkpoints(custody=...)`` writes one beside every
snapshot and verifies it at every restore (the auto-restore and the
guardian's rollback).  Verification fails closed: a missing manifest
refuses the restore unless ``allow_unsigned`` (``--allow-unsigned``).

Schema ``aggregathor.secure.custody.v1``::

    {"schema", "run_id", "step", "experiment", "gar", "data_digest",
     "snapshot_digest" (SHA-256 of the on-disk bytes, after encryption),
     "tag_chain": {"head", "steps", "nb_workers"} | null, "created_at",
     "signature" (HMAC-SHA256 hex over the canonical JSON of the rest,
     bound to the step)}
"""

import hashlib
import json
import os
import time

import numpy as np

from ..parallel.auth import GradientAuthenticator
from ..utils import UserException, warning

SCHEMA = "aggregathor.secure.custody.v1"


def manifest_path(ckpt_path):
    """The lineage manifest beside a snapshot file."""
    return str(ckpt_path) + ".manifest.json"


def _treedef_repr(tree):
    """JAX's ``repr(treedef)`` body of a nested dict / tuple / list / None
    tree (dict keys sorted, leaves ``*``)."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{%s}" % ", ".join("%r: %s" % (key, _treedef_repr(tree[key])) for key in sorted(tree))
    if isinstance(tree, tuple):
        inner = ", ".join(_treedef_repr(item) for item in tree)
        return "(%s,)" % inner if len(tree) == 1 else "(%s)" % inner
    if isinstance(tree, list):
        return "[%s]" % ", ".join(_treedef_repr(item) for item in tree)
    return "*"


def _leaves(tree):
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in _leaves(tree[key])]
    if isinstance(tree, (tuple, list)):
        return [leaf for item in tree for leaf in _leaves(item)]
    return [tree]


def data_digest_for(experiment, fallback_identity):
    """SHA-256 over the experiment's training arrays, or over the config
    identity when the data never sits on the host whole (``train_arrays()``
    None or failing).  The arrays are hashed as JAX hashes its pytree:
    ``repr(treedef)`` (``PyTreeDef({'image': *, 'label': *})`` for the
    experiments' dicts; nested dicts, tuples, lists and None are written
    the same way), then each leaf's dtype, shape and bytes in sorted-key
    order, so the digest equals JAX's for the same arrays."""
    try:
        arrays = experiment.train_arrays()
    except Exception:
        arrays = None
    digest = hashlib.sha256()
    if arrays is not None:
        digest.update(("PyTreeDef(%s)" % _treedef_repr(arrays)).encode())
        for leaf in _leaves(arrays):
            host = np.ascontiguousarray(leaf.cpu().numpy() if hasattr(leaf, "cpu") else np.asarray(leaf))
            digest.update(str(host.dtype).encode() + repr(host.shape).encode())
            digest.update(host.tobytes())
    else:
        digest.update(b"config-identity:" + str(fallback_identity).encode())
    return digest.hexdigest()


class ChainOfCustody:
    """Writes and verifies signed lineage manifests.  The trainer builds it
    with the run's lineage (``submission``: the live
    ``SubmissionAuthenticator`` whose tag chain each manifest signs); a
    verifier needs only the session secret and its ``allow_unsigned``
    policy."""

    def __init__(self, session_secret, run_id=None, experiment=None, gar_spec=None, data_digest=None,
                 submission=None, allow_unsigned=False):
        self.auth = GradientAuthenticator(session_secret, 1, context=b"custody")
        self.run_id = run_id
        self.experiment = experiment
        self.gar_spec = gar_spec  # the runner updates it on a guardian escalation
        self.data_digest = data_digest
        self.submission = submission
        self.allow_unsigned = bool(allow_unsigned)
        self.verified = 0
        self.unsigned = 0
        self.last_manifest = None

    def lineage(self, step):
        """The lineage as of ``step``, taken on the saving thread (a
        background writer then signs the chain head of the save)."""
        return {
            "schema": SCHEMA,
            "run_id": self.run_id,
            "step": int(step),
            "experiment": self.experiment,
            "gar": self.gar_spec,
            "data_digest": self.data_digest,
            "tag_chain": self.submission.chain() if self.submission is not None else None,
            "created_at": time.time(),
        }

    @staticmethod
    def _canonical(payload):
        return json.dumps(payload, sort_keys=True, separators=(",", ":")).encode()

    def write(self, ckpt_path, step, data, payload=None):
        """Write the signed manifest of the snapshot bytes ``data`` (as on
        disk) beside ``ckpt_path``, atomically; returns its path."""
        payload = dict(payload if payload is not None else self.lineage(step))
        payload["snapshot_digest"] = hashlib.sha256(bytes(data)).hexdigest()
        payload["signature"] = self.auth.sign(0, int(step), self._canonical(payload)).hex()
        path = manifest_path(ckpt_path)
        tmp = path + ".tmp"
        with open(tmp, "w") as fd:
            json.dump(payload, fd, sort_keys=True, indent=1)
            fd.write("\n")
        os.replace(tmp, path)
        return path

    def verify(self, ckpt_path, step, data):
        """Check the provenance of snapshot bytes ``data`` about to be
        loaded: a UserException on a missing manifest (unless
        ``allow_unsigned``), a bad signature, another step, or bytes that
        do not match the signed digest.  True when it verified, False when
        an unsigned snapshot was let through."""
        path = manifest_path(ckpt_path)
        try:
            with open(path) as fd:
                doc = json.load(fd)
        except OSError:
            if self.allow_unsigned:
                warning("Checkpoint %r has NO custody manifest — loading it anyway (--allow-unsigned): provenance "
                        "is unverified" % (str(ckpt_path),))
                self.unsigned += 1
                return False
            raise UserException(
                "Checkpoint %r has no custody manifest: it was saved without --secure (or the manifest was "
                "deleted). Refusing to load an unsigned checkpoint; pass --allow-unsigned to opt out, or re-save it "
                "from a --secure run" % (str(ckpt_path),))
        if not isinstance(doc, dict) or doc.get("schema") != SCHEMA:
            raise UserException("Custody manifest %r is not a %s document" % (path, SCHEMA))
        signature = doc.pop("signature", "")
        try:
            tag = bytes.fromhex(signature)
        except ValueError:
            tag = b""
        if not self.auth.verify(0, int(step), self._canonical(doc), tag):
            raise UserException(
                "Custody manifest %r failed signature verification: forged, tampered, or a --session-secret "
                "mismatch; treat the checkpoint as untrusted" % (path,))
        if int(doc.get("step", -1)) != int(step):
            raise UserException(
                "Custody manifest %r signs step %r but snapshot step %d was restored — a manifest copied between "
                "snapshots" % (path, doc.get("step"), int(step)))
        if hashlib.sha256(bytes(data)).hexdigest() != doc.get("snapshot_digest"):
            raise UserException(
                "Checkpoint %r does not match its signed custody manifest (snapshot digest mismatch): the snapshot "
                "was swapped or corrupted after signing" % (str(ckpt_path),))
        self.verified += 1
        self.last_manifest = dict(doc)
        return True

    @property
    def all_verified(self):
        """True when every restore so far verified, and at least one did."""
        return self.verified > 0 and self.unsigned == 0
