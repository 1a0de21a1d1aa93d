"""Step-indexed train-state checkpoints.

Counterpart of ``aggregathor_tpu/obs/checkpoint.py``: files
``<base>-<step>.ckpt`` in a directory, found by scanning it and sorted by
step; ``can_restore`` / ``restore`` (the latest step or a given one) /
``save``, pruning to ``max_to_keep`` snapshots, a last-known-good ``pin``
that pruning spares, ``discard_after`` for an abandoned timeline, and
``wait`` for background writes.

A snapshot is ``torch.save`` of ``core.train_state.host_snapshot(state)``:
``{"step", "seed", "params", "opt_state"}`` with CPU tensors, and ``"ef"``
(every worker's (n, d) error-feedback residuals) when the wire codec
carries them, read back with ``weights_only=True``.  The CLEVER carry is
never saved (a transport buffer, not model state).  ``restore`` checks
every name, shape and dtype against the live state before it loads
anything, and loads in place on the state's device; as in JAX, a snapshot
without residuals restores into a run with them (zeroed) and one with them
into a run without (ignored).  Writes are atomic (a temporary file, then a rename), so a
killed run never leaves a torn snapshot.

``background=True`` hands serialisation, the write and the pruning to one
worker thread.  ``save`` still takes its CPU copy before it returns: the
optimizer updates the parameters in place at the next step.  ``wait()``
joins the pending writes and raises the first failure.  The restore, the
CPU copy and the write are spans of ``obs/trace.py`` (``checkpoint.restore``,
``checkpoint.fetch``, ``checkpoint.write``, the last on the writer thread).

Optional authentication, encryption and custody, in JAX's order:
``authenticator`` (a ``parallel.auth.GradientAuthenticator``) tags every
snapshot in a ``.tag`` sidecar (slot 0, bound to the step); ``cipher`` (a
``parallel.crypto.SnapshotCipher``) encrypts the bytes before they reach
the disk; ``custody`` (a ``secure.ChainOfCustody``) writes a signed lineage
manifest beside each snapshot.  A save encrypts, then writes the manifest
over the encrypted bytes, then tags them (encrypt-then-MAC), the sidecars
landing before the snapshot's rename.  A restore verifies the tag (a tag
of the key scheme before contexts is accepted once under the same secret
and re-tagged at once, unless ``allow_legacy_tags=False``), then the
manifest, then decrypts: a tampered blob is refused before a keystream
byte is derived.  Pruning and ``discard_after`` take the sidecars with
their snapshots.
"""

import io
import os
import pickle
import re

import torch

from . import trace
from ..core.train_state import host_snapshot, load_snapshot
from ..utils import UserException, info, warning


def _describe(tree, prefix=""):
    """{dotted name: (shape, dtype) of a tensor, or the type name of another leaf}."""
    out = {}
    for key, value in tree.items():
        name = prefix + str(key)
        if isinstance(value, dict):
            out.update(_describe(value, name + "/"))
        elif isinstance(value, torch.Tensor):
            out[name] = (tuple(value.shape), value.dtype)
        else:
            out[name] = type(value).__name__
    return out


class Checkpoints:
    def __init__(self, directory, base_name="model", max_to_keep=5, authenticator=None,
                 background=False, allow_legacy_tags=True, cipher=None, custody=None, nb_workers=None):
        """``nb_workers``: the run's n, the rows a snapshot's residuals must
        hold (default: the live state's rows, those of a one-rank run)."""
        self.directory = directory
        self.authenticator = authenticator
        self.cipher = cipher
        self.custody = custody
        self.allow_legacy_tags = bool(allow_legacy_tags)
        self.base_name = base_name
        self.max_to_keep = int(max_to_keep)
        self.nb_workers = None if nb_workers is None else int(nb_workers)
        self._pattern = re.compile(re.escape(base_name) + r"-(\d+)\.ckpt$")
        self._pinned = None
        self._pool = None
        self._pending = []
        if background:
            import concurrent.futures

            # one worker: writes (and their prunes) stay in order
            self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=1, thread_name_prefix="ckpt")
        if directory:
            os.makedirs(directory, exist_ok=True)

    def _path(self, step):
        return os.path.join(self.directory, "%s-%d.ckpt" % (self.base_name, step))

    def steps(self):
        """Sorted steps with a snapshot on disk."""
        if not self.directory or not os.path.isdir(self.directory):
            return []
        found = []
        for name in os.listdir(self.directory):
            match = self._pattern.match(name)
            if match:
                found.append(int(match.group(1)))
        return sorted(found)

    def can_restore(self, step=None):
        steps = self.steps()
        return bool(steps) if step is None else step in steps

    def pin(self, step):
        """Pin ``step`` as last-known-good: pruning spares its snapshot until
        a newer pin replaces it (``None`` releases the pin)."""
        self._pinned = None if step is None else int(step)

    def pinned_step(self):
        """The pinned step if its snapshot is on disk, else None."""
        pinned = self._pinned
        return pinned if pinned is not None and self.can_restore(pinned) else None

    def discard_after(self, step):
        """Remove every snapshot past ``step``; returns their steps.  Call
        ``wait()`` first when background writes may be pending."""
        dropped = [s for s in self.steps() if s > step]
        for old in dropped:
            for path in (self._path(old), self._path(old) + ".tag", self._path(old) + ".manifest.json"):
                try:
                    os.remove(path)
                except OSError:
                    pass
        return dropped

    def restore(self, state, step=None):
        """Load the snapshot of ``step`` (the latest if None) into ``state``
        in place; returns ``(state, step)``."""
        with trace.span("checkpoint.restore", cat="checkpoint"):
            return self._restore(state, step)

    def _restore(self, state, step):
        steps = self.steps()
        if not steps:
            raise UserException("No checkpoint to restore in %r" % (self.directory,))
        if step is None:
            step = steps[-1]
        elif step not in steps:
            raise UserException("No checkpoint for step %d in %r" % (step, self.directory))
        path = self._path(step)
        with open(path, "rb") as fd:
            data = fd.read()
        if self.authenticator is not None:
            self._verify_tag(path, step, data)
        if self.custody is not None:
            # provenance before anything is read: the manifest signs the
            # bytes on disk (secure/custody.py)
            self.custody.verify(path, step, data)
        if self.cipher is not None:
            data = self.cipher.decrypt(step, data)
        else:
            from ..parallel.crypto import SnapshotCipher

            if SnapshotCipher.is_encrypted(data):
                raise UserException("Checkpoint %r is encrypted; pass --encrypt-checkpoints with the matching "
                                    "--session-secret to restore it" % (path,))
        try:
            snapshot = torch.load(io.BytesIO(data), map_location="cpu", weights_only=True)
        except (pickle.UnpicklingError, RuntimeError, EOFError) as exc:  # a foreign or torn file
            raise UserException("Cannot read checkpoint %r: %s" % (path, exc))
        template = {"step": state.step, "seed": state.seed, "params": state.params, "opt_state": state.opt_state}
        if not isinstance(snapshot, dict) or set(snapshot) - {"ef"} != set(template):
            raise UserException("Checkpoint %r does not hold a train state" % path)
        saved_ef = snapshot.get("ef")
        if saved_ef is not None and state.ef is not None:
            # every worker's rows: a run with another n is refused here, as
            # JAX's template check refuses it
            want = (self.nb_workers if self.nb_workers is not None else state.ef.shape[0], state.ef.shape[1])
            if not (isinstance(saved_ef, torch.Tensor) and saved_ef.dtype == state.ef.dtype
                    and tuple(saved_ef.shape) == want):
                raise UserException("Checkpoint %r holds error-feedback residuals %s that do not fit this run's %s"
                                    % (path, tuple(getattr(saved_ef, "shape", ())), want))
        for part in ("params", "opt_state"):
            want, got = _describe(template[part]), _describe(snapshot[part])
            if want != got:
                diff = sorted(set(want.items()) ^ set(got.items()), key=str)[:4]
                raise UserException(
                    "Checkpoint %r does not fit this run's %s (names, shapes or dtypes differ: %s)"
                    % (path, part, ", ".join("%s %s" % item for item in diff)))
        load_snapshot(state, snapshot)
        info("Restored checkpoint at step %d from %r" % (step, self.directory))
        return state, step

    def _verify_tag(self, path, step, data):
        """The ``.tag`` sidecar's check (fail-closed), with the one-time
        migration of a tag of the key scheme before contexts."""
        tag_path = path + ".tag"
        try:
            with open(tag_path, "rb") as fd:
                tag = fd.read()
        except OSError:
            raise UserException(
                "Checkpoint %r has no authentication tag. If it predates tagging (saved without --session-secret), "
                "restore once WITHOUT the secret and resume with it — new snapshots are tagged; otherwise treat the "
                "snapshot as untrusted" % (path,))
        if self.authenticator.verify(0, step, data, tag):
            return
        legacy_ok = getattr(self.authenticator, "verify_legacy", None)
        if not (self.allow_legacy_tags and legacy_ok is not None and legacy_ok(0, step, data, tag)):
            raise UserException("Checkpoint %r failed HMAC verification: corrupted, forged, or a --session-secret "
                                "mismatch; treat the snapshot as untrusted" % (path,))
        # accepted under the same secret: re-tagged at once, so the
        # downgrade window closes for this snapshot now
        try:
            tag_tmp = tag_path + ".tmp"
            with open(tag_tmp, "wb") as fd:
                fd.write(self.authenticator.sign(0, step, data))
            os.replace(tag_tmp, tag_path)
            retag = "re-tagged under the current scheme"
        except OSError:
            retag = "re-tagging skipped (directory not writable)"
        warning("Checkpoint %r was tagged under the legacy key scheme (pre-context-separation); accepted under "
                "the same session secret, %s" % (path, retag))

    def save(self, state, step=None, ef=None):
        """Snapshot ``state`` (at ``step``, default ``state.step``; ``ef``:
        every worker's residuals gathered from a W-rank axis, default
        ``state.ef``); prunes beyond ``max_to_keep`` oldest first.  With
        ``background=True`` only the CPU copy happens here."""
        step = int(state.step if step is None else step)
        with trace.span("checkpoint.fetch", cat="checkpoint", step=step):
            snapshot = host_snapshot(state, ef=ef)
        # the lineage on the caller's thread: the manifest signs the tag
        # chain's head as of this save
        lineage = self.custody.lineage(step) if self.custody is not None else None
        if self._pool is not None:
            self._pending.append(self._pool.submit(self._write, snapshot, step, lineage))
            return self._path(step)
        return self._write(snapshot, step, lineage)

    def wait(self, shutdown=False):
        """Join every pending background write, then raise the first
        failure; ``shutdown=True`` also retires the worker thread."""
        pending, self._pending = self._pending, []
        first_error = None
        for future in pending:
            try:
                future.result()
            except Exception as exc:
                if first_error is None:
                    first_error = exc
        if shutdown and self._pool is not None:
            pool, self._pool = self._pool, None
            pool.shutdown(wait=True)
        if first_error is not None:
            raise first_error

    @trace.span("checkpoint.write", cat="checkpoint")
    def _write(self, snapshot, step, lineage=None):
        buffer = io.BytesIO()
        torch.save(snapshot, buffer)
        data = buffer.getvalue()
        if self.cipher is not None:
            data = self.cipher.encrypt(step, data)  # before the tag: encrypt-then-MAC
        path = self._path(step)
        if self.custody is not None:
            # over the bytes on disk; lands before the snapshot's rename, as
            # the tag does (discovery scans .ckpt files)
            self.custody.write(path, step, data, payload=lineage)
        if self.authenticator is not None:
            tag_tmp = path + ".tag.tmp"
            with open(tag_tmp, "wb") as fd:
                fd.write(self.authenticator.sign(0, step, data))
            os.replace(tag_tmp, path + ".tag")
        tmp = path + ".tmp"
        with open(tmp, "wb") as fd:
            fd.write(data)
        os.replace(tmp, path)
        if self.max_to_keep > 0:
            for old in self.steps()[: -self.max_to_keep]:
                if old == self._pinned:
                    continue  # the last-known-good survives pruning
                os.remove(self._path(old))
                for sidecar in (self._path(old) + ".tag", self._path(old) + ".manifest.json"):
                    if os.path.exists(sidecar):
                        os.remove(sidecar)
        return path

