"""Inference engine: bucket-ladder batching + replicated robust vote.

Counterpart of ``aggregathor_tpu/serve/engine.py``.  Incoming batches are
padded on the host up to a fixed ladder of power-of-two bucket sizes, so the
card only ever sees ``len(buckets)`` input shapes; ``warmup()`` runs each
once, and after it serving, a hot swap and a pool resize build no kernel
library (``ops/build.py``) and ``compile_count`` (the bucket shapes run so
far) never grows.  PyTorch runs eagerly: there is no executable a bucket,
and capturing one CUDA graph a bucket is performance work, not a port.

Byzantine robustness transfers from training to serving: with ``R`` replica
parameter sets (distinct checkpoints, or copies of one), every bucket runs
through all R replicas and the ``(R, bucket * classes)`` replica logits are
reduced by a GAR (``gars/``) exactly as the training engine reduces the
``(n, d)`` gradient matrix: replicas are workers, logit coordinates are
gradient coordinates.  On the card the vote is the rank kernels of
``ops/csrc`` (median: K3; averaged-median: K4; trimmed-mean: K5;
average-nan: K6; krum: K1's distances).  The NaN-last convention carries
over: a crashed replica whose logits read NaN is absorbed by ``median``
(R >= 2f + 1 replicas mask f faulty ones), while plain ``average`` is
poisoned.  Per-replica **disagreement scores** (mean squared deviation from
the voted logits over the valid rows; non-finite deviations read +inf) come
back with every batch.

The R replicas are stacked on a leading axis (one ``(R, ...)`` tensor a
parameter) and run one after the other, each a plain ``predict_logits`` on
its slice of the stack: a replica's logits are then bit for bit those of a
lone forward at the same bucket, which a ``torch.func.vmap`` over the
weights would not promise (it turns a convolution into a grouped one, whose
algorithm may differ).  The experiment's module is ``models.thread_module``'s
copy on every lane thread (``functional_call`` swaps a module's parameters
while it runs).

Two serving-scale levers act on the live state alone:

- **Active-replica mask** (``set_active_replicas``): a retired replica's
  logits are set to NaN BEFORE the vote, so it is excluded exactly like a
  crashed worker, and exactly like one it SPENDS the vote's declared-f
  budget.  Whether the rule absorbs that many dead rows is PROBED on the
  engine's device (``vote_absorbs_retired``), not trusted from a flag.
- **Hot weight swap** (``swap_replicas``): the ``(stack, active, step)``
  triple is ONE tuple, rebound atomically once the new stack is wholly on
  the device; an in-flight forward finishes on the old stack (it holds a
  reference to it), the next dispatch reads the new one, and every
  ``predict`` reports the ``weights_step`` its batch ran on.
"""

import threading

import numpy as np
import torch

from ..obs import trace
from ..utils import UserException, info, resolve_device


def bucket_ladder(max_batch, min_bucket=1):
    """The power-of-two bucket ladder covering batch sizes up to ``max_batch``.

    ``(min_bucket, 2*min_bucket, ..., max_batch)``: ``max_batch`` is rounded
    UP to the next power of two so every request size <= max_batch has a
    bucket.  A fixed ladder bounds the input shapes at ``log2(max_batch)``
    while wasting at most half of any bucket's rows on padding.
    """
    max_batch, min_bucket = int(max_batch), int(min_bucket)
    if max_batch < 1 or min_bucket < 1:
        raise UserException(
            "bucket ladder wants positive sizes (max_batch=%d, min_bucket=%d)"
            % (max_batch, min_bucket)
        )
    ladder = []
    size = 1
    while size < min_bucket:
        size *= 2
    while True:
        ladder.append(size)
        if size >= max_batch:
            return tuple(ladder)
        size *= 2


def choose_bucket(nb_rows, buckets):
    """Smallest bucket holding ``nb_rows`` rows, or None when none fits.

    ``buckets`` must be sorted ascending (``InferenceEngine`` guarantees it).
    """
    for bucket in buckets:
        if bucket >= nb_rows:
            return bucket
    return None


def restore_params(experiment, directory, tx, step=None, seed=0,
                   base_name=None, authenticator=None, cipher=None,
                   allow_legacy_tags=True, custody=None):
    """Restore a trained checkpoint's parameters for serving.

    Loads into a fresh host-side :class:`TrainState` template (so name,
    shape and dtype mismatches fail loudly, the training restore's
    discipline) and returns ``(params, step)``.  ``tx`` must match the
    optimizer the checkpoint was trained with: the snapshot holds the
    optimizer state, and a mismatched one is refused at the restore instead
    of silently seeding garbage.  ``authenticator``/``cipher`` honour the
    training-side checkpoint tags and encryption (``obs/checkpoint.py``);
    ``custody`` (a ``secure.ChainOfCustody``) verifies the signed lineage
    manifest before anything is loaded: the serving end of the
    train -> sign -> serve chain.
    """
    from .. import config
    from ..core.train_state import TrainState
    from ..obs.checkpoint import Checkpoints

    params = experiment.init(seed)
    template = TrainState(params=params, opt_state=tx.init(params), step=0, seed=int(seed))
    checkpoints = Checkpoints(
        directory,
        base_name if base_name is not None else config.default_checkpoint_base_name,
        authenticator=authenticator,
        cipher=cipher,
        allow_legacy_tags=allow_legacy_tags,
        custody=custody,
    )
    state, at_step = checkpoints.restore(template, step=step)
    return state.params, at_step


class InferenceEngine:
    """Checkpoint-to-predictions apply path with R-way robust replication.

    Args:
      experiment: a ``models`` Experiment instance; ``predict_logits`` is
        the apply path, ``sample_shape`` validates inputs.
      replicas: list of R parameter dicts (R >= 1), all of one topology
        (copies or same-model checkpoints).
      gar: a ``gars`` GAR *instance* over ``nb_workers == R`` (or None for
        single-replica serving: replica 0's logits).  Any registered rule
        whose (n, f) check admits R replicas works.
      max_batch: largest servable batch; also the ladder top when
        ``buckets`` is not given.
      buckets: explicit bucket ladder (sorted ascending after
        normalization); default ``bucket_ladder(max_batch)``.
      seed: the key of the randomized meta-rules (``uses_key`` GARs draw a
        FIXED per-engine key: serving is deterministic).
      weights_step: the training step of the served weights (None: unknown).
      device: ``"cuda"`` (default; raises without a GPU) or ``"cpu"``.
    """

    def __init__(self, experiment, replicas, gar=None, max_batch=64,
                 buckets=None, seed=0, weights_step=None, device="cuda"):
        if not replicas:
            raise UserException("InferenceEngine needs at least one replica")
        self.experiment = experiment
        self.nb_replicas = len(replicas)
        self.gar = gar
        if gar is not None and gar.nb_workers != self.nb_replicas:
            raise UserException(
                "GAR %s aggregates %d workers but %d replicas are loaded"
                % (type(gar).__name__, gar.nb_workers, self.nb_replicas)
            )
        self.buckets = tuple(sorted(set(
            int(b) for b in (buckets if buckets else bucket_ladder(max_batch))
        )))
        if not self.buckets or self.buckets[0] < 1:
            raise UserException("Bucket ladder must hold positive sizes: %r" % (self.buckets,))
        self.sample_shape = tuple(experiment.sample_shape)
        self.device = resolve_device(device)
        self._vote_key = int(seed)
        # The live serving state is ONE tuple (stacked params, active mask,
        # weights step), rebound atomically by swap_replicas /
        # set_active_replicas, so a dispatch never reads old weights with a
        # new step tag.  Reads are lock-free (a tuple rebind is atomic); the
        # two MUTATORS are read-modify-writes and hold _live_lock, so a hot
        # swap (watcher or SIGHUP thread) and an autoscale move cannot undo
        # each other's update.
        self._live_lock = threading.Lock()
        self._live = (
            self._stack(replicas),
            torch.ones((self.nb_replicas,), dtype=torch.bool, device=self.device),
            weights_step,
        )
        self._shapes_lock = threading.Lock()
        self._shapes_run = set()

    def _stack(self, replicas):
        """One (R, ...) tensor a parameter on the engine's device, wholly
        there before it is returned: the stream that copied it is
        synchronized, so a lane can never read a half-copied stack."""
        names = sorted(replicas[0])
        for params in replicas[1:]:
            if sorted(params) != names:
                raise UserException(
                    "replicas do not share one topology (parameter names differ)"
                )
        with torch.no_grad():
            stack = {}
            for name in names:
                leaves = [torch.as_tensor(params[name]) for params in replicas]
                if any((leaf.shape, leaf.dtype) != (leaves[0].shape, leaves[0].dtype) for leaf in leaves):
                    raise UserException(
                        "replicas do not share one topology (leaf %r differs in shape or dtype)" % name
                    )
                stack[name] = torch.stack([leaf.detach().to(self.device) for leaf in leaves])
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return stack

    def _forward(self, stack, x, nb_valid, active):
        """The bucket forward: R replica forwards, the float32 vote and the
        disagreement scores, on the engine's device.  ``x`` is the padded
        (bucket, *sample_shape) input, ``nb_valid`` its real rows."""
        bucket = x.shape[0]
        rows = []
        for r in range(self.nb_replicas):
            params = {name: leaf[r] for name, leaf in stack.items()}
            rows.append(self.experiment.predict_logits(params, x).to(torch.float32).reshape(-1))
        flat = torch.stack(rows)  # (R, bucket * classes), contiguous
        # a retired replica is a crashed one as far as the vote can tell:
        # its row reads NaN and the NaN-last convention excludes it
        flat = torch.where(active[:, None], flat, float("nan"))
        if self.gar is None or self.nb_replicas == 1:
            voted = flat[0]
        else:
            voted = self.gar.aggregate(flat, key=self._vote_key)
        classes = flat.shape[1] // bucket
        # disagreement over the VALID rows only: padding rows would dilute
        # (never inflate) a faulty replica's score.  A non-finite deviation
        # is maximal disagreement (+inf); a RETIRED replica reads NaN, so the
        # host can tell "scaled out" from "suspect".
        row_valid = torch.arange(bucket, device=flat.device) < nb_valid
        coord_valid = torch.repeat_interleave(row_valid, classes)
        deviation = (flat - voted[None, :]) ** 2
        deviation = torch.where(torch.isfinite(deviation), deviation, float("inf"))
        masked = torch.where(coord_valid[None, :], deviation, 0.0)
        disagreement = torch.sum(masked, dim=1) / float(max(nb_valid * classes, 1))
        disagreement = torch.where(active, disagreement, float("nan"))
        voted = voted.reshape(bucket, classes)
        return torch.argmax(voted, dim=-1), voted, disagreement

    def _note_shape(self, bucket):
        with self._shapes_lock:
            self._shapes_run.add(int(bucket))

    @property
    def weights_step(self):
        """The training step of the served weights (None when the source
        checkpoint did not carry one)."""
        return self._live[2]

    @property
    def active_replicas(self):
        """Sorted indices of the replicas currently voting."""
        mask = self._live[1].cpu().numpy()
        return [int(i) for i in np.nonzero(mask)[0]]

    def set_active_replicas(self, indices):
        """Scale the voting pool: serve with exactly ``indices`` active.

        Retired replicas' logits read NaN and are excluded by the vote,
        spending the declared-f budget exactly like a crashed replica, so the
        caller (``serve/autoscale.py``) must keep ``retired + expected faults
        <= f``.  Returns the active list.
        """
        indices = sorted(set(int(i) for i in indices))
        if not indices:
            raise UserException("at least one replica must stay active")
        if indices[0] < 0 or indices[-1] >= self.nb_replicas:
            raise UserException(
                "active replicas %r out of range for R=%d"
                % (indices, self.nb_replicas)
            )
        if len(indices) < self.nb_replicas:
            if self.gar is None or self.nb_replicas == 1:
                raise UserException(
                    "cannot retire replicas without a vote rule: the "
                    "single/unvoted forward serves replica 0 unconditionally"
                )
            if not self.vote_absorbs_retired(self.nb_replicas - len(indices)):
                raise UserException(
                    "vote rule %s does not absorb %d retired (NaN) replica "
                    "row(s) at R=%d: the vote would be poisoned — retire "
                    "fewer replicas or declare a larger f"
                    % (type(self.gar).__name__,
                       self.nb_replicas - len(indices), self.nb_replicas)
                )
        mask = torch.zeros((self.nb_replicas,), dtype=torch.bool)
        mask[indices] = True
        mask = mask.to(self.device)
        with self._live_lock:
            stack, _, step = self._live
            self._live = (stack, mask, step)
        return indices

    def vote_absorbs_retired(self, nb_retired):
        """Concrete feasibility probe: does the vote rule return a finite
        aggregate with ``nb_retired`` all-NaN rows in the stack?  Each rule's
        real absorption boundary (median's order-statistic slots, krum's
        +inf distances, average-nan's exclusion, plain average's none) is
        probed rather than trusted from a flag.  The probe runs the rule on a
        tiny (R, 4) matrix on the engine's device: on the card, the card's
        kernel decides."""
        if self.gar is None:
            return nb_retired == 0
        probe = torch.ones((self.nb_replicas, 4), dtype=torch.float32)
        if nb_retired > 0:
            probe[self.nb_replicas - nb_retired:] = float("nan")
        try:
            voted = self.gar.aggregate(probe.to(self.device), key=self._vote_key)
        except Exception:
            return False
        return bool(torch.isfinite(voted).all())

    def swap_replicas(self, replicas, step=None):
        """Hot weight swap: replace the replica parameter stack.

        The new replicas must match the serving topology (same count, same
        names, leaf shapes and dtypes).  The new stack is copied and wholly
        on the device before the live tuple is rebound (one reference
        swap): an in-flight forward finishes on the old stack, the next
        dispatch reads the new one and reports the new ``step`` as its
        ``weights_step``.  The active-replica mask survives the swap.  Used
        by the checkpoint watcher (``serve/weights.py``) and the serve CLI's
        SIGHUP reload after custody verification.  Returns ``compile_count``.
        """
        if len(replicas) != self.nb_replicas:
            raise UserException(
                "swap_replicas got %d replica(s) for a %d-replica engine "
                "(the vote rule is sized R=%d)"
                % (len(replicas), self.nb_replicas, self.nb_replicas)
            )
        fresh = self._stack(replicas)
        old = self._live[0]
        if sorted(old) != sorted(fresh) or any(
            (old[name].shape, old[name].dtype) != (fresh[name].shape, fresh[name].dtype) for name in old
        ):
            raise UserException(
                "swap_replicas: the new checkpoints do not match the serving "
                "topology (leaf shape/dtype mismatch) — restart to change it"
            )
        with self._live_lock:
            self._live = (fresh, self._live[1], step)
        return self.compile_count

    @property
    def compile_count(self):
        """Bucket shapes this engine has run, the eager port's count of what
        the JAX engine compiles: after ``warmup()`` it equals
        ``len(self.buckets)`` and never grows in steady state."""
        with self._shapes_lock:
            return len(self._shapes_run)

    def warmup(self):
        """Run every ladder bucket once (zeros input), so the first real
        request finds the kernels built and the bucket's shape seen.
        Returns ``compile_count``."""
        live = self._live
        for bucket in self.buckets:
            self._run_bucket(np.zeros((bucket,) + self.sample_shape, np.float32), live)
        info(
            "Inference warmup: %d bucket(s) %r run, %d replica(s), vote=%s"
            % (len(self.buckets), list(self.buckets), self.nb_replicas,
               type(self.gar).__name__ if self.gar else "none")
        )
        return self.compile_count

    def _run_bucket(self, rows, live):
        stack, active, _ = live
        n = rows.shape[0]
        bucket = choose_bucket(n, self.buckets)
        # pad on the HOST: one array and one host->device copy a call
        pad = np.zeros((bucket,) + self.sample_shape, np.float32)
        pad[:n] = rows
        # one span covers the dispatch AND the fetch, where the forward's
        # wall time lands
        with trace.span("serve.forward", cat="serve", bucket=int(bucket), rows=int(n)):
            x = torch.from_numpy(pad).to(self.device)
            with torch.no_grad():
                preds, logits, disagreement = self._forward(stack, x, n, active)
            out = (preds[:n].cpu().numpy(), logits[:n].cpu().numpy(), disagreement.cpu().numpy(), bucket)
        self._note_shape(bucket)
        return out

    def predict(self, x):
        """Serve a batch: ``(n, *sample_shape)`` -> dict with ``predictions``
        (n,) int labels, ``logits`` (n, classes) voted logits,
        ``disagreement`` (R,) per-replica scores (rows-weighted over chunks;
        NaN = retired replica), ``bucket`` (the last bucket used),
        ``weights_step`` (the checkpoint step this batch served from) and
        ``active_replicas``.  Requests beyond the ladder top are chunked at
        the largest bucket.
        """
        x = np.asarray(x, np.float32)
        if x.ndim == len(self.sample_shape):  # single sample convenience
            x = x[None]
        if tuple(x.shape[1:]) != self.sample_shape:
            raise UserException(
                "Input shape %r does not match the experiment's sample shape %r"
                % (tuple(x.shape[1:]), self.sample_shape)
            )
        if x.shape[0] == 0:
            raise UserException("Empty inference batch")
        # ONE read of the live tuple a predict: every chunk of this batch
        # serves the same weights, and the reported weights_step can never
        # pair old weights with a new step tag
        live = self._live
        top = self.buckets[-1]
        preds, logits, scores, weights, bucket = [], [], [], [], None
        for start in range(0, x.shape[0], top):
            chunk = x[start:start + top]
            p, l, d, bucket = self._run_bucket(chunk, live)
            preds.append(p)
            logits.append(l)
            scores.append(d)
            weights.append(chunk.shape[0])
        total = float(sum(weights))
        disagreement = sum(s * (w / total) for s, w in zip(scores, weights))
        active = live[1].cpu().numpy()
        return {
            "predictions": np.concatenate(preds),
            "logits": np.concatenate(logits),
            "disagreement": np.asarray(disagreement),
            "bucket": bucket,
            "weights_step": live[2],
            "active_replicas": [int(i) for i in np.nonzero(active)[0]],
        }
