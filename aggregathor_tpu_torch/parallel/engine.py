"""The robust training engine, flat dataflow over a worker axis.

Counterpart of the flat mode of ``aggregathor_tpu/parallel/engine.py``
(its dataflow, ``engine.py:1-31``).  The n logical workers lie over a
``parallel.mesh.WorkerAxis`` of W ranks, one process a device, k = n/W
workers a rank (worker w = rank k + j); at W = 1 (the default) one device
holds the whole (n, d) matrix and no collective runs.  Per step, on each
rank:

0. **In-step augmentation** (``batch_transform``, optional): worker w's
   training batch goes through the transform with draws made on a CPU
   generator seeded from (seed, step, w, 3) and copied to the device, so
   worker w's augmentation depends on neither n nor the device.
1. **Isolated worker gradients** (``_worker_gradients``): one
   ``torch.func.vmap`` of ``grad_and_value(loss)`` over the k local workers'
   batches on the detached parameters (JAX ``engine.py:463-471``): every
   worker's forward and backward in one batched pass, all n workers'
   activations live at once.  The (n, *shape) gradient leaves are written
   into the (k, d) float32 matrix in the JAX package's coordinate order,
   one copy per leaf (``FlatMap.flatten_rows``).  Every stream below is
   keyed by the global worker index w, so W does not change the draws.
2. **Worker momentum** (``_send``, ``worker_momentum=beta``): each worker
   sends m <- beta m + (1 - beta) g, divided by 1 - beta^k for its k-th
   update (Adam's bias correction, k counted from the buffer's last zeroing,
   in float32), instead of its gradient.  It runs before the attack: an
   attacker forges what it sends, not what honest peers remember.
3. **The submission pipeline** (``_perturb_local``, JAX
   ``engine.py:503-558``), each row w with its own streams: the local
   attack on rows w < r (the static one, then the chaos regime's, both
   with a generator seeded from (seed, step, w, 1)); the wire codec
   (``exchange``: int8 or top-k, with error feedback the row sent is
   ``C(g + e)`` and the rank's ``TrainState.ef`` keeps the residual); the
   lossy link (``--UDP``), masking the lost packets of rows w < k from the
   (seed, step, w, 2) stream with NaN or, under ``clever:true``, the
   carry's row; the chaos regime's drop storm on every row (the same
   stream, at the regime's rate); its stragglers (one (seed, step, w, 5)
   draw: a late row becomes NaN, or under ``straggle-mode=stale`` the
   carry's row).  The carry then takes every row as it arrived (before
   the omniscient attack and the forgery below).  Then the submission
   forgery and its authentication (JAX ``engine.py:544-595``): under the
   regime's ``forge`` rate a worker w < r replaces its row with Gaussian
   noise times ``FORGE_SCALE`` (an impersonator; the draw is the first
   uniform of the (seed, step, w, 5) stream, the lateness draw's, as JAX
   draws both from one key; the noise from its own stream); under
   ``secure`` the sent row's digest (``secure.row_digest``) is taken;
   under the ``tamper`` rate (the (seed, step, w, 6) stream) one exponent
   bit of a drawn coordinate flips; the received row's digest is taken
   (the sent one where nothing was tampered); and under ``secure`` a
   forged or tampered row is NaN before the rule sees it, the digests and
   verdicts riding ``metrics["secure"]`` (``digest_sent``,
   ``digest_recv``: (n, 4) uint32; ``forged``, ``rejected``: (n,) bool,
   gathered worker-major at W > 1) to the host's HMAC check.  The health
   probe then flags the rows holding a non-finite value.  The chaos regime
   is the step's, ``regime_at(step)``, and every step's metrics carry it
   (``chaos_regime``).
4. **The wire** (``exchange_dtype``): under bfloat16 every row crosses it
   rounded (``compress.wire_roundtrip``); the rule computes in float32.  At
   W > 1 the wire is the reshard (``_reshard_to_blocks``, JAX
   ``engine.py:604-617``): the (k, d) rows, in the wire's dtype, padded to
   W blk columns (blk = ceil(d/W)), go through one ``all_to_all``, and each
   rank holds the (n, blk) column block of its coordinates.
5. **Omniscient attack and quarantine** (``_prepare_rows``): coalition
   attacks (the static one, then the chaos regime's) rewrite rows w < r
   from the honest statistics, and the whole matrix crosses the wire (the
   codec or the dtype) again; then the rows of at most f workers whose reputation fell
   below ``quarantine_threshold`` are masked NaN, which only a
   ``nan_row_tolerant`` rule accepts.
6. **Aggregation** (``_aggregate_block``): when the rule needs distances,
   one launch gives the block's (n, n) matrix (K1 up to 64 workers, the
   block's own median centring and K2 beyond), completed across the ranks
   by one ``all_reduce_sum`` at W > 1 and clamped at 0; then the rule on
   its block, handed the axis if it ``uses_axis`` (its row norms, liveness
   or Gram completed across the ranks) (K3-K5 for the rank-based
   rules and Bulyan's last phase, K6 for average-nan; the meta-rules' own
   passes), and under ``worker_metrics`` the rule's per-worker
   participation.  A rule that declares ``uses_key`` gets the step's GAR
   key, ``gar_key(seed, step)`` (JAX folds ``GAR_KEY_TAG`` into the step's
   key, ``engine.py:671-679``); under granularity:leaf leaf i's is
   ``fold_in_seed(gar_key, i)``, i the leaf's index in flattening order.  Under
   ``granularity="leaf"`` steps 4-6 run once per parameter leaf (each
   layer picks its own honest set: distance kernels once a leaf; at W > 1
   each leaf's (k, d_leaf) rows are ``all_gather``ed and every rank runs
   the rule on whole leaf rows, JAX's unrolled path ``engine.py:799-858``),
   the participation is the mean over the leaves, and the aggregate does
   not cross the wire again; under ``"vector"`` the (d,) aggregate crosses
   it back: at W > 1 the blocks' aggregates, in the wire's dtype, are
   ``all_gather``ed and cut to d, and the workers' distances to it are
   summed across the ranks.
7. **Update**: the (d,) aggregate is inflated to torch-layout views and the
   optimizer applies it in place to the one copy of the parameters.
   The loss sum is summed across the ranks and the probe's NaN rows are
   gathered worker-major, so every metric below is the same on every rank,
   and so are the parameters after the update.
8. **Finalize** (``_finalize_step``): the reputation EMA of a rank signal
   (1 if the worker's raw row, before quarantine, is among the n - f
   closest to the aggregate and finite), the health probe
   (``metrics["probe"]``, on by default), the suspicion metrics and the
   flight recorder's row.

``build_multi_step`` runs K such steps in one call, on K distinct batches
or one resident batch K times; ``build_sampled_multi_step`` draws each
step's batches from a dataset held on the device (``replicate``), worker
w's indices from the (seed, step, w, 4) stream, and gathers them there.
Both return per-step metrics with a leading K (the probe's fields too).

``trace_ops`` prints one ``TRACE step s dev <rank> ...`` line after the
gradients, the aggregate and the update, in the JAX package's words.

The momentum, the CLEVER carry and the codec's error-feedback residual are
(k, d) buffers of the rank's own workers (JAX keeps them worker-sharded);
no checkpoint holds the first two, and the residual is saved as every
worker's (n, d) rows, so a snapshot written at W restores at any W'
dividing n.

``put_batch``/``put_batches`` keep this rank's k workers of an (n, ...)
batch; ``put_batches`` also places a step-axis slice of a chunk and
``assemble_batches`` joins the slices (the input pipeline's transfer);
``build_gar_probe`` times the rule alone (``--gar-probe``).

The bounded-wait protocol (``parallel/bounded.py``, JAX
``engine.py:2249-2708``) splits the step in two: ``build_worker_grad``, one
worker's submission (its gradient, augmentation, momentum, local attack and
wire encoding, steps 0-3 for one row), which the protocol runs once a
worker on a stream of its own, and ``build_bounded_aggregate``, the
aggregate and update of steps 4-8 over the rows that arrived, the others
NaN or a stale carry (``build_incremental_fold`` decodes a row into the
aggregate's buffer as it lands).  It needs granularity ``vector``, no
lossy link or chaos schedule in the step, and one rank (W = 1).  The
sharded mode's submission builders (``build_group_grad``,
``build_submesh_grad``) wait for the sharded engine (ROADMAP queue 1 item
8).

Refused with a UserException: the sharded mode,
``leaf_bucketing=True`` (the bucketed per-leaf path needs kernels with a
batch dimension), and ``l1_regularize``/``l2_regularize`` (the JAX flat
engine refuses them too: its loss carries them).
"""

import numpy as np
import torch
from torch.func import grad_and_value, vmap

from ..core.flatten import FlatMap
from ..core.train_state import TrainState
from ..gars import GAR_KEY_TAG
from ..gars.common import nonfinite_to_inf, smallest_k_mask
from ..guardian import probe as health
from ..ops import kernels
from ..utils import UserException, fold_in_seed, resolve_device
from ..gars import rule_kwargs
from ..gars.common import completed_distances
from .compress import parse_exchange_spec, wire_dtype, wire_roundtrip
from .mesh import WorkerAxis

#: stream tags, as the JAX engine folds them: the local attacks (1), the
#: in-step augmentation (3) and the device-side sampling (4); the lossy
#: link's (2) lives in ``lossy.py``; the rule's key folds ``GAR_KEY_TAG``
#: (``gar_key``).  Under granularity:leaf the JAX engine also folds leaf i's
#: omniscient-attack key with 20_000 + i; no ported omniscient attack draws
#: from a key (empire and little are deterministic), so the port derives no
#: such stream
ATTACK_TAG = 1
AUGMENT_TAG = 3
SAMPLE_TAG = 4
#: the submission forgery's streams: the forge verdict reads the first
#: uniform of the lateness stream (5, ``chaos/stragglers.py``), as JAX's
#: ``bernoulli(fold_in(wkey, 5))`` shares the straggler's key; the tamper
#: verdict (6); the impostor's noise and the tampered coordinate on
#: streams of their own, apart from 1-6, ``GAR_KEY_TAG`` and
#: ``RNG_PERTURB_TAG``
FORGE_TAG = 5
TAMPER_TAG = 6
IMPOSTOR_TAG = 51
TAMPER_COORD_TAG = 61

def gar_key(seed, step):
    """The step's GAR key, an int seed: ``fold_in_seed(fold_in_seed(seed,
    step), GAR_KEY_TAG)``, as JAX folds the step into the run's key and the
    tag into that.  A function of (seed, step) alone, so the same on the CPU
    and the card, in every ``--unroll`` chunk and after a resume, and moved
    with the seed by the guardian's perturbation; the tag keeps it apart
    from the (seed, step, worker, tag) streams."""
    return fold_in_seed(fold_in_seed(seed, step), GAR_KEY_TAG)


#: engine options of the JAX package this port does not carry yet
UNPORTED_OPTIONS = ()


def stream_generator(seed, step, worker, tag, device):
    """A ``torch.Generator`` on ``device`` for the (seed, step, worker, tag)
    stream: disjoint streams for distinct tuples, the same draws every run."""
    words = np.random.SeedSequence([seed, step, worker, tag]).generate_state(2, np.uint32)
    value = (int(words[0]) << 31) ^ int(words[1])
    return torch.Generator(device=device).manual_seed(value)


def bias_correction(beta, count, device):
    """Adam's momentum bias correction ``1 - beta^count`` in float32, as the
    JAX engine computes it, as a 0-d tensor on ``device``: the momentum is
    divided by a tensor (CUDA divides by a host scalar as a product with its
    reciprocal, a bit off the quotient)."""
    correction = np.float32(1.0) - np.float32(beta) ** np.float32(count)
    return torch.full((), float(correction), dtype=torch.float32, device=device)


def validate_reputation_args(gar, reputation_decay, quarantine_threshold):
    """The normalized ``(decay, threshold)`` pair, or a UserException.
    Quarantine masks at most f workers a step (``quarantine_mask``), so it
    needs f >= 1 and a rule that excludes an all-NaN row cleanly."""
    decay = None if reputation_decay is None else float(reputation_decay)
    threshold = float(quarantine_threshold)
    if decay is not None and not 0.0 < decay < 1.0:
        raise UserException("reputation_decay must lie in (0, 1), got %r" % reputation_decay)
    if threshold:
        if decay is None:
            raise UserException("quarantine_threshold needs reputation_decay set")
        if not 0.0 < threshold < 1.0:
            raise UserException("quarantine_threshold must lie in (0, 1), got %r" % quarantine_threshold)
        if gar.nb_byz_workers < 1:
            raise UserException(
                "Quarantine masks up to f workers per step; declare --nb-decl-byz-workers >= 1 to use it"
            )
        if not gar.nan_row_tolerant:
            from ..gars import gars as registry

            tolerant = sorted(name for name in registry.itemize()
                              if getattr(registry.get(name), "nan_row_tolerant", False))
            raise UserException(
                "Quarantine masks rows to NaN, which %s does not cleanly exclude (pick a NaN-excluding "
                "rule: %s)" % (type(gar).__name__, ", ".join(tolerant))
            )
    return decay, threshold


def validate_chaos_args(chaos, attack, lossy_link, nb_workers, nb_real_byz):
    """A ChaosSchedule against the engine's own configuration (JAX
    ``engine.py:120-148``); returns ``chaos``."""
    if chaos is None:
        return None
    if attack is not None or lossy_link is not None:
        raise UserException("--chaos subsumes the static --attack/--UDP knobs: encode them as schedule regimes "
                            "instead (e.g. '0:attack=empire' / '0:drop=0.3')")
    if chaos.nb_workers != nb_workers:
        raise UserException("ChaosSchedule was built for n=%d workers but the engine has %d"
                            % (chaos.nb_workers, nb_workers))
    if chaos.has_attacks or chaos.has_forgery:
        if nb_real_byz == 0:
            raise UserException("The chaos schedule declares attack/forge/tamper regimes; they need "
                                "--nb-real-byz-workers > 0 to have anyone to run them")
        if chaos.nb_real_byz != nb_real_byz:
            raise UserException("ChaosSchedule was built for %d real Byzantine workers but the engine declares %d"
                                % (chaos.nb_real_byz, nb_real_byz))
    return chaos


def quarantine_mask(reputation, threshold, nb_byz):
    """(n,) bool: below ``threshold`` and among the ``nb_byz`` lowest
    reputations (ties to the lower index), so at most f rows are masked."""
    return (reputation < threshold) & smallest_k_mask(reputation, nb_byz)


def fused_ema(beta, old, new):
    """``beta * old + (1 - beta) * new`` in float32, rounded once, as the JAX
    engine's compiled step rounds it (XLA fuses the first product into the
    sum): the product and the sum are taken in float64, where the product of
    two float32 values is exact."""
    scaled = ((1.0 - beta) * new).to(torch.float64)
    return (float(np.float32(beta)) * old.to(torch.float64) + scaled).to(torch.float32)


def stack_metrics(per_step):
    """One dict of per-step metrics (nested dicts too, as the probe's) with
    a leading axis over the steps."""
    first = per_step[0]
    return {name: stack_metrics([m[name] for m in per_step]) if isinstance(value, dict)
            else torch.stack([m[name] for m in per_step]) for name, value in first.items()}


def index_metrics(metrics, index):
    """Entry ``index`` of stacked metrics, nested dicts included."""
    return {name: index_metrics(value, index) if isinstance(value, dict) else value[index]
            for name, value in metrics.items()}


class RobustEngine:
    """The robust engine on one device (see the module docstring).

    Args:
      gar: the aggregation rule (``gars.instantiate``).
      nb_workers: n logical workers (default: the rule's n).
      nb_real_byz: r, the workers that actually attack (the first r rows).
      attack: an ``attacks.Attack`` or None.
      lossy_link: a ``lossy.LossyLink`` (``--UDP``) or None.
      exchange_dtype: the wire's dtype (None or float32: exact; bfloat16).
      exchange: a wire spec (``f32``, ``bf16``, ``int8[:ef]``,
        ``topk:k=K|frac=F[,ef]``) or a ``compress.WireCodec``; not with
        ``exchange_dtype``.
      chaos: a ``chaos.ChaosSchedule`` (not with ``attack``/``lossy_link``).
      worker_momentum: beta in (0, 1): workers send bias-corrected momenta.
      batch_transform: an in-step augmentation (``preprocessing.device_transform``)
        applied to each worker's training batch, or None.
      worker_metrics: add ``worker_sq_dist`` (each worker's squared
        distance to the aggregate), the rule's ``worker_participation``
        and, with reputation, ``worker_reputation`` and ``nb_quarantined``.
      reputation_decay: beta in (0, 1) of the reputation EMA, or None.
      quarantine_threshold: mask (NaN) the rows of at most f workers whose
        reputation is below it; 0 disables.
      granularity: "vector" (the whole row) or "leaf" (per parameter leaf).
      leaf_bucketing: "auto" or False, both the per-leaf loop.
      trace_ops: print a TRACE line after each phase of the step.
      health_probe: add ``metrics["probe"]`` (default on).
      flight: an ``obs.flight.FlightRecorder`` or None.
      secure: authenticated submission: digests of every row sent and
        received, a forged or tampered row NaN (``metrics["secure"]``).
      device: "cuda" (default) or "cpu"; CUDA without a GPU raises.
      sharding: only "flat" is ported.
      axis: the ``parallel.mesh.WorkerAxis`` of a W-rank run (its device
        wins over ``device``); None: one rank.
    """

    def __init__(self, gar, nb_workers=None, nb_real_byz=0, attack=None, lossy_link=None,
                 exchange_dtype=None, worker_momentum=None, batch_transform=None, worker_metrics=False,
                 reputation_decay=None, quarantine_threshold=0.0, granularity="vector", leaf_bucketing="auto",
                 trace_ops=False, health_probe=True, flight=None, l1_regularize=None, l2_regularize=None,
                 device="cuda", sharding="flat", axis=None, chaos=None, exchange=None, secure=False, **options):
        for name, value in options.items():
            if name not in UNPORTED_OPTIONS:
                raise TypeError("RobustEngine got an unexpected keyword argument %r" % name)
            if value not in (None, False, 0, 0.0):
                raise UserException("%s is not available in the PyTorch port yet" % name)
        if sharding != "flat":
            raise UserException("sharding=%r is not available in the PyTorch port yet (flat only)" % sharding)
        if granularity not in ("vector", "leaf"):
            raise UserException(
                "granularity must be vector or leaf (got %r); layer/global need the sharded mode "
                "(sharding='sharded')" % (granularity,)
            )
        if leaf_bucketing != "auto" and not isinstance(leaf_bucketing, bool):
            raise UserException("leaf_bucketing must be 'auto' or a bool (got %r)" % (leaf_bucketing,))
        if leaf_bucketing is True:
            raise UserException(
                "leaf_bucketing=True (one batched rule call per leaf size) is not available in the PyTorch "
                "port yet: it needs the distance and rank kernels with a batch dimension; 'auto' and False "
                "run the per-leaf loop"
            )
        if l1_regularize or l2_regularize:
            raise UserException(
                "the flat engine takes l1/l2 inside loss_fn (the per-worker loss is global there); "
                "l1_regularize/l2_regularize are the sharded engine's analytic equivalent"
            )
        self.gar = gar
        self.nb_workers = int(nb_workers if nb_workers is not None else gar.nb_workers)
        self.nb_real_byz = int(nb_real_byz)
        self.attack = attack
        self.lossy_link = lossy_link
        self.chaos = validate_chaos_args(chaos, attack, lossy_link, self.nb_workers, self.nb_real_byz)
        self.batch_transform = batch_transform
        self.exchange_dtype = wire_dtype(exchange_dtype)
        # the wire codec (JAX engine.py:377-414): bf16/f32 specs land on the
        # dtype twin, int8/topk engage the codec of the submission pipeline
        self.codec = None
        if exchange is not None:
            if self.exchange_dtype is not None:
                raise UserException("pass either exchange= (the wire codec spec) or exchange_dtype=, not both — "
                                    "bf16 is spelled exchange='bf16' on the codec surface")
            spec_dtype, self.codec = parse_exchange_spec(exchange)
            if spec_dtype is not None:
                self.exchange_dtype = spec_dtype
        if self.codec is not None:
            self.codec.validate_for(gar=gar)
        #: the per-worker error-feedback residual rides TrainState.ef
        self.carries_ef = self.codec is not None and self.codec.uses_ef
        self.worker_momentum = None if worker_momentum is None else float(worker_momentum)
        if self.worker_momentum is not None and not 0.0 < self.worker_momentum < 1.0:
            raise UserException("worker_momentum must lie in (0, 1), got %r" % worker_momentum)
        self.worker_metrics = bool(worker_metrics)
        self.reputation_decay, self.quarantine_threshold = validate_reputation_args(
            gar, reputation_decay, quarantine_threshold)
        self.granularity = granularity
        self.trace_ops = bool(trace_ops)
        self.health_probe = bool(health_probe)
        self.secure = bool(secure)
        self.flight = flight
        if flight is not None:
            flight.validate_for(nb_workers=self.nb_workers, probe=self.health_probe,
                                worker_metrics=self.worker_metrics, chaos=self.chaos is not None,
                                secure=self.secure)
        # CLEVER infill reads the rows received last step (TrainState.carry);
        # stale-mode stragglers re-send the same carry
        self.carries_gradients = (lossy_link is not None and lossy_link.clever) or (
            self.chaos is not None and self.chaos.needs_carry)
        if axis is None:
            axis = WorkerAxis(self.nb_workers, 1, 0, resolve_device(device))
        elif axis.nb_workers != self.nb_workers:
            raise UserException("the worker axis holds %d workers, the engine %d" % (axis.nb_workers, self.nb_workers))
        self.axis = axis
        self.device = axis.device
        self.nb_devices = axis.size
        self.workers_per_device = axis.workers_per_device
        if self.nb_real_byz > self.nb_workers:
            raise UserException("More real Byzantine workers than workers")
        if attack is not None and self.nb_real_byz == 0:
            raise UserException("An attack needs --nb-real-byz-workers > 0 to have anyone to run it")

    # ------------------------------------------------------------------ #

    def _worker_gradients(self, params, batch, loss_fn, flatmap):
        """((n,) losses, (n, d) float32 gradient rows in JAX coordinate order):
        one vmapped forward and backward over the n workers' batches."""
        detached = {name: value.detach() for name, value in params.items()}
        grads, losses = vmap(grad_and_value(loss_fn), in_dims=(None, 0))(detached, batch)
        return losses.detach(), flatmap.flatten_rows(grads)

    def _worker_draws(self, draw, seed, step, tag):
        """``draw(generator)`` -> dict of CPU tensors, made for each local
        worker from its global (seed, step, w, tag) stream on a CPU
        generator (so a CPU and a card run, and every W, draw alike),
        stacked to (k, ...) and copied to the device."""
        per_worker = [draw(stream_generator(seed, step, self.axis.worker_index(j), tag, "cpu"))
                      for j in range(self.workers_per_device)]
        return {key: self._to_device(torch.stack([draws[key] for draws in per_worker]))
                for key in per_worker[0]}

    def _augment(self, batch, seed, step):
        """The in-step augmentation of a training batch (identity without one)."""
        transform = self.batch_transform
        if transform is None:
            return batch
        size = batch["image"].shape[1]
        draws = self._worker_draws(lambda generator: transform.draw(size, generator), seed, step, AUGMENT_TAG)
        return transform(batch, draws)

    def _perturb_local(self, rows, seed, step, carry=None, ridx=None, ef=None):
        """The submission pipeline on the local (k, d) rows, each row with
        its own streams (JAX ``engine.py:503-558``): the local attacks on
        the workers w < r (the static one, then regime ``ridx``'s), the wire
        codec (with ``ef``, the rank's residuals, updated in place), the
        lossy link on the lossy workers, the regime's drop storm and its
        stragglers.  ``carry`` (the rows received last step) is then
        overwritten with the rows as they arrived, in place, before the
        forgery (``_forge_and_authenticate``).  Returns ``(rows, secure)``,
        ``secure`` the rank's digests and verdicts (None unless secure)."""
        local = [(j, self.axis.worker_index(j)) for j in range(self.workers_per_device)]
        workers = [w for _, w in local]
        chaos = self.chaos
        attack = self.attack if self.attack is not None and not self.attack.omniscient else None
        if attack is not None or (chaos is not None and chaos.has_local_attacks):
            for j, w in local:
                if w < self.nb_real_byz:
                    # both draw from the worker's (seed, step, w, 1) stream
                    if attack is not None:
                        rows[j] = attack.apply_local(rows[j], stream_generator(seed, step, w, ATTACK_TAG, self.device))
                    if chaos is not None:
                        rows[j] = chaos.apply_local_attacks(
                            ridx, rows[j], stream_generator(seed, step, w, ATTACK_TAG, self.device))
        if self.codec is not None:
            # the wire: encoded after the attacks (an attacker forges what it
            # sends), before the transport faults (a lost packet is a run of
            # the decoded image); the rows' codec is row by row, so one call
            # over the (k, d) rows is each worker's own
            if ef is not None:
                image, residual = self.codec.ef_roundtrip(rows, ef)
                ef.copy_(residual)
            else:
                image = self.codec.roundtrip(rows)
            rows.copy_(image)
        d = rows.shape[1]
        link = self.lossy_link
        if link is not None:
            drops = torch.stack([link.draw_drops(d, seed, step, w) for w in workers])
            rows = link.apply_rows(rows, workers, drops, previous=carry)
        if chaos is not None and chaos.drop_rate(ridx) > 0:
            # the storm hits every worker (a rate of 0 drops nothing)
            drops = torch.stack([chaos.draw_drops(d, seed, step, w, ridx) for w in workers])
            rows = chaos.link.apply_rows(rows, workers, drops)
        if chaos is not None and chaos.straggler_rate(ridx) > 0:
            rate, stale = chaos.straggler_rate(ridx), chaos.straggler_stale(ridx)
            for j, w in local:
                late = chaos.stragglers.draw_late(seed, step, w, rate)
                rows[j] = chaos.stragglers.apply(rows[j], late, stale, previous=carry[j] if carry is not None else None)
        if carry is not None:
            carry.copy_(rows)
        return self._forge_and_authenticate(rows, local, seed, step, ridx)

    def draw_forge(self, seed, step, worker, rate):
        """bool: does worker ``worker`` forge at ``step``?  The first uniform
        of its (seed, step, w, 5) stream below ``rate``, the same uniform
        the straggler lateness reads (trap s)."""
        generator = stream_generator(seed, step, worker, FORGE_TAG, "cpu")
        return bool(torch.rand((), generator=generator) < rate)

    def draw_tamper(self, seed, step, worker, rate):
        """bool: is worker ``worker``'s row tampered at ``step``?  The first
        uniform of its (seed, step, w, 6) stream below ``rate``."""
        generator = stream_generator(seed, step, worker, TAMPER_TAG, "cpu")
        return bool(torch.rand((), generator=generator) < rate)

    def draw_tamper_coord(self, seed, step, worker, d):
        """The coordinate a tamper flips, uniform in [0, d)."""
        generator = stream_generator(seed, step, worker, TAMPER_COORD_TAG, "cpu")
        return int(torch.randint(0, d, (), generator=generator))

    def draw_impostor(self, seed, step, worker, d):
        """An impostor's (d,) row: N(0, 1) noise times ``FORGE_SCALE``, drawn
        on the engine's device."""
        from ..secure.submit import FORGE_SCALE

        generator = stream_generator(seed, step, worker, IMPOSTOR_TAG, self.device)
        return torch.randn(d, generator=generator, dtype=torch.float32, device=self.device) * FORGE_SCALE

    def _forge_and_authenticate(self, rows, local, seed, step, ridx):
        """The forgery pipeline on the local (k, d) rows, in JAX's order
        (``engine.py:544-595``): forge, sent digest, tamper, received
        digest, rejection (module docstring, step 3).  Returns ``(rows,
        secure)``; ``secure`` holds the rank's (k, 4) uint32 digests and
        (k,) bool verdicts, or is None unless ``secure``."""
        chaos = self.chaos
        forgery = chaos is not None and chaos.has_forgery
        if not (forgery or self.secure):
            return rows, None
        from ..secure.submit import row_digest, tamper_row

        k, d = rows.shape
        forged, tampered = np.zeros(k, bool), np.zeros(k, bool)
        forge_rate = chaos.forge_rate(ridx) if forgery else 0.0
        tamper_rate = chaos.tamper_rate(ridx) if forgery else 0.0
        if forge_rate > 0:
            for j, w in local:
                if w < self.nb_real_byz and self.draw_forge(seed, step, w, forge_rate):
                    forged[j] = True
                    rows[j] = self.draw_impostor(seed, step, w, d)
        sent = row_digest(rows) if self.secure else None
        if tamper_rate > 0:
            for j, w in local:
                if w < self.nb_real_byz and self.draw_tamper(seed, step, w, tamper_rate):
                    tampered[j] = True
                    rows[j] = tamper_row(rows[j], self.draw_tamper_coord(seed, step, w, d))
        if not self.secure:
            return rows, None
        # an untampered row arrives as sent: its digest is the sender's
        recv = sent.clone() if tampered.any() else sent
        for j in np.nonzero(tampered)[0]:
            recv[j] = row_digest(rows[j])
        rejected = forged | tampered
        for j in np.nonzero(rejected)[0]:
            rows[j] = float("nan")
        flags = self._to_device(torch.from_numpy(np.stack([forged, rejected])))
        return rows, {"digest_sent": sent, "digest_recv": recv, "forged": flags[0], "rejected": flags[1]}

    def _gather_secure(self, secure):
        """The ranks' digests and verdicts, worker-major (n, ...), on every rank."""
        if secure is None or self.nb_devices == 1:
            return secure
        out = {}
        for name, value in secure.items():
            wire = value.to(torch.int64) if value.dtype == torch.uint32 else value
            gathered = self.axis.all_gather(wire).reshape((self.nb_workers,) + tuple(value.shape[1:]))
            out[name] = gathered.to(value.dtype)
        return out

    def _send(self, state, rows):
        """What the workers send: their gradients, or under worker momentum
        their bias-corrected momenta (``state.momentum`` and its update count
        advance)."""
        if self.worker_momentum is None:
            return rows
        beta = self.worker_momentum
        state.momentum = beta * state.momentum + (1.0 - beta) * rows
        state.momentum_steps += 1
        return state.momentum / bias_correction(beta, state.momentum_steps, rows.device)

    def _prepare_rows(self, rows, reputation=None, ridx=None):
        """Omniscient attacks (the static one, then regime ``ridx``'s: the
        coalition rewrites rows w < r; the whole matrix then crosses the
        wire again, the codec's or the dtype's), then the quarantine mask.
        Returns ``(rows, raw_rows)``: what the rule consumes, and the rows
        before the quarantine, which the reputation signal measures (masking
        first would measure the attacker's honest gradient and never suspect
        it)."""
        forged = False
        byz_mask = torch.arange(self.nb_workers, device=rows.device) < self.nb_real_byz
        if self.attack is not None and self.attack.omniscient:
            rows = self.attack.apply_matrix(rows, byz_mask)
            forged = True
        if self.chaos is not None and self.chaos.has_omniscient_attacks:
            rows = self.chaos.apply_omniscient_attacks(ridx, rows, byz_mask)
            forged = True
        if forged:
            rows = wire_roundtrip(rows, self.exchange_dtype, codec=self.codec)
        raw_rows = rows
        if self.quarantine_threshold:
            masked = quarantine_mask(reputation, self.quarantine_threshold, self.gar.nb_byz_workers)
            rows = torch.where(masked[:, None], torch.nan, rows)
        return rows, raw_rows

    def _distances(self, rows, axis=None):
        """The rule's pairwise squared distances of ``rows`` (one K1 or K2
        launch), completed over ``axis`` and clamped at 0, or None when the
        rule needs none."""
        if not self.gar.needs_distances:
            return None
        return completed_distances(kernels.pairwise_sq_distances(rows), axis)

    def _aggregate_block(self, rows, key=None, axis=None):
        """Distances (one K1 or K2 launch, completed over ``axis``) when the
        rule needs them, then the rule, given ``key`` if it ``uses_key`` and
        ``axis`` if it ``uses_axis``: ``(aggregate, participation)``, the
        participation None unless ``worker_metrics`` and the rule weighs
        whole workers."""
        dist2 = self._distances(rows, axis)
        if self.worker_metrics:
            # as in _call_aggregate, only a uses_key (uses_axis) rule is
            # handed the key (axis): a rule's two-argument override stays
            # callable
            return self.gar.aggregate_block_and_participation(rows, dist2, **rule_kwargs(self.gar, key, axis))
        return self.gar._call_aggregate(rows, dist2, key=key, axis=axis), None

    def _sq_dists(self, rows, raw_rows, agg):
        """(worker_sq_dist, rep_dist): each worker's squared distance to the
        aggregate over the rows the rule saw, and over the raw rows (each
        None unless its feature is on)."""
        def sq_dist(x):
            diff = x - agg[None, :]
            return torch.sum(diff * diff, dim=1)

        return (sq_dist(rows) if self.worker_metrics else None,
                sq_dist(raw_rows) if self.reputation_decay is not None else None)

    def _reshard_to_blocks(self, rows):
        """(k, d) rows of this rank's workers -> the (n, blk) float32 column
        block of its coordinates, blk = ceil(d/W): the rows in the wire's
        dtype, zero-padded to W blk columns, through one ``all_to_all``
        (JAX ``_reshard_to_blocks``, ``engine.py:604-617``)."""
        W, k = self.nb_devices, self.workers_per_device
        d = rows.shape[1]
        if self.exchange_dtype is not None:
            rows = rows.to(self.exchange_dtype)
        blk = -(-d // W)
        padded = torch.nn.functional.pad(rows, (0, W * blk - d))
        pieces = padded.view(k, W, blk).transpose(0, 1)  # (W, k, blk): piece i goes to rank i
        return self.axis.all_to_all(pieces).reshape(self.nb_workers, blk).to(torch.float32)

    def _aggregate_vector(self, rows, reputation, key=None, ridx=None):
        """granularity:vector: the rows through the wire (at W > 1 the
        reshard to column blocks), the attack, the quarantine and the rule
        (given the step's GAR ``key``); the aggregate crosses the wire back
        (at W > 1 the blocks' aggregates are gathered and cut to d).
        Returns ``(agg, participation, wdist, rep_dist)``."""
        if self.nb_devices == 1:
            rows, raw_rows = self._prepare_rows(wire_roundtrip(rows, self.exchange_dtype), reputation, ridx)
            agg, participation = self._aggregate_block(rows, key)
            agg = wire_roundtrip(agg, self.exchange_dtype)
            return (agg, participation) + self._sq_dists(rows, raw_rows, agg)
        d = rows.shape[1]
        block, raw_block = self._prepare_rows(self._reshard_to_blocks(rows), reputation, ridx)
        agg_block, participation = self._aggregate_block(block, key, self.axis)
        wire = agg_block if self.exchange_dtype is None else agg_block.to(self.exchange_dtype)
        agg = self.axis.all_gather(wire).reshape(-1)[:d].to(torch.float32)
        wdist, rep_dist = self._sq_dists(block, raw_block, wire_roundtrip(agg_block, self.exchange_dtype))
        present = [value for value in (wdist, rep_dist) if value is not None]
        if present:
            # the blocks' squared distances summed across the ranks, in one collective
            summed = iter(self.axis.all_reduce_sum(torch.stack(present)).unbind(0))
            wdist = None if wdist is None else next(summed)
            rep_dist = None if rep_dist is None else next(summed)
        return agg, participation, wdist, rep_dist

    def _aggregate_per_leaf(self, rows, flatmap, reputation, key=None, ridx=None):
        """granularity:leaf: each parameter leaf's (n, d_leaf) columns
        through the wire, the attack, the quarantine and the rule on their
        own (per-layer selection; the distance kernels launch once a leaf;
        leaf i's rule key is ``fold_in_seed(key, i)``), the aggregates
        concatenated in flattening order.  The participation is the mean
        over the leaves, the distances summed over them.  Returns ``(agg,
        participation, wdist, rep_dist)``."""
        parts = []
        participation, nb_parts = None, 0
        wdist = rep_dist = None
        for i, (_, _, offset, size, _, _) in enumerate(flatmap.slices):
            if self.nb_devices == 1:
                leaf = wire_roundtrip(rows[:, offset:offset + size], self.exchange_dtype).contiguous()
            else:
                # one all_gather a leaf, in the wire's dtype: every rank
                # holds the whole (n, d_leaf) rows (JAX :799-858)
                local = rows[:, offset:offset + size]
                if self.exchange_dtype is not None:
                    local = local.to(self.exchange_dtype)
                leaf = self.axis.all_gather(local).reshape(self.nb_workers, size).to(torch.float32)
            leaf, raw_leaf = self._prepare_rows(leaf, reputation, ridx)
            agg_leaf, part = self._aggregate_block(leaf, None if key is None else fold_in_seed(key, i))
            if part is not None:
                participation = part if participation is None else participation + part
                nb_parts += 1
            leaf_wdist, leaf_rep = self._sq_dists(leaf, raw_leaf, agg_leaf)
            if leaf_wdist is not None:
                wdist = leaf_wdist if wdist is None else wdist + leaf_wdist
            if leaf_rep is not None:
                rep_dist = leaf_rep if rep_dist is None else rep_dist + leaf_rep
            parts.append(agg_leaf)
        if participation is not None:
            participation = participation / nb_parts
        return torch.cat(parts), participation, wdist, rep_dist

    def _finalize_step(self, state, losses, agg, worker_nan, participation, wdist, rep_dist, ridx=None,
                       secure=None):
        """After the update: the loss sum (summed across the ranks), the
        reputation EMA, the probe, the metrics dict and the flight
        recorder's row; advances ``state.step``.  Returns ``(state,
        metrics)``."""
        total_loss = torch.sum(losses)
        if self.nb_devices > 1:
            total_loss = self.axis.all_reduce_sum(total_loss)
        # a cascaded sum of squares: torch's CPU vector_norm of a float32
        # vector of 11M coordinates errs by ~4e-4 relative
        update_norm = torch.sqrt(torch.sum(torch.square(agg)))
        metrics = {"total_loss": total_loss, "grad_norm": update_norm}
        reputation = state.reputation  # before this step's update: the mask used it
        if self.reputation_decay is not None:
            # the rank signal: among the n - f closest raw rows, and finite (a
            # NaN row reads +inf; the gate stops +inf index ties from
            # rewarding low-index dead workers)
            signal = (smallest_k_mask(nonfinite_to_inf(rep_dist), self.nb_workers - self.gar.nb_byz_workers)
                      .to(torch.float32) * torch.isfinite(rep_dist).to(torch.float32))
            state.reputation = fused_ema(self.reputation_decay, reputation, signal)
        if self.health_probe:
            metrics[health.PROBE_KEY] = health.probe_metrics(
                total_loss, update_norm, health.spike_score(total_loss, state.loss_ema), worker_nan)
            state.loss_ema = health.update_loss_ema(state.loss_ema, total_loss)
        if secure is not None:
            metrics["secure"] = secure
        if ridx is not None:
            # the observability layer's regime column (JAX :911-914): filled
            # on the device, as a copy from host memory would wait for the card
            metrics["chaos_regime"] = torch.full((), ridx, dtype=torch.int32, device=agg.device)
        if self.worker_metrics:
            metrics["worker_sq_dist"] = wdist
            if participation is not None:
                metrics["worker_participation"] = participation
            if self.reputation_decay is not None:
                metrics["worker_reputation"] = state.reputation
                if self.quarantine_threshold:
                    metrics["nb_quarantined"] = torch.sum(
                        quarantine_mask(reputation, self.quarantine_threshold, self.gar.nb_byz_workers),
                        dtype=torch.int32)
        if self.flight is not None:
            self.flight.record(state.flight, state.step, metrics)
        state.step += 1
        return state, metrics

    def _mark(self, state, phase, value):
        """Under ``trace_ops``, the JAX engine's narrative line for a phase."""
        if self.trace_ops:
            print("TRACE step %d dev %d %s %s" % (state.step, self.axis.rank, phase, np.asarray(value.detach().cpu())),
                  flush=True)

    # ------------------------------------------------------------------ #

    def init_state(self, params, tx, seed=0):
        """A TrainState holding ``params`` moved to the engine's device
        (leaf tensors that require grad), a fresh optimizer state and the
        side buffers of the features that are on: under clever infill (or
        stale stragglers) a zero (k, d) carry of the rank's workers (a
        packet lost before anything arrived reads as 0), their zero momenta,
        their zero error-feedback residuals, reputations of 1.0, an unset
        loss EMA, an empty flight ring.  A codec's budget is checked
        against d here (JAX ``engine.py:1413-1420``)."""
        params = {
            name: value.detach().to(self.device, torch.float32).clone().requires_grad_(True)
            for name, value in params.items()
        }
        state = TrainState(params=params, opt_state=tx.init(params), step=0, seed=int(seed))
        d = sum(value.numel() for value in params.values())
        if self.codec is not None:
            self.codec.validate_d(d)
        if self.carries_ef:
            state.ef = torch.zeros((self.workers_per_device, d), dtype=torch.float32, device=self.device)
        if self.carries_gradients:
            state.carry = torch.zeros((self.workers_per_device, d), dtype=torch.float32, device=self.device)
        if self.worker_momentum is not None:
            state.momentum = torch.zeros((self.workers_per_device, d), dtype=torch.float32, device=self.device)
        if self.reputation_decay is not None:
            state.reputation = torch.ones(self.nb_workers, dtype=torch.float32, device=self.device)
        if self.health_probe:
            state.loss_ema = torch.full((), health.EMA_UNSET, dtype=torch.float32, device=self.device)
        if self.flight is not None:
            state.flight = self.flight.init_buffers(self.device)
        return state

    def gather_ef(self, state):
        """Every worker's (n, d) error-feedback residuals, what a checkpoint
        saves: ``state.ef`` at W = 1, one ``all_gather`` of the ranks' rows
        at W > 1 (a collective: every rank calls it); None without them."""
        if state.ef is None:
            return None
        if self.nb_devices == 1:
            return state.ef
        return self.axis.all_gather(state.ef).reshape(self.nb_workers, -1)

    def _to_device(self, tensor):
        """``tensor`` on the engine's device; on CUDA through pinned memory,
        copied asynchronously on the current stream.  A tensor pinned already
        (a slice of the input pipeline's ping-pong buffer, whose owner keeps
        it until the copy is done) is copied as it is; any other is pinned
        first (the caching host allocator keeps that block until the copy is
        done)."""
        if self.device.type != "cuda":
            return tensor.to(self.device)
        if not tensor.is_pinned():
            tensor = tensor.pin_memory()
        return tensor.to(self.device, non_blocking=True)

    def _put(self, batch, lead):
        out = {}
        k = self.workers_per_device
        for key, value in batch.items():
            tensor = torch.as_tensor(np.ascontiguousarray(value))
            if tuple(tensor.shape[:len(lead)]) != lead:
                raise UserException(
                    "batch %r leads with %s, expected %s" % (key, tuple(tensor.shape[:len(lead)]), lead)
                )
            if self.nb_devices > 1:
                # this rank's k workers of the global batch
                tensor = tensor.narrow(len(lead) - 1, self.axis.rank * k, k).contiguous()
            out[key] = self._to_device(tensor)
        return out

    def put_batch(self, batch):
        """Move this rank's k workers of a worker-major numpy batch (leading
        axis n) to the device."""
        return self._put(batch, (self.nb_workers,))

    def put_batches(self, chunk):
        """Move a (K, n, ...) numpy chunk of K batches to the device; also a
        step-axis slice (k_i, n, ...) of one, as the input pipeline sends
        them (JAX ``shard_batches``)."""
        first = next(iter(chunk.values()))
        return self._put(chunk, (int(np.shape(first)[0]), self.nb_workers))

    def assemble_batches(self, parts):
        """Join step-axis slices (each ``put_batches``-placed) into the one
        (K, n, ...) chunk ``build_multi_step`` consumes: one ``torch.cat``
        along the step axis a leaf, into a fresh buffer on the device, so the
        slices' host buffers may be refilled once it has run (JAX
        ``assemble_batches``)."""
        return {key: torch.cat([part[key] for part in parts]) for key in parts[0]}

    def replicate(self, tree):
        """Put a dataset (name -> array, leading axis the examples) on the
        engine's device once, for ``build_sampled_multi_step``."""
        return {key: torch.as_tensor(np.ascontiguousarray(value)).to(self.device) for key, value in tree.items()}

    def build_step(self, loss_fn, tx):
        """Build the robust training step.

        Args:
          loss_fn: (params, worker_batch) -> scalar loss.
          tx: the optimizer (``core.build_optimizer``).
        Returns:
          step(state, batch) -> (state, metrics): ``batch`` is worker-major
          (``put_batch``); the state is updated in place and returned;
          ``metrics`` holds the device scalars ``total_loss`` (sum of the n
          worker losses) and ``grad_norm`` (norm of the aggregate), the
          probe's fields under ``"probe"`` and the worker metrics of the
          features that are on, as the JAX engine's step returns them.
        """

        def step(state, batch):
            flatmap = FlatMap(state.params)
            batch = self._augment(batch, state.seed, state.step)
            losses, rows = self._worker_gradients(state.params, batch, loss_fn, flatmap)
            self._mark(state, "losses+gradients done: local loss sum", torch.sum(losses))
            with torch.no_grad():
                ridx = self.chaos.regime_at(state.step) if self.chaos is not None else None
                rows, secure = self._perturb_local(self._send(state, rows), state.seed, state.step, state.carry,
                                                   ridx, state.ef if self.carries_ef else None)
                # the rows as they arrived, before the omniscient attack
                worker_nan = torch.any(~torch.isfinite(rows), dim=1) if self.health_probe else None
                if worker_nan is not None and self.nb_devices > 1:
                    worker_nan = self.axis.all_gather(worker_nan).reshape(self.nb_workers)  # worker-major
                key = gar_key(state.seed, state.step)
                if self.granularity == "leaf":
                    agg, participation, wdist, rep_dist = self._aggregate_per_leaf(
                        rows, flatmap, state.reputation, key, ridx)
                else:
                    agg, participation, wdist, rep_dist = self._aggregate_vector(rows, state.reputation, key, ridx)
                self._mark(state, "aggregate done: |agg|", torch.linalg.vector_norm(agg))
                tx.apply(state.params, flatmap.inflate(agg), state.opt_state)
                self._mark(state, "apply done: |p0|", torch.linalg.vector_norm(state.params[flatmap.slices[0][0]]))
                return self._finalize_step(state, losses, agg, worker_nan, participation, wdist, rep_dist, ridx,
                                           self._gather_secure(secure))

        return step

    def build_multi_step(self, loss_fn, tx, repeat_steps=None):
        """Build a K-step trainer: K steps of the step body in one call, with
        metrics per step (leading K).

        - ``repeat_steps=None``: ``multi(state, batches)`` with every batch
          leaf leading (K, n, ...) (``put_batches``): K distinct batches.
        - ``repeat_steps=K``: ``multi(state, batch)`` reuses one
          worker-major batch for K steps.
        """
        body = self.build_step(loss_fn, tx)

        def multi(state, batches):
            if repeat_steps is not None:
                return _run_steps(body, state, int(repeat_steps), lambda state, k: batches)
            count = next(iter(batches.values())).shape[0]
            return _run_steps(body, state, count, lambda state, k: {key: value[k] for key, value in batches.items()})

        return multi

    def _sample_indices(self, seed, step, nb_examples, batch_size):
        """(n, batch_size) int64 indices on the device: worker w's draw,
        uniform with replacement over ``nb_examples``, from the
        (seed, step, w, 4) stream."""

        def draw(generator):
            return {"index": torch.randint(0, nb_examples, (batch_size,), generator=generator)}

        return self._worker_draws(draw, seed, step, SAMPLE_TAG)["index"]

    def build_sampled_multi_step(self, loss_fn, tx, repeat_steps, batch_size):
        """Build a K-step trainer that draws fresh per-worker batches on the
        device each step from a resident dataset (JAX ``engine.py:1181``).

        Returns ``multi(state, data) -> (state, metrics)``, ``data`` the
        dataset (``replicate``).  Worker w's step-s draw is a function of
        (seed, s, w) alone, so a run gives the same batches however it is
        cut into chunks, and a resumed run needs no fast-forward; the
        in-step augmentation runs on the sampled batch as on a streamed one.
        """
        body = self.build_step(loss_fn, tx)
        nb_steps, batch_size = int(repeat_steps), int(batch_size)

        def multi(state, data):
            nb_examples = next(iter(data.values())).shape[0]

            def sampled(state, k):
                index = self._sample_indices(state.seed, state.step, nb_examples, batch_size)
                return {key: value[index] for key, value in data.items()}

            return _run_steps(body, state, nb_steps, sampled)

        return multi

    def build_gar_probe(self, d, seed=0):
        """The rule alone at the run's (n, d) (JAX ``_flat_build_gar_probe``):
        the instrument behind the runner's ``--gar-probe``.

        Synthetic (n, d) float32 rows are drawn once on the engine's device
        from a ``torch.Generator`` seeded with ``seed`` (``probe.rows``).
        At W > 1 every rank draws the same rows and keeps its column block
        (JAX shards the draw over the axis), so the probe runs the step's
        collectives too and returns the rank's aggregate block.
        ``probe(step)`` runs one aggregation on them: the distances (K1, or
        the centring and K2) when the rule needs them, clamped at 0, then
        the rule (K3-K6 for the coordinate rules, Bulyan's last phase, the
        meta-rules' passes) -- the step's own path, without attack, lossy
        link or quarantine.  ``step`` folds into the rule's key,
        ``gar_key(seed, step)``, so a randomized meta-rule re-draws as in
        training.  The caller synchronises before reading the clock."""
        generator = torch.Generator(device=self.device).manual_seed(int(seed))
        rows = torch.randn((self.nb_workers, int(d)), generator=generator, dtype=torch.float32, device=self.device)
        axis = self.axis if self.nb_devices > 1 else None  # JAX's axis_name=None at W = 1
        if axis is not None:
            # every rank draws the same rows and keeps its column block
            blk = -(-int(d) // self.nb_devices)
            rows = torch.nn.functional.pad(rows, (0, self.nb_devices * blk - int(d)))
            rows = rows[:, axis.rank * blk:(axis.rank + 1) * blk].contiguous()

        @torch.no_grad()
        def probe(step=0):
            return self.gar._call_aggregate(probe.rows, self._distances(probe.rows, axis), key=gar_key(seed, step),
                                            axis=axis)

        probe.rows = rows
        return probe

    # ------------------------------------------------------------------ #
    # bounded-wait (parallel/bounded.py): the step split into one submission
    # a worker and one aggregate over the rows that arrived

    def _check_bounded_wait_supported(self):
        """The bounded-wait builders' preconditions (JAX ``engine.py:2255-2290``
        for the flat mode), and one rank: the port's worker axis is W
        processes, and the protocol's submission threads poll one process's
        streams (the JAX runner refuses ``process_count() > 1``)."""
        if self.granularity != "vector":
            raise UserException("bounded-wait aggregates the whole flattened gradient (granularity vector); per-leaf "
                                "selection is not supported")
        if self.lossy_link is not None or self.chaos is not None:
            raise UserException("bounded-wait replaces the simulated transport: drop --UDP/--chaos in-graph regimes "
                                "(straggler regimes move to the host straggler model, parallel/bounded.py)")
        if self.nb_devices > 1:
            raise UserException("bounded-wait is single-process: its submission threads wait on one process's "
                                "streams, and a worker axis of %d ranks (--nb-devices) is %d processes; run "
                                "--nb-devices 1" % (self.nb_devices, self.nb_devices))

    def _augment_worker(self, worker_batch, seed, step, widx):
        """Worker ``widx``'s in-step augmentation alone, its draws from its
        (seed, step, widx, 3) stream: the rows of ``_augment``'s for that
        worker."""
        transform = self.batch_transform
        draws = transform.draw(worker_batch["image"].shape[0],
                               stream_generator(seed, step, widx, AUGMENT_TAG, "cpu"))
        return transform(worker_batch, {key: self._to_device(value) for key, value in draws.items()})

    def build_worker_grad(self, loss_fn):
        """One worker's submission (JAX ``build_worker_grad`` and
        ``_bounded_submission_body``, ``engine.py:2292-2400``):
        ``grad_fn(params, worker_batch, seed, step, widx, momentum=None,
        momentum_steps=0, ef=None) -> {loss, row[, momentum][, ef]}``.

        ``params`` are read and never written (the protocol hands it a copy
        of the round's parameters), ``worker_batch`` is the worker's own
        (no leading n).  In JAX's order: the in-step augmentation from the
        worker's (seed, step, widx, 3) stream; the loss and its gradient
        (``torch.autograd.grad``, not vmapped); the gradient flattened in JAX's coordinate order; under
        worker momentum the worker's new momentum row ``beta m[widx] + (1 -
        beta) g`` (returned as ``momentum``) divided by ``1 - beta^(
        momentum_steps + 1)``, the global count, in float32 on the host and
        a true division by a device tensor (trap m); the local attack on
        ``widx < r`` from the (seed, step, widx, 1) stream; then the wire:
        under a codec ``row`` is the encoded payload (with error feedback
        ``C(row + ef[widx])``, the new residual returned as ``ef``), else
        the row in the exchange dtype.  Under ``secure`` ``digest`` is the
        (4,) ``row_digest`` of the codec's decoded image, or of the row
        before the dtype's rounding.  ``momentum`` and ``ef`` are the
        whole (n, d) buffers of the state."""
        self._check_bounded_wait_supported()
        from ..secure.submit import row_digest

        beta = self.worker_momentum
        attack = self.attack if self.attack is not None and not self.attack.omniscient else None

        def grad_fn(params, worker_batch, seed, step, widx, momentum=None, momentum_steps=0, ef=None):
            if self.batch_transform is not None:
                worker_batch = self._augment_worker(worker_batch, seed, step, widx)
            # plain autograd on leaves of their own: one worker needs no
            # functorch transform, whose wrappers cost cnnet ~3 ms of host time
            # a worker on the H100 (8.5 against 5.5 ms,
            # scripts/torch_bounded_timing.py), time the submission threads
            # spend holding the GIL
            leaves = {name: value.detach().requires_grad_(True) for name, value in params.items()}
            with torch.enable_grad():
                loss = loss_fn(leaves, worker_batch)
                grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
            with torch.no_grad():
                row = FlatMap(params).flatten(grads)
                out = {"loss": loss.detach()}
                if beta is not None:
                    new_m = beta * momentum[widx] + (1.0 - beta) * row
                    out["momentum"] = new_m
                    row = new_m / bias_correction(beta, int(momentum_steps) + 1, row.device)
                if attack is not None and widx < self.nb_real_byz:
                    row = attack.apply_local(row, stream_generator(seed, step, widx, ATTACK_TAG, row.device))
                if self.codec is not None:
                    if ef is not None:
                        payload, image, out["ef"] = self.codec.ef_encode(row, ef[widx])
                    else:
                        payload = self.codec.encode(row)
                        image = self.codec.decode(payload, row.shape[-1]) if self.secure else None
                    if self.secure:
                        out["digest"] = row_digest(image)  # the wire image, what the aggregate decodes
                    out["row"] = payload
                    return out
                if self.secure:
                    out["digest"] = row_digest(row)  # before the dtype's rounding, as JAX's
                out["row"] = row if self.exchange_dtype is None else row.to(self.exchange_dtype)
                return out

        return grad_fn

    def build_bounded_aggregate(self, tx, params_template, rows_form="wire", stale_reweight=False):
        """The aggregator's side (JAX ``build_bounded_aggregate``,
        ``engine.py:2491-2671``): ``agg(state, rows, losses, arrived, stale,
        extras) -> (state, metrics)``, the state updated in place.

        ``rows`` is the (n, ...) stack of what crossed the wire
        (``rows_form="wire"``: the exchange dtype's rows, or the codec's
        stacked payloads, decoded here) or of rows decoded already
        (``"decoded"``, the incremental fold's buffer); ``losses`` (n,);
        ``arrived`` and ``stale`` (n,) bool on the device; ``extras`` the
        (n, d) ``momentum`` and ``ef`` rows the submissions returned,
        under ``stale_reweight`` the (n,) int ``stale_age`` and under
        ``secure`` the (n, 4) ``digests`` of what arrived (the drop row's,
        a stale carry's).  In JAX's
        order: decode; NaN where neither arrived nor stale; the dtype wire's
        image; each stale row scaled by ``c(a) = 1/(1 + a)`` (float32, a
        true division on the device); ``_prepare_rows`` (the omniscient
        attack and the quarantine); the distances and the rule with the
        step's GAR key; the update; the loss summed over the arrived
        workers; momentum and residual rows written back only where
        arrived (``momentum_steps`` + 1); ``_finalize_step``.  The metrics
        add ``straggler_timeout`` (~arrived), ``stale_infill``,
        ``nb_timeouts`` (NaN drops and stale rows alike: the f budget they
        spend), ``nb_stale``, reweighted ``stale_reweight_coeff`` and, under
        ``secure``, ``secure`` with the digests as sent and as received (no
        transform lies between) and no forged or rejected worker."""
        self._check_bounded_wait_supported()
        if rows_form not in ("wire", "decoded"):
            raise UserException("rows_form must be 'wire' or 'decoded' (got %r)" % (rows_form,))
        flatmap = FlatMap(params_template)
        d = flatmap.size
        if self.codec is not None:
            self.codec.validate_d(d)

        @torch.no_grad()
        def agg_fn(state, rows, losses, arrived, stale, extras):
            if rows_form == "wire" and self.codec is not None:
                rows = self.codec.decode(rows, d)
            else:
                rows = rows.to(torch.float32)
            # the deadline's verdict: a worker neither arrived nor stale is a
            # NaN row, as a fully lossy link's
            rows = torch.where((arrived | stale)[:, None], rows, torch.nan)
            if rows_form == "wire" and self.codec is None:
                rows = wire_roundtrip(rows, self.exchange_dtype)
            coeff = None
            if stale_reweight:
                ages = extras["stale_age"].to(torch.float32)
                ones = torch.ones_like(ages)
                coeff = torch.where(stale, ones / (1.0 + ages), ones)
                rows = rows * coeff[:, None]
            rows, raw_rows = self._prepare_rows(rows, state.reputation)
            agg, participation = self._aggregate_block(rows, gar_key(state.seed, state.step))
            agg = agg.to(torch.float32)
            tx.apply(state.params, flatmap.inflate(agg), state.opt_state)
            wdist, rep_dist = self._sq_dists(rows, raw_rows, agg)
            worker_nan = torch.any(~torch.isfinite(rows), dim=1) if self.health_probe else None
            if self.worker_momentum is not None:
                # a timed-out worker's momentum update never completed
                state.momentum = torch.where(arrived[:, None], extras["momentum"], state.momentum)
                state.momentum_steps += 1
            if self.carries_ef:
                state.ef = torch.where(arrived[:, None], extras["ef"], state.ef)
            secure = None
            if self.secure:
                nobody = torch.zeros(self.nb_workers, dtype=torch.bool, device=agg.device)
                secure = {"digest_sent": extras["digests"], "digest_recv": extras["digests"], "forged": nobody,
                          "rejected": nobody}
            state, metrics = self._finalize_step(state, torch.where(arrived, losses, 0.0), agg, worker_nan,
                                                 participation, wdist, rep_dist, secure=secure)
            metrics["straggler_timeout"] = ~arrived
            metrics["stale_infill"] = stale
            metrics["nb_timeouts"] = torch.sum(~arrived, dtype=torch.int32)
            metrics["nb_stale"] = torch.sum(stale, dtype=torch.int32)
            if coeff is not None:
                metrics["stale_reweight_coeff"] = coeff
            return state, metrics

        return agg_fn

    def build_incremental_fold(self, d):
        """The incremental fold (JAX ``engine.py:2673-2708``): ``(fold,
        fresh)``, ``fresh()`` a zeroed (n, d) float32 buffer on the device
        and ``fold(buffer, wire_row, widx)`` worker ``widx``'s row decoded
        into it in place (returned), as it lands; the aggregate then takes
        the buffer with ``rows_form="decoded"``.  A row is decoded alone as
        it is in the stack, so the bits are the stacked path's."""
        self._check_bounded_wait_supported()
        codec, n, device = self.codec, self.nb_workers, self.device
        if codec is not None:
            codec.validate_d(d)

        @torch.no_grad()
        def fold(buffer, wire_row, widx):
            buffer[widx] = codec.decode(wire_row, d) if codec is not None else wire_row.to(torch.float32)
            return buffer

        def fresh():
            return torch.zeros((n, d), dtype=torch.float32, device=device)

        return fold, fresh

    def build_eval_sums(self, metric_fn):
        """eval_step(state, batch) -> dict name -> (sum, count) over the batch:
        ``metric_fn`` vmapped over the k local workers, summed over them and
        (W > 1) across the ranks."""

        @torch.no_grad()
        def eval_step(state, batch):
            params = {name: value.detach() for name, value in state.params.items()}
            sums = vmap(metric_fn, in_dims=(None, 0))(params, batch)
            folded = {name: (torch.sum(total, dim=0), torch.sum(count, dim=0)) for name, (total, count) in sums.items()}
            if self.nb_devices > 1:
                names = sorted(folded)
                summed = self.axis.all_reduce_sum(torch.stack([
                    value.to(torch.float64) for name in names for value in folded[name]])).unbind(0)
                folded = {name: (summed[2 * i].to(folded[name][0].dtype), summed[2 * i + 1].to(folded[name][1].dtype))
                          for i, name in enumerate(names)}
            return folded

        return eval_step

    def build_eval(self, metric_fn):
        """Like ``build_eval_sums`` but divides, returning per-batch means."""
        eval_sums = self.build_eval_sums(metric_fn)

        def means(state, batch):
            folded = eval_sums(state, batch)
            return {name: total / torch.clamp(count, min=1) for name, (total, count) in folded.items()}

        return means


def _run_steps(body, state, count, batch_of):
    """Run ``body`` for ``count`` steps, step k on ``batch_of(state, k)``;
    the state and the per-step metrics stacked along a leading axis."""
    metrics = []
    for k in range(count):
        state, step_metrics = body(state, batch_of(state, k))
        metrics.append(step_metrics)
    return state, stack_metrics(metrics)
