"""The robust training engine: the flat dataflow over a worker axis, and
the sharded one over a (worker, pipe, model) grid.

Counterpart of ``aggregathor_tpu/parallel/engine.py``: the flat mode (its
dataflow, ``engine.py:1-31``) below, the sharded mode
(``sharding="sharded"``, JAX ``engine.py:1440-2170``) at the end: a
logical worker is a (pipe x model) submesh of ranks running a pipelined,
tensor-parallel replica (``models/transformer.py``), and the rule runs per
parameter bucket on the sharded gradients (``_sharded_build_step``).  The n logical workers lie over a
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
   not cross the wire again.  Bucketed (``leaf_bucketing``: True, or
   "auto" on a card, JAX ``engine.py:684-691``), the same-sized leaves go
   through one ``torch.func.vmap`` of steps 4-6
   (``_aggregate_per_leaf_bucketed``, JAX ``engine.py:694-797``): one rule
   call, one all_gather and one batched launch of each kernel a leaf
   size.  Under ``"vector"`` the (d,) aggregate crosses
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
aggregate's buffer as it lands).  It needs granularity ``vector`` and no
lossy link or chaos schedule in the step.  At W > 1 each rank runs the
submissions of its own k workers, and the aggregate takes the rank's k
rows with every worker's masks: the rows cross the reshard to column
blocks, the rule runs on its block with the distances completed across the
ranks, and the blocks' aggregates are gathered (``parallel/bounded.py``
agrees the masks).  The sharded mode's submission unit is a worker-axis
index, its k workers' whole rows at once (``build_group_grad`` at PP TP = 1,
``build_submesh_grad`` beyond, its collectives on groups of its own), and
its aggregate (granularity global) reshards the units' rows to column blocks
over every rank of the grid and updates each rank's own blocks.

Refused with a UserException: ``l1_regularize``/``l2_regularize`` on the
flat mode (the JAX flat engine refuses them too: its loss carries them;
the sharded mode applies them analytically).
"""

import numpy as np
import torch
from torch.func import grad_and_value, vmap

from ..core.flatten import FlatMap
from ..core.train_state import TrainState
from ..gars import GAR_KEY_TAG
from ..gars.common import LeafKeys, nonfinite_to_inf, smallest_k_mask
from ..guardian import probe as health
from ..ops import kernels
from ..utils import UserException, fold_in_seed, resolve_device
from ..gars import rule_kwargs
from ..gars.common import centered_gram_sq_distances, completed_distances
from .compress import parse_exchange_spec, wire_dtype, wire_roundtrip
from .lossy import LOSSY_TAG
from .mesh import WorkerAxis, make_mesh

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
#: the sharded mode's streams (trap c), apart from the flat mode's: JAX
#: keys the perturbation per (worker, leaf), ``fold_in(fold_in(key, w),
#: i)`` then tags 1 and 2, here (seed, step, w, ``leaf_tag(i, t)``); the
#: lateness one draw a worker (JAX 30_000 + w), the submission forgery's
#: verdicts and draws on JAX's 32_000 + w offsets, the impostor of leaf i on
#: 32_100 + i
LEAF_TAG_STRIDE = 100_000
SHARDED_LATE_TAG = 30_000
SHARDED_FORGE_TAG = 32_005
SHARDED_TAMPER_TAG = 32_006
SHARDED_TAMPER_COORD_TAG = 32_061
SHARDED_IMPOSTOR_TAG = 32_100
#: the in-group axes of the sharded mode (replication, the submesh psums)
IN_GROUP_AXES = ("pipe", "model")


def leaf_tag(i, tag):
    """The stream tag of leaf ``i``'s ``tag`` (1 attack, 2 link) in the
    sharded mode: ``LEAF_TAG_STRIDE (i + 1) + tag``, above every other tag."""
    return LEAF_TAG_STRIDE * (int(i) + 1) + int(tag)


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
    """The robust engine (see the module docstring).

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
      leaf_bucketing: under granularity "leaf", True runs one vmapped rule
        call per leaf size (the batched kernels), False the per-leaf loop,
        "auto" the first on a card and the second on the CPU.
      trace_ops: print a TRACE line after each phase of the step.
      health_probe: add ``metrics["probe"]`` (default on).
      flight: an ``obs.flight.FlightRecorder`` or None.
      secure: authenticated submission: digests of every row sent and
        received, a forged or tampered row NaN (``metrics["secure"]``).
      device: "cuda" (default) or "cpu"; CUDA without a GPU raises.
      sharding: "flat" or "sharded" (None: sharded when ``mesh`` is given);
        granularity then "layer" (default), "leaf" or "global", and
        ``l1_regularize``/``l2_regularize`` apply.
      axis: the ``parallel.mesh.WorkerAxis`` of a W-rank flat run (its
        device wins over ``device``); None: one rank.
      mesh: the ``parallel.mesh.DeviceGrid`` of a sharded run (None: the
        one-rank grid on ``device``).
    """

    def __init__(self, gar, nb_workers=None, nb_real_byz=0, attack=None, lossy_link=None,
                 exchange_dtype=None, worker_momentum=None, batch_transform=None, worker_metrics=False,
                 reputation_decay=None, quarantine_threshold=0.0, granularity=None, leaf_bucketing="auto",
                 trace_ops=False, health_probe=True, flight=None, l1_regularize=None, l2_regularize=None,
                 device="cuda", sharding=None, axis=None, chaos=None, exchange=None, secure=False, mesh=None,
                 **options):
        for name, value in options.items():
            if name not in UNPORTED_OPTIONS:
                raise TypeError("RobustEngine got an unexpected keyword argument %r" % name)
            if value not in (None, False, 0, 0.0):
                raise UserException("%s is not available in the PyTorch port yet" % name)
        # the mode: explicit wins; else a grid means the sharded mode
        if sharding is None:
            sharding = "sharded" if mesh is not None else "flat"
        if sharding not in ("flat", "sharded"):
            raise UserException("sharding must be 'flat' or 'sharded' (got %r)" % (sharding,))
        self.sharded = sharding == "sharded"
        if granularity is None:
            granularity = "layer" if self.sharded else "vector"
        if self.sharded:
            if granularity not in ("layer", "leaf", "global"):
                raise UserException("sharded granularity must be layer, leaf or global (got %r)" % (granularity,))
            if batch_transform is not None:
                raise UserException("batch_transform is a flat-engine feature (the sharded batches flow through "
                                    "the pipeline stages)")
            if trace_ops:
                raise UserException("trace_ops narrates the flat step body only; use --trace for a profiler window "
                                    "on the sharded engine")
            if axis is not None:
                raise UserException("the sharded engine takes its grid as mesh= (parallel.mesh.make_mesh), not a "
                                    "worker axis")
        else:
            if granularity not in ("vector", "leaf"):
                raise UserException(
                    "granularity must be vector or leaf (got %r); layer/global need the sharded mode "
                    "(sharding='sharded')" % (granularity,)
                )
            if mesh is not None:
                raise UserException("the flat engine takes its worker axis as axis=, not a grid (mesh=)")
            if l1_regularize or l2_regularize:
                raise UserException(
                    "the flat engine takes l1/l2 inside loss_fn (the per-worker loss is global there); "
                    "l1_regularize/l2_regularize are the sharded engine's analytic equivalent"
                )
        if leaf_bucketing != "auto" and not isinstance(leaf_bucketing, bool):
            raise UserException("leaf_bucketing must be 'auto' or a bool (got %r)" % (leaf_bucketing,))
        self.l1_regularize = float(l1_regularize) if l1_regularize else None
        self.l2_regularize = float(l2_regularize) if l2_regularize else None
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
            if self.sharded:
                raise UserException(
                    "--exchange %s needs the flat engine: the sharded dataflow's per-(worker, leaf) submissions "
                    "would need per-leaf codec/error-feedback state, a different protocol (bf16/f32 wire dtypes "
                    "work everywhere)" % self.codec.spec())
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
        if self.sharded:
            if granularity == "global" and (gar.uses_axis or gar.uses_key) and not gar.needs_distances:
                # the global path sums distances across the leaves; an
                # iterative rule would need its row norms summed so
                raise UserException("granularity:global is not supported for %s (whole-vector norms across leaves "
                                    "are not implemented); use granularity:layer" % type(gar).__name__)
            if gar.nb_workers != self.nb_workers:
                raise UserException("GAR was built for n=%d but the mesh worker axis is %d"
                                    % (gar.nb_workers, self.nb_workers))
            if mesh is None:
                mesh = make_mesh(1, 1, 1, device=device)
            if self.nb_workers % mesh.shape["worker"]:
                raise UserException("nb_workers (%d) must be a multiple of the worker mesh axis (%d)"
                                    % (self.nb_workers, mesh.shape["worker"]))
            axis = mesh.worker.with_workers(self.nb_workers)
        self.mesh = mesh
        if axis is None:
            axis = WorkerAxis(self.nb_workers, 1, 0, resolve_device(device))
        elif axis.nb_workers != self.nb_workers:
            raise UserException("the worker axis holds %d workers, the engine %d" % (axis.nb_workers, self.nb_workers))
        self.axis = axis
        self.device = axis.device
        # granularity:leaf runs bucketed where asked, and by default on a card
        # (JAX: on the accelerator, engine.py:684-691)
        self.leaf_bucketed = leaf_bucketing is True or (leaf_bucketing == "auto" and self.device.type == "cuda")
        self._bucket_layouts = {}
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

    def draw_forge(self, seed, step, worker, rate, tag=FORGE_TAG):
        """bool: does worker ``worker`` forge at ``step``?  The first uniform
        of its (seed, step, w, 5) stream below ``rate``, the same uniform
        the straggler lateness reads (trap s); the sharded mode passes its
        own ``tag``."""
        generator = stream_generator(seed, step, worker, tag, "cpu")
        return bool(torch.rand((), generator=generator) < rate)

    def draw_tamper(self, seed, step, worker, rate, tag=TAMPER_TAG):
        """bool: is worker ``worker``'s row tampered at ``step``?  The first
        uniform of its (seed, step, w, 6) stream below ``rate``."""
        generator = stream_generator(seed, step, worker, tag, "cpu")
        return bool(torch.rand((), generator=generator) < rate)

    def draw_tamper_coord(self, seed, step, worker, d, tag=TAMPER_COORD_TAG):
        """The coordinate a tamper flips, uniform in [0, d)."""
        generator = stream_generator(seed, step, worker, tag, "cpu")
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

    def _reshard_to_blocks(self, rows, axis=None, order=None):
        """(m, d) rows this rank sends -> the (n, blk) float32 column block
        of its coordinates, blk = ceil(d/R) over the R ranks of ``axis``
        (the worker axis, m = k, by default): the rows in the wire's dtype,
        zero-padded to R blk columns, through one ``all_to_all`` (JAX
        ``_reshard_to_blocks``, ``engine.py:604-617``).  ``order`` picks the
        n workers' rows, worker-major, out of the R m received ones (None:
        they are already)."""
        axis = self.axis if axis is None else axis
        R, m, d = axis.size, rows.shape[0], rows.shape[1]
        if self.exchange_dtype is not None:
            rows = rows.to(self.exchange_dtype)
        blk = -(-d // R)
        padded = torch.nn.functional.pad(rows, (0, R * blk - d))
        pieces = padded.view(m, R, blk).transpose(0, 1)  # (R, m, blk): piece i goes to rank i
        block = axis.all_to_all(pieces).reshape(R * m, blk)
        if order is not None:
            block = block.index_select(0, order)
        return block.to(torch.float32)

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

    def _flat_leaf_buckets(self, flatmap):
        """``(buckets, order)``: {leaf size: [(leaf index, offset), ...]} in
        flattening order, and the (d,) gather taking the buckets' stacked
        aggregates, concatenated, back to flattening order (cached a layout)."""
        layout = tuple((offset, size) for _, _, offset, size, _, _ in flatmap.slices)
        cached = self._bucket_layouts.get(layout)
        if cached is None:
            buckets = {}
            for i, (offset, size) in enumerate(layout):
                buckets.setdefault(size, []).append((i, offset))
            order = np.empty(sum(size for _, size in layout), np.int64)
            pos = 0
            for size, entries in buckets.items():
                for _, offset in entries:
                    order[offset:offset + size] = np.arange(pos, pos + size)
                    pos += size
            cached = self._bucket_layouts[layout] = (buckets, torch.from_numpy(order).to(self.device))
        return cached

    def _aggregate_per_leaf_bucketed(self, rows, flatmap, reputation, key=None, ridx=None):
        """granularity:leaf bucketed by leaf size (JAX ``_aggregate_per_leaf_
        bucketed``, ``engine.py:694-797``): the same-sized leaves, in
        flattening order, stacked into one (L, n, size) tensor through the
        wire (at W > 1 one ``all_gather`` a bucket, (W, L, k, size) to (L,
        n, size)), then one ``torch.func.vmap`` over the leaves of the
        preparation, the distances and the rule, so that each kernel runs
        its batched form once a bucket.  Leaf i's rule key is
        ``fold_in_seed(key, i)``, as in the loop, handed to the rule as the
        bucket's ``LeafKeys``: both paths make the same selections.  The
        participation is the mean over the leaves, the distances summed over
        them, and one gather puts the aggregates back in flattening order.
        Returns ``(agg, participation, wdist, rep_dist)``."""
        buckets, order = self._flat_leaf_buckets(flatmap)
        parts, sums = [], {}
        nb_parts = 0
        for size, entries in buckets.items():
            stack = torch.stack([rows[:, offset:offset + size] for _, offset in entries])  # (L, k, size)
            if self.exchange_dtype is not None:
                stack = stack.to(self.exchange_dtype)
            if self.nb_devices > 1:
                stack = self.axis.all_gather(stack).transpose(0, 1).reshape(len(entries), self.nb_workers, size)
            stack = stack.to(torch.float32)
            seeds = None if key is None else [fold_in_seed(key, i) for i, _ in entries]

            def per_leaf(leaf, index):
                leaf, raw_leaf = self._prepare_rows(leaf, reputation, ridx)
                agg_leaf, part = self._aggregate_block(leaf, None if seeds is None else LeafKeys(seeds, index))
                wdist, rep_dist = self._sq_dists(leaf, raw_leaf, agg_leaf)
                # vmap returns tensors only: the features that are off stay out
                named = {"participation": part, "wdist": wdist, "rep_dist": rep_dist}
                return agg_leaf, {name: value for name, value in named.items() if value is not None}

            # randomness "same": a rule's draws are keyed (LeafKeys draws each
            # leaf's on a generator of its own seed), none is the vmap's
            aggs, extras = vmap(per_leaf, randomness="same")(stack, torch.arange(len(entries), device=stack.device))
            parts.append(aggs.reshape(-1))
            for name, value in extras.items():
                total = torch.sum(value, dim=0)
                sums[name] = total if name not in sums else sums[name] + total
            nb_parts += len(entries)
        participation = sums.get("participation")
        if participation is not None:
            participation = participation / nb_parts
        return (torch.index_select(torch.cat(parts), 0, order), participation, sums.get("wdist"),
                sums.get("rep_dist"))

    def _flat_totals(self, losses, agg):
        """``(total_loss, update_norm)`` of the flat dataflow: the loss sum
        (summed across the ranks) and the norm of the (d,) aggregate."""
        total_loss = torch.sum(losses)
        if self.nb_devices > 1:
            total_loss = self.axis.all_reduce_sum(total_loss)
        # a cascaded sum of squares: torch's CPU vector_norm of a float32
        # vector of 11M coordinates errs by ~4e-4 relative
        return total_loss, torch.sqrt(torch.sum(torch.square(agg)))

    def _finalize_step(self, state, total_loss, update_norm, worker_nan, participation, wdist, rep_dist, ridx=None,
                       secure=None):
        """After the update, shared by the flat and the sharded dataflows
        (and bounded-wait's aggregate), which pass values already summed
        across their ranks: the reputation EMA, the probe, the metrics dict
        and the flight recorder's row; advances ``state.step``.  Returns
        ``(state, metrics)``."""
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
            metrics["chaos_regime"] = torch.full((), ridx, dtype=torch.int32, device=update_norm.device)
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

    def _flat_init_state(self, params, tx, seed=0):
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

    def _flat_build_step(self, loss_fn, tx):
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
                    per_leaf = (self._aggregate_per_leaf_bucketed if self.leaf_bucketed
                                else self._aggregate_per_leaf)
                    agg, participation, wdist, rep_dist = per_leaf(rows, flatmap, state.reputation, key, ridx)
                else:
                    agg, participation, wdist, rep_dist = self._aggregate_vector(rows, state.reputation, key, ridx)
                self._mark(state, "aggregate done: |agg|", torch.linalg.vector_norm(agg))
                tx.apply(state.params, flatmap.inflate(agg), state.opt_state)
                self._mark(state, "apply done: |p0|", torch.linalg.vector_norm(state.params[flatmap.slices[0][0]]))
                return self._finalize_step(state, *self._flat_totals(losses, agg), worker_nan, participation, wdist,
                                           rep_dist, ridx, self._gather_secure(secure))

        return step

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
        self._flat_only("build_sampled_multi_step")
        body = self._flat_build_step(loss_fn, tx)
        nb_steps, batch_size = int(repeat_steps), int(batch_size)

        def multi(state, data):
            nb_examples = next(iter(data.values())).shape[0]

            def sampled(state, k):
                index = self._sample_indices(state.seed, state.step, nb_examples, batch_size)
                return {key: value[index] for key, value in data.items()}

            return _run_steps(body, state, nb_steps, sampled)

        return multi

    def _flat_build_gar_probe(self, d, seed=0):
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

    def _check_bounded_wait_supported(self, allow_submesh=False):
        """The bounded-wait builders' preconditions (JAX ``engine.py:2255-2290``).
        Any worker axis: at W > 1 each rank's protocol runs its own k
        workers' submissions on its own threads and streams, and one gather
        a round agrees the verdicts (``parallel/bounded.py``).  The sharded
        mode's units are its worker-axis submeshes (``build_group_grad`` on
        a trivial in-group mesh, ``build_submesh_grad`` beyond)."""
        if self.sharded:
            if self.mesh.in_group_size != 1 and not allow_submesh:
                raise UserException("build_group_grad needs trivial in-group axes (--mesh W,1,1): a (pipe x model) "
                                    "submesh submission is one collective program whose members cannot time out "
                                    "independently — per-SUBMESH collective timeouts are build_submesh_grad's "
                                    "protocol (docs/engine.md, 'v3: submesh deadlines')")
            if self.granularity != "global":
                raise UserException("sharded bounded-wait aggregates the whole flattened gradient; use granularity "
                                    "global (the sharded spelling of the flat mode's vector)")
            if self.worker_momentum is not None:
                raise UserException("sharded bounded-wait does not carry worker momentum: the sharded "
                                    "TrainState.momentum is a per-leaf pytree, not the flat (n, d) buffer the "
                                    "submission body indexes — run the flat engine for momentum + bounded-wait")
        elif self.granularity != "vector":
            raise UserException("bounded-wait aggregates the whole flattened gradient (granularity vector); per-leaf "
                                "selection is not supported")
        if self.lossy_link is not None or self.chaos is not None:
            raise UserException("bounded-wait replaces the simulated transport: drop --UDP/--chaos in-graph regimes "
                                "(straggler regimes move to the host straggler model, parallel/bounded.py)")

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
        (no leading n), ``widx`` its global index (a worker of this rank).  In
        JAX's order: the in-step augmentation from the
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
        state's (k, d) buffers of this rank's workers.  A submission encodes
        its worker's whole (d,) row, so a codec's payload (int8's scale
        included) does not depend on W (ROADMAP trap az)."""
        self._check_bounded_wait_supported()
        from ..secure.submit import row_digest

        beta = self.worker_momentum
        attack = self.attack if self.attack is not None and not self.attack.omniscient else None
        first = self.axis.worker_index(0)

        def grad_fn(params, worker_batch, seed, step, widx, momentum=None, momentum_steps=0, ef=None):
            local = widx - first  # the worker's row in the rank's (k, d) buffers
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
                    new_m = beta * momentum[local] + (1.0 - beta) * row
                    out["momentum"] = new_m
                    row = new_m / bias_correction(beta, int(momentum_steps) + 1, row.device)
                if attack is not None and widx < self.nb_real_byz:
                    row = attack.apply_local(row, stream_generator(seed, step, widx, ATTACK_TAG, row.device))
                if self.codec is not None:
                    if ef is not None:
                        payload, image, out["ef"] = self.codec.ef_encode(row, ef[local])
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

    def build_group_grad(self, loss_fn):
        """The sharded mode's submission on a trivial in-group mesh (JAX
        ``build_group_grad``, ``engine.py:2402-2443``): one unit a worker-axis
        index, one rank, ``group_fn(params, group_batch, seed, step, gidx) ->
        {loss: (k,), row: (k, d)[, digest: (k, 4)]}``.

        ``loss_fn(params, batch, grid)`` is the sharded engine's local
        partial loss at one microbatch (at PP TP = 1 the worker's whole
        loss); ``group_batch`` the unit's (k, ...) batches, ``gidx`` its
        worker-axis index: its workers are gidx k + j, so the local attack
        and its streams address them as the flat mode does.  The k workers'
        full-batch gradients are one ``torch.func.vmap``, as the flat
        ``_worker_gradients``; each row is the whole flattened (d,) gradient
        in JAX's coordinate order, then, in JAX's order, the local attack
        on workers < r from the (seed, step, w, 1) stream, the digest of the
        whole row under ``secure`` and the exchange dtype.  There is no
        codec and no momentum (both refused on the sharded engine)."""
        self._check_bounded_wait_supported()
        if not self.sharded:
            raise UserException("build_group_grad is the sharded-mode submission builder (one unit a worker-axis "
                                "index); the flat engine dispatches build_worker_grad")
        return self._submission_unit(loss_fn, self.mesh)

    def build_submesh_grad(self, loss_fn):
        """The sharded mode's submission on a (pipe x model) submesh (JAX
        ``build_submesh_grad``, ``engine.py:2445-2490``): ``build_group_grad``'s
        contract, computed by the unit's PP TP ranks together.  Each of the
        k workers' full-batch gradients goes through ``loss_fn`` with its
        pipe ring and tensor-parallel collectives (at one microbatch GPipe
        is the full-batch forward), each leaf's gradient is summed over its
        replication axes inside the unit (trap ar), the worker's loss over
        the unit, and one ``all_gather`` over the unit gives every member
        the k whole rows in JAX's coordinate order (traps d and x): the
        digest and the aggregate take whole rows.

        Every collective of a submission runs on process groups of its own,
        made here on every rank in the same order
        (``mesh.submission_grid``, the function's ``grid``): a straggling
        unit may still be inside them when its round closes and the
        aggregate starts on the grid's groups (``parallel/bounded.py``)."""
        self._check_bounded_wait_supported(allow_submesh=True)
        if not self.sharded:
            raise UserException("build_submesh_grad is the sharded-mode submission builder (per-submesh collective "
                                "programs); the flat engine dispatches build_worker_grad")
        from .mesh import submission_grid

        return self._submission_unit(loss_fn, submission_grid(self.mesh))

    def _submission_unit(self, loss_fn, grid):
        """A worker-axis unit's submission on ``grid`` (the one-rank grid's
        own at PP TP = 1, the submission's groups beyond): the k workers'
        gradients and losses, completed inside the unit, as whole rows."""
        from ..secure.submit import row_digest

        k = self.workers_per_device
        attack = self.attack if self.attack is not None and not self.attack.omniscient else None

        def unit_fn(params, group_batch, seed, step, gidx):
            losses, grads = self._sharded_worker_gradients(params, group_batch, loss_fn, grid)
            with torch.no_grad():
                losses = grid.psum(losses, IN_GROUP_AXES)  # each worker's loss: its partials' sum
                grads = {name: grid.psum(grads[name], self._replication_axes(self._specs[name])) for name in grads}
                rows = self._whole_rows(grads, grid)
                if attack is not None:
                    for j in range(k):
                        widx = gidx * k + j
                        if widx < self.nb_real_byz:
                            rows[j] = attack.apply_local(rows[j], stream_generator(seed, step, widx, ATTACK_TAG,
                                                                                   rows.device))
                out = {"loss": losses}
                if self.secure:
                    out["digest"] = row_digest(rows)  # the whole rows, before the dtype's rounding
                out["row"] = rows if self.exchange_dtype is None else rows.to(self.exchange_dtype)
                return out

        unit_fn.grid = grid
        return unit_fn

    def _whole_rows(self, grads, grid):
        """The (k, d) float32 rows, whole and in JAX's coordinate order, of the
        unit's completed gradient blocks ``grads`` ({name: (k, *block)}): at
        PP TP = 1 the blocks are the leaves; beyond, one ``all_gather`` of
        the rank's blocks over the unit's ``grid.group``, each leaf's joined
        along the dims its spec shards."""
        layout = self._global_layout()
        if grid.in_group_size == 1:
            return layout.flatten_rows(grads)
        names = sorted(grads)
        k = grads[names[0]].shape[0]
        local = torch.cat([grads[name].reshape(k, -1).to(torch.float32) for name in names], dim=1)
        pp, tp = grid.shape["pipe"], grid.shape["model"]
        parts = grid.group.all_gather(local).reshape(pp, tp, k, -1)
        leaves, offset = {}, 0
        for name in names:
            block = tuple(grads[name].shape)
            size = grads[name][0].numel()
            piece = parts[..., offset:offset + size].reshape((pp, tp) + block)
            leaves[name] = self._join_blocks(piece, self._specs[name], lead=1)
            offset += size
        return layout.flatten_rows(leaves)

    def build_bounded_aggregate(self, tx, params_template, rows_form="wire", stale_reweight=False):
        """The aggregator's side (JAX ``build_bounded_aggregate``,
        ``engine.py:2491-2671``): ``agg(state, rows, losses, arrived, stale,
        extras) -> (state, metrics)``, the state updated in place.

        ``rows`` is the (k, ...) stack of what this rank's workers put on
        the wire (``rows_form="wire"``: the exchange dtype's rows, or the
        codec's stacked payloads, decoded here, on the owner) or of rows
        decoded already (``"decoded"``, the incremental fold's buffer);
        ``losses`` (k,); ``arrived`` and ``stale`` every worker's (n,) bool
        masks on the device, the same on every rank; ``extras`` the (k, d)
        ``momentum`` and ``ef`` rows the submissions returned, under
        ``stale_reweight`` the (n,) int ``stale_age`` and under ``secure``
        the (k, 4) ``digests`` of what arrived (the drop row's, a stale
        carry's).  At W = 1, k = n.  In JAX's order: decode; over R > 1
        ranks the reshard to the (n, ceil(d/R)) column block
        (``_reshard_to_blocks``, the wire's dtype; the rows are decoded
        first, so no block needs another's to decode); NaN where neither
        arrived nor stale; the dtype wire's image; each stale row scaled by
        ``c(a) = 1/(1 + a)`` (float32, a true division on the device);
        ``_prepare_rows`` (the omniscient attack and the quarantine); the
        distances (completed across the ranks) and the rule with the step's
        GAR key; the blocks' float32 aggregates gathered and cut to d; the
        update; the loss summed over the arrived workers (and the ranks);
        momentum and residual rows written back only where arrived
        (``momentum_steps`` + 1); ``_finalize_step``, the worker distances
        and NaN rows summed across the ranks and the digests gathered
        worker-major.  The metrics add ``straggler_timeout`` (~arrived),
        ``stale_infill``, ``nb_timeouts`` (NaN drops and stale rows alike:
        the f budget they spend), ``nb_stale``, reweighted
        ``stale_reweight_coeff`` and, under ``secure``, ``secure`` with the
        digests as sent and as received (no transform lies between) and no
        forged or rejected worker.

        On the flat engine the R ranks are the worker axis's W.  On the
        sharded engine (granularity global: the flat rule over the whole
        vector, JAX ``allow_submesh=True`` at ``engine.py:2539``) they are
        the grid's W PP TP: every member of a unit holds its k whole rows,
        and member q of the PP TP sends rows q m .. q m + m - 1 (m =
        ceil(k / (PP TP)), zero rows padding the last), so each row enters
        the reshard once; the aggregate is inflated to the global leaves and
        each rank updates its own (pipe, model) blocks."""
        self._check_bounded_wait_supported(allow_submesh=True)
        if rows_form not in ("wire", "decoded"):
            raise UserException("rows_form must be 'wire' or 'decoded' (got %r)" % (rows_form,))
        flatmap = FlatMap(params_template)
        d = flatmap.size
        if self.codec is not None:
            self.codec.validate_d(d)

        k = self.workers_per_device
        first = self.axis.worker_index(0)
        owned, order = slice(0, k), None
        if self.sharded:
            grid = self.mesh
            axis = grid.world if grid.size > 1 else None
            G, q = grid.in_group_size, grid.group.rank
            m = -(-k // G)
            owned = slice(min(k, q * m), min(k, (q + 1) * m))
            if k % G:
                # rank r = w G + q sent rows q m + i of unit w; keep the real ones
                order = torch.tensor([(w // k * G + w % k // m) * m + w % k % m for w in range(self.nb_workers)],
                                     device=self.device)
        else:
            axis = self.axis if self.nb_devices > 1 else None
            m = k

        def update(state, agg):
            if not self.sharded:
                tx.apply(state.params, flatmap.inflate(agg), state.opt_state)
                return
            leaves = self._global_layout().inflate(agg)
            tx.apply(state.params, {name: self._shard(leaves[name], self._specs[name]) for name in state.params},
                     state.opt_state)

        @torch.no_grad()
        def agg_fn(state, rows, losses, arrived, stale, extras):
            if rows_form == "wire" and self.codec is not None:
                rows = self.codec.decode(rows, d)
            else:
                rows = rows.to(torch.float32)
            if axis is not None:
                mine = rows[owned]
                if mine.shape[0] < m:
                    mine = torch.nn.functional.pad(mine, (0, 0, 0, m - mine.shape[0]))
                rows = self._reshard_to_blocks(mine, axis, order)
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
            agg, participation = self._aggregate_block(rows, gar_key(state.seed, state.step), axis)
            agg = block = agg.to(torch.float32)
            if axis is not None:
                agg = axis.all_gather(block).reshape(-1)[:d]
            update(state, agg)
            wdist, rep_dist = self._sq_dists(rows, raw_rows, block)
            worker_nan = torch.any(~torch.isfinite(rows), dim=1) if self.health_probe else None
            if axis is not None:
                # the blocks' distances and NaN rows summed across the ranks,
                # in one collective
                nans = None if worker_nan is None else worker_nan.to(torch.float32)
                present = [value for value in (wdist, rep_dist, nans) if value is not None]
                if present:
                    summed = iter(axis.all_reduce_sum(torch.stack(present)).unbind(0))
                    wdist = None if wdist is None else next(summed)
                    rep_dist = None if rep_dist is None else next(summed)
                    worker_nan = None if worker_nan is None else next(summed) > 0
            mine = arrived[first:first + k]  # this rank's workers
            if self.worker_momentum is not None:
                # a timed-out worker's momentum update never completed
                state.momentum = torch.where(mine[:, None], extras["momentum"], state.momentum)
                state.momentum_steps += 1
            if self.carries_ef:
                state.ef = torch.where(mine[:, None], extras["ef"], state.ef)
            secure = None
            if self.secure:
                nobody = torch.zeros(self.nb_workers, dtype=torch.bool, device=agg.device)
                digests = self._gather_secure({"digests": extras["digests"]})["digests"]
                secure = {"digest_sent": digests, "digest_recv": digests, "forged": nobody, "rejected": nobody}
            state, metrics = self._finalize_step(state, *self._flat_totals(torch.where(mine, losses, 0.0), agg),
                                                 worker_nan, participation, wdist, rep_dist, secure=secure)
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
        fresh)``, ``fresh()`` a zeroed (k, d) float32 buffer of this rank's
        workers on the device and ``fold(buffer, wire_row, j)`` local worker
        ``j``'s row decoded into it in place (returned), as it lands; the
        aggregate then takes the buffer with ``rows_form="decoded"`` (at
        W > 1 it reshards at the barrier).  A row is decoded alone as it is
        in the stack, so the bits are the stacked path's."""
        self._check_bounded_wait_supported()
        codec, k, device = self.codec, self.workers_per_device, self.device
        if codec is not None:
            codec.validate_d(d)

        @torch.no_grad()
        def fold(buffer, wire_row, j):
            buffer[j] = codec.decode(wire_row, d) if codec is not None else wire_row.to(torch.float32)
            return buffer

        def fresh():
            return torch.zeros((k, d), dtype=torch.float32, device=device)

        return fold, fresh

    def build_eval_sums(self, metric_fn):
        """eval_step(state, batch) -> dict name -> (sum, count) over the batch:
        ``metric_fn`` vmapped over the k local workers, summed over them and
        (W > 1) across the ranks."""
        self._flat_only("build_eval_sums")

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

    def _flat_build_eval(self, metric_fn):
        """Like ``build_eval_sums`` but divides, returning per-batch means."""
        eval_sums = self.build_eval_sums(metric_fn)

        def means(state, batch):
            folded = eval_sums(state, batch)
            return {name: total / torch.clamp(count, min=1) for name, (total, count) in folded.items()}

        return means

    # ------------------------------------------------------------------ #
    # the public surface, one for both modes (JAX engine.py:2168-2247)

    def _flat_only(self, name):
        if self.sharded:
            raise UserException("%s is a flat-engine builder; the sharded engine has build_step, build_multi_step "
                                "and build_eval" % name)

    def init_state(self, *args, **kwargs):
        """The TrainState of this engine's mode: flat ``init_state(params,
        tx, seed=0)``; sharded ``init_state(init_fn, specs, tx, seed=0)``."""
        if self.sharded:
            return self._sharded_init_state(*args, **kwargs)
        return self._flat_init_state(*args, **kwargs)

    def build_step(self, loss_fn, tx):
        """The robust training step of the engine's mode."""
        if self.sharded:
            return self._sharded_build_step(loss_fn, tx)
        return self._flat_build_step(loss_fn, tx)

    def build_multi_step(self, loss_fn, tx, repeat_steps=None):
        """Build a K-step trainer: K steps of the mode's step body in one
        call, with metrics per step (leading K).

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

    def build_eval(self, fn):
        """flat: ``build_eval(metric_fn)`` -> per-batch means; sharded:
        ``build_eval(loss_fn)`` -> the mean sharded loss."""
        if self.sharded:
            return self._sharded_build_eval(fn)
        return self._flat_build_eval(fn)

    def build_gar_probe(self, d, seed=0):
        """The rule alone at the engine's (n, d) (``--gar-probe``)."""
        if self.sharded:
            return self._sharded_build_gar_probe(d, seed=seed)
        return self._flat_build_gar_probe(d, seed=seed)

    # ------------------------------------------------------------------ #
    # the sharded dataflow (logical worker = a (pipe x model) submesh),
    # JAX engine.py:1440-2166

    def _spec_names(self, spec):
        return {entry for entry in spec or () if entry is not None}

    def _replication_axes(self, spec):
        """The in-group axes over which a leaf with this spec is replicated."""
        names = self._spec_names(spec)
        return tuple(a for a in IN_GROUP_AXES if a not in names)

    def _replication_scale(self, spec):
        scale = 1.0
        for a in self._replication_axes(spec):
            scale /= self.mesh.shape[a]
        return scale

    def replication_scale(self, name):
        """1 / (the size of the in-group axes that replicate leaf ``name``):
        a rank's share of a term over that leaf, so that the submesh's sum
        counts it once."""
        return self._replication_scale(self._specs[name])

    def _shard(self, value, spec):
        """This rank's block of a global leaf: each dim named by ``spec``
        cut into the axis's size, block ``coord``."""
        for dim, name in enumerate(spec or ()):
            if name is None:
                continue
            size, index = self.mesh.shape[name], self.mesh.axis(name).rank
            if value.shape[dim] % size:
                raise UserException("leaf dim %d of size %d does not divide over the %s axis of size %d"
                                    % (dim, value.shape[dim], name, size))
            block = value.shape[dim] // size
            value = value.narrow(dim, index * block, block)
        return value

    def _unshard(self, value, spec):
        """The global leaf of this rank's block (a collective over the
        worker's (pipe, model) submesh: every rank calls it)."""
        group = self.mesh.group
        if group.size == 1:
            return value
        pp, tp = self.mesh.shape["pipe"], self.mesh.shape["model"]
        return self._join_blocks(group.all_gather(value).reshape((pp, tp) + tuple(value.shape)), spec)

    @staticmethod
    def _join_blocks(parts, spec, lead=0):
        """The global leaf of a submesh's (PP, TP, *block) blocks: joined
        along the dims ``spec`` shards (the block's dims after ``lead``
        leading ones), one copy where it replicates."""
        spec = tuple(spec or ())
        rows = [torch.cat(row.unbind(0), dim=lead + spec.index("model")) if "model" in spec else row[0]
                for row in parts.unbind(0)]
        return torch.cat(rows, dim=lead + spec.index("pipe")) if "pipe" in spec else rows[0]

    def _global_layout(self):
        """The ``FlatMap`` of the global parameters (JAX's coordinate order of
        a whole row), from the shapes ``init_state`` recorded."""
        if getattr(self, "_global_flatmap", None) is None:
            if getattr(self, "_global_shapes", None) is None:
                raise UserException("the sharded engine's row layout is the global parameters': call init_state "
                                    "before the first bounded-wait round")
            self._global_flatmap = FlatMap({name: torch.empty(shape, device="meta")
                                            for name, shape in self._global_shapes.items()})
        return self._global_flatmap

    def _map_state_leaves(self, tree, fn):
        """``fn(tensor, spec)`` over the params-shaped dicts of a params or
        optimizer-state tree (other leaves as they are)."""
        if isinstance(tree, dict) and tree and set(tree) <= set(self._specs) and all(
                isinstance(v, torch.Tensor) for v in tree.values()):
            return {name: fn(value, self._specs[name]) for name, value in tree.items()}
        if isinstance(tree, dict):
            return {key: self._map_state_leaves(value, fn) for key, value in tree.items()}
        return tree

    def _sharded_init_state(self, init_fn, specs, tx, seed=0):
        """The sharded TrainState (JAX ``_sharded_init_state``).

        ``init_fn(seed)`` builds the global parameter dict (on the CPU, the
        same on every rank; e.g. ``transformer.init_params``), ``specs``
        its axis names a dim (``transformer.param_specs``).  Each rank keeps
        its (pipe, model) block of every leaf, on its device; the optimizer
        state is built on those blocks (the rules are elementwise, so it is
        the block of the global state); the momentum and the carry are
        per-leaf (k, *block) buffers of the rank's k workers."""
        global_params = init_fn(int(seed))
        self._specs = {name: tuple(specs[name]) for name in global_params}
        self._global_shapes = {name: tuple(value.shape) for name, value in global_params.items()}
        self._global_flatmap = None
        self.model_dim = sum(value.numel() for value in global_params.values())
        params = {name: self._shard(value, self._specs[name]).detach().to(self.device, torch.float32).clone()
                  .requires_grad_(True) for name, value in global_params.items()}
        state = TrainState(params=params, opt_state=tx.init(params), step=0, seed=int(seed))
        k = self.workers_per_device

        def per_worker_zeros():
            return {name: torch.zeros((k,) + tuple(p.shape), dtype=torch.float32, device=self.device)
                    for name, p in params.items()}

        if self.worker_momentum is not None:
            state.momentum = per_worker_zeros()
        if self.carries_gradients:
            state.carry = per_worker_zeros()
        if self.reputation_decay is not None:
            state.reputation = torch.ones(self.nb_workers, dtype=torch.float32, device=self.device)
        if self.health_probe:
            state.loss_ema = torch.full((), health.EMA_UNSET, dtype=torch.float32, device=self.device)
        if self.flight is not None:
            state.flight = self.flight.init_buffers(self.device)
        return state

    def global_state(self, state):
        """The global parameters and optimizer state of a sharded ``state``
        (blocks gathered over each worker's submesh), with its step and
        seed, as a TrainState on the device: what a checkpoint saves and a
        restore loads into (``put_state``).  A collective: every rank calls
        it.  The flat mode's state is global already."""
        if not self.sharded:
            return state
        with torch.no_grad():
            params = self._map_state_leaves(state.params, self._unshard)
            opt_state = self._map_state_leaves(state.opt_state, self._unshard)
        return TrainState(params=params, opt_state=opt_state, step=int(state.step), seed=int(state.seed))

    def put_state(self, state, global_state):
        """Load a global state (``global_state``'s layout, e.g. restored from
        a checkpoint) into the live sharded ``state`` in place: each rank
        its blocks, the step and the seed; the side buffers reset as a
        restore resets them.  Returns ``state``."""
        from ..core.train_state import _reset_side_buffers

        with torch.no_grad():
            for tree, saved in ((state.params, global_state.params), (state.opt_state, global_state.opt_state)):
                blocks = self._map_state_leaves(saved, self._shard)

                def load(live, new):
                    for key, value in new.items():
                        if isinstance(value, dict):
                            load(live[key], value)
                        elif isinstance(value, torch.Tensor):
                            live[key].copy_(value)
                        else:
                            live[key] = value

                load(tree, blocks)
            _reset_side_buffers(state)
        state.step, state.seed = int(global_state.step), int(global_state.seed)
        return state

    def _sharded_worker_gradients(self, params, batch, loss_fn, grid=None):
        """((k,) local partial losses, {name: (k, *block) gradient}) of the
        rank's k workers, the loss's collectives on ``grid`` (the engine's
        by default).  At PP TP = 1 the loss calls no collective and
        the k workers run as one ``torch.func.vmap`` of ``grad_and_value``,
        as the flat engine's; beyond, the loss calls collectives, which
        cannot run under a vmap, and the k workers run as a loop of k
        forward and backward passes (JAX's k = 1 path has no vmap either).
        A leaf a rank's loss does not reach (``embed`` off stage 0) gets a
        zero gradient: the psum over its replication axes completes it."""
        grid = self.mesh if grid is None else grid
        names = list(params)
        detached = {name: value.detach() for name, value in params.items()}
        if grid.in_group_size == 1:
            grads, losses = vmap(grad_and_value(lambda p, b: loss_fn(p, b, grid)), in_dims=(None, 0))(detached, batch)
            return losses.detach(), {name: grads[name] for name in names}
        losses, rows = [], {name: [] for name in names}
        for j in range(self.workers_per_device):
            leaves = {name: value.detach().requires_grad_(True) for name, value in detached.items()}
            with torch.enable_grad():
                loss = loss_fn(leaves, {key: value[j] for key, value in batch.items()}, grid)
                # backward(), not autograd.grad(inputs=): every collective's
                # backward must run (parallel/collectives.py)
                loss.backward()
            losses.append(loss.detach())
            for name in names:
                grad = leaves[name].grad
                rows[name].append(torch.zeros_like(leaves[name]) if grad is None else grad)
        return torch.stack(losses), {name: torch.stack(value) for name, value in rows.items()}

    def _sharded_perturb(self, g, i, widx, seed, step, previous=None, ridx=None, late=None):
        """Worker ``widx``'s leaf ``i`` block (JAX ``_perturb``): the local
        attacks (on w < r), the lossy link, the regime's drop storm and its
        stragglers, each leaf on its own (seed, step, w, leaf_tag(i, t))
        streams.  Returns the block as it arrived."""
        flat = g.reshape(-1)
        prev = previous.reshape(-1) if previous is not None else None
        chaos = self.chaos
        if widx < self.nb_real_byz:
            if self.attack is not None and not self.attack.omniscient:
                flat = self.attack.apply_local(flat, stream_generator(seed, step, widx, leaf_tag(i, ATTACK_TAG),
                                                                      self.device))
            if chaos is not None and chaos.has_local_attacks:
                flat = chaos.apply_local_attacks(ridx, flat, stream_generator(seed, step, widx,
                                                                              leaf_tag(i, ATTACK_TAG), self.device))
        d = flat.shape[0]
        link = self.lossy_link
        if link is not None:
            drops = link.draw_drops(d, seed, step, widx, tag=leaf_tag(i, LOSSY_TAG))
            flat = link.apply_rows(flat[None], [widx], drops[None],
                                   previous=None if prev is None else prev[None])[0]
        if chaos is not None and chaos.drop_rate(ridx) > 0:
            drops = chaos.link.draw_drops(d, seed, step, widx, drop_rate=chaos.drop_rate(ridx),
                                          tag=leaf_tag(i, LOSSY_TAG))
            flat = chaos.link.apply_rows(flat[None], [widx], drops[None])[0]
        if late is not None:
            flat = chaos.stragglers.apply(flat, late, chaos.straggler_stale(ridx), previous=prev)
        return flat.reshape(g.shape)

    def _sharded_submission(self, g_leaves, seed, step, ridx):
        """The submission forgery on the sharded leaves (JAX
        ``_submission_pipeline``): under the regime's ``forge`` rate every
        leaf of a coalition worker is replaced by impostor noise; under
        ``secure`` the sender's digest is the sum mod 2^32 of the leaves'
        ``row_digest``, leaf i salted ``i * 0x9E3779B1``; ``tamper`` flips a
        bit of the first leaf after signing; the receiver's digest follows
        and a rejected worker's every leaf reads NaN.  Returns ``(g_leaves,
        secure_local)``, the rank's (k, 4) digest sums (this submesh's
        blocks only) and (k,) verdicts, or None unless ``secure``."""
        chaos = self.chaos
        forgery = chaos is not None and chaos.has_forgery
        if not (self.secure or forgery):
            return g_leaves, None
        from ..secure.submit import FORGE_SCALE, DIGEST_LANES, row_digest, tamper_row

        k = self.workers_per_device
        forge_rate = chaos.forge_rate(ridx) if forgery else 0.0
        tamper_rate = chaos.tamper_rate(ridx) if forgery else 0.0
        g_leaves = [g.clone() for g in g_leaves]
        sent = torch.zeros((k, DIGEST_LANES), dtype=torch.int64, device=self.device)
        recv = torch.zeros_like(sent)
        forged, rejected = np.zeros(k, bool), np.zeros(k, bool)
        for j in range(k):
            widx = self.axis.worker_index(j)
            is_forge = forgery and widx < self.nb_real_byz and forge_rate > 0 and self.draw_forge(
                seed, step, widx, forge_rate, tag=SHARDED_FORGE_TAG)
            is_tamper = forgery and widx < self.nb_real_byz and tamper_rate > 0 and self.draw_tamper(
                seed, step, widx, tamper_rate, tag=SHARDED_TAMPER_TAG)
            forged[j], rejected[j] = is_forge, is_forge or is_tamper
            for i, g in enumerate(g_leaves):
                flat = g[j].reshape(-1).to(torch.float32)
                if is_forge:
                    generator = stream_generator(seed, step, widx, SHARDED_IMPOSTOR_TAG + i, self.device)
                    flat = torch.randn(flat.shape[0], generator=generator, dtype=torch.float32,
                                       device=self.device) * FORGE_SCALE
                digest = None
                if self.secure:
                    digest = row_digest(flat, salt=i * 0x9E3779B1).to(torch.int64)
                    sent[j] += digest
                if is_tamper and i == 0:
                    flat = tamper_row(flat, self.draw_tamper_coord(seed, step, widx, flat.shape[0],
                                                                   tag=SHARDED_TAMPER_COORD_TAG))
                    if self.secure:
                        digest = row_digest(flat, salt=0).to(torch.int64)
                if self.secure:
                    recv[j] += digest
                    if rejected[j]:
                        flat = torch.full_like(flat, float("nan"))
                g[j] = flat.reshape(g[j].shape).to(g.dtype)
        if not self.secure:
            return g_leaves, None
        flags = self._to_device(torch.from_numpy(np.stack([forged, rejected])))
        return g_leaves, {"digest_sent": sent & 0xFFFFFFFF, "digest_recv": recv & 0xFFFFFFFF,
                          "forged": flags[0], "rejected": flags[1]}

    def _leaf_buckets(self, g, spec):
        """A locally worker-stacked (k, ...) leaf as (k, n_buckets,
        d_bucket): under ``layer`` a stage-stacked leaf has one bucket a
        layer, every other leaf one bucket."""
        k = g.shape[0]
        if self.granularity == "layer" and spec is not None and len(spec) >= 2 and spec[0] == "pipe":
            return g.reshape(k, g.shape[1] * g.shape[2], -1)
        return g.reshape(k, 1, -1)

    def _gather_rows(self, buckets):
        """(k, Lb, d) local buckets -> (Lb, n, d) float32 rows of every
        worker: one all_gather over the worker axis, in the wire's dtype,
        worker-major (global worker = group k + local slot)."""
        if self.exchange_dtype is not None:
            buckets = buckets.to(self.exchange_dtype)
        if self.nb_devices > 1:
            buckets = self.axis.all_gather(buckets)  # (W, k, Lb, d)
        rows = buckets.to(torch.float32).reshape((self.nb_workers,) + tuple(buckets.shape[-2:]))
        return rows.transpose(0, 1).contiguous()

    def _apply_omniscient(self, rows, ridx=None):
        """The coalition's attacks on each (n, d) bucket; the forged rows
        cross the wire again (the ported omniscient attacks draw nothing,
        so no stream)."""
        byz_mask = torch.arange(self.nb_workers, device=rows.device) < self.nb_real_byz
        forged = False
        if self.attack is not None and self.attack.omniscient:
            rows = torch.stack([self.attack.apply_matrix(bucket, byz_mask) for bucket in rows])
            forged = True
        if self.chaos is not None and self.chaos.has_omniscient_attacks:
            rows = torch.stack([self.chaos.apply_omniscient_attacks(ridx, bucket, byz_mask) for bucket in rows])
            forged = True
        if forged:
            rows = wire_roundtrip(rows, self.exchange_dtype)
        return rows

    def _bucket_distances(self, bucket, spec):
        """One bucket's (n, n) distances: the centring and K2 (the centred
        Gram form JAX computes in jnp), summed over the model axis when the
        leaf's coordinates are sharded across it, clamped at 0.  The port's
        Gram form clamps each block's partial at 0 before that sum."""
        partial = centered_gram_sq_distances(bucket)
        if "model" in self._spec_names(spec):
            partial = self.mesh.psum(partial, ("model",))
        return torch.clamp_min(partial, 0.0)

    def _sharded_build_step(self, loss_fn, tx):
        """The sharded step (JAX ``_make_sharded_body``, ``engine.py:1721-2022``):
        ``step(state, batch)``, ``batch`` the rank's k workers' (k, B, S)
        batch (``put_batch``), ``loss_fn(params, batch, grid)`` the local
        partial loss (``transformer.make_pipeline_loss``).

        1. the k workers' local losses and gradients
           (``_sharded_worker_gradients``);
        2. each leaf's gradient summed over its replication axes (the
           in-group axes its spec does not name), then l1/l2 analytically,
           ``l1 sign(p) + 2 l2 p`` on the completed gradient, the norm
           scaled by 1/(replication) added to every worker's loss;
        3. worker momentum (bias-corrected, per leaf);
        4. the per-(worker, leaf) perturbation and the submission forgery;
        5. per leaf: the buckets (``_leaf_buckets``), gathered over the
           worker axis (``_gather_rows``), the omniscient attack, the
           quarantine (before any distance), then per bucket the rule: its
           distances (``_bucket_distances``: the centring and K2, a launch
           each a bucket; under ``global`` one accumulation over the
           leaves, each scaled by 1/(replication), summed over the
           submesh), an iterative rule completing its norms over the model
           axis when the leaf is sharded there, a randomized one keyed by
           the step's ``gar_key``; the buckets loop, one rule call a
           bucket (the batched kernels of the flat leaf path could serve
           it: ROADMAP queue 2 item 2);
        6. the optimizer on each rank's blocks; the grad norm, the loss
           sum, the reputation, worker distance and participation
           accumulators scaled by 1/(replication) and summed over the
           submesh (JAX's scales); the probe's NaN rows and the secure
           lanes gathered worker-major; ``_finalize_step``."""
        gar, grid = self.gar, self.mesh
        k = self.workers_per_device

        def step(state, batch):
            names = sorted(state.params)
            specs = [self._specs[name] for name in names]
            seed, stepno = state.seed, state.step
            chaos = self.chaos
            ridx = chaos.regime_at(stepno) if chaos is not None else None
            lates = [None] * k
            if chaos is not None and chaos.straggler_rate(ridx) > 0:
                rate = chaos.straggler_rate(ridx)
                # one lateness draw a worker, for all its leaves
                lates = [chaos.stragglers.draw_late(seed, stepno, self.axis.worker_index(j), rate, tag=SHARDED_LATE_TAG)
                         for j in range(k)]
            losses, grads = self._sharded_worker_gradients(state.params, batch, loss_fn)
            with torch.no_grad():
                g_leaves = [grid.psum(grads[name], self._replication_axes(spec)) for name, spec in zip(names, specs)]
                l1, l2 = self.l1_regularize, self.l2_regularize
                if l1 or l2:
                    reg = torch.zeros((), dtype=torch.float32, device=self.device)
                    for i, (name, spec) in enumerate(zip(names, specs)):
                        p32 = state.params[name].detach().to(torch.float32)
                        delta = torch.zeros_like(p32)
                        if l1:
                            delta = delta + l1 * torch.sign(p32)
                            reg = reg + l1 * torch.sum(torch.abs(p32)) * self._replication_scale(spec)
                        if l2:
                            delta = delta + 2.0 * l2 * p32
                            reg = reg + l2 * torch.sum(p32 * p32) * self._replication_scale(spec)
                        g_leaves[i] = g_leaves[i] + delta.to(g_leaves[i].dtype)
                    losses = losses + reg
                if self.worker_momentum is not None:
                    beta = self.worker_momentum
                    state.momentum_steps += 1
                    correction = bias_correction(beta, state.momentum_steps, self.device)
                    for i, name in enumerate(names):
                        state.momentum[name] = beta * state.momentum[name] + (1.0 - beta) * g_leaves[i]
                        g_leaves[i] = state.momentum[name] / correction
                if self.attack is not None or self.lossy_link is not None or chaos is not None:
                    for i, name in enumerate(names):
                        g = g_leaves[i]
                        outs = []
                        for j in range(k):
                            previous = state.carry[name][j] if state.carry is not None else None
                            outs.append(self._sharded_perturb(g[j], i, self.axis.worker_index(j), seed, stepno,
                                                              previous, ridx, lates[j]))
                        g_leaves[i] = torch.stack(outs)
                        if state.carry is not None:
                            state.carry[name] = g_leaves[i].clone()
                g_leaves, secure_local = self._sharded_submission(g_leaves, seed, stepno, ridx)

                all_rows = [self._apply_omniscient(self._gather_rows(self._leaf_buckets(g, spec)), ridx)
                            for g, spec in zip(g_leaves, specs)]
                raw_all_rows = all_rows
                if self.quarantine_threshold:
                    masked = quarantine_mask(state.reputation, self.quarantine_threshold, gar.nb_byz_workers)
                    all_rows = [torch.where(masked[None, :, None], torch.nan, rows) for rows in all_rows]
                global_dist2 = None
                if self.granularity == "global" and gar.needs_distances:
                    acc = torch.zeros((self.nb_workers, self.nb_workers), dtype=torch.float32, device=self.device)
                    for rows, spec in zip(all_rows, specs):
                        acc = acc + centered_gram_sq_distances(rows.reshape(self.nb_workers, -1)) * \
                            self._replication_scale(spec)
                    global_dist2 = torch.clamp_min(grid.psum(acc, IN_GROUP_AXES), 0.0)
                key = gar_key(seed, stepno)
                n = self.nb_workers
                wdist = torch.zeros(n, dtype=torch.float32, device=self.device)
                rep_dist = torch.zeros(n, dtype=torch.float32, device=self.device)
                part_sum = torch.zeros(n, dtype=torch.float32, device=self.device)
                part_count = 0.0
                agg_leaves = {}
                for name, rows, raw_rows, g, spec in zip(names, all_rows, raw_all_rows, g_leaves, specs):
                    axis = grid.model if "model" in self._spec_names(spec) and grid.model.size > 1 else None
                    aggs, parts = [], []
                    for b in range(rows.shape[0]):
                        bucket = rows[b]
                        if gar.needs_distances:
                            dist2 = global_dist2 if global_dist2 is not None else self._bucket_distances(bucket, spec)
                            if self.worker_metrics:
                                agg, part = gar.aggregate_block_and_participation(bucket, dist2)
                            else:
                                agg, part = gar.aggregate_block(bucket, dist2), None
                        elif gar.uses_axis or gar.uses_key:
                            if self.worker_metrics:
                                agg, part = gar.aggregate_block_and_participation(
                                    bucket, None, **rule_kwargs(gar, key, axis))
                            else:
                                agg, part = gar._call_aggregate(bucket, None, key=key, axis=axis), None
                        else:
                            agg, part = gar.aggregate_block(bucket, None), None
                        aggs.append(agg.to(torch.float32))
                        parts.append(part)
                    agg = torch.stack(aggs)  # (Lb, d_b)
                    scale = self._replication_scale(spec)
                    if self.reputation_decay is not None:
                        rdiff = raw_rows - agg[:, None, :]
                        rep_dist = rep_dist + torch.sum(rdiff * rdiff, dim=(0, 2)) * scale
                    if self.worker_metrics:
                        diff = rows - agg[:, None, :]
                        wdist = wdist + torch.sum(diff * diff, dim=(0, 2)) * scale
                        if parts[0] is not None:
                            stacked = self.granularity == "layer" and len(spec) >= 2 and spec[0] == "pipe"
                            pscale = 1.0 / grid.shape["model"] / (1 if stacked else grid.shape["pipe"])
                            part_sum = part_sum + torch.sum(torch.stack(parts), dim=0) * pscale
                            part_count += len(parts) * (grid.shape["pipe"] if stacked else 1)
                    agg_leaves[name] = agg.reshape(g.shape[1:]).to(g.dtype)
                tx.apply(state.params, agg_leaves, state.opt_state)

                sq = torch.zeros((), dtype=torch.float32, device=self.device)
                for name, spec in zip(names, specs):
                    sq = sq + torch.sum(torch.square(agg_leaves[name].to(torch.float32))) * \
                        self._replication_scale(spec)
                grad_norm = torch.sqrt(grid.psum(sq, IN_GROUP_AXES))
                total_loss = torch.sum(losses)
                if grid.size > 1:
                    total_loss = grid.world.all_reduce_sum(total_loss)
                worker_nan = None
                if self.health_probe:
                    bad = torch.zeros(k, dtype=torch.int64, device=self.device)
                    for g in g_leaves:
                        bad = bad + torch.sum(~torch.isfinite(g.reshape(k, -1)), dim=1)
                    bad = grid.psum(bad, IN_GROUP_AXES) > 0
                    worker_nan = bad if self.nb_devices == 1 else self.axis.all_gather(bad).reshape(n)
                secure = None
                if secure_local is not None:
                    secure = {}
                    for field, summed in (("digest_sent", True), ("digest_recv", True), ("forged", False),
                                          ("rejected", False)):
                        value = secure_local[field]
                        if summed:
                            value = grid.psum(value, IN_GROUP_AXES) & 0xFFFFFFFF
                        if self.nb_devices > 1:
                            value = self.axis.all_gather(value).reshape((n,) + tuple(value.shape[1:]))
                        secure[field] = value.to(torch.uint32) if summed else value
                return self._finalize_step(
                    state, total_loss, grad_norm, worker_nan,
                    grid.psum(part_sum, IN_GROUP_AXES) / part_count if part_count else None,
                    grid.psum(wdist, IN_GROUP_AXES) if self.worker_metrics else None,
                    grid.psum(rep_dist, IN_GROUP_AXES) if self.reputation_decay is not None else None,
                    ridx, secure)

        return step

    def _sharded_build_eval(self, loss_fn):
        """``eval(state, batch)``: the mean over the workers of the sharded
        loss (the local partials summed over every rank, divided by n)."""
        grid = self.mesh

        @torch.no_grad()
        def eval_step(state, batch):
            params = {name: value.detach() for name, value in state.params.items()}
            total = sum(loss_fn(params, {key: value[j] for key, value in batch.items()}, grid)
                        for j in range(self.workers_per_device))
            if grid.size > 1:
                total = grid.world.all_reduce_sum(total)
            return total / self.nb_workers

        return eval_step

    def _sharded_build_gar_probe(self, d, seed=0):
        """The rule once over whole-model (n, d) synthetic rows on this rank
        (JAX ``_sharded_build_gar_probe``): exact for ``global``, an upper
        bound of the per-bucket work otherwise; the distances are the
        centring and K2, as the step's.  The caller synchronises before
        reading the clock."""
        generator = torch.Generator(device=self.device).manual_seed(int(seed))
        rows = torch.randn((self.nb_workers, int(d)), generator=generator, dtype=torch.float32, device=self.device)

        @torch.no_grad()
        def probe(step=0):
            dist2 = centered_gram_sq_distances(probe.rows) if self.gar.needs_distances else None
            return self.gar._call_aggregate(probe.rows, dist2, key=gar_key(seed, step))

        probe.rows = rows
        return probe


def _run_steps(body, state, count, batch_of):
    """Run ``body`` for ``count`` steps, step k on ``batch_of(state, k)``;
    the state and the per-step metrics stacked along a leading axis."""
    metrics = []
    for k in range(count):
        state, step_metrics = body(state, batch_of(state, k))
        metrics.append(step_metrics)
    return state, stack_metrics(metrics)


class ShardedRobustEngine(RobustEngine):
    """``RobustEngine(..., sharding="sharded")`` under JAX's historical name
    and signature (JAX ``engine.py:2711-2731``): ``mesh`` a
    ``parallel.mesh.DeviceGrid`` (None: the one-rank grid on ``device``)."""

    def __init__(self, mesh, gar, nb_real_byz=0, attack=None, lossy_link=None, granularity="layer",
                 exchange_dtype=None, worker_momentum=None, worker_metrics=False, reputation_decay=None,
                 quarantine_threshold=0.0, l1_regularize=None, l2_regularize=None, chaos=None, health_probe=True,
                 nb_workers=None, secure=False, flight=None, device="cuda"):
        super().__init__(gar, nb_workers=nb_workers, nb_real_byz=nb_real_byz, attack=attack, lossy_link=lossy_link,
                         granularity=granularity, exchange_dtype=exchange_dtype, worker_momentum=worker_momentum,
                         worker_metrics=worker_metrics, reputation_decay=reputation_decay,
                         quarantine_threshold=quarantine_threshold, l1_regularize=l1_regularize,
                         l2_regularize=l2_regularize, chaos=chaos, health_probe=health_probe, secure=secure,
                         flight=flight, sharding="sharded", mesh=mesh, device=device)
