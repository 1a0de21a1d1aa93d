"""The robust training engine, flat dataflow on one device.

Counterpart of the flat mode of ``aggregathor_tpu/parallel/engine.py``
(its dataflow, ``engine.py:1-31``) with the worker -> dimension
``all_to_all`` collapsed: one device holds the whole (n, d) matrix.  Per step:

0. **In-step augmentation** (``batch_transform``, optional): worker w's
   training batch goes through the transform with draws made on a CPU
   generator seeded from (seed, step, w, 3) and copied to the device, so
   worker w's augmentation depends on neither n nor the device.
1. **Isolated worker gradients** (``_worker_gradients``): one
   ``torch.func.vmap`` of ``grad_and_value(loss)`` over the n workers'
   batches on the detached parameters (JAX ``engine.py:463-471``): every
   worker's forward and backward in one batched pass, all n workers'
   activations live at once.  The (n, *shape) gradient leaves are written
   into the (n, d) float32 matrix in the JAX package's coordinate order,
   one copy per leaf (``FlatMap.flatten_rows``).
2. **Local attack and transport** (``_perturb_local``): rows w < r pass
   through the attack's ``apply_local`` with a generator seeded from
   (seed, step, w, 1); then the lossy link (``--UDP``) masks the lost
   packets of rows w < k from the (seed, step, w, 2) stream, with NaN or,
   under ``clever:true``, the carry's row.  The carry then takes every
   row as it arrived (post-transport, before the omniscient attack).
3. **Omniscient attack** (``_prepare_rows``): coalition attacks rewrite rows
   w < r from the honest statistics.
4. **Aggregation** (``_aggregate_block``): when the rule needs distances,
   one launch gives the (n, n) matrix (K1 up to 64 workers, median centring
   and K2 beyond), clamped at 0; then the rule (K3-K5 for the rank-based
   rules and Bulyan's last phase, K6 for average-nan).
5. **Update**: the (d,) aggregate is inflated to torch-layout views and the
   optimizer applies it in place to the one copy of the parameters.

``build_multi_step`` runs K such steps in one call, on K distinct batches
or one resident batch K times; ``build_sampled_multi_step`` draws each
step's batches from a dataset held on the device (``replicate``), worker
w's indices from the (seed, step, w, 4) stream, and gathers them there.
Both return per-step metrics with a leading K.

Left out of this port so far, each refused with a UserException when asked
for: chaos schedules, the wire codec and exchange dtype, secure submission,
reputation/quarantine, worker momentum, worker metrics, the flight recorder,
bounded-wait, the sharded mode and leaf granularity.
"""

import numpy as np
import torch
from torch.func import grad_and_value, vmap

from ..core.flatten import FlatMap
from ..core.train_state import TrainState
from ..ops import kernels
from ..utils import UserException, resolve_device

#: stream tags, as the JAX engine folds them: the local attacks (1), the
#: in-step augmentation (3) and the device-side sampling (4); the lossy
#: link's (2) lives in ``lossy.py``
ATTACK_TAG = 1
AUGMENT_TAG = 3
SAMPLE_TAG = 4

#: engine options of the JAX package this port does not carry yet
UNPORTED_OPTIONS = (
    "exchange_dtype", "exchange", "worker_momentum", "worker_metrics", "reputation_decay",
    "quarantine_threshold", "chaos", "secure", "flight", "step_deadline", "l1_regularize", "l2_regularize",
)


def stream_generator(seed, step, worker, tag, device):
    """A ``torch.Generator`` on ``device`` for the (seed, step, worker, tag)
    stream: disjoint streams for distinct tuples, the same draws every run."""
    words = np.random.SeedSequence([seed, step, worker, tag]).generate_state(2, np.uint32)
    value = (int(words[0]) << 31) ^ int(words[1])
    return torch.Generator(device=device).manual_seed(value)


class RobustEngine:
    """The robust engine on one device (see the module docstring).

    Args:
      gar: the aggregation rule (``gars.instantiate``).
      nb_workers: n logical workers (default: the rule's n).
      nb_real_byz: r, the workers that actually attack (the first r rows).
      attack: an ``attacks.Attack`` or None.
      lossy_link: a ``lossy.LossyLink`` (``--UDP``) or None.
      batch_transform: an in-step augmentation (``preprocessing.device_transform``)
        applied to each worker's training batch, or None.
      device: "cuda" (default) or "cpu"; CUDA without a GPU raises.
      sharding / granularity: only "flat" / "vector" are ported.
    """

    def __init__(self, gar, nb_workers=None, nb_real_byz=0, attack=None, lossy_link=None,
                 batch_transform=None, device="cuda", sharding="flat", granularity="vector", **options):
        for name, value in options.items():
            if name not in UNPORTED_OPTIONS:
                raise TypeError("RobustEngine got an unexpected keyword argument %r" % name)
            if value not in (None, False, 0, 0.0):
                raise UserException("%s is not available in the PyTorch port yet" % name)
        if sharding != "flat":
            raise UserException("sharding=%r is not available in the PyTorch port yet (flat only)" % sharding)
        if granularity != "vector":
            raise UserException(
                "granularity=%r is not available in the PyTorch port yet (vector only)" % granularity
            )
        self.gar = gar
        self.nb_workers = int(nb_workers if nb_workers is not None else gar.nb_workers)
        self.nb_real_byz = int(nb_real_byz)
        self.attack = attack
        self.lossy_link = lossy_link
        self.batch_transform = batch_transform
        # CLEVER infill reads the rows received last step (TrainState.carry)
        self.carries_gradients = lossy_link is not None and lossy_link.clever
        self.device = resolve_device(device)
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
        """``draw(generator)`` -> dict of CPU tensors, made for each worker w
        from its (seed, step, w, tag) stream on a CPU generator (so a CPU and
        a card run draw alike), stacked to (n, ...) and copied to the device."""
        per_worker = [draw(stream_generator(seed, step, w, tag, "cpu")) for w in range(self.nb_workers)]
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

    def _perturb_local(self, rows, seed, step, carry=None):
        """Local attack on the first r rows, then the lossy link on the first
        k, each row with its own streams; ``carry`` (the rows received last
        step, under clever infill) is then overwritten with the rows as they
        arrived, in place."""
        if self.attack is not None and not self.attack.omniscient:
            for w in range(self.nb_real_byz):
                generator = stream_generator(seed, step, w, ATTACK_TAG, self.device)
                rows[w] = self.attack.apply_local(rows[w], generator)
        link = self.lossy_link
        if link is not None:
            d = rows.shape[1]
            for w in range(min(link.nb_lossy, self.nb_workers)):
                previous = carry[w] if carry is not None else None
                rows[w] = link.apply(rows[w], w, link.draw_drops(d, seed, step, w), previous=previous)
        if carry is not None:
            carry.copy_(rows)
        return rows

    def _prepare_rows(self, rows):
        """Omniscient attack: the coalition rewrites rows w < r."""
        if self.attack is None or not self.attack.omniscient:
            return rows
        byz_mask = torch.arange(self.nb_workers, device=self.device) < self.nb_real_byz
        return self.attack.apply_matrix(rows, byz_mask)

    def _aggregate_block(self, rows):
        """Distances (one K1 or K2 launch) when the rule needs them, then the rule."""
        dist2 = None
        if self.gar.needs_distances:
            dist2 = torch.clamp_min(kernels.pairwise_sq_distances(rows), 0.0)
        return self.gar._call_aggregate(rows, dist2)

    # ------------------------------------------------------------------ #

    def init_state(self, params, tx, seed=0):
        """A TrainState holding ``params`` moved to the engine's device
        (leaf tensors that require grad), a fresh optimizer state and, under
        clever infill, a zero (n, d) carry: a packet lost before anything
        arrived reads as 0."""
        params = {
            name: value.detach().to(self.device, torch.float32).clone().requires_grad_(True)
            for name, value in params.items()
        }
        carry = None
        if self.carries_gradients:
            d = sum(value.numel() for value in params.values())
            carry = torch.zeros((self.nb_workers, d), dtype=torch.float32, device=self.device)
        return TrainState(params=params, opt_state=tx.init(params), step=0, seed=int(seed), carry=carry)

    def _to_device(self, tensor):
        """``tensor`` on the engine's device; on CUDA through pinned memory,
        copied asynchronously on the current stream (the caching host
        allocator keeps the pinned block until the copy is done)."""
        if self.device.type != "cuda":
            return tensor.to(self.device)
        return tensor.pin_memory().to(self.device, non_blocking=True)

    def _put(self, batch, lead):
        out = {}
        for key, value in batch.items():
            tensor = torch.as_tensor(np.ascontiguousarray(value))
            if tuple(tensor.shape[:len(lead)]) != lead:
                raise UserException(
                    "batch %r leads with %s, expected %s" % (key, tuple(tensor.shape[:len(lead)]), lead)
                )
            out[key] = self._to_device(tensor)
        return out

    def put_batch(self, batch):
        """Move a worker-major numpy batch (leading axis n) to the device."""
        return self._put(batch, (self.nb_workers,))

    def put_batches(self, chunk):
        """Move a (K, n, ...) numpy chunk of K batches to the device."""
        first = next(iter(chunk.values()))
        return self._put(chunk, (int(np.shape(first)[0]), self.nb_workers))

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
          worker losses) and ``grad_norm`` (norm of the aggregate).
        """

        def step(state, batch):
            flatmap = FlatMap(state.params)
            batch = self._augment(batch, state.seed, state.step)
            losses, rows = self._worker_gradients(state.params, batch, loss_fn, flatmap)
            with torch.no_grad():
                rows = self._perturb_local(rows, state.seed, state.step, state.carry)
                rows = self._prepare_rows(rows)
                agg = self._aggregate_block(rows)
                tx.apply(state.params, flatmap.inflate(agg), state.opt_state)
            state.step += 1
            return state, {"total_loss": torch.sum(losses), "grad_norm": torch.linalg.vector_norm(agg)}

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

    def build_eval_sums(self, metric_fn):
        """eval_step(state, batch) -> dict name -> (sum, count) over the batch:
        ``metric_fn`` vmapped over the n workers, then summed over them."""

        @torch.no_grad()
        def eval_step(state, batch):
            params = {name: value.detach() for name, value in state.params.items()}
            sums = vmap(metric_fn, in_dims=(None, 0))(params, batch)
            return {name: (torch.sum(total, dim=0), torch.sum(count, dim=0)) for name, (total, count) in sums.items()}

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
    return state, {name: torch.stack([m[name] for m in metrics]) for name in metrics[0]}
