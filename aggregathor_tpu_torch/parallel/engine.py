"""The robust training engine, flat dataflow on one device.

Counterpart of the flat mode of ``aggregathor_tpu/parallel/engine.py``
(its dataflow, ``engine.py:1-31``) with the worker -> dimension
``all_to_all`` collapsed: one device holds the whole (n, d) matrix.  Per step:

1. **Isolated worker gradients** (``_worker_gradients``): each of the n
   logical workers runs forward and backward on its own batch, one after
   the other (a loop over the n workers, not ``vmap``: the same kernels as a
   plain training step, at the memory of one worker), and its gradient is
   written into row w of the (n, d) float32 matrix in the JAX package's
   coordinate order (``core/flatten.py``).
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

Left out of this port so far, each refused with a UserException when asked
for: chaos schedules, the wire codec and exchange dtype, secure submission,
reputation/quarantine, worker momentum, worker metrics, the flight recorder,
bounded-wait, the sharded mode and leaf granularity.
"""

import numpy as np
import torch

from ..core.flatten import FlatMap
from ..core.train_state import TrainState
from ..ops import kernels
from ..utils import UserException, resolve_device

#: stream tag of the local attacks, as the JAX engine folds it (attack: 1)
ATTACK_TAG = 1

#: engine options of the JAX package this port does not carry yet
UNPORTED_OPTIONS = (
    "exchange_dtype", "exchange", "worker_momentum", "batch_transform",
    "worker_metrics", "reputation_decay", "quarantine_threshold", "chaos", "secure",
    "flight", "step_deadline", "l1_regularize", "l2_regularize",
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
      device: "cuda" (default) or "cpu"; CUDA without a GPU raises.
      sharding / granularity: only "flat" / "vector" are ported.
    """

    def __init__(self, gar, nb_workers=None, nb_real_byz=0, attack=None, lossy_link=None,
                 device="cuda", sharding="flat", granularity="vector", **options):
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
        # CLEVER infill reads the rows received last step (TrainState.carry)
        self.carries_gradients = lossy_link is not None and lossy_link.clever
        self.device = resolve_device(device)
        if self.nb_real_byz > self.nb_workers:
            raise UserException("More real Byzantine workers than workers")
        if attack is not None and self.nb_real_byz == 0:
            raise UserException("An attack needs --nb-real-byz-workers > 0 to have anyone to run it")

    # ------------------------------------------------------------------ #

    def _worker_gradients(self, params, batch, loss_fn, flatmap):
        """((n,) losses, (n, d) float32 gradient rows in JAX coordinate order)."""
        names = list(params)
        leaves = [params[name] for name in names]
        rows = torch.empty((self.nb_workers, flatmap.size), dtype=torch.float32, device=self.device)
        losses = torch.empty(self.nb_workers, dtype=torch.float32, device=self.device)
        for w in range(self.nb_workers):
            worker_batch = {key: value[w] for key, value in batch.items()}
            with torch.enable_grad():
                loss = loss_fn(params, worker_batch)
                grads = torch.autograd.grad(loss, leaves)
            losses[w] = loss.detach()
            flatmap.flatten_into(rows[w], dict(zip(names, grads)))
        return losses, rows

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

    def put_batch(self, batch):
        """Move a worker-major numpy batch (leading axis n) to the device."""
        out = {}
        for key, value in batch.items():
            tensor = torch.as_tensor(np.ascontiguousarray(value))
            if tensor.dim() == 0 or tensor.shape[0] != self.nb_workers:
                raise UserException(
                    "batch %r leads with %s, expected the %d workers"
                    % (key, tuple(tensor.shape[:1]), self.nb_workers)
                )
            out[key] = tensor.to(self.device)
        return out

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
            losses, rows = self._worker_gradients(state.params, batch, loss_fn, flatmap)
            with torch.no_grad():
                rows = self._perturb_local(rows, state.seed, state.step, state.carry)
                rows = self._prepare_rows(rows)
                agg = self._aggregate_block(rows)
                tx.apply(state.params, flatmap.inflate(agg), state.opt_state)
            state.step += 1
            return state, {"total_loss": torch.sum(losses), "grad_norm": torch.linalg.vector_norm(agg)}

        return step

    def build_eval_sums(self, metric_fn):
        """eval_step(state, batch) -> dict name -> (sum, count) over the batch."""

        @torch.no_grad()
        def eval_step(state, batch):
            folded = {}
            for w in range(self.nb_workers):
                sums = metric_fn(state.params, {key: value[w] for key, value in batch.items()})
                for name, (total, count) in sums.items():
                    prev = folded.get(name)
                    folded[name] = (total, count) if prev is None else (prev[0] + total, prev[1] + count)
            return folded

        return eval_step

    def build_eval(self, metric_fn):
        """Like ``build_eval_sums`` but divides, returning per-batch means."""
        eval_sums = self.build_eval_sums(metric_fn)

        def means(state, batch):
            folded = eval_sums(state, batch)
            return {name: total / torch.clamp(count, min=1) for name, (total, count) in folded.items()}

        return means
