"""Bounded-wait robust aggregation: never wait on the slowest worker.

Counterpart of ``aggregathor_tpu/parallel/bounded.py`` in its flat mode.  A
rule sized for f Byzantine rows absorbs a missing row for free (a lost
packet becomes a NaN row), so the aggregator may close a round at a
DEADLINE instead of at the last submission (OptiReduce, arXiv:2310.06993).
:class:`BoundedWaitStep` is that protocol over the engine's bounded-wait
builders (``parallel/engine.py``):

1. ``engine.build_worker_grad``: one worker's submission, run once a worker
   a round on a thread of its own (a submission unit is one worker).  On
   the card each unit has its own CUDA stream, made once with the step: the
   thread makes it current, makes it wait on an event the caller's stream
   recorded after the round's inputs were enqueued, runs the submission,
   records a ``done`` event and waits on it (which releases the GIL).  The
   submission ARRIVES when that wait returns, on the host's monotonic clock.
   One thread at a time enqueues a submission's kernels (the host's work,
   under the GIL): eight threads interleaving it took a synchronous cnnet
   round to ~85 ms on the H100, one at a time ~55 ms
   (``scripts/torch_bounded_timing.py``, PERF.md); the card runs the
   enqueued streams side by side either way, and a stalled thread sleeps
   outside the lock.
2. The host waits for arrivals against a window: a fixed ``deadline``, or
   the :class:`~.deadline.DeadlineController`'s adaptive one.  The first
   round has no deadline: it builds the kernels at first use
   (``ops/build.py``), and charging that to the deadline would time out
   every worker of round 0.
3. A timed-out worker's slot becomes a NaN row or, under ``stale_infill``,
   its CLEVER carry row (the last row the aggregator received from it) for
   at most ``stale_max_age`` consecutive rounds.
4. ``engine.build_bounded_aggregate``: the aggregate and update on the
   caller's stream, after it waited on each arrived unit's ``done`` event,
   over the stacked rows (the codec's payloads, decoded there) and the
   arrival and stale masks, which cross to the card once a round through
   pinned memory without blocking.

**f-accounting** (JAX ``bounded.py:46-57``): timeout rows AND stale rows
spend the declared-f budget as attack rows do (t + s + b <= f).  A worker
whose previous submission is still in flight when a round opens is skipped
for it (an immediate timeout): a unit never has more than one submission
outstanding.

**Cross-stream lifetime.** Every tensor one stream makes and another reads
is ``record_stream``-ed to the reader, so the caching allocator does not
hand its block on while the reader's work is queued: what a submission
reads (the parameters, the batch slice, ``state.momentum``, ``state.ef``)
to the unit's stream, what the aggregate reads (the rows, losses, momentum
and residual rows a submission made) to the caller's stream.

**No donation race.** The aggregate updates the parameters in place, and a
submission dispatched before a round closed may still run.  The
submissions of a round read a copy of the round's parameters, made on the
caller's stream before the round opens, so a late one neither reads
half-updated values nor trips autograd's version check on the parameters
it saved; its outputs are discarded, and the round lock stops any dispatch
after the close (JAX ``bounded.py:482-485``).  There is no benign late
failure (JAX's ``_is_donation_race``): every exception of a submission
that outlived its round is a real failure and surfaces at that unit's next
dispatch; a failure inside the round surfaces at its barrier.

:class:`HostStragglerModel` maps a chaos schedule's straggler regimes (or a
flat rate, with a lognormal ``jitter``) to wall-clock submission delays,
drawn from ``np.random.default_rng((seed, step, worker))`` as JAX draws
them.  A stalled thread sleeps in slices of at most 50 ms and checks the
step's poison between them, so ``close()`` and interpreter exit never hang.

Not carried: the sharded mode's submesh units (``build_group_grad``,
``build_submesh_grad``: the sharded engine, ROADMAP queue 1 item 8c).

Under ``topology`` (a :class:`~aggregathor_tpu_torch.topology.TreeAggregator`,
the runner's ``--topology``) the round's stacked wire rows go through the
tree's protocol at the barrier, after the worker-plane bookkeeping (timeout
counters, tracer, ``bounded_round``, the leaf controller): the per-level
emissions, custody, the level windows, reconstruction and exclusion, in a
``bounded_wait.topology`` span.  The masks it returns, excluded subtrees
cleared, are the ones the aggregate reads.  It reads the rows the caller's
stream already waited for, on that stream.

Under ``secure`` each submission returns its row's digest, and the round
hands the aggregate the digest of what arrived for each slot: the
submission's own, a stale carry's (kept with the carry), or the digest of
the NaN drop row for a slot that timed out (sender and receiver agree on
it, so a timeout is no forgery: forensics names it).
"""

import threading
import time
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait

import numpy as np
import torch

from ..obs import events, trace
from ..utils import UserException
from .compress import bytes_per_row
from .engine import gar_key

#: longest sleep of a stalled submission between two checks of the poison
STALL_SLICE_S = 0.05


class HostStragglerModel:
    """Per-(step, worker) wall-clock submission delays (JAX
    ``bounded.py:88-168``, the same draws bit for bit).

    A worker is late with the regime's straggler rate (``chaos``: a
    schedule whose only adversity is straggler regimes) or the flat
    ``rate``, and a late worker sleeps ``stall_seconds``, or ``stall *
    exp(jitter * N(0, 1))`` under ``jitter`` (the regime's, or the flat
    argument): lognormal with median ``stall``.  ``nb_eligible`` restricts
    lateness to the first K workers (the schedule's ``straggle-workers``)."""

    def __init__(self, nb_workers, stall_seconds, rate=0.0, chaos=None, nb_eligible=0, seed=0, jitter=0.0):
        self.nb_workers = int(nb_workers)
        self.stall_seconds = float(stall_seconds)
        self.rate = float(rate)
        self.jitter = float(jitter)
        self.chaos = chaos
        self.nb_eligible = int(nb_eligible)
        self.seed = int(seed)
        if chaos is not None:
            if chaos.has_attacks or chaos.has_drop or chaos.has_forgery:
                raise UserException("bounded-wait consumes ONLY straggler regimes from the schedule (attack/drop/"
                                    "forge/tamper still need the in-graph simulation of the synchronous step)")
            if not chaos.has_stragglers:
                raise UserException("the schedule has no straggler regime; drop --chaos or add one "
                                    "(e.g. '0:straggle=0.3')")
            self.nb_eligible = chaos.stragglers.nb_eligible
        if self.stall_seconds < 0.0:
            raise UserException("straggler stall must be >= 0 seconds")
        if not 0.0 <= self.rate <= 1.0:
            raise UserException("straggler rate must lie in [0, 1]")
        if self.jitter < 0.0:
            raise UserException("straggler jitter must be >= 0 (the lognormal sigma around the stall), got %g"
                                % self.jitter)
        if self.stall_seconds == 0.0 and (self.rate > 0.0 or chaos is not None):
            raise UserException("a straggler rate/schedule needs --straggler-stall > 0 seconds to actually delay "
                                "anyone")

    def _rate_at(self, step):
        if self.chaos is not None:
            return float(self.chaos._straggler_rates[self.chaos.regime_at(step)])
        return self.rate

    def _jitter_at(self, step):
        if self.chaos is not None:
            return float(self.chaos._straggler_jitter[self.chaos.regime_at(step)])
        return self.jitter

    def delay(self, step, worker):
        """Seconds worker ``worker`` holds its step-``step`` submission."""
        rate = self._rate_at(step)
        if rate <= 0.0 or self.stall_seconds <= 0.0:
            return 0.0
        if self.nb_eligible and worker >= self.nb_eligible:
            return 0.0
        # a counter-based draw: the same whichever thread asks, in any order
        gen = np.random.default_rng((self.seed, int(step), int(worker)))
        if gen.random() >= rate:
            return 0.0
        sigma = self._jitter_at(step)
        if sigma > 0.0:
            return float(self.stall_seconds * np.exp(sigma * gen.standard_normal()))
        return self.stall_seconds


def _tensors(tree):
    """The tensors of a (nested dict or list of) values."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for value in tree.values():
            yield from _tensors(value)
    elif isinstance(tree, (list, tuple)):
        for value in tree:
            yield from _tensors(value)


def _stack(rows):
    """n rows (tensors, or the codec's payload dicts) stacked to (n, ...)."""
    if isinstance(rows[0], dict):
        return {key: torch.stack([row[key] for row in rows]) for key in rows[0]}
    return torch.stack(rows)


class BoundedWaitStep:
    """The bounded-wait training step (JAX ``bounded.py:171-927``, flat
    mode): ``step(state, batch) -> (state, metrics)``, the contract of
    ``engine.build_step``'s step, so the runner's loop, forensics and
    guardian consume it unchanged.  ``deadline=None`` without a controller
    is the synchronous protocol (wait for every submission).

    - ``controller``: a :class:`~.deadline.DeadlineController`; it gives
      every warm round's window and is fed the round's arrivals.
    - ``stale_infill`` / ``stale_max_age``: a timed-out worker re-enters its
      carry row for at most ``stale_max_age`` consecutive rounds, then a
      NaN row; stale rows spend the f budget.
    - ``stale_reweight``: a stale row of age a enters scaled by 1/(1 + a)
      (needs ``stale_infill``); each such re-entry is a ``stale_reweight``
      journal event.
    - ``incremental``: each arrived row is decoded into the aggregate's
      buffer as it lands (``engine.build_incremental_fold``), the aggregate
      taking the buffer; a fold made while a submission is still pending
      counts as overlapped (``exchange_overlap_fraction``).
    - ``registry``: ``straggler_timeouts_total``,
      ``straggler_skipped_rounds_total``, ``stale_infill_rows_total`` (by
      worker), ``bounded_wait_rounds_total``,
      ``bounded_wait_deadline_seconds`` and, incremental, the
      ``exchange_*`` fold families.
    - ``topology``: the tree's host protocol, bound here to the leaf plane
      (module docstring); not with ``incremental``.
    """

    def __init__(self, engine, loss_fn, tx, params_template, deadline=None, straggler_model=None, registry=None,
                 controller=None, stale_infill=False, stale_max_age=4, stale_reweight=False, incremental=False,
                 topology=None):
        if deadline is not None and deadline <= 0.0:
            raise UserException("--step-deadline must be > 0 seconds")
        if stale_infill and deadline is None and controller is None:
            raise UserException("--stale-infill needs a deadline (or the adaptive controller): the synchronous "
                                "protocol never times anyone out, so there is nothing to infill")
        if stale_reweight and not stale_infill:
            raise UserException("--stale-reweight rescales STALE CARRY rows; without --stale-infill every miss is a "
                                "NaN drop and there is nothing to reweight")
        self.stale_max_age = int(stale_max_age)
        if stale_infill and self.stale_max_age < 1:
            raise UserException("--stale-max-age must be >= 1 round (got %d)" % self.stale_max_age)
        if topology is not None and engine.sharded:
            raise UserException("--topology drives per-WORKER leaf rows; the sharded engine's per-submesh "
                                "submission units are a different grouping than the tree's — run the flat engine")
        if topology is not None and incremental:
            raise UserException("--topology and --incremental-aggregation are mutually exclusive: the tree's "
                                "custody plane signs the stacked wire rows at the barrier, which the incremental "
                                "fold never materializes")
        self.engine = engine
        self.nb_workers = self.nb_units = engine.nb_workers
        self.deadline = deadline
        self.controller = controller
        self.stale_infill = bool(stale_infill)
        self.stale_reweight = bool(stale_reweight)
        self.model = straggler_model
        self.momentum = engine.worker_momentum is not None
        self.codec = engine.codec
        self.ef = bool(engine.carries_ef)
        self.incremental = bool(incremental)
        self.topology = topology
        self.grad_fn = engine.build_worker_grad(loss_fn)
        self.agg_fn = engine.build_bounded_aggregate(tx, params_template,
                                                     rows_form="decoded" if self.incremental else "wire",
                                                     stale_reweight=self.stale_reweight)
        self.device = engine.device
        self.pool = ThreadPoolExecutor(max_workers=self.nb_units, thread_name_prefix="bw-submit")
        # one stream a unit, made once: the card's queue of its submissions
        self._streams = ([torch.cuda.Stream(self.device) for _ in range(self.nb_units)]
                         if self.device.type == "cuda" else None)
        # on the card one submission enqueues its kernels at a time: the
        # enqueueing is the host's work under the GIL, which eight threads
        # interleaved slow down (module docstring); the card still runs the
        # streams' work side by side
        self._dispatch_lock = threading.Lock()
        self._in_flight = [None] * self.nb_units
        self._round = 0
        self._round_lock = threading.Lock()
        self._closed = False
        self._warm = False
        d = sum(int(value.numel()) for value in params_template.values())
        self.d = d
        self._row_wire_bytes = bytes_per_row(d, dtype=engine.exchange_dtype, codec=self.codec)
        # one miss row and zero loss for every missing slot: a NaN row on the
        # dtype wire, a zeroed payload under a codec (never read: the
        # aggregate masks the slot after decoding)
        if self.codec is not None:
            self._miss_row = self.codec.payload_zeros(d, device=self.device)
        else:
            self._miss_row = torch.full((d,), torch.nan, dtype=engine.exchange_dtype or torch.float32,
                                        device=self.device)
        self._miss_loss = torch.zeros((), dtype=torch.float32, device=self.device)
        self._zero_row = torch.zeros((d,), dtype=torch.float32, device=self.device)
        if topology is not None:
            # the tree's emissions decode and sign exactly these wire rows
            topology.bind(self.nb_workers, d, codec=self.codec)
        self._fold_fn = self._fresh_buffer = None
        if self.incremental:
            self._fold_fn, self._fresh_buffer = engine.build_incremental_fold(d)
        self.secure = bool(engine.secure)
        self._nan_digest = None
        if self.secure:
            from ..secure.submit import row_digest

            # the drop row's digest, over the f32 NaN row on every wire (under
            # a codec the drop's image is still the NaN row the aggregate masks in)
            self._nan_digest = row_digest(torch.full((d,), torch.nan, dtype=torch.float32, device=self.device))
        # the CLEVER carry: the last row each worker delivered, its digest and its age
        self._carry = [None] * self.nb_workers
        self._carry_digest = [None] * self.nb_workers
        self._carry_age = np.zeros((self.nb_workers,), np.int64)
        self.timeouts_total = np.zeros((self.nb_workers,), np.int64)
        self.stale_total = np.zeros((self.nb_workers,), np.int64)
        self.folds_total = 0
        self.overlapped_folds_total = 0
        self.last_overlap_fraction = 0.0
        #: the last round's arrival seconds by unit (inf: missed) and the
        #: monotonic time it closed at
        self.last_arrivals = None
        self.last_closed_at = None
        self._c_timeouts = self._c_rounds = self._g_deadline = None
        self._c_late = self._c_stale = None
        self._c_folds = self._c_overlapped = self._g_overlap = None
        if registry is not None:
            self._c_timeouts = registry.counter("straggler_timeouts_total",
                                                "Worker submissions that missed the step deadline",
                                                labelnames=("worker",))
            self._c_late = registry.counter("straggler_skipped_rounds_total",
                                            "Rounds skipped because the worker's previous submission was still "
                                            "in flight", labelnames=("worker",))
            self._c_stale = registry.counter("stale_infill_rows_total",
                                             "Timed-out submissions replaced by the worker's CLEVER carry row "
                                             "instead of a NaN drop", labelnames=("worker",))
            self._c_rounds = registry.counter("bounded_wait_rounds_total", "Bounded-wait aggregation rounds")
            self._g_deadline = registry.gauge("bounded_wait_deadline_seconds", "Configured step deadline")
            if deadline is not None:
                self._g_deadline.set(float(deadline))
            if self.incremental:
                self._c_folds = registry.counter("exchange_folds_total",
                                                 "Submissions folded into the aggregate-side buffer as they "
                                                 "landed (incremental aggregation)")
                self._c_overlapped = registry.counter("exchange_overlapped_folds_total",
                                                      "Incremental folds issued while at least one submission was "
                                                      "still outstanding")
                self._g_overlap = registry.gauge("exchange_overlap_fraction", "Last round's overlapped-fold fraction")

    # ------------------------------------------------------------------ #

    def _track_name(self, unit):
        """The Perfetto track of one submission unit (zero-padded so the
        tracks sort numerically)."""
        return "worker %0*d" % (len(str(max(self.nb_units - 1, 1))), unit)

    def _stall(self, step_idx, unit):
        """Sleep the model's delay in slices, checking the poison between
        them; False when the step was closed meanwhile."""
        stall = self.model.delay(step_idx, unit)
        if not stall:
            return True
        tracer = trace.installed()
        stall_t0 = tracer.now_us() if tracer is not None else 0.0
        wake_at = time.monotonic() + stall
        while True:
            remaining = wake_at - time.monotonic()
            if remaining <= 0:
                break
            time.sleep(min(STALL_SLICE_S, remaining))
            if self._closed:
                return False
        if tracer is not None:
            tracer.complete_at("stall", stall_t0, tracer.now_us() - stall_t0, tracer.track(self._track_name(unit)),
                               cat="bounded", args={"step": step_idx})
        return True

    def _submit_one(self, round_id, step_idx, unit, round_begin, args, kwargs, ready, consumer):
        """The submission thread: the injected stall, then the submission.
        Returns ``(arrival_seconds, outputs, done)`` or None when the round
        closed first.  A failure raises: inside the round it surfaces at the
        barrier, after it at the unit's next dispatch."""
        if self.model is not None and not self._stall(step_idx, unit):
            return None
        with self._round_lock:
            if round_id != self._round:
                return None  # the round closed while we stalled: no dispatch
        if self._streams is None:
            out = self.grad_fn(*args, **kwargs)
            return time.monotonic() - round_begin, out, None
        stream = self._streams[unit]
        with torch.cuda.device(self.device), torch.cuda.stream(stream):
            stream.wait_event(ready)
            for tensor in _tensors((args, kwargs)):
                tensor.record_stream(stream)
            with self._dispatch_lock:
                out = self.grad_fn(*args, **kwargs)
            done = torch.cuda.Event()
            done.record(stream)
        done.synchronize()
        arrival = time.monotonic() - round_begin
        for tensor in _tensors(out):
            tensor.record_stream(consumer)
        return arrival, out, done

    def _received(self, result, consumer):
        """A submission's outputs, the caller's stream made to wait for them."""
        _, out, done = result
        if done is not None:
            consumer.wait_event(done)
        return out

    def __call__(self, state, batch):
        if self._closed:
            raise RuntimeError("BoundedWaitStep was closed")
        n = self.nb_workers
        step_idx = int(state.step)
        cuda = self._streams is not None
        consumer = torch.cuda.current_stream(self.device) if cuda else None
        # the round's parameters, read by its submissions; the aggregate
        # updates the live ones in place
        params = {name: value.detach().clone() for name, value in state.params.items()}
        ready = None
        if cuda:
            ready = torch.cuda.Event()
            ready.record(consumer)
        futures, skipped = {}, []
        round_begin = time.monotonic()
        tracer = trace.installed()
        round_t0_us = tracer.now_us() if tracer is not None else 0.0
        for unit in range(self.nb_units):
            prev = self._in_flight[unit]
            if prev is not None and not prev.done():
                skipped.append(unit)  # still submitting an earlier round
                continue
            if prev is not None and not prev.cancelled() and prev.exception() is not None:
                raise RuntimeError("bounded-wait: submission unit %d died after its round closed (late failure)"
                                   % unit) from prev.exception()
            args = (params, {key: value[unit] for key, value in batch.items()}, state.seed, step_idx, unit)
            kwargs = {}
            if self.momentum:
                kwargs.update(momentum=state.momentum, momentum_steps=state.momentum_steps)
            if self.ef:
                kwargs["ef"] = state.ef
            self._in_flight[unit] = futures[unit] = self.pool.submit(
                self._submit_one, self._round, step_idx, unit, round_begin, args, kwargs, ready, consumer)
        was_warm = self._warm
        deadline = (self.controller.window if self.controller is not None else self.deadline) if was_warm else None
        self._warm = True
        buffer = self._fresh_buffer() if self.incremental else None
        folded = set()
        nb_folds = nb_overlapped = 0
        fut_unit = {fut: unit for unit, fut in futures.items()}

        def fold_done(done, pending):
            nonlocal buffer, nb_folds, nb_overlapped
            for fut in done:
                if fut.cancelled() or fut.exception() is not None or fut.result() is None:
                    continue  # the barrier surfaces a failure
                unit = fut_unit[fut]
                buffer = self._fold_fn(buffer, self._received(fut.result(), consumer)["row"], unit)
                folded.add(unit)
                nb_folds += 1
                nb_overlapped += bool(pending)
                if tracer is not None:
                    tracer.complete_at("fold", tracer.now_us(), 0.0, tracer.track(self._track_name(unit)),
                                       cat="bounded", args={"step": step_idx, "overlapped": bool(pending)})

        with trace.span("bounded_wait.collect", cat="train"):
            pending = set(futures.values())
            if deadline is None and not self.incremental:
                if pending:
                    wait(pending)
            else:
                deadline_at = None if deadline is None else time.monotonic() + deadline
                while pending:
                    if deadline_at is None:
                        done, pending = wait(pending, return_when=FIRST_COMPLETED)
                    else:
                        remaining = deadline_at - time.monotonic()
                        if remaining <= 0:
                            break
                        done, pending = wait(pending, timeout=remaining, return_when=FIRST_COMPLETED)
                    if self.incremental:
                        fold_done(done, pending)
        # close the round: a submission that wakes from now on does not run
        with self._round_lock:
            self._round += 1
        self.last_closed_at = time.monotonic()
        arrived = np.zeros((n,), bool)
        stale = np.zeros((n,), bool)
        arrival_seconds = np.full((n,), np.inf)
        losses, rows = [None] * n, [None] * n
        mom_rows = [None] * n if self.momentum else None
        ef_rows = [None] * n if self.ef else None
        digests = [None] * n if self.secure else None
        for w in range(n):
            fut = futures.get(w)
            result = None
            if fut is not None and fut.done():
                try:
                    result = fut.result()
                except Exception as exc:
                    raise RuntimeError("bounded-wait: submission unit %d died mid-round at step %d"
                                       % (w, step_idx)) from exc
            if result is not None:
                out = self._received(result, consumer)
                arrived[w] = True
                arrival_seconds[w] = result[0]
                losses[w] = out["loss"]
                rows[w] = out["row"]
                if self.stale_infill:
                    self._carry[w] = out["row"]
                    self._carry_age[w] = 0
                if self.momentum:
                    mom_rows[w] = out["momentum"]
                if self.ef:
                    ef_rows[w] = out["ef"]
                if self.secure:
                    digests[w] = out["digest"]
                    if self.stale_infill:
                        self._carry_digest[w] = out["digest"]
            else:
                self._carry_age[w] += 1
                losses[w] = self._miss_loss
                if self.stale_infill and self._carry[w] is not None and self._carry_age[w] <= self.stale_max_age:
                    stale[w] = True  # the carry re-enters, and spends the f budget
                    rows[w] = self._carry[w]
                    if self.secure:
                        digests[w] = self._carry_digest[w]
                else:
                    rows[w] = self._miss_row
                    if self.secure:
                        digests[w] = self._nan_digest
                if self.momentum:
                    mom_rows[w] = self._zero_row  # never read: the aggregate keeps the old row
                if self.ef:
                    ef_rows[w] = self._zero_row
        if self.incremental:
            # rows that landed after the window, and stale carries, are folded
            # at the barrier (not overlapped)
            for w in range(n):
                if (arrived[w] and w not in folded) or stale[w]:
                    buffer = self._fold_fn(buffer, rows[w], w)
                    nb_folds += 1
            self.folds_total += nb_folds
            self.overlapped_folds_total += nb_overlapped
            self.last_overlap_fraction = nb_overlapped / nb_folds if nb_folds else 0.0
        self.timeouts_total += ~arrived
        self.stale_total += stale
        self.last_arrivals = arrival_seconds
        skipped_units = set(skipped)
        if tracer is not None:
            self._trace_round(tracer, step_idx, round_t0_us, deadline, arrived, stale, arrival_seconds, skipped_units)
        self._journal_round(step_idx, was_warm, deadline, arrived, stale, skipped_units)
        if self.controller is not None and was_warm:
            # the rounds the deadline governed only: round 0 measures the builds
            self.controller.observe_round(arrival_seconds, step=step_idx)
        if self._c_folds is not None:
            self._c_folds.inc(nb_folds)
            self._c_overlapped.inc(nb_overlapped)
            self._g_overlap.set(self.last_overlap_fraction)
        if self._c_timeouts is not None:
            for w in np.nonzero(~arrived)[0]:
                self._c_timeouts.labels(worker=str(int(w))).inc()
            for w in np.nonzero(stale)[0]:
                self._c_stale.labels(worker=str(int(w))).inc()
            for w in skipped:
                self._c_late.labels(worker=str(int(w))).inc()
            self._c_rounds.inc()
            if deadline is not None:
                self._g_deadline.set(float(deadline))
        rows_in = buffer if self.incremental else _stack(rows)
        if self.topology is not None:
            with trace.span("bounded_wait.topology", cat="train", step=step_idx):
                arrived, stale = self.topology.process_round(step_idx, arrived, stale, arrival_seconds, rows_in,
                                                             leaf_window=deadline, key=gar_key(state.seed, step_idx))
        # the masks and ages cross to the card once, through pinned memory
        flags = self.engine._to_device(torch.from_numpy(
            np.stack([arrived, stale, self._carry_age]).astype(np.int32)))
        extras = {}
        if self.stale_reweight:
            extras["stale_age"] = flags[2]
        if self.momentum:
            extras["momentum"] = torch.stack(mom_rows)
        if self.ef:
            extras["ef"] = torch.stack(ef_rows)
        if self.secure:
            extras["digests"] = torch.stack(digests)
        with trace.span("bounded_wait.aggregate", cat="train", step=step_idx):
            return self.agg_fn(state, rows_in, torch.stack(losses), flags[0].bool(), flags[1].bool(), extras)

    def _cache_size(self):
        """The compile surface (JAX ``bounded.py:896-907``): the tree's
        emission shapes a level, else 1 once the first round ran (the
        submission and the aggregate run eagerly, one shape each)."""
        sizes = [int(self._warm)]
        if self.topology is not None:
            sizes.append(self.topology.cache_size())
        return max(sizes)

    def _trace_round(self, tracer, step_idx, round_t0_us, deadline, arrived, stale, arrival_seconds, skipped_units):
        """Each unit's round on its own track, as one span from the round's
        open (JAX ``bounded.py:729-794``), and the round's counters."""
        close_us = tracer.now_us()
        window_us = close_us - round_t0_us if deadline is None else float(deadline) * 1e6
        for unit in range(self.nb_units):
            track = tracer.track(self._track_name(unit))
            if arrived[unit]:
                tracer.complete_at("submit", round_t0_us, arrival_seconds[unit] * 1e6, track, cat="bounded",
                                   args={"step": step_idx})
            elif unit in skipped_units:
                tracer.complete_at("skipped_round", round_t0_us, 0.0, track, cat="bounded", args={"step": step_idx})
            elif stale[unit]:
                span_args = {"step": step_idx, "age": int(self._carry_age[unit])}
                if self.stale_reweight:
                    span_args["coefficient"] = 1.0 / (1.0 + float(self._carry_age[unit]))
                tracer.complete_at("stale_infill", round_t0_us, window_us, track, cat="bounded", args=span_args)
            else:
                tracer.complete_at("timeout", round_t0_us, window_us, track, cat="bounded", args={"step": step_idx})
        if deadline is not None:
            tracer.counter("bounded.deadline_window_s", float(deadline), ts=close_us, cat="bounded")
        tracer.counter("bounded.arrivals", int(arrived.sum()), ts=close_us, cat="bounded")
        tracer.counter("bounded.timeouts", int((~arrived).sum()), ts=close_us, cat="bounded")
        tracer.counter("bounded.stale_rows", int(stale.sum()), ts=close_us, cat="bounded")
        tracer.counter("bounded.bytes_on_wire", int(arrived.sum()) * self._row_wire_bytes, ts=close_us,
                       cat="bounded")
        if self.incremental:
            tracer.counter("bounded.overlap_fraction", self.last_overlap_fraction, ts=close_us, cat="bounded")

    def _journal_round(self, step_idx, was_warm, deadline, arrived, stale, skipped_units):
        """The round's decisions on the journal (JAX ``bounded.py:795-817``):
        a warm round that timed someone out, infilled a carry or skipped a
        unit is a ``bounded_round``; each reweighted re-entry a
        ``stale_reweight``."""
        if not was_warm:
            return
        if (~arrived).any() or stale.any() or skipped_units:
            events.emit("bounded_round", step=step_idx, deadline_s=None if deadline is None else float(deadline),
                        nb_arrived=int(arrived.sum()), timed_out=[int(w) for w in np.nonzero(~arrived)[0]],
                        stale_infill=[int(w) for w in np.nonzero(stale)[0]],
                        skipped_units=sorted(int(u) for u in skipped_units))
        if self.stale_reweight:
            for w in np.nonzero(stale)[0]:
                age = int(self._carry_age[w])
                events.emit("stale_reweight", step=step_idx, worker=int(w), age=age, coefficient=1.0 / (1.0 + age))

    def close(self, timeout=5.0):
        """Idempotent shutdown: poison the round so stalled threads never
        dispatch, cancel what is queued, then join the outstanding threads
        with a bounded wait."""
        if self._closed:
            return
        self._closed = True
        with self._round_lock:
            self._round += 1
        self.pool.shutdown(wait=False, cancel_futures=True)
        pending = [fut for fut in self._in_flight if fut is not None and not fut.done()]
        if pending:
            wait(pending, timeout=timeout)
