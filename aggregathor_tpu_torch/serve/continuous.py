"""Continuous (in-flight) batching on the bucket ladder.

A copy of ``aggregathor_tpu/serve/continuous.py`` (the module imports no
JAX).  Continuous batching dispatches a request as soon as a bucket slot
(lane) is free, so an idle server never waits:

- while every lane is busy, arrivals accumulate and **join the next
  dispatch the moment a lane frees**: batching emerges from in-flight time
  instead of from an imposed wait, so occupancy rises exactly when load
  does;
- formation is strictly FIFO off the queue head, so an old request can
  never be bypassed by younger ones (starvation-freedom).

The scheduling decision lives in :class:`ContinuousPolicy`, a PURE policy
object in the ``parallel/deadline.py`` style: it consumes a queue snapshot
and a clock reading and returns a plan (no threads, no wall clock, testable
against synthetic time).  :class:`ContinuousBatcher` is the runtime around
it: a pool of dispatch **lanes** (one in-flight bucket each; ``set_lanes``
resizes the pool live, the autoscaler's capacity lever) driving one shared
engine, so any lane count runs the same bucket shapes and
``compile_count == len(buckets)`` holds at every scale.  The lanes are
threads; on the card they all enqueue on the current (default) stream.

Backpressure is explicit: over ``queue_bound`` queued rows, ``submit``
raises :class:`LoadShed` (the 429 path) instead of growing the queue; the
bound caps WAITING work only (an empty queue always admits).  A timed-out
``Ticket.wait`` (the 504 path) CANCELS its still-queued rows so lanes never
run dead work under saturation.  Every shared attribute is written under
the one scheduler lock.
"""

import threading
import time

import numpy as np

from ..obs import trace
from ..utils import UserException, info
from .engine import choose_bucket


class LoadShed(Exception):
    """Raised by ``submit`` when the queue is over ``queue_bound`` rows —
    map to HTTP 429 (``serve/frontend.py``)."""


class _Pending:
    """One submitted request travelling through the scheduler."""

    __slots__ = ("rows", "event", "result", "error", "enqueued_at",
                 "_lock", "_callbacks", "_done")

    def __init__(self, rows, now):
        self.rows = rows
        self.event = threading.Event()
        self.result = None
        self.error = None
        self.enqueued_at = now
        self._lock = threading.Lock()
        self._callbacks = []
        self._done = False

    def finish(self, result=None, error=None):
        """Complete exactly once; late completions (a cancelled request's
        batch landing anyway) are dropped.  Returns whether this call won."""
        with self._lock:
            if self._done:
                return False
            self._done = True
            self.result = result
            self.error = error
            callbacks, self._callbacks = self._callbacks, []
        self.event.set()
        for callback in callbacks:
            try:
                callback(self)
            except Exception as exc:  # a bad callback must not kill a lane
                info("serve ticket callback failed: %s: %s"
                     % (type(exc).__name__, exc))
        return True

    def add_done_callback(self, callback):
        """Run ``callback(pending)`` on completion — immediately when
        already done, else from the completing thread (the asyncio front
        end bridges this to its event loop)."""
        with self._lock:
            if not self._done:
                self._callbacks.append(callback)
                return
        callback(self)


class Ticket:
    """Handle for one submitted request.

    ``wait()`` blocks for the batch carrying it (threaded callers);
    ``add_done_callback`` delivers the completion without a blocked thread
    (the asyncio front end's path — one event loop awaits thousands of
    tickets without a thread each).  A timed-out ``wait`` CANCELS the
    request: still-queued rows are removed (lanes never run dead work for
    a caller that already got its 504); an in-flight batch's result is
    simply dropped.
    """

    def __init__(self, batcher, pending):
        self._batcher = batcher
        self._pending = pending

    def wait(self, timeout=None):
        if not self._pending.event.wait(timeout):
            self.cancel()
            raise TimeoutError("inference batch did not complete in time")
        if self._pending.error is not None:
            raise self._pending.error
        return self._pending.result

    def cancel(self):
        """Remove the request from the queue if still waiting; no-op once
        its batch is in flight.  Returns whether it was still queued."""
        return self._batcher._cancel(self._pending)

    def add_done_callback(self, callback):
        self._pending.add_done_callback(callback)

    @property
    def done(self):
        return self._pending.event.is_set()


class ContinuousPolicy:
    """Pure batch-formation policy: queue snapshot + clock in, plan out.

    The policy is deterministic in its inputs (no wall clock, no threads —
    the ``parallel/deadline.py`` discipline), so the scheduling math is
    pinned against synthetic traces by tests/test_serve_sched.py:

    - ``admit``: the load-shedding decision — over ``queue_bound`` queued
      rows a new request sheds; an empty queue ALWAYS admits (the bound
      caps waiting work, so any request up to the ladder top is servable
      by an idle server regardless of the bound).
    - ``plan``: given the pending queue (oldest first) and ``now``,
      either ``("dispatch", (nb_requests, bucket))`` — take the FIFO
      prefix that fits the ladder top, padded up to the smallest covering
      bucket — or ``("wait", due_at)`` while a sub-top batch may still
      coalesce (``linger_s > 0`` only), or ``("idle", None)``.

    ``linger_s`` is an OPTIONAL coalescing window bounding how long a
    sub-top batch may wait for company, measured from the OLDEST queued
    request's arrival; the default 0 is pure continuous batching (dispatch
    the instant a lane frees).  Note the asymmetry with the retired
    deadline batcher: linger only ever delays a batch that has a free lane
    AND spare bucket room, never an admitted request behind a busy fleet.

    Starvation-freedom is structural: formation always starts at the queue
    head, so the oldest request is in EVERY dispatched batch until served
    — a younger request can never jump it.
    """

    def __init__(self, buckets, queue_bound=256, linger_s=0.0):
        self.buckets = tuple(int(b) for b in buckets)
        if not self.buckets or list(self.buckets) != sorted(set(self.buckets)) \
                or self.buckets[0] < 1:
            raise UserException(
                "ContinuousPolicy wants a sorted positive bucket ladder, got %r"
                % (buckets,)
            )
        self.top = self.buckets[-1]
        self.queue_bound = int(queue_bound)
        if self.queue_bound < 1:
            raise UserException("queue_bound must be >= 1")
        self.linger_s = float(linger_s)
        if self.linger_s < 0.0:
            raise UserException("linger_s must be >= 0")

    def admit(self, queued_rows, new_rows):
        """Shed decision for a ``new_rows``-row request arriving over a
        ``queued_rows``-deep queue.  True = admit, False = shed (429)."""
        if new_rows < 1:
            raise UserException("Empty request")
        if new_rows > self.top:
            raise UserException(
                "Request of %d rows exceeds the ladder top %d; split it "
                "client-side" % (new_rows, self.top)
            )
        return queued_rows == 0 or queued_rows + new_rows <= self.queue_bound

    def plan(self, pending, now):
        """One scheduling decision for one free lane.

        ``pending``: sequence of ``(nb_rows, enqueued_at)`` oldest first.
        Returns ``("dispatch", (nb_requests, bucket))`` /
        ``("wait", due_at)`` / ``("idle", None)``.
        """
        if not pending:
            return ("idle", None)
        take, rows = 0, 0
        for nb_rows, _ in pending:
            if rows + nb_rows > self.top:
                break
            take += 1
            rows += nb_rows
        # take >= 1 always: admit() bounded every request at the ladder top
        if self.linger_s > 0.0 and rows < self.top:
            due_at = pending[0][1] + self.linger_s
            if now < due_at:
                return ("wait", due_at)
        return ("dispatch", (take, choose_bucket(rows, self.buckets)))


class ContinuousBatcher:
    """Lane pool + queue in front of an inference runner.

    Args:
      runner: ``(rows) -> dict`` — typically ``InferenceEngine.predict``.
        Leading-axis-``k`` ndarray values are split per request; other
        values (disagreement vectors, bucket/weights-step scalars) are
        shared by every request in the batch.
      buckets: the engine's bucket ladder (sorted ascending); the top
        bounds a single request's rows.
      queue_bound: queued-row limit beyond which ``submit`` sheds.
      nb_lanes: initial dispatch-lane count (in-flight batches); resized
        live by ``set_lanes`` within [1, ``max_lanes``].
      max_lanes: hard lane ceiling (default ``nb_lanes``); the
        autoscaler's capacity range.
      linger_s: optional coalescing window (see :class:`ContinuousPolicy`).
      clock: injectable monotonic clock (tests).
      on_batch: ``fn(rows, requests, latency_s, output)`` after each batch.
    """

    #: result keys never split per request even when their leading
    #: dimension happens to equal the batch's row count
    SHARED_KEYS = ("disagreement", "bucket", "weights_step", "active_replicas")

    def __init__(self, runner, buckets, queue_bound=256, nb_lanes=1,
                 max_lanes=None, linger_s=0.0, clock=time.monotonic,
                 on_batch=None, shared_keys=SHARED_KEYS):
        self.runner = runner
        self.policy = ContinuousPolicy(buckets, queue_bound=queue_bound,
                                       linger_s=linger_s)
        self.max_lanes = int(max_lanes) if max_lanes is not None else int(nb_lanes)
        if not 1 <= int(nb_lanes) <= self.max_lanes:
            raise UserException(
                "need 1 <= nb_lanes (%d) <= max_lanes (%d)"
                % (int(nb_lanes), self.max_lanes)
            )
        self.clock = clock
        self.on_batch = on_batch
        self.shared_keys = frozenset(shared_keys)
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._queue = []
        self._queued_rows = 0
        self._closed = False
        self._target_lanes = 0
        self._lane_threads = {}
        self._in_flight = 0
        self.batch_count = 0
        self.served_rows = 0
        self.shed_count = 0
        self.cancelled_count = 0
        #: occupancy of the last dispatched batch: (rows, bucket)
        self.last_occupancy = (0, self.policy.top)
        self.set_lanes(nb_lanes)

    # ------------------------------------------------------------------ #
    # producer side

    def submit(self, rows):
        """Enqueue ``rows`` ((k, *sample) array, k >= 1); returns a
        :class:`Ticket`.  Sheds with :class:`LoadShed` over the bound."""
        rows = np.asarray(rows)
        k = int(rows.shape[0]) if rows.ndim else 0
        with self._cond:
            if self._closed:
                raise RuntimeError("ContinuousBatcher is closed")
            if not self.policy.admit(self._queued_rows, k):
                self.shed_count += 1
                trace.instant("serve.shed", cat="serve", rows=k,
                              queued_rows=self._queued_rows)
                raise LoadShed(
                    "queue at %d/%d rows; request of %d rows shed"
                    % (self._queued_rows, self.policy.queue_bound, k)
                )
            pending = _Pending(rows, self.clock())
            self._queue.append(pending)
            self._queued_rows += k
            self._cond.notify_all()
        trace.instant("serve.enqueue", cat="serve", rows=k)
        return Ticket(self, pending)

    def _cancel(self, pending):
        """Drop a still-queued request (timed-out/cancelled Ticket)."""
        with self._cond:
            if pending in self._queue:
                self._queue.remove(pending)
                self._queued_rows -= pending.rows.shape[0]
                self.cancelled_count += 1
                removed = True
            else:
                removed = False
        if removed:
            pending.finish(error=TimeoutError(
                "request cancelled after wait timeout"
            ))
        return removed

    @property
    def queue_depth(self):
        """Queued rows awaiting dispatch (the backpressure signal)."""
        with self._lock:
            return self._queued_rows

    @property
    def in_flight(self):
        """Batches currently dispatched on a lane."""
        with self._lock:
            return self._in_flight

    @property
    def nb_lanes(self):
        """The current dispatch-lane target (the autoscaled pool size)."""
        with self._lock:
            return self._target_lanes

    # ------------------------------------------------------------------ #
    # lane pool

    def set_lanes(self, nb_lanes):
        """Resize the dispatch-lane pool live, within [1, max_lanes].

        Scale-up spawns the missing lane threads; scale-down lets excess
        lanes finish their current batch and exit — in-flight work is
        never interrupted.  Returns the new target."""
        nb_lanes = int(nb_lanes)
        if not 1 <= nb_lanes <= self.max_lanes:
            raise UserException(
                "lane count must lie in [1, %d], got %d"
                % (self.max_lanes, nb_lanes)
            )
        with self._cond:
            if self._closed:
                raise RuntimeError("ContinuousBatcher is closed")
            self._target_lanes = nb_lanes
            for index in range(nb_lanes):
                if index not in self._lane_threads:
                    thread = threading.Thread(
                        target=self._lane, args=(index,), daemon=True,
                        name="serve-lane-%d" % index,
                    )
                    self._lane_threads[index] = thread
                    thread.start()
            self._cond.notify_all()
        return nb_lanes

    def _lane(self, index):
        try:
            while True:
                with self._cond:
                    batch = None
                    while batch is None:
                        if self._closed or index >= self._target_lanes:
                            # deregister INSIDE the locked exit decision: a
                            # concurrent scale-up must not see this zombie
                            # entry and skip respawning the lane
                            self._deregister_lane(index)
                            return
                        kind, arg = self.policy.plan(
                            [(p.rows.shape[0], p.enqueued_at)
                             for p in self._queue],
                            self.clock(),
                        )
                        if kind == "dispatch":
                            nb_requests, bucket = arg
                            batch = self._queue[:nb_requests]
                            del self._queue[:nb_requests]
                            self._queued_rows -= sum(
                                p.rows.shape[0] for p in batch
                            )
                            self._in_flight += 1
                        elif kind == "wait":
                            self._cond.wait(max(0.0, arg - self.clock()))
                        else:
                            self._cond.wait()
                try:
                    self._run_batch(batch, bucket)
                finally:
                    with self._cond:
                        self._in_flight -= 1
                        # a freed lane is the wake signal continuous
                        # batching is named for: whoever queued meanwhile
                        # joins the next dispatch right now
                        self._cond.notify_all()
        finally:
            with self._cond:
                self._deregister_lane(index)
                self._cond.notify_all()

    def _deregister_lane(self, index):
        """Drop this thread's own pool registration (caller holds the
        lock).  Identity-checked: after a scale-down/up cycle the index may
        already belong to a FRESH lane thread, whose entry must survive the
        old thread's exit path."""
        if self._lane_threads.get(index) is threading.current_thread():
            self._lane_threads.pop(index, None)

    def _run_batch(self, batch, bucket):
        rows = (np.concatenate([p.rows for p in batch])
                if len(batch) > 1 else batch[0].rows)
        started = self.clock()
        try:
            with trace.span("serve.batch", cat="serve",
                            rows=int(rows.shape[0]), requests=len(batch)):
                out = self.runner(rows)
        except Exception as exc:  # surfaced per ticket, the lane survives
            for pending in batch:
                pending.finish(error=exc)
            return
        k = rows.shape[0]
        offset = 0
        for pending in batch:
            span = pending.rows.shape[0]
            result = {}
            for name, value in out.items():
                if (name not in self.shared_keys
                        and isinstance(value, np.ndarray)
                        and value.ndim >= 1 and value.shape[0] == k):
                    result[name] = value[offset:offset + span]
                else:
                    result[name] = value  # batch-shared extras
            offset += span
            pending.finish(result=result)
        with self._lock:
            self.batch_count += 1
            self.served_rows += k
            self.last_occupancy = (k, bucket)
        if self.on_batch is not None:
            self.on_batch(rows=k, requests=len(batch),
                          latency_s=self.clock() - started, output=out)

    # ------------------------------------------------------------------ #
    # lifecycle

    def close(self, timeout=5.0):
        """Stop every lane; queued requests are failed, not served.
        Idempotent; in-flight batches finish first."""
        with self._cond:
            already = self._closed
            self._closed = True
            leftovers, self._queue = self._queue, []
            self._queued_rows = 0
            threads = list(self._lane_threads.values())
            self._cond.notify_all()
        for pending in leftovers:
            pending.finish(error=RuntimeError("ContinuousBatcher closed"))
        if not already:
            for thread in threads:
                thread.join(timeout)
