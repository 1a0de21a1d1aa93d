"""Zero-downtime weight pipeline: a checkpoint watcher over hot swaps.

A copy of ``aggregathor_tpu/serve/weights.py`` (the module imports no JAX).
Serving FOLLOWS a training run: a daemon thread polls the run's snapshot
directory; when a step newer than the served one lands, the replicas
re-restore through exactly the startup path (chain-of-custody manifests
re-verified fail-closed, poison specs re-applied: a poisoned test replica
STAYS poisoned across swaps) and swap in atomically
(``InferenceEngine.swap_replicas``).  Requests keep flowing throughout: a
swap is one host-to-device copy behind the serving dispatches, never a
dropped ticket, and every response carries the ``weights_step`` its batch
ran on, so "zero wrong-weight responses" is a checkable claim.

A FAILED reload (custody violation, torn snapshot, vanished directory)
keeps the previous weights serving and is counted
(``serve_weight_swap_failures_total``): a bad snapshot must not take the
service down.  ``SIGHUP`` is the manual trigger: the CLI routes it to
``check_once(force=True)`` (re-restore even without a newer step).

The poll loop is deliberately dumb (no inotify: snapshot directories may
be network mounts) and everything decision-shaped is injectable
(``poll_steps``/``reload``/``clock``), so tests drive the whole pipeline on
synthetic steps without a filesystem or a sleep.
"""

import threading
import time

from ..obs import events
from ..obs import metrics as obs_metrics
from ..obs import trace
from ..utils import UserException, info


class CheckpointWatcher:
    """Follows a snapshot stream and hot-swaps newer weights in.

    Args:
      poll_steps: zero-arg callable -> ascending iterable of available
        checkpoint steps (typically ``Checkpoints(...).steps``); exceptions
        count as a failed check and keep the current weights.
      reload: ``reload(step)`` restores the replica set at ``step`` and
        swaps it into the engine (the CLI closes over ``load_replicas`` +
        ``swap_replicas`` + custody bookkeeping); raising keeps the
        previous weights.
      served_step: the step currently serving (None = unknown — the first
        check swaps whatever is newest).
      interval_s: poll period for the background thread.
      registry: metrics registry (default process-wide):
        ``serve_weight_checks_total``, ``serve_weight_swaps_total``,
        ``serve_weight_swap_failures_total``.
      summaries: optional ``SummaryWriter`` — one tagged
        ``serve_weight_swap`` event per applied swap.
    """

    def __init__(self, poll_steps, reload, served_step=None, interval_s=2.0,
                 registry=None, summaries=None, clock=time.monotonic):
        if interval_s <= 0.0:
            raise UserException(
                "checkpoint watcher interval must be > 0 seconds"
            )
        self.poll_steps = poll_steps
        self.reload = reload
        self.interval_s = float(interval_s)
        self.summaries = summaries
        self.clock = clock
        self.registry = (registry if registry is not None
                         else obs_metrics.REGISTRY)
        self._lock = threading.Lock()
        self._served_step = served_step
        self._thread = None
        self._stop = threading.Event()
        self._metric_names = [
            "serve_weight_checks_total", "serve_weight_swaps_total",
            "serve_weight_swap_failures_total",
        ]
        self._c_checks = self.registry.counter(
            "serve_weight_checks_total", "Snapshot-directory polls"
        )
        self._c_swaps = self.registry.counter(
            "serve_weight_swaps_total", "Hot weight swaps applied"
        )
        self._c_failures = self.registry.counter(
            "serve_weight_swap_failures_total",
            "Reloads refused or failed (previous weights kept serving)"
        )

    @property
    def served_step(self):
        with self._lock:
            return self._served_step

    def check_once(self, force=False):
        """One poll: swap in the newest step when it beats the served one
        (or unconditionally re-restore with ``force`` — the SIGHUP path).
        Returns the newly-served step, or None when nothing changed.
        Serialized: concurrent calls (poll thread vs SIGHUP) queue on the
        watcher lock, so two reloads can never interleave."""
        with self._lock:
            self._c_checks.inc()
            try:
                steps = sorted(int(s) for s in self.poll_steps())
            except Exception as exc:
                self._c_failures.inc()
                info("checkpoint watcher poll failed (still serving step "
                     "%r): %s: %s"
                     % (self._served_step, type(exc).__name__, exc))
                events.emit("serve_weight_swap_failed",
                            step=self._served_step, phase="poll",
                            error="%s: %s" % (type(exc).__name__, exc))
                return None
            if not steps:
                return None
            latest = steps[-1]
            if (not force and self._served_step is not None
                    and latest <= self._served_step):
                return None
            previous = self._served_step
            try:
                self.reload(latest)
            except Exception as exc:
                # a bad snapshot must not take the service
                # down — previous weights keep serving, the failure is a
                # counter and a log line, and the next poll retries
                self._c_failures.inc()
                info("hot swap to step %d REFUSED (still serving step %r): "
                     "%s: %s" % (latest, previous, type(exc).__name__, exc))
                events.emit("serve_weight_swap_failed", step=latest,
                            phase="reload", previous=previous,
                            error="%s: %s" % (type(exc).__name__, exc))
                return None
            self._served_step = latest
            self._c_swaps.inc()
        trace.instant("serve.weight_swap", cat="serve", step=int(latest),
                      previous=previous if previous is None else int(previous))
        events.emit("serve_weight_swap", step=latest, previous=previous,
                    forced=bool(force))
        info("hot swap: serving weights of step %d (was %r)"
             % (latest, previous))
        if self.summaries is not None:
            self.summaries.event(int(latest), "serve_weight_swap", {
                "step": int(latest),
                "previous": previous,
                "forced": bool(force),
            })
        return latest

    # ------------------------------------------------------------------ #
    # lifecycle

    def start(self):
        """Poll every ``interval_s`` seconds on a daemon thread."""
        with self._lock:
            if self._thread is not None:
                return
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="serve-weight-watcher"
            )
            thread = self._thread
        thread.start()

    def _run(self):
        while not self._stop.wait(self.interval_s):
            try:
                self.check_once()
            except Exception as exc:  # belt and braces: the loop survives
                info("checkpoint watcher check failed: %s: %s"
                     % (type(exc).__name__, exc))

    def close(self):
        self._stop.set()
        with self._lock:
            thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(5.0)
        for name in self._metric_names:
            self.registry.unregister(name)
