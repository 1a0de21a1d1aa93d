"""Throughput accounting: the end-of-run performance report.

Counterpart of ``aggregathor_tpu/obs/perf.py``: the run's wall time split
into "in-graph" (from ``step_begin`` to ``step_end`` around each step) and
"off-graph" (everything between steps: batches, evaluations, checkpoints),
p50/p95/p99 of the step latency, and steps/s with and without the first
step.

What "in-graph" covers on the card: the step is dispatched asynchronously,
so the runner's window around it (the step and the divergence check, at the
JAX runner's points) holds the host's launches for the n workers' batched
pass, the aggregation and the update, and the wait for the card that the
divergence check's read of the previous losses makes -- a read queued
behind the current call's kernels, so the window ends when they do.  No synchronisation is
added for the report.

With a ``registry`` (``obs/metrics.py``) the report also exports, as the
JAX report does, ``train_steps_total``, ``train_in_graph_seconds_total`` and
the ``train_step_latency_seconds`` histogram; the printed percentiles stay
this run's own.
"""

import random
import threading
import time

from ..utils import info


class LatencyHistogram:
    """p50/p95/p99 over a bounded uniform reservoir of samples (Vitter's
    algorithm R), thread-safe."""

    #: the percentiles ``percentiles()`` reports, as (name, fraction)
    POINTS = (("p50", 0.50), ("p95", 0.95), ("p99", 0.99))

    def __init__(self, capacity=4096, seed=0):
        if capacity < 1:
            raise ValueError("LatencyHistogram capacity must be >= 1 (got %d)" % capacity)
        self.capacity = int(capacity)
        self._samples = []
        self._count = 0
        self._rng = random.Random(seed)
        self._lock = threading.Lock()

    def record(self, seconds):
        value = float(seconds)
        with self._lock:
            self._count += 1
            if len(self._samples) < self.capacity:
                self._samples.append(value)
            else:
                slot = self._rng.randrange(self._count)
                if slot < self.capacity:
                    self._samples[slot] = value

    @property
    def count(self):
        """Samples ever recorded (not just those retained)."""
        with self._lock:
            return self._count

    def percentiles(self):
        """{"p50": s, "p95": s, "p99": s} by nearest rank on the sorted
        reservoir, or None when empty."""
        with self._lock:
            if not self._samples:
                return None
            ordered = sorted(self._samples)
        last = len(ordered) - 1
        return {name: ordered[min(last, int(q * len(ordered)))] for name, q in self.POINTS}


class PerfReport:
    """The run's step accounting; the latency reservoir is this run's own
    and leaves out the first step.  With ``registry`` the accumulators are
    also exported there (get-or-create, so cumulative over the process: a
    second run in one process does not change the first's printed report)."""

    def __init__(self, registry=None):
        self.nb_steps = 0
        self.first_step_s = 0.0
        self.in_graph_s = 0.0
        self.start = time.monotonic()
        self._step_start = None
        self.latency = LatencyHistogram()
        self._registry_latency = self._steps_counter = self._in_graph_counter = None
        if registry is not None:
            self._registry_latency = registry.histogram(
                "train_step_latency_seconds", "Per-step train latency (first/compile dispatch excluded)")
            self._steps_counter = registry.counter("train_steps_total", "Completed training steps")
            self._in_graph_counter = registry.counter(
                "train_in_graph_seconds_total", "Wall time spent blocked on dispatched step programs")

    def step_begin(self):
        self._step_start = time.monotonic()

    def step_end(self, nb_steps=1):
        """Account a call covering ``nb_steps`` training steps (``--unroll``);
        the latency reservoir takes its time a step."""
        elapsed = time.monotonic() - self._step_start
        if self.nb_steps == 0:
            self.first_step_s = elapsed
        else:
            self.latency.record(elapsed / max(int(nb_steps), 1))
            if self._registry_latency is not None:
                self._registry_latency.observe(elapsed / max(int(nb_steps), 1))
        self.in_graph_s += elapsed
        self.nb_steps += int(nb_steps)
        if self._steps_counter is not None:
            self._steps_counter.inc(int(nb_steps))
            self._in_graph_counter.inc(elapsed)

    def steps_per_s_excl_first(self):
        total = time.monotonic() - self.start
        if self.nb_steps <= 1:
            return 0.0
        return (self.nb_steps - 1) / max(total - self.first_step_s, 1e-9)

    def summary(self):
        """The report's numbers, as of now."""
        total = time.monotonic() - self.start
        return {
            "steps": self.nb_steps,
            "total_s": total,
            "in_graph_s": self.in_graph_s,
            "off_graph_s": total - self.in_graph_s,
            "first_step_s": self.first_step_s,
            "latency": self.latency.percentiles(),
            "steps_per_s_all": self.nb_steps / max(total, 1e-9) if self.nb_steps > 0 else 0.0,
            "steps_per_s_excl_first": self.steps_per_s_excl_first(),
        }

    def report(self):
        """Print the report (the JAX runner's lines); returns ``summary()``."""
        out = self.summary()
        total, in_graph, off_graph = out["total_s"], out["in_graph_s"], out["off_graph_s"]
        info("Performance report:")
        info("  steps                 %d" % self.nb_steps)
        info("  total wall time       %.3f s" % total)
        info("  in-graph time         %.3f s (%.1f%%)" % (in_graph, 100.0 * in_graph / max(total, 1e-9)))
        info("  off-graph time        %.3f s (%.1f%%)" % (off_graph, 100.0 * off_graph / max(total, 1e-9)))
        info("  first (compile) step  %.3f s" % self.first_step_s)
        tail = out["latency"]
        if tail is not None:
            info("  step latency p50/p95/p99  %.1f / %.1f / %.1f ms"
                 % tuple(tail[name] * 1e3 for name, _ in LatencyHistogram.POINTS))
        if self.nb_steps > 0:
            info("  steps/s (all steps)   %.3f" % out["steps_per_s_all"])
        if self.nb_steps > 1:
            info("  steps/s (excl. 1st)   %.3f" % out["steps_per_s_excl_first"])
        return out
