"""Device-side profiling: a step-windowed trace, build and memory telemetry.

Counterpart of ``aggregathor_tpu/obs/profiler.py``, rewritten over
``torch.profiler`` (the JAX module drives ``jax.profiler`` and
``jax.monitoring``).  Three instruments, host-side plumbing only:

- :class:`ProfilerWindow`: one ``torch.profiler.profile`` (CPU activities,
  and CUDA ones on the card) over an explicit step window (``--xprof A:B``
  on the runner): it opens when the step counter reaches ``A``, closes at
  ``B`` and writes one Chrome trace under ``--trace-dir``; every dispatch
  inside the window runs under a ``torch.profiler.record_function`` named
  ``train step <s>``, the counterpart of JAX's ``StepTraceAnnotation``, so
  the host spans line up with the card's kernels step by step.  Under
  ``--unroll`` the boundaries land on chunk boundaries, as in JAX.
- The ``compile_*`` families.  PyTorch has no jit cache to grow; what this
  port compiles is its kernels, built by ``ops/build.py`` (``nvcc`` for the
  CUDA sources, the C++ compiler for the host tier) into a directory keyed
  by the sources' hash.  So:

  - ``compile_backend_total`` counts the compiler runs of this process
    that finished (0 on a run whose kernels were built already), and
    ``compile_backend_seconds_total`` their wall time
    (:func:`install_compile_listener`, reading ``ops.build.BUILD_STATS``);
  - ``compile_cache_misses_total{executable=<source>}`` counts the build
    cache's misses per source (a compiler run, failed ones included), and
    each miss emits a ``compile_cache_miss`` summary event naming the
    source, its build directory's hash, the seconds and the exit code
    (:class:`CompileWatch`).
- :func:`install_memory_gauges`: ``device_memory_live_bytes`` and
  ``device_memory_peak_bytes`` as scrape-time gauges read from
  ``torch.cuda.memory_stats(device)`` (the caching allocator's current and
  peak allocated bytes).  The families are registered on every run, as the
  JAX runner registers them; on the CPU they hold no sample, as JAX's hold
  none on XLA:CPU.
"""

import contextlib
import os

import torch

from ..ops import build
from ..utils import UserException, info, warning


class ProfilerWindow:
    """One ``torch.profiler`` capture over steps ``[begin, end)``.

    ``spec`` is the CLI form ``"A:B"`` (ints, ``0 <= A < B``).  The runner
    calls :meth:`maybe_start` before each dispatch and :meth:`maybe_stop`
    after the step counter advances; :meth:`annotate` wraps the dispatch in
    a ``record_function`` while the capture is live (a ``nullcontext``
    otherwise); :meth:`close` stops a capture left open.  ``path`` is the
    trace written, once the window closed."""

    def __init__(self, spec, trace_dir, registry=None, device=None, run_id=None):
        try:
            begin, _, end = str(spec).partition(":")
            self.begin, self.end = int(begin), int(end)
        except ValueError:
            raise UserException("--xprof wants A:B step integers (got %r)" % (spec,))
        if not 0 <= self.begin < self.end:
            raise UserException("--xprof wants 0 <= A < B (got %d:%d)" % (self.begin, self.end))
        self.trace_dir = trace_dir
        self.device = torch.device(device) if device is not None else torch.device("cpu")
        self.run_id = run_id
        self.active = False
        self.done = False
        self.path = None
        self._prof = None
        self._opened_at = None
        if registry is not None:
            registry.gauge("profiler_window_active", "1 while a --xprof device capture is recording").set_function(
                lambda: 1.0 if self.active else 0.0)

    def maybe_start(self, step):
        """Open the capture when ``step`` enters the window (idempotent;
        never reopens a finished window)."""
        if self.active or self.done or step < self.begin or step >= self.end:
            return False
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.device.type == "cuda" else [])
        self._prof = profile(activities=activities)
        self._prof.start()
        self.active, self._opened_at = True, int(step)
        info("Profiler window open at step %d -> %r (steps %d:%d)" % (step, self.trace_dir, self.begin, self.end))
        return True

    def _finish(self, step):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof, self._prof = self._prof, None
        prof.stop()
        self.active, self.done = False, True
        os.makedirs(self.trace_dir, exist_ok=True)
        name = "xprof-%d-%d%s.pt.trace.json" % (self._opened_at, step, "-%s" % self.run_id if self.run_id else "")
        self.path = os.path.join(self.trace_dir, name)
        prof.export_chrome_trace(self.path)
        info("Profiler window closed at step %d (trace %r)" % (step, self.path))

    def maybe_stop(self, step):
        """Close the capture once ``step`` passed the window end."""
        if not self.active or step < self.end:
            return False
        self._finish(step)
        return True

    def annotate(self, step):
        """Context manager for one dispatch: ``record_function("train step
        <s>")`` inside the live window, a free ``nullcontext`` outside it."""
        if not self.active:
            return contextlib.nullcontext()
        return torch.profiler.record_function("train step %d" % int(step))

    def close(self, step=None):
        if self.active:
            self._finish(self._opened_at if step is None else step)
        elif not self.done:
            # e.g. the whole window fell inside one unrolled chunk, or before
            # the resume step: an empty trace dir must not read as success
            warning("--xprof window %d:%d never opened (steps advance in chunk strides and must LAND inside the "
                    "window; widen it past the unroll, or move it past the resume step)" % (self.begin, self.end))


# --------------------------------------------------------------------- #
# build telemetry


def install_compile_listener(registry):
    """``compile_backend_total`` / ``compile_backend_seconds_total``:
    scrape-time gauges over ``ops.build.BUILD_STATS``, the compiler runs of
    this process that finished and their wall time."""
    registry.gauge("compile_backend_total",
                   "Kernel builds (nvcc, c++) ops/build.py finished in this process").set_function(
        lambda: float(build.BUILD_STATS["builds"]))
    registry.gauge("compile_backend_seconds_total",
                   "Wall time of the kernel builds ops/build.py finished in this process").set_function(
        lambda: float(build.BUILD_STATS["seconds"]))


class CompileWatch:
    """Names the build-cache misses: each compiler run ``ops/build.py``
    starts increments ``compile_cache_misses_total{executable=<source>}``
    and, with a ``SummaryWriter`` attached, emits a ``compile_cache_miss``
    event naming the source, its build directory's hash, the seconds and the
    exit code.  ``misses`` keeps ``(source, hash, seconds, code)``;
    :meth:`close` stops listening."""

    def __init__(self, registry, summaries=None, step_provider=None):
        self._counter = registry.counter(
            "compile_cache_misses_total",
            "Kernel build-cache misses (a compiler run) per source",
            labelnames=("executable",),
        )
        self.summaries = summaries
        self.step_provider = step_provider
        self.misses = []
        build.add_build_listener(self.note_miss)

    def note_miss(self, source, digest, seconds, code):
        self.misses.append((source, digest, float(seconds), int(code)))
        self._counter.labels(executable=source).inc()
        if self.summaries is not None:
            step = 0
            if self.step_provider is not None:
                try:
                    step = int(self.step_provider())
                except Exception:
                    step = 0
            self.summaries.event(step, "compile_cache_miss", {
                "executable": source, "hash": digest, "seconds": float(seconds), "exit_code": int(code)})

    def close(self):
        build.remove_build_listener(self.note_miss)


# --------------------------------------------------------------------- #
# device memory gauges


def install_memory_gauges(registry, device):
    """``device_memory_live_bytes`` and ``device_memory_peak_bytes``
    (label ``device``), read at scrape time from
    ``torch.cuda.memory_stats(device)``: ``allocated_bytes.all.current`` and
    ``allocated_bytes.all.peak``.  Returns the number of devices given a
    sample: 1 on a card, 0 on the CPU (the families stay empty)."""
    live = registry.gauge("device_memory_live_bytes", "Bytes currently allocated on the device",
                          labelnames=("device",))
    peak = registry.gauge("device_memory_peak_bytes", "Peak bytes ever allocated on the device",
                          labelnames=("device",))
    device = torch.device(device)
    if device.type != "cuda":
        return 0

    def read(key):
        def value():
            try:
                return float(torch.cuda.memory_stats(device).get(key, 0.0))
            except Exception:
                return 0.0
        return value

    label = str(device.index if device.index is not None else torch.cuda.current_device())
    live.labels(device=label).set_function(read("allocated_bytes.all.current"))
    peak.labels(device=label).set_function(read("allocated_bytes.all.peak"))
    return 1
