"""Host-side span tracer emitting Chrome trace-event JSON.

A copy of ``aggregathor_tpu/obs/trace.py`` (the module imports no JAX):
lightweight spans written as Chrome trace events (the ``{"traceEvents":
[...]}`` JSON Array Format), loadable in Perfetto / ``chrome://tracing``
beside a ``torch.profiler`` device trace (the runner's ``--trace``).  The
runner's ``--trace-file`` installs it: where a step's wall time went
(input, host gaps, the loss fetch, evaluations, summaries, the GAR probe,
checkpoint writes), per step, without a profiler.

- **Near-zero cost disabled**: tracing is off until :func:`install`; the
  disabled path of :class:`span` / :func:`instant` /
  :class:`TracedCallable` is one global ``None`` check.
- **Bounded enabled cost**: events append to an in-memory list under a
  lock (one append per span) with a hard event cap; past it events are
  counted as dropped, never written.

Usage::

    from aggregathor_tpu_torch.obs import trace
    trace.install("run.trace.json", run_id=run_id)
    with trace.span("input", cat="train", step=12):
        ...
    @trace.span("checkpoint.write")
    def save(...): ...
    trace.save()            # or trace.uninstall(save=True)

Nesting is tracked per thread (a thread-local span stack): each event
carries its stack depth and parent name in ``args``, and Perfetto nests
same-thread "X" events by time containment.  All public entry points are
thread-safe (the input pipeline's producer records ``input.gather`` and
``input.put`` from its own thread).

Beyond spans: ``Tracer.track`` allocates named synthetic tracks,
``complete_at`` lays events onto them with explicit timestamps, and
``counter`` emits "C" events Perfetto renders as numeric tracks.

Two tracers pointed at one path do not clobber each other: a tiny
``<path>.claim`` sidecar carries the live writer's (writer_pid, run_id)
from install time, and a tracer installing onto a path owned by a live
sibling writes to a pid-suffixed variant instead, while the trace file
itself is never touched before the first real save.  For the same spans
the events are the JAX package's, apart from pid and tid.
"""

import functools
import json
import os
import threading
import time

#: the process-wide installed tracer (None = tracing disabled)
_tracer = None

#: per-thread span stack for nesting (list of span names)
_local = threading.local()

#: hard cap on buffered events — a runaway loop degrades to a counted drop,
#: not an OOM (at ~150 B/event this caps the buffer around 150 MB)
MAX_EVENTS = 1_000_000

#: synthetic-track tids start here, far above any OS thread id width that
#: matters for display — named tracks (per-worker submission timelines,
#: counter tracks) must never collide with a real thread's tid
TRACK_TID_BASE = 1 << 48


def _claim_path(path):
    """The tiny sidecar holding a live tracer's (writer_pid, run_id)
    claim on ``path``.  A SIDECAR, not the trace file itself: the claim
    must exist from install time (or a second live tracer adopting the
    same path goes unnoticed for the whole run) without ever touching the
    trace file before its first real save (a metadata stub would destroy
    a dead writer's completed trace even if this run crashes unsaved)."""
    return path + ".claim"


def _write_claim(path, run_id):
    directory = os.path.dirname(path)
    if directory:
        os.makedirs(directory, exist_ok=True)
    tmp = _claim_path(path) + ".tmp"
    with open(tmp, "w") as fd:
        json.dump({"writer_pid": os.getpid(), "run_id": run_id}, fd)
    os.replace(tmp, _claim_path(path))


def _claimed_by_other(path, run_id):
    """Is ``path`` under a LIVE claim by another tracer?  True when its
    claim sidecar names a different (writer_pid, run_id) whose process is
    still alive (or is this very process — a sibling tracer).  A dead
    writer's claim is stale: overwriting its output at save time is the
    historical, expected behavior.  No sidecar = no claim."""
    try:
        with open(_claim_path(path)) as fd:
            other = json.load(fd)
    except Exception:
        return False
    pid, rid = other.get("writer_pid"), other.get("run_id")
    if pid is None:
        return False  # pre-claim-era trace: legacy file, no live writer
    try:
        pid = int(pid)
    except (TypeError, ValueError):
        return False
    if pid == os.getpid():
        # same process: ours only when the run_ids match AND identify a
        # writer (two default-None tracers are indistinguishable, so they
        # must not clobber each other — a second install in one process
        # never overwrites the first's output)
        return not (rid == run_id and rid is not None)
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False  # writer is gone: stale file
    except PermissionError:
        return True   # alive under another uid: very much a live claim
    except OSError:
        return False
    return True


def _unclaimed_path(path, run_id):
    """``path``, or a pid-suffixed variant when another LIVE tracer owns
    it, so two runner invocations pointed at the same --trace-file do not
    overwrite each other."""
    if path is None or not _claimed_by_other(path, run_id):
        return path
    root, ext = os.path.splitext(path)
    candidate = "%s.%d%s" % (root, os.getpid(), ext)
    nb = 1
    while os.path.exists(candidate) and _claimed_by_other(candidate, run_id):
        candidate = "%s.%d-%d%s" % (root, os.getpid(), nb, ext)
        nb += 1
    from ..utils import warning

    warning(
        "Trace path %r is owned by another live tracer; writing to %r "
        "instead (pass distinct --trace-file paths to silence this)"
        % (path, candidate)
    )
    return candidate


def _stack():
    stack = getattr(_local, "spans", None)
    if stack is None:
        stack = _local.spans = []
    return stack


class Tracer:
    """Event buffer + clock for one trace file.  Use the module-level
    :func:`install` / :func:`save` / :func:`uninstall` in application code;
    construct directly only in tests."""

    def __init__(self, path, run_id=None, clock=None):
        # refuse to clobber a LIVE sibling's file: two tracers pointed at
        # one path (two runner invocations) would otherwise overwrite each
        # other through last-writer-wins os.replace
        self.path = _unclaimed_path(path, run_id)
        self.run_id = run_id
        self._clock = clock if clock is not None else time.perf_counter
        self._epoch = self._clock()
        self._lock = threading.Lock()
        self._events = []
        self._named_threads = set()
        self._tracks = {}
        self.dropped = 0
        self._pid = os.getpid()
        self._events.append({
            "ph": "M", "name": "process_name", "pid": self._pid, "tid": 0,
            "args": {"name": "aggregathor_tpu"},
        })
        if self.path is not None:
            # the claim sidecar marks this path owned by (writer_pid,
            # run_id) from THIS instant — what _claimed_by_other of a
            # later tracer reads before picking its own path; the trace
            # file itself is untouched until the first real save, so a
            # dead writer's completed trace survives a run that crashes
            # before saving anything
            _write_claim(self.path, run_id)

    # ------------------------------------------------------------------ #

    def now_us(self):
        """Microseconds since tracer epoch (the trace's ``ts`` clock)."""
        return (self._clock() - self._epoch) * 1e6

    def _append(self, event, tid):
        with self._lock:
            if tid not in self._named_threads:
                self._named_threads.add(tid)
                self._events.append({
                    "ph": "M", "name": "thread_name", "pid": self._pid,
                    "tid": tid, "args": {"name": threading.current_thread().name},
                })
            if len(self._events) >= MAX_EVENTS:
                self.dropped += 1
                return
            self._events.append(event)

    def complete(self, name, start_us, dur_us, cat="host", args=None):
        """One "X" (complete) event: a span of ``dur_us`` from ``start_us``."""
        self._append({
            "ph": "X", "name": name, "cat": cat, "pid": self._pid,
            "tid": threading.get_ident(), "ts": start_us,
            "dur": max(dur_us, 0.0), "args": args or {},
        }, threading.get_ident())

    def track(self, name):
        """A stable synthetic track (tid + thread_name metadata) for
        events that belong to a LOGICAL lane rather than a host thread
        (one Perfetto track per logical worker, whichever pool thread ran
        its work).  Idempotent per name."""
        with self._lock:
            tid = self._tracks.get(name)
            if tid is None:
                tid = TRACK_TID_BASE + len(self._tracks)
                self._tracks[name] = tid
                self._named_threads.add(tid)
                self._events.append({
                    "ph": "M", "name": "thread_name", "pid": self._pid,
                    "tid": tid, "args": {"name": name},
                })
        return tid

    def complete_at(self, name, start_us, dur_us, tid, cat="host", args=None):
        """An "X" event on an EXPLICIT track with explicit timestamps:
        the retrospective form, laying events onto a track after the
        fact."""
        self._append({
            "ph": "X", "name": name, "cat": cat, "pid": self._pid,
            "tid": int(tid), "ts": float(start_us),
            "dur": max(float(dur_us), 0.0), "args": args or {},
        }, int(tid))

    def counter(self, name, value, ts=None, cat="host", series="value"):
        """A "C" (counter) event — Perfetto renders each counter name as
        its own numeric track (the per-round deadline window, arrivals,
        stale rows, bytes on wire).  ``ts`` defaults to now."""
        self._append({
            "ph": "C", "name": name, "cat": cat, "pid": self._pid,
            "tid": 0, "ts": self.now_us() if ts is None else float(ts),
            "args": {series: float(value)},
        }, 0)

    def instant(self, name, cat="host", args=None):
        """One "i" (instant) event — discrete occurrences like a guardian
        rollback decision."""
        self._append({
            "ph": "i", "s": "t", "name": name, "cat": cat, "pid": self._pid,
            "tid": threading.get_ident(), "ts": self.now_us(),
            "args": args or {},
        }, threading.get_ident())

    def save(self):
        """Write the trace (atomic: tmp + rename).  Callable repeatedly —
        each call snapshots the events so far."""
        if self.path is None:
            return None
        with self._lock:
            events = list(self._events)
            dropped = self.dropped
        payload = {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {
                "producer": "aggregathor_tpu_torch.obs.trace",
                "run_id": self.run_id,
                "writer_pid": self._pid,
                "dropped_events": dropped,
            },
        }
        directory = os.path.dirname(self.path)
        if directory:
            os.makedirs(directory, exist_ok=True)
        tmp = self.path + ".tmp"
        with open(tmp, "w") as fd:
            json.dump(payload, fd)
        os.replace(tmp, self.path)
        return self.path

    @property
    def nb_events(self):
        with self._lock:
            return len(self._events)


# --------------------------------------------------------------------- #
# module-level lifecycle


def install(path, run_id=None, clock=None):
    """Enable tracing process-wide, writing to ``path`` on :func:`save`.
    Returns the :class:`Tracer`.  Installing over a live tracer replaces it
    (the old one is saved first)."""
    global _tracer
    if _tracer is not None:
        _tracer.save()
    _tracer = Tracer(path, run_id=run_id, clock=clock)
    return _tracer


def installed():
    """The active tracer, or None when tracing is disabled."""
    return _tracer


def save():
    """Flush the active tracer to its path (no-op when disabled)."""
    if _tracer is not None:
        return _tracer.save()
    return None


def uninstall(save=True):
    """Disable tracing; optionally flush first.  Returns the written path
    (or None)."""
    global _tracer
    tracer, _tracer = _tracer, None
    if tracer is not None and save:
        return tracer.save()
    return None


# --------------------------------------------------------------------- #
# spans


class span:
    """Context manager AND decorator for one named span.

    ``with span("dispatch", cat="train", step=3): ...`` times the block;
    ``@span("checkpoint.save")`` times every call of the decorated function.
    When tracing is disabled the enter/exit path is one global ``None``
    check.  ``start()``/``stop()`` expose the manual form for spans whose
    lifetime does not nest lexically (the runner's host-gap span).
    """

    __slots__ = ("name", "cat", "args", "_t0", "_tracer")

    def __init__(self, name, cat="host", **args):
        self.name = name
        self.cat = cat
        self.args = args
        self._t0 = 0.0
        self._tracer = None

    def __enter__(self):
        tracer = _tracer
        self._tracer = tracer
        if tracer is None:
            return self
        stack = _stack()
        if self.args is not None and stack:
            self.args = dict(self.args, parent=stack[-1], depth=len(stack))
        stack.append(self.name)
        self._t0 = tracer.now_us()
        return self

    def __exit__(self, exc_type, exc, tb):
        tracer = self._tracer
        if tracer is None:
            return False
        stack = _stack()
        if stack and stack[-1] == self.name:
            stack.pop()
        args = self.args or {}
        if exc_type is not None:
            args = dict(args, error=exc_type.__name__)
        tracer.complete(self.name, self._t0, tracer.now_us() - self._t0,
                        cat=self.cat, args=args)
        return False

    # manual form (non-lexical lifetimes)
    start = __enter__

    def stop(self):
        self.__exit__(None, None, None)

    def __call__(self, fn):
        name, cat, args = self.name, self.cat, self.args

        @functools.wraps(fn)
        def wrapper(*a, **kw):
            with span(name, cat=cat, **args):
                return fn(*a, **kw)

        return wrapper


def instant(name, cat="host", **args):
    """Record an instant event (no-op when tracing is disabled)."""
    tracer = _tracer
    if tracer is not None:
        tracer.instant(name, cat=cat, args=args)


class TracedCallable:
    """Wrap a callable (a step function) so every call is a span, without
    touching the callable itself: attribute access falls through to the
    wrapped function.  ``inner`` is the unwrapped callable."""

    __slots__ = ("inner", "_name", "_cat")

    def __init__(self, name, fn, cat="dispatch"):
        object.__setattr__(self, "inner", fn)
        object.__setattr__(self, "_name", name)
        object.__setattr__(self, "_cat", cat)

    def __call__(self, *args, **kwargs):
        if _tracer is None:
            return self.inner(*args, **kwargs)
        with span(self._name, cat=self._cat):
            return self.inner(*args, **kwargs)

    def __getattr__(self, item):
        return getattr(self.inner, item)


def traced(name, fn, cat="dispatch"):
    """Shorthand: ``traced("train_step.dispatch", step_fn)``."""
    return TracedCallable(name, fn, cat=cat)


def validate_chrome_trace(payload):
    """Structural check that ``payload`` (a parsed trace file) is loadable
    Chrome trace JSON: ``traceEvents`` list, every event a dict with
    ``ph``/``name``/``pid``/``tid``, "X" events with numeric ``ts``/``dur``.
    Returns the event list; raises ``ValueError`` on violations.  Shared by
    the tests and ``chip_smoke.py``, so both assert the same schema."""
    if not isinstance(payload, dict) or not isinstance(payload.get("traceEvents"), list):
        raise ValueError("Chrome trace JSON wants a top-level traceEvents list")
    for event in payload["traceEvents"]:
        if not isinstance(event, dict):
            raise ValueError("trace event is not an object: %r" % (event,))
        for key in ("ph", "name", "pid", "tid"):
            if key not in event:
                raise ValueError("trace event missing %r: %r" % (key, event))
        if event["ph"] == "X":
            for key in ("ts", "dur"):
                if not isinstance(event.get(key), (int, float)):
                    raise ValueError("X event wants numeric %r: %r" % (key, event))
            if event["dur"] < 0:
                raise ValueError("X event with negative dur: %r" % (event,))
        elif event["ph"] == "i":
            if not isinstance(event.get("ts"), (int, float)):
                raise ValueError("i event wants numeric ts: %r" % (event,))
        elif event["ph"] == "C":
            if not isinstance(event.get("ts"), (int, float)):
                raise ValueError("C event wants numeric ts: %r" % (event,))
            args = event.get("args")
            if not isinstance(args, dict) or not args or not all(
                isinstance(v, (int, float)) for v in args.values()
            ):
                raise ValueError(
                    "C event wants a non-empty numeric args dict: %r" % (event,)
                )
    return payload["traceEvents"]
