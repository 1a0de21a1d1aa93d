"""Causal run journal: typed, append-only decision events (JSONL).

Copy of ``aggregathor_tpu/obs/events.py`` (numpy and the standard library
only; the port keeps its own copy and imports nothing of the JAX package).
The schema (``aggregathor.obs.events.v2``; v1 files still load), the
declared catalog :data:`EVENT_TYPES`, the record layout and the encoding
are the JAX package's, so given the same clocks the two packages write the
same bytes and read each other's journals.

The journal is ONE append-only JSONL file per process: the decisions that
steer a run -- guardian rollback decisions, rollbacks, escalations and
recoveries, flight post-mortems, the run's start and end -- in one causal
timeline.

- **Host-side only.**  Every emit is a dict and one buffered line write;
  the step never sees the journal.
- **Typed, fail-loud.**  Every event type is declared in
  :data:`EVENT_TYPES`; emitting an undeclared type raises even when no
  journal is installed, and a keyword field may not shadow a base field.
- **Causally orderable.**  Every event carries the run id, the step it
  speaks about (None for step-less events), a ``seq`` strictly increasing
  per file, wall time (``t_wall``) and monotonic time (``t_mono``).
- **Causally linked (schema v2).**  An event may cite the event that
  triggered it through the optional ``cause`` field, a validated
  ``{"instance", "run_id", "seq"}`` reference (``instance`` None = the
  same journal); ``format_cause``/``parse_cause`` carry it across process
  boundaries as one token (the runner's ``--cause``).
- **Bounded on disk.**  A journal constructed with ``max_bytes`` rotates
  to ``path.1``, ``path.2``, ... once the live file crosses the limit;
  :func:`tail_journal` cursors follow the rotation loudly (a vanished
  segment raises, it is never skipped).
- **Cross-referenced.**  A ``flight_postmortem`` event names the dump
  path (``obs/flight.py``).
- **Near-zero cost disabled.**  ``emit`` without an installed journal is a
  dict-membership check and a return.

Non-finite floats are encoded as tagged strings (``"nan"``/``"inf"``/
``"-inf"``, the flight-recorder idiom) so every line is strict JSON;
:func:`decode_event` restores them.  :func:`load_journal` validates a
whole file.

Usage::

    from aggregathor_tpu_torch.obs import events
    events.install("run.journal.jsonl", run_id=run_id)
    events.emit("guardian_rollback", step=120, reason="spike", attempt=0)
    events.uninstall()     # flush + close
"""

import collections
import json
import os
import threading
import time

import numpy as np

SCHEMA_V1 = "aggregathor.obs.events.v1"
SCHEMA = "aggregathor.obs.events.v2"

#: schemas :func:`validate_event` accepts on load — new journals are
#: written as v2; v1 files (pre-``cause``) remain loadable forever
ACCEPTED_SCHEMAS = (SCHEMA_V1, SCHEMA)

#: the declared event catalog: type -> one-line meaning.  EVERY ``emit``
#: call must name one of these (enforced at runtime here).  The catalog is
#: the JAX package's whole, the serving, router, supervisor and topology
#: types included, so both packages validate the same journals.
EVENT_TYPES = {
    "run_start": "a process opened its journal (role, config description)",
    "run_end": "a process closed its journal (final step, verdict, "
               "cross-refs to the forensics report / flight dumps)",
    "guardian_rollback_decision": "the watchdog decided to roll back "
                                  "(reason: non-finite / spike / "
                                  "straggler_timeouts / deadline_ceiling)",
    "guardian_rollback": "a rollback executed: restore step, attempt "
                         "index, cooldown horizon",
    "guardian_escalation": "an escalation-ladder rung applied (rung spec, "
                           "resulting overrides)",
    "guardian_recovered": "the run stayed healthy long enough after a "
                          "rollback to be declared recovered",
    "deadline_window": "the adaptive bounded-wait window moved, censored, "
                       "or changed its at-ceiling verdict",
    "bounded_round": "a bounded-wait round closed with timeouts, stale "
                     "infills or skipped (still-in-flight) units",
    "forgery_verdict": "submission tags failed HMAC verification "
                       "(reject-and-name, secure/submit.py)",
    "serve_autoscale": "the serving autoscaler applied a capacity-rung "
                       "move (lanes / retired replicas)",
    "serve_weight_swap": "the weight pipeline hot-swapped a newer "
                         "snapshot in",
    "serve_weight_swap_failed": "a reload was refused or failed; previous "
                                "weights kept serving",
    "flight_postmortem": "a flight-recorder window was dumped "
                         "(cross-ref: the dump path holds the per-step "
                         "evidence)",
    "serve_drain": "a serving process entered (or finished) its SIGTERM "
                   "drain: in-flight requests complete, new traffic "
                   "re-routes through the fleet router",
    "router_route": "the fleet router assigned (or re-assigned) a client "
                    "to a backend FOR A CAUSE (reason: initial / "
                    "backend_down / drain / step_pin); steady-state "
                    "least-in-flight rebalances stay off the timeline",
    "router_shed": "the fleet router refused admission (429): every "
                   "healthy backend is saturated — a FLEET decision, "
                   "never one process's registry",
    "router_retry": "a request whose backend died mid-flight was "
                    "re-dispatched onto a live backend (exactly once)",
    "router_backend_down": "a backend transitioned to down (scrape "
                           "misses or a failed forward)",
    "router_backend_up": "a down backend recovered on a successful "
                         "scrape and re-entered the routable pool",
    "router_drain": "the router observed a backend draining and stopped "
                    "routing new traffic to it",
    "router_step_pin": "a client's weights_step pin advanced — routing "
                       "is now constrained to backends at >= this step "
                       "(the fleet-wide monotone-sequence guarantee)",
    "supervisor_restart": "the fleet supervisor restarted a dead or hung "
                          "instance (attempt index, backoff horizon, the "
                          "down-judgment evidence)",
    "supervisor_quarantine": "a crash-looping instance exhausted its "
                             "restart budget and was QUARANTINED instead "
                             "of restarted forever (flap damping)",
    "supervisor_retune": "the supervisor rewrote an instance's knobs and "
                         "gracefully restarted it — the Overrides "
                         "rebuild discipline one level up (rung spec, "
                         "the sustained-regime evidence)",
    "supervisor_rollback": "a sentinel REGRESS rolled the checkpoint "
                           "timeline back through the custody path "
                           "(restore step, discarded steps, verdict ref)",
    "supervisor_observe": "the supervisor saw a symptom but is "
                          "deliberately waiting (backoff not elapsed, "
                          "hysteresis, finished instance) — the no-op "
                          "arm of the action ladder, journaled so the "
                          "causal story has no gaps",
    "topology_level_timeout": "a tree level's bounded-wait window closed "
                              "on a straggling sub-aggregator unit — the "
                              "whole subtree timed out as one row "
                              "(topology/tree.py)",
    "topology_reconstruction": "a faulted sub-aggregator's summary was "
                               "served by a verified redundant sibling "
                               "shadow instead of spending the level's f "
                               "budget",
    "topology_corruption_verdict": "a sub-aggregator's custody tag failed "
                                   "chain verification — NAMED as a "
                                   "(level, unit) sub-aggregator, not "
                                   "laundered into worker blame",
    "stale_reweight": "a stale carry row re-entered aggregation damped by "
                      "its age coefficient c(a) = 1/(1+a) (worker, age, "
                      "coefficient — bounded-wait v3, still spends the f "
                      "budget)",
    "submesh_timeout": "a (pipe x model) submesh missed its bounded-wait "
                       "window and forfeited its k logical rows as a unit "
                       "(group, forfeited — bounded-wait v3 per-submesh "
                       "deadlines)",
}

#: fields every event carries (plus the optional ``cause``); ``emit``
#: keyword fields may not shadow them
BASE_FIELDS = ("schema", "type", "run_id", "seq", "step", "t_wall", "t_mono",
               "cause")

#: event types that ACTUATE (change the fleet) rather than observe — every
#: emit of one of these must pass an explicit ``cause=`` keyword (None is
#: legal when no journal event triggered it, e.g. a liveness restart whose
#: evidence is the ABSENCE of scrapes).
ACTION_EVENT_TYPES = frozenset((
    "supervisor_restart",
    "supervisor_quarantine",
    "supervisor_retune",
    "supervisor_rollback",
    "supervisor_observe",
    "router_retry",
    "guardian_rollback",
    "topology_level_timeout",
    "topology_corruption_verdict",
    "topology_reconstruction",
))

_undeclared_actions = ACTION_EVENT_TYPES - set(EVENT_TYPES)
if _undeclared_actions:       # fail-loud at import: the two catalogs may not drift
    raise AssertionError(
        "ACTION_EVENT_TYPES not in EVENT_TYPES: %s"
        % ", ".join(sorted(_undeclared_actions)))

#: the process-wide installed journal (None = journaling disabled)
_journal = None


def _encode(value):
    """Strict-JSON encoding: numpy scalars/arrays unwrapped, non-finite
    floats as tagged strings (the flight-recorder idiom — a journal must
    keep the difference between NaN and ±inf)."""
    if isinstance(value, dict):
        return {str(k): _encode(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_encode(v) for v in value]
    if isinstance(value, np.ndarray):
        return [_encode(v) for v in value.tolist()]
    if isinstance(value, (bool, np.bool_)):
        return bool(value)
    if isinstance(value, (int, np.integer)):
        return int(value)
    if isinstance(value, (float, np.floating)):
        value = float(value)
        if value != value:
            return "nan"
        if value in (float("inf"), float("-inf")):
            return "inf" if value > 0 else "-inf"
        return value
    if value is None or isinstance(value, str):
        return value
    return str(value)


def decode_value(value):
    """Inverse of the non-finite tagging (recursive): the exact strings
    ``"nan"``/``"inf"``/``"-inf"`` become floats again.  Event fields that
    legitimately hold those strings must spell them differently."""
    if isinstance(value, dict):
        return {k: decode_value(v) for k, v in value.items()}
    if isinstance(value, list):
        return [decode_value(v) for v in value]
    if value == "nan":
        return float("nan")
    if value == "inf":
        return float("inf")
    if value == "-inf":
        return float("-inf")
    return value


def decode_event(record):
    """A copy of one journal record with tagged non-finite floats restored."""
    return {key: decode_value(value) for key, value in record.items()}


# --------------------------------------------------------------------- #
# cause references (schema v2)

#: the exact key set of a cause reference
CAUSE_KEYS = frozenset(("instance", "run_id", "seq"))


def validate_cause(cause):
    """Structural check of one cause reference.  Returns the reference;
    raises ``ValueError`` on violations.  ``instance`` None means "the
    journal this event was written to" (resolved by the fleet merge);
    ``run_id`` None cites a record whose own run_id is null."""
    if not isinstance(cause, dict):
        raise ValueError("cause reference is not an object: %r" % (cause,))
    if set(cause) != CAUSE_KEYS:
        raise ValueError(
            "cause reference wants exactly keys %s, got %s"
            % (sorted(CAUSE_KEYS), sorted(cause)))
    if not isinstance(cause["seq"], int) or isinstance(cause["seq"], bool) \
            or cause["seq"] < 0:
        raise ValueError(
            "cause reference wants an int seq >= 0: %r" % (cause,))
    for key in ("instance", "run_id"):
        value = cause[key]
        if value is not None and not isinstance(value, str):
            raise ValueError(
                "cause reference %s must be str or null: %r" % (key, value))
    return cause


def _normalize_cause(cause):
    """Accept a validated dict or an ``(instance, run_id, seq)`` triple."""
    if isinstance(cause, (tuple, list)):
        if len(cause) != 3:
            raise ValueError(
                "cause triple wants (instance, run_id, seq), got %r" % (cause,))
        cause = {"instance": cause[0], "run_id": cause[1], "seq": cause[2]}
    return validate_cause(cause)


def cause_of(record, instance=None):
    """A cause reference citing ``record`` (a loaded journal record or an
    :meth:`Journal.emit` return value).  ``instance`` names the fleet
    instance whose journal holds the record; None = the same journal the
    citing event is written to."""
    return validate_cause({
        "instance": instance,
        "run_id": record.get("run_id"),
        "seq": record["seq"],
    })


def format_cause(cause):
    """Serialize a cause reference to the one-token wire form
    ``INSTANCE:RUN_ID:SEQ`` (empty instance/run_id encode None) — the
    router's ``X-Causal-Id`` header and the supervisor's ``--cause`` argv
    flag.  ``instance`` may not contain ``:`` (run_id may — the token
    splits instance off the front and seq off the back)."""
    cause = _normalize_cause(cause)
    instance = cause["instance"] or ""
    if ":" in instance:
        raise ValueError(
            "cause instance %r may not contain ':' (the token separator)"
            % (instance,))
    return "%s:%s:%d" % (instance, cause["run_id"] or "", cause["seq"])


def parse_cause(token):
    """Inverse of :func:`format_cause`; raises ``ValueError`` on garbage."""
    if not isinstance(token, str):
        raise ValueError("cause token is not a string: %r" % (token,))
    instance, sep, rest = token.partition(":")
    if not sep:
        raise ValueError(
            "cause token %r wants INSTANCE:RUN_ID:SEQ (instance/run_id "
            "may be empty)" % (token,))
    run_id, sep, seq = rest.rpartition(":")
    if not sep:
        raise ValueError(
            "cause token %r wants INSTANCE:RUN_ID:SEQ (instance/run_id "
            "may be empty)" % (token,))
    try:
        seq = int(seq)
    except ValueError:
        raise ValueError("cause token %r: seq %r is not an int" % (token, seq))
    return validate_cause({
        "instance": instance or None,
        "run_id": run_id or None,
        "seq": seq,
    })


class Journal:
    """One append-only JSONL journal file.  Use the module-level
    :func:`install` / :func:`emit` / :func:`uninstall` in application code;
    construct directly only in tests (clocks injectable)."""

    def __init__(self, path, run_id=None, wall_clock=None, mono_clock=None,
                 max_bytes=None):
        self.path = path
        self.run_id = run_id
        self._wall = wall_clock if wall_clock is not None else time.time
        self._mono = mono_clock if mono_clock is not None else time.monotonic
        self._lock = threading.Lock()
        self._seq = 0
        self._counts = {}
        if max_bytes is not None and (not isinstance(max_bytes, int)
                                      or max_bytes < 1):
            raise ValueError(
                "journal max_bytes must be a positive int or None, got %r"
                % (max_bytes,))
        self.max_bytes = max_bytes
        directory = os.path.dirname(path)
        if directory:
            os.makedirs(directory, exist_ok=True)
        # a resumed run may find rotated segments from its predecessor:
        # continue the numbering instead of overwriting history
        self._nb_rotations = 0
        while os.path.exists("%s.%d" % (path, self._nb_rotations + 1)):
            self._nb_rotations += 1
        # append mode: a journal survives the process that wrote it and a
        # resumed run extends the same causal file instead of replacing it
        self._fd = open(path, "a")

    def _rotate_locked(self):
        """Roll the live file to ``path.N`` and start a fresh segment file
        (seq restarts at 0 — each segment file validates standalone and the
        cross-file chain reads as a resumed segment)."""
        self._fd.close()
        self._nb_rotations += 1
        os.replace(self.path, "%s.%d" % (self.path, self._nb_rotations))
        self._fd = open(self.path, "a")
        self._seq = 0

    @property
    def nb_rotations(self):
        """How many ``path.N`` segment files this journal has rolled."""
        with self._lock:
            return self._nb_rotations

    def emit(self, etype, step=None, cause=None, **fields):
        """Append one event; returns the written record (decoded form).
        ``cause`` optionally cites the triggering event — a validated
        reference dict (:func:`validate_cause`) or an ``(instance, run_id,
        seq)`` triple."""
        if etype not in EVENT_TYPES:
            raise ValueError(
                "undeclared journal event type %r (declare it in "
                "obs.events.EVENT_TYPES; registered: %s)"
                % (etype, ", ".join(sorted(EVENT_TYPES)))
            )
        clash = sorted(set(fields) & set(BASE_FIELDS))
        if clash:
            raise ValueError(
                "journal event %r fields %r shadow the base fields" % (etype, clash)
            )
        if cause is not None:
            cause = _normalize_cause(cause)
        with self._lock:
            if self._fd is None:
                raise ValueError(
                    "journal %r is closed; emit of %r refused" % (self.path, etype)
                )
            record = {
                "schema": SCHEMA,
                "type": etype,
                "run_id": self.run_id,
                "seq": self._seq,
                "step": None if step is None else int(step),
                "t_wall": self._wall(),
                "t_mono": self._mono(),
            }
            if cause is not None:
                record["cause"] = cause
            record.update(_encode(fields))
            self._seq += 1
            self._counts[etype] = self._counts.get(etype, 0) + 1
            self._fd.write(json.dumps(record) + "\n")
            self._fd.flush()
            # rotate AFTER the write: a record never splits across segments
            if self.max_bytes is not None and self._fd.tell() >= self.max_bytes:
                self._rotate_locked()
        return record

    def counts_by_type(self):
        """{event_type: emitted count} for THIS journal instance — what the
        forensics report's ``journal`` section records."""
        with self._lock:
            return dict(self._counts)

    @property
    def nb_events(self):
        with self._lock:
            return self._seq

    def close(self):
        with self._lock:
            if self._fd is not None:
                self._fd.close()
                self._fd = None


# --------------------------------------------------------------------- #
# module-level lifecycle (the trace.py shape)


def install(path, run_id=None, wall_clock=None, mono_clock=None,
            max_bytes=None):
    """Enable journaling process-wide, appending to ``path``.  Installing
    over a live journal closes the old one first."""
    global _journal
    if _journal is not None:
        _journal.close()
    _journal = Journal(path, run_id=run_id, wall_clock=wall_clock,
                       mono_clock=mono_clock, max_bytes=max_bytes)
    return _journal


def installed():
    """The active journal, or None when journaling is disabled."""
    return _journal


def emit(etype, step=None, cause=None, **fields):
    """Append one event to the installed journal (validates the type even
    when disabled — an undeclared emit must fail in every configuration)."""
    journal = _journal
    if journal is None:
        if etype not in EVENT_TYPES:
            raise ValueError(
                "undeclared journal event type %r (declare it in "
                "obs.events.EVENT_TYPES)" % (etype,)
            )
        return None
    return journal.emit(etype, step=step, cause=cause, **fields)


def uninstall():
    """Disable journaling; flush + close.  Returns the journal's path (or
    None when nothing was installed)."""
    global _journal
    journal, _journal = _journal, None
    if journal is not None:
        journal.close()
        return journal.path
    return None


# --------------------------------------------------------------------- #
# validation + load (tests, smoke scripts, /fleet/journal)


def validate_event(record):
    """Structural check of one journal record (encoded form).  Returns the
    record; raises ``ValueError`` on violations."""
    if not isinstance(record, dict):
        raise ValueError("journal event is not an object: %r" % (record,))
    schema = record.get("schema")
    if schema not in ACCEPTED_SCHEMAS:
        raise ValueError(
            "expected schema in %s, got %r" % (list(ACCEPTED_SCHEMAS), schema)
        )
    cause = record.get("cause")
    if cause is not None:
        if schema == SCHEMA_V1:
            raise ValueError(
                "journal event carries a cause under schema %r (cause "
                "references are v2): %r" % (schema, record))
        try:
            validate_cause(cause)
        except ValueError as exc:
            raise ValueError("journal event cause: %s" % (exc,))
    etype = record.get("type")
    if etype not in EVENT_TYPES:
        raise ValueError("undeclared journal event type %r" % (etype,))
    if not isinstance(record.get("seq"), int) or record["seq"] < 0:
        raise ValueError("journal event wants an int seq >= 0: %r" % (record,))
    step = record.get("step")
    if step is not None and not isinstance(step, int):
        raise ValueError("journal event step must be int or null: %r" % (step,))
    for key in ("t_wall", "t_mono"):
        if not isinstance(record.get(key), (int, float)):
            raise ValueError(
                "journal event wants numeric %r: %r" % (key, record)
            )
    run_id = record.get("run_id")
    if run_id is not None and not isinstance(run_id, str):
        raise ValueError("journal event run_id must be str or null: %r" % (run_id,))
    return record


#: resumable read position in one journal: ``offset`` is the byte offset
#: of the first unread line IN THE FILE CURRENTLY BEING READ, ``line`` the
#: 1-based number that line will carry in error messages, ``segment`` how
#: many seq-restart segments have been consumed, ``last_seq`` the seq of
#: the last validated record (None before the first), and ``rotated`` how
#: many rolled ``path.N`` files have been fully consumed (the cursor
#: currently points into ``path.{rotated+1}`` if that file exists, else
#: the live ``path``).  Immutable — each :func:`tail_journal` call returns
#: a NEW cursor, so a caller can retry a failed poll from the old one.
TailCursor = collections.namedtuple(
    "TailCursor", ("offset", "line", "segment", "last_seq", "rotated"),
    defaults=(0,))

#: the start-of-file cursor (segment 0, nothing consumed yet)
TAIL_START = TailCursor(offset=0, line=1, segment=0, last_seq=None, rotated=0)


def _validate_line(nb, line, last_seq):
    """Parse + validate ONE journal line against the chain state.  The
    single validation path under both :func:`load_journal` and
    :func:`tail_journal` — contiguity semantics cannot drift between the
    whole-file and incremental readers.  Returns ``(record, resumed)``
    where ``resumed`` flags a new segment (seq restarted at 0)."""
    try:
        record = json.loads(line)
    except json.JSONDecodeError as exc:
        raise ValueError("journal line %d does not parse: %s" % (nb, exc))
    try:
        validate_event(record)
    except ValueError as exc:
        raise ValueError("journal line %d: %s" % (nb, exc))
    if last_seq is not None:
        if record["seq"] not in (last_seq + 1, 0):
            raise ValueError(
                "journal line %d: seq %d breaks the chain "
                "(previous %d wants %d, or 0 for a resumed "
                "segment)" % (nb, record["seq"], last_seq, last_seq + 1)
            )
        return record, record["seq"] == 0
    if record["seq"] != 0:
        raise ValueError(
            "journal line %d: first segment must start at seq 0, "
            "got %d" % (nb, record["seq"])
        )
    return record, False


def load_journal(path):
    """Load + validate one journal file.  Returns the event records in file
    order (encoded form — see :func:`decode_event`); raises ``ValueError``
    on schema violations or a broken ``seq`` chain: within a segment each
    seq must be exactly the previous + 1, and a new segment (an appended
    resume — same or different run_id) must begin at 0.  Two processes
    interleaving appends into one file break contiguity within a line or
    two and fail here — point concurrent writers at DISTINCT paths (the
    fleet collector merges them)."""
    # A whole-file load of a missing journal is an error (the fleet
    # collector reports it as "not written yet") — only the incremental
    # tail treats missing-at-start-of-file as an empty poll.
    with open(path, "rb"):
        pass
    records, _ = tail_journal(path)
    return records


def _tail_file(path, offset, nb, segment, last_seq, allow_missing,
               finalize=False):
    """Read + validate one physical file from ``offset`` on.  Returns
    ``(records, offset, nb, segment, last_seq)``.  ``finalize`` marks a
    rotated (closed) segment: a torn trailing line there is permanent
    damage and raises instead of being deferred to the next poll."""
    records = []
    try:
        fd = open(path, "rb")
    except OSError:
        if offset or not allow_missing:
            raise ValueError(
                "journal %r vanished behind its tail cursor (offset %d)"
                % (path, offset))
        return records, offset, nb, segment, last_seq
    with fd:
        fd.seek(0, os.SEEK_END)
        size = fd.tell()
        if size < offset:
            raise ValueError(
                "journal %r shrank below its tail cursor (size %d < "
                "offset %d): truncated or replaced behind the reader"
                % (path, size, offset))
        fd.seek(offset)
        while True:
            line = fd.readline()
            if not line:
                break
            if not line.endswith(b"\n"):
                if finalize:
                    raise ValueError(
                        "rotated journal segment %r ends mid-line at "
                        "offset %d: the writer can never finish it"
                        % (path, offset))
                break     # a writer mid-append: re-read next poll
            offset += len(line)
            stripped = line.strip()
            if stripped:
                record, resumed = _validate_line(
                    nb, stripped.decode("utf-8"), last_seq)
                if resumed:
                    segment += 1
                last_seq = record["seq"]
                records.append(record)
            nb += 1
    return records, offset, nb, segment, last_seq


def tail_journal(path, cursor=None):
    """Incremental :func:`load_journal`: read + validate only the records
    appended since ``cursor`` (a :data:`TailCursor` from a previous call;
    None or :data:`TAIL_START` reads from the beginning).  Returns
    ``(new_records, next_cursor)``.

    The chain check continues ACROSS calls — the cursor carries the
    (segment, seq) position, so a seq break at a poll boundary fails
    exactly as it would in one whole-file load.  A trailing line without
    its newline (a writer mid-append) is left for the next call rather
    than half-parsed; a file shorter than the cursor's offset (truncated
    or replaced behind the reader) raises.  Missing file with a
    start-of-file cursor is an empty poll — the supervisor tails journals
    of instances that have not opened them yet.

    Rotation-aware: when the writer rolled the live file to ``path.N``
    (``Journal(max_bytes=...)``), the cursor follows — it finishes the
    rolled segment it was reading, then advances through younger segments
    to the live file.  A rotated segment that vanished or was torn behind
    the cursor raises (rotation must never silently drop history)."""
    if cursor is None:
        cursor = TAIL_START
    offset, nb, segment, last_seq, rotated = cursor
    records = []
    while True:
        rolled = "%s.%d" % (path, rotated + 1)
        if not os.path.exists(rolled):
            if os.path.exists("%s.%d" % (path, rotated + 2)):
                raise ValueError(
                    "rotated journal segment %r vanished behind its tail "
                    "cursor (younger segments exist)" % (rolled,))
            break
        # the file the cursor points into was rolled to ``rolled`` (or it
        # is an older rolled segment not yet consumed): finish it whole,
        # then restart at the top of the next file
        got, offset, nb, segment, last_seq = _tail_file(
            rolled, offset, nb, segment, last_seq, allow_missing=False,
            finalize=True)
        records.extend(got)
        rotated += 1
        offset = 0
        nb = 1
    # a missing live file at offset 0 is an empty poll (not opened yet, or
    # the writer is between its rotation rename and the fresh open)
    got, offset, nb, segment, last_seq = _tail_file(
        path, offset, nb, segment, last_seq, allow_missing=(offset == 0))
    records.extend(got)
    return records, TailCursor(offset=offset, line=nb, segment=segment,
                               last_seq=last_seq, rotated=rotated)


def counts_by_type(records):
    """{event_type: count} over loaded records (load_journal output)."""
    counts = {}
    for record in records:
        counts[record["type"]] = counts.get(record["type"], 0) + 1
    return counts
