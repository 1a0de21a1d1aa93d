"""The port's run journal (``aggregathor_tpu_torch/obs/events.py``) held
against the JAX package's (``aggregathor_tpu/obs/events.py``).

- the catalog, the schemas and the base fields are the JAX package's;
- the same records through both ``Journal`` classes, with the same
  injected wall and monotonic clocks, give byte-identical files: plain
  records, non-finite floats and numpy values, cause references, the
  module-level ``install``/``emit``/``uninstall``, and the segments of a
  rotating journal;
- each package reads the other's journal to the same decoded records;
- ``load_journal`` and ``tail_journal`` give the same records and cursors,
  or refuse with the same exception and text, on the same fixtures: a
  partial line, a chain break, a truncation under the cursor, a vanished
  file, a torn rotated segment, a missing journal, and each schema
  violation;
- both refuse an undeclared type (installed or not), base-field shadowing
  and an emit on a closed journal with the same exception type;
- ``format_cause``/``parse_cause`` agree on good and bad tokens.
"""

import itertools
import json
import os

import numpy as np
import pytest

from aggregathor_tpu.obs import events as jevents
from aggregathor_tpu_torch.obs import events as tevents

from torch_threads import pinned_threads  # noqa: F401  (a fixture: the xdist worker's intra-op pool)

PACKAGES = (("jax", jevents), ("port", tevents))


@pytest.fixture(autouse=True)
def _no_journal_leak():
    yield
    jevents.uninstall()
    tevents.uninstall()


def _clocks():
    """Injected wall and monotonic clocks: the same ticks for every journal."""
    wall = itertools.count(1_792_000_000.25, 0.125)
    mono = itertools.count(100.0, 0.0625)
    return (lambda: next(wall)), (lambda: next(mono))


def _outcome(fn):
    """``("ok", value)`` or ``("raised", exception type name, text)``."""
    try:
        return ("ok", fn())
    except Exception as exc:  # compared across the packages
        return ("raised", type(exc).__name__, str(exc))


def _files(path):
    """The bytes of a journal and of its rotated segments, in order."""
    out = {}
    for name in sorted(os.listdir(os.path.dirname(path))):
        if name.startswith(os.path.basename(path)):
            with open(os.path.join(os.path.dirname(path), name), "rb") as fd:
                out[name] = fd.read()
    return out


def test_catalog_and_schema_are_the_jax_packages():
    assert tevents.EVENT_TYPES == jevents.EVENT_TYPES
    assert list(tevents.EVENT_TYPES) == list(jevents.EVENT_TYPES)
    assert tevents.BASE_FIELDS == jevents.BASE_FIELDS
    assert tevents.ACTION_EVENT_TYPES == jevents.ACTION_EVENT_TYPES
    assert (tevents.SCHEMA, tevents.SCHEMA_V1, tevents.ACCEPTED_SCHEMAS) == (
        jevents.SCHEMA, jevents.SCHEMA_V1, jevents.ACCEPTED_SCHEMAS)
    assert tevents.CAUSE_KEYS == jevents.CAUSE_KEYS
    assert tuple(tevents.TAIL_START) == tuple(jevents.TAIL_START)


#: (event type, step, cause, fields) scripts written through both journals
SCRIPTS = {
    "plain": [
        ("run_start", None, None, {"role": "train", "experiment": "mnist", "aggregator": "average",
                                   "nb_workers": 8, "declared_f": 2, "pid": 4242}),
        ("guardian_rollback_decision", 2, None, {"reason": "non-finite"}),
        ("guardian_escalation", 0, None, {"rung": "f+1", "overrides": "f=3 gar=average"}),
        ("guardian_recovered", 5, None, {"attempts": 2, "healthy_streak": 5}),
        ("run_end", 30, None, {"diverged": False, "aborting": False, "forensics": None}),
    ],
    "nonfinite": [
        ("deadline_window", 4, None, {"window_s": 0.25, "target_s": float("inf"), "previous_s": float("nan"),
                                      "floor_s": float("-inf"), "at_ceiling": True, "censored": np.bool_(True)}),
        ("bounded_round", 5, None, {"deadline_s": np.float32(0.1), "nb_arrived": np.int64(6),
                                    "timed_out": np.array([0, 1]), "stale": np.array([np.nan, np.inf, 1.5]),
                                    "nested": {"a": [np.float64(-np.inf), (1, 2)], "b": None}}),
        ("guardian_rollback_decision", 9, None, {"reason": "spike", "spike": np.float32(31.5), "streak": 3}),
        ("flight_postmortem", 9, None, {"reason": "guardian_rollback", "path": None, "rows": 0,
                                        "odd": object.__new__(type("Opaque", (), {"__str__": lambda s: "opaque"}))}),
    ],
    "cause": [
        ("guardian_rollback_decision", 2, None, {"reason": "non-finite"}),
        ("guardian_rollback", 0, {"instance": None, "run_id": "r1", "seq": 0},
         {"reason": "non-finite loss at step 2", "attempt": 0, "cooldown_until": 6}),
        ("guardian_rollback", 0, ("node-a", None, 7), {"reason": "spike", "attempt": 1, "cooldown_until": 12}),
        ("run_start", None, {"instance": "sup", "run_id": "x:y", "seq": 3}, {"role": "train"}),
    ],
}


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_journals_are_byte_identical(tmp_path, script):
    paths = {}
    for label, module in PACKAGES:
        wall, mono = _clocks()
        journal = module.Journal(str(tmp_path / label / "run.jsonl"), run_id="r1", wall_clock=wall, mono_clock=mono)
        returned = [journal.emit(etype, step=step, cause=cause, **fields)
                    for etype, step, cause, fields in SCRIPTS[script]]
        assert [r["seq"] for r in returned] == list(range(len(SCRIPTS[script])))
        assert journal.nb_events == len(SCRIPTS[script])
        journal.close()
        paths[label] = journal.path
    assert _files(paths["port"]) == _files(paths["jax"])
    assert tevents.load_journal(paths["port"]) == jevents.load_journal(paths["jax"])


def test_rotating_journals_are_byte_identical(tmp_path):
    counts = {}
    for label, module in PACKAGES:
        wall, mono = _clocks()
        journal = module.Journal(str(tmp_path / label / "rot.jsonl"), run_id="rot", wall_clock=wall,
                                 mono_clock=mono, max_bytes=400)
        for i in range(12):
            journal.emit("guardian_rollback_decision", step=i, reason="spike", spike=float(i) * 7.5, streak=i)
        counts[label] = (journal.nb_rotations, journal.counts_by_type())
        journal.close()
    assert counts["port"] == counts["jax"] and counts["port"][0] >= 3
    ours, theirs = _files(str(tmp_path / "port" / "rot.jsonl")), _files(str(tmp_path / "jax" / "rot.jsonl"))
    assert ours == theirs and len(ours) == counts["port"][0] + 1
    # both tail cursors follow the rotation to the same records
    ours, theirs = (tevents.tail_journal(str(tmp_path / "port" / "rot.jsonl")),
                    jevents.tail_journal(str(tmp_path / "jax" / "rot.jsonl")))
    assert ours[0] == theirs[0] and tuple(ours[1]) == tuple(theirs[1]) and len(ours[0]) == 12


def test_module_level_install_emit_uninstall_is_byte_identical(tmp_path):
    for label, module in PACKAGES:
        wall, mono = _clocks()
        module.install(str(tmp_path / label / "j.jsonl"), run_id="m", wall_clock=wall, mono_clock=mono)
        assert module.installed() is not None
        record = module.emit("guardian_rollback_decision", step=2, reason="non-finite")
        module.emit("guardian_rollback", step=0, cause=module.cause_of(record), reason="non-finite loss at step 2",
                    attempt=0, cooldown_until=6)
        path = module.uninstall()
        assert module.installed() is None and module.uninstall() is None
        assert module.emit("run_end", step=1) is None  # declared and disabled: a no-op
        assert path == str(tmp_path / label / "j.jsonl")
    assert _files(str(tmp_path / "port" / "j.jsonl")) == _files(str(tmp_path / "jax" / "j.jsonl"))


def test_each_package_reads_the_others_journal(tmp_path):
    for label, module in PACKAGES:
        wall, mono = _clocks()
        journal = module.Journal(str(tmp_path / label / "x.jsonl"), run_id="x", wall_clock=wall, mono_clock=mono)
        for etype, step, cause, fields in SCRIPTS["nonfinite"] + SCRIPTS["cause"]:
            journal.emit(etype, step=step, cause=cause, **fields)
        journal.close()
    for reader, writer in (("port", "jax"), ("jax", "port")):
        read = dict(PACKAGES)[reader].load_journal(str(tmp_path / writer / "x.jsonl"))
        own = dict(PACKAGES)[writer].load_journal(str(tmp_path / writer / "x.jsonl"))
        assert read == own
        assert [tevents.decode_event(r) for r in read][1]["stale"][:2] == pytest.approx(
            [np.nan, np.inf], nan_ok=True)
        assert tevents.counts_by_type(read) == jevents.counts_by_type(own)


BASE = {"schema": jevents.SCHEMA, "type": "run_start", "run_id": None, "seq": 0, "step": None,
        "t_wall": 1.0, "t_mono": 1.0}


def _line(**changes):
    return json.dumps(dict(BASE, **changes)) + "\n"


#: fixture -> (the file's text before the first poll, what happens between
#: the polls: a text to append, "truncate", "remove" or None)
TAIL_FIXTURES = {
    "partial-line": (_line() + json.dumps(dict(BASE, type="run_end", seq=1)), "\n"),
    "chain-break": (_line(), _line(seq=5)),
    "resumed-segment": (_line() + _line(seq=1), _line(run_id="b")),
    "truncation": (_line() + _line(seq=1), "truncate"),
    "vanished": (_line(), "remove"),
    "missing": (None, None),
    "first-seq": (_line(seq=3), None),
}


@pytest.mark.parametrize("fixture", sorted(TAIL_FIXTURES))
def test_tail_journal_agrees_on_fixtures(tmp_path, fixture):
    first, between = TAIL_FIXTURES[fixture]
    results = {}
    for label, module in PACKAGES:
        path = str(tmp_path / ("%s.jsonl" % label))
        if first is not None:
            with open(path, "w") as fd:
                fd.write(first)
        polls = [_outcome(lambda: module.tail_journal(path))]
        if between == "truncate":
            open(path, "w").close()
        elif between == "remove":
            os.remove(path)
        elif between is not None:
            with open(path, "a") as fd:
                fd.write(between)
        if polls[0][0] == "ok":
            cursor = polls[0][1][1]
            polls.append(_outcome(lambda: module.tail_journal(path, cursor)))
        polls.append(_outcome(lambda: module.load_journal(path)))
        # the texts name the path: compare them with it taken out
        results[label] = json.loads(json.dumps(polls, default=str).replace(path, "PATH"))
    assert results["port"] == results["jax"]
    assert any(poll[0] == "raised" for poll in results["port"]) == (fixture not in ("partial-line",
                                                                                   "resumed-segment"))


def test_torn_rotated_segment_raises_in_both(tmp_path):
    results = {}
    for label, module in PACKAGES:
        path = str(tmp_path / ("%s.jsonl" % label))
        with open(path + ".1", "w") as fd:
            fd.write(_line() + json.dumps(dict(BASE, seq=1)))
        with open(path, "w") as fd:
            fd.write(_line())
        outcome = _outcome(lambda: module.tail_journal(path))
        results[label] = outcome[:2] + (outcome[2].replace(path, "PATH"),)
    assert results["port"] == results["jax"] and results["port"][0] == "raised"


VIOLATIONS = {
    "schema": _line(schema="wrong.v0"),
    "undeclared": _line(type="unknown_event"),
    "seq-repeat": _line() + _line(seq=5) + _line(seq=5),
    "t_wall": _line(t_wall="late"),
    "parse": "{not json\n",
    "v1-cause": _line(schema=jevents.SCHEMA_V1, cause={"instance": None, "run_id": None, "seq": 0}),
    "bad-cause": _line(cause={"instance": None, "seq": -1}),
    "step": _line(step="two"),
    "run_id": _line(run_id=7),
}


@pytest.mark.parametrize("violation", sorted(VIOLATIONS))
def test_load_journal_refuses_the_same_violations(tmp_path, violation):
    path = str(tmp_path / "bad.jsonl")
    with open(path, "w") as fd:
        fd.write(VIOLATIONS[violation])
    ours, theirs = _outcome(lambda: tevents.load_journal(path)), _outcome(lambda: jevents.load_journal(path))
    assert ours == theirs and ours[:2] == ("raised", "ValueError")


REFUSALS = {
    "undeclared-installed": (True, lambda m: m.emit("no_such_event")),
    "undeclared-disabled": (False, lambda m: m.emit("no_such_event")),
    "shadowing": (True, lambda m: m.emit("run_start", seq=7)),
    "shadowing-cause-field": (True, lambda m: m.emit("run_start", t_wall=1.0)),
    "bad-cause": (True, lambda m: m.emit("run_start", cause=("a", "b"))),
}


@pytest.mark.parametrize("refusal", sorted(REFUSALS))
def test_both_refuse_alike(tmp_path, refusal):
    install, emit = REFUSALS[refusal]
    outcomes = []
    for label, module in PACKAGES:
        if install:
            module.install(str(tmp_path / ("%s.jsonl" % label)), run_id="r")
        outcomes.append(_outcome(lambda: emit(module)))
        module.uninstall()
    assert outcomes[0] == outcomes[1] and outcomes[0][:2] == ("raised", "ValueError")


def test_emit_on_a_closed_journal_refuses_in_both(tmp_path):
    outcomes = []
    for label, module in PACKAGES:
        journal = module.Journal(str(tmp_path / ("%s.jsonl" % label)))
        journal.close()
        outcome = _outcome(lambda: journal.emit("run_end"))
        outcomes.append(outcome[:2] + (outcome[2].replace(label, "X"),))
    assert outcomes[0] == outcomes[1] and outcomes[0][1] == "ValueError"


@pytest.mark.parametrize("token", ["node-a:run-1:7", ":run:0", "::3", "a:x:y:12", "no-separator", "a:b:c",
                                   "a:b:-1", 17])
def test_cause_tokens_agree(token):
    ours, theirs = _outcome(lambda: tevents.parse_cause(token)), _outcome(lambda: jevents.parse_cause(token))
    assert ours == theirs
    if ours[0] == "ok":
        assert tevents.format_cause(ours[1]) == jevents.format_cause(theirs[1])
        assert tevents.parse_cause(tevents.format_cause(ours[1])) == ours[1]
