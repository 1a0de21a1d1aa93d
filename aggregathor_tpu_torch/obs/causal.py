"""The causal plane's reader half: N journals in, ONE verified story out.

A copy of ``aggregathor_tpu/obs/causal.py`` (the module imports no JAX).
Journals (``obs/events.py``) are per-process truths; schema v2's ``cause``
references, ``(instance, run_id, seq)`` edges stamped at every boundary
crossing, let this module put them back together:

- :func:`merge_streams`: the deterministic, EDGE-RESPECTING merge.  Within
  one instance the journal's own order is law; across instances events
  interleave by wall clock with ``(t_wall, instance)`` tie-breaking, except
  that an event whose ``cause`` cites a not-yet-merged record of another
  stream waits for its cause; an inversion is reported as a measured skew.
- :func:`audit`: the causal DAG checks behind the postmortem verdict
  (dangling cause references, orphan actions, incomplete spawn chains,
  rollbacks that fail to name their sentinel verdict).
- :func:`run_postmortem` / :func:`render_story`: load every journal
  strictly, merge, audit, and emit the ``aggregathor.obs.postmortem.v1``
  report plus a human story.

Everything here is pure over the loaded records: no clocks, no sockets.
"""

import os

from . import events as obs_events

#: the postmortem report schema (BENCHMARKS.md schema index)
POSTMORTEM_SCHEMA = "aggregathor.obs.postmortem.v1"

#: action types whose conviction IS their payload — detections at the
#: edge of observability (a timeout window expiring, a signature failing
#: verification): nothing upstream of them exists in any journal to cite,
#: so a missing cause edge is not an orphan for these.
SELF_EVIDENT_ACTIONS = frozenset((
    "topology_level_timeout",
    "topology_corruption_verdict",
))

#: spawn-shaped actions: each must be answered by a later ``run_start``
#: citing it (chain completeness), provided the spawned instance keeps a
#: journal at all — a crash-looper one-liner with no journal is
#: unobservable and cannot fail the verdict.
SPAWN_ACTIONS = frozenset(("supervisor_restart", "supervisor_retune"))


def load_stream(path):
    """Whole-journal load for postmortems: :func:`~.events.load_journal`
    semantics (validation, seq-chain, rotation-aware) but STRICT about the
    tail — the incremental readers defer a line without its newline to the
    writer's next append, a postmortem has no next append.  Unconsumed
    trailing bytes mean the journal was truncated or torn: raises
    ``ValueError`` (destroyed evidence must flip the verdict, not vanish)."""
    with open(path, "rb"):
        pass                    # missing journal is the caller's error entry
    records, cursor = obs_events.tail_journal(path)
    try:
        size = os.path.getsize(path)
    except OSError:
        size = cursor.offset
    if size > cursor.offset:
        raise ValueError(
            "journal %r ends mid-line at offset %d (%d trailing bytes "
            "never got their newline): truncated or torn tail"
            % (path, cursor.offset, size - cursor.offset))
    return records


def _ref_key(cause, own_instance):
    """A cause reference's resolution key; ``instance`` None means the
    citing event's own journal."""
    instance = cause.get("instance")
    return (instance if instance is not None else own_instance,
            cause.get("run_id"), cause["seq"])


def merge_streams(streams):
    """Merge per-instance record lists into one causally ordered timeline.

    ``streams``: ``{instance_name: [records in file order]}``.  Returns
    ``(events, report)``.  Each merged event is a COPY stamped with
    ``instance`` (the owning journal — the fleet payload contract); a
    record whose own ``instance`` field that stamp would shadow (the
    supervisor's acted-on target) keeps it under ``subject``.

    ``report`` carries the cross-instance clock story: per-ordered-pair
    skew samples (an effect merged after a cause that carries a LATER
    wall clock), the count of forced emissions (cause cycles — broken by
    wall clock rather than deadlocking), and ambiguous reference keys
    (seq restarts under one run_id — rotated segments — make a key
    non-unique; references to those resolve to the first occurrence)."""
    names = sorted(streams)
    # --- identity pre-pass: which (instance, run_id, seq) keys exist ---
    first_t_wall = {}
    ambiguous = set()
    for name in names:
        for record in streams[name]:
            key = (name, record.get("run_id"), record["seq"])
            if key in first_t_wall:
                ambiguous.add(key)
            else:
                first_t_wall[key] = record.get("t_wall")
    # --- the k-way edge-respecting merge ------------------------------
    position = {name: 0 for name in names}
    emitted = set()
    merged = []
    skew = {}
    forced = 0

    def order_key(item):
        name, record = item
        return (record.get("t_wall", 0.0), name)

    while True:
        heads = [(name, streams[name][position[name]])
                 for name in names if position[name] < len(streams[name])]
        if not heads:
            break
        eligible = []
        for name, record in heads:
            cause = record.get("cause")
            if cause is None:
                eligible.append((name, record))
                continue
            target = _ref_key(cause, name)
            if (target[0] == name          # same stream: file order is law
                    or target not in first_t_wall   # dangling: audit's job
                    or target in ambiguous          # non-unique: best effort
                    or target in emitted):
                eligible.append((name, record))
        if eligible:
            name, record = min(eligible, key=order_key)
        else:
            # every head waits on a not-yet-merged cause: a reference
            # cycle.  Break it by wall clock — the merge must always
            # terminate, and the audit reports the cycle's dangling half.
            name, record = min(heads, key=order_key)
            forced += 1
        position[name] += 1
        emitted.add((name, record.get("run_id"), record["seq"]))
        out = dict(record, instance=name)
        if "instance" in record and record["instance"] != name:
            out["subject"] = record["instance"]
        merged.append(out)
        # --- skew: effect wall clock earlier than its cause's ---------
        cause = record.get("cause")
        if cause is not None:
            target = _ref_key(cause, name)
            cause_t = first_t_wall.get(target)
            effect_t = record.get("t_wall")
            if (target[0] != name and cause_t is not None
                    and effect_t is not None and effect_t < cause_t):
                pair = "%s->%s" % (target[0], name)
                sample = skew.setdefault(
                    pair, {"samples": 0, "max_seconds": 0.0})
                sample["samples"] += 1
                sample["max_seconds"] = max(
                    sample["max_seconds"], float(cause_t - effect_t))
    report = {
        "skew_pairs": skew,
        "forced_order": forced,
        "ambiguous_refs": [
            {"instance": k[0], "run_id": k[1], "seq": k[2]}
            for k in sorted(ambiguous,
                            key=lambda k: (k[0], k[1] or "", k[2]))],
    }
    return merged, report


def audit(streams):
    """The causal DAG checks over loaded streams.  Returns
    ``(chains, violations, edges_total)`` — ``chains`` the reconstructed
    cross-process stories (spawn chains answered, rollbacks naming their
    verdicts), ``violations`` the failure lists behind the verdict."""
    names = set(streams)
    exists = set()
    for name in names:
        for record in streams[name]:
            exists.add((name, record.get("run_id"), record["seq"]))
    dangling, unresolvable, orphans, incomplete, chains = [], [], [], [], []
    edges = 0
    # run_start citations: which action keys got answered by a spawn
    answered = {}
    for name in names:
        for record in streams[name]:
            if record.get("type") != "run_start":
                continue
            cause = record.get("cause")
            if cause is None:
                continue
            answered[_ref_key(cause, name)] = {
                "instance": name, "run_id": record.get("run_id"),
                "seq": record["seq"]}
    for name in sorted(names):
        for record in streams[name]:
            etype = record.get("type")
            cause = record.get("cause")
            where = {"instance": name, "type": etype,
                     "run_id": record.get("run_id"), "seq": record["seq"]}
            if cause is not None:
                edges += 1
                target = _ref_key(cause, name)
                if target not in exists:
                    entry = dict(where, cause={
                        "instance": target[0], "run_id": target[1],
                        "seq": target[2]})
                    if target[0] in names:
                        dangling.append(entry)
                    else:
                        # the cited journal was not given to this
                        # postmortem: reported, but not a verdict failure
                        # — absence of input is not absence of cause
                        unresolvable.append(entry)
            if etype in obs_events.ACTION_EVENT_TYPES:
                if (cause is None and etype not in SELF_EVIDENT_ACTIONS
                        and not record.get("evidence")):
                    orphans.append(where)
                if etype == "supervisor_rollback":
                    verdict_id = (record.get("evidence") or {}).get(
                        "verdict_id")
                    if not verdict_id:
                        incomplete.append(dict(
                            where, missing="evidence.verdict_id (the "
                            "sentinel verdict this rollback answers)"))
                    else:
                        chains.append({
                            "kind": "verdict_rollback", "action": where,
                            "verdict_id": verdict_id})
                if etype in SPAWN_ACTIONS:
                    subject = record.get("instance")
                    key = (name, record.get("run_id"), record["seq"])
                    spawned = answered.get(key)
                    if spawned is not None:
                        chains.append({
                            "kind": "spawn", "action": dict(
                                where, subject=subject),
                            "run_start": spawned})
                    elif subject in names:
                        # the spawned instance journals — its run_start
                        # MUST cite the action that spawned it
                        incomplete.append(dict(
                            where, subject=subject,
                            missing="a run_start in %r citing this %s"
                                    % (subject, etype)))
                    # a spawn subject with no journal is unobservable:
                    # neither a chain nor a violation
    violations = {
        "dangling_refs": dangling,
        "unresolvable_refs": unresolvable,
        "orphan_actions": orphans,
        "incomplete_chains": incomplete,
    }
    return chains, violations, edges


def run_postmortem(sources, include_timeline=False):
    """The whole checker: ``{instance: journal_path}`` in,
    ``aggregathor.obs.postmortem.v1`` report out.  A journal that fails
    to load (missing, truncated, seq chain broken) becomes a per-instance
    ``load_errors`` entry AND fails the verdict — a postmortem that
    silently drops a stream tells a clean story about a dirty run.

    ``include_timeline`` additionally returns the merged event list under
    a ``timeline`` key (NOT part of the report schema — callers that
    persist the report pop it first; :mod:`..cli.postmortem` feeds it to
    :func:`render_story`)."""
    streams, instances, load_errors = {}, {}, []
    for name in sorted(sources):
        path = sources[name]
        try:
            records = load_stream(path)
        except (OSError, ValueError) as exc:
            instances[name] = {"path": path, "events": 0,
                               "error": "%s: %s" % (type(exc).__name__, exc)}
            load_errors.append({"instance": name, "path": path,
                                "error": str(exc)})
            continue
        streams[name] = records
        instances[name] = {"path": path, "events": len(records),
                           "by_type": obs_events.counts_by_type(records)}
    merged, merge_report = merge_streams(streams)
    chains, violations, edges = audit(streams)
    violations["load_errors"] = load_errors
    failing = [key for key in ("dangling_refs", "orphan_actions",
                               "incomplete_chains", "load_errors")
               if violations[key]]
    extra = {"timeline": merged} if include_timeline else {}
    return dict(extra, **{
        "schema": POSTMORTEM_SCHEMA,
        "instances": instances,
        "events_total": len(merged),
        "edges_total": edges,
        "chains": chains,
        "violations": violations,
        "skew": {"pairs": merge_report["skew_pairs"],
                 "forced_order": merge_report["forced_order"],
                 "ambiguous_refs": merge_report["ambiguous_refs"]},
        "verdict": "FAIL" if failing else "PASS",
        "failing": failing,
    })


def _describe_ref(ref):
    return "%s:%s:%s" % (ref.get("instance") or "?",
                         ref.get("run_id") or "-", ref.get("seq"))


def render_story(report, merged=None):
    """The report as a markdown story (``--story``): verdict first, then
    the reconstructed chains, then every violation with its address — an
    operator reads WHY before WHAT.  Pass the merged event list (the
    ``timeline`` of ``run_postmortem(include_timeline=True)``) to append
    the full fleet timeline, each caused event carrying a
    ``└─ because:`` line naming the event it answers."""
    lines = ["# Fleet postmortem", ""]
    lines.append("**Verdict: %s**" % report["verdict"])
    if report["failing"]:
        lines.append("")
        lines.append("Failing checks: %s" % ", ".join(report["failing"]))
    lines.append("")
    lines.append("## Streams")
    lines.append("")
    lines.append("| instance | events | note |")
    lines.append("|---|---|---|")
    for name in sorted(report["instances"]):
        entry = report["instances"][name]
        lines.append("| %s | %d | %s |" % (
            name, entry.get("events", 0), entry.get("error", "ok")))
    lines.append("")
    lines.append("## Chains (%d edge(s) across %d event(s))"
                 % (report["edges_total"], report["events_total"]))
    lines.append("")
    if not report["chains"]:
        lines.append("No cross-process chains reconstructed.")
    for chain in report["chains"]:
        if chain["kind"] == "spawn":
            action = chain["action"]
            spawned = chain["run_start"]
            lines.append(
                "- **%s** of `%s` (%s) answered by `run_start` %s"
                % (action["type"], action.get("subject"),
                   _describe_ref(action), _describe_ref(spawned)))
        elif chain["kind"] == "verdict_rollback":
            action = chain["action"]
            lines.append(
                "- **supervisor_rollback** (%s) answers sentinel verdict "
                "`%s`" % (_describe_ref(action), chain["verdict_id"]))
    lines.append("")
    lines.append("## Violations")
    lines.append("")
    clean = True
    labels = (
        ("load_errors", "journal failed to load (verdict-failing)"),
        ("dangling_refs", "cause edge into nothing (verdict-failing)"),
        ("orphan_actions",
         "actuation with neither cause nor evidence (verdict-failing)"),
        ("incomplete_chains", "unanswered chain (verdict-failing)"),
        ("unresolvable_refs", "cited journal not given to this postmortem"),
    )
    for key, label in labels:
        entries = report["violations"][key]
        if not entries:
            continue
        clean = False
        lines.append("### %s — %s" % (key, label))
        lines.append("")
        for entry in entries:
            lines.append("- %s" % (entry,))
        lines.append("")
    if clean:
        lines.append("None.")
        lines.append("")
    skew = report["skew"]
    lines.append("## Clock skew")
    lines.append("")
    if skew["pairs"]:
        lines.append("| cause -> effect | inversions | max skew (s) |")
        lines.append("|---|---|---|")
        for pair in sorted(skew["pairs"]):
            sample = skew["pairs"][pair]
            lines.append("| %s | %d | %.6f |" % (
                pair, sample["samples"], sample["max_seconds"]))
    else:
        lines.append("No effect-before-cause wall-clock inversions measured.")
    if skew["forced_order"]:
        lines.append("")
        lines.append("%d event(s) force-merged through a reference cycle."
                     % skew["forced_order"])
    if merged:
        index = {}
        for record in merged:
            index[(record.get("instance"), record.get("run_id"),
                   record["seq"])] = record
        lines.append("")
        lines.append("## Timeline")
        lines.append("")
        for record in merged:
            stamp = record.get("t_wall")
            lines.append("- %s `%s` **%s** seq %d%s" % (
                "t_wall %.6f" % stamp if stamp is not None else "t_wall ?",
                record.get("instance"), record.get("type"), record["seq"],
                " (step %s)" % record["step"]
                if record.get("step") is not None else ""))
            cause = record.get("cause")
            if cause is None:
                continue
            target = _ref_key(cause, record.get("instance"))
            answered = index.get(target)
            lines.append("  - └─ because: `%s` **%s** seq %d" % (
                target[0], answered.get("type") if answered
                else "(not in this postmortem)", target[2]))
    lines.append("")
    return "\n".join(lines)
