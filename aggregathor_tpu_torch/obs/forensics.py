"""Byzantine forensics: a per-worker reputation ledger with attribution.

The engines already compute per-step suspicion diagnostics — each worker's
squared distance to the applied aggregate (``worker_sq_dist``), the probe's
post-transport NaN-row flags (``probe.worker_nan_rows``), the reputation
EMA and quarantine counts — but the reference mindset treats them as
transient scalars: summarized, then forgotten.  Masking an attacker is not
the same as *naming* one; the accountability line of work (Kerberos-style
attributable Byzantine SGD, ByzShield — PAPERS.md) argues attribution is
what makes robust training operable.  The ledger is that memory: a
step-indexed timeline of per-worker evidence, folded into an attribution
report that says WHICH workers behaved Byzantine, over WHICH step ranges,
under WHICH chaos regime.

Evidence kinds per observed step and worker:

- ``distance``    the worker's ``worker_sq_dist`` is a robust outlier —
  above ``distance_factor`` x the median finite distance (the honest
  majority anchors the median while ``r < n/2``, the same regime where the
  GARs themselves hold);
- ``nan_row``     the worker's post-transport submission held non-finite
  coordinates (``inf`` attacks, lossy drops, dead stragglers);
- ``reputation``  the engine's reputation EMA fell below
  ``reputation_threshold`` (the quarantine signal, when enabled);
- ``rank``        the worker holds the STRICT maximum finite distance this
  step (n >= 3 only).  One rank observation means nothing — some honest
  worker is farthest every step — but *persistence* does: under a uniform
  honest spread each worker tops out ~1/n of steps, so a worker that is
  farthest far more often than that is running something (the signal that
  catches attacks subtle enough to stay under the distance factor, e.g.
  sign-flips on noisy small-batch gradients).

A worker is *suspect at a step* when any evidence fires.  Attribution is
two-tier, and both tiers run globally AND over sliding windows — an
attacker active for 10% of a long run (a time-varying chaos schedule)
must not dilute below threshold:

- **strong** (distance / nan_row / reputation): attributed when the
  strong-evidence rate reaches ``byzantine_fraction`` over the whole run
  or over any ``window`` consecutive observations;
- **rank**: attributed when the global rank rate reaches
  ``rank_fraction``, or when the rank count in some window is
  statistically impossible for an honest worker — a Binomial(L, 1/n) tail
  test at significance ``rank_alpha``, Bonferroni-corrected over the
  number of windows (so longer runs demand proportionally stronger
  evidence, and the false-positive rate stays ~``rank_alpha`` per worker
  regardless of run length).

Consecutive suspect observations merge into intervals, each carrying the
regimes it spanned — so a report line reads "worker 2: Byzantine over
steps 500-999 under ``attack=empire``".

The report serializes under schema ``aggregathor.obs.forensics.v1`` (JSON)
plus a markdown rendering.

A copy of ``aggregathor_tpu/obs/forensics.py`` (numpy only): the port's
runner feeds it under ``--forensics`` exactly as the JAX runner does, so the
two packages' reports on the same run agree.  ``note_subaggregator`` has no
caller in the port until the aggregation-tree topology is ported.
"""

import json
import math
import os
import time

import numpy as np


def binom_sf(total, successes, p):
    """Exact Binomial survival ``P(Bin(total, p) >= successes)`` — the
    honest-null tail for the rank-persistence test (no scipy dependency)."""
    successes = int(successes)
    if successes <= 0:
        return 1.0
    if successes > total or p <= 0.0:
        return 0.0
    if p >= 1.0:
        return 1.0
    log_p, log_q = math.log(p), math.log1p(-p)
    log_total = math.lgamma(total + 1)
    acc = 0.0
    for k in range(successes, total + 1):
        acc += math.exp(
            log_total - math.lgamma(k + 1) - math.lgamma(total - k + 1)
            + k * log_p + (total - k) * log_q
        )
    return min(acc, 1.0)

SCHEMA = "aggregathor.obs.forensics.v1"

#: evidence kinds that attribute on their own (``rank`` is weak — it only
#: attributes through persistence, see :meth:`ForensicsLedger.report`).
#: ``forgery`` is the secure submission layer's verdict (secure/submit.py):
#: the worker's per-step HMAC tag failed verification — cryptographic,
#: not statistical, so it is strong by construction (reject-and-name).
STRONG_EVIDENCE = ("distance", "nan_row", "reputation", "forgery")

#: report keys every per-worker record carries
WORKER_KEYS = (
    "worker", "steps_observed", "steps_suspect", "suspicion_rate",
    "strong_rate", "strong_window_rate", "rank_rate", "rank_window_count",
    "rank_p_value", "byzantine", "evidence", "intervals",
)


class ForensicsLedger:
    """Accumulates per-step suspicion evidence; renders attribution.

    Args:
      nb_workers: worker count n (evidence vectors must be length n).
      run_id: joined with trace metadata and summary lines (obs/summaries).
      distance_factor: a finite ``worker_sq_dist`` above ``factor x median``
        of the finite distances is ``distance`` evidence.  The median needs
        an honest majority — the same n > 2r regime the GARs need.
      reputation_threshold: reputation below this is ``reputation`` evidence.
      byzantine_fraction: STRONG-evidence rate at/above which a worker is
        attributed Byzantine — over the whole run or over any window.
      rank_fraction: rank-persistence rate (fraction of observed steps the
        worker held the strict maximum distance) at/above which a worker is
        attributed Byzantine — far above the ~1/n an honest worker hits.
      window: sliding-window length (observations) for the windowed tests —
        the smallest attack burst the ledger is expected to resolve.
      rank_alpha: per-worker false-positive bound of the windowed rank
        test: the max window rank count is attributed only when its
        Binomial(window, 1/n) tail probability, Bonferroni-corrected over
        all window positions, falls at/under this.
    """

    def __init__(self, nb_workers, run_id=None, distance_factor=4.0,
                 reputation_threshold=0.5, byzantine_fraction=0.5,
                 rank_fraction=0.8, window=8, rank_alpha=0.005,
                 straggler_fraction=0.25):
        if nb_workers < 1:
            raise ValueError("ForensicsLedger wants nb_workers >= 1")
        self.nb_workers = int(nb_workers)
        self.run_id = run_id
        self.distance_factor = float(distance_factor)
        self.reputation_threshold = float(reputation_threshold)
        self.byzantine_fraction = float(byzantine_fraction)
        self.rank_fraction = float(rank_fraction)
        self.window = int(window)
        self.rank_alpha = float(rank_alpha)
        self.straggler_fraction = float(straggler_fraction)
        if self.window < 1:
            raise ValueError("ForensicsLedger wants window >= 1")
        #: [(step, {worker: set(evidence)}, regime, regime_desc)] — sparse:
        #: only workers with evidence appear in the per-step dict
        self._timeline = []
        #: [(step, kind, payload)] guardian verdicts (rollback/escalation/...)
        self._guardian = []
        #: flight-recorder post-mortems (obs/flight.py) attached at
        #: rollback/crash: {at_step, reason, path, window} references the
        #: exact per-step evidence for the window that killed the run
        self._flight = []
        #: the run's causal journal (obs/events.py) cross-ref: path + event
        #: counts by type, so a post-mortem starts from ONE file
        self._journal = None
        #: [(step, level, unit, kind, payload)] sub-aggregator verdicts
        #: from the topology plane — a separate surface from worker
        #: evidence (a forged PARENT is named as a tree node, never
        #: laundered into the leaf workers it relayed)
        self._subaggregators = []
        self._steps_observed = 0

    # ------------------------------------------------------------------ #
    # ingestion

    def observe(self, step, worker_sq_dist=None, worker_nan=None,
                reputation=None, regime=None, regime_desc=None, forgery=None,
                timeout=None, stale=None):
        """One completed training step's diagnostics.  Every vector is
        length-n (or None when the engine did not compute it); non-finite
        ``worker_sq_dist`` entries are treated as masked (no ``distance``
        evidence — the NaN-row flag is the signal for dead rows).
        ``forgery`` is the submission authenticator's per-worker verdict
        (True = this worker's tag failed verification this step).
        ``timeout`` is the bounded-wait protocol's deadline verdict
        (parallel/bounded.py): a timed-out worker gets ``straggler_timeout``
        evidence, and its NaN row is EXPLAINED by the timeout — it does not
        double as ``nan_row`` strong evidence (late is not Byzantine; the
        stragglers surface in the report's own ``stragglers`` list).
        ``stale`` marks the timed-out workers whose round was served by
        their CLEVER carry instead of a NaN drop (stale infill): named
        ``stale_infill`` evidence, weak like the timeout itself, so
        late-but-honest stays distinguishable from Byzantine — while the
        row STILL spends the declared-f budget (docs/engine.md)."""
        suspects = {}
        timed_out = None
        if timeout is not None:
            timed_out = np.asarray(timeout).reshape(-1).astype(bool)
            self._check_len("timeout", timed_out)

        def mark(worker, kind):
            suspects.setdefault(int(worker), set()).add(kind)

        if timed_out is not None:
            for worker in np.nonzero(timed_out)[0]:
                mark(worker, "straggler_timeout")
        if stale is not None:
            infilled = np.asarray(stale).reshape(-1).astype(bool)
            self._check_len("stale", infilled)
            for worker in np.nonzero(infilled)[0]:
                mark(worker, "stale_infill")
        if forgery is not None:
            forged = np.asarray(forgery).reshape(-1)
            self._check_len("forgery", forged)
            for worker in np.nonzero(forged.astype(bool))[0]:
                mark(worker, "forgery")

        if worker_sq_dist is not None:
            dist = np.asarray(worker_sq_dist, np.float64).reshape(-1)
            self._check_len("worker_sq_dist", dist)
            if timed_out is not None:
                # a timeout EXPLAINS the row that replaced this worker's
                # submission (NaN drop or stale carry): its distance
                # measures the protocol's infill, not the worker's conduct
                # this step — excused from distance/rank evidence exactly
                # like the NaN-row flag below (late is not Byzantine; an
                # aging stale carry legitimately drifts from the honest
                # mean).  The row still SPENT the f budget, and a worker
                # gaming this by straggling loses its infill at
                # stale-max-age (docs/engine.md).
                dist = np.where(timed_out, np.nan, dist)
            finite = dist[np.isfinite(dist)]
            if finite.size:
                anchor = float(np.median(finite))
                # Degenerate anchor (all-zero distances: identical
                # gradients) cannot rank anyone; positive outliers over a
                # zero anchor still flag via the epsilon floor.
                floor = max(anchor * self.distance_factor, 1e-12)
                for worker in np.nonzero(np.isfinite(dist) & (dist > floor))[0]:
                    mark(worker, "distance")
                # Rank persistence (n >= 3, strict max only — an all-equal
                # spread names nobody): weak alone, attributed only when it
                # persists at rank_fraction of steps (see report()).
                if self.nb_workers >= 3 and finite.size >= 2:
                    order = np.argsort(np.where(np.isfinite(dist), dist, -np.inf))
                    top, runner_up = order[-1], order[-2]
                    if np.isfinite(dist[top]) and dist[top] > dist[runner_up]:
                        mark(top, "rank")
        if worker_nan is not None:
            nan_rows = np.asarray(worker_nan).reshape(-1)
            self._check_len("worker_nan", nan_rows)
            if timed_out is not None:
                # a timeout's NaN infill is accounted above, not as nan_row
                nan_rows = nan_rows.astype(bool) & ~timed_out
            for worker in np.nonzero(nan_rows.astype(bool))[0]:
                mark(worker, "nan_row")
        if reputation is not None:
            rep = np.asarray(reputation, np.float64).reshape(-1)
            self._check_len("reputation", rep)
            for worker in np.nonzero(rep < self.reputation_threshold)[0]:
                mark(worker, "reputation")
        self._timeline.append((
            int(step), suspects,
            None if regime is None else int(regime),
            regime_desc,
        ))
        self._steps_observed += 1

    def note_subaggregator(self, step, level, unit, kind, payload=None):
        """Record a SUB-AGGREGATOR verdict from the topology plane
        (topology/tree.py): a (level, unit) tree node whose custody tag
        failed chain verification (``forgery``), whose subtree timed out
        as a unit (``timeout``), or whose summary was served by a
        redundant sibling shadow (``reconstructed``).

        Deliberately a SEPARATE ledger surface from worker evidence: a
        forged intermediate is an infrastructure node, and naming it as a
        (level, unit) keeps the blame where the cryptography put it —
        never laundered into the leaf workers whose honest rows it
        relayed (they keep their clean per-worker records)."""
        self._subaggregators.append({
            "step": int(step),
            "level": int(level),
            "unit": int(unit),
            "kind": str(kind),
            "payload": dict(payload or {}),
        })

    def note_guardian(self, step, kind, payload=None):
        """Record a guardian verdict (``rollback``/``escalation``/
        ``recovered``) — the recovery layer's contribution to the audit
        trail."""
        self._guardian.append((int(step), str(kind), dict(payload or {})))

    def attach_flight(self, at_step, reason, path=None, window_summary=None):
        """Reference a flight-recorder post-mortem dump (obs/flight.py) in
        the report: the in-scan ring holds EXACT per-step evidence for the
        window around a rollback or crash — including the final dispatch's
        sub-steps that a cadenced feed would summarize away.  Post-mortems
        survive ``truncate_after`` (like the rollback event itself, they
        are the audit trail of the abandoned timeline)."""
        self._flight.append({
            "at_step": int(at_step),
            "reason": str(reason),
            "path": path,
            "window": dict(window_summary or {}),
        })

    def note_journal(self, path, counts_by_type):
        """Cross-reference the run's causal journal (obs/events.py) in the
        report: the path plus per-type event counts — the report says WHO
        misbehaved, the journal says WHAT the run decided about it, and
        each points at the other."""
        counts = {str(k): int(v) for k, v in dict(counts_by_type).items()}
        self._journal = {
            "path": path,
            "nb_events": int(sum(counts.values())),
            "events_by_type": counts,
        }

    def truncate_after(self, step):
        """Drop observations and guardian events beyond ``step`` — the
        abandoned timeline after a rollback (mirrors
        ``EvalFile.truncate_after``).  Returns the dropped observation
        count."""
        step = int(step)
        before = len(self._timeline)
        self._timeline = [row for row in self._timeline if row[0] <= step]
        self._guardian = [row for row in self._guardian if row[0] <= step]
        self._subaggregators = [
            row for row in self._subaggregators if row["step"] <= step
        ]
        self._steps_observed = len(self._timeline)
        return before - len(self._timeline)

    def _check_len(self, name, vector):
        if vector.shape[0] != self.nb_workers:
            raise ValueError(
                "%s has %d entries for %d workers" % (name, vector.shape[0], self.nb_workers)
            )

    # ------------------------------------------------------------------ #
    # attribution

    def report(self):
        """The attribution report (schema ``aggregathor.obs.forensics.v1``)."""
        timeline = sorted(self._timeline, key=lambda row: row[0])
        observed = len(timeline)
        length = min(self.window, observed)
        kernel = np.ones(length, np.float64) if length else None
        nb_windows = observed - length + 1 if length else 0
        workers = []
        for worker in range(self.nb_workers):
            suspect_steps = []
            evidence_counts = {}
            strong_flags = np.zeros(observed, np.float64)
            rank_flags = np.zeros(observed, np.float64)
            for index, (step, suspects, regime, desc) in enumerate(timeline):
                kinds = suspects.get(worker)
                if kinds:
                    suspect_steps.append((step, regime, desc, sorted(kinds)))
                    if any(kind in kinds for kind in STRONG_EVIDENCE):
                        strong_flags[index] = 1.0
                    if "rank" in kinds:
                        rank_flags[index] = 1.0
                    for kind in kinds:
                        evidence_counts[kind] = evidence_counts.get(kind, 0) + 1
            intervals = self._merge_intervals(timeline, suspect_steps)
            rate = len(suspect_steps) / observed if observed else 0.0
            # Two-tier attribution, global AND windowed (see module doc):
            # strong evidence at byzantine_fraction of the run or of any
            # window; rank persistence at rank_fraction of the run, or at a
            # window count statistically impossible for an honest worker
            # (Binomial tail at rank_alpha, Bonferroni over windows).
            strong_rate = float(strong_flags.sum()) / observed if observed else 0.0
            rank_rate = float(rank_flags.sum()) / observed if observed else 0.0
            strong_window_rate = 0.0
            rank_window_count = 0
            rank_p_value = 1.0
            if length:
                strong_window_rate = float(
                    np.convolve(strong_flags, kernel, "valid").max()
                ) / length
                rank_window_count = int(
                    np.convolve(rank_flags, kernel, "valid").max()
                )
                rank_p_value = min(
                    binom_sf(length, rank_window_count, 1.0 / self.nb_workers)
                    * nb_windows,
                    1.0,
                )
            workers.append({
                "worker": worker,
                "steps_observed": observed,
                "steps_suspect": len(suspect_steps),
                "suspicion_rate": rate,
                "strong_rate": strong_rate,
                "strong_window_rate": strong_window_rate,
                "rank_rate": rank_rate,
                "rank_window_count": rank_window_count,
                "rank_p_value": rank_p_value,
                "byzantine": bool(observed and (
                    strong_rate >= self.byzantine_fraction
                    or strong_window_rate >= self.byzantine_fraction
                    or rank_rate >= self.rank_fraction
                    or rank_p_value <= self.rank_alpha
                )),
                "timeout_rate": (
                    evidence_counts.get("straggler_timeout", 0) / observed
                    if observed else 0.0
                ),
                "evidence": evidence_counts,
                "intervals": intervals,
            })
        return {
            "schema": SCHEMA,
            "run_id": self.run_id,
            "generated_at": time.time(),
            "nb_workers": self.nb_workers,
            "steps_observed": len(timeline),
            "step_range": (
                [timeline[0][0], timeline[-1][0]] if timeline else None
            ),
            "thresholds": {
                "distance_factor": self.distance_factor,
                "reputation_threshold": self.reputation_threshold,
                "byzantine_fraction": self.byzantine_fraction,
                "rank_fraction": self.rank_fraction,
                "window": self.window,
                "rank_alpha": self.rank_alpha,
                "straggler_fraction": self.straggler_fraction,
            },
            "suspects": [w["worker"] for w in workers if w["byzantine"]],
            # bounded-wait deadline offenders (parallel/bounded.py): named
            # separately from Byzantine suspects — late is a capacity
            # problem, not an integrity one, but both spend the f budget
            "stragglers": [
                w["worker"] for w in workers
                if w["timeout_rate"] >= self.straggler_fraction
            ],
            "workers": workers,
            # topology-plane verdicts (topology/tree.py): per-(level, unit)
            # sub-aggregator records, aggregated from note_subaggregator —
            # ``corrupt_subaggregators`` names every tree node with a
            # custody-forgery verdict as "LEVEL.UNIT"
            "sub_aggregators": self._subaggregator_records(),
            "corrupt_subaggregators": sorted({
                "%d.%d" % (row["level"], row["unit"])
                for row in self._subaggregators if row["kind"] == "forgery"
            }),
            "guardian_events": [
                {"step": step, "kind": kind, "payload": payload}
                for step, kind, payload in self._guardian
            ],
            "flight_postmortems": list(self._flight),
            "journal": None if self._journal is None else dict(self._journal),
        }

    def _subaggregator_records(self):
        """Aggregate the sub-aggregator timeline into per-(level, unit)
        records: step span, per-kind counts, and the corrupt verdict (any
        custody forgery names the node)."""
        records = {}
        for row in self._subaggregators:
            node = (row["level"], row["unit"])
            rec = records.setdefault(node, {
                "level": row["level"], "unit": row["unit"],
                "first_step": row["step"], "last_step": row["step"],
                "steps": 0, "evidence": {},
            })
            rec["first_step"] = min(rec["first_step"], row["step"])
            rec["last_step"] = max(rec["last_step"], row["step"])
            rec["steps"] += 1
            rec["evidence"][row["kind"]] = rec["evidence"].get(row["kind"], 0) + 1
        out = []
        for node in sorted(records):
            rec = records[node]
            rec["corrupt"] = rec["evidence"].get("forgery", 0) > 0
            out.append(rec)
        return out

    @staticmethod
    def _merge_intervals(timeline, suspect_steps):
        """Merge observations suspect at CONSECUTIVE observed steps into
        [{start, end, steps, regimes, evidence}] ranges.  Consecutive means
        adjacent in the observation sequence (cadenced feeds observe every
        k-th step; a gap in the observations is not a gap in suspicion)."""
        if not suspect_steps:
            return []
        observed_order = {step: i for i, (step, _, _, _) in enumerate(timeline)}
        intervals = []
        current = None
        for step, regime, desc, kinds in suspect_steps:
            index = observed_order[step]
            if current is not None and index == current["_last_index"] + 1:
                current["end"] = step
                current["steps"] += 1
                current["_last_index"] = index
                if regime is not None and regime not in current["regimes"]:
                    current["regimes"].append(regime)
                    if desc:
                        current["regime_specs"].append(desc)
                for kind in kinds:
                    if kind not in current["evidence"]:
                        current["evidence"].append(kind)
            else:
                current = {
                    "start": step, "end": step, "steps": 1,
                    "regimes": [] if regime is None else [regime],
                    "regime_specs": [desc] if (regime is not None and desc) else [],
                    "evidence": list(kinds),
                    "_last_index": index,
                }
                intervals.append(current)
        for interval in intervals:
            del interval["_last_index"]
        return intervals

    # ------------------------------------------------------------------ #
    # output

    def save(self, path, markdown_path=None):
        """Write the JSON report (and optionally the markdown rendering).
        Returns the report dict."""
        report = self.report()
        directory = os.path.dirname(path)
        if directory:
            os.makedirs(directory, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as fd:
            json.dump(report, fd, indent=1)
            fd.write("\n")
        os.replace(tmp, path)
        if markdown_path:
            with open(markdown_path, "w") as fd:
                fd.write(render_markdown(report))
        return report


def render_markdown(report):
    """Human-readable attribution report for one ledger report dict."""
    lines = [
        "# Byzantine forensics — run %s" % (report.get("run_id") or "?"),
        "",
        "Schema `%s`; %d worker(s), %d observed step(s)%s." % (
            report["schema"], report["nb_workers"], report["steps_observed"],
            (" over steps %d-%d" % tuple(report["step_range"])
             if report.get("step_range") else ""),
        ),
        "",
    ]
    suspects = report.get("suspects", [])
    if suspects:
        lines.append("**Attributed Byzantine: worker(s) %s.**"
                     % ", ".join(str(w) for w in suspects))
    else:
        lines.append("**No worker attributed Byzantine.**")
    stragglers = report.get("stragglers", [])
    if stragglers:
        lines.append("")
        lines.append(
            "**Deadline offenders (bounded-wait): worker(s) %s.**"
            % ", ".join(str(w) for w in stragglers)
        )
    lines += [
        "",
        "| worker | suspect/observed | rate | verdict | evidence | intervals |",
        "|---:|---:|---:|---|---|---|",
    ]
    for worker in report["workers"]:
        spans = "; ".join(
            "%d-%d%s" % (
                iv["start"], iv["end"],
                (" (regime %s)" % ",".join(str(r) for r in iv["regimes"])
                 if iv["regimes"] else ""),
            )
            for iv in worker["intervals"]
        ) or "—"
        evidence = ", ".join(
            "%s x%d" % kv for kv in sorted(worker["evidence"].items())
        ) or "—"
        lines.append("| %d | %d/%d | %.2f | %s | %s | %s |" % (
            worker["worker"], worker["steps_suspect"], worker["steps_observed"],
            worker["suspicion_rate"],
            "**BYZANTINE**" if worker["byzantine"] else "honest",
            evidence, spans,
        ))
    subaggs = report.get("sub_aggregators", [])
    if subaggs:
        corrupt = report.get("corrupt_subaggregators", [])
        lines += ["", "## Sub-aggregators (topology plane)", ""]
        if corrupt:
            lines.append("**Corrupt sub-aggregator(s): %s** (custody-chain "
                         "forgery — named as tree nodes, not workers)."
                         % ", ".join(corrupt))
            lines.append("")
        lines += [
            "| node | steps | span | verdict | evidence |",
            "|---|---:|---|---|---|",
        ]
        for rec in subaggs:
            evidence = ", ".join(
                "%s x%d" % kv for kv in sorted(rec["evidence"].items())
            ) or "—"
            lines.append("| %d.%d | %d | %d-%d | %s | %s |" % (
                rec["level"], rec["unit"], rec["steps"],
                rec["first_step"], rec["last_step"],
                "**CORRUPT**" if rec["corrupt"] else "clean",
                evidence,
            ))
    events = report.get("guardian_events", [])
    if events:
        lines += ["", "## Guardian events", ""]
        for event in events:
            lines.append("- step %d: %s %s" % (
                event["step"], event["kind"],
                json.dumps(event["payload"], sort_keys=True),
            ))
    journal = report.get("journal")
    if journal:
        lines += ["", "## Run journal", ""]
        lines.append("`%s` — %d event(s): %s" % (
            journal.get("path"), journal.get("nb_events", 0),
            ", ".join(
                "%s x%d" % kv
                for kv in sorted(journal.get("events_by_type", {}).items())
            ) or "—",
        ))
    return "\n".join(lines) + "\n"
