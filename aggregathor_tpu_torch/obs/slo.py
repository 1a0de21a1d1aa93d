"""Regression sentinel: baseline documents and PASS/REGRESS verdicts.

A copy of ``aggregathor_tpu/obs/slo.py`` (the module imports no JAX); the
documents are the same schema, so either package's sentinel reads the
other's.  A stored baseline document (schema ``aggregathor.obs.slo.v1``,
seeded by a healthy run's ``--slo-capture``) records the throughput-shaped
metrics a run is expected to hold; at its natural end the runner compares
the live values and emits a PASS/REGRESS verdict: an ``slo_verdict``
summary event, an info line, a verdict JSON (``--slo-verdict``) and the
live ``/status`` payload.

Checked metrics (each with a direction and a relative tolerance):

- ``steps_per_s``              higher is better (steady-state throughput,
  the first call excluded: ``PerfReport``);
- ``gar_seconds_total``        lower is better (the ``--gar-probe``
  cumulative rule cost);
- ``input_overlap_fraction``   higher is better (the input pipeline's
  measured overlap).

A metric absent from the baseline, or unmeasured in the current run
(``--gar-probe`` off, no pipeline), is skipped and listed as such: a
sentinel must not make up a regression from a knob that was not enabled.
"""

import json
import os
import platform
import time

from ..utils import UserException

SCHEMA = "aggregathor.obs.slo.v1"

#: default relative tolerance when the baseline document does not carry one
DEFAULT_TOLERANCE = 0.25

#: direction per known metric: "higher" regresses when the current value
#: falls below baseline*(1-tol); "lower" when it rises above
#: baseline*(1+tol).  The serve_* entries are the serving-side SLO (the
#: same sentinel and schema, another producer).
DIRECTIONS = {
    "steps_per_s": "higher",
    "gar_seconds_total": "lower",
    "input_overlap_fraction": "higher",
    "serve_req_per_s": "higher",
    "serve_p50_ms": "lower",
    "serve_p99_ms": "lower",
}


def collect_current(registry, perf=None):
    """The live values the sentinel judges, pulled from the one metrics
    registry (plus ``PerfReport`` for throughput).  Unmeasured metrics are
    ABSENT from the result, not zero: a zero would read as an infinite
    regression for higher-is-better checks."""
    current = {}
    if perf is not None and perf.nb_steps > 1:
        current["steps_per_s"] = float(perf.steps_per_s_excl_first())
    families = {family.name: family for family in registry.families()}
    gar = families.get("gar_seconds_total")
    if gar is not None and not gar.labelnames and gar.value > 0.0:
        current["gar_seconds_total"] = float(gar.value)
    overlap = families.get("input_overlap_fraction")
    if overlap is not None and not overlap.labelnames:
        current["input_overlap_fraction"] = float(overlap.value)
    return current


def capture(path, current, run_id=None, tolerances=None, notes=None):
    """Write a baseline document from one run's measured values (atomic).
    Returns the document."""
    doc = {
        "schema": SCHEMA,
        "captured_at": time.time(),
        "run_id": run_id,
        "host": {
            "platform": platform.platform(),
            "machine": platform.machine(),
        },
        "metrics": {name: float(value) for name, value in current.items()},
        "tolerances": {
            name: float((tolerances or {}).get(name, DEFAULT_TOLERANCE))
            for name in current
        },
        "directions": {
            name: DIRECTIONS.get(name, "higher") for name in current
        },
    }
    if notes:
        doc["notes"] = str(notes)
    directory = os.path.dirname(path)
    if directory:
        os.makedirs(directory, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as fd:
        json.dump(doc, fd, indent=1)
        fd.write("\n")
    os.replace(tmp, path)
    return doc


class Sentinel:
    """Loads a baseline document and judges a run's current metrics."""

    def __init__(self, baseline):
        """``baseline`` is a document dict or a path to one.  A missing
        file or a wrong schema fails loudly AT LOAD (startup), not at run
        end — a misconfigured sentinel must not surface after an hour of
        training."""
        if isinstance(baseline, str):
            try:
                with open(baseline) as fd:
                    baseline = json.load(fd)
            except (OSError, ValueError) as exc:
                raise UserException(
                    "cannot load SLO baseline %r: %s (seed one with "
                    "--slo-capture on a healthy run)" % (baseline, exc)
                )
        if not isinstance(baseline, dict):
            raise UserException(
                "SLO baseline must be a JSON object, got %s (seed one with "
                "--slo-capture on a healthy run)" % type(baseline).__name__
            )
        if baseline.get("schema") != SCHEMA:
            raise UserException(
                "SLO baseline schema is %r, expected %r"
                % (baseline.get("schema"), SCHEMA)
            )
        if not isinstance(baseline.get("metrics"), dict) or not baseline["metrics"]:
            raise UserException("SLO baseline carries no metrics")
        self.baseline = baseline

    def verdict(self, current, run_id=None):
        """Judge ``current`` (a ``collect_current`` dict) against the
        baseline.  Returns the verdict document: per-metric checks
        (``ok``/``regressed``/``skipped``) and an overall ``"PASS"`` /
        ``"REGRESS"`` — PASS means no checked metric regressed (skipped
        metrics are listed, never counted as passes)."""
        checks = []
        regressed = 0
        for name, base in self.baseline["metrics"].items():
            base = float(base)
            tolerance = float(
                self.baseline.get("tolerances", {}).get(name, DEFAULT_TOLERANCE)
            )
            direction = self.baseline.get("directions", {}).get(
                name, DIRECTIONS.get(name, "higher")
            )
            check = {
                "metric": name,
                "baseline": base,
                "tolerance": tolerance,
                "direction": direction,
            }
            if name not in current:
                check["status"] = "skipped"
                check["current"] = None
            else:
                value = float(current[name])
                check["current"] = value
                if direction == "lower":
                    bound = base * (1.0 + tolerance)
                    ok = value <= bound
                else:
                    bound = base * (1.0 - tolerance)
                    ok = value >= bound
                check["bound"] = bound
                check["status"] = "ok" if ok else "regressed"
                regressed += 0 if ok else 1
            checks.append(check)
        return {
            "schema": SCHEMA + ".verdict",
            "run_id": run_id,
            "judged_at": time.time(),
            "baseline_run_id": self.baseline.get("run_id"),
            "baseline_captured_at": self.baseline.get("captured_at"),
            "verdict": "REGRESS" if regressed else "PASS",
            "regressed": regressed,
            "checks": checks,
        }


def save_verdict(path, verdict):
    """Write a verdict document (atomic)."""
    directory = os.path.dirname(path)
    if directory:
        os.makedirs(directory, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as fd:
        json.dump(verdict, fd, indent=1)
        fd.write("\n")
    os.replace(tmp, path)
    return verdict


def describe_verdict(verdict):
    """One info-line rendering of a verdict document."""
    parts = []
    for check in verdict["checks"]:
        if check["status"] == "skipped":
            parts.append("%s skipped" % check["metric"])
        else:
            parts.append("%s %.4g vs %.4g (%s, tol %.0f%%): %s" % (
                check["metric"], check["current"], check["baseline"],
                check["direction"], check["tolerance"] * 100.0,
                check["status"].upper(),
            ))
    return "SLO %s — %s" % (verdict["verdict"], "; ".join(parts))
