"""Machine-readable analysis report -- schema ``aggregathor.analysis.report.v1``.

Counterpart of ``aggregathor_tpu/analysis/report.py``, copied: both
packages write the same schema, so one reader takes either report, and
``root`` tells them apart.  One JSON document per run, consumed by
``scripts/run_torch_analysis.sh`` and any CI that wants structure instead
of exit codes; ``validate_report`` is the shared schema check of the tests
and the script.
"""

import json
import time

SCHEMA = "aggregathor.analysis.report.v1"


def build_report(root, checkers, unbaselined, baselined, issues,
                 baseline_path=None, justifications=None):
    """Assemble the report document from ``baseline.apply`` output."""
    justifications = justifications or {}

    def rows(findings, status):
        out = []
        for f in findings:
            doc = f.to_json()
            doc["status"] = status
            if status == "baselined":
                doc["justification"] = justifications.get(f.fingerprint, "")
            out.append(doc)
        return out

    findings = (
        rows(unbaselined, "unbaselined")
        + rows(baselined, "baselined")
        + rows(issues, "baseline-issue")
    )
    return {
        "schema": SCHEMA,
        "generated_at": time.strftime("%Y-%m-%dT%H:%M:%S"),
        "root": root,
        "checkers": list(checkers),
        "baseline": baseline_path,
        "counts": {
            "total": len(unbaselined) + len(baselined) + len(issues),
            "unbaselined": len(unbaselined),
            "baselined": len(baselined),
            "baseline_issues": len(issues),
        },
        "clean": not unbaselined and not issues,
        "findings": findings,
    }


def validate_report(doc):
    """Raise ValueError unless ``doc`` is a well-formed v1 report."""
    if not isinstance(doc, dict):
        raise ValueError("report wants a JSON object")
    if doc.get("schema") != SCHEMA:
        raise ValueError("report schema %r wants %r" % (doc.get("schema"), SCHEMA))
    for field in ("generated_at", "root", "checkers", "counts", "clean", "findings"):
        if field not in doc:
            raise ValueError("report misses field %r" % field)
    counts = doc["counts"]
    for field in ("total", "unbaselined", "baselined", "baseline_issues"):
        if not isinstance(counts.get(field), int):
            raise ValueError("report counts miss integer %r" % field)
    if counts["total"] != len(doc["findings"]):
        raise ValueError("counts.total %d != %d findings"
                         % (counts["total"], len(doc["findings"])))
    if counts["total"] != (counts["unbaselined"] + counts["baselined"]
                           + counts["baseline_issues"]):
        raise ValueError("counts do not add up")
    statuses = {"unbaselined", "baselined", "baseline-issue"}
    for row in doc["findings"]:
        for field in ("checker", "code", "path", "line", "scope", "symbol",
                      "message", "fingerprint", "status"):
            if field not in row:
                raise ValueError("finding row misses field %r" % field)
        if row["status"] not in statuses:
            raise ValueError("finding status %r unknown" % row["status"])
    if doc["clean"] != (counts["unbaselined"] == 0 and counts["baseline_issues"] == 0):
        raise ValueError("clean flag disagrees with counts")
    return doc


def save_report(path, doc):
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(doc, fh, indent=2, sort_keys=True)
        fh.write("\n")
