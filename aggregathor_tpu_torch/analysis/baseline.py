"""Findings baseline: accepted violations are named, justified, and expire.

Counterpart of ``aggregathor_tpu/analysis/baseline.py``, copied.  The
gate's contract: a NEW violation fails loudly, an ACCEPTED one is checked
in here with a one-line safety argument.  The
baseline is itself linted —

- **BL001 stale entry** — a baseline entry matching no current finding:
  the violation was fixed (delete the entry) or the code moved in a way
  that changed its fingerprint (re-justify the new one).  Either way the
  baseline must not accrete dead weight that would mask a future
  regression landing on the same fingerprint.
- **BL002 empty justification** — an entry with no justification is not an
  accepted violation, it is an unreviewed one; ``--write-baseline`` emits
  empty justifications on purpose so the gate stays red until a human
  argues each one.

Format (checked in at ``aggregathor_tpu_torch/analysis/baseline.json``,
the port's own: no entry of the JAX package's carries over unchecked)::

    {"version": 1,
     "entries": [{"fingerprint": "CC001 models/datasets.py ...",
                  "justification": "single producer thread; ..."}]}

Fingerprints are line-number-free (core.Finding.fingerprint), so pure code
motion does not churn the baseline; editing the flagged statement does.
"""

import json
import os

from .core import Finding

BASELINE_VERSION = 1


def default_baseline_path():
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "baseline.json")


def load(path):
    """Parse a baseline file -> {fingerprint: justification}.  A missing
    file is an empty baseline; a malformed one raises ValueError (a gate
    must never silently run without its accept-list)."""
    if not os.path.exists(path):
        return {}
    with open(path, "r", encoding="utf-8") as fh:
        doc = json.load(fh)
    if not isinstance(doc, dict) or doc.get("version") != BASELINE_VERSION:
        raise ValueError(
            "baseline %r wants {'version': %d, 'entries': [...]}"
            % (path, BASELINE_VERSION)
        )
    entries = {}
    for entry in doc.get("entries", ()):
        if not isinstance(entry, dict) or "fingerprint" not in entry:
            raise ValueError("baseline entry %r wants a 'fingerprint'" % (entry,))
        entries[entry["fingerprint"]] = str(entry.get("justification", ""))
    return entries


def save(path, entries):
    """Write {fingerprint: justification} sorted for stable diffs."""
    doc = {
        "version": BASELINE_VERSION,
        "entries": [
            {"fingerprint": fp, "justification": entries[fp]}
            for fp in sorted(entries)
        ],
    }
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(doc, fh, indent=2, sort_keys=True)
        fh.write("\n")


def apply(findings, entries, active_codes=None):
    """Split findings against the baseline.

    Returns ``(unbaselined, baselined, issues)`` where ``issues`` are the
    baseline's own findings (BL001 stale / BL002 empty justification) —
    both gate-failing, like any unbaselined finding.

    ``active_codes``: code prefixes (``("RT", "PK", ...)``) of the checkers
    that actually RAN.  An entry owned by a checker that did not run is out
    of scope — neither matched nor stale — so a ``--checkers`` subset run
    cannot misreport the other checkers' justified entries as BL001.
    ``None`` means every checker ran (the default gate).
    """
    unbaselined, baselined = [], []
    matched = set()
    for finding in findings:
        if finding.fingerprint in entries:
            matched.add(finding.fingerprint)
            baselined.append(finding)
        else:
            unbaselined.append(finding)
    issues = []
    for fingerprint in sorted(entries):
        if active_codes is not None and not fingerprint.startswith(
            tuple("%s" % code for code in active_codes)
        ):
            continue  # owning checker did not run: out of scope this pass
        if fingerprint not in matched:
            issues.append(Finding(
                checker="baseline", code="BL001", path="analysis/baseline.json",
                line=0, scope="baseline", symbol=fingerprint,
                message="stale baseline entry %r matches no current finding "
                        "— delete it (fixed) or re-justify its successor "
                        "(moved)" % fingerprint,
            ))
        elif not entries[fingerprint].strip():
            issues.append(Finding(
                checker="baseline", code="BL002", path="analysis/baseline.json",
                line=0, scope="baseline", symbol=fingerprint,
                message="baseline entry %r has no justification: an "
                        "unreviewed acceptance is not an acceptance"
                        % fingerprint,
            ))
    return unbaselined, baselined, issues
