"""CLI: ``python -m aggregathor_tpu_torch.analysis`` -- the port's graftcheck gate.

Counterpart of ``python -m aggregathor_tpu.analysis``, with its options and
one more, ``--device`` (the runner's): the gar-contract sweep runs on the
card by default and raises without a GPU, never carrying on on the CPU;
``--device cpu`` runs it through the kernels' plain versions.  The AST
checkers need no device.  Exit code 0 iff every finding is baselined with
a justification and no baseline entry is stale -- the contract
``scripts/run_torch_analysis.sh --check`` and the clean-package test
assert.  ``--write-baseline`` seeds acceptance
entries with EMPTY justifications on purpose: the gate stays red (BL002)
until a human argues each one in ``baseline.json``.
"""

import argparse
import sys

from . import (
    CHECKERS,
    active_codes,
    baseline as baseline_mod,
    report as report_mod,
    run_checkers,
)
from .core import package_root
from ..utils import resolve_device


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m aggregathor_tpu_torch.analysis",
        description="graftcheck: repo-native static analysis "
                    "(retrace, prng, concurrency, gar-contract, events)",
    )
    parser.add_argument("--root", default=None,
                        help="package root to scan (default: the installed "
                             "aggregathor_tpu_torch package)")
    parser.add_argument("--checkers", default=None,
                        help="comma-separated subset of: %s"
                             % ", ".join(sorted(CHECKERS)))
    parser.add_argument("--baseline", default=None,
                        help="baseline JSON (default: analysis/baseline.json)")
    parser.add_argument("--no-baseline", action="store_true",
                        help="ignore the baseline: report every finding raw")
    parser.add_argument("--json", dest="json_path", default=None,
                        help="write the aggregathor.analysis.report.v1 "
                             "document here")
    parser.add_argument("--write-baseline", action="store_true",
                        help="accept the current unbaselined findings into "
                             "the baseline (EMPTY justifications: the gate "
                             "stays red until each is argued)")
    parser.add_argument("--check", action="store_true",
                        help="gate mode (the default behavior, named for "
                             "scripts): exit nonzero on any unbaselined "
                             "finding or baseline issue")
    parser.add_argument("--device", default="cuda",
                        help="device of the gar-contract sweep: cuda (default; "
                             "raises without a GPU) or cpu (the kernels' plain "
                             "versions)")
    parser.add_argument("--list-checkers", action="store_true")
    parser.add_argument("-q", "--quiet", action="store_true",
                        help="summary line only")
    args = parser.parse_args(argv)

    if args.write_baseline and args.no_baseline:
        parser.error("--write-baseline with --no-baseline would overwrite "
                     "the baseline (and every justification in it) with "
                     "empty entries; drop one of the flags")

    if args.list_checkers:
        for name in sorted(CHECKERS):
            doc = (CHECKERS[name].__doc__ or "").strip().splitlines()
            print("%-14s %s" % (name, doc[0] if doc else ""))
        return 0

    root = args.root or package_root()
    checkers = args.checkers.split(",") if args.checkers else None
    if checkers:
        unknown = [c for c in checkers if c not in CHECKERS]
        if unknown:
            parser.error("unknown checker(s) %s; available: %s"
                         % (", ".join(unknown), ", ".join(sorted(CHECKERS))))
    device = resolve_device(args.device) if "gar-contract" in (checkers or CHECKERS) else None
    findings, scan_errors = run_checkers(root=root, checkers=checkers, device=device)
    findings = scan_errors + findings

    baseline_path = args.baseline or baseline_mod.default_baseline_path()
    entries = {} if args.no_baseline else baseline_mod.load(baseline_path)
    codes = active_codes(checkers)
    unbaselined, baselined, issues = baseline_mod.apply(findings, entries,
                                                        active_codes=codes)

    if args.write_baseline:
        for finding in unbaselined:
            entries.setdefault(finding.fingerprint, "")
        baseline_mod.save(baseline_path, entries)
        print("baseline: wrote %d entr%s to %s (justify each -- empty "
              "justifications keep the gate red)"
              % (len(unbaselined), "y" if len(unbaselined) == 1 else "ies",
                 baseline_path))
        unbaselined, baselined, issues = baseline_mod.apply(
            findings, entries, active_codes=codes)

    doc = report_mod.build_report(
        root=root, checkers=checkers or sorted(CHECKERS),
        unbaselined=unbaselined, baselined=baselined, issues=issues,
        baseline_path=None if args.no_baseline else baseline_path,
        justifications=entries,
    )
    if args.json_path:
        report_mod.save_report(args.json_path, report_mod.validate_report(doc))

    if not args.quiet:
        for finding in unbaselined + issues:
            print(finding.render())
        if baselined and not unbaselined and not issues:
            by_code = {}
            for f in baselined:
                by_code[f.code] = by_code.get(f.code, 0) + 1
            print("baselined: %s" % ", ".join(
                "%s x%d" % (code, count) for code, count in sorted(by_code.items())
            ))
    verdict = "clean" if doc["clean"] else "FAILING"
    print("graftcheck: %s -- %d finding(s): %d unbaselined, %d baselined, "
          "%d baseline issue(s)"
          % (verdict, doc["counts"]["total"], doc["counts"]["unbaselined"],
             doc["counts"]["baselined"], doc["counts"]["baseline_issues"]))
    return 0 if doc["clean"] else 1


if __name__ == "__main__":
    sys.exit(main())
