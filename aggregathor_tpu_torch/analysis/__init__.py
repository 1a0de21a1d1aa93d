"""graftcheck for the port: its own static-analysis pass over ``aggregathor_tpu_torch/``.

Counterpart of ``aggregathor_tpu/analysis`` (the JAX package's gate, which
stays its own), with the same module names, code families (RT, PK, CC,
GC, EV, BL, PARSE), report schema and CLI options.  Five checkers prove,
everywhere in the package, the invariants the tests only sample:

- **retrace** (``retrace.py``): no kernel built or op registered per step,
  no host read or Python branch on a tensor inside a ``torch.func``
  transform.
- **prng** (``prng.py``): every draw keyed per (seed, step, worker, tag),
  no two streams from one key, no generator minted and dropped.
- **concurrency** (``concurrency.py``): no unlocked attribute writes on
  thread-reachable code paths, no default-group collective on one.
- **gar-contract** (``gar_contract.py``): every registered GAR spec honors
  its declared contract (NaN tolerance, parse-time feasibility,
  participation scatter, dtype preservation, the int8 wire) under tiny
  concrete probes, on the card through K1-K6 and the centring, or on the
  CPU through their plain versions.
- **events** (``events_check.py``): every journal ``emit`` names an event
  type declared in ``obs/events.py`` (EV001), and every action event says
  its ``cause=`` (EV002).

Run as a CLI (``python -m aggregathor_tpu_torch.analysis``; the card by
default, ``--device cpu`` on a machine without one), as tests
(``tests/test_torch_analysis.py``) and from
``scripts/run_torch_analysis.sh``.  Accepted findings live in the port's
own ``baseline.json``, each with its justification; new findings, stale
entries and empty justifications all fail the gate.
"""

from . import (
    baseline,
    concurrency,
    core,
    events_check,
    gar_contract,
    prng,
    report,
    retrace,
)
from .core import Finding  # noqa: F401

#: name -> checker module: the registry the CLI and the tests iterate --
#: adding a checker means adding a module with ``check(modules)`` and one
#: line here
CHECKERS = {
    "retrace": retrace,
    "prng": prng,
    "concurrency": concurrency,
    "gar-contract": gar_contract,
    "events": events_check,
}

#: finding-code prefixes owned by each checker: baseline staleness (BL001)
#: is only asserted for entries whose owning checker actually ran, so a
#: ``--checkers`` subset cannot misreport the others' justified entries
CHECKER_CODES = {
    "retrace": ("RT",),
    "prng": ("PK",),
    "concurrency": ("CC",),
    "gar-contract": ("GC",),
    "events": ("EV",),
}


def active_codes(checkers=None):
    """Code prefixes for a checker selection (None = every checker ran,
    plus the scan's own PARSE findings)."""
    selected = list(CHECKERS) if checkers is None else list(checkers)
    codes = ["PARSE"]
    for name in selected:
        codes.extend(CHECKER_CODES.get(name, ()))
    return tuple(codes)


def run_checkers(root=None, paths=None, checkers=None, gar_specs=None, device="cuda"):
    """Run the selected checkers; returns (findings, scan_errors).

    AST checkers share one cached module scan (core.scan_modules) and need
    no device; the gar-contract checker ignores the scan and probes the
    live registry on ``device`` (the card unless the caller asks for the
    CPU: without a GPU it raises rather than carry on on the CPU)."""
    root = root or core.package_root()
    selected = list(CHECKERS) if checkers is None else list(checkers)
    unknown = [name for name in selected if name not in CHECKERS]
    if unknown:
        raise ValueError(
            "unknown checker(s) %r; available: %s"
            % (unknown, ", ".join(sorted(CHECKERS)))
        )
    needs_scan = any(name != "gar-contract" for name in selected)
    modules, errors = core.scan_modules(root, paths) if needs_scan else ([], [])
    findings = []
    for name in selected:
        if name == "gar-contract":
            findings.extend(gar_contract.check(specs=gar_specs, device=device))
        else:
            findings.extend(CHECKERS[name].check(modules))
    return findings, errors
