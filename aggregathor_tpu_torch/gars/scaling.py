"""n-sweep GAR scaling harness (schema ``aggregathor.gar.scaling.v1``).

Counterpart of ``aggregathor_tpu/gars/scaling.py``, with its schema, specs,
exponents, validator and table.  The flat rules (Krum, Bulyan) are
O(n^2 d) on the stacked (n, d) matrix; the composite rules (``hier``,
``bucketing`` over ``hier``) shrink the quadratic term to the group level,
so their time should grow sublinearly in n^2.  The sweep times each rule
over a worker-count grid at fixed d and turns the timings into that verdict:

- for every rule the **tail exponent** ``p = log(t_hi/t_lo) / log(n_hi/n_lo)``
  over the two largest swept n, plus a whole-grid least-squares exponent;
- a composite rule passes when its tail exponent stays below
  ``SUBLINEAR_EXPONENT_BAR``; the verdict is the conjunction over the
  composite family.  The flat rules' quadratic growth is reported
  (``flat_shows_quadratic``), not gated.

Composite specs are generated per n so the outer matrix stays at
``OUTER_ROWS`` rows (``hier:g=n/8``).

Timing protocol: every timed repetition is synchronised -- on CUDA
``torch.cuda.synchronize`` and one scalar fetched to the host -- before the
clock stops, and the median repetition is reported.  The rows are drawn on
the sweep's device from a ``torch.Generator`` seeded with n.
"""

import math
import time

import numpy as np

SCHEMA = "aggregathor.gar.scaling.v1"

#: A composite rule's tail exponent must stay below this to count as
#: "sublinear in n²" — 2.0 is the quadratic line, and the 0.5 margin keeps
#: measurement noise from waving a genuinely quadratic rule through.
SUBLINEAR_EXPONENT_BAR = 1.5

#: Informational counterpart for the flat rules: a tail exponent above this
#: reads as "the quadratic term is visible at this scale".
QUADRATIC_EXPONENT_FLOOR = 1.25

#: Target size of the outer (expensive) matrix in generated hier specs.
OUTER_ROWS = 8


def sync_fetch(out):
    """Wait for ``out``: on CUDA ``torch.cuda.synchronize`` of its device,
    then one scalar of it fetched to the host (4 bytes, not the whole
    output).  A numpy output (the native tier) is indexed on the host."""
    import torch

    if isinstance(out, (tuple, list)):
        out = out[0]
    if isinstance(out, torch.Tensor) and out.device.type == "cuda":
        torch.cuda.synchronize(out.device)
    float(out.reshape(-1)[0])


def time_aggregate(fn, reps):
    """Median per-call ms; EVERY timed output fully synced (sync_fetch of
    that rep's own output).

    The median over reps is jitter-robust and cannot go negative, unlike a
    ``t_many - t_one`` slope.  The fetch adds one scalar round trip per rep,
    which the rules under test dwarf.
    """
    sync_fetch(fn())  # warm-up: the kernels' first launch and a first sync
    times = []
    for _ in range(max(1, int(reps))):
        begin = time.perf_counter()
        sync_fetch(fn())
        times.append(time.perf_counter() - begin)
    times.sort()
    return times[len(times) // 2] * 1e3


def hier_spec(n, outer="krum", inner="median", outer_rows=OUTER_ROWS):
    """The per-n hier spec holding the outer matrix at ``outer_rows`` rows
    (g = n/outer_rows, clamped to a divisor of n — total work linear in n)."""
    g = max(1, n // outer_rows)
    while n % g:
        g -= 1
    return "hier:g=%d,inner=%s,outer=%s" % (g, inner, outer)


def nested_spec(n, outer="krum", outer_rows=OUTER_ROWS):
    """bucketing-over-hier: s=2 bucketing feeding a hier inner, the
    spec-composition cell (parenthesized sub-spec, gars/__init__.parse_spec)."""
    buckets = n // 2
    g = max(1, buckets // outer_rows)
    while buckets % g:
        g -= 1
    return "bucketing:s=2,inner=hier(g=%d,inner=median,outer=%s)" % (g, outer)


def default_rules(f):
    """The swept rule family: (name, kind, flat_ref, spec_fn(n) -> spec)."""
    del f  # the defaults are feasible at every swept n for small f
    return [
        ("krum", "flat", None, lambda n: "krum"),
        ("bulyan", "flat", None, lambda n: "bulyan"),
        ("hier-krum", "composite", "krum", lambda n: hier_spec(n, outer="krum")),
        ("hier-bulyan", "composite", "bulyan", lambda n: hier_spec(n, outer="bulyan")),
        ("bucketing-hier-krum", "composite", "krum", nested_spec),
    ]


def _fit_exponent(ns, ms):
    """Least-squares slope of log(ms) vs log(n) over the whole grid."""
    xs = np.log(np.asarray(ns, np.float64))
    ys = np.log(np.maximum(np.asarray(ms, np.float64), 1e-9))
    xs = xs - xs.mean()
    return float(np.dot(xs, ys - ys.mean()) / max(np.dot(xs, xs), 1e-12))


def _tail_exponent(ns, ms):
    """Local exponent over the two largest n — the asymptotic claim."""
    return float(
        math.log(max(ms[-1], 1e-9) / max(ms[-2], 1e-9)) / math.log(ns[-1] / ns[-2])
    )


def run_sweep(ns, d, f=1, reps=5, rules=None, progress=None, device="cuda"):
    """Sweep rules over worker counts at fixed d; returns the scaling doc.

    Every cell times one rule-only dense aggregation (``gar.aggregate(rows,
    key=0)``: the distances and the rule, the kernels on CUDA) at (n, d)
    with the per-rep-synced protocol above.  ``rules`` defaults to
    :func:`default_rules`; entries are (name, kind, flat_ref, spec_fn).
    ``device`` is where the rows live ("cuda" unless the caller asks for
    the CPU).
    """
    import torch

    from ..utils import resolve_device
    from . import instantiate

    # dedup and sort: duplicate worker counts would zero the log(n_hi/n_lo)
    # denominator in _tail_exponent
    ns = sorted({int(n) for n in ns})
    if len(ns) < 2:
        raise ValueError("the n-sweep needs at least two distinct worker counts, got %r" % (ns,))
    rules = default_rules(f) if rules is None else rules
    d = int(d)
    device = resolve_device(device)
    # n is the outer loop: one seeded fixture per n, shared by every rule and
    # released before the next n (peak memory max(ns) * d, not sum(ns) * d)
    ms_cells, spec_cells = {}, {}
    for n in ns:
        generator = torch.Generator(device=device).manual_seed(n)
        rows = torch.randn((n, d), generator=generator, dtype=torch.float32, device=device)
        for name, kind, flat_ref, spec_fn in rules:
            spec = spec_fn(n)
            spec_cells[(name, n)] = spec
            gar = instantiate(spec, n, f)
            with torch.no_grad():
                cell_ms = time_aggregate(lambda: gar.aggregate(rows, key=0), reps)
            ms_cells[(name, n)] = round(cell_ms, 4)
            if progress is not None:
                progress("%-22s n=%-4d %10.3f ms  (%s)" % (name, n, cell_ms, spec))
        del rows
    entries = []
    for name, kind, flat_ref, spec_fn in rules:
        ms_by_n = [ms_cells[(name, n)] for n in ns]
        entry = {
            "rule": name,
            "kind": kind,
            "spec_by_n": {str(n): spec_cells[(name, n)] for n in ns},
            "ms": ms_by_n,
            "tail_exponent": round(_tail_exponent(ns, ms_by_n), 3),
            "fit_exponent": round(_fit_exponent(ns, ms_by_n), 3),
        }
        if kind == "composite":
            entry["flat_ref"] = flat_ref
            entry["sublinear_in_n2"] = entry["tail_exponent"] < SUBLINEAR_EXPONENT_BAR
        entries.append(entry)

    by_name = {e["rule"]: e for e in entries}
    for entry in entries:
        ref = by_name.get(entry.get("flat_ref"))
        if ref is not None:
            entry["speedup_at_nmax"] = round(
                max(ref["ms"][-1], 1e-9) / max(entry["ms"][-1], 1e-9), 3
            )
    composites = [e for e in entries if e["kind"] == "composite"]
    flats = [e for e in entries if e["kind"] == "flat"]
    verdict = {
        # the gated claim: every composite rule escapes the n² wall
        "composite_sublinear_in_n2": all(e["sublinear_in_n2"] for e in composites),
        # informational: does this scale/backend show the flat rules'
        # quadratic term at all? (tiny-d CPU smokes legitimately may not)
        "flat_shows_quadratic": any(
            e["tail_exponent"] > QUADRATIC_EXPONENT_FLOOR for e in flats
        ),
    }
    verdict["ok"] = verdict["composite_sublinear_in_n2"]
    return {
        "schema": SCHEMA,
        "platform": "gpu" if device.type == "cuda" else device.type,
        "ns": ns,
        "d": d,
        "f": int(f),
        "reps": int(reps),
        "sublinear_exponent_bar": SUBLINEAR_EXPONENT_BAR,
        "rules": entries,
        "verdict": verdict,
    }


def validate_scaling_doc(doc):
    """Schema contract for ``aggregathor.gar.scaling.v1``; raises
    AssertionError with a field-naming message on violation."""
    assert doc.get("schema") == SCHEMA, "schema != %s: %r" % (SCHEMA, doc.get("schema"))
    ns = doc.get("ns")
    assert isinstance(ns, list) and len(ns) >= 2, "ns must list >= 2 worker counts"
    assert ns == sorted(ns) and all(
        isinstance(n, int) and n >= 1 for n in ns
    ), "ns must be ascending positive ints"
    for field in ("d", "f", "reps"):
        assert isinstance(doc.get(field), int) and doc[field] >= 0, field
    assert isinstance(doc.get("platform"), str) and doc["platform"], "platform"
    rules = doc.get("rules")
    assert isinstance(rules, list) and rules, "rules must be a nonempty list"
    kinds = set()
    for entry in rules:
        name = entry.get("rule")
        assert isinstance(name, str) and name, "rule name"
        assert entry.get("kind") in ("flat", "composite"), "%s: kind" % name
        kinds.add(entry["kind"])
        ms = entry.get("ms")
        assert isinstance(ms, list) and len(ms) == len(ns), "%s: ms misaligned with ns" % name
        assert all(
            isinstance(v, (int, float)) and v > 0 and math.isfinite(v) for v in ms
        ), "%s: ms must be positive finite (0.0 means an unsynced timer)" % name
        spec_by_n = entry.get("spec_by_n")
        assert isinstance(spec_by_n, dict) and set(spec_by_n) == {
            str(n) for n in ns
        }, "%s: spec_by_n keys" % name
        for field in ("tail_exponent", "fit_exponent"):
            assert isinstance(entry.get(field), (int, float)) and math.isfinite(
                entry[field]
            ), "%s: %s" % (name, field)
        if entry["kind"] == "composite":
            assert isinstance(entry.get("flat_ref"), str), "%s: flat_ref" % name
            assert isinstance(entry.get("sublinear_in_n2"), bool), (
                "%s: sublinear_in_n2" % name
            )
    assert kinds == {"flat", "composite"}, "sweep needs both flat and composite rules"
    verdict = doc.get("verdict")
    assert isinstance(verdict, dict), "verdict"
    for field in ("composite_sublinear_in_n2", "flat_shows_quadratic", "ok"):
        assert isinstance(verdict.get(field), bool), "verdict.%s" % field
    want = all(e["sublinear_in_n2"] for e in rules if e["kind"] == "composite")
    assert verdict["composite_sublinear_in_n2"] == want, (
        "verdict.composite_sublinear_in_n2 inconsistent with per-rule flags"
    )
    assert verdict["ok"] == verdict["composite_sublinear_in_n2"], "verdict.ok"
    return doc


def render_table(doc):
    """Human-readable sweep table (one line per rule x n, plus the verdict)."""
    lines = ["%-22s %-9s %6s %12s %8s" % ("rule", "kind", "n", "ms", "exp")]
    for entry in doc["rules"]:
        for n, ms in zip(doc["ns"], entry["ms"]):
            lines.append(
                "%-22s %-9s %6d %12.3f %8s"
                % (entry["rule"], entry["kind"], n, ms,
                   "p=%.2f" % entry["tail_exponent"] if n == doc["ns"][-1] else "")
            )
    verdict = doc["verdict"]
    lines.append(
        "verdict: composite sublinear in n^2: %s; flat quadratic visible: %s"
        % ("YES" if verdict["composite_sublinear_in_n2"] else "NO",
           "yes" if verdict["flat_shows_quadratic"] else "no (scale too small)")
    )
    return "\n".join(lines)
