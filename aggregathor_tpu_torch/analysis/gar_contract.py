"""GAR contract checker: every registered rule proves its declared contract.

Counterpart of ``aggregathor_tpu/analysis/gar_contract.py``, over the
port's registry with the same spec list (every ``gars.itemize()`` name
plus JAX's seven ``COMPOSITE_SPECS``), the same ``CANDIDATES``, the same
``PROBE_D = 8`` and the same probe rows (``np.random.default_rng(0x6A2)``).
A GAR's class attributes are load-bearing declarations, not
documentation: ``nan_row_tolerant`` licenses the lossy link, the
bounded-wait timeout path and the quarantine to inject NaN rows *inside
the declared-f budget*; ``worker_participation`` feeds reputation and
forensics; parse-time feasibility is what the guardian's escalation ladder
relies on when it re-sizes ``f``; dtype preservation is the exchange
contract.  A rule registered with a false declaration breaks subsystems
that never import it directly, so registration itself must be checkable.

Each spec is instantiated at the first feasible ``(n, f)`` of
``CANDIDATES`` and probed with concrete rows on ``device`` at width ``d``
(``check_spec(spec, device, d)``): the same probes run on the CPU in the
tests, through the kernels' plain versions, and on the card in
``chip_smoke.py``, through K1-K6 and the centring, where their findings
must be the CPU's, fingerprint for fingerprint.

- **GC001 nan-poison** -- finite rows must aggregate finite; with
  ``nan_row_tolerant`` declared, ``f`` all-NaN rows must leave the
  aggregate finite.
- **GC002 infeasibility accepted** -- ``f >= n`` must be rejected at parse
  time with a ``UserException`` for EVERY rule, not accepted and not a
  crash deep in aggregation.
- **GC003 participation** -- when ``worker_participation`` is defined it
  must be an (n,) vector summing to 1.
- **GC004 dtype/shape drift** -- float32 ``(n, d)`` in, float32 ``(d,)``
  out.  JAX proves it abstractly with ``jax.eval_shape``; torch's
  counterpart, meta tensors, fails where a rule reads a value on the host
  (Bulyan's selection loop, DnC's count), so the port reads the concrete
  clean probe's output.
- **GC005 int8-wire survival** -- finite rows with one coordinate a row
  amplified 1000x, squeezed through ``parallel.compress.Int8Codec``'s
  round trip (which zeroes every small coordinate exactly), must still
  aggregate finite.
- **GC000 probe crash** -- any probe raising something other than the
  contract's expected exception: a rule the checker cannot exercise is a
  rule the next PR can silently break.

The port's keys are int seeds: the probes' keys are ``fold_in_seed(0,
tag)`` for tags 0-4 where JAX folds tags 0-4 into ``PRNGKey(0)`` (tag 0,
JAX's ``eval_shape`` key, is unused).  Results are cached per (specs,
device, d) in the process, so the CLI and the tests share one sweep.
"""

import functools

from .core import Finding

CHECKER = "gar-contract"

#: small feasible-(n, f) candidates, probed in order (bulyan needs
#: n >= 4f + 3, hier needs divisible groups, bucketing reduced inner ...)
CANDIDATES = ((8, 1), (8, 2), (12, 2), (16, 2), (11, 3), (16, 3), (9, 1),
              (6, 1), (16, 1), (32, 4))

#: probe width: big enough for coordinate medians to be meaningful, small
#: enough that 30+ rules x 4 probes stay cheap on the CPU
PROBE_D = 8

#: composite nestings swept IN ADDITION to every registered name (JAX's
#: list, copied): the meta-rule compositions the engines accept anywhere a
#: GAR name is, the aggregation tree in both nesting directions
COMPOSITE_SPECS = (
    "hier:g=2,inner=median,outer=krum",
    "bucketing:s=2,inner=krum",
    "bucketing:s=2,inner=hier(g=2,inner=median,outer=average-nan)",
    "hier:g=4,inner=bucketing(s=2,inner=median),outer=average-nan",
    "tree:g=2x2,rules=median>median>average-nan",
    "tree:g=4,rules=bucketing(s=2,inner=median)>krum",
    "hier:g=2,inner=median,outer=tree(g=2,rules=median>average-nan)",
)


def default_specs():
    """Every registered GAR name (a rule cannot register without entering
    this sweep) plus the composite nestings."""
    from .. import gars

    return tuple(gars.itemize()) + COMPOSITE_SPECS


def _finding(code, spec, symbol, message):
    return Finding(
        checker=CHECKER, code=code, path="gars/%s" % spec.split(":", 1)[0],
        line=0, scope=spec, symbol=symbol, message=message,
    )


def _instantiate(spec, n, f):
    from .. import gars

    return gars.instantiate(spec, n, f)


def _feasible(spec):
    """(gar, n, f) at the first feasible candidate; (None, None, reason)
    when none is.  A non-UserException from a rule's constructor is a
    CRASH, not an infeasibility: it surfaces as a GC000 finding."""
    from ..utils import UserException

    crash = None
    for n, f in CANDIDATES:
        try:
            return _instantiate(spec, n, f), n, f
        except UserException:
            continue
        except Exception as exc:
            crash = "(n=%d, f=%d) crashed: %s: %s" % (n, f, type(exc).__name__, exc)
    return None, None, crash


@functools.lru_cache(maxsize=4)
def probe_rows(n, d=PROBE_D):
    """The (n, d) float32 probe rows, as JAX draws them: drawn once per
    (n, d) in a process and shared, so callers copy before they write."""
    import numpy as np

    return np.random.default_rng(0x6A2).normal(size=(n, d)).astype(np.float32)


def check_spec(spec, device, d=PROBE_D):
    """All contract probes for one spec on ``device`` at width ``d``; returns
    a list of findings."""
    import numpy as np
    import torch

    from ..gars.common import pairwise_sq_distances
    from ..parallel.compress import Int8Codec
    from ..utils import UserException, fold_in_seed

    findings = []
    gar, n, f = _feasible(spec)
    if gar is None:
        return [_finding(
            "GC000", spec, "feasibility",
            f or "no feasible (n, f) among %r: the contract cannot be exercised" % (CANDIDATES,),
        )]

    # one derived key per probe, as JAX folds tags 1-4 into PRNGKey(0)
    clean_key, nan_key, part_key, int8_key = (fold_in_seed(0, tag) for tag in range(1, 5))
    grads = probe_rows(n, d)

    def on_device(rows):
        # a copy on every device: a rule may write into its input
        return torch.as_tensor(rows).to(device, copy=True)

    # the concrete clean aggregate: GC004 on its shape and dtype, GC001 on
    # its values
    try:
        out = gar.aggregate(on_device(grads), key=clean_key)
        if tuple(out.shape) != (d,):
            findings.append(_finding(
                "GC004", spec, "shape",
                "aggregate of (%d, %d) returned shape %r, wants (%d,)" % (n, d, tuple(out.shape), d),
            ))
        if out.dtype != torch.float32:
            findings.append(_finding(
                "GC004", spec, "dtype",
                "float32 input aggregated to %s: the engines' exchange-dtype round trip relies on "
                "dtype preservation" % out.dtype,
            ))
        if not bool(torch.all(torch.isfinite(out))):
            findings.append(_finding(
                "GC001", spec, "clean-finite",
                "aggregate of finite gradients is not finite at (n=%d, f=%d)" % (n, f),
            ))
    except Exception as exc:
        findings.append(_finding(
            "GC000", spec, "aggregate",
            "concrete aggregate probe crashed: %s: %s" % (type(exc).__name__, exc),
        ))
        return findings  # later probes would only repeat the crash

    # GC001: declared NaN tolerance actually absorbs f NaN rows
    if gar.nan_row_tolerant and f >= 1:
        poisoned = grads.copy()
        poisoned[:f] = np.nan
        try:
            out = gar.aggregate(on_device(poisoned), key=nan_key)
            if not bool(torch.all(torch.isfinite(out))):
                findings.append(_finding(
                    "GC001", spec, "nan-rows",
                    "declares nan_row_tolerant but %d NaN row(s) within f=%d poison the aggregate -- "
                    "the lossy/straggler/quarantine NaN budget is a lie for this rule" % (f, f),
                ))
        except Exception as exc:
            findings.append(_finding(
                "GC000", spec, "nan-probe",
                "NaN-tolerance probe crashed: %s: %s" % (type(exc).__name__, exc),
            ))

    # GC005: int8-wire survival.  One coordinate per row is amplified 1000x
    # before the round trip: the per-row scale then quantizes every small
    # coordinate to an exact zero, the structure a fragile rule breaks on.
    try:
        spiky = grads.copy()
        spiky[:, 0] *= 1000.0
        quantized = Int8Codec().roundtrip(on_device(spiky))
        out = gar.aggregate(quantized, key=int8_key)
        if not bool(torch.all(torch.isfinite(out))):
            findings.append(_finding(
                "GC005", spec, "int8-wire",
                "aggregate of int8-roundtripped finite gradients is not finite at (n=%d, f=%d) -- the "
                "rule breaks under the compressed exchange (--exchange int8)" % (n, f),
            ))
    except Exception as exc:
        findings.append(_finding(
            "GC000", spec, "int8-probe",
            "int8-wire probe crashed: %s: %s" % (type(exc).__name__, exc),
        ))

    # GC003: participation scatter sums to 1
    try:
        block = on_device(grads)
        dist2 = pairwise_sq_distances(block) if gar.needs_distances else None
        _, part = gar.aggregate_block_and_participation(block, dist2, key=part_key)
        if part is not None:
            part = part.detach().cpu().numpy()
            if part.shape != (n,):
                findings.append(_finding(
                    "GC003", spec, "participation-shape",
                    "worker_participation returned shape %r, wants (%d,)" % (part.shape, n),
                ))
            elif not np.isclose(float(np.sum(part)), 1.0, atol=1e-3):
                findings.append(_finding(
                    "GC003", spec, "participation-sum",
                    "worker_participation sums to %.6f, wants 1 -- the reputation/forensics scatter "
                    "double- or under-counts" % float(np.sum(part)),
                ))
    except Exception as exc:
        findings.append(_finding(
            "GC000", spec, "participation",
            "participation probe crashed: %s: %s" % (type(exc).__name__, exc),
        ))

    # GC002: f >= n must be a parse-time UserException
    try:
        _instantiate(spec, 3, 3)
        findings.append(_finding(
            "GC002", spec, "infeasible-accepted",
            "(n=3, f=3) accepted at parse time: a rule cannot tolerate a Byzantine majority of "
            "everyone -- feasibility must reject f >= n before a step ever runs",
        ))
    except UserException:
        pass
    except Exception as exc:
        findings.append(_finding(
            "GC002", spec, "infeasible-crash",
            "infeasible (n=3, f=3) crashed with %s instead of a parse-time UserException: %s"
            % (type(exc).__name__, exc),
        ))
    return findings


@functools.lru_cache(maxsize=8)
def _check_cached(specs, device, d):
    findings = []
    for spec in specs:
        findings.extend(check_spec(spec, device, d))
    return tuple(findings)


def check(modules=None, specs=None, device="cuda", d=PROBE_D):
    """Checker entry point: the sweep on ``device`` (the card unless the
    caller asks for the CPU; ``utils.resolve_device`` raises without a
    GPU).  ``modules`` is accepted (and ignored) for signature parity with
    the AST checkers; results are cached per (spec tuple, device, d), so
    the CLI and the tests share one probe pass per process."""
    from ..utils import resolve_device

    del modules
    device = resolve_device(device)
    specs = tuple(specs) if specs is not None else default_specs()
    return list(_check_cached(specs, str(device), int(d)))
