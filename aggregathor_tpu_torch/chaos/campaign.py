"""Resilience-campaign harness: sweep attack x GAR x schedule grids.

Counterpart of ``aggregathor_tpu/chaos/campaign.py``.  Every cell of the
(GAR x chaos scenario) grid trains the same experiment through the port's
:class:`RobustEngine` under a :class:`ChaosSchedule`, and the campaign
emits a resilience matrix (JSON, schema
``aggregathor.chaos.resilience-matrix.v1``, the JAX package's) with per-cell
loss trajectories and converged/diverged verdicts, and a markdown report
with the verdict grid and, under ``--breakdown``, each rule's empirical
f-breakdown boundary (the first attack scenario at r = f and at r = n//2 +
1).  ``--guardian`` runs every cell under the recovery layer with in-memory
last-known-good snapshots; ``--forensics`` adds the ledger's attribution.

Scenarios: ``--attacks NAME[,k=v...]`` is the schedule ``0:attack=NAME[,...]``,
``--schedules NAME=SPEC`` any schedule; a ``calm`` row always comes first.

A cell's ``compile_count`` is the number of kernel builds (``nvcc``/``c++``
runs of ``ops/build.py``, the ``compile_backend_total`` count of
``obs/profiler.py``) made during the cell: the port's counterpart of the
JAX cell's executable count; 0 once the kernels are built, and on the CPU.

Example (CPU)::

  python -m aggregathor_tpu_torch.chaos.campaign --device cpu \\
      --experiment mnist --experiment-args batch-size:16 \\
      --nb-workers 8 --nb-decl-byz-workers 2 --nb-real-byz-workers 2 \\
      --gars average median krum --attacks empire,epsilon=4.0 \\
      --schedules storm="0:calm 10:drop=0.3" \\
      --nb-steps 25 --output matrix.json --report report.md
"""

import argparse
import json
import sys

SCHEMA = "aggregathor.chaos.resilience-matrix.v1"

#: matrix keys every cell carries
CELL_KEYS = (
    "gar", "scenario", "schedule", "nb_real_byz", "declared_byz",
    "first_loss", "final_loss", "min_loss", "converged", "diverged", "losses",
    "compile_count",
)


def build_parser():
    parser = argparse.ArgumentParser(
        prog="aggregathor-torch campaign",
        description="Resilience campaign: attack x GAR x schedule grid through the robust engine",
    )
    parser.add_argument("--experiment", default="mnist", help="experiment name (models registry)")
    parser.add_argument("--experiment-args", nargs="*", default=[], help="key:value experiment arguments")
    parser.add_argument("--nb-workers", type=int, default=8, help="number n of logical workers")
    parser.add_argument("--nb-decl-byz-workers", type=int, default=2, help="declared Byzantine count f")
    parser.add_argument("--nb-real-byz-workers", type=int, default=2,
                        help="actual attacker count r for attack scenarios")
    parser.add_argument("--gars", nargs="+", default=["average", "median", "krum"],
                        help="GAR names to sweep (gars registry)")
    parser.add_argument("--gar-args", nargs="*", default=[], help="key:value arguments for every GAR")
    parser.add_argument("--attacks", nargs="*", default=[],
                        help="attack scenarios NAME[,k=v...] (single-regime schedules)")
    parser.add_argument("--schedules", nargs="*", default=[],
                        help="named schedule scenarios NAME=SPEC (full chaos DSL)")
    parser.add_argument("--chaos-args", nargs="*", default=[],
                        help="key:value schedule-wide options (packet-coords, straggle-workers, ...)")
    parser.add_argument("--nb-steps", type=int, default=25, help="train steps per cell")
    parser.add_argument("--learning-rate", type=float, default=0.05)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--nb-devices", type=int, default=1,
                        help="devices on the worker axis (the campaign runs one: 1)")
    parser.add_argument("--breakdown", action="store_true",
                        help="empirically probe each robust rule's f-breakdown boundary "
                             "(re-runs the first attack scenario at r=f and r=n//2+1)")
    parser.add_argument("--guardian", action="store_true",
                        help="run every cell under the guardian recovery layer: cells report "
                             "diverged-then-recovered instead of stopping at the first non-finite loss")
    parser.add_argument("--guardian-args", nargs="*", default=[],
                        help="key:value watchdog options (patience:N, spike:X, retries:N, ladder:...)")
    parser.add_argument("--forensics", action="store_true",
                        help="run every cell with a Byzantine forensics ledger and record which workers it "
                             "names against the injected coalition (workers 0..r-1)")
    parser.add_argument("--output", default=None, metavar="JSON", help="resilience matrix output path")
    parser.add_argument("--report", default=None, metavar="MD", help="markdown report output path")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="where the cells train (default cuda; without a GPU, cuda fails)")
    return parser


def _scenarios(args):
    """[(name, schedule spec or None)], the calm baseline first; names key
    the cells and must be unique."""
    from ..utils import UserException

    out = [("calm", None)]
    for item in args.attacks:
        out.append((item.split(",", 1)[0], "0:attack=%s" % item))
    for item in args.schedules:
        if "=" not in item:
            raise UserException("--schedules wants NAME=SPEC (got %r)" % (item,))
        name, spec = item.split("=", 1)
        out.append((name, spec))
    names = [name for name, _ in out]
    duplicates = sorted({name for name in names if names.count(name) > 1})
    if duplicates:
        raise UserException("Duplicate scenario name(s) %s would collide in the matrix/report; give variants "
                            "distinct names via --schedules NAME=SPEC" % ", ".join(duplicates))
    return out


def _declares_attack(spec, nb_workers):
    """Does this schedule activate any attack regime (probed with a
    one-member coalition)?"""
    from ..utils import UserException
    from .schedule import ChaosSchedule

    try:
        return ChaosSchedule(spec, nb_workers, nb_real_byz=1).has_attacks
    except UserException:
        return False


def run_cell(exp_name, exp_args, gar_name, gar_args, n, f, r, schedule_spec, chaos_args, nb_steps, lr, seed,
             nb_devices=1, guardian=None, forensics=False, device="cuda"):
    """Train one grid cell on ``device``; returns the cell record (see
    ``CELL_KEYS``).  ``guardian`` (a ``GuardianConfig``) rolls back to
    in-memory snapshots and climbs the ladder; ``forensics`` adds the
    ledger's attribution against the coalition and the attack steps."""
    import numpy as np
    import torch

    from .. import gars, models
    from ..core import build_optimizer, build_schedule
    from ..core.train_state import host_snapshot, load_snapshot
    from ..guardian import RESEED_STRIDE, RNG_PERTURB_TAG, Overrides, Watchdog
    from ..ops import build
    from ..parallel import RobustEngine
    from ..utils import UserException, fold_in_seed, resolve_device, warning
    from .schedule import ChaosSchedule

    if nb_devices != 1:
        raise UserException("the campaign trains each cell on one device (--nb-devices 1); run a worker axis "
                            "through cli.runner --nb-devices")
    device = resolve_device(device)
    builds_before = build.BUILD_STATS["builds"]
    experiment = models.instantiate(exp_name, exp_args)
    chaos = ChaosSchedule(schedule_spec, n, nb_real_byz=r, args=chaos_args) if schedule_spec else None
    # forge/tamper regimes are coalition behavior too (the engine refuses them)
    nb_real = r if (chaos is not None and (chaos.has_attacks or chaos.has_forgery)) else 0

    def build_stack(ov):
        """(engine, tx, step) for an Overrides record, rebuilt per rung."""
        gar = gars.instantiate(ov.gar_name, n, ov.f, list(ov.gar_args))
        tx = build_optimizer("sgd", build_schedule("fixed", ["initial-rate:%s" % (lr * ov.lr_scale)]))
        engine = RobustEngine(gar, n, nb_real_byz=nb_real, chaos=chaos, worker_metrics=bool(forensics),
                              reputation_decay=ov.reputation_decay, quarantine_threshold=ov.quarantine_threshold,
                              device=device)
        return engine, tx, engine.build_step(experiment.loss, tx)

    overrides = Overrides(f, gar_name, tuple(gar_args or []))
    watchdog = Watchdog(guardian) if guardian is not None else None
    engine, tx, step = build_stack(overrides)
    state = engine.init_state(experiment.init(seed), tx, seed=seed + 1)
    it = experiment.make_train_iterator(n, seed=seed + 2)
    ledger = None
    if forensics:
        from ..obs.forensics import ForensicsLedger

        ledger = ForensicsLedger(n)

    losses, diverged, failed, rollbacks, escalations, recovered = [], False, False, 0, [], False
    good = None  # (host snapshot, len(losses)) at the last healthy snapshot
    snap_every = max(1, nb_steps // 8)
    s = 0
    while s < nb_steps:
        state, metrics = step(state, engine.put_batch(next(it)))
        loss = float(metrics["total_loss"])
        losses.append(loss)
        s += 1
        if ledger is not None:
            # ledger steps are 1-based: step s ran under the regime of s - 1
            probe = metrics.get("probe")
            ridx = chaos.regime_at(s - 1) if chaos is not None else None
            dist = metrics.get("worker_sq_dist")
            ledger.observe(s, worker_sq_dist=None if dist is None else dist.cpu().numpy(),
                           worker_nan=None if probe is None else probe["worker_nan_rows"].cpu().numpy(),
                           regime=ridx, regime_desc=chaos.describe(ridx) if ridx is not None else None)
        if watchdog is None:
            if not np.isfinite(loss):
                diverged = True  # every later loss is NaN too
                break
            continue
        probe = metrics["probe"]
        action = watchdog.observe(s, loss, bool(int(probe["loss_finite"])), float(probe["spike"]))
        if action == "recovered":
            recovered = rollbacks > 0
            continue
        if action != "rollback":
            if watchdog.healthy and s % snap_every == 0:
                good = (host_snapshot(state), len(losses))
            continue
        diverged = True  # the cell did diverge; recovery may still save it
        if watchdog.exhausted:
            failed = True
            break
        target_len = good[1] if good is not None else 0
        attempt = watchdog.note_rollback(int(good[0]["step"]) if good is not None else 0)
        rollbacks += 1
        rung = guardian.ladder.rung(attempt)
        if rung is not None:
            try:
                new_overrides = rung.apply(overrides)
                engine, tx, step = build_stack(new_overrides)
                overrides = new_overrides
                escalations.append(rung.describe())
            except UserException as exc:
                warning("guardian cell: rung %r rejected: %s" % (rung.describe(), exc))
        fresh_seed = seed + 1 + RESEED_STRIDE * (attempt + 1) if good is None else seed + 1
        state = engine.init_state(experiment.init(seed), tx, seed=fresh_seed)
        if good is not None:
            load_snapshot(state, good[0])
            state.seed = fold_in_seed(state.seed, RNG_PERTURB_TAG + attempt)  # the perturbed streams
        losses = losses[:target_len]
        s = target_len
        if ledger is not None:
            ledger.truncate_after(target_len)
            ledger.note_guardian(target_len, "rollback", {"attempt": attempt})
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    finite = [x for x in losses if np.isfinite(x)]
    first = losses[0] if losses else float("nan")
    final = losses[-1] if losses else float("nan")
    cell = {
        "gar": gar_name,
        "nb_real_byz": nb_real,
        "declared_byz": f,
        "compile_count": int(build.BUILD_STATS["builds"] - builds_before),
        "first_loss": first,
        "final_loss": final,
        "min_loss": min(finite) if finite else float("nan"),
        "converged": bool((watchdog is None or not failed) and np.isfinite(first) and np.isfinite(final)
                          and final < first),
        "diverged": diverged if watchdog is None else bool(failed or not np.isfinite(final)),
        "losses": losses,
    }
    if watchdog is not None:
        cell["guardian"] = True
        cell["rollbacks"] = rollbacks
        cell["escalations"] = escalations
        cell["recovered"] = bool(rollbacks > 0 and not failed and np.isfinite(final) and recovered)
    if ledger is not None:
        freport = ledger.report()
        expected = list(range(nb_real))
        attack_steps = set()
        if chaos is not None and (chaos.has_attacks or chaos.has_forgery):
            for sx in range(nb_steps):
                regime = chaos.regimes[chaos.regime_at(sx)]
                if regime.attack is not None or regime.forge_rate > 0 or regime.tamper_rate > 0:
                    attack_steps.add(sx + 1)

        def overlaps_attack(worker):
            return any(iv["start"] <= sx <= iv["end"] for iv in freport["workers"][worker]["intervals"]
                       for sx in attack_steps)

        suspects = freport["suspects"]
        correct = sorted(suspects) == expected and all(overlaps_attack(w) for w in expected)
        cell["forensics"] = {
            "suspects": suspects,
            "expected": expected,
            "attack_steps": [min(attack_steps), max(attack_steps)] if attack_steps else None,
            "attribution_correct": bool(correct),
            "suspect_intervals": {str(w): freport["workers"][w]["intervals"] for w in suspects},
        }
    return cell


def run_campaign(args):
    """Run the whole grid; returns the resilience-matrix dict."""
    from ..utils import UserException, info, warning

    n, f, r = args.nb_workers, args.nb_decl_byz_workers, args.nb_real_byz_workers
    if r > n:
        raise UserException("More real Byzantine workers (%d) than workers (%d)" % (r, n))
    guardian = None
    if getattr(args, "guardian", False):
        from ..guardian import GuardianConfig

        guardian = GuardianConfig(args.guardian_args)
    device = getattr(args, "device", "cuda")
    scenarios = _scenarios(args)
    cells = []
    for gar_name in args.gars:
        for scenario, spec in scenarios:
            info("campaign cell: gar=%s scenario=%s" % (gar_name, scenario))
            cell = run_cell(args.experiment, args.experiment_args, gar_name, args.gar_args, n, f, r, spec,
                            args.chaos_args, args.nb_steps, args.learning_rate, args.seed,
                            nb_devices=args.nb_devices, guardian=guardian,
                            forensics=getattr(args, "forensics", False), device=device)
            cell["scenario"] = scenario
            cell["schedule"] = spec
            cells.append(cell)
            verdict = "DIVERGED" if cell["diverged"] else ("converged" if cell["converged"] else "degraded")
            if cell.get("recovered"):
                verdict = "recovered (%d rollback(s))" % cell["rollbacks"]
            if "forensics" in cell:
                fx = cell["forensics"]
                verdict += ", attribution %s (named %s, expected %s)" % (
                    "CORRECT" if fx["attribution_correct"] else "WRONG", fx["suspects"] or "nobody",
                    fx["expected"] or "nobody")
            info("  -> %s (first %.4f final %.4f)" % (verdict, cell["first_loss"], cell["final_loss"]))
    breakdown = []
    if args.breakdown:
        # only attack scenarios have a coalition to size
        attack_specs = [(name, spec) for name, spec in scenarios if spec is not None and _declares_attack(spec, n)]
        if not attack_specs:
            raise UserException("--breakdown needs at least one attack scenario (--attacks NAME or a --schedules "
                                "spec with an attack= regime)")
        probe_name, probe_spec = attack_specs[0]
        r_beyond = n // 2 + 1  # a strict Byzantine majority: beyond every rule's bound
        for gar_name in args.gars:
            if gar_name.startswith("average"):
                continue  # no declared bound to probe
            entry = {"gar": gar_name, "scenario": probe_name, "declared_byz": f, "r_within": f,
                     "r_beyond": r_beyond}
            for tag, rr in (("within", f), ("beyond", r_beyond)):
                try:
                    cell = run_cell(args.experiment, args.experiment_args, gar_name, args.gar_args, n, f, rr,
                                    probe_spec, args.chaos_args, args.nb_steps, args.learning_rate, args.seed,
                                    nb_devices=args.nb_devices, device=device)
                except UserException as exc:
                    warning("breakdown %s/%s skipped: %s" % (gar_name, tag, exc))
                    entry["%s_error" % tag] = str(exc)
                    continue
                entry["%s_converged" % tag] = cell["converged"]
                entry["%s_final_loss" % tag] = cell["final_loss"]
                entry["%s_compile_count" % tag] = cell["compile_count"]
            if "within_converged" in entry and "beyond_converged" in entry:
                entry["bound_holds"] = bool(entry["within_converged"] and not entry["beyond_converged"])
            breakdown.append(entry)
    return {
        "schema": SCHEMA,
        "experiment": args.experiment,
        "experiment_args": list(args.experiment_args),
        "nb_workers": n,
        "declared_byz": f,
        "nb_real_byz": r,
        "nb_steps": args.nb_steps,
        "learning_rate": args.learning_rate,
        "seed": args.seed,
        "cells": cells,
        "breakdown": breakdown,
    }


def render_report(matrix):
    """The markdown verdict grid (and breakdown table) of a matrix."""
    scenarios = []
    for cell in matrix["cells"]:
        if cell["scenario"] not in scenarios:
            scenarios.append(cell["scenario"])
    by_key = {(c["gar"], c["scenario"]): c for c in matrix["cells"]}
    lines = [
        "# Resilience matrix — %s, n=%d, f=%d declared, %d steps"
        % (matrix["experiment"], matrix["nb_workers"], matrix["declared_byz"], matrix["nb_steps"]),
        "",
        "Verdicts: `ok` loss decreased (first -> final), `degraded` finite but",
        "not decreasing, `DIVERGED` non-finite loss (params poisoned),",
        "`recovered` diverged then healed by the guardian (rollback count).",
        "",
        "| GAR | " + " | ".join(scenarios) + " |",
        "|---|" + "---|" * len(scenarios),
    ]
    for gar_name in dict.fromkeys(c["gar"] for c in matrix["cells"]):
        row = ["| %s" % gar_name]
        for scenario in scenarios:
            cell = by_key.get((gar_name, scenario))
            if cell is None:
                row.append("—")
            elif cell.get("recovered"):
                row.append("recovered x%d (%.3f→%.3f)" % (cell["rollbacks"], cell["first_loss"], cell["final_loss"]))
            elif cell["diverged"]:
                row.append("DIVERGED")
            elif cell["converged"]:
                row.append("ok (%.3f→%.3f)" % (cell["first_loss"], cell["final_loss"]))
            else:
                row.append("degraded (%.3f→%.3f)" % (cell["first_loss"], cell["final_loss"]))
        lines.append(" | ".join(row) + " |")
    if any("forensics" in cell for cell in matrix["cells"]):
        lines += [
            "",
            "## Forensics attribution",
            "",
            "Per cell: the workers the ledger (obs/forensics.py) named",
            "Byzantine vs the injected coalition; `correct` means exactly the",
            "coalition was named with suspect ranges overlapping the attack",
            "window (calm cells: correct = nobody named).",
            "",
            "| GAR | scenario | named | expected | correct |",
            "|---|---|---|---|---|",
        ]
        for cell in matrix["cells"]:
            fx = cell.get("forensics")
            if fx is None:
                continue
            lines.append("| %s | %s | %s | %s | %s |" % (
                cell["gar"], cell["scenario"], ",".join(str(w) for w in fx["suspects"]) or "—",
                ",".join(str(w) for w in fx["expected"]) or "—",
                "**yes**" if fx["attribution_correct"] else "NO"))
    if matrix["breakdown"]:
        lines += [
            "",
            "## Empirical f-breakdown boundary",
            "",
            "Same attack scenario at `r = f` (inside the declared budget) and",
            "`r = n//2 + 1` (Byzantine majority — beyond every rule's bound).",
            "",
            "| GAR | scenario | r=f converged | r=majority converged | bound holds |",
            "|---|---|---|---|---|",
        ]
        for entry in matrix["breakdown"]:
            lines.append("| %s | %s | %s | %s | %s |" % (
                entry["gar"], entry["scenario"], entry.get("within_converged", entry.get("within_error", "?")),
                entry.get("beyond_converged", entry.get("beyond_error", "?")), entry.get("bound_holds", "?")))
    return "\n".join(lines) + "\n"


def main(argv=None):
    from ..utils import info

    args = build_parser().parse_args(argv)
    matrix = run_campaign(args)
    text = json.dumps(matrix, indent=1)
    if args.output:
        with open(args.output, "w") as fd:
            fd.write(text + "\n")
        info("resilience matrix -> %s" % args.output)
    else:
        print(text)
    if args.report:
        with open(args.report, "w") as fd:
            fd.write(render_report(matrix))
        info("markdown report -> %s" % args.report)
    return 0


def cli():
    """Console entry: UserException -> clean error + exit code 1."""
    from ..utils import UserException, error

    try:
        return main()
    except UserException as exc:
        error(str(exc))
        return 1


if __name__ == "__main__":
    sys.exit(cli())
