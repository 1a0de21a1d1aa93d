"""Serving resilience campaign: replica faults x vote rules, measured.

Counterpart of ``aggregathor_tpu/serve/campaign.py``, with its schema
(``aggregathor.serve.replica-matrix.v2``) and verdicts.  Where the training
campaign (``chaos/campaign.py``) proves a GAR absorbs Byzantine
*gradients*, this harness proves the replica vote absorbs Byzantine
*replicas*.  Every cell of the (vote GAR x replica fault) grid serves the
SAME eval split through a real :class:`serve.engine.InferenceEngine` whose
replica set holds ``--nb-faulty`` corrupted members
(``chaos/replica_faults.py`` modes: nan / scale / zero / noise / stale),
through the continuous scheduler (``serve/continuous.py``: request-sized
submissions in flight at once), and reports

- ``accuracy``    served top-1 accuracy of the voted predictions;
- ``match_rate``  fraction of served predictions identical to the CLEAN
  single-replica baseline; ``masked`` is ``match_rate >= --match-bar``
  (with identical clean replicas the median vote is *exactly* the clean
  model, so the bar defaults to 1.0);
- ``disagreement``  the engine's per-replica scores (the faulty replica
  reads null for +inf);
- ``batches`` and ``compile_count``  the scheduler's batches and the
  engine's bucket shapes run.

The model is trained in-process (a short run through the port's
``parallel.RobustEngine``) unless ``--ckpt-dir`` points at a checkpoint;
``stale`` replicas take the parameters early in that run (or the oldest
snapshot on disk).

Example (CPU)::

  python -m aggregathor_tpu_torch.serve.campaign --device cpu \\
      --experiment digits --train-steps 60 --replicas 3 \\
      --gars median average --faults nan scale=100 \\
      --output matrix.json --report report.md
"""

import argparse
import json
import sys

SCHEMA = "aggregathor.serve.replica-matrix.v2"

#: matrix keys every cell must carry
CELL_KEYS = (
    "gar", "fault", "nb_replicas", "nb_faulty", "accuracy", "match_rate",
    "masked", "disagreement", "suspects", "batches", "compile_count",
)


def validate(doc):
    """Schema check for round-tripping consumers; returns ``doc``."""
    if doc.get("schema") != SCHEMA:
        raise ValueError("not a %s document" % SCHEMA)
    for key in ("experiment", "nb_replicas", "nb_faulty", "steps_trained",
                "eval_rows", "match_bar", "clean_accuracy", "cells"):
        if key not in doc:
            raise ValueError("missing %r" % key)
    if not isinstance(doc["cells"], list) or not doc["cells"]:
        raise ValueError("cells must be a non-empty list")
    for cell in doc["cells"]:
        for key in CELL_KEYS:
            if key not in cell:
                raise ValueError("cell missing %r" % key)
        if not isinstance(cell["masked"], bool):
            raise ValueError("cell 'masked' must be a bool")
        if cell["batches"] < 1:
            raise ValueError("cell served zero scheduler batches")
    return doc


def load(path):
    with open(path) as fd:
        return validate(json.load(fd))


def build_parser():
    parser = argparse.ArgumentParser(
        prog="aggregathor-torch serve-campaign",
        description="Replica-fault x vote-rule grid through the real inference engine",
    )
    parser.add_argument("--experiment", default="digits", help="experiment name (models registry)")
    parser.add_argument("--experiment-args", nargs="*", default=[], help="key:value experiment arguments")
    parser.add_argument("--gars", nargs="+", default=["median", "average"],
                        help="vote rules to sweep (gars registry; nb_workers = --replicas)")
    parser.add_argument("--gar-args", nargs="*", default=[], help="key:value arguments for every vote rule")
    parser.add_argument("--faults", nargs="*", default=["nan", "scale=100"],
                        help="replica fault scenarios MODE[=VALUE] "
                             "(chaos/replica_faults.py; 'clean' baseline is always prepended)")
    parser.add_argument("--replicas", type=int, default=3, help="replica count R")
    parser.add_argument("--nb-faulty", type=int, default=1,
                        help="corrupted replicas per fault cell (last indices)")
    parser.add_argument("--train-steps", type=int, default=60,
                        help="in-process training steps (ignored with --ckpt-dir)")
    parser.add_argument("--ckpt-dir", default=None,
                        help="serve an existing checkpoint instead of training in-process")
    parser.add_argument("--optimizer", default="sgd",
                        help="optimizer the --ckpt-dir snapshot was trained with (template rebuild)")
    parser.add_argument("--optimizer-args", nargs="*", default=[], help="key:value optimizer arguments")
    parser.add_argument("--learning-rate", type=float, default=0.05)
    parser.add_argument("--eval-rows", type=int, default=256,
                        help="eval rows served per cell (0 = the whole test split)")
    parser.add_argument("--max-batch", type=int, default=64, help="bucket ladder top")
    parser.add_argument("--request-rows", type=int, default=16,
                        help="rows per scheduler submission (the simulated client "
                             "request size the continuous batcher coalesces)")
    parser.add_argument("--lanes", type=int, default=2,
                        help="dispatch lanes the cell's scheduler runs")
    parser.add_argument("--match-bar", type=float, default=1.0,
                        help="masked verdict: match_rate >= this bar")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--output", default=None, metavar="JSON", help="replica matrix output path")
    parser.add_argument("--report", default=None, metavar="MD", help="markdown report output path")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="device of the training run and the engines (default cuda; raises without a GPU)")
    return parser


def _parse_fault(item):
    """'nan' / 'scale=100' -> (name, mode, value) via the chaos spec parser."""
    from ..chaos.replica_faults import parse_poison

    _, mode, value = parse_poison("0:%s" % item)
    return item, mode, value


def train_in_process(experiment, nb_steps, lr, seed, stale_at=None, device="cuda"):
    """Short real training run; returns (params, stale_params), CPU copies.

    ``stale_params`` is the parameter snapshot at step ``stale_at`` (default
    nb_steps // 4), the under-trained replica the ``stale`` fault serves.
    """
    from .. import gars
    from ..core import build_optimizer, build_schedule
    from ..parallel import RobustEngine

    def host(params):  # the engine updates its parameters in place
        return {name: value.detach().to("cpu", copy=True) for name, value in params.items()}

    n = 4
    gar = gars.instantiate("average", n, 0)
    tx = build_optimizer("sgd", build_schedule("fixed", ["initial-rate:%s" % lr]))
    engine = RobustEngine(gar, n, device=device)
    step = engine.build_step(experiment.loss, tx)
    state = engine.init_state(experiment.init(seed), tx, seed=seed + 1)
    it = experiment.make_train_iterator(n, seed=seed + 2)
    if stale_at is None:
        stale_at = max(1, nb_steps // 4)
    stale_params = host(state.params)
    for s in range(nb_steps):
        state, _ = step(state, engine.put_batch(next(it)))
        if s + 1 == stale_at:
            stale_params = host(state.params)
    return host(state.params), stale_params


def serve_through_scheduler(engine, x, request_rows=16, lanes=2):
    """Serve ``x`` through a :class:`~.continuous.ContinuousBatcher` over
    ``engine`` — the production dispatch path — as a stream of
    ``request_rows``-sized submissions all in flight at once.

    Returns ``(predictions, disagreement, batches)``: predictions in row
    order, the rows-weighted mean per-replica disagreement over the
    dispatched batches (inf/NaN propagate — a faulty replica stays
    flagged), and the scheduler batch count (< number of submissions
    proves coalescing happened).
    """
    import numpy as np

    from .continuous import ContinuousBatcher

    request_rows = max(1, min(int(request_rows), engine.buckets[-1]))
    batcher = ContinuousBatcher(
        engine.predict, buckets=engine.buckets,
        queue_bound=max(len(x), 1), nb_lanes=lanes, max_lanes=lanes,
    )
    try:
        tickets = [
            batcher.submit(x[start:start + request_rows])
            for start in range(0, len(x), request_rows)
        ]
        results = [ticket.wait(120.0) for ticket in tickets]
    finally:
        batcher.close()
    predictions = np.concatenate([r["predictions"] for r in results])
    weights = np.asarray([len(r["predictions"]) for r in results], np.float64)
    scores = np.stack([np.asarray(r["disagreement"], np.float64) for r in results])
    disagreement = (scores * (weights / weights.sum())[:, None]).sum(axis=0)
    return predictions, disagreement, batcher.batch_count


def _eval_rows(experiment, limit):
    import numpy as np

    x = np.asarray(experiment.dataset.x_test, np.float32)
    # Engine predictions are argmax over the bare logits, which live in the
    # SHIFTED label space for experiments with a labels-offset (the zoo's
    # metrics compare against label - offset, models/zoo.py) — accuracy here
    # must compare in the same space.
    y = np.asarray(experiment.dataset.y_test) - getattr(experiment, "labels_offset", 0)
    if limit and limit > 0:
        x, y = x[:limit], y[:limit]
    return x, y


def run_campaign(args):
    import numpy as np

    from .. import gars, models
    from ..chaos.replica_faults import corrupt_params
    from ..utils import UserException, info
    from .engine import InferenceEngine, restore_params

    experiment = models.instantiate(args.experiment, args.experiment_args)
    if args.replicas < 1 or not 0 <= args.nb_faulty < args.replicas:
        raise UserException(
            "Need replicas >= 1 and 0 <= nb-faulty < replicas (got R=%d, faulty=%d)"
            % (args.replicas, args.nb_faulty)
        )
    if args.ckpt_dir:
        from ..core import build_optimizer, build_schedule

        tx = build_optimizer(
            args.optimizer, build_schedule("fixed", ["initial-rate:%s" % args.learning_rate]),
            args.optimizer_args,
        )
        params, at_step = restore_params(experiment, args.ckpt_dir, tx, seed=args.seed)
        steps_trained = at_step
        from ..obs.checkpoint import Checkpoints

        on_disk = Checkpoints(args.ckpt_dir).steps()
        stale_step = on_disk[0] if on_disk and on_disk[0] < at_step else None
        stale_params = (
            restore_params(experiment, args.ckpt_dir, tx, step=stale_step, seed=args.seed)[0]
            if stale_step is not None else params
        )
    else:
        params, stale_params = train_in_process(
            experiment, args.train_steps, args.learning_rate, args.seed, device=args.device
        )
        steps_trained = args.train_steps

    x_eval, y_eval = _eval_rows(experiment, args.eval_rows)
    info("Serve campaign: %s, %d eval rows, R=%d (%d faulty), trained %d step(s)"
         % (args.experiment, len(y_eval), args.replicas, args.nb_faulty, steps_trained))

    # The clean single-replica baseline every cell is judged against.
    baseline = InferenceEngine(experiment, [params], max_batch=args.max_batch, device=args.device)
    clean = baseline.predict(x_eval)
    clean_preds = clean["predictions"]
    clean_accuracy = float(np.mean(clean_preds == y_eval))

    scenarios = [("clean", None, None)]
    scenarios += [_parse_fault(item) for item in args.faults]

    cells = []
    for gar_name in args.gars:
        vote = gars.instantiate(
            gar_name, args.replicas, (args.replicas - 1) // 2, list(args.gar_args)
        )
        for fault_name, mode, value in scenarios:
            replicas = [params] * (args.replicas - (args.nb_faulty if mode else 0))
            for rank in range(args.nb_faulty if mode else 0):
                if mode == "stale":
                    replicas.append(stale_params)
                else:
                    replicas.append(corrupt_params(
                        params, mode, value, seed=args.seed + 17 * (rank + 1)
                    ))
            engine = InferenceEngine(
                experiment, replicas, gar=vote, max_batch=args.max_batch,
                seed=args.seed, device=args.device,
            )
            # through the continuous scheduler: the production path
            preds, disagreement, batches = serve_through_scheduler(
                engine, x_eval, request_rows=args.request_rows,
                lanes=args.lanes,
            )
            suspects = [
                int(i) for i, v in enumerate(disagreement) if not np.isfinite(v)
            ]
            match_rate = float(np.mean(preds == clean_preds))
            cell = {
                "gar": gar_name,
                "fault": fault_name,
                "nb_replicas": args.replicas,
                "nb_faulty": int(args.nb_faulty if mode else 0),
                "accuracy": float(np.mean(preds == y_eval)),
                "match_rate": match_rate,
                "masked": bool(match_rate >= args.match_bar),
                "disagreement": [
                    float(v) if np.isfinite(v) else None for v in disagreement
                ],
                "suspects": suspects,
                "batches": int(batches),
                "compile_count": int(engine.compile_count),
                "nb_buckets": len(engine.buckets),
            }
            cells.append(cell)
            info("  cell %-12s x %-12s accuracy=%.3f match=%.3f masked=%s"
                 % (gar_name, fault_name, cell["accuracy"], match_rate, cell["masked"]))

    return {
        "schema": SCHEMA,
        "experiment": args.experiment,
        "nb_replicas": args.replicas,
        "nb_faulty": args.nb_faulty,
        "steps_trained": int(steps_trained),
        "eval_rows": int(len(y_eval)),
        "request_rows": int(args.request_rows),
        "lanes": int(args.lanes),
        "match_bar": args.match_bar,
        "clean_accuracy": clean_accuracy,
        "cells": cells,
    }


def write_report(matrix, path):
    gars_seen = sorted({c["gar"] for c in matrix["cells"]})
    faults = []
    for cell in matrix["cells"]:
        if cell["fault"] not in faults:
            faults.append(cell["fault"])
    by = {(c["gar"], c["fault"]): c for c in matrix["cells"]}
    lines = [
        "# Serving replica-fault campaign",
        "",
        "Experiment `%s` — R=%d replicas (%d faulty per fault cell), %d eval rows, "
        "clean single-replica accuracy **%.3f**.  A cell is **masked** when the "
        "voted predictions match the clean baseline at rate >= %.3f."
        % (matrix["experiment"], matrix["nb_replicas"], matrix["nb_faulty"],
           matrix["eval_rows"], matrix["clean_accuracy"], matrix["match_bar"]),
        "",
        "| vote \\ fault | " + " | ".join(faults) + " |",
        "|---|" + "---|" * len(faults),
    ]
    for gar_name in gars_seen:
        row = ["`%s`" % gar_name]
        for fault in faults:
            cell = by[(gar_name, fault)]
            row.append("%s acc %.3f / match %.3f"
                       % ("MASKED" if cell["masked"] else "degraded",
                          cell["accuracy"], cell["match_rate"]))
        lines.append("| " + " | ".join(row) + " |")
    lines += [
        "",
        "Per-replica disagreement flags the faulty members (null = non-finite "
        "= maximal): see `suspects` per cell in the JSON matrix.",
    ]
    with open(path, "w") as fd:
        fd.write("\n".join(lines) + "\n")


def main(argv=None):
    args = build_parser().parse_args(argv)
    matrix = run_campaign(args)
    if args.output:
        with open(args.output, "w") as fd:
            json.dump(matrix, fd, indent=1)
    if args.report:
        write_report(matrix, args.report)
    if not args.output and not args.report:
        json.dump(matrix, sys.stdout, indent=1)
        sys.stdout.write("\n")
    return 0


def cli():
    from ..cli import console_entry

    return console_entry(main)


if __name__ == "__main__":
    sys.exit(cli())
