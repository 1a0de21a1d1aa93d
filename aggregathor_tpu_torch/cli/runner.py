"""Training runner: robust SGD of one experiment on one device.

Counterpart of ``aggregathor_tpu/cli/runner.py`` for the main path, with
the same flags and defaults: experiment / aggregator selection with
``key:value`` sub-arguments, the n/f/r worker counts and their checks, the
attack, the lossy link (``--UDP``), the optimizer and learning-rate
registries, the step count, the seed, and the evaluation, checkpoint and
summary cadences (each fires on a step delta or a wall period, at its first
check, and once more at the end unless the run diverged), plus
``--device``.  It runs on CUDA unless ``--device cpu`` is given; with no GPU
and no ``--device cpu`` it fails instead of falling back.

With ``--checkpoint-dir`` it restores the latest snapshot there at start:
the evaluation TSV loses its rows past the restored step and the batch
streams are fast-forwarded to it, so a resumed run consumes exactly the
batches of an uninterrupted one (on the CPU it ends with the same bits).

At the end it prints the performance report (in-graph and off-graph time,
step latency percentiles, steps/s with and without the first step), the
final evaluation and each kernel's launch count.  Seeds follow the JAX
runner: parameters from ``--seed``, the train batches from ``--seed + 1``.

Example::

  python3 -m aggregathor_tpu_torch.cli.runner --experiment digits \\
      --aggregator krum --nb-workers 8 --nb-decl-byz-workers 2 \\
      --max-step 4000 --learning-rate-args initial-rate:0.1
"""

import argparse
import math
import sys


def build_parser():
    parser = argparse.ArgumentParser(
        prog="aggregathor-torch runner",
        description="Byzantine-resilient SGD on one GPU (PyTorch + CUDA)",
    )
    parser.add_argument("--experiment", required=True, help="experiment name (see models registry)")
    parser.add_argument("--experiment-args", nargs="*", default=[], help="key:value experiment arguments")
    parser.add_argument("--aggregator", required=True, help="GAR name (see gars registry)")
    parser.add_argument("--aggregator-args", nargs="*", default=[], help="key:value GAR arguments")
    parser.add_argument("--nb-workers", type=int, required=True, help="number n of logical workers")
    parser.add_argument("--nb-decl-byz-workers", type=int, default=0, help="declared Byzantine count f")
    parser.add_argument("--nb-real-byz-workers", type=int, default=0, help="actual attacking worker count")
    parser.add_argument("--attack", default=None, help="gradient attack name")
    parser.add_argument("--attack-args", nargs="*", default=[], help="key:value attack arguments")
    parser.add_argument("--UDP", type=int, default=0, dest="udp", help="first k workers use the lossy link")
    parser.add_argument("--UDP-args", nargs="*", default=[], dest="udp_args", help="key:value lossy-link arguments")
    parser.add_argument("--optimizer", default="sgd", help="optimizer name")
    parser.add_argument("--optimizer-args", nargs="*", default=[], help="key:value optimizer arguments")
    parser.add_argument("--learning-rate", default="fixed", help="learning-rate schedule name")
    parser.add_argument("--learning-rate-args", nargs="*", default=[], help="key:value schedule arguments")
    parser.add_argument("--max-step", type=int, default=None, help="train step count (default config.py)")
    parser.add_argument("--seed", type=int, default=0, help="base seed")
    # Cadences (negative disables; defaults from config.py, as in the JAX runner)
    parser.add_argument("--evaluation-file", default=None, help="TSV evaluation log path")
    parser.add_argument("--evaluation-delta", type=int, default=None, help="eval every this many steps")
    parser.add_argument("--evaluation-period", type=float, default=None, help="eval every this many seconds")
    parser.add_argument("--checkpoint-dir", default=None, help="checkpoint directory")
    parser.add_argument("--checkpoint-base-name", default=None, help="checkpoint file base name")
    parser.add_argument("--checkpoint-delta", type=int, default=None)
    parser.add_argument("--checkpoint-period", type=float, default=None)
    parser.add_argument("--checkpoint-keep", type=int, default=5, help="snapshots to keep")
    parser.add_argument("--summary-dir", default=None, help="JSONL scalar summary directory")
    parser.add_argument("--summary-delta", type=int, default=None)
    parser.add_argument("--summary-period", type=float, default=None)
    parser.add_argument(
        "--device", default="cuda", choices=("cuda", "cpu"),
        help="where to train (default cuda; without a GPU, cuda fails instead of falling back)",
    )
    return parser


def main(argv=None):
    """Run the training; returns a summary dict: the steps run in this call,
    the step restored from (``restored_step``), steps/s excluding the first
    step (over the training loop), the final loss and evaluation, kernel
    launches, the device and the performance report (``perf``)."""
    args = build_parser().parse_args(argv)

    import torch

    from .. import config, gars, models
    from ..core import build_optimizer, build_schedule
    from ..obs.cadence import CadenceTrigger
    from ..obs.checkpoint import Checkpoints
    from ..obs.evalfile import EvalFile
    from ..obs.perf import PerfReport
    from ..obs.summaries import SummaryWriter
    from ..ops import kernels
    from ..parallel import RobustEngine, attacks
    from ..parallel.lossy import LossyLink
    from ..utils import Context, UserException, info, resolve_device, warning

    device = resolve_device(args.device)
    # The JAX package computes in float32.  On CUDA, cuDNN convolutions run in
    # TF32 unless told otherwise (about three decimal digits), and matmuls may
    # be allowed to: pin both to full float32 so the port computes what the
    # reference computes and parity runs compare like with like.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    n, f, r = args.nb_workers, args.nb_decl_byz_workers, args.nb_real_byz_workers
    if n < 1:
        raise UserException("Need at least 1 worker (got %d)" % n)
    if r > n:
        raise UserException("More real Byzantine workers (%d) than workers (%d)" % (r, n))
    if r > f:
        warning("More real Byzantine workers (%d) than declared (%d): the GAR bound is void" % (r, f))
    if n <= 2 * f:
        warning("n = %d <= 2f = %d: most GARs offer no guarantee at this ratio" % (n, 2 * f))

    with Context("setup"):
        experiment = models.instantiate(args.experiment, args.experiment_args)
        gar = gars.instantiate(args.aggregator, n, f, args.aggregator_args)
        attack = attacks.instantiate(args.attack, n, r, args.attack_args) if args.attack else None
        lossy = LossyLink(args.udp, args.udp_args) if args.udp > 0 else None
        tx = build_optimizer(args.optimizer, build_schedule(args.learning_rate, args.learning_rate_args),
                             args.optimizer_args)
        engine = RobustEngine(gar, n, nb_real_byz=r, attack=attack, lossy_link=lossy, device=device)
        state = engine.init_state(experiment.init(args.seed), tx, seed=args.seed)
        step_fn = engine.build_step(experiment.loss, tx)
        eval_fn = engine.build_eval_sums(experiment.metrics)
        info("Training %s on %s: %d workers, f=%d, r=%d, aggregator %s, d=%d"
             % (args.experiment, torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                n, f, r, args.aggregator, sum(p.numel() for p in state.params.values())))

    def pick(value, default):
        return default if value is None else value

    max_step = pick(args.max_step, config.default_max_step)
    eval_trigger = CadenceTrigger(pick(args.evaluation_delta, config.default_evaluation_delta),
                                  pick(args.evaluation_period, config.default_evaluation_period))
    ckpt_trigger = CadenceTrigger(pick(args.checkpoint_delta, config.default_checkpoint_delta),
                                  pick(args.checkpoint_period, config.default_checkpoint_period))
    summary_trigger = CadenceTrigger(pick(args.summary_delta, config.default_summary_delta),
                                     pick(args.summary_period, config.default_summary_period))
    # serialisation and the disk write run on a writer thread; the CPU copy
    # is taken in save(), before the next step updates the parameters
    checkpoints = Checkpoints(
        args.checkpoint_dir, pick(args.checkpoint_base_name, config.default_checkpoint_base_name),
        args.checkpoint_keep, background=True,
    ) if args.checkpoint_dir else None
    eval_file = EvalFile(args.evaluation_file)
    summaries = SummaryWriter(args.summary_dir)

    def run_eval(step):
        sums = {}
        for batch in experiment.make_eval_iterator(n):
            for name, (total, count) in eval_fn(state, engine.put_batch(batch)).items():
                prev = sums.get(name, (0.0, 0.0))
                sums[name] = (prev[0] + float(total), prev[1] + float(count))
        metrics = {name: total / max(count, 1.0) for name, (total, count) in sums.items()}
        info("Evaluation at step %d: %s" % (step, "  ".join("%s=%.4f" % kv for kv in sorted(metrics.items()))))
        eval_file.append(step, metrics)
        return metrics

    def summary_scalars(step, metrics):
        return {
            "total_loss": float(metrics["total_loss"]),
            "grad_norm": float(metrics["grad_norm"]),
            "learning_rate": float(tx.schedule(step)),
            "steps_per_s": perf.steps_per_s_excl_first(),
        }

    def synchronize():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def check_divergence():
        # the loss of the last step dispatched, read one step late in the
        # loop (on the card, the read waits for the step queued before it)
        if pending is not None and not math.isfinite(float(pending)):
            raise UserException("Training diverged (non-finite loss around step %d)" % step)

    launches_before = kernels.launch_counts()
    metrics, evaluation, perf, report = {}, None, None, None
    try:
        # Auto-restore the latest snapshot, then realign the batch streams:
        # the per-step attack and lossy streams derive from (seed, step,
        # worker, tag), so the restored step is all they need
        offstep = 0
        if checkpoints is not None and checkpoints.can_restore():
            with Context("restore"):
                state, offstep = checkpoints.restore(state)
            dropped = eval_file.truncate_after(offstep)
            if dropped:
                info("Trimmed %d stale eval row(s) beyond restored step %d" % (dropped, offstep))
        train_iter = experiment.make_train_iterator(n, seed=args.seed + 1)
        train_iter.skip(offstep)
        step, pending, loop_steps_per_s = offstep, None, 0.0
        perf = PerfReport()
        with Context("train"):
            while step < max_step:
                batch = engine.put_batch(next(train_iter))
                perf.step_begin()
                state, metrics = step_fn(state, batch)
                check_divergence()
                if step == offstep:
                    synchronize()  # the first step, whole (its time is left out of steps/s)
                perf.step_end()
                step += 1
                pending = metrics["total_loss"]
                if eval_trigger.should_fire(step):
                    check_divergence()
                    evaluation = run_eval(step)
                    eval_trigger.fired(step)
                if checkpoints is not None and ckpt_trigger.should_fire(step):
                    check_divergence()
                    checkpoints.wait()  # surface a previous write's failure
                    checkpoints.save(state, step)
                    ckpt_trigger.fired(step)
                if summary_trigger.should_fire(step):
                    check_divergence()
                    summaries.scalars(step, summary_scalars(step, metrics))
                    summary_trigger.fired(step)
            check_divergence()
            synchronize()
            loop_steps_per_s = perf.steps_per_s_excl_first()
            # the final fire of each cadence, unless it fired at this step
            # (a diverged run never gets here: no final snapshot of NaNs)
            if step > offstep:
                if eval_trigger.enabled and eval_trigger.last_step != step:
                    evaluation = run_eval(step)
                if checkpoints is not None and ckpt_trigger.last_step != step:
                    checkpoints.save(state, step)
                if summary_trigger.last_step != step:
                    summaries.scalars(step, summary_scalars(step, metrics))
    finally:
        eval_file.close()
        summaries.close()
        if perf is not None:
            report = perf.report()
        if checkpoints is not None:
            if sys.exc_info()[0] is not None:
                try:
                    checkpoints.wait(shutdown=True)
                except Exception as exc:  # the run's own error stays the one raised
                    warning("Checkpoint write failed during abort: %s" % exc)
            else:
                checkpoints.wait(shutdown=True)

    launches = {name: count - launches_before[name] for name, count in kernels.launch_counts().items()}
    if evaluation is not None:
        info("  final evaluation      %s" % "  ".join("%s=%.4f" % kv for kv in sorted(evaluation.items())))
    info("  kernel launches       %s" % "  ".join("%s=%d" % kv for kv in sorted(launches.items())))
    return {
        "steps": step - offstep,
        "restored_step": offstep,
        "steps_per_s": loop_steps_per_s,
        "final_loss": float(metrics["total_loss"]) if metrics else None,
        "evaluation": evaluation,
        "launches": launches,
        "device": str(device),
        "perf": report,
    }


def cli():
    """Console entry: UserException -> clean error + exit code 1."""
    from ..utils import UserException, error

    try:
        main()
    except UserException as exc:
        error(str(exc))
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(cli())
