"""Training runner: robust SGD of one experiment on one device.

Counterpart of ``aggregathor_tpu/cli/runner.py`` for the main path, with
the same flags and defaults: experiment / aggregator selection with
``key:value`` sub-arguments, the n/f/r worker counts and their checks, the
attack, the lossy link (``--UDP``), the optimizer and learning-rate
registries, the step count, the seed, the evaluation cadence and TSV, plus
``--device``.  It runs on CUDA unless ``--device cpu`` is given; with no GPU
and no ``--device cpu`` it fails instead of falling back.

At the end it prints steps/s excluding the first step (the reference's own
metric, runner.py:595-597), the final evaluation and each kernel's launch
count.  Seeds follow the JAX runner: parameters from ``--seed``, the train
batches from ``--seed + 1``.

Example::

  python3 -m aggregathor_tpu_torch.cli.runner --experiment cnnet \\
      --aggregator krum --nb-workers 8 --nb-decl-byz-workers 2 \\
      --nb-real-byz-workers 2 --attack signflip --max-step 100
"""

import argparse
import math
import sys
import time


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
    parser.add_argument("--evaluation-delta", type=int, default=None, help="eval every this many steps")
    parser.add_argument("--evaluation-file", default=None, help="TSV evaluation log path")
    parser.add_argument(
        "--device", default="cuda", choices=("cuda", "cpu"),
        help="where to train (default cuda; without a GPU, cuda fails instead of falling back)",
    )
    return parser


def main(argv=None):
    """Run the training; returns a summary dict (steps, steps/s excluding
    the first step, final loss and evaluation, kernel launches, device)."""
    args = build_parser().parse_args(argv)

    import torch

    from .. import config, gars, models
    from ..core import build_optimizer, build_schedule
    from ..obs.evalfile import EvalFile
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
        train_iter = experiment.make_train_iterator(n, seed=args.seed + 1)
        info("Training %s on %s: %d workers, f=%d, r=%d, aggregator %s, d=%d"
             % (args.experiment, torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                n, f, r, args.aggregator, sum(p.numel() for p in state.params.values())))

    max_step = config.default_max_step if args.max_step is None else args.max_step
    eval_delta = config.default_evaluation_delta if args.evaluation_delta is None else args.evaluation_delta
    eval_file = EvalFile(args.evaluation_file)

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

    def synchronize():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    launches_before = kernels.launch_counts()
    metrics, evaluation, last_eval = {}, None, None
    first_done = end = None
    try:
        with Context("train"):
            start = time.perf_counter()
            pending = None  # the previous step's loss, checked one step late
            for step in range(1, max_step + 1):
                state, metrics = step_fn(state, engine.put_batch(next(train_iter)))
                if pending is not None and not math.isfinite(float(pending)):
                    raise UserException("Training diverged (non-finite loss around step %d)" % (step - 1))
                pending = metrics["total_loss"]
                if step == 1:
                    synchronize()
                    first_done = time.perf_counter()
                if eval_delta > 0 and step % eval_delta == 0:
                    evaluation, last_eval = run_eval(step), step
            synchronize()
            end = time.perf_counter()
            if pending is not None and not math.isfinite(float(pending)):
                raise UserException("Training diverged (non-finite loss around step %d)" % max_step)
        if max_step > 0 and last_eval != max_step:
            evaluation = run_eval(max_step)
    finally:
        eval_file.close()

    steps_per_s = (max_step - 1) / (end - first_done) if max_step > 1 else 0.0
    launches = {name: count - launches_before[name] for name, count in kernels.launch_counts().items()}
    info("Performance report:")
    info("  steps                 %d" % max_step)
    if max_step > 0:
        info("  first step            %.3f s" % (first_done - start))
    info("  steps/s (excl. 1st)   %.3f" % steps_per_s)
    if evaluation is not None:
        info("  final evaluation      %s" % "  ".join("%s=%.4f" % kv for kv in sorted(evaluation.items())))
    info("  kernel launches       %s" % "  ".join("%s=%d" % kv for kv in sorted(launches.items())))
    return {
        "steps": max_step,
        "steps_per_s": steps_per_s,
        "final_loss": float(metrics["total_loss"]) if metrics else None,
        "evaluation": evaluation,
        "launches": launches,
        "device": str(device),
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
