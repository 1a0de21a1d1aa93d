"""Training runner: robust SGD of one experiment on one device.

Counterpart of ``aggregathor_tpu/cli/runner.py`` for the main path, with
the same flags and defaults: experiment / aggregator selection with
``key:value`` sub-arguments, the n/f/r worker counts and their checks, the
attack, the lossy link (``--UDP``), the optimizer and learning-rate
registries, the step count, the seed, and the evaluation, checkpoint and
summary cadences (each fires on a step delta or a wall period, at its first
check, and once more at the end unless the run diverged), the input path
(``--unroll``, ``--prefetch``, ``--input-source``), the engine's robustness
options (``--worker-momentum``, ``--reputation-decay``,
``--quarantine-threshold``, ``--worker-metrics``, ``--exchange-dtype``,
``--granularity``, ``--leaf-bucketing``, ``--trace-ops``), the flight
recorder (``--flight``, ``--flight-dump``), the metrics plane
(``--gar-probe``, ``--metrics-file``, ``--trace-file``, ``--trace``,
``--trace-dir``, ``--live-port``, ``--live-host``, ``--live-ready-file``,
``--run-id``) and ``--input-slices``, plus ``--device``.  It runs on
CUDA unless ``--device cpu`` is given; with no GPU and no ``--device cpu``
it fails instead of falling back.

A summary event carries, beside the four scalars, the worker diagnostics
the engine computes (``worker_sq_dist`` and ``suspect_worker``, the most
distant worker with a finite distance; ``worker_participation``,
``worker_reputation``, ``nb_quarantined``) and, under ``--flight``, the
ring's row count from one fetch.  When the run crashes or diverges, the
ring is dumped to ``--flight-dump`` before the state is dropped.

The input path follows the JAX runner's.  ``--unroll K`` runs K steps per
call (``RobustEngine.build_multi_step`` on a (K, n, ...) chunk), the
cadences firing at chunk granularity and the divergence check reading the
chunk's per-step losses; the final (max_step - start) % K steps run one at
a time.  ``--prefetch D`` (default 2) keeps D device batches ready from a
background thread (``datasets.DevicePrefetcher``); under ``--unroll`` it
runs the chunk pipeline (``datasets.ChunkPipeline``: a sharded gather into
two ping-pong host buffers, pinned on CUDA, ``--input-slices`` transfers a
chunk, assembled on the card).
``--input-source device`` puts the train split on the device once and draws
each worker's batch there every step (``build_sampled_multi_step``; the
final steps through a tail-sized trainer); it refuses an experiment whose
``train_arrays()`` is None and moves a host augmentation to the in-step
tier.

With ``--checkpoint-dir`` it restores the latest snapshot there at start:
the evaluation TSV loses its rows past the restored step and the batch
streams are fast-forwarded to it (before any prefetch thread starts), so a
resumed run consumes exactly the batches of an uninterrupted one (on the CPU
it ends with the same bits); a device-sampled run needs no fast-forward, its
draws being a function of the step.

The metrics plane follows the JAX runner's too: the training gauges and
counters (``train_*``, ``gar_*``, ``bytes_on_wire_total``, the flight and
input-pipeline families, the perf report's) live on the process-wide
registry (``obs/metrics.py``), updated at each summary fire and written as
Prometheus text to ``--metrics-file`` at each fire and at exit (a diverged
or crashed run included); ``--live-port`` serves them with ``/status`` and
``/healthz`` (``obs/live.py``); ``--trace-file`` writes a Chrome trace of
host spans (``obs/trace.py``: ``host_gap``, ``input``, ``block.loss_fetch``,
``eval``, ``summaries``, ``flight.fetch``, ``gar.*``, the checkpoint's);
``--gar-probe`` times the rule alone at the run's (n, d) at each summary
fire (``RobustEngine.build_gar_probe``); ``--trace`` records three steps
with ``torch.profiler`` (CPU and CUDA activities) into ``--trace-dir`` as a
Chrome trace, and fails the run when the card's activity is missing from
it.  ``--run-id`` stamps the summaries, the span trace and ``/status``.

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
import os
import sys
import time

import numpy as np


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
    parser.add_argument(
        "--unroll", type=int, default=1,
        help="run this many steps per call (cadences then fire at chunk granularity)",
    )
    parser.add_argument(
        "--prefetch", type=int, default=2, metavar="DEPTH",
        help="device-ready input batches (--unroll: chunks) prepared ahead of the step "
             "by a background thread (0 disables)",
    )
    parser.add_argument(
        "--input-slices", type=int, default=4, metavar="S",
        help="transfer slices per --unroll chunk in the input pipeline: each slice's host->device copy is "
             "issued as soon as it is gathered (1 = one transfer a chunk)",
    )
    parser.add_argument(
        "--input-source", default="stream", choices=["stream", "device"],
        help="stream: per-step host batches. device: hold the training split on the "
             "device (transferred once) and draw each worker's fresh i.i.d. batch there; "
             "needs an experiment exposing train_arrays() (no host-side transform)",
    )
    parser.add_argument(
        "--exchange-dtype", default=None, choices=["float32", "bfloat16"],
        help="wire precision of the gradient exchange (bfloat16 halves the bytes; the GAR computes in float32)",
    )
    parser.add_argument(
        "--worker-momentum", type=float, default=None, metavar="BETA",
        help="workers send momenta (beta in (0,1)) instead of raw gradients: history-aware robustness "
             "(Karimireddy et al. 2021)",
    )
    parser.add_argument(
        "--granularity", default="vector", choices=["vector", "leaf", "layer", "global"],
        help="apply the rule to the whole flattened gradient (vector, the reference's semantics) or per "
             "parameter leaf (leaf: per-layer selection; each layer picks its own honest set); layer and "
             "global need the sharded engine",
    )
    parser.add_argument(
        "--leaf-bucketing", default="auto", choices=["auto", "on", "off"],
        help="granularity:leaf implementation: on batches same-sized leaves into one rule call (not "
             "available in this port: it needs batched kernels); auto and off loop over the leaves",
    )
    parser.add_argument(
        "--reputation-decay", type=float, default=None, metavar="BETA",
        help="track a per-worker reputation EMA (1 = trusted) of a rank signal: was the worker's raw "
             "gradient among the n-f closest to the applied aggregate this step",
    )
    parser.add_argument(
        "--quarantine-threshold", type=float, default=0.0, metavar="T",
        help="workers whose reputation falls below T are excluded from aggregation (row masked NaN; needs "
             "a NaN-tolerant rule); they are re-admitted when their raw gradients re-approach the "
             "aggregate (requires --reputation-decay)",
    )
    parser.add_argument(
        "--worker-metrics", action="store_true",
        help="record per-worker suspicion diagnostics each summary: squared distance to the aggregate "
             "and, for selection rules, the worker's participation weight",
    )
    parser.add_argument(
        "--flight", type=int, default=0, metavar="CAPACITY",
        help="flight recorder: a CAPACITY-row ring of per-step telemetry (loss, update norm, probe "
             "flags, per-worker distances) on the device, written in the step, fetched once per summary "
             "fire and dumped post-mortem on a crash or divergence; 0 disables",
    )
    parser.add_argument(
        "--flight-dump", default=None, metavar="JSON",
        help="write the flight-recorder window here when the run crashes or diverges (schema "
             "aggregathor.obs.flight.v1; requires --flight)",
    )
    parser.add_argument(
        "--trace-ops", action="store_true",
        help="per-op terminal narrative: print a marker after each phase of the step body (gradients, "
             "aggregate, apply); debug cadence only",
    )
    parser.add_argument(
        "--gar-probe", action="store_true",
        help="measure the GAR's wall time at each summary fire: one rule-only aggregation at the run's exact "
             "(n, d), timed under a gar.aggregate span and exported as gar_seconds_total / gar_probe_seconds "
             "on the metrics registry",
    )
    parser.add_argument("--trace", action="store_true",
                        help="record a torch.profiler trace (CPU and CUDA) of a few steps into --trace-dir")
    parser.add_argument("--trace-dir", default="trace", help="profiler trace output directory")
    parser.add_argument(
        "--trace-file", default=None, metavar="PATH",
        help="whole-run host span trace (obs/trace): input, host-gap, loss-fetch, eval, summary, GAR-probe "
             "and checkpoint spans as Chrome trace-event JSON, Perfetto-loadable",
    )
    parser.add_argument(
        "--metrics-file", default=None, metavar="PATH",
        help="dump the process-wide metrics registry as Prometheus text exposition here at every summary "
             "fire and at exit (the final flush runs on divergence and crashes too)",
    )
    parser.add_argument(
        "--live-port", type=int, default=None, metavar="PORT",
        help="serve a live exporter for this training run (obs/live.py): /metrics (Prometheus text of the "
             "registry), /status (step progress, steps/s, the latest flight window), /healthz; 0 binds an "
             "ephemeral port",
    )
    parser.add_argument("--live-host", default="127.0.0.1", metavar="HOST", help="bind address of the live exporter")
    parser.add_argument(
        "--live-ready-file", default=None, metavar="PATH",
        help="write 'host port' here once the live exporter is bound (requires --live-port)",
    )
    parser.add_argument(
        "--run-id", default=None, metavar="ID",
        help="run id stamped on every summary line, the span trace's metadata and /status (default: generated)",
    )
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
    launches, the device, the performance report (``perf``), the run id, the
    input pipeline that fed the loop (``input_pipeline``: its class name, or
    None) with its consumer's wait (``input_wait_s``), and the GAR probe's
    calls (``gar_probe_calls``, its warm-up included)."""
    args = build_parser().parse_args(argv)

    import torch

    from .. import config, gars, models
    from ..core import build_optimizer, build_schedule
    from ..obs.cadence import CadenceTrigger
    from ..obs.checkpoint import Checkpoints
    from ..obs.evalfile import EvalFile
    from ..obs.perf import PerfReport
    from ..models.datasets import ChunkPipeline, DevicePrefetcher
    from ..obs import flight as obs_flight, live as obs_live, metrics as obs_metrics, trace
    from ..obs.summaries import SummaryWriter, make_run_id
    from ..ops import kernels
    from ..parallel import RobustEngine, attacks, compress
    from ..parallel.engine import index_metrics, stack_metrics
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
    unroll = max(1, args.unroll)
    if args.flight < 0:
        raise UserException("--flight wants a nonnegative ring capacity")
    if args.flight_dump and not args.flight:
        raise UserException("--flight-dump needs --flight CAPACITY")
    if args.live_ready_file and args.live_port is None:
        raise UserException("--live-ready-file needs --live-port")
    if args.granularity in ("layer", "global"):
        raise UserException("--granularity %s needs the sharded engine (--mesh), which this port does not carry yet"
                            % args.granularity)
    if args.leaf_bucketing != "auto" and args.granularity != "leaf":
        warning("--leaf-bucketing only affects --granularity leaf; ignored for granularity %r" % args.granularity)
    flight_rec = None
    if args.flight:
        flight_rec = obs_flight.FlightRecorder(args.flight, n, probe=True, worker_metrics=args.worker_metrics)
        if args.flight < unroll:
            warning("--flight capacity %d < --unroll %d: a summary fetch cannot cover the whole last chunk; "
                    "size the ring to at least the unroll (ideally the summary delta)" % (args.flight, unroll))
    run_id = args.run_id if args.run_id else make_run_id()
    registry = obs_metrics.REGISTRY

    with Context("setup"):
        experiment = models.instantiate(args.experiment, args.experiment_args)
        if args.input_source == "device":
            if experiment.train_arrays() is None and experiment.route_augmentation_to_device():
                # the host tier's in-step twin takes over (its draws change:
                # the engine's keyed streams, as the sample stream's do)
                info("--input-source device: routing %r augmentation through the in-step device tier"
                     % getattr(experiment, "preprocessing", "host"))
            if experiment.train_arrays() is None:
                raise UserException(
                    "--input-source device: experiment %r keeps a host-side batch transform "
                    "(train_arrays() is None), so a device-side gather cannot reproduce its input "
                    "stream; use --input-source stream" % args.experiment
                )
        gar = gars.instantiate(args.aggregator, n, f, args.aggregator_args)
        attack = attacks.instantiate(args.attack, n, r, args.attack_args) if args.attack else None
        lossy = LossyLink(args.udp, args.udp_args) if args.udp > 0 else None
        tx = build_optimizer(args.optimizer, build_schedule(args.learning_rate, args.learning_rate_args),
                             args.optimizer_args)
        engine = RobustEngine(
            gar, n, nb_real_byz=r, attack=attack, lossy_link=lossy, exchange_dtype=args.exchange_dtype,
            worker_momentum=args.worker_momentum, batch_transform=experiment.device_transform(),
            worker_metrics=args.worker_metrics, reputation_decay=args.reputation_decay,
            quarantine_threshold=args.quarantine_threshold, granularity=args.granularity,
            leaf_bucketing={"auto": "auto", "on": True, "off": False}[args.leaf_bucketing],
            trace_ops=args.trace_ops, flight=flight_rec, device=device)
        state = engine.init_state(experiment.init(args.seed), tx, seed=args.seed)
        model_dim = sum(p.numel() for p in state.params.values())
        step_fn = engine.build_step(experiment.loss, tx)
        device_dataset = None
        if args.input_source == "device":
            # the train split lives on the device; every step is sampled there
            device_dataset = engine.replicate(experiment.train_arrays())
            multi_fn = engine.build_sampled_multi_step(experiment.loss, tx, unroll, experiment.batch_size)
        else:
            multi_fn = engine.build_multi_step(experiment.loss, tx) if unroll > 1 else None
        eval_fn = engine.build_eval_sums(experiment.metrics)
        info("Training %s on %s: %d workers, f=%d, r=%d, aggregator %s, d=%d"
             % (args.experiment, torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                n, f, r, args.aggregator, model_dim))

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
    summaries = SummaryWriter(args.summary_dir, run_id=run_id)

    # Training gauges and counters on the process-wide registry, as the JAX
    # runner registers them: the summary's values, updated at every fire
    g_loss = registry.gauge("train_loss", "Last summarized total training loss")
    g_grad_norm = registry.gauge("train_grad_norm", "Last summarized aggregate norm")
    g_lr = registry.gauge("train_learning_rate", "Learning rate at the last summary")
    g_steps_per_s = registry.gauge("train_steps_per_second", "Throughput excluding the first (compile) step")
    registry.gauge("train_chaos_regime", "Active chaos regime index")  # 0: chaos is not ported
    g_quarantined = registry.gauge("train_quarantined_workers", "Workers under quarantine")
    g_worker_dist = registry.gauge("train_worker_sq_dist", "Per-worker squared distance to the aggregate",
                                   labelnames=("worker",))
    g_worker_rep = registry.gauge("train_worker_reputation", "Per-worker reputation EMA (1 = trusted)",
                                  labelnames=("worker",))
    c_gar_seconds = registry.counter("gar_seconds_total", "Cumulative measured GAR aggregation wall time")
    g_gar_probe = registry.gauge("gar_probe_seconds", "Last measured single-aggregation GAR wall time")
    c_wire_bytes = registry.counter("bytes_on_wire_total", "Gradient-exchange submission bytes shipped over the wire")
    registry.gauge("exchange_compression_ratio", "f32-wire bytes over configured-exchange bytes (>= 1)").set(
        compress.compression_ratio(model_dim, engine.exchange_dtype))
    wire_step_bytes = n * compress.bytes_per_row(model_dim, engine.exchange_dtype)
    c_flight_fetches = registry.counter("flight_fetches_total", "Flight-recorder ring fetches")
    g_flight_rows = registry.gauge("flight_window_steps", "Rows in the last fetched flight window")
    g_flight_last = registry.gauge("flight_last_step", "Completed step of the newest fetched flight row")
    live_state = {"step": 0, "flight": None}
    probe = {"fn": None, "calls": 0}

    def synchronize():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    @trace.span("eval", cat="eval")
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

    def time_gar_probe(step):
        """One timed rule-only aggregation (``--gar-probe``): the probe is
        built and run once at the first fire (outside the timing), then each
        fire times one aggregation, the card drained before and after."""
        if probe["fn"] is None:
            with trace.span("gar.probe_build", cat="train"):
                probe["fn"] = engine.build_gar_probe(model_dim)
                probe["fn"](0)
                probe["calls"] += 1
                synchronize()
        with trace.span("gar.aggregate", cat="train"):
            synchronize()  # the step's queued work is not the rule's
            begin = time.perf_counter()
            probe["fn"](step)
            synchronize()
            elapsed = time.perf_counter() - begin
        probe["calls"] += 1
        c_gar_seconds.inc(elapsed)
        g_gar_probe.set(elapsed)
        return elapsed

    def summary_scalars(step, metrics):
        """The summary event: the four scalars, the worker diagnostics the
        engine computes, the GAR probe's time and the flight ring's row count
        (one ring fetch); mirrored into the registry."""
        scalars = {
            "total_loss": float(metrics["total_loss"]),
            "grad_norm": float(metrics["grad_norm"]),
            "learning_rate": float(tx.schedule(step)),
            "steps_per_s": perf.steps_per_s_excl_first(),
        }
        if "worker_sq_dist" in metrics:
            wdist = metrics["worker_sq_dist"].cpu().numpy()
            scalars["worker_sq_dist"] = wdist
            # the most distant live worker: a masked row (lossy NaN infill,
            # quarantine) has a non-finite distance and shows in
            # nb_quarantined/participation instead; no finite entry, no suspect
            if np.any(np.isfinite(wdist)):
                scalars["suspect_worker"] = int(np.argmax(np.where(np.isfinite(wdist), wdist, -np.inf)))
        for name in ("worker_participation", "worker_reputation"):
            if name in metrics:
                scalars[name] = metrics[name].cpu().numpy()
        if "nb_quarantined" in metrics:
            scalars["nb_quarantined"] = int(metrics["nb_quarantined"])
        if args.gar_probe:
            scalars["gar_seconds"] = time_gar_probe(step)
        if flight_rec is not None:
            with trace.span("flight.fetch", cat="obs"):
                window = flight_rec.fetch(state.flight)
            c_flight_fetches.inc()
            nb_rows = int(window["step"].size)
            g_flight_rows.set(nb_rows)
            if nb_rows:
                g_flight_last.set(int(window["step"][-1]) + 1)
            live_state["flight"] = obs_flight.summarize_window(window)
            scalars["flight_rows"] = nb_rows
        g_loss.set(scalars["total_loss"])
        g_grad_norm.set(scalars["grad_norm"])
        g_lr.set(scalars["learning_rate"])
        g_steps_per_s.set(scalars["steps_per_s"])
        if "nb_quarantined" in scalars:
            g_quarantined.set(scalars["nb_quarantined"])
        if "worker_sq_dist" in scalars:
            for w, value in enumerate(scalars["worker_sq_dist"]):
                g_worker_dist.labels(worker=str(w)).set(float(value) if np.isfinite(value) else float("inf"))
        if "worker_reputation" in scalars:
            for w, value in enumerate(scalars["worker_reputation"]):
                g_worker_rep.labels(worker=str(w)).set(float(value))
        return scalars

    def fire_summary(step, metrics):
        with trace.span("summaries", cat="obs"):
            summaries.scalars(step, summary_scalars(step, metrics))
        dump_metrics_file()

    def dump_metrics_file():
        if not args.metrics_file:
            return
        tmp = args.metrics_file + ".tmp"
        with open(tmp, "w") as fd:
            fd.write(registry.render_prometheus())
        os.replace(tmp, args.metrics_file)

    def flight_postmortem(reason):
        """Fetch the ring and dump it (``--flight-dump``) before the state
        is dropped: the per-step evidence of the window that ended the run."""
        if flight_rec is None or not args.flight_dump:
            return
        window = flight_rec.fetch(state.flight)
        obs_flight.dump_window(args.flight_dump, window, run_id=run_id, reason=reason,
                               capacity=flight_rec.capacity, extra={"at_step": int(step)})
        info("Flight post-mortem (%s) -> %r (%d row(s))" % (reason, args.flight_dump, int(window["step"].size)))

    def check_divergence():
        # the loss of the last step (the losses of the last chunk) dispatched,
        # read one call late in the loop (on the card, the read waits for the
        # call queued before it)
        nonlocal diverged
        if pending is None:
            return
        with trace.span("block.loss_fetch", cat="train"):
            finite = bool(torch.all(torch.isfinite(pending)))
        if not finite:
            diverged = True
            raise UserException("Training diverged (non-finite loss around step %d)" % step)

    # --trace: torch.profiler over three steps, one step a call, from the
    # first call boundary at or past the third step (after the first call
    # and a warm-up; under --unroll, after the first chunk); its Chrome
    # trace must hold the card's activity, or the run fails
    profiler = {"prof": None, "done": not args.trace, "start": None}

    def profiler_start():
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
        profiler["prof"], profiler["start"] = profile(activities=activities), step
        profiler["prof"].start()

    def profiler_stop():
        prof, profiler["prof"], profiler["done"] = profiler["prof"], None, True
        synchronize()
        prof.stop()
        os.makedirs(args.trace_dir, exist_ok=True)
        path = os.path.join(args.trace_dir, "%s.pt.trace.json" % run_id)
        prof.export_chrome_trace(path)
        if device.type == "cuda" and not any(
                event.device_type == torch.autograd.DeviceType.CUDA for event in prof.events()):
            raise UserException("--trace: torch.profiler recorded no activity on the card (is CUPTI available?); "
                                "trace %r holds the host's events only" % path)
        info("Profiler trace of steps %d-%d written to %r" % (profiler["start"] + 1, step, path))

    # host_gap: the wall time between one call returning and the next one
    # starting (input, cadences); started and stopped by hand across turns
    gap = {"span": None}

    def gap_open():
        if trace.installed() is not None:
            gap["span"] = trace.span("host_gap", cat="train").start()

    def gap_close():
        if gap["span"] is not None:
            gap["span"].stop()
            gap["span"] = None

    launches_before = kernels.launch_counts()
    metrics, evaluation, perf, report, prefetcher, live = {}, None, None, None, None, None
    step, diverged, offstep = 0, False, 0
    if args.trace_file:
        trace.install(args.trace_file, run_id=run_id)
        info("Span tracing to %r (run_id %s)" % (args.trace_file, run_id))
    try:
        # Auto-restore the latest snapshot, then realign the batch streams:
        # the per-step attack and lossy streams derive from (seed, step,
        # worker, tag), so the restored step is all they need
        if checkpoints is not None and checkpoints.can_restore():
            with Context("restore"):
                state, offstep = checkpoints.restore(state)
            dropped = eval_file.truncate_after(offstep)
            if dropped:
                info("Trimmed %d stale eval row(s) beyond restored step %d" % (dropped, offstep))
        train_iter = None
        if device_dataset is None:
            train_iter = experiment.make_train_iterator(n, seed=args.seed + 1)
            train_iter.skip(offstep)  # before a prefetch thread draws from it
            chunks = (max_step - offstep) // unroll
            if args.prefetch > 0 and multi_fn is None:
                prefetcher = DevicePrefetcher(train_iter, engine.put_batch, depth=args.prefetch, device=device)
            elif args.prefetch > 0 and not args.trace and chunks > 0:
                # a finite producer: exactly the chunks the loop consumes, so
                # it has left train_iter when the per-step tail reads it
                # (--trace runs some steps one at a time: no chunk producer)
                prefetcher = ChunkPipeline(train_iter, unroll, chunks, put=engine.put_batches,
                                           assemble=engine.assemble_batches, depth=args.prefetch,
                                           slices=args.input_slices, registry=registry, device=device)
        feeder = prefetcher  # the tail may close it: kept for the result
        step, pending, loop_steps_per_s = offstep, None, 0.0
        live_state["step"] = step
        perf = PerfReport(registry=registry)
        if args.live_port is not None:
            def live_status():
                return {"step": live_state["step"], "max_step": max_step,
                        "steps_per_s": perf.steps_per_s_excl_first(), "flight": live_state["flight"], "slo": None}

            live = obs_live.LiveExporter(registry=registry, status_provider=live_status, run_id=run_id,
                                         host=args.live_host, port=args.live_port)
            live_addr = live.serve_background()
            if args.live_ready_file:
                ready_dir = os.path.dirname(args.live_ready_file)
                if ready_dir:
                    os.makedirs(ready_dir, exist_ok=True)
                tmp = args.live_ready_file + ".tmp"
                with open(tmp, "w") as fd:
                    fd.write("%s %d\n" % live_addr)
                os.replace(tmp, args.live_ready_file)
        with Context("train"):
            while step < max_step:
                if not profiler["done"] and profiler["prof"] is None and step >= offstep + 2:
                    profiler_start()
                one_at_a_time = profiler["prof"] is not None
                if multi_fn is not None and max_step - step >= unroll and not one_at_a_time:
                    with trace.span("input", cat="train"):
                        if device_dataset is not None:
                            chunk_input = device_dataset
                        elif prefetcher is not None:
                            chunk_input = next(prefetcher)
                        else:
                            chunk_input = engine.put_batches(train_iter.next_many(unroll))
                    gap_close()
                    perf.step_begin()
                    state, many = multi_fn(state, chunk_input)
                    chunk = unroll
                elif device_dataset is not None:
                    # the final (max_step - start) % unroll steps, sampled too
                    # (under --trace's window, one step a call)
                    chunk = 1 if one_at_a_time else max_step - step
                    tail = engine.build_sampled_multi_step(experiment.loss, tx, chunk, experiment.batch_size)
                    gap_close()
                    perf.step_begin()
                    state, many = tail(state, device_dataset)
                else:
                    if multi_fn is not None and prefetcher is not None:
                        prefetcher.close()  # the chunk producer is done: the tail reads train_iter
                        prefetcher = None
                    with trace.span("input", cat="train"):
                        batch = next(prefetcher) if prefetcher is not None else engine.put_batch(next(train_iter))
                    gap_close()
                    perf.step_begin()
                    state, step_metrics = step_fn(state, batch)
                    many = stack_metrics([step_metrics])
                    chunk = 1
                check_divergence()
                if step == offstep:
                    synchronize()  # the first call, whole (its time is left out of steps/s)
                perf.step_end(chunk)
                gap_open()
                step += chunk
                c_wire_bytes.inc(chunk * wire_step_bytes)
                live_state["step"] = step
                pending = many["total_loss"]
                metrics = index_metrics(many, -1)
                if profiler["prof"] is not None and step >= profiler["start"] + 3:
                    profiler_stop()
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
                    fire_summary(step, metrics)
                    summary_trigger.fired(step)
            check_divergence()
            synchronize()
            loop_steps_per_s = perf.steps_per_s_excl_first()
            if profiler["prof"] is not None:
                profiler_stop()  # a run shorter than the window
            # the final fire of each cadence, unless it fired at this step
            # (a diverged run never gets here: no final snapshot of NaNs)
            if step > offstep:
                if eval_trigger.enabled and eval_trigger.last_step != step:
                    evaluation = run_eval(step)
                if checkpoints is not None and ckpt_trigger.last_step != step:
                    checkpoints.save(state, step)
                if summary_trigger.last_step != step:
                    fire_summary(step, metrics)
    finally:
        aborting = sys.exc_info()[0] is not None
        gap_close()
        # Each flush runs whatever failed before it; while the run's own
        # error propagates a flush failure is logged, otherwise the first
        # one is raised at the end (lost telemetry must not pass silently)
        flush_errors = []

        def flush(label, fn):
            try:
                fn()
            except Exception as exc:
                warning("Telemetry flush (%s) failed: %s" % (label, exc))
                if not aborting:
                    flush_errors.append(exc)

        if diverged or aborting:
            flush("flight-postmortem", lambda: flight_postmortem("divergence" if diverged else "crash"))
        if profiler["prof"] is not None:
            flush("profiler", profiler_stop)
        if prefetcher is not None:
            prefetcher.close()
        eval_file.close()
        summaries.close()
        flush("metrics-file", dump_metrics_file)
        if args.trace_file:
            def save_span_trace():
                written = trace.uninstall(save=True)
                if written:
                    info("Span trace -> %r (run_id %s)" % (written, run_id))

            flush("trace", save_span_trace)
        if live is not None:
            flush("live-exporter", live.shutdown_all)
        if perf is not None:
            report = perf.report()
        if checkpoints is not None:
            if aborting:
                try:
                    checkpoints.wait(shutdown=True)
                except Exception as exc:  # the run's own error stays the one raised
                    warning("Checkpoint write failed during abort: %s" % exc)
            else:
                checkpoints.wait(shutdown=True)
        if flush_errors:
            raise flush_errors[0]

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
        "run_id": run_id,
        "input_pipeline": type(feeder).__name__ if feeder is not None else None,
        "input_wait_s": getattr(feeder, "wait_seconds", None),
        "gar_probe_calls": probe["calls"],
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
