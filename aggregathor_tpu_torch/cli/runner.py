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
``--run-id``), ``--input-slices``, the guardian (``--guardian``,
``--guardian-args``), the run journal (``--journal``, ``--cause``,
``--journal-max-bytes``), the reference's drop-in compatibility flags and
``--device``.  It runs on CUDA unless ``--device cpu`` is given; with no
GPU and no ``--device cpu`` it fails instead of falling back.

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

The guardian follows the JAX runner's rollback-and-escalate
(``aggregathor_tpu/cli/runner.py:2183-2350``).  The watchdog
(``guardian/watchdog.py``) reads each completed step's probe one call late,
as the divergence check does; on a non-finite loss or a sustained spike the
runner restores the last-known-good snapshot (pinned at a checkpoint save
whose call read clean, or the auto-restored one), or starts from a fresh
state with a strided seed when none is pinned, perturbs the random streams
(the restored ``seed`` is replaced by one drawn from ``SeedSequence([seed,
RNG_PERTURB_TAG + attempt])``, the port's counterpart of JAX's
``fold_in``), climbs one rung of the escalation ladder (``f+K``, ``gar=``,
``quarantine``, ``lr*X``) by rebuilding its engine and step functions,
drops the abandoned timeline's snapshots and evaluation rows, and rebuilds
the input stream from a reseeded iterator.  Only the watchdog's verdicts
roll back: a CUDA error, a kernel that fails to build or launch, or an
exception other than a refused rung ends the run.  ``--journal`` writes
every decision (``obs/events.py``) with the run's start and end.

The compatibility flags of the reference: ``--stdout-to``/``--stderr-to``
tee the streams, ``--use-gpu``/``--reuse-gpu`` and ``--platform cpu|gpu|
cuda`` choose ``--device`` (a TPU request refuses: the port has no TPU
backend), ``--backend-timeout`` bounds the first CUDA initialisation, and
the cluster flags (``--client``, ``--server``, the job names, ``--MPI``,
``--no-wait``) are accepted and warned about once.

SIGINT and SIGTERM stop the run as the JAX runner's handlers do
(``aggregathor_tpu/cli/runner.py:680-708``): they are installed before the
device is initialised; the first signal lets the step in flight finish, and
the loop then ends as at ``--max-step`` (the final evaluation, checkpoint
and summary fires, the metrics file, the span trace and the journal's
``run_end``); a second raises ``KeyboardInterrupt``.  The original handlers
come back when ``main`` returns or raises.  Outside the main thread no
handler is installed.

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
import signal
import sys
import time
import types

import numpy as np

from . import add_causal_flags


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
        "--guardian", action="store_true",
        help="in-loop divergence watchdog + rollback-and-escalate recovery (guardian/): on sustained "
             "divergence, restore the last-known-good snapshot, perturb the random streams and climb the "
             "escalation ladder (raise f -> stronger GAR -> quarantine -> damp lr) with bounded retries; "
             "needs --checkpoint-dir",
    )
    parser.add_argument(
        "--guardian-args", nargs="*", default=[],
        help="key:value watchdog options (patience:N, spike:X, retries:N, backoff:B, recover:N, "
             "ladder:RUNG,RUNG,... -- see guardian/escalate.py for the ladder grammar)",
    )
    parser.add_argument(
        "--journal", default=None, metavar="JSONL",
        help="causal run journal (obs/events.py): append every decision event -- guardian rollback "
             "decisions, rollbacks, escalations and recoveries, flight post-mortems -- as typed JSONL "
             "(schema aggregathor.obs.events.v2) with run_id, step, wall and monotonic time; host-side only",
    )
    add_causal_flags(parser)
    parser.add_argument(
        "--device", default="cuda", choices=("cuda", "cpu"),
        help="where to train (default cuda; without a GPU, cuda fails instead of falling back)",
    )
    parser.add_argument(
        "--backend-timeout", type=float, default=300.0, metavar="SECONDS",
        help="fail loudly if CUDA does not initialize in this many seconds (a wedged card otherwise hangs "
             "forever); <= 0 waits indefinitely",
    )
    # Drop-in compatibility with the reference's driver scripts (JAX
    # runner.py:491-516): the device flags choose --device, the cluster
    # flags are accepted and warned about once
    parser.add_argument("--platform", default=None,
                        help="compat: cpu, or gpu/cuda, sets --device (there is no TPU backend)")
    parser.add_argument("--stdout-to", default=None, help="replicate stdout to this file")
    parser.add_argument("--stderr-to", default=None, help="replicate stderr to this file")
    parser.add_argument("--use-tpu", action="store_true",
                        help="compat: refused unless --use-gpu is given too (there is no TPU backend)")
    parser.add_argument("--use-gpu", action="store_true", help="compat: --device cuda")
    parser.add_argument("--reuse-tpu", action="store_true", help="compat: implies --use-tpu")
    parser.add_argument("--reuse-gpu", action="store_true", help="compat: implies --use-gpu")
    for flag, meta in (
        ("--client", "TARGET"), ("--server", "SPEC"), ("--ps-job-name", "NAME"),
        ("--ev-job-name", "NAME"), ("--wk-job-name", "NAME"),
    ):
        parser.add_argument(flag, default=None, metavar=meta,
                            help="compat no-op: cluster/session topology dissolved")
    parser.add_argument("--MPI", action="store_true", dest="mpi", help="compat no-op: there is no MPI transport")
    parser.add_argument("--no-wait", action="store_true", help="compat no-op: there is no server process to linger")
    return parser


def resolve_device_flags(args):
    """Map the reference's device flags onto ``args.device`` (JAX
    ``runner.py:529-541``).  ``--platform`` wins over the preference flags,
    as in JAX; a TPU request refuses instead of running on the CPU (the
    port has no TPU backend, and a quiet fallback would hide the device)."""
    from ..utils import UserException

    wanted = None
    if args.platform:
        platform = args.platform.strip().lower()
        if platform == "cpu":
            wanted = "cpu"
        elif platform in ("gpu", "cuda"):
            wanted = "cuda"
        else:
            raise UserException("--platform %r: this port runs on cuda (gpu) or cpu; it has no TPU or other "
                                "backend" % args.platform)
    elif args.use_gpu or args.reuse_gpu:
        wanted = "cuda"
    elif args.use_tpu or args.reuse_tpu:
        raise UserException("--use-tpu/--reuse-tpu: this port has no TPU backend; pass --use-gpu or --device cuda "
                            "(or --device cpu)")
    if wanted == "cuda" and args.device == "cpu":
        raise UserException("--device cpu contradicts %s, which asks for the GPU"
                            % ("--platform %s" % args.platform if args.platform else "--use-gpu/--reuse-gpu"))
    if wanted is not None:
        args.device = wanted
    return args.device


def wait_for_cuda(timeout):
    """Initialise CUDA on a daemon thread and fail loudly if it does not
    finish within ``timeout`` seconds (JAX ``runner.py:739-764``, which
    probes ``jax.devices()`` the same way): a wedged card can hang the
    initialisation indefinitely and uninterruptibly."""
    import threading

    import torch

    from ..utils import UserException

    done = threading.Event()
    errors = []

    def probe():
        try:
            torch.cuda.init()
        except BaseException as exc:  # surfaced below
            errors.append(exc)
        finally:
            done.set()

    threading.Thread(target=probe, daemon=True, name="backend-probe").start()
    if not done.wait(timeout):
        raise UserException("CUDA did not initialize within %.0fs -- the card looks wedged or unreachable; retry "
                            "with --device cpu or raise --backend-timeout" % timeout)
    if errors:
        raise errors[0]


def main(argv=None):
    """Run the training; returns a summary dict: the steps run in this call,
    the step restored from (``restored_step``), steps/s excluding the first
    step (over the training loop), the final loss and evaluation, kernel
    launches, the device, the performance report (``perf``), the run id, the
    input pipeline that fed the loop (``input_pipeline``: its class name, or
    None) with its consumer's wait (``input_wait_s``, summed over the
    pipelines a rollback rebuilt), the GAR probe's calls
    (``gar_probe_calls``, its warm-up included), and the guardian's
    timeline: ``rollbacks`` (one dict a rollback: ``from_step``,
    ``to_step``, ``attempt``, ``restored_snapshot``), ``escalations`` (the
    rung specs applied), ``recovered`` (the steps at which recovery was
    declared) and ``steps_by_overrides`` (steps dispatched under each
    ``Overrides.describe()``, abandoned calls included)."""
    args = build_parser().parse_args(argv)
    from ..utils import warning

    # the stop handlers come first, so a signal during the device's
    # initialisation or the first step is a stop, not a kill
    stop = {"requested": False}

    def on_signal(signum, frame):
        if stop["requested"]:
            # a second signal aborts: the step in flight may hang
            warning("Interrupted twice: aborting now")
            raise KeyboardInterrupt
        stop["requested"] = True
        warning("Interrupted: finishing current step then shutting down (interrupt again to abort immediately)")

    try:
        previous_handlers = {signum: signal.signal(signum, on_signal) for signum in (signal.SIGINT, signal.SIGTERM)}
    except ValueError:
        # not the main thread (an embedded runner): the host application
        # keeps its signal handling
        previous_handlers = {}
    try:
        return _run(args, stop)
    finally:
        for signum, handler in previous_handlers.items():
            signal.signal(signum, handler)


def _run(args, stop):
    """``main``'s body; ``stop["requested"]`` ends the loop at the next step
    boundary."""
    import torch

    from .. import config, gars, models
    from ..core import build_optimizer, build_schedule
    from ..guardian import RESEED_STRIDE, RNG_PERTURB_TAG, GuardianConfig, Overrides, Watchdog, note_escalation
    from ..guardian import probe as health
    from ..obs.cadence import CadenceTrigger
    from ..obs.checkpoint import Checkpoints
    from ..obs.evalfile import EvalFile
    from ..obs.perf import PerfReport
    from ..models.datasets import ChunkPipeline, DevicePrefetcher
    from ..obs import events as obs_events, flight as obs_flight, live as obs_live, metrics as obs_metrics, trace
    from ..obs.summaries import SummaryWriter, make_run_id
    from ..ops import kernels
    from ..parallel import RobustEngine, attacks, compress
    from ..parallel.engine import fold_in_seed, index_metrics, stack_metrics
    from ..parallel.lossy import LossyLink
    from ..utils import Context, UserException, info, replicate_streams, resolve_device, warning
    from . import parse_cause_flag

    replicate_streams(args.stdout_to, args.stderr_to)
    ignored = [flag for flag, value in (
        ("--client", args.client), ("--server", args.server),
        ("--ps-job-name", args.ps_job_name), ("--ev-job-name", args.ev_job_name),
        ("--wk-job-name", args.wk_job_name), ("--MPI", args.mpi), ("--no-wait", args.no_wait),
    ) if value]
    if ignored:
        warning("Compat no-op flags ignored (cluster topology and transport dissolved under single-controller "
                "SPMD, see docs/transport.md): %s" % " ".join(ignored))
    resolve_device_flags(args)
    if args.device == "cuda" and args.backend_timeout and args.backend_timeout > 0 and torch.cuda.is_available():
        wait_for_cuda(args.backend_timeout)
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
    cause = parse_cause_flag(args.cause)
    # the guardian's configuration is parsed before anything is built, so a
    # bad ladder or threshold fails before the first launch
    guardian = None
    if args.guardian:
        guardian = GuardianConfig(args.guardian_args)
        if not args.checkpoint_dir:
            raise UserException("--guardian rolls back to on-disk snapshots; pass --checkpoint-dir")
    watchdog = Watchdog(guardian) if guardian is not None else None
    # the knobs the escalation ladder may change; the training stack is built
    # from this record so a rollback can rebuild it mid-run
    overrides = Overrides(f, args.aggregator, tuple(args.aggregator_args),
                          reputation_decay=args.reputation_decay, quarantine_threshold=args.quarantine_threshold)
    # the flight recorder's layout is fixed for the run: built once and
    # shared by every rebuilt stack (its ring is per-state)
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
        attack = attacks.instantiate(args.attack, n, r, args.attack_args) if args.attack else None
        lossy = LossyLink(args.udp, args.udp_args) if args.udp > 0 else None
        base_schedule = build_schedule(args.learning_rate, args.learning_rate_args)

        def build_training(ov):
            """The rebuildable half of the run, built from an ``Overrides``
            record (JAX ``TrainingStack``, runner.py:1203-1240): the rule,
            the optimizer, the engine and its step, multi-step and
            evaluation functions.  A rollback that climbs a rung builds a
            new one; the experiment, the attack, the link, the cadences,
            the flight recorder and the registry instruments stay."""
            stack = types.SimpleNamespace(overrides=ov, gar_probe_fn=None)
            stack.gar = gars.instantiate(ov.gar_name, n, ov.f, list(ov.gar_args))
            if ov.lr_scale != 1.0:
                # the ladder's lr damping composes with the named schedule
                def schedule(count, _base=base_schedule, _scale=ov.lr_scale):
                    return _base(count) * _scale
            else:
                schedule = base_schedule
            stack.tx = build_optimizer(args.optimizer, schedule, args.optimizer_args)
            stack.engine = RobustEngine(
                stack.gar, n, nb_real_byz=r, attack=attack, lossy_link=lossy, exchange_dtype=args.exchange_dtype,
                worker_momentum=args.worker_momentum, batch_transform=experiment.device_transform(),
                worker_metrics=args.worker_metrics, reputation_decay=ov.reputation_decay,
                quarantine_threshold=ov.quarantine_threshold, granularity=args.granularity,
                leaf_bucketing={"auto": "auto", "on": True, "off": False}[args.leaf_bucketing],
                trace_ops=args.trace_ops, flight=flight_rec, device=device)
            stack.step_fn = stack.engine.build_step(experiment.loss, stack.tx)
            if args.input_source == "device":
                stack.multi_fn = stack.engine.build_sampled_multi_step(experiment.loss, stack.tx, unroll,
                                                                       experiment.batch_size)
            else:
                stack.multi_fn = stack.engine.build_multi_step(experiment.loss, stack.tx) if unroll > 1 else None
            stack.eval_fn = stack.engine.build_eval_sums(experiment.metrics)
            return stack

        def make_fresh_state(seed):
            # the parameters always from the run's seed; ``seed`` moves only
            # the random streams (a rollback with no snapshot, JAX :1327-1332)
            return ts.engine.init_state(experiment.init(args.seed), ts.tx, seed=seed)

        ts = build_training(overrides)
        state = make_fresh_state(args.seed)
        model_dim = sum(p.numel() for p in state.params.values())
        # the train split lives on the device, uploaded once for the run (JAX
        # uploads it again with every rebuilt stack, :1354-1358; the ladder
        # never changes the data)
        device_dataset = ts.engine.replicate(experiment.train_arrays()) if args.input_source == "device" else None
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
    # the ladder never changes d or the wire: computed once
    c_wire_bytes = registry.counter("bytes_on_wire_total", "Gradient-exchange submission bytes shipped over the wire")
    registry.gauge("exchange_compression_ratio", "f32-wire bytes over configured-exchange bytes (>= 1)").set(
        compress.compression_ratio(model_dim, ts.engine.exchange_dtype))
    wire_step_bytes = n * compress.bytes_per_row(model_dim, ts.engine.exchange_dtype)
    c_rollbacks = registry.counter("guardian_rollbacks_total", "Guardian rollbacks to last-known-good")
    c_escalations = registry.counter("guardian_escalations_total", "Guardian escalation-ladder rungs applied")
    c_recoveries = registry.counter("guardian_recoveries_total", "Guardian diverged-then-recovered verdicts")
    c_flight_fetches = registry.counter("flight_fetches_total", "Flight-recorder ring fetches")
    g_flight_rows = registry.gauge("flight_window_steps", "Rows in the last fetched flight window")
    g_flight_last = registry.gauge("flight_last_step", "Completed step of the newest fetched flight row")
    live_state = {"step": 0, "flight": None}
    probe = {"calls": 0}
    timeline = {"rollbacks": [], "escalations": [], "recovered": [], "steps_by_overrides": {}}

    def synchronize():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    @trace.span("eval", cat="eval")
    def run_eval(step):
        sums = {}
        for batch in experiment.make_eval_iterator(n):
            for name, (total, count) in ts.eval_fn(state, ts.engine.put_batch(batch)).items():
                prev = sums.get(name, (0.0, 0.0))
                sums[name] = (prev[0] + float(total), prev[1] + float(count))
        metrics = {name: total / max(count, 1.0) for name, (total, count) in sums.items()}
        info("Evaluation at step %d: %s" % (step, "  ".join("%s=%.4f" % kv for kv in sorted(metrics.items()))))
        eval_file.append(step, metrics)
        return metrics

    def time_gar_probe(step):
        """One timed rule-only aggregation (``--gar-probe``): the probe is
        built and run once at the first fire of a stack (outside the
        timing), then each fire times one aggregation, the card drained
        before and after."""
        if ts.gar_probe_fn is None:
            with trace.span("gar.probe_build", cat="train"):
                ts.gar_probe_fn = ts.engine.build_gar_probe(model_dim)
                ts.gar_probe_fn(0)
                probe["calls"] += 1
                synchronize()
        with trace.span("gar.aggregate", cat="train"):
            synchronize()  # the step's queued work is not the rule's
            begin = time.perf_counter()
            ts.gar_probe_fn(step)
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
            "learning_rate": float(ts.tx.schedule(step)),
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

    def flight_postmortem(reason, at_step):
        """Fetch the ring and dump it (``--flight-dump``) before the state
        is dropped: the per-step evidence of the window that ended the run
        or forced a rollback (each rollback keeps its own dump,
        ``<root>.rollback-<step><ext>``; the final dump owns the bare
        path).  The journal's event points at the dump (JAX :2026-2063)."""
        if flight_rec is None:
            return None
        try:
            window = flight_rec.fetch(state.flight)
        except Exception as exc:
            warning("flight: post-mortem fetch failed: %s" % exc)
            return None
        summary = obs_flight.summarize_window(window)
        path = None
        if args.flight_dump:
            path = args.flight_dump
            if reason == "guardian_rollback":
                root, ext = os.path.splitext(path)
                path = "%s.rollback-%d%s" % (root, int(at_step), ext or ".json")
            obs_flight.dump_window(path, window, run_id=run_id, reason=reason, capacity=flight_rec.capacity,
                                   extra={"at_step": int(at_step)})
            info("Flight post-mortem (%s) -> %r (%d row(s))" % (reason, path, summary.get("rows", 0)))
        obs_events.emit("flight_postmortem", step=at_step, reason=reason, path=path, rows=summary.get("rows", 0))
        return path

    def check_divergence():
        # the losses of the last call dispatched, read one call late in the
        # loop (on the card, the read waits for the call queued before it)
        nonlocal diverged
        if pending_loss is None:
            return
        with trace.span("block.loss_fetch", cat="train"):
            finite = bool(torch.all(torch.isfinite(pending_loss)))
        if not finite:
            if watchdog is not None:
                return  # the guardian owns divergence: rollback, not abort (JAX :2022-2023)
            diverged = True
            raise UserException("Training diverged (non-finite loss around step %d)" % step)

    def probe_clean(call_metrics):
        """Did every step of this call read healthy by the probe?  Gates the
        last-known-good pin at a checkpoint save (JAX :2171-2180)."""
        view = health.host_view(call_metrics)
        if view is None:
            return True
        return bool(np.all(view["loss_finite"]) and np.all(np.isfinite(view["update_norm"]))
                    and np.all(np.asarray(view["spike"]) <= guardian.spike_factor))

    def reset_input(start_step, reseed=0):
        """(Re)build the input stream positioned at ``start_step`` (JAX
        :1645-1700): at start (the auto-restored step) and after a
        rollback.  At start the stream is fast-forwarded to ``start_step``;
        a rollback passes ``reseed`` > 0 and draws the replay window's
        batches from a fresh stream instead.  The running prefetcher or
        chunk pipeline is closed first (the pipeline waits for its
        in-flight copies: a pinned ``non_blocking`` copy reads its source
        after it returns).  Under ``--input-source device`` nothing is
        built: the state's seed keys the sample stream."""
        nonlocal train_iter, prefetcher
        if prefetcher is not None:
            prefetcher.close()
            prefetcher = None
        if device_dataset is not None:
            return
        train_iter = experiment.make_train_iterator(n, seed=args.seed + 1 + RESEED_STRIDE * reseed)
        if start_step and not reseed:
            train_iter.skip(start_step)  # before a prefetch thread draws from it
        chunks = (max_step - start_step) // unroll
        if args.prefetch > 0 and ts.multi_fn is None:
            prefetcher = DevicePrefetcher(train_iter, ts.engine.put_batch, depth=args.prefetch, device=device)
        elif args.prefetch > 0 and not args.trace and chunks > 0:
            # a finite producer: exactly the chunks the loop consumes, so it
            # has left train_iter when the per-step tail reads it (--trace
            # runs some steps one at a time: no chunk producer)
            prefetcher = ChunkPipeline(train_iter, unroll, chunks, put=ts.engine.put_batches,
                                       assemble=ts.engine.assemble_batches, depth=args.prefetch,
                                       slices=args.input_slices, registry=registry, device=device)
        if prefetcher is not None:
            feeders.append(prefetcher)

    def do_rollback(at_step):
        """Rollback-and-escalate (JAX :2183-2290): restore the last-known-good
        snapshot (or a fresh state when none is pinned), perturb the random
        streams, climb one rung, drop the abandoned timeline."""
        nonlocal state, step, ts, overrides, pending_loss, pending_metrics, diverged
        reason = watchdog.last_reason or "divergence"
        if watchdog.exhausted:
            diverged = True
            raise UserException("guardian: run failed — %s after %d recovery attempt(s) (ladder %s)"
                                % (reason, watchdog.attempts, guardian.ladder.describe()))
        with trace.span("guardian.rollback", cat="guardian", from_step=int(at_step)):
            checkpoints.wait()  # the writer's queue flushed before reading the targets
            target = checkpoints.pinned_step()
            rstep = target if target is not None else 0
            attempt = watchdog.note_rollback(rstep)
            warning("guardian: %s — rolling back from step %d to %s (attempt %d/%d)"
                    % (reason, at_step, "step %d" % rstep if target is not None else "a fresh state",
                       attempt + 1, guardian.retries))
            record = {"reason": reason, "from_step": int(at_step), "to_step": int(rstep), "attempt": attempt,
                      "restored_snapshot": target is not None}
            summaries.event(at_step, "guardian_rollback", record)
            timeline["rollbacks"].append(record)
            c_rollbacks.inc()
            # the ring still holds the diverged timeline's rows: dumped
            # before the state is dropped
            flight_postmortem("guardian_rollback", at_step)
            state = pending_loss = pending_metrics = None  # the old state's memory goes with it
            rung = guardian.ladder.rung(attempt)
            if rung is not None:
                try:
                    new_overrides = rung.apply(overrides)
                    with Context("escalate"):
                        new_ts = build_training(new_overrides)
                    overrides, ts = new_overrides, new_ts
                    info("guardian: escalated — %s (now %s)" % (rung.describe(), overrides.describe()))
                    summaries.event(rstep, "guardian_escalation", {
                        "rung": rung.describe(), "attempt": attempt, "overrides": overrides.describe()})
                    timeline["escalations"].append(rung.describe())
                    c_escalations.inc()
                    note_escalation(rstep, rung, overrides)
                except UserException as exc:
                    warning("guardian: escalation rung %r rejected (%s); retrying with the current configuration"
                            % (rung.describe(), exc))
            if target is not None:
                # restored into a fresh state, whose side buffers (momentum,
                # reputation, loss EMA, flight ring, carry) start over (JAX
                # :2266-2276); the port's streams derive from (seed, step,
                # worker, tag), so the perturbation replaces the seed (trap c)
                state, rstep = checkpoints.restore(make_fresh_state(args.seed), step=target)
                state.seed = fold_in_seed(state.seed, RNG_PERTURB_TAG + attempt)
            else:
                state = make_fresh_state(args.seed + RESEED_STRIDE * (attempt + 1))
            step = rstep
            live_state["step"] = step
            # the abandoned timeline: its snapshots and eval rows would poison
            # a later auto-restore or interleave with the retry's rows
            checkpoints.discard_after(rstep)
            eval_file.truncate_after(rstep)
            for trigger in (eval_trigger, ckpt_trigger, summary_trigger):
                if trigger.last_step is not None and trigger.last_step > rstep:
                    trigger.last_step = rstep
            reset_input(rstep, reseed=attempt + 1)

    def observe_pending():
        """Feed the watchdog the previous call's probe, one observation a
        completed step (JAX :2293-2350).  Returns True when a rollback
        happened: the caller drops the call it has in flight."""
        nonlocal pending_loss, pending_metrics
        if watchdog is None or pending_metrics is None:
            return False
        with trace.span("block.probe_fetch", cat="guardian"):
            view = health.host_view(pending_metrics)
            losses = np.atleast_1d(pending_loss.detach().cpu().numpy())
        start = pending_start
        pending_loss = pending_metrics = None
        if view is None:  # an engine built without the probe
            return False
        finite = np.atleast_1d(view["loss_finite"]).astype(bool)
        spikes = np.atleast_1d(view["spike"]).astype(np.float64)
        for i in range(losses.shape[0]):
            action = watchdog.observe(start + i + 1, float(losses[i]), bool(finite[i]), float(spikes[i]))
            if action == "recovered":
                info("guardian: recovered — %d healthy step(s) since the last rollback" % guardian.recover_after)
                summaries.event(start + i + 1, "guardian_recovered", {
                    "attempt": watchdog.attempts - 1, "overrides": overrides.describe()})
                timeline["recovered"].append(start + i + 1)
                c_recoveries.inc()
            elif action == "rollback":
                do_rollback(start + i + 1)
                return True
        return False

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
    metrics, evaluation, perf, report, prefetcher, live, train_iter = {}, None, None, None, None, None, None
    feeders = []
    step, diverged, offstep = 0, False, 0
    # the divergence check and the watchdog read the previous call's losses
    # and probe (one call late): the call's metrics and its first step
    pending_loss, pending_metrics, pending_start = None, None, 0
    if args.trace_file:
        trace.install(args.trace_file, run_id=run_id)
        info("Span tracing to %r (run_id %s)" % (args.trace_file, run_id))
    if args.journal:
        # before the first step, so every decision lands in one timeline
        # (JAX :818-828, which installs it before its graph phase)
        obs_events.install(args.journal, run_id=run_id, max_bytes=args.journal_max_bytes)
        obs_events.emit("run_start", role="train", experiment=args.experiment, aggregator=args.aggregator,
                        nb_workers=n, declared_f=f, pid=os.getpid(), cause=cause)
        info("Run journal to %r (run_id %s)" % (args.journal, run_id))
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
            if watchdog is not None and offstep > 0:
                # the snapshot this run resumed from is the guardian's first
                # last-known-good (JAX :1604-1609)
                checkpoints.pin(offstep)
        reset_input(offstep)
        step, loop_steps_per_s = offstep, 0.0
        live_state["step"] = step
        perf = PerfReport(registry=registry)
        if args.live_port is not None:
            def live_status():
                return {"step": live_state["step"], "max_step": max_step,
                        "steps_per_s": perf.steps_per_s_excl_first(), "overrides": overrides.describe(),
                        "flight": live_state["flight"], "slo": None}

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
            while True:
                if step >= max_step or stop["requested"]:
                    # the lagged observation first: a rollback here re-enters
                    # training from the restored step (JAX :2357-2363)
                    if observe_pending() and step < max_step and not stop["requested"]:
                        continue
                    check_divergence()
                    break
                if not profiler["done"] and profiler["prof"] is None and step >= offstep + 2:
                    profiler_start()
                one_at_a_time = profiler["prof"] is not None
                if ts.multi_fn is not None and max_step - step >= unroll and not one_at_a_time:
                    with trace.span("input", cat="train"):
                        if device_dataset is not None:
                            chunk_input = device_dataset
                        elif prefetcher is not None:
                            chunk_input = next(prefetcher)
                        else:
                            chunk_input = ts.engine.put_batches(train_iter.next_many(unroll))
                    gap_close()
                    perf.step_begin()
                    state, many = ts.multi_fn(state, chunk_input)
                    chunk = unroll
                elif device_dataset is not None:
                    # the final (max_step - start) % unroll steps, sampled too
                    # (under --trace's window, one step a call)
                    chunk = 1 if one_at_a_time else max_step - step
                    tail = ts.engine.build_sampled_multi_step(experiment.loss, ts.tx, chunk, experiment.batch_size)
                    gap_close()
                    perf.step_begin()
                    state, many = tail(state, device_dataset)
                else:
                    if ts.multi_fn is not None and prefetcher is not None:
                        prefetcher.close()  # the chunk producer is done: the tail reads train_iter
                        prefetcher = None
                    with trace.span("input", cat="train"):
                        batch = next(prefetcher) if prefetcher is not None else ts.engine.put_batch(next(train_iter))
                    gap_close()
                    perf.step_begin()
                    state, step_metrics = ts.step_fn(state, batch)
                    many = stack_metrics([step_metrics])
                    chunk = 1
                described = overrides.describe()
                timeline["steps_by_overrides"][described] = timeline["steps_by_overrides"].get(described, 0) + chunk
                if observe_pending():
                    continue  # the previous call diverged: this one is abandoned
                check_divergence()
                if perf.nb_steps == 0:
                    synchronize()  # the first call, whole (its time is left out of steps/s)
                perf.step_end(chunk)
                gap_open()
                pending_loss, pending_metrics, pending_start = many["total_loss"], many, step
                step += chunk
                c_wire_bytes.inc(chunk * wire_step_bytes)
                live_state["step"] = step
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
                    if watchdog is not None and watchdog.healthy and probe_clean(many):
                        # last-known-good: spared by pruning, the rollback
                        # target; every step of the call must read clean
                        # (JAX :2493-2501)
                        checkpoints.pin(step)
                    ckpt_trigger.fired(step)
                if summary_trigger.should_fire(step):
                    check_divergence()
                    fire_summary(step, metrics)
                    summary_trigger.fired(step)
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

        if (diverged or aborting) and state is not None:
            flush("flight-postmortem", lambda: flight_postmortem("divergence" if diverged else "crash", step))
        if profiler["prof"] is not None:
            flush("profiler", profiler_stop)
        if prefetcher is not None:
            prefetcher.close()
        eval_file.close()
        summaries.close()
        if args.journal and obs_events.installed() is not None:
            # run_end closes the causal timeline (JAX :2596-2613)
            flush("journal-end", lambda: obs_events.emit("run_end", step=step, diverged=diverged,
                                                         aborting=aborting, forensics=None))
        flush("metrics-file", dump_metrics_file)
        if args.trace_file:
            def save_span_trace():
                written = trace.uninstall(save=True)
                if written:
                    info("Span trace -> %r (run_id %s)" % (written, run_id))

            flush("trace", save_span_trace)
        if args.journal and obs_events.installed() is not None:
            def close_journal():
                written = obs_events.uninstall()
                if written:
                    info("Run journal -> %r (run_id %s)" % (written, run_id))

            flush("journal-close", close_journal)
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
    waits = [feeder.wait_seconds for feeder in feeders if getattr(feeder, "wait_seconds", None) is not None]
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
        "input_pipeline": type(feeders[0]).__name__ if feeders else None,
        "input_wait_s": sum(waits) if waits else None,
        "gar_probe_calls": probe["calls"],
        "rollbacks": timeline["rollbacks"],
        "escalations": timeline["escalations"],
        "recovered": timeline["recovered"],
        "steps_by_overrides": timeline["steps_by_overrides"],
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
