"""Serving runner: checkpoint -> Byzantine-robust HTTP inference.

Counterpart of ``aggregathor_tpu/cli/serve.py``, with its options and
defaults; ``--device`` (default ``cuda``, raising without a GPU) takes the
place of ``--platform``.  It loads a trained checkpoint (the
``obs/checkpoint.py`` restore: tags, encryption and custody under the
training flags ``--session-secret``, ``--encrypt-checkpoints``,
``--no-legacy-checkpoint-tags``, ``--allow-unsigned``), builds an R-way
replicated :class:`serve.engine.InferenceEngine` with a GAR vote over the
replica logits, and serves ``/predict``, ``/healthz``, ``/metrics`` and
``/status`` through the asyncio front end (``serve/frontend.py``),
continuous batching (``--lanes``/``--max-lanes``/``--linger-ms``),
optional autoscaling (``--autoscale``) and the weight pipeline
(``--follow``).

Replica sources: one ``--ckpt-dir`` + ``--replicas R`` serves R copies of
the latest snapshot (identical replicas: the vote then masks injected faults
exactly); several ``--ckpt-dir`` paths serve one replica each.

``--poison-replica INDEX:MODE[=VALUE]`` (repeatable) injects the replica
faults of ``chaos/replica_faults.py`` (nan / scale / zero / noise / stale),
RE-APPLIED on every hot swap.  With ``--session-secret`` every restored
checkpoint's signed lineage manifest is verified before loading (an unsigned
one is refused unless ``--allow-unsigned``) and ``/healthz`` reports
``custody_verified``; hot swaps verify through the same path.

Signals: ``SIGTERM`` drains (``/status`` flips ``draining``, in-flight
requests finish, the process exits at quiescence or after
``--drain-timeout``, journaled as ``serve_drain``); ``SIGHUP`` reloads the
newest snapshot now (requests keep flowing; a bad snapshot keeps the
previous weights); ``SIGINT`` stops at once.  The ``--ready-file``
(``host port pid``) is written only after the bucket-ladder warmup and the
bind, so its reader's first request never meets a cold bucket.

Example::

  python -m aggregathor_tpu_torch.cli.serve --experiment cnnet \\
      --ckpt-dir out/ckpt --replicas 3 --gar median \\
      --port 8000 --max-batch 64 --lanes 2 --max-lanes 4 --autoscale \\
      --follow
"""

import argparse
import os
import signal
import sys
import threading
import time


def build_parser():
    parser = argparse.ArgumentParser(
        prog="aggregathor-torch serve",
        description="Byzantine-robust batched inference serving",
    )
    parser.add_argument("--experiment", required=True, help="experiment name (models registry)")
    parser.add_argument("--experiment-args", nargs="*", default=[], help="key:value experiment arguments")
    parser.add_argument("--ckpt-dir", nargs="+", required=True, metavar="DIR",
                        help="checkpoint directory (one: replicated --replicas times; "
                             "several: one replica each)")
    parser.add_argument("--ckpt-step", type=int, default=None,
                        help="serve this snapshot step (default: latest per directory)")
    parser.add_argument("--checkpoint-base-name", default=None, help="checkpoint file base name")
    parser.add_argument("--replicas", type=int, default=None,
                        help="replica count R (default: number of --ckpt-dir paths)")
    parser.add_argument("--gar", default="median",
                        help="vote rule over replica logits (gars registry; 'none' disables "
                             "the vote and serves replica 0)")
    parser.add_argument("--gar-args", nargs="*", default=[], help="key:value vote-rule arguments")
    parser.add_argument("--replica-byz", type=int, default=None, metavar="F",
                        help="declared faulty-replica budget f for the vote rule "
                             "(default (R-1)//2)")
    parser.add_argument("--poison-replica", action="append", default=[], metavar="IDX:MODE[=V]",
                        help="chaos tie-in: corrupt replica IDX with a replica fault "
                             "(nan|scale=X|zero|noise=S|stale); repeatable; re-applied "
                             "on every hot swap")
    # Restore template: must match the optimizer the snapshot was trained with
    parser.add_argument("--optimizer", default="sgd", help="optimizer the checkpoint was trained with")
    parser.add_argument("--optimizer-args", nargs="*", default=[], help="key:value optimizer arguments")
    parser.add_argument("--session-secret", default=None, metavar="SECRET",
                        help="verify checkpoint HMAC tags under this secret (training's "
                             "--session-secret; restore fails on tampered snapshots)")
    parser.add_argument("--no-legacy-checkpoint-tags", action="store_true",
                        help="refuse snapshots tagged under the legacy key scheme")
    parser.add_argument("--encrypt-checkpoints", action="store_true",
                        help="snapshots are encrypted at rest (requires --session-secret)")
    parser.add_argument("--allow-unsigned", action="store_true",
                        help="serve checkpoints WITHOUT a custody manifest: with "
                             "--session-secret the chain-of-custody manifest "
                             "(written by --secure training) is verified before "
                             "loading and an unsigned checkpoint is REFUSED "
                             "unless this explicit opt-out is passed "
                             "(/healthz then reports custody_verified false)")
    # Scheduling / shedding (serve/continuous.py)
    parser.add_argument("--max-batch", type=int, default=64, help="bucket ladder top / batch cap")
    parser.add_argument("--buckets", default=None, metavar="B1,B2,...",
                        help="explicit bucket ladder (default: powers of two up to --max-batch)")
    parser.add_argument("--lanes", type=int, default=1,
                        help="initial dispatch lanes (concurrent in-flight batches over "
                             "the one bucket ladder)")
    parser.add_argument("--max-lanes", type=int, default=None,
                        help="lane ceiling the autoscaler may climb to (default --lanes)")
    parser.add_argument("--linger-ms", type=float, default=0.0,
                        help="optional sub-top coalescing window; 0 = pure continuous "
                             "batching (dispatch the instant a lane frees)")
    parser.add_argument("--queue-bound", type=int, default=256,
                        help="queued-row bound beyond which requests are shed (HTTP 429)")
    parser.add_argument("--flag-threshold", type=float, default=None,
                        help="flag a replica suspect when its disagreement exceeds this "
                             "(non-finite always flags)")
    parser.add_argument("--no-warmup", action="store_true",
                        help="skip running the bucket ladder up front (first requests "
                             "then pay the kernel builds)")
    # Autoscaling (serve/autoscale.py)
    parser.add_argument("--autoscale", action="store_true",
                        help="scale lanes (and, under sustained pressure, the vote pool "
                             "within the declared-f floor) from the live registry")
    parser.add_argument("--autoscale-args", nargs="*", default=[], metavar="K:V",
                        help="autoscale knobs (serve/autoscale.py AutoscaleConfig: "
                             "interval, high-queue, low-queue, high-p99, low-p99, "
                             "high-shed, low-shed, up-patience, down-patience, "
                             "cooldown, fault-reserve, min-lanes)")
    # Weight pipeline (serve/weights.py)
    parser.add_argument("--follow", action="store_true",
                        help="follow the checkpoint director(ies): poll for newer "
                             "snapshots and hot-swap them in (custody re-verified, "
                             "zero dropped requests)")
    parser.add_argument("--follow-interval", type=float, default=2.0, metavar="S",
                        help="snapshot poll period in seconds for --follow")
    # HTTP / observability
    parser.add_argument("--host", default="127.0.0.1", help="bind address")
    parser.add_argument("--port", type=int, default=8000, help="bind port (0 = ephemeral)")
    parser.add_argument("--ready-file", default=None, metavar="PATH",
                        help="write 'host port pid' here once the warmup is "
                             "done AND the front end is bound (harness handshake)")
    parser.add_argument("--summary-dir", default=None,
                        help="JSONL serve_batch/serve_shed/serve_autoscale/"
                             "serve_weight_swap event directory (obs/summaries)")
    parser.add_argument("--trace-file", default=None, metavar="PATH",
                        help="write a Chrome trace-event JSON of the request "
                             "lifecycle spans (enqueue -> batch -> forward -> reply) "
                             "here at shutdown — Perfetto-loadable (obs/trace)")
    parser.add_argument("--journal", default=None, metavar="JSONL",
                        help="causal run journal (obs/events.py): append every "
                             "serving decision — autoscale moves, weight swaps "
                             "and their failures — as typed JSONL (schema "
                             "aggregathor.obs.events.v2); merged fleet-wide by "
                             "a fleet collector's /fleet/journal")
    parser.add_argument("--run-id", default=None, metavar="ID",
                        help="run id stamped on summary lines and trace metadata "
                             "(default: generated)")
    parser.add_argument("--request-timeout", type=float, default=60.0,
                        help="seconds a /predict handler waits on its batch")
    parser.add_argument("--drain-timeout", type=float, default=30.0, metavar="S",
                        help="SIGTERM drain bound: seconds to wait for in-flight "
                             "requests to finish (the fleet router re-routes new "
                             "traffic off a draining /status) before exiting anyway")
    parser.add_argument("--seed", type=int, default=0, help="base PRNG seed (template init)")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="where to serve (default cuda; without a GPU, cuda fails instead "
                             "of falling back)")
    from . import add_causal_flags

    add_causal_flags(parser)
    return parser


def load_replicas(args, experiment, step=None):
    """Resolve the replica parameter sets: checkpoint restores + poison specs.

    Returns ``(replicas, sources, custody_verified, served_step)`` —
    ``sources`` is the human-readable per-replica provenance logged at
    startup and reported by /healthz's operator story ("which checkpoint is
    replica 2, and is it poisoned?"); ``custody_verified`` is the
    chain-of-custody verdict (True = every restored checkpoint's signed
    lineage manifest verified, False = an unsigned restore was allowed
    through ``--allow-unsigned``, None = no ``--session-secret``,
    verification not attempted); ``served_step`` is the step the non-stale
    replicas restored at (None when distinct directories restored at
    different steps — a mixed pool has no one step to tag responses with).
    ``step`` pins the restore (the weight pipeline's reload path, beating
    ``args.ckpt_step``).  Called again on every hot swap, so a fresh
    custody tally is built per load and poison specs are re-applied.
    """
    from .. import config
    from ..chaos.replica_faults import corrupt_params, parse_poison
    from ..core import build_optimizer, build_schedule
    from ..obs.checkpoint import Checkpoints
    from ..serve.engine import restore_params
    from ..utils import UserException

    tx = build_optimizer(
        args.optimizer, build_schedule("fixed", ["initial-rate:0.01"]), args.optimizer_args
    )
    authenticator = None
    cipher = None
    custody = None
    if args.encrypt_checkpoints and not args.session_secret:
        raise UserException("--encrypt-checkpoints derives its key from --session-secret; pass both")
    if args.session_secret:
        from ..parallel.auth import GradientAuthenticator
        from ..secure import ChainOfCustody

        authenticator = GradientAuthenticator(args.session_secret.encode(), 1, context=b"ckpt")
        custody = ChainOfCustody(
            args.session_secret.encode(), allow_unsigned=args.allow_unsigned
        )
        if args.encrypt_checkpoints:
            from ..parallel.crypto import SnapshotCipher

            cipher = SnapshotCipher(args.session_secret.encode())

    def restore(directory, step=None):
        return restore_params(
            experiment, directory, tx, step=step, seed=args.seed,
            base_name=args.checkpoint_base_name,
            authenticator=authenticator, cipher=cipher,
            allow_legacy_tags=not args.no_legacy_checkpoint_tags,
            custody=custody,
        )

    dirs = list(args.ckpt_dir)
    nb_replicas = args.replicas if args.replicas is not None else len(dirs)
    if nb_replicas < 1:
        raise UserException("--replicas must be >= 1")
    if len(dirs) == 1:
        dirs = dirs * nb_replicas
    elif len(dirs) != nb_replicas:
        raise UserException(
            "%d --ckpt-dir paths but --replicas %d: give one directory, or one per replica"
            % (len(dirs), nb_replicas)
        )

    poisons = {}
    for spec in args.poison_replica:
        index, mode, value = parse_poison(spec)
        if index >= nb_replicas:
            raise UserException(
                "--poison-replica %r: replica %d does not exist (R=%d)"
                % (spec, index, nb_replicas)
            )
        if index in poisons:
            raise UserException("--poison-replica: replica %d poisoned twice" % index)
        poisons[index] = (mode, value)

    pinned = step if step is not None else args.ckpt_step
    replicas, sources = [], []
    steps_seen = set()
    cache = {}
    for index, directory in enumerate(dirs):
        poison = poisons.get(index)
        if poison is not None and poison[0] == "stale":
            on_disk = Checkpoints(
                directory,
                args.checkpoint_base_name if args.checkpoint_base_name is not None
                else config.default_checkpoint_base_name,
            ).steps()
            if len(on_disk) < 2:
                raise UserException(
                    "--poison-replica %d:stale needs at least two snapshots in %r"
                    % (index, directory)
                )
            params, at_step = restore(directory, step=on_disk[0])
            sources.append("%s@%d (stale)" % (directory, at_step))
        else:
            key = (directory, pinned)
            if key not in cache:
                cache[key] = restore(directory, step=pinned)
            params, at_step = cache[key]
            steps_seen.add(int(at_step))
            if poison is not None:
                mode, value = poison
                params = corrupt_params(params, mode, value, seed=args.seed + 31 * index)
                sources.append("%s@%d (poisoned: %s)" % (directory, at_step, mode))
            else:
                sources.append("%s@%d" % (directory, at_step))
        replicas.append(params)
    custody_verified = None if custody is None else custody.all_verified
    served_step = steps_seen.pop() if len(steps_seen) == 1 else None
    return replicas, sources, custody_verified, served_step


def main(argv=None):
    args = build_parser().parse_args(argv)
    from .. import config, gars, models
    from ..obs import trace
    from ..obs.checkpoint import Checkpoints
    from ..obs.summaries import SummaryWriter, make_run_id
    from ..serve import (
        AutoscaleConfig,
        CheckpointWatcher,
        InferenceEngine,
        InferenceServer,
        PoolAutoscaler,
    )
    from ..utils import Context, UserException, info, resolve_device

    device = resolve_device(args.device)  # a card that is not there fails first
    run_id = args.run_id if args.run_id else make_run_id()
    if args.trace_file:
        # installed before the warmup, so its serve.forward spans land too
        trace.install(args.trace_file, run_id=run_id)
    if args.journal:
        from . import parse_cause_flag
        from ..obs import events as obs_events

        obs_events.install(args.journal, run_id=run_id,
                           max_bytes=args.journal_max_bytes)
        obs_events.emit("run_start", role="serve",
                        experiment=args.experiment, pid=os.getpid(),
                        cause=parse_cause_flag(args.cause))
        info("Run journal to %r (run_id %s)" % (args.journal, run_id))

    with Context("load"):
        experiment = models.instantiate(args.experiment, args.experiment_args)
        replicas, sources, custody_verified, served_step = load_replicas(args, experiment)
        nb_replicas = len(replicas)
        for index, source in enumerate(sources):
            info("replica %d: %s" % (index, source))
        if custody_verified is not None:
            info("chain of custody: %s" % (
                "VERIFIED (every replica's lineage manifest checks out)"
                if custody_verified else
                "UNVERIFIED (unsigned checkpoint allowed by --allow-unsigned)"
            ))
        vote = None
        if args.gar != "none" and nb_replicas > 1:
            f = args.replica_byz if args.replica_byz is not None else (nb_replicas - 1) // 2
            vote = gars.instantiate(args.gar, nb_replicas, f, list(args.gar_args))
        elif args.gar != "none" and args.poison_replica:
            raise UserException(
                "Poisoned single-replica serving has no vote to mask the fault; "
                "use --replicas >= 2 (R >= 2f+1 for median)"
            )
        buckets = None
        if args.buckets:
            buckets = [int(b) for b in args.buckets.split(",")]

    with Context("warmup"):
        engine = InferenceEngine(
            experiment, replicas, gar=vote, max_batch=args.max_batch,
            buckets=buckets, seed=args.seed, weights_step=served_step, device=device,
        )
        if not args.no_warmup:
            engine.warmup()

    summaries = SummaryWriter(args.summary_dir, run_name="serve", run_id=run_id)
    server = InferenceServer(
        engine, host=args.host, port=args.port,
        queue_bound=args.queue_bound,
        lanes=args.lanes, max_lanes=args.max_lanes,
        linger_s=args.linger_ms / 1e3,
        summaries=summaries,
        request_timeout_s=args.request_timeout,
        flag_threshold=args.flag_threshold,
        custody_verified=custody_verified,
    )

    # the card's side of the vote, beside the serve_* instruments: each GAR
    # kernel's launches and the kernel builds since start (a reader tells
    # which kernels served, and that nothing was built after the warmup)
    from ..ops import build as ops_build
    from ..ops import kernels as ops_kernels

    launches = server.registry.gauge("serve_kernel_launches", "Launches of each GAR kernel on the card since "
                                     "start (a vote on the CPU launches none)", labelnames=("kernel",))
    for name in ops_kernels.KERNELS:
        launches.labels(kernel=name).set_function(lambda name=name: ops_kernels.KERNELS[name].launches)
    server.registry.gauge("serve_kernel_builds", "Kernel library builds (compiler runs) since start").set_function(
        lambda: ops_build.BUILD_STATS["builds"])

    def reload_step(step):
        """The weight pipeline's reload: re-restore every replica at
        ``step`` through the full custody path (poison specs re-applied),
        swap atomically, update /healthz's verdict.  Raising keeps the
        previous weights serving (CheckpointWatcher's contract)."""
        fresh, fresh_sources, fresh_custody, _ = load_replicas(
            args, experiment, step=step
        )
        engine.swap_replicas(fresh, step=step)
        server.set_custody_verified(fresh_custody)
        for index, source in enumerate(fresh_sources):
            info("hot swap: replica %d <- %s" % (index, source))

    def poll_steps():
        """Steps available in EVERY checkpoint directory (a multi-dir pool
        only swaps when all its sources reached the step)."""
        base_name = (args.checkpoint_base_name
                     if args.checkpoint_base_name is not None
                     else config.default_checkpoint_base_name)
        common = None
        for directory in dict.fromkeys(args.ckpt_dir):
            steps = set(Checkpoints(directory, base_name).steps())
            common = steps if common is None else (common & steps)
        return sorted(common or ())

    watcher = CheckpointWatcher(
        poll_steps, reload_step, served_step=served_step,
        interval_s=args.follow_interval, summaries=summaries,
    )
    autoscaler = None
    if args.autoscale:
        autoscaler = PoolAutoscaler(server, AutoscaleConfig(args.autoscale_args))

    from ..obs import events as obs_events

    stop = threading.Event()
    draining = threading.Event()

    def on_signal(signum, frame):
        info("Signal %d: immediate shutdown" % signum)
        stop.set()

    def on_drain(signum, frame):
        # SIGTERM = the fleet-clean exit: /status flips ``draining`` so the
        # router stops sending NEW traffic here, in-flight requests (and any
        # stragglers that race the scrape window) finish, and we leave at
        # quiescence — bounded by --drain-timeout so a wedged queue cannot
        # hold the process hostage.
        if draining.is_set():
            info("Signal %d: already draining; forcing shutdown" % signum)
            stop.set()
            return
        draining.set()
        info("Signal %d: draining (timeout %gs)" % (signum, args.drain_timeout))
        server.begin_drain()

        def wait_quiescent():
            obs_events.emit("serve_drain", phase="begin",
                            in_flight=server.scheduler.in_flight,
                            queue_depth=server.scheduler.queue_depth)
            deadline = time.monotonic() + args.drain_timeout
            while time.monotonic() < deadline and not server.is_quiescent():
                time.sleep(0.05)
            obs_events.emit("serve_drain", phase="finished",
                            quiescent=server.is_quiescent())
            stop.set()

        threading.Thread(target=wait_quiescent, daemon=True,
                         name="serve-drain").start()

    def on_reload(signum, frame):
        # off the signal handler: a reload restores checkpoints (seconds of
        # work) and the watcher lock serializes it against the poll thread
        info("Signal %d: hot checkpoint restore" % signum)
        threading.Thread(
            target=watcher.check_once, kwargs={"force": True}, daemon=True
        ).start()

    previous = {
        signal.SIGINT: signal.signal(signal.SIGINT, on_signal),
        signal.SIGTERM: signal.signal(signal.SIGTERM, on_drain),
        signal.SIGHUP: signal.signal(signal.SIGHUP, on_reload),
    }
    try:
        host, port = server.serve_background()
        if args.follow:
            watcher.start()
            info("weight pipeline: following %r every %gs (served step %r)"
                 % (list(args.ckpt_dir), args.follow_interval, served_step))
        if autoscaler is not None:
            autoscaler.start()
            info("autoscale: %d capacity rung(s), starting at %d"
                 % (len(autoscaler.ladder), autoscaler.rung))
        # The handshake contract: by the time the ready file exists, the
        # bucket ladder has run (warmup above, unless explicitly skipped)
        # and the port accepts connections: a reader's first request never
        # races a cold bucket.
        if args.ready_file:
            tmp = args.ready_file + ".tmp"
            with open(tmp, "w") as fd:
                fd.write("%s %d %d\n" % (host, port, os.getpid()))
            os.replace(tmp, args.ready_file)  # atomic: readers never see a torn line
        info("Serving %s on http://%s:%d (%d replica(s), vote=%s)"
             % (args.experiment, host, port, nb_replicas,
                type(vote).__name__ if vote else "none"))
        stop.wait()
    finally:
        for signum, handler in previous.items():
            signal.signal(signum, handler)
        if autoscaler is not None:
            autoscaler.close()
        watcher.close()
        server.shutdown_all()
        summaries.close()
        if args.journal:
            from ..obs import events as obs_events

            if obs_events.installed() is not None:
                obs_events.emit("run_end", role="serve")
                written = obs_events.uninstall()
                info("Run journal -> %r (run_id %s)" % (written, run_id))
        if args.trace_file:
            written = trace.uninstall(save=True)
            if written:
                info("Trace written to %r (run_id %s)" % (written, run_id))
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
