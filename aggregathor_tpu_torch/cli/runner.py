"""Training runner: robust SGD of one experiment on one device or a worker axis.

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
``--exchange``, ``--granularity``, ``--leaf-bucketing``, ``--trace-ops``),
the chaos schedule (``--chaos``, ``--chaos-args``), bounded-wait
(``--step-deadline`` and its eleven options, below), the flight
recorder (``--flight``, ``--flight-dump``), the metrics plane
(``--gar-probe``, ``--metrics-file``, ``--trace-file``, ``--trace``,
``--trace-dir``, ``--live-port``, ``--live-host``, ``--live-ready-file``,
``--run-id``), ``--input-slices``, the guardian (``--guardian``,
``--guardian-args``), the run journal (``--journal``, ``--cause``,
``--journal-max-bytes``), the forensics ledger (``--forensics``), the
profiler window (``--xprof``), the worker axis (``--nb-devices``), the
security flags (``--session-secret``, ``--secure``, ``--secure-mask``,
``--allow-unsigned``, ``--no-legacy-checkpoint-tags``,
``--encrypt-checkpoints``, below), the reference's drop-in compatibility
flags and ``--device``.  It runs on CUDA unless ``--device cpu`` is given; with no
GPU and no ``--device cpu`` it fails instead of falling back.

``--chaos SCHEDULE`` (``chaos/schedule.py``) replaces ``--attack`` and
``--UDP`` with regimes that switch at their steps: the log names the
schedule, the regime at the start and each switch, seen at a call
boundary (under ``--unroll`` a switch inside a chunk shows at its end),
where a ``chaos_regime_switch`` summary event is written; the summaries
and the ``train_chaos_regime`` gauge carry the last step's regime, the
evaluation TSV's ``chaos_regime`` column the regime of the last completed
step (``step - 1``), and the forensics ledger each step's regime.  The
schedule's process keys are refused, and its topology keys
(``corrupt-agg``, ``straggle-agg``) unless ``--topology`` is given.
``--exchange SPEC`` (``parallel/compress.py``) sets the
wire: ``bf16`` is ``--exchange-dtype bfloat16``, ``int8[:ef]`` and
``topk:k=K|frac=F[,ef]`` engage the codec; ``bytes_on_wire_total`` counts
n rows of the codec's bytes a step, and the error-feedback residual is
saved in the checkpoints (gathered from every rank).

``--step-deadline SECONDS`` (``parallel/bounded.py``, JAX
``runner.py:1013-1175``) runs each worker's submission on its own thread
and CUDA stream and closes every round at the deadline: a worker that
misses it sends a NaN row (or, under ``--stale-infill``, its last row for
at most ``--stale-max-age`` rounds, damped by ``--stale-reweight``) inside
the declared-f budget.  ``--straggler-stall``/``--straggler-rate``/
``--straggler-jitter`` inject the delays (with ``--chaos`` its straggler
regimes say who is late; without a deadline the stalls drive the
synchronous baseline), ``--deadline-percentile``/``-floor``/``-ceiling``/
``-ema`` adapt the window (``parallel/deadline.py``, built once for the
run), ``--incremental-aggregation`` decodes each row as it lands.  It
needs ``--unroll 1``, stream input, no ``--UDP`` and a schedule of
straggler regimes only; the flight recorder then has no chaos lane.  At
``--nb-devices`` W > 1 each rank submits for its own k workers and one
gather a round agrees the verdicts, so the run is the one-rank run's.
Under ``--mesh W,PP,TP`` a unit is a worker-axis submesh: its k workers'
full-batch gradients (the pipeline at one microbatch, l1/l2 folded into
each worker's loss) are submitted together by its PP TP ranks, arrive or
forfeit their k rows together (``submesh_timeout``), and the aggregate is
the flat rule over the whole vector across every rank of the grid; not
with ``--microbatches``.  The summaries carry ``straggler_timeouts``, ``stale_infill_rows``
and ``deadline_window_seconds``; the forensics ledger each step's timeouts
and stale rows; the watchdog rolls back on timeouts beyond f
(``observe_timeouts``) and on a window pinned at its ceiling
(``observe_ceiling``).  A rollback that rebuilds the stack, and the exit
(a stop signal's included), close the step's threads.

``--topology tree:...`` (``topology/``, JAX ``runner.py:857-898``) makes
the tree spec the aggregation rule (with ``--aggregator tree`` and no
``--aggregator-args``; the spec stands for the rule in the guardian's
``Overrides``) and implies bounded-wait: each round's stacked wire rows go
through the ``TreeAggregator`` (per-level windows from ``--step-deadline``
and the deadline knobs, custody keyed by ``--session-secret``, the chaos
``corrupt-agg``/``straggle-agg`` targets), which clears the leaf spans of
excluded subtrees from the masks the aggregate reads; with ``--forensics``
the ledger names corrupt sub-aggregators ``"LEVEL.UNIT"``.  Not with
``--mesh`` or ``--incremental-aggregation``.  At W > 1 the lead runs the
tree's round on the gathered wire rows and broadcasts its masks.

The regression sentinel (``obs/slo.py``): ``--slo-capture PATH`` writes
this run's end-state ``steps_per_s``, ``gar_seconds_total`` and
``input_overlap_fraction`` as a baseline document, ``--slo-baseline PATH``
loads one at startup and judges the run at its natural end (PASS or
REGRESS: an info line, an ``slo_verdict`` summary event, ``/status``'s
``slo``), ``--slo-verdict PATH`` writes the verdict document too.

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

The worker axis (``--nb-devices W``, JAX ``runner.py:775-792``): the n
workers lie over W ranks, one process a device (``parallel/mesh.py``), k =
n/W workers a rank.  The default is JAX's: the largest divisor of n that is
at most the number of cards on CUDA; on ``--device cpu`` it is 1 (the port
has one CPU device where JAX's test platform has eight: the one deliberate
difference).  At W > 1 the calling process becomes rank 0, the lead: it
spawns W - 1 ranks (start method ``spawn``) that run the same arguments,
rendezvouses with them on 127.0.0.1 at a free port, and joins them at exit;
a rank that fails fails the run.  With ``RANK``, ``WORLD_SIZE`` and
``MASTER_ADDR`` in the environment (``cli/deploy``) it joins that group
instead.  Every rank reads the same global batch stream and keeps its k
workers' slice.  The lead alone writes the evaluation TSV, the checkpoints,
the summaries, ``--metrics-file``, ``--trace-file``, the journal, the flight
dump and the forensics report.  JAX has one controller, the port W: every
host decision that starts a collective or changes the step is the lead's
and reaches every rank at the same step, in one small ``all_reduce_sum``
after each call (the wall-clock cadences, the guardian's rollback, a
SIGTERM/SIGINT on any rank): no rank reads its own clock.  The lead
restores a snapshot (at start or in a rollback) and broadcasts the state.

``--forensics JSON`` (implies ``--worker-metrics``) keeps the lead's
``obs/forensics.ForensicsLedger``, fed one call behind (one row a step,
under ``--unroll`` one a scanned step), told of the guardian's rollbacks,
escalations and recoveries, the flight dumps and the journal's counts, and
saved with its ``.md`` at exit (the stop handlers' path included).
``--xprof A:B`` records one ``torch.profiler`` window over steps [A, B)
with each dispatch inside it annotated ``train step <s>``
(``obs/profiler.py``); the ``compile_*`` and ``device_memory_*`` families
are on the registry.

Security (``secure/``, ``parallel/auth.py``, ``parallel/crypto.py``;
JAX ``runner.py:1442-1630``, ``:2064-2100``): ``--session-secret`` tags
every snapshot (a ``.tag`` sidecar under the ``b"ckpt"`` keys, verified at
every restore; a tag of the key scheme before contexts is accepted once
and re-tagged unless ``--no-legacy-checkpoint-tags``) and runs the
bring-up handshake after the restore (every rank proves the secret and
holds the same parameters; a W-rank run without a secret is warned
about).  ``--encrypt-checkpoints`` encrypts the snapshots (encrypt-then-
MAC).  ``--secure`` authenticates every submission: the engine digests
each row sent and received, a forged or tampered row (the chaos
``forge=``/``tamper=`` regimes) is NaN, and the lead's
``SubmissionAuthenticator`` signs and verifies each step's digests one
call behind (a ``secure.verify`` span), naming each rejected worker to the
forensics ledger as ``forgery`` evidence and on the ``secure_*`` counters;
with ``--checkpoint-dir`` a signed custody manifest lands beside every
snapshot and is verified at every restore (``--allow-unsigned`` lets a
snapshot without one through).  ``--secure-mask`` computes the group means
of ``bucketing`` (or ``hier`` with ``inner=average``) in the masked
integer domain of ``secure/masking.py``, checked again at every guardian
rebuild.  ``--secure`` and ``--secure-mask`` need ``--session-secret``;
``--secure-mask`` refuses ``--exchange`` codecs and ``--step-deadline``.

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
import contextlib
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
    parser.add_argument(
        "--chaos", default=None, metavar="SCHEDULE",
        help="time-varying fault-regime schedule (chaos/ DSL, e.g. '0:calm 500:drop=0.3 1000:attack=empire'): "
             "regimes switch at their steps; subsumes the static --attack/--UDP knobs",
    )
    parser.add_argument(
        "--chaos-args", nargs="*", default=[],
        help="key:value schedule-wide chaos options (packet-coords:N, min-coords:N, straggle-workers:K)",
    )
    parser.add_argument("--optimizer", default="sgd", help="optimizer name")
    parser.add_argument("--optimizer-args", nargs="*", default=[], help="key:value optimizer arguments")
    parser.add_argument("--learning-rate", default="fixed", help="learning-rate schedule name")
    parser.add_argument("--learning-rate-args", nargs="*", default=[], help="key:value schedule arguments")
    parser.add_argument("--l1-regularize", type=float, default=None,
                        help="l1 loss regularization (the flat engine wraps each worker's loss; the sharded engine "
                             "adds l1 sign(p) to the completed gradients)")
    parser.add_argument("--l2-regularize", type=float, default=None,
                        help="l2 loss regularization (the flat engine wraps each worker's loss; the sharded engine "
                             "adds 2 l2 p to the completed gradients)")
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
        "--step-deadline", type=float, default=None, metavar="SECONDS",
        help="bounded-wait aggregation (parallel/bounded.py): dispatch each worker's gradient as its own async "
             "submission (a CUDA stream a worker) and close every round at this host-side deadline -- workers that "
             "miss it contribute NaN rows within the same declared-f budget as Byzantine rows (timeouts + attacks "
             "<= f), land as straggler_timeout forensics evidence, and sustained over-budget timeouts are a guardian "
             "escalation input.  Needs --unroll 1, stream input, a NaN-tolerant rule, and no in-graph transport "
             "simulation (--UDP/non-straggler --chaos)",
    )
    parser.add_argument(
        "--topology", default=None, metavar="SPEC",
        help="aggregation-tree topology (topology/): replace the PS star with L levels of untrusted "
             "sub-aggregators, e.g. tree:g=16x4,rules=median>trimmed-mean>krum,link=int8,redundancy=2,agg-f=1x0.  "
             "The tree IS the aggregation rule (pass --aggregator tree; the spec substitutes into the guardian's "
             "Overrides record): f-budgets compose through the levels at parse time, every inter-level link rides "
             "the declared wire codec, each level closes its own bounded-wait round, sub-aggregator custody is "
             "chain-verified (a forged emission NAMES its (level, unit) in forensics — never laundered into worker "
             "blame), and redundancy=r serves a faulted unit from a sibling shadow.  Needs the flat engine and one "
             "device; implies bounded-wait dispatch (add --step-deadline for real per-level windows)",
    )
    parser.add_argument(
        "--straggler-stall", type=float, default=0.0, metavar="SECONDS",
        help="bounded-wait straggler injection: a worker drawn late holds its submission this long before "
             "dispatching (the chaos straggler regimes' wall-clock twin; with --chaos the per-regime straggle rates "
             "schedule WHO is late, otherwise --straggler-rate does)",
    )
    parser.add_argument(
        "--straggler-rate", type=float, default=0.0, metavar="P",
        help="bounded-wait: flat per-(step, worker) lateness probability when no --chaos schedule provides regime "
             "rates",
    )
    parser.add_argument(
        "--straggler-jitter", type=float, default=0.0, metavar="SIGMA",
        help="bounded-wait straggler injection: heavy-tail the stall -- a late worker sleeps stall * exp(SIGMA * "
             "N(0,1)) (lognormal, median = --straggler-stall) instead of exactly the stall; with --chaos the "
             "per-regime jitter=SIGMA takes precedence",
    )
    parser.add_argument(
        "--deadline-percentile", type=float, default=None, metavar="P",
        help="adaptive bounded-wait window (parallel/deadline.py): track the per-worker arrival distribution and "
             "set each round's window to its P-th percentile, EMA-smoothed and clamped into [--deadline-floor, "
             "--deadline-ceiling].  Requires --step-deadline (the initial window and the default ceiling).  Choose "
             "P at or below 100*(n-f-1)/(n-1) (e.g. 71.4 for n=8, f=2) so a persistent straggler coalition inside "
             "the declared budget cannot pin the window at the ceiling",
    )
    parser.add_argument(
        "--deadline-floor", type=float, default=0.01, metavar="SECONDS",
        help="adaptive deadline: smallest window the controller may emit",
    )
    parser.add_argument(
        "--deadline-ceiling", type=float, default=None, metavar="SECONDS",
        help="adaptive deadline: largest window (default: --step-deadline -- the fixed protocol's declared "
             "worst-case wait); a controller pinned here for ceiling-patience steps is a guardian escalation input",
    )
    parser.add_argument(
        "--deadline-ema", type=float, default=0.3, metavar="ALPHA",
        help="adaptive deadline: weight of each new round's percentile target in (0, 1] -- smoothing so a single "
             "spiked round cannot whipsaw the window",
    )
    parser.add_argument(
        "--stale-infill", action="store_true",
        help="bounded-wait: a timed-out worker re-enters its CLEVER carry row (the last submission this aggregator "
             "received from it) instead of a NaN drop.  Stale rows SPEND the declared-f budget exactly like "
             "timeouts and attacks (stale + timeouts + attacks <= f -- a Byzantine straggler re-enters its carried "
             "attack row), and land as stale_infill forensics evidence",
    )
    parser.add_argument(
        "--stale-max-age", type=int, default=4, metavar="ROUNDS",
        help="bounded-wait stale infill: a carry older than this many consecutive missed rounds degrades back to "
             "a NaN drop",
    )
    parser.add_argument(
        "--stale-reweight", action="store_true",
        help="bounded-wait: damp each stale carry row by its age -- a carry of age a enters aggregation scaled by "
             "1/(1+a) (the unbiased-estimator framing of arXiv:2505.23523) instead of at full weight.  Requires "
             "--stale-infill; the damped row still SPENDS the declared-f budget, and every reweighted re-entry is a "
             "stale_reweight journal event",
    )
    parser.add_argument(
        "--incremental-aggregation", action="store_true",
        help="bounded-wait: fold each submission's decoded row into the aggregate-side device buffer the instant "
             "it lands instead of stacking at the round barrier -- decode/transfer overlaps the submissions still "
             "outstanding (exchange_overlap_fraction on the registry measures it).  Needs --step-deadline; numerics "
             "identical to the stacked path",
    )
    parser.add_argument(
        "--exchange-dtype", default=None, choices=["float32", "bfloat16"],
        help="wire precision of the gradient exchange (bfloat16 halves the bytes; the GAR computes in float32).  "
             "Subsumed by --exchange, which also reaches int8/top-k",
    )
    parser.add_argument(
        "--exchange", default=None, metavar="SPEC",
        help="wire codec of the gradient exchange (parallel/compress.py): f32 | bf16 | int8[:ef] | topk:k=K[,ef] | "
             "topk:frac=F[,ef].  int8 quantizes each row symmetrically with a per-row scale (~4x fewer bytes); "
             "topk ships only the k largest-|value| coordinates; ef adds per-worker error feedback (the residual "
             "rides TrainState.ef, checkpointed).  Rows are encoded after the worker-local attacks and decoded at "
             "the aggregation boundary, so every GAR sees float32; bytes_on_wire_total / "
             "exchange_compression_ratio land on the metrics registry",
    )
    parser.add_argument(
        "--worker-momentum", type=float, default=None, metavar="BETA",
        help="workers send momenta (beta in (0,1)) instead of raw gradients: history-aware robustness "
             "(Karimireddy et al. 2021)",
    )
    parser.add_argument(
        "--mesh", default=None, metavar="W,PP,TP",
        help="route training through the sharded engine on a (worker x pipeline x tensor) grid of W PP TP ranks: "
             "per-layer robust aggregation on sharded gradients, the (n, d) matrix never materialized (needs an "
             "experiment that publishes sharded hooks, e.g. transformer); W must divide --nb-workers",
    )
    parser.add_argument(
        "--microbatches", type=int, default=None,
        help="pipeline microbatches per step (sharded engine only; default 2)",
    )
    parser.add_argument(
        "--granularity", default="vector", choices=["vector", "leaf", "layer", "global"],
        help="apply the rule to the whole flattened gradient (vector, the reference's semantics) or per "
             "parameter leaf (leaf: per-layer selection; each layer picks its own honest set); layer and "
             "global need the sharded engine",
    )
    parser.add_argument(
        "--leaf-bucketing", default="auto", choices=["auto", "on", "off"],
        help="granularity:leaf implementation: on stacks same-sized leaves into one vmapped rule call per "
             "distinct size (one batched launch of each kernel), off loops over the leaves; auto is on on a "
             "card and off on the CPU; the two paths make the same selections (the same per-leaf keys)",
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
    parser.add_argument(
        "--xprof", default=None, metavar="A:B",
        help="programmatic torch.profiler capture (CPU and CUDA) over steps [A, B) into --trace-dir "
             "(obs/profiler.py): dispatches inside the window run under a 'train step <s>' record_function so "
             "the host span trace joins the card's timeline per step; under --unroll the window lands on chunk "
             "boundaries (mutually exclusive with --trace)",
    )
    parser.add_argument(
        "--forensics", default=None, metavar="JSON",
        help="write a Byzantine forensics attribution report here at exit (schema "
             "aggregathor.obs.forensics.v1, plus a .md rendering): a per-worker suspicion timeline built from "
             "the engine's per-step diagnostics and the guardian's verdicts; implies --worker-metrics",
    )
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
        "--slo-baseline", default=None, metavar="JSON",
        help="regression sentinel (obs/slo.py): load this baseline document (schema aggregathor.obs.slo.v1, "
             "seeded via --slo-capture on a healthy run) and emit a PASS/REGRESS verdict on steps/s, "
             "gar_seconds_total and input_overlap_fraction at run end (an slo_verdict summary event + info line)",
    )
    parser.add_argument(
        "--slo-verdict", default=None, metavar="JSON",
        help="also write the sentinel verdict document here (requires --slo-baseline)",
    )
    parser.add_argument(
        "--slo-capture", default=None, metavar="JSON",
        help="capture THIS run's end-state throughput metrics as a fresh SLO baseline document here (what "
             "--slo-baseline loads)",
    )
    parser.add_argument(
        "--run-id", default=None, metavar="ID",
        help="run id stamped on every summary line, the span trace's metadata and /status (default: generated)",
    )
    parser.add_argument("--seed", type=int, default=0, help="base seed")
    parser.add_argument(
        "--session-secret", default=None, metavar="SECRET",
        help="shared secret authenticating the multi-host boundary: every process HMAC-tags a digest of its "
             "post-init parameters and verifies every peer's tag at bring-up; any process launched without the "
             "secret (or with a tampered payload) aborts the cluster (reference: signed worker->PS pushes + TLS "
             "channels, mpi_rendezvous_mgr.patch:585-627, grpc_channel.patch:70-85)",
    )
    parser.add_argument(
        "--secure", action="store_true",
        help="authenticated gradient submission (secure/, docs/security.md): every worker's per-step row is "
             "digest-tagged under a per-(worker, step) HMAC key from --session-secret, verified before "
             "aggregation; a failed tag becomes a NaN row AND a named 'forgery' forensics evidence entry "
             "(reject-and-name); custody manifests are written beside every checkpoint and verified on restore; "
             "zero added recompiles (requires --session-secret)",
    )
    parser.add_argument(
        "--secure-mask", action="store_true",
        help="bucket-level additive masking (Bonawitz-style, secure/masking.py): individual gradient rows are "
             "one-time-padded and the pads cancel EXACTLY inside bucket/hier group means — requires a mean-inner "
             "meta-GAR spec (bucketing:..., or hier:inner=average,...) and --session-secret; a worker that drops "
             "mid-step NaNs its whole group",
    )
    parser.add_argument(
        "--allow-unsigned", action="store_true",
        help="let a --secure run restore checkpoints that carry NO custody manifest (e.g. resuming a directory "
             "written before --secure was enabled): provenance is then unverified for that restore; new snapshots "
             "are signed as usual",
    )
    parser.add_argument(
        "--no-legacy-checkpoint-tags", action="store_true",
        help="refuse snapshots tagged under the pre-context-separation key scheme instead of accepting + "
             "re-tagging them once; set this when no pre-upgrade snapshots exist to close the downgrade acceptance "
             "entirely",
    )
    parser.add_argument(
        "--encrypt-checkpoints", action="store_true",
        help="encrypt snapshot bytes at rest under a key derived from --session-secret (SHAKE-256 keystream, "
             "encrypt-then-MAC with the HMAC tag) — the framework-side counterpart of the reference's TLS channels "
             "(grpc_channel.patch:70-85) for state that outlives the run; requires --session-secret",
    )
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
    parser.add_argument("--nb-devices", type=int, default=None,
                        help="devices on the worker axis (ranks, one process a device; default: the largest divisor "
                             "of --nb-workers at most the number of cards, 1 on --device cpu)")
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


def main(argv=None, rank=None):
    """Run the training; returns a summary dict: the steps run in this call,
    the step restored from (``restored_step``), steps/s excluding the first
    step (over the training loop), the final loss and evaluation, kernel
    launches (``launches``, and ``batched_launches`` of the kernels' batched
    forms), the device, the performance report (``perf``), the run id, the
    input pipeline that fed the loop (``input_pipeline``: its class name, or
    None) with its consumer's wait (``input_wait_s``, summed over the
    pipelines a rollback rebuilt), the GAR probe's calls
    (``gar_probe_calls``, its warm-up included), and the guardian's
    timeline: ``rollbacks`` (one dict a rollback: ``from_step``,
    ``to_step``, ``attempt``, ``restored_snapshot``), ``escalations`` (the
    rung specs applied), ``recovered`` (the steps at which recovery was
    declared) and ``steps_by_overrides`` (steps dispatched under each
    ``Overrides.describe()``, abandoned calls included), the worker axis's
    size (``nb_devices``), this process's ``rank`` and the ``--xprof``
    trace written (``xprof_trace``, or None).  ``rank`` is ``(rank, size,
    init_method)`` in a rank the lead spawned."""
    argv = list(sys.argv[1:] if argv is None else argv)
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
        return _run(args, stop, argv, rank)
    finally:
        for signum, handler in previous_handlers.items():
            signal.signal(signum, handler)


def _spawned_rank(argv, rank, size, init_method):
    """A rank the lead spawned: ``main`` on the lead's arguments as rank
    ``rank`` of ``size`` (an exception exits the process non-zero)."""
    main(argv, rank=(rank, size, init_method))


def parse_mesh(text):
    """``--mesh W,PP,TP`` -> (W, PP, TP), or None without it (JAX :521-530)."""
    from ..utils import UserException

    if not text:
        return None
    try:
        axes = tuple(int(x) for x in text.split(","))
        if len(axes) != 3 or any(a < 1 for a in axes):
            raise ValueError
    except ValueError:
        raise UserException("--mesh wants W,PP,TP positive integers (got %r)" % text) from None
    return axes


def check_mesh_flags(args):
    """The JAX runner's refusals of ``--mesh`` (JAX :650-655, :951-980,
    :1023-1045), before any rank is spawned."""
    from .. import models
    from ..parallel import compress
    from ..utils import UserException

    if args.input_source == "device":
        raise UserException("--input-source device needs the flat engine (the sharded engine's batches flow "
                            "through the pipeline stages); drop --mesh or use --input-source stream")
    if not getattr(models.get(args.experiment), "supports_sharded", False):
        raise UserException(
            "Experiment %r does not publish sharded hooks (sharded_init/sharded_specs/sharded_loss); --mesh "
            "currently works with: %s" % (args.experiment, ", ".join(
                name for name in models.itemize() if getattr(models.get(name), "supports_sharded", False)) or "none"))
    if args.exchange:
        codec = compress.parse_exchange_spec(args.exchange)[1]
        if codec is not None:
            raise UserException("--exchange %s needs the flat engine (drop --mesh): the sharded per-(worker, leaf) "
                                "submissions would need per-leaf codec state — --exchange bf16 works everywhere"
                                % codec.spec())
    if args.incremental_aggregation:
        raise UserException("--incremental-aggregation folds per-WORKER rows; the sharded mode's per-submesh "
                            "submissions need a per-group fold layout — run the flat engine")
    if args.topology is not None:
        raise UserException("--topology needs the flat engine: the tree's custody plane signs the stacked "
                            "per-worker wire rows, which the sharded submesh submissions never materialize — drop "
                            "--mesh")
    if (args.step_deadline is not None or args.straggler_stall > 0) and args.microbatches is not None:
        raise UserException("--step-deadline on the sharded engine computes per-worker FULL-batch gradients over "
                            "experiment.loss; --microbatches only shapes the fused pipeline loss — drop it (the "
                            "bounded path would silently ignore it)")


def make_regularized_loss(base_loss, l1, l2, sharded=None):
    """The per-worker loss's l1/l2 (JAX :1186-1200): the loss plus l1 times
    the sum of |p| and l2 times the sum of p^2 over the leaves (the
    reference's graph.py:125-139); ``base_loss`` itself without them.
    Given the ``sharded`` engine, ``base_loss(params, batch, grid)`` is a
    rank's local partial and each leaf's terms are scaled by 1/(its
    replication), so that the submesh's sum carries them once."""
    import torch

    if not (l1 or l2):
        return base_loss

    def regularized(loss, params):
        def scale(name):
            return 1.0 if sharded is None else sharded.replication_scale(name)

        if l1:
            loss = loss + l1 * sum(scale(name) * torch.sum(torch.abs(p)) for name, p in params.items())
        if l2:
            loss = loss + l2 * sum(scale(name) * torch.sum(p * p) for name, p in params.items())
        return loss

    if sharded is not None:
        return lambda params, batch, grid: regularized(base_loss(params, batch, grid), params)
    return lambda params, batch: regularized(base_loss(params, batch), params)


def default_nb_devices(n, device):
    """JAX's default (``runner.py:786-788``): the largest divisor of n at
    most the number of cards; 1 on the CPU, the port's one CPU device."""
    import torch

    if device.type != "cuda":
        return 1
    return max(d for d in range(1, torch.cuda.device_count() + 1) if n % d == 0)


def _run(args, stop, argv, rank):
    """Resolve the device, join (or, as the lead, spawn and join) the
    worker axis, train (``_train``), then leave the group and, as the lead,
    join the ranks it spawned: a rank that failed fails the run."""
    import multiprocessing

    import torch

    from ..parallel import mesh
    from ..utils import UserException, replicate_streams, resolve_device

    plan = rank if rank is not None else mesh.environment_rank()
    if plan is None or plan[0] == 0:
        replicate_streams(args.stdout_to, args.stderr_to)
    resolve_device_flags(args)
    if args.device == "cuda" and args.backend_timeout and args.backend_timeout > 0 and torch.cuda.is_available():
        wait_for_cuda(args.backend_timeout)
    device = resolve_device(args.device)
    n = args.nb_workers
    mesh_axes = parse_mesh(args.mesh)
    if mesh_axes is not None:
        grid_size = mesh_axes[0] * mesh_axes[1] * mesh_axes[2]
        if args.nb_devices is not None and args.nb_devices != grid_size:
            raise UserException("--nb-devices %d contradicts --mesh %s (%d ranks)" % (args.nb_devices, args.mesh,
                                                                                    grid_size))
        if n % mesh_axes[0]:
            raise UserException("--mesh worker axis W=%d must divide --nb-workers %d (k = n/W logical Byzantine "
                                "workers a (pipe x model) submesh)" % (mesh_axes[0], n))
        check_mesh_flags(args)
        args.nb_devices = grid_size
    if plan is not None and args.nb_devices is not None and args.nb_devices != plan[1]:
        raise UserException("--nb-devices %d contradicts the group's world size %d" % (args.nb_devices, plan[1]))
    if plan is None:
        size = args.nb_devices if args.nb_devices is not None else default_nb_devices(n, device)
        if size < 1 or n < 1 or (n % size and mesh_axes is None):
            raise UserException("--nb-devices %d must divide --nb-workers %d (k = n/W workers a device)" % (size, n))
        plan = (0, size, None)
    rank_index, size, init_method = plan
    children = []
    if size > 1 and init_method is None:
        # the lead: W - 1 ranks on the same arguments, spawned before the
        # rendezvous (which waits for every rank)
        mesh.choose_backend(device, size)  # W cards for W ranks, before anything starts
        init_method = "tcp://127.0.0.1:%d" % mesh.free_port()
        context = multiprocessing.get_context("spawn")
        children = [context.Process(target=_spawned_rank, args=(argv, r, size, init_method), daemon=True,
                                    name="rank-%d" % r) for r in range(1, size)]
        for child in children:
            child.start()
    if mesh_axes is not None and size > 1 and device.type == "cpu":
        # the grid's ranks share the host's cores, one intra-op pool each
        # (as mesh.spawn's ranks): oversubscribed pools stall every
        # pipeline and ring collective
        torch.set_num_threads(max(1, mesh.host_threads() // size))
    # a collective whose peer died raises (gloo) or times out (NCCL, after
    # mesh.DEFAULT_TIMEOUT): the lead never returns past a dead rank
    axis_device = torch.device(device.type) if size > 1 else device
    try:
        # under --mesh the process group is the grid's world, one rank a
        # device (the engine's worker axis is the grid's)
        axis = mesh.join(n if mesh_axes is None else size, size, rank_index, init_method, device=axis_device)
        try:
            result = _train(args, stop, axis)
        finally:
            axis.close()
    finally:
        aborting = sys.exc_info()[0] is not None
        for child in children:
            child.join(timeout=5.0 if aborting else 120.0)
            if child.is_alive():
                child.terminate()
                child.join()
    dead = [child for child in children if child.exitcode != 0]
    if dead:
        raise UserException("rank %s of the worker axis failed (exit code %s): the run failed"
                            % (dead[0].name.split("-")[-1], dead[0].exitcode))
    return result


def _train(args, stop, axis):
    """The training loop on ``axis``; ``stop["requested"]`` ends the loop at
    the next step boundary (at W > 1 the ranks agree on it)."""
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
    from ..chaos import ChaosSchedule
    from ..parallel import RobustEngine, attacks, compress
    from ..parallel.engine import fold_in_seed, index_metrics, stack_metrics
    from ..parallel.lossy import LossyLink
    from ..obs import profiler as obs_profiler
    from ..obs import slo as obs_slo
    from ..obs.forensics import ForensicsLedger
    from ..core.train_state import broadcast_state
    from ..utils import Context, UserException, info, warning
    from . import parse_cause_flag

    ignored = [flag for flag, value in (
        ("--client", args.client), ("--server", args.server),
        ("--ps-job-name", args.ps_job_name), ("--ev-job-name", args.ev_job_name),
        ("--wk-job-name", args.wk_job_name), ("--MPI", args.mpi), ("--no-wait", args.no_wait),
    ) if value]
    if ignored:
        warning("Compat no-op flags ignored (cluster topology and transport dissolved under single-controller "
                "SPMD, see docs/transport.md): %s" % " ".join(ignored))
    device, lead, W = axis.device, axis.lead, axis.size
    if args.xprof and args.trace:
        raise UserException("--xprof and --trace both drive the torch.profiler; pick one")
    if args.forensics and not args.worker_metrics:
        # the ledger's distance evidence rides worker_sq_dist
        info("--forensics implies --worker-metrics: enabling the per-worker suspicion diagnostics")
        args.worker_metrics = True
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
    if args.slo_verdict and not args.slo_baseline:
        raise UserException("--slo-verdict needs --slo-baseline")
    # the sentinel's baseline loads at startup: a missing or garbled
    # document fails before the run, not at the verdict (JAX :671-679)
    sentinel = obs_slo.Sentinel(args.slo_baseline) if args.slo_baseline else None
    mesh_axes = parse_mesh(args.mesh)
    if mesh_axes is None:
        if args.granularity in ("layer", "global"):
            raise UserException("--granularity %s needs the sharded engine: pass --mesh W,PP,TP" % args.granularity)
        if args.leaf_bucketing != "auto" and args.granularity != "leaf":
            warning("--leaf-bucketing only affects --granularity leaf; ignored for granularity %r" % args.granularity)
    if (args.secure or args.secure_mask) and not args.session_secret:
        raise UserException("--secure/--secure-mask derive their per-worker keys and mask pads from "
                            "--session-secret; pass it")
    # the wire codec, parsed before anything is built (JAX :634-663)
    exchange_codec = None
    if args.exchange:
        if args.exchange_dtype:
            raise UserException("--exchange generalizes --exchange-dtype (bf16 is spelled --exchange bf16); pass "
                                "only one")
        spec_dtype, exchange_codec = compress.parse_exchange_spec(args.exchange)
        if spec_dtype is not None:
            # bf16 lands on the dtype twin, bit-compatible with --exchange-dtype
            args.exchange_dtype = "bfloat16"
            args.exchange = None
    if exchange_codec is not None and args.secure_mask:
        raise UserException("--exchange %s + --secure-mask is not supported: the fixed-point pairwise pads cancel "
                            "exactly over the EXACT float32 rows, and a lossy wire codec would corrupt the "
                            "cancellation — run masking on the f32/bf16 wire" % exchange_codec.spec())
    cause = parse_cause_flag(args.cause)
    # the guardian's configuration is parsed before anything is built, so a
    # bad ladder or threshold fails before the first launch
    guardian = None
    if args.guardian:
        guardian = GuardianConfig(args.guardian_args)
        if not args.checkpoint_dir:
            raise UserException("--guardian rolls back to on-disk snapshots; pass --checkpoint-dir")
    watchdog = Watchdog(guardian) if guardian is not None else None
    # the aggregation tree (--topology, topology/): the spec parses and
    # composes its budgets here, before anything is built, and substitutes
    # for --aggregator in the Overrides record, so an escalation to a flat
    # rung retires the host tree plane and a rollback to the tree's rung
    # brings it back (JAX :857-890)
    topology_spec = topology = None
    if args.topology is not None:
        from ..topology import parse_topology_spec

        if args.aggregator != "tree":
            raise UserException("--topology replaces the aggregation rule with the tree spec; pass --aggregator "
                                "tree (got %r)" % args.aggregator)
        if args.aggregator_args:
            raise UserException("--topology carries the tree's arguments inline (tree:g=...,rules=...); drop "
                                "--aggregator-args")
        topology_spec = parse_topology_spec(args.topology, n, f)
        if lead:
            info("Topology: %s" % topology_spec.describe())
    # the knobs the escalation ladder may change; the training stack is built
    # from this record so a rollback can rebuild it mid-run
    overrides = Overrides(f, args.topology if topology_spec is not None else args.aggregator,
                          () if topology_spec is not None else tuple(args.aggregator_args),
                          reputation_decay=args.reputation_decay, quarantine_threshold=args.quarantine_threshold)
    # bounded-wait (parallel/bounded.py): under a deadline, or stalls without
    # one (the synchronous baseline), or the tree, the schedule moves to the
    # host's clock and the step has no chaos regime (JAX :893-897)
    bounded_wait = args.step_deadline is not None or args.straggler_stall > 0 or topology_spec is not None
    # the flight recorder's layout is fixed for the run: built once and
    # shared by every rebuilt stack (its ring is per-state)
    flight_rec = None
    if args.flight:
        flight_rec = obs_flight.FlightRecorder(args.flight, n, probe=True, worker_metrics=args.worker_metrics,
                                               chaos=bool(args.chaos) and not bounded_wait, secure=args.secure)
        if args.flight < unroll:
            warning("--flight capacity %d < --unroll %d: a summary fetch cannot cover the whole last chunk; "
                    "size the ring to at least the unroll (ideally the summary delta)" % (args.flight, unroll))
    run_id = args.run_id if args.run_id else make_run_id()
    registry = obs_metrics.REGISTRY

    with Context("setup"):
        experiment = models.instantiate(args.experiment, args.experiment_args)
        grid = None
        if mesh_axes is not None:
            # the sharded engine's warnings (JAX :966-975; its refusals ran
            # before the ranks spawned, check_mesh_flags)
            if args.leaf_bucketing != "auto":
                warning("--leaf-bucketing applies to the flat engine's leaf path only; the sharded engine always "
                        "aggregates per bucket")
            if args.trace_ops:
                warning("--trace-ops narrates the flat engine's step body only; ignored under --mesh (use --trace "
                        "for a profiler window)")
                args.trace_ops = False
            from ..parallel.mesh import make_mesh

            W_axis, PP, TP = mesh_axes
            grid = make_mesh(W_axis, TP, PP, device=device)
            if lead:
                info("Sharded mesh: %d worker slot(s) x %d pipeline stage(s) x %d-way tensor parallelism on %d %s "
                     "rank(s), %d logical worker(s)/slot" % (W_axis, PP, TP, grid.size, device.type, n // W_axis))
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
        chaos = None
        if args.chaos:
            # the sub-aggregator keys (corrupt-agg, straggle-agg) only under
            # --topology, each naming a node the tree has (JAX :934-945)
            chaos = ChaosSchedule(args.chaos, n, nb_real_byz=r, args=args.chaos_args,
                                  allow_topology_faults=topology_spec is not None)
            info("Chaos schedule: %d regime(s): %s"
                 % (len(chaos), "  ".join("%d:%s" % t for t in chaos.transitions())))
            if topology_spec is not None:
                for regime in chaos.regimes:
                    for level, unit in regime.agg_corrupt + regime.agg_straggle:
                        topology_spec.validate_fault_target(level, unit)
        base_schedule = build_schedule(args.learning_rate, args.learning_rate_args)
        # bounded-wait's straggler model and deadline controller, checked
        # before anything is built (JAX :1013-1175); the controller is built
        # once, outside the rebuild, so its window survives an escalation
        straggler_model = deadline_controller = params_template = None
        if bounded_wait:
            from ..parallel.bounded import BoundedWaitStep, HostStragglerModel

            if args.incremental_aggregation and args.step_deadline is None:
                raise UserException("--incremental-aggregation overlaps decode with the deadline window; pass "
                                    "--step-deadline")
            if unroll > 1:
                raise UserException("--step-deadline closes every round on the host clock; a scanned --unroll chunk "
                                    "cannot be interrupted -- use --unroll 1")
            if args.input_source == "device":
                raise UserException("--step-deadline dispatches per-worker host batches; use --input-source stream")
            if args.secure_mask:
                raise UserException("--step-deadline + --secure-mask is not supported: the pairwise pads are added "
                                    "inside the fused submission pipeline and would not cancel across per-worker "
                                    "dispatches (--secure digests DO ride the bounded path)")
            if args.udp > 0:
                raise UserException("--step-deadline replaces the simulated lossy transport; drop --UDP (real "
                                    "timeouts produce the NaN rows)")
            # the straggler model takes the schedule only when it has worker
            # content to consume or refuse
            chaos_worker = chaos
            if chaos is not None and not (chaos.has_stragglers or chaos.has_attacks or chaos.has_drop
                                          or chaos.has_forgery):
                chaos_worker = None
            if args.straggler_stall > 0 or args.straggler_rate > 0 or chaos_worker is not None:
                straggler_model = HostStragglerModel(n, args.straggler_stall, rate=args.straggler_rate,
                                                     chaos=chaos_worker, seed=args.seed, jitter=args.straggler_jitter)
            elif args.straggler_jitter > 0:
                raise UserException("--straggler-jitter scales an injected stall; without --straggler-stall/"
                                    "--straggler-rate or a --chaos straggler regime it injects nothing -- drop it or "
                                    "add a stall source")
            if args.deadline_percentile is not None:
                from ..parallel.deadline import DeadlineController

                if args.step_deadline is None:
                    raise UserException("--deadline-percentile needs --step-deadline (the controller's initial "
                                        "window and default ceiling)")
                deadline_controller = DeadlineController(
                    args.step_deadline, percentile=args.deadline_percentile, floor=args.deadline_floor,
                    ceiling=args.deadline_ceiling, ema=args.deadline_ema, registry=registry)
            # the rows' layout, for the aggregate's flatten and inflate
            params_template = experiment.init(args.seed)
            if topology_spec is not None:
                if args.incremental_aggregation:
                    raise UserException("--topology and --incremental-aggregation are mutually exclusive: the "
                                        "tree's custody plane signs the stacked wire rows at the round barrier, "
                                        "which the incremental fold never materializes")
                from ..topology import TreeAggregator

                # built once, outside the rebuild, as the deadline controller:
                # the custody chain's head and the per-level windows outlive
                # an escalation (JAX :1128-1166)
                topology = TreeAggregator(
                    topology_spec, registry=registry,
                    session_secret=args.session_secret.encode() if args.session_secret else None,
                    deadline=args.step_deadline,
                    deadline_opts=dict(percentile=args.deadline_percentile, floor=args.deadline_floor,
                                       ceiling=args.deadline_ceiling, ema=args.deadline_ema)
                    if args.deadline_percentile is not None else None)
                topology.schedule = chaos
        elif (args.deadline_percentile is not None or args.stale_infill or args.stale_reweight
              or args.straggler_jitter > 0 or args.incremental_aggregation):
            raise UserException("--deadline-percentile/--stale-infill/--stale-reweight/--straggler-jitter/"
                                "--incremental-aggregation are bounded-wait options; pass --step-deadline (or "
                                "--straggler-stall for the synchronous baseline)")

        # bucket-level masking (secure/masking.py): the pads' seed from the
        # session secret; the spec's feasibility is checked by
        # enable_masking here and at every escalation's rebuild, so a rung
        # to an unmaskable rule is refused, not run unmasked
        group_masking = None
        if args.secure_mask:
            from ..secure import GroupMasking

            group_masking = GroupMasking.from_secret(args.session_secret.encode())

        def build_training(ov):
            """The rebuildable half of the run, built from an ``Overrides``
            record (JAX ``TrainingStack``, runner.py:1203-1240): the rule,
            the optimizer, the engine and its step, multi-step and
            evaluation functions.  A rollback that climbs a rung builds a
            new one; the experiment, the attack, the link, the cadences,
            the flight recorder and the registry instruments stay."""
            stack = types.SimpleNamespace(overrides=ov, gar_probe_fn=None)
            stack.gar = gars.instantiate(ov.gar_name, n, ov.f, list(ov.gar_args))
            if group_masking is not None:
                from ..secure import enable_masking

                enable_masking(stack.gar, group_masking)
            if ov.lr_scale != 1.0:
                # the ladder's lr damping composes with the named schedule
                def schedule(count, _base=base_schedule, _scale=ov.lr_scale):
                    return _base(count) * _scale
            else:
                schedule = base_schedule
            stack.tx = build_optimizer(args.optimizer, schedule, args.optimizer_args)
            stack.eval_loss_fn = None
            if grid is not None:
                # the sharded mode (JAX :1238-1298): ``vector`` (whole-vector
                # selection) is spelled ``global`` there; l1/l2 are applied
                # analytically on the completed gradients
                stack.engine = RobustEngine(
                    stack.gar, n, sharding="sharded", mesh=grid, nb_real_byz=r, attack=attack, lossy_link=lossy,
                    granularity="global" if args.granularity == "vector" else args.granularity,
                    exchange_dtype=args.exchange_dtype, worker_momentum=args.worker_momentum,
                    worker_metrics=args.worker_metrics, reputation_decay=ov.reputation_decay,
                    quarantine_threshold=ov.quarantine_threshold, l1_regularize=args.l1_regularize,
                    l2_regularize=args.l2_regularize, chaos=None if bounded_wait else chaos, secure=args.secure,
                    flight=flight_rec)
                loss_fn = experiment.sharded_loss(mesh_axes[1], 2 if args.microbatches is None else args.microbatches)
                stack.bounded_step = None
                if bounded_wait:
                    # a submesh's submission (JAX :1277-1300): each worker's
                    # full-batch loss, the pipeline at one microbatch, with
                    # l1/l2 folded into it as the flat loss folds them (the
                    # engine's analytic terms belong to the fused step)
                    bounded_loss = make_regularized_loss(experiment.sharded_loss(mesh_axes[1], 1),
                                                         args.l1_regularize, args.l2_regularize, stack.engine)
                    stack.bounded_step = BoundedWaitStep(
                        stack.engine, bounded_loss, stack.tx, params_template, deadline=args.step_deadline,
                        straggler_model=straggler_model, registry=registry, controller=deadline_controller,
                        stale_infill=args.stale_infill, stale_max_age=args.stale_max_age,
                        stale_reweight=args.stale_reweight)
                    stack.step_fn = stack.bounded_step
                else:
                    stack.step_fn = stack.engine.build_step(loss_fn, stack.tx)
                stack.multi_fn = stack.engine.build_multi_step(loss_fn, stack.tx) if unroll > 1 else None
                # metric sums need a dense replica; evaluation reports the loss
                stack.eval_fn = None
                stack.eval_loss_fn = stack.engine.build_eval(loss_fn)
                return stack
            stack.engine = RobustEngine(
                stack.gar, n, nb_real_byz=r, attack=attack, lossy_link=lossy, exchange_dtype=args.exchange_dtype,
                worker_momentum=args.worker_momentum, batch_transform=experiment.device_transform(),
                worker_metrics=args.worker_metrics, reputation_decay=ov.reputation_decay,
                quarantine_threshold=ov.quarantine_threshold, granularity=args.granularity,
                leaf_bucketing={"auto": "auto", "on": True, "off": False}[args.leaf_bucketing],
                trace_ops=args.trace_ops, flight=flight_rec, device=device, axis=axis,
                chaos=None if bounded_wait else chaos, exchange=exchange_codec, secure=args.secure)
            stack.bounded_step = None
            loss_fn = make_regularized_loss(experiment.loss, args.l1_regularize, args.l2_regularize)
            if bounded_wait:
                # one submission a worker and a deadline-closed round; the
                # controller is shared by every rebuilt stack
                stack.bounded_step = BoundedWaitStep(
                    stack.engine, loss_fn, stack.tx, params_template, deadline=args.step_deadline,
                    straggler_model=straggler_model, registry=registry, controller=deadline_controller,
                    stale_infill=args.stale_infill, stale_max_age=args.stale_max_age,
                    stale_reweight=args.stale_reweight, incremental=args.incremental_aggregation,
                    # the tree rides its own rung only: an escalation that
                    # swaps the rule retires the host plane with it
                    topology=topology if topology is not None and ov.gar_name == args.topology else None)
                stack.step_fn = stack.bounded_step
            else:
                stack.step_fn = stack.engine.build_step(loss_fn, stack.tx)
            if args.input_source == "device":
                stack.multi_fn = stack.engine.build_sampled_multi_step(loss_fn, stack.tx, unroll,
                                                                       experiment.batch_size)
            else:
                stack.multi_fn = stack.engine.build_multi_step(loss_fn, stack.tx) if unroll > 1 else None
            stack.eval_fn = stack.engine.build_eval_sums(experiment.metrics)
            return stack

        def make_fresh_state(seed):
            # the parameters always from the run's seed; ``seed`` moves only
            # the random streams (a rollback with no snapshot, JAX :1327-1332)
            if grid is not None:
                # the sharded parameters from ``seed``, as JAX's init_state
                # draws them from PRNGKey(seed)
                return ts.engine.init_state(experiment.sharded_init(mesh_axes[1]), experiment.sharded_specs(),
                                            ts.tx, seed=seed)
            return ts.engine.init_state(experiment.init(args.seed), ts.tx, seed=seed)

        ts = build_training(overrides)
        state = make_fresh_state(args.seed)
        model_dim = ts.engine.model_dim if grid is not None else sum(p.numel() for p in state.params.values())
        # the train split lives on the device, uploaded once for the run (JAX
        # uploads it again with every rebuilt stack, :1354-1358; the ladder
        # never changes the data)
        device_dataset = ts.engine.replicate(experiment.train_arrays()) if args.input_source == "device" else None
        info("Training %s on %s: %d workers, f=%d, r=%d, aggregator %s, d=%d%s"
             % (args.experiment, torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                n, f, r, args.aggregator, model_dim,
                ", rank %d of %d (%d workers a rank)" % (axis.rank, W, axis.workers_per_device) if W > 1 else ""))

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
    # the lead alone writes (and restores) snapshots, evaluation rows and
    # summaries (JAX keeps them lead-only)
    ckpt_auth = ckpt_cipher = None
    if args.encrypt_checkpoints and not args.session_secret:
        raise UserException("--encrypt-checkpoints derives its key from --session-secret; pass both")
    if args.session_secret and args.checkpoint_dir:
        # the session secret tags the snapshots too, under its b"ckpt" keys
        # (apart from the handshake's)
        from ..parallel.auth import GradientAuthenticator

        ckpt_auth = GradientAuthenticator(args.session_secret.encode(), 1, context=b"ckpt")
        if args.encrypt_checkpoints:
            from ..parallel.crypto import SnapshotCipher

            ckpt_cipher = SnapshotCipher(args.session_secret.encode())
    # authenticated submission (secure/submit.py): the lead signs and
    # verifies the digests, fed one call behind like the forensics ledger
    secure_auth = None
    if args.secure and lead:
        from ..secure import SubmissionAuthenticator

        secure_auth = SubmissionAuthenticator(args.session_secret.encode(), n, registry=registry)
    # the chain of custody (secure/custody.py): a signed lineage manifest
    # beside every snapshot, verified at every restore
    custody = None
    if args.secure and args.checkpoint_dir and lead:
        from ..secure import ChainOfCustody
        from ..secure.custody import data_digest_for

        identity = "%s|%s|seed=%d|n=%d" % (args.experiment, " ".join(args.experiment_args), args.seed, n)
        custody = ChainOfCustody(args.session_secret.encode(), run_id=run_id, experiment=args.experiment,
                                 gar_spec=overrides.describe(), data_digest=data_digest_for(experiment, identity),
                                 submission=secure_auth, allow_unsigned=args.allow_unsigned)
    checkpoints = Checkpoints(
        args.checkpoint_dir, pick(args.checkpoint_base_name, config.default_checkpoint_base_name),
        args.checkpoint_keep, authenticator=ckpt_auth, background=True,
        allow_legacy_tags=not args.no_legacy_checkpoint_tags, cipher=ckpt_cipher, custody=custody, nb_workers=n,
    ) if args.checkpoint_dir and lead else None
    eval_file = EvalFile(args.evaluation_file if lead else None)
    summaries = SummaryWriter(args.summary_dir if lead else None, run_id=run_id)
    # Byzantine forensics ledger (obs/forensics.py): fed one call behind,
    # written at exit; lead-only, the diagnostics being the same on every rank
    ledger = ForensicsLedger(n, run_id=run_id) if args.forensics and lead else None
    if topology is not None and ledger is not None:
        # the tree's custody verdicts land on the ledger's sub-aggregator
        # surface: a forged emission names its (level, unit), never a worker
        topology.ledger = ledger

    # Training gauges and counters on the process-wide registry, as the JAX
    # runner registers them: the summary's values, updated at every fire
    g_loss = registry.gauge("train_loss", "Last summarized total training loss")
    g_grad_norm = registry.gauge("train_grad_norm", "Last summarized aggregate norm")
    g_lr = registry.gauge("train_learning_rate", "Learning rate at the last summary")
    g_steps_per_s = registry.gauge("train_steps_per_second", "Throughput excluding the first (compile) step")
    g_regime = registry.gauge("train_chaos_regime", "Active chaos regime index")
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
        compress.compression_ratio(model_dim, ts.engine.exchange_dtype, codec=ts.engine.codec))
    wire_step_bytes = n * compress.bytes_per_row(model_dim, ts.engine.exchange_dtype, codec=ts.engine.codec)
    c_rollbacks = registry.counter("guardian_rollbacks_total", "Guardian rollbacks to last-known-good")
    c_escalations = registry.counter("guardian_escalations_total", "Guardian escalation-ladder rungs applied")
    c_recoveries = registry.counter("guardian_recoveries_total", "Guardian diverged-then-recovered verdicts")
    c_flight_fetches = registry.counter("flight_fetches_total", "Flight-recorder ring fetches")
    g_flight_rows = registry.gauge("flight_window_steps", "Rows in the last fetched flight window")
    g_flight_last = registry.gauge("flight_last_step", "Completed step of the newest fetched flight row")
    # the build-cache and memory families (obs/profiler.py); --xprof's
    # window, lead-only like --trace-file
    compile_watch = obs_profiler.CompileWatch(registry, summaries=summaries, step_provider=lambda: step)
    obs_profiler.install_compile_listener(registry)
    if obs_profiler.install_memory_gauges(registry, device):
        info("Device memory gauges live on %s" % device)
    xprof = obs_profiler.ProfilerWindow(args.xprof, args.trace_dir, registry=registry, device=device,
                                        run_id=run_id) if args.xprof and lead else None
    live_state = {"step": 0, "flight": None, "slo": None}
    probe = {"calls": 0}
    timeline = {"rollbacks": [], "escalations": [], "recovered": [], "steps_by_overrides": {}}

    def synchronize():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def share_restored(state, host):
        """Every rank's ``state`` from the lead's restored ``host`` (the state
        itself in the flat mode, the global layout under --mesh): the lead's
        values broadcast, then each rank's blocks loaded (``put_state``)."""
        broadcast_state(host, axis)
        if grid is not None:
            ts.engine.put_state(state, host)

    def sharded_eval_sums(batch):
        """The metric sums of a dense replica of the sharded parameters on
        the batch, its worker dim folded (one process holding every block:
        the one-rank grid; JAX :1742-1770)."""
        with torch.no_grad():
            params = experiment.sharded_to_dense_params({k: v.detach() for k, v in state.params.items()})
            flat = {key: torch.as_tensor(np.ascontiguousarray(value)).reshape((-1,) + tuple(value.shape[2:])).to(device)
                    for key, value in batch.items()}
            return experiment.metrics(params, flat)

    @trace.span("eval", cat="eval")
    def run_eval(step):
        sums = {}
        values = []
        for batch in experiment.make_eval_iterator(n):
            if ts.eval_fn is None:
                # the sharded engine reports the mean sharded loss, and the
                # dense metrics where one process holds every block
                values.append(float(ts.eval_loss_fn(state, ts.engine.put_batch(batch))))
                folded = sharded_eval_sums(batch) if grid.size == 1 else {}
            else:
                folded = ts.eval_fn(state, ts.engine.put_batch(batch))
            for name, (total, count) in folded.items():
                prev = sums.get(name, (0.0, 0.0))
                sums[name] = (prev[0] + float(total), prev[1] + float(count))
        metrics = {name: total / max(count, 1.0) for name, (total, count) in sums.items()}
        if ts.eval_fn is None:
            metrics["loss"] = sum(values) / max(len(values), 1)
        if chaos is not None:
            # the regime of the last completed step (JAX :1782-1788)
            metrics["chaos_regime"] = chaos.regime_at(max(step - 1, 0))
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
        if "chaos_regime" in metrics:
            scalars["chaos_regime"] = int(metrics["chaos_regime"])
        if "nb_timeouts" in metrics:
            # bounded-wait's verdicts for this call's step (JAX :1968-1976)
            scalars["straggler_timeouts"] = int(metrics["nb_timeouts"])
        if "nb_stale" in metrics:
            scalars["stale_infill_rows"] = int(metrics["nb_stale"])
        if ts.bounded_step is not None and ts.bounded_step.controller is not None:
            scalars["deadline_window_seconds"] = ts.bounded_step.controller.window
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
        if "chaos_regime" in scalars:
            g_regime.set(scalars["chaos_regime"])
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

    def agree(values, lead_only):
        """One small ``all_reduce_sum`` that makes a host decision the same
        on every rank: entry i is the lead's value where ``lead_only[i]``
        (the other ranks send 0), else the sum over the ranks (a signal on
        any rank counts).  The values themselves at W = 1."""
        values = [int(value) for value in values]
        if W == 1:
            return values
        mine = [value if lead or not only else 0 for value, only in zip(values, lead_only)]
        return [int(v) for v in axis.all_reduce_sum(torch.tensor(mine, dtype=torch.int64, device=device)).tolist()]

    def dump_metrics_file():
        if not args.metrics_file or not lead:
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
        if args.flight_dump and lead:
            path = args.flight_dump
            if reason == "guardian_rollback":
                root, ext = os.path.splitext(path)
                path = "%s.rollback-%d%s" % (root, int(at_step), ext or ".json")
            obs_flight.dump_window(path, window, run_id=run_id, reason=reason, capacity=flight_rec.capacity,
                                   extra={"at_step": int(at_step)})
            info("Flight post-mortem (%s) -> %r (%d row(s))" % (reason, path, summary.get("rows", 0)))
        if ledger is not None:
            ledger.attach_flight(at_step, reason, path=path, window_summary=summary)
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
        nonlocal state, step, ts, overrides, pending_loss, pending_metrics, diverged, chaos_regime_seen
        reason = watchdog.last_reason or "divergence"
        if watchdog.exhausted:
            diverged = True
            raise UserException("guardian: run failed — %s after %d recovery attempt(s) (ladder %s)"
                                % (reason, watchdog.attempts, guardian.ladder.describe()))
        with trace.span("guardian.rollback", cat="guardian", from_step=int(at_step)):
            target = None
            if checkpoints is not None:
                checkpoints.wait()  # the writer's queue flushed before reading the targets
                target = checkpoints.pinned_step()
            # the lead's snapshot is every rank's target
            target = agree([-1 if target is None else target], (True,))[0]
            target = None if target < 0 else target
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
            if ledger is not None:
                # the replay window re-observes the truncated steps; the
                # rollback note (at the restore step, so it survives the
                # truncation) keeps why
                ledger.truncate_after(rstep)
                forensics_fed["start"] = None
                ledger.note_guardian(rstep, "rollback", {"reason": reason, "from_step": int(at_step),
                                                         "attempt": attempt})
            # the abandoned verdicts: the replay re-verifies its steps (the
            # tag chain keeps the abandoned timeline, an append-only audit)
            secure_verdicts.clear()
            secure_fed["start"] = None
            state = pending_loss = pending_metrics = None  # the old state's memory goes with it
            rung = guardian.ladder.rung(attempt)
            if rung is not None:
                try:
                    new_overrides = rung.apply(overrides)
                    with Context("escalate"):
                        new_ts = build_training(new_overrides)
                    if ts.bounded_step is not None:
                        ts.bounded_step.close()  # the old stack's submission threads
                    overrides, ts = new_overrides, new_ts
                    if custody is not None:
                        custody.gar_spec = overrides.describe()  # later manifests sign the new spec
                    info("guardian: escalated — %s (now %s)" % (rung.describe(), overrides.describe()))
                    summaries.event(rstep, "guardian_escalation", {
                        "rung": rung.describe(), "attempt": attempt, "overrides": overrides.describe()})
                    timeline["escalations"].append(rung.describe())
                    c_escalations.inc()
                    note_escalation(rstep, rung, overrides)
                    if ledger is not None:
                        ledger.note_guardian(rstep, "escalation", {"rung": rung.describe(),
                                                                   "overrides": overrides.describe()})
                except UserException as exc:
                    warning("guardian: escalation rung %r rejected (%s); retrying with the current configuration"
                            % (rung.describe(), exc))
            if target is not None:
                # restored into a fresh state, whose side buffers (momentum,
                # reputation, loss EMA, flight ring, carry) start over (JAX
                # :2266-2276); the port's streams derive from (seed, step,
                # worker, tag), so the perturbation replaces the seed (trap
                # c); the lead restores, every rank receives its state
                state = make_fresh_state(args.seed)
                host = ts.engine.global_state(state)  # every rank: a collective under --mesh
                if checkpoints is not None:
                    host, rstep = checkpoints.restore(host, step=target)
                    host.seed = fold_in_seed(host.seed, RNG_PERTURB_TAG + attempt)
                share_restored(state, host)
            else:
                state = make_fresh_state(args.seed + RESEED_STRIDE * (attempt + 1))
            step = rstep
            live_state["step"] = step
            # the abandoned timeline: its snapshots and eval rows would poison
            # a later auto-restore or interleave with the retry's rows
            if checkpoints is not None:
                checkpoints.discard_after(rstep)
            eval_file.truncate_after(rstep)
            for trigger in (eval_trigger, ckpt_trigger, summary_trigger):
                if trigger.last_step is not None and trigger.last_step > rstep:
                    trigger.last_step = rstep
            reset_input(rstep, reseed=attempt + 1)
            if chaos is not None:
                chaos_regime_seen = chaos.regime_at(step)

    # the secure feed (JAX :2064-2100): the lead's HMAC sign and verify of
    # the previous call's digests, one call behind as the forensics feed,
    # so the host's work never waits for the call in flight; the verdicts,
    # by step, become the ledger's forgery evidence
    secure_fed = {"start": None}
    secure_verdicts = {}

    def feed_pending_secure():
        if secure_auth is None or pending_metrics is None or "secure" not in pending_metrics:
            return
        if secure_fed["start"] == pending_start:
            return
        secure_fed["start"] = pending_start
        with trace.span("secure.verify", cat="obs"):
            sec = {name: value.detach().cpu().numpy() for name, value in pending_metrics["secure"].items()}
            sent, recv, forged, rejected = sec["digest_sent"], sec["digest_recv"], sec["forged"], sec["rejected"]
            for i in range(sent.shape[0]):
                at_step = pending_start + i + 1
                ok = secure_auth.process_step(at_step, sent[i], recv[i], forged=forged[i])
                if not np.array_equal(~ok, rejected[i].astype(bool)):
                    # the step's rejection models the tag check exactly: a
                    # disagreement means the simulation drifted
                    warning("secure: host verification disagrees with the in-graph rejection at step %d" % at_step)
                if ledger is not None:
                    secure_verdicts[at_step] = ~ok

    # the forensics feed: one ledger observation a completed step, from the
    # previous call (JAX :2105-2165); ``forensics_fed`` keeps the same call
    # from being fed twice
    forensics_fed = {"start": None}

    def feed_pending_forensics():
        if ledger is None or pending_metrics is None or forensics_fed["start"] == pending_start:
            return
        forensics_fed["start"] = pending_start
        with trace.span("forensics.feed", cat="obs"):
            def rows(name, tree=None):
                # (K, n): one row a step of the call
                value = (pending_metrics if tree is None else tree).get(name)
                return None if value is None else np.atleast_2d(value.detach().cpu().numpy())

            probe_tree = pending_metrics.get(health.PROBE_KEY)
            dist, rep = rows("worker_sq_dist"), rows("worker_reputation")
            nan_rows = rows("worker_nan_rows", probe_tree) if probe_tree is not None else None
            # bounded-wait's deadline verdicts: a timed-out worker's NaN row is
            # explained, a stale one named (JAX :2126-2170)
            timeouts, stale_rows = rows("straggler_timeout"), rows("stale_infill")
            regime = pending_metrics.get("chaos_regime")
            regime = None if regime is None else np.atleast_1d(regime.detach().cpu().numpy())
            present = [v for v in (dist, rep, nan_rows, regime, timeouts) if v is not None]
            for i in range(max(v.shape[0] for v in present) if present else 0):
                ridx = None if regime is None else int(regime[min(i, regime.shape[0] - 1)])
                ledger.observe(pending_start + i + 1,
                               worker_sq_dist=None if dist is None else dist[i],
                               worker_nan=None if nan_rows is None else nan_rows[i],
                               reputation=None if rep is None else rep[i],
                               regime=ridx,
                               regime_desc=chaos.describe(ridx) if ridx is not None else None,
                               forgery=secure_verdicts.pop(pending_start + i + 1, None),
                               timeout=None if timeouts is None else timeouts[i],
                               stale=None if stale_rows is None else stale_rows[i])

    def observe_pending():
        """Feed the forensics ledger and the watchdog the previous call's
        diagnostics, one observation a completed step (JAX :2293-2350).  The
        lead's watchdog decides; at W > 1 its verdict reaches every rank.
        Returns True when a rollback happened: the caller drops the call it
        has in flight."""
        nonlocal pending_loss, pending_metrics
        feed_pending_secure()
        feed_pending_forensics()
        if watchdog is None or pending_metrics is None:
            return False
        with trace.span("block.probe_fetch", cat="guardian"):
            view = health.host_view(pending_metrics)
            losses = np.atleast_1d(pending_loss.detach().cpu().numpy())
            timeouts = pending_metrics.get("nb_timeouts")
            if timeouts is not None:
                timeouts = np.atleast_1d(timeouts.detach().cpu().numpy())
        start = pending_start
        pending_loss = pending_metrics = None
        rollback_at = 0
        if view is not None and lead:  # None: an engine built without the probe
            finite = np.atleast_1d(view["loss_finite"]).astype(bool)
            spikes = np.atleast_1d(view["spike"]).astype(np.float64)
            for i in range(losses.shape[0]):
                action = watchdog.observe(start + i + 1, float(losses[i]), bool(finite[i]), float(spikes[i]))
                if action is None and timeouts is not None:
                    # bounded-wait: timeouts beyond the declared budget,
                    # sustained, roll back and climb the ladder (JAX :2306-2335)
                    action = watchdog.observe_timeouts(start + i + 1, int(timeouts[i]), overrides.f)
                if action is None and ts.bounded_step is not None and ts.bounded_step.controller is not None:
                    # an adaptive window pinned at its ceiling: the arrival
                    # tail outgrew the budgeted window
                    action = watchdog.observe_ceiling(start + i + 1, ts.bounded_step.controller.at_ceiling)
                if action == "recovered":
                    info("guardian: recovered — %d healthy step(s) since the last rollback" % guardian.recover_after)
                    summaries.event(start + i + 1, "guardian_recovered", {
                        "attempt": watchdog.attempts - 1, "overrides": overrides.describe()})
                    timeline["recovered"].append(start + i + 1)
                    c_recoveries.inc()
                    if ledger is not None:
                        ledger.note_guardian(start + i + 1, "recovered", {"attempt": watchdog.attempts - 1})
                elif action == "rollback":
                    rollback_at = start + i + 1
                    break
        if view is not None:
            rollback_at = agree([rollback_at], (True,))[0]
        if rollback_at:
            do_rollback(rollback_at)
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
        if not lead:
            return  # every rank keeps the window's one-step calls; the lead writes the trace
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

    # at W > 1 the ranks stop together, at the agreed signal of any of them
    agreed = {"stop": False}

    def stopping():
        return stop["requested"] if W == 1 else agreed["stop"]

    # the regime of the next step to dispatch, tracked on the host: a switch
    # shows at a call boundary (JAX :2365-2372, :2470-2480)
    chaos_regime_seen = None
    launches_before = kernels.launch_counts()
    batched_before = kernels.batched_launch_counts()
    metrics, evaluation, perf, report, prefetcher, live, train_iter = {}, None, None, None, None, None, None
    feeders = []
    step, diverged, offstep = 0, False, 0
    # the divergence check and the watchdog read the previous call's losses
    # and probe (one call late): the call's metrics and its first step
    pending_loss, pending_metrics, pending_start = None, None, 0
    if args.trace_file and lead:
        trace.install(args.trace_file, run_id=run_id)
        info("Span tracing to %r (run_id %s)" % (args.trace_file, run_id))
    if args.journal and lead:
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
        restored = 0
        # under --mesh the lead restores the global layout (every rank
        # gathers it: a collective) and each rank loads its blocks
        host = ts.engine.global_state(state)
        if checkpoints is not None and checkpoints.can_restore():
            with Context("restore"):
                host, offstep = checkpoints.restore(host)
            restored = 1
            dropped = eval_file.truncate_after(offstep)
            if dropped:
                info("Trimmed %d stale eval row(s) beyond restored step %d" % (dropped, offstep))
            if watchdog is not None and offstep > 0:
                # the snapshot this run resumed from is the guardian's first
                # last-known-good (JAX :1604-1609)
                checkpoints.pin(offstep)
        # the lead restores; every rank starts from its state
        restored, offstep = agree([restored, offstep], (True, True))
        if restored:
            share_restored(state, host)
        # the flat mode's host is the state: no reference to it may outlive
        # the restore, or a rollback's fresh state leaves this one alive
        del host
        # the bring-up handshake (JAX :1611-1630), after the restore, so the
        # digest covers the parameters training starts from; every rank
        if args.session_secret:
            from ..parallel.auth import authenticate_processes

            with Context("auth"):
                # under --mesh each rank holds its own blocks (JAX verify_equal=mesh_axes is None)
                authenticate_processes(args.session_secret.encode(), state.params, step=offstep, axis=axis,
                                       verify_equal=grid is None)
                info("Host handshake OK: %d process(es) authenticated" % W)
        elif W > 1:
            warning("Multi-process run without --session-secret: the host boundary is UNAUTHENTICATED (the "
                    "reference signs every worker->PS tensor, mpi_rendezvous_mgr.patch:585-627); pass the same "
                    "--session-secret on every host to enable the bring-up handshake")
        reset_input(offstep)
        step, loop_steps_per_s = offstep, 0.0
        if chaos is not None:
            chaos_regime_seen = chaos.regime_at(step)
            info("Chaos regime at step %d: %s" % (step, chaos.describe(chaos_regime_seen)))
        live_state["step"] = step
        perf = PerfReport(registry=registry)
        if args.live_port is not None and lead:
            def live_status():
                return {"step": live_state["step"], "max_step": max_step,
                        "steps_per_s": perf.steps_per_s_excl_first(), "overrides": overrides.describe(),
                        "flight": live_state["flight"], "slo": live_state["slo"]}

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
                if step >= max_step or stopping():
                    # the lagged observation first: a rollback here re-enters
                    # training from the restored step (JAX :2357-2363)
                    if observe_pending() and step < max_step and not stopping():
                        continue
                    check_divergence()
                    break
                if not profiler["done"] and profiler["prof"] is None and step >= offstep + 2:
                    profiler_start()
                if xprof is not None:
                    # under --unroll the window's edges land on chunk boundaries
                    xprof.maybe_start(step)
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
                    with xprof.annotate(step) if xprof is not None else contextlib.nullcontext():
                        state, many = ts.multi_fn(state, chunk_input)
                    chunk = unroll
                elif device_dataset is not None:
                    # the final (max_step - start) % unroll steps, sampled too
                    # (under --trace's window, one step a call)
                    chunk = 1 if one_at_a_time else max_step - step
                    tail = ts.engine.build_sampled_multi_step(experiment.loss, ts.tx, chunk, experiment.batch_size)
                    gap_close()
                    perf.step_begin()
                    with xprof.annotate(step) if xprof is not None else contextlib.nullcontext():
                        state, many = tail(state, device_dataset)
                else:
                    if ts.multi_fn is not None and prefetcher is not None:
                        prefetcher.close()  # the chunk producer is done: the tail reads train_iter
                        prefetcher = None
                    with trace.span("input", cat="train"):
                        batch = next(prefetcher) if prefetcher is not None else ts.engine.put_batch(next(train_iter))
                    gap_close()
                    perf.step_begin()
                    with xprof.annotate(step) if xprof is not None else contextlib.nullcontext():
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
                if xprof is not None:
                    xprof.maybe_stop(step)
                if chaos is not None:
                    regime_now = chaos.regime_at(step)
                    if regime_now != chaos_regime_seen:
                        chaos_regime_seen = regime_now
                        info("Chaos regime switch at step %d: now %s" % (step, chaos.describe(regime_now)))
                        summaries.event(step, "chaos_regime_switch",
                                        {"regime": regime_now, "spec": chaos.describe(regime_now)})
                if profiler["prof"] is not None and step >= profiler["start"] + 3:
                    profiler_stop()
                # the cadences are the lead's clock's, and a signal on any
                # rank stops every rank after this call
                halted, eval_fire, ckpt_fire, summary_fire = agree(
                    [stop["requested"], eval_trigger.should_fire(step),
                     checkpoints is not None and ckpt_trigger.should_fire(step), summary_trigger.should_fire(step)],
                    (False, True, True, True))
                agreed["stop"] = agreed["stop"] or halted > 0
                if eval_fire:
                    check_divergence()
                    evaluation = run_eval(step)
                    eval_trigger.fired(step)
                if ckpt_fire:
                    check_divergence()
                    ef_rows = ts.engine.gather_ef(state)  # every rank: a collective at W > 1
                    saved = ts.engine.global_state(state)  # every rank: a collective under --mesh
                    if checkpoints is not None:
                        checkpoints.wait()  # surface a previous write's failure
                        checkpoints.save(saved, step, ef=ef_rows)
                        if watchdog is not None and watchdog.healthy and probe_clean(many):
                            # last-known-good: spared by pruning, the rollback
                            # target; every step of the call must read clean
                            # (JAX :2493-2501)
                            checkpoints.pin(step)
                    # the flat mode's is the state itself: a rollback must
                    # be able to free it
                    del saved
                    ckpt_trigger.fired(step)
                if summary_fire:
                    check_divergence()
                    fire_summary(step, metrics)
                    summary_trigger.fired(step)
            synchronize()
            loop_steps_per_s = perf.steps_per_s_excl_first()
            if W > 1:
                info("Rank %d of %d stopped at step %d" % (axis.rank, W, step))
            if profiler["prof"] is not None:
                profiler_stop()  # a run shorter than the window
            # the final fire of each cadence, unless it fired at this step
            # (a diverged run never gets here: no final snapshot of NaNs)
            if step > offstep:
                if eval_trigger.enabled and eval_trigger.last_step != step:
                    evaluation = run_eval(step)
                if args.checkpoint_dir and ckpt_trigger.last_step != step:
                    ef_rows = ts.engine.gather_ef(state)  # every rank: a collective at W > 1
                    saved = ts.engine.global_state(state)  # every rank: a collective under --mesh
                    if checkpoints is not None:
                        checkpoints.save(saved, step, ef=ef_rows)
                    del saved
                if summary_trigger.last_step != step:
                    fire_summary(step, metrics)
            if step > offstep and not diverged and not stop["requested"]:
                # the regression sentinel at run end (obs/slo.py, JAX
                # :2530-2556), before the summaries close (the verdict is a
                # summary event too); a run a signal stopped is not judged
                if sentinel is not None or args.slo_capture:
                    slo_current = obs_slo.collect_current(registry, perf)
                if sentinel is not None:
                    verdict = sentinel.verdict(slo_current, run_id=run_id)
                    live_state["slo"] = verdict
                    info(obs_slo.describe_verdict(verdict))
                    summaries.event(step, "slo_verdict", {"verdict": verdict["verdict"],
                                                          "regressed": verdict["regressed"],
                                                          "checks": verdict["checks"]})
                    if args.slo_verdict and lead:
                        obs_slo.save_verdict(args.slo_verdict, verdict)
                        info("SLO verdict -> %r" % args.slo_verdict)
                if args.slo_capture and lead:
                    doc = obs_slo.capture(args.slo_capture, slo_current, run_id=run_id)
                    info("SLO baseline -> %r (metrics: %s)" % (args.slo_capture, ", ".join(sorted(doc["metrics"]))))
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
        if xprof is not None:
            flush("xprof", lambda: xprof.close(step))
        compile_watch.close()
        if prefetcher is not None:
            prefetcher.close()
        if ts.bounded_step is not None:
            ts.bounded_step.close()
        eval_file.close()
        summaries.close()
        # the lagged feed drained before the report is written: the last
        # call's evidence sits one call behind by design
        flush("secure-drain", feed_pending_secure)
        flush("forensics-drain", feed_pending_forensics)
        if args.journal and obs_events.installed() is not None:
            # run_end closes the causal timeline before the forensics report
            # is written, so its journal section counts every event (JAX
            # :2596-2613)
            def journal_run_end():
                journal = obs_events.installed()
                obs_events.emit("run_end", step=step, diverged=diverged, aborting=aborting,
                                forensics=args.forensics if ledger is not None else None)
                if ledger is not None:
                    ledger.note_journal(journal.path, journal.counts_by_type())

            flush("journal-end", journal_run_end)
        if ledger is not None:
            def save_forensics():
                md_path = (args.forensics[:-5] + ".md" if args.forensics.endswith(".json")
                           else args.forensics + ".md")
                report = ledger.save(args.forensics, markdown_path=md_path)
                suspects = report["suspects"]
                info("Forensics report -> %r (%s)" % (
                    args.forensics, "Byzantine worker(s): %s" % ", ".join(map(str, suspects))
                    if suspects else "no worker attributed Byzantine"))

            flush("forensics-report", save_forensics)
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
    batched_launches = {name: count - batched_before[name] for name, count in kernels.batched_launch_counts().items()}
    if evaluation is not None:
        info("  final evaluation      %s" % "  ".join("%s=%.4f" % kv for kv in sorted(evaluation.items())))
    info("  kernel launches       %s" % "  ".join("%s=%d" % kv for kv in sorted(launches.items())))
    if any(batched_launches.values()):
        info("  batched launches      %s" % "  ".join("%s=%d" % kv for kv in sorted(batched_launches.items())))
    waits = [feeder.wait_seconds for feeder in feeders if getattr(feeder, "wait_seconds", None) is not None]
    return {
        "steps": step - offstep,
        "restored_step": offstep,
        "steps_per_s": loop_steps_per_s,
        "final_loss": float(metrics["total_loss"]) if metrics else None,
        "evaluation": evaluation,
        "launches": launches,
        "batched_launches": batched_launches,
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
        "nb_devices": W,
        "rank": axis.rank,
        "xprof_trace": xprof.path if xprof is not None else None,
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
