#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: build, check, train.

    python3 chip_smoke.py

Phases, in order (any failure exits non-zero and prints no result):

1. Print the card and its power limit, then build the CUDA kernels of
   ``aggregathor_tpu_torch/ops/csrc`` with nvcc (one process per source).
2. Hold every kernel against its plain PyTorch version on the card, on the
   main path's shapes -- (8, 1,756,682), the cnnet gradient matrix of n=8
   workers (for K6 with NaN runs of 16,250 coordinates in 4 rows, what
   --UDP 4 sends); (5, 1,756,682) with beta=1, Bulyan's last phase at n=11,
   f=2; (11, 1,756,682), Bulyan's distances; the raw (128, 1,756,682) and
   its column median, Krum's distances at n=128 (K2 centres as it loads) --
   and on poisoned inputs: NaN and +-inf rows and columns, tied values, a
   majority-NaN column, widths that are no multiple of the kernels' chunks,
   n=256 (for K1 n = 1, 3, 16, 17, and 20 and 21 on both sides of its
   switch from registers to staged tiles, 33 and 64, the (64, 1,756,682)
   matrix, and even widths on a 4-byte-aligned start at n = 8, 17 and 21;
   for K2 n = 65, 127, 128, 129 and 256 at widths of every residue mod 4,
   with and without a centre, and an even width on a 4-byte-aligned
   start).  Tolerances: K3 bit-exact (the kernel returns an original
   value); K4, K5, K6: same NaN/inf pattern, |a - b| <= 1e-6 (1 + |b|)
   (sums of unit-scale float32 values in another order); K1: same NaN
   pattern, relative 1e-5 (a sum of d squares in another order; the
   diagonal must be 0 in both); K2: the same non-finite pattern with every
   non-finite entry NaN (its 3xTF32 split turns an inf into NaN parts, so it
   cannot keep float32's mix of +inf and NaN), diagonal 0, symmetric bit
   for bit, and off the diagonal |a - b| <= 1e-5 (|x_i|^2 + |x_j|^2) on the
   centred rows (a Gram form's terms are as large as the squared norms, so
   its error scales with them, not with the distance).  Beyond 64 rows K3/K4/K5 and the median
   centring in front of K2 (``nanmedian_columns``, bit-exact like K3) run
   their sort path: held at the main path's shapes (K3 and K5 (8, 112) at
   (128, 1,756,682), K4 beta=94 at (110, 1,756,682), the centring on the raw
   (128, 1,756,682)) and on poisoned inputs at n = 65, 127, 128, 129, 256
   and 1000, and at 1030 on the re-reading path (NaN/+-inf rows and columns, an all-NaN and a majority-NaN
   column, signed zeros, ties, widths off the blocks' column counts).  Each
   kernel is timed with CUDA events at its main-path shape (K1 also at
   (11, d) and (64, d), K3-K5 also at their sort-path shape), and by
   torch.profiler for its time on the card alone (without the host's time
   between calls), beside its plain version, one PyTorch library call
   where one computes the same function, and its bound: max(bytes moved /
   3.35 TB/s, operations / 67 TFLOP/s FP32), the operations of K1 being
   its pairs i < j (the diagonal needs only a row's finiteness), those of
   the sort path its compare-exchanges, those of K2 its 3xTF32 tensor-core
   products at 495 TFLOP/s.  K2's row also times the whole distance path on the raw
   (128, d) (centring and K2).  Distances of 64 rows must launch K1 and of
   65 the centring and K2.  The worker axis's column blocks at W = 2
   (``BLOCK_SHAPES``: K1 at (8, 878,341), the centring and K2 at (128,
   878,341), K3, K5 and K6 at (8, 878,341)) are held and timed too, clean and
   poisoned.
3. The worker gradients of cnnet at n=8, batch 128: the engine's one
   vmapped forward and backward (``torch.func``) against a per-worker loop
   on the same weights and batches, each row within ``VMAP_RTOL`` of its
   largest magnitude, no batching-rule fallback (warnings are errors); both
   timed, with the vmap's peak memory.
   Drive the port's runner on the card: cnnet + krum (n=8, f=2, r=2
   signflip) for 15 steps at d = 1,756,682, the same with the cifarnet
   augmentation in the step and the batches drawn on the card
   (``augment:device --input-source device``), then a few steps each of
   bulyan (n=11, f=2), median, trimmed-mean, averaged-median, krum at n=128
   (the centring and K2), bulyan at n=128 (the centring, K2, and K4 on the
   sort path), and the lossy link: average-nan (K6) and krum under --UDP, and
   average under --UDP with CLEVER infill; then the engine's options: krum
   per parameter leaf (``--granularity leaf``, bucketed by leaf size on the
   card: the batched kernels once for each of cnnet's 9 leaf sizes a step,
   none unbatched, ``PER_BUCKET``, counted from ``FlatMap.slices``) at n=8
   (K1) and at n=128 (the centring and K2, the 10-wide logits bias
   included), the suspicion flags of JAX ``test_engine.py``'s quarantine
   test (``SUSPICION``: worker metrics, reputation 0.5, quarantine 0.4)
   under a deviation-100 gaussian attack with krum and a 64-row flight
   recorder for 30 steps and with average-nan (K6 on the quarantined NaN
   rows) for 10, whose last summary must show the two attackers quarantined
   (reputation < 0.1, the others > 0.9, krum's participation 0, one flight
   row a step), worker momentum over the bf16 wire, cnnet in bf16
   (``dtype:bfloat16``), two steps of ``--trace-ops`` (three TRACE lines a
   step), and momentum at n=128 (its 0.9 GB buffer beside the activations);
   each options leg's steps/s is printed beside cnnet+krum's.  Every launch
   count is set to 0 just before a leg and read just after: each leg must
   have launched its kernels once a step (or once a leaf a step), and its
   loss must be finite; each leg's peak device
   memory is printed (the n=128 legs hold all 128 workers' activations at
   once).  The runner prefetches two batches ahead by default.  The kernels
   of the leaf path are held against their plain versions at each of
   cnnet's leaf widths (10 to 1,572,864 columns, a NaN row in each: K1 and
   K6 at n = 8, the centring and K2 at n = 128), and the MLP with momentum,
   reputation, quarantine, worker metrics and granularity:leaf runs 5 steps
   on the card (bucketed) and on the CPU (the per-leaf loop) from one init
   at n = 8 (K1) and n = 72 (K2, the quarantined rows' all-NaN distances):
   identical participation,
   reputations, quarantine counts and masked rows, parameters within rtol
   1e-4, atol 1e-5.  Then each rule's
   aggregate of a small poisoned matrix on the card is held against the
   same rule on the CPU (Krum's and Bulyan's selections must be identical,
   at n=11, n=72 and n=128, and Krum's near a tie, ``NEAR_TIES``), three MLP
   steps on the card against the same steps
   on the CPU, without and with --UDP-style loss, and each rule's time on
   the (n, d) cnnet matrix is read (GAR ms a step), with the engine's krum
   aggregation at n = 8 and 128 on the whole rows and per leaf, and the
   worker-metric and reputation passes alone.
   The cnnet legs evaluate on their step delta only (``--evaluation-period
   -1``), so no wall-period evaluation lands in their timed window.
4. The real data: the loaders are pointed at the port's copy of the UCI
   digits (``aggregathor_tpu_torch/data/digits.npz``; the card's machine
   has no scikit-learn) and the corpus must be real.  Then the anchors of
   docs/robustness.md, Multi-Krum n=8, f=2: ``digits`` (d = 7,510) for 4000
   steps at lr 0.1 must reach 0.95 real test accuracy (the JAX package:
   0.961), ``digits-conv`` (cnnet at 32x32x1, d = 1,753,482, batch 16) for
   400 steps at lr 0.05 must reach 0.96 (JAX: 0.975), both with cuDNN's
   deterministic algorithms (these anchors run in a child process,
   ``chip_smoke.py --digits-anchors``, beside the zoo phase's card legs,
   joined before its Z4); then ``digits`` again with its batches drawn on
   the card, 10 steps a call (``--input-source device --unroll 10``), which
   must reach ``DIGITS_DEVICE_FLOOR``; each must launch K1 once a step and
   nothing else.  K1 is held at their widths (and at odd
   widths beside 7,510) in phase 2, and timed at both.  ``digitsAttack``:
   severity 2 must train, evaluate, and stop with the loud divergence error
   or a finite loss; severity 1 trains 100 steps (``mnistAttack``, 20).
   Resume, for ``digits`` and ``digits-conv``: 20 steps uninterrupted
   (twice, once with cuDNN's default algorithms), then 10 with a
   checkpoint and a second runner call that restores it and runs to 20; the
   restored state must equal the saved one bit for bit, the losses of steps
   11-20 must match the uninterrupted run's within ``RESUME_RTOL`` (bit for
   bit, with cuDNN pinned to its deterministic algorithms), the TSV
   must hold no step twice, and the summary JSONL must carry the run id and
   the four scalars; both again with the batches drawn on the card, 4 steps
   a call (``--input-source device --unroll 4``).
   The input pipeline (``pipeline_phase``): cnnet ``augment:device``
   + krum n=8 at ``--unroll 10`` for ``PIPELINE_STEPS`` steps, synchronous,
   and through the chunk pipeline at 4 and 1 slices and at 1 gather thread;
   every leg's per-step losses must be the synchronous leg's bits, K1 once
   a step; each prints its steps/s
   without the first call and its ``input_*`` deltas.  Then cnnet with its
   host augmentation (the sequential gather) and ``digits`` at ``--unroll
   16`` (the gather pool) through the pipeline, bit for bit against their
   synchronous twins.  The metrics plane (``plane_phase``): cnnet + median
   through the pipeline with ``--gar-probe``, ``--metrics-file``,
   ``--trace-file``, ``--run-id`` and the live exporter, scraped while it
   trains; the metrics file, the span trace, the endpoints and K3's
   launches (a step and a probe call) are checked.  ``--trace``
   (``profiler_phase``): torch.profiler's Chrome trace of a krum leg must
   name K1's kernel.  ``--xprof 2:4`` and ``--forensics``
   (``observability_phase``): one trace with the ``train step``
   annotations of steps 2 and 3 and the card's kernels, the memory gauges
   above 0, and a report that names the gaussian coalition.  The worker
   axis (``multirank_phase``): two gloo ranks spawned on ``cuda:0``
   (NCCL refuses two ranks on one card, so the collectives are staged
   through pinned host memory and NCCL across ranks stays unmeasured) run
   cnnet + krum and median for ``MULTIRANK_STEPS`` steps and the GAR
   probes of krum at n = 128 and centered-clip, against one rank on the
   same weights and batches (losses within 1e-5 relative, selections
   identical, launches exact on each rank at the block shapes); it prints
   each step's ms and the staged collectives' ms and MB.  Before it the
   chaos phase (``chaos_phase``): cnnet drawn on the card with
   its augmentation in the step under ``CHAOS_SCHEDULE`` (average-nan, a
   drop storm, an empire coalition and stale stragglers: K6 once a step,
   the regime log and ``chaos_regime_switch`` events at exactly
   ``CHAOS_SWITCHES``) and ``CHAOS_LATE`` (median with
   ``straggle-workers:2``: K3 once a step; build_step with average: the
   parameters finite through step 2, not at step 3); the same on
   ``digits`` on the card and on the CPU (the masks drawn on CPU
   generators: losses within 1e-5 relative, regimes identical); a micro
   campaign (digits, average and median x calm and empire) whose verdicts
   on the card equal the CPU's; each regime's ms a step, and the
   ``--UDP 4`` link's, against calm.
   And the codec phase (``codec_phase``): int8 and top-k (k = 17,567)
   payloads, images and error-feedback residuals at (8, 1,756,682) equal
   the CPU's bit for bit (NaN at the same places: a NaN's payload is the
   device's), the codecs timed beside their byte bounds, and cnnet + krum
   under each of ``CODEC_WIRES``: K1 once a step, ``bytes_on_wire_total``
   exact, ms a step against the f32 wire.  A resume of ``digits-conv``
   under ``--exchange int8:ef`` ends with the uninterrupted run's bits,
   the residuals included.
   The bounded-wait phase (``bounded_phase``, legs A-H): the bounded
   aggregate at (8, 1,756,682) on the card against the CPU for krum,
   median, trimmed-mean and average-nan (timed-out and stale rows, K1, K3,
   K5 and K6 once a call); the synchronous protocol (a CUDA stream a
   worker) against the fused step, both rounds' ms; cnnet through the
   runner under two persistent stragglers (``--step-deadline``), stale
   infill with and without ``--stale-reweight``, the guardian's escalation
   for timeouts beyond f; the adaptive window (``--deadline-percentile
   71.4``) with the honest arrivals' p50/p95; ``int8:ef`` folded as rows
   land against the stacked path, bit for bit; a 2 ms deadline's race.
   Bounded-wait over two ranks (``bounded_ranks_phase``): two gloo ranks
   spawned on ``cuda:0`` run cnnet's bounded rounds (a 1 s deadline,
   workers 0 and 5 stalled 4 s from round 1: krum 3 rounds, median and
   average-nan 2 each) against one rank on the same weights and batches:
   the masks and krum's selections equal, the parameters bit-identical
   across the ranks and within 1e-5 of the one rank's, K1, K3 and K6 once
   a round on each rank's (8, 878,341) block, no kernel built; it prints
   each rank's round ms, the verdicts' gather ms and the staged MB.  Each
   phase from the pipeline's on prints its seconds.
   The secure phase (``secure_phase``): ``row_digest`` and
   ``masked_group_mean`` at cnnet's width on the card against the CPU, bit
   for bit, and timed; cnnet + krum under a forge/tamper schedule with
   ``--secure`` (every rejected worker named ``forgery``, K1 once a step)
   and without (the digest tax), average-nan under ``--secure`` (K6 over
   the rejected rows), an ``--encrypt-checkpoints`` save and resume under
   custody and a flipped byte refused, and ``--secure-mask`` bucketing
   (the centring and K2 on the bucket means) against the unmasked leg.
   The zoo phase (``zoo_phase``, before the ranks): cuDNN's float32 conv
   weight gradient at each of ResNet-50's 23 conv shapes on Z1 and the
   ImageNet stem against float64 (the shapes of
   ``common.F64_WEIGHT_GRAD_SHAPES`` take the float64 path, the rest must
   hold 1e-5 of the largest entry); Z1 ``slim-resnet_v1_50-digits32`` +
   Bulyan at n = 32, f = 7, batch 16 (d = 23,519,690; K1's staged tiles
   and K4 at beta = 2 once a step; the peak memory, its breakdown and the
   gradient phase with every weight gradient in float64); Z2 the ImageNet
   shape at 224x224 (the stand-in, d = 25,557,032); Z3 resnet_v1_18 +
   krum on digits32, 400 steps, real test accuracy >= 0.92; Z4 every one
   of the 34 nets, 2 median steps each, within 120 s; Z5 a Bulyan step card
   against CPU (float32 within 2e-2, float64 within 1e-9, the same
   selections; the CPU's half on a thread from the phase's start); K1 and
   K4 at the zoo's widths, timed.  Every zoo leg runs with the vmap
   fallback's warning an error.
   The analysis phase (``analysis_phase``, after the GAR extensions'): the
   port's GAR contract sweep (``aggregathor_tpu_torch/analysis``, every
   spec of the JAX gate's list) on the card through K1-K6 and the
   centring at d = 8 and at cnnet's width, whose findings must be the
   CPU's sweep's at the same width, fingerprint for fingerprint (the
   CPU's at cnnet's width in a niced child process started after the
   build, ``chip_smoke.py --gar-sweep-cpu``); K1 launched by krum, the
   centring and K2 by bucketing's 4 bucket means, K3 by median, K4 by
   averaged-median and bulyan, K5 by trimmed-mean, K6 by average-nan; no
   kernel built; within ``ANALYSIS_BUDGET_S``.
   The serve phase (``serve_phase``, after the transformer's): S1 cnnet
   trained 4 steps with ``--secure`` and checkpoints, then served by
   ``python -m aggregathor_tpu_torch.cli.serve`` (3 replicas, median,
   replica 1 NaN, custody under the session secret) from a subprocess:
   ``/healthz`` reports custody verified; requests of 1, 3, 17 and 64 rows
   and 100 rows split client-side (a 100-row request is refused, 400) give
   the clean replica's predictions with disagreement exactly [0, null, 0]
   (the median of identical replicas is the clean logits bit for bit, which
   an in-process engine shows on the logits themselves); a SIGHUP reload to
   a newer step moves ``weights_step`` with no request failing; no kernel
   library is built after the ready file (the build directory and the
   child's ``serve_kernel_builds``); K3 once a served bucket (the child's
   ``serve_kernel_launches``); SIGTERM exits 0.  S2 an in-process engine on
   ``slim-resnet_v1_50-digits32`` (d = 23,519,690, R = 3, one NaN replica,
   buckets 1-32): the vote equals the clean replica's logits bit for bit,
   predict's p50 and p99 a bucket with the K3 vote's share.  S3 K3-K6 and
   K1 at the vote's shapes (R, bucket x 10) held against their plain
   versions (R = 3, 5, 7, poisoned) and timed; an engine a rule
   (averaged-median, trimmed-mean, average-nan, krum at R = 5, two NaN
   replicas) launching its kernel once a bucket and serving the clean
   predictions; a ContinuousBatcher leg at lanes 1 and 2 (requests/s).
   The topology phase (``topology_phase``, after the serve phase): F1
   cnnet at n = 32, f = 1 through ``--topology tree:g=4x2,rules=median>
   median>krum,redundancy=2`` with a far deadline under ``0:corrupt-agg=1.1
   3:straggle-agg=2.1``, 6 steps: unit 1.1's forged tag and unit 2.1's
   timeout each served by shadow 2 (the journal and forensics name them),
   every round's masks untouched, the parameters bit-identical to the same
   run without the schedule (cuDNN pinned), K3 4, the centring and K2 once
   a step; F1b the schedule without redundancy (``median>median>median,
   agg-f=1x1``): both subtrees excluded, leaves 4-7 then 8-15 cleared from
   the masks, the losses finite, K3 5 a step; F2 the emissions alone at
   ``tree:g=8,rules=krum>median``, n = 64, on the card's rows against the
   CPU's plain emission (1e-5; digests equal where the summaries are
   bit-equal), the centring and K2 once a unit, timed; the kernels at the
   tree's shapes held and timed; F3 the sentinel: a capture, its repeat
   PASS, a baseline ×10 faster REGRESS; F4 ``cli.supervise`` over a
   ``cli.serve`` child serving cnnet: SIGKILLed, restarted, ``/healthz``
   answers, ``cli.postmortem`` exits 0.
   Last, a cnnet + krum step and a digits-conv + krum step are split into
   their phases (host batch, transfer, augmentation, worker gradients,
   attack + aggregate, update), with the batches streamed and drawn on the
   card (cnnet then augments in the step), and cnnet in bf16 drawn on the
   card, and the card's busy share over whole steps is traced with
   torch.profiler.
5. Print the kernels held against their plain versions, the JSON kernel
   table, and last the JSON result line.
"""

import collections
import concurrent.futures
import json
import math
import os
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import time

MEMORY_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FP32_OPS_PER_S = 67e12        # H100 SXM, FP32 outside the tensor cores
TF32_OPS_PER_S = 495e12       # H100 SXM, dense TF32 on the tensor cores
CNNET_D = 1756682
DIGITS_D = 7510          # the digits MLP, 64-100-10
DIGITS_CONV_D = 1753482  # cnnet at 32x32x1
#: Krum near a tie (n, f, d, margin): the two scores at the selection's
#: boundary differ by ``margin`` relative, just above the distance kernel's
#: measured error on these rows (K1 at n = 8: scores within 7.9e-8 of
#: float64; the centring and K2 at n = 72 and 128: within 5.4e-7)
NEAR_TIES = ((8, 2, CNNET_D, 2e-7), (72, 8, 100003, 1.5e-6), (128, 8, 100003, 1.5e-6))
#: the digits anchor drawn on the card (``--input-source device``): the least
#: real test accuracy at 4000 steps, below the port's CPU runs of that path
#: over seeds 0-3 (PERF.md)
DIGITS_DEVICE_FLOOR = 0.95
#: the vmapped worker gradients on the card: at batch 8 against a per-worker
#: loop, each row within this share of the row's largest magnitude (float32
#: sums in other orders)...
VMAP_RTOL = 1e-5
#: ...and in float64 at batch 128 (``vmap_phase`` says why not in float32)
VMAP_F64_RTOL = 1e-10


def fail(message):
    print("chip_smoke: FAILED: %s" % message, file=sys.stderr)
    sys.exit(1)


def check(condition, message):
    if not condition:
        fail(message)


def batched(name):
    """The key of kernel ``name``'s batched form in a phase's launch counts
    and in the kernels line."""
    return name + "_batched"


def zero_counts(kernels):
    """{kernel: 0} for every kernel and its batched form."""
    return {key: 0 for name in kernels.KERNELS for key in (name, batched(name))}


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def time_ms(fn, torch, iters=20, warmup=3):
    """Mean milliseconds of fn() on the card, by CUDA events over ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def device_ms(fn, torch, iters=20, warmup=3, tries=3):
    """Mean milliseconds of the port's own kernels in fn(): the summed
    durations of their events in a torch.profiler trace of ``iters`` calls,
    without the host's time between launches.  The port's kernels are those
    of ops/csrc, which keep them in an anonymous namespace (PyTorch's live in
    at::).  A trace of one call counts them by name (an empty one, as a
    fresh profiler's first cycle can give, is read off the longer trace when
    every kernel's count there is the same multiple of ``iters``); a trace
    of ``iters`` calls that does not hold ``iters`` times each count has
    lost some (it happens, most in a long process): both are taken again.
    After ``tries`` such pairs the time is each kernel's median recorded
    duration times its launches a call, from the last pair (a line says so),
    or None, not measured, when that pair did not record every kernel."""
    from torch.profiler import ProfilerActivity, profile

    def traced(calls):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                and ("(anonymous namespace)::" in e.name or "_GLOBAL__N_" in e.name)]

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        per_call = collections.Counter(e.name for e in traced(1))
        events = traced(iters)
        counts = collections.Counter(e.name for e in events)
        multiples = set(counts.values())
        if not per_call and len(multiples) == 1 and multiples.pop() % iters == 0:
            per_call = collections.Counter({name: count // iters for name, count in counts.items()})
        if per_call and counts == collections.Counter({name: c * iters for name, c in per_call.items()}):
            return sum(e.time_range.elapsed_us() for e in events) / iters / 1e3
    if not per_call or set(counts) != set(per_call):
        return None
    print("device_ms: every trace lost events (%d of %d recorded in the last): each kernel's median duration "
          "times its launches a call" % (len(events), sum(per_call.values()) * iters))
    return sum(statistics.median(e.time_range.elapsed_us() for e in events if e.name == name) * count
               for name, count in per_call.items()) / 1e3


def card_busy_us(torch, prof):
    """(microseconds the card was busy, events): the union of the card's
    event intervals in a torch.profiler trace."""
    intervals = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA)
    busy_us, reach = 0.0, None
    for lo, hi in intervals:
        if reach is None or lo > reach:
            busy_us += hi - lo
            reach = hi
        elif hi > reach:
            busy_us += hi - reach
            reach = hi
    return busy_us, len(intervals)


def poison(x, columns=True):
    """A NaN row, scattered +-inf and NaN values, tied values and two equal
    rows; with ``columns``, also whole NaN and +-inf columns (which would
    make every pairwise distance NaN, so the distance inputs leave them out)."""
    n, d = x.shape
    x[n // 2, :] = float("nan")
    if columns:
        x[:, 1] = float("nan")
        x[:, 2] = float("inf")
        x[:, 3] = -float("inf")
    x[0, 5:d:97] = float("inf")
    x[n - 1, 7:d:89] = float("nan")
    x[1, 11:d:61] = -float("inf")
    x[:, 13] = 0.5          # a column of ties
    x[: n // 2, 17] = -2.0  # half a column tied
    if n > 3:
        x[n - 2] = x[n - 3]  # two identical rows: a zero distance
    return x


def krum_near_tie(torch, n, f, d, margin, seed):
    """(n, d) float32 rows on the CPU whose Multi-Krum scores straddle the
    selection's boundary by ``margin``, and the (n,) bool selection.

    With m = n - f - 2 rows selected, the smallest score outside the
    selection exceeds the largest inside by ``margin`` times the latter, in
    float64 on the float32 rows.  Rows are normals at distinct scales, so the
    scores start well apart; the last selected row then moves along a fixed
    random direction, the step set by bisection until the gap is the margin."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((n, d), generator=gen) * (1.0 + 0.05 * torch.arange(float(n)))[:, None]
    direction = torch.randn(d, generator=gen, dtype=torch.float64)
    x64 = x.double()
    norms = torch.sum(x64 * x64, dim=1)
    dist = torch.clamp_min(norms[:, None] + norms[None, :] - 2.0 * (x64 @ x64.T), 0.0)
    m = n - f - 2

    def scores(dist):
        off = dist + torch.diag(torch.full((n,), torch.inf, dtype=torch.float64))
        return torch.sum(torch.sort(off, dim=1).values[:, :m], dim=1)

    order = torch.argsort(scores(dist), stable=True)
    selected = torch.zeros(n, dtype=torch.bool)
    selected[order[:m]] = True
    moved = int(order[m - 1])

    def gap(step):
        row = (x64[moved] + step * direction).float()
        row64 = row.double()
        to_row = torch.clamp_min(norms + torch.sum(row64 * row64) - 2.0 * (x64 @ row64), 0.0)
        to_row[moved] = 0.0
        trial = dist.clone()
        trial[moved], trial[:, moved] = to_row, to_row
        s = scores(trial)
        return float(s[~selected].min() - s[selected].max()) - margin * float(s[selected].max()), row

    low, high = 0.0, 1e-3
    while gap(high)[0] > 0:
        low, high = high, 2 * high
    for _ in range(60):
        mid = (low + high) / 2
        if gap(mid)[0] > 0:
            low = mid
        else:
            high = mid
    x[moved] = gap(low)[1]
    return x, selected


def compare(name, a, b, torch, x=None, args=()):
    """Max |a - b| over finite entries, after the exactness checks of ``name``
    (``x`` and ``args``: the inputs, for K2's tolerance on the centred rows)."""
    check(a.shape == b.shape, "%s: shape %s != %s" % (name, tuple(a.shape), tuple(b.shape)))
    if name == "pairwise_sq_distances_gram":
        # the same entries non-finite, and each of them NaN in the kernel's
        # output: a 3xTF32 split turns an inf into hi = inf and lo = NaN, so
        # the kernel cannot keep float32's mix of +inf and NaN (every caller
        # maps a non-finite distance to +inf before scoring)
        check(torch.equal(torch.isfinite(a), torch.isfinite(b)), "K2: non-finite pattern differs")
        check(bool(torch.all(torch.isnan(a[~torch.isfinite(a)]))), "K2: a non-finite entry is not NaN")
        diagonal = torch.diagonal(b)
        check(bool(torch.all(torch.diagonal(a)[torch.isfinite(diagonal)] == 0)), "K2: diagonal not 0")
        check(torch.equal(a.view(torch.int32), a.T.contiguous().view(torch.int32)), "K2: not symmetric bit for bit")
        rows = x - args[0][None, :] if args else x
        norms = torch.sum(torch.square(rows.double()), dim=1)
        del rows
        scale = norms[:, None] + norms[None, :]
        off = torch.isfinite(b) & ~torch.eye(b.shape[0], dtype=torch.bool, device=b.device)
        err = torch.abs(a.double() - b.double())[off]
        max_err = float(err.max()) if err.numel() else 0.0
        check(bool(torch.all(err <= 1e-5 * scale[off])), "K2: outside tolerance (max err %g)" % max_err)
        return max_err
    check(torch.equal(torch.isnan(a), torch.isnan(b)), "%s: NaN pattern differs" % name)
    if name in ("coordinate_median", "nanmedian_columns"):
        same = torch.equal(a.view(torch.int32), b.view(torch.int32))
        check(same, "%s: not bit-identical to the plain version" % name)
        return 0.0
    inf_a, inf_b = torch.isinf(a), torch.isinf(b)
    check(torch.equal(inf_a, inf_b) and torch.equal(a[inf_a], b[inf_b]), "%s: inf pattern differs" % name)
    finite = torch.isfinite(b)
    err = torch.abs(a[finite] - b[finite])
    if name == "pairwise_sq_distances":
        check(bool(torch.all(torch.diagonal(a)[torch.isfinite(torch.diagonal(b))] == 0)), "K1: diagonal not 0")
        bound = 1e-5 * torch.abs(b[finite]) + 1e-6
    else:
        bound = 1e-6 * (1.0 + torch.abs(b[finite]))
    max_err = float(err.max()) if err.numel() else 0.0
    check(bool(torch.all(err <= bound)), "%s: outside tolerance (max err %g)" % (name, max_err))
    return max_err


def bounds(kernels, name, n, d):
    """(bytes, operations, what the operations count, their peak rate) of one
    call at (n, d)."""
    if name == "pairwise_sq_distances":
        # the diagonal is 0 or NaN, which a row's finiteness decides: a test a value
        return (n * d * 4 + n * n * 4, n * (n - 1) // 2 * d * 3 + n * d,
                "3 per pair i < j and column, a test per value", FP32_OPS_PER_S)
    if name == "pairwise_sq_distances_gram":
        # x and the centre read once; FP32 accuracy on the tensor cores takes
        # 3 TF32 products (lo.hi, hi.lo, hi.hi) of a multiply and an add
        return (n * d * 4 + d * 4 + n * n * 4, 3 * 2 * n * (n + 1) // 2 * d,
                "3xTF32: 3 products of 2 per pair and column", TF32_OPS_PER_S)
    if name == "average_nan_columns":
        return n * d * 4 + d * 4, 2 * n * d + d, "a test and an add per value", FP32_OPS_PER_S
    if n <= 64 and name != "nanmedian_columns":
        passes = 2 if name == "coordinate_averaged_median" else 1
        return n * d * 4 + d * 4, passes * n * n * d + n * d, "n^2 compares per rank pass", FP32_OPS_PER_S
    # the sort path: P log2(P) (log2(P) + 1) / 4 compare-exchanges of a min
    # and a max per column and sort (two sorts for K4), n steps of the row
    # pass, P the power of two the rows need (the kernel pads to at least
    # 128 lanes, which the function does not need: not counted)
    p = 1 << max(0, (n - 1).bit_length())
    log_p = p.bit_length() - 1
    sorts = 2 if name == "coordinate_averaged_median" else 1
    return (n * d * 4 + d * 4, sorts * (p * log_p * (log_p + 1) // 2 + n) * d, "the sort's min/max",
            FP32_OPS_PER_S)


def timed_row(torch, kernels, name, x, args, library, max_abs_err):
    """Time kernel, plain version and library call at x; the JSON row's numbers."""
    kernel, plain = getattr(kernels, name), kernels.PLAIN[name]
    n, d = x.shape
    ms = time_ms(lambda: kernel(x, *args), torch, iters=20 if n > 64 else 50, warmup=5)
    kernel_ms = device_ms(lambda: kernel(x, *args), torch)
    plain_ms = time_ms(lambda: plain(x, *args), torch, iters=5)
    library_ms = time_ms(lambda: library(x), torch, iters=5) if library else None
    nbytes, ops, counted, peak = bounds(kernels, name, n, d)
    bytes_ms, ops_ms = nbytes / MEMORY_BYTES_PER_S * 1e3, ops / peak * 1e3
    return {"ms": ms, "device_ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations", "library_ms": library_ms,
            "shape": [n, d], "max_abs_err": max_abs_err, "operations": ops, "operations_ms": ops_ms,
            "operations_counted": counted, "operations_per_s": peak}


def kernel_phase(torch, kernels):
    """Hold each kernel against its plain version; time it at the main shape."""
    gen = torch.Generator(device="cuda").manual_seed(20261016)

    def randn(n, d):
        return torch.randn((n, d), device="cuda", generator=gen)

    def gram_poison(n, d, centre=True):
        """Raw poisoned rows and K2's arguments: their column median, or none."""
        x = poison(randn(n, d), columns=False)
        x[: n // 2 + 1, 19] = float("nan")  # a majority-NaN column
        return x, (kernels.nanmedian_columns(x),) if centre else ()

    def lossy(n, d):
        # what --UDP 4 sends: NaN runs of 16,250 coordinates in the first 4 rows
        x = randn(n, d)
        packets = -(-d // 16250)
        for w, first in ((0, 3), (1, 40), (2, 41), (3, packets - 1)):
            x[w, first * 16250:(first + 1) * 16250] = float("nan")
        return x

    def rank_poison(n, d):
        # poison() with its NaN and +-inf columns, plus a majority-NaN column
        # and signed zeros, which tie with +0 yet keep their sign
        x = poison(randn(n, d))
        x[: n // 2 + 1, 19] = float("nan")
        x[::3, 21] = -0.0
        x[1::3, 21] = 0.0
        return x

    main = randn(8, CNNET_D)
    bulyan_rows = randn(11, CNNET_D)
    k1_wide = randn(64, CNNET_D)  # K1 at the most rows it serves
    bulyan_sel = randn(5, CNNET_D)
    raw128 = randn(128, CNNET_D)
    bulyan128 = raw128[:110].contiguous()  # Bulyan's t = 110 selections at n = 128, f = 8
    udp = lossy(8, CNNET_D)
    digits_rows, digits_conv_rows = randn(8, DIGITS_D), randn(8, DIGITS_CONV_D)
    all_nan = randn(7, 3001)
    all_nan[:, 100] = float("nan")
    # beyond 64 rows (the sort path up to 1024, the re-reading path beyond):
    # widths off the sort blocks' 32/16/8 columns
    beyond = [(n, 4099 if n <= 256 else 1025) for n in (65, 127, 128, 129, 256, 1000, 1030)]
    cases = {
        # K1's register path up to 20 rows, its staged path beyond (N = 32, 64)
        "pairwise_sq_distances": [(main, ()), (bulyan_rows, ()), (k1_wide, ()), (poison(randn(8, 100003), False), ()),
                                  (poison(randn(11, 5001), False), ()), (poison(randn(64, 20011), False), ()),
                                  (poison(randn(3, 129), False), ()), (poison(randn(16, 20011), False), ()),
                                  (poison(randn(16, 4098), False), ()), (poison(randn(17, 20011), False), ()),
                                  (poison(randn(17, 4099), False), ()), (poison(randn(20, 4098), False), ()),
                                  (poison(randn(21, 4099), False), ()), (poison(randn(33, 4098), False), ()),
                                  (randn(1, 129), ()),
                                  # the digits legs' widths, and odd widths beside the MLP's, where the
                                  # grid is a few blocks and the last block sums few partials
                                  (digits_rows, ()), (digits_conv_rows, ()),
                                  (poison(randn(8, DIGITS_D + 1), False), ()),
                                  (poison(randn(8, DIGITS_D - 1), False), ())],
        "coordinate_median": [(main, ()), (poison(randn(8, 100003)), ()),
                              (poison(randn(11, 5001)), ()), (poison(randn(256, 4099)), ()),
                              (poison(randn(33, 1025)), ())],
        "coordinate_averaged_median": [(main, (6,)), (bulyan_sel, (1,)), (poison(randn(8, 100003)), (6,)),
                                       (poison(randn(5, 5001)), (1,)),
                                       (poison(randn(256, 4099)), (200,)),
                                       (poison(randn(64, 1025)), (1,))],
        "coordinate_trimmed_mean": [(main, (2, 4)), (poison(randn(8, 100003)), (2, 4)),
                                    (poison(randn(11, 5001)), (2, 7)),
                                    (poison(randn(256, 4099)), (60, 136)),
                                    (poison(randn(17, 1025)), (0, 17))],
        # the raw rows and their centre, which K2 subtracts as it loads
        "pairwise_sq_distances_gram": [(raw128, (kernels.nanmedian_columns(raw128),)), gram_poison(65, 20011),
                                       gram_poison(72, 129), gram_poison(130, 5001), gram_poison(300, 1000),
                                       gram_poison(128, 4098, centre=False), gram_poison(129, 4099, centre=False)]
                                      + [gram_poison(n, d) for n in (65, 127, 128, 129, 256)
                                         for d in (4096, 4097, 4098, 4099)],
        "average_nan_columns": [(udp, ()), (poison(randn(8, 100003)), ()), (poison(randn(11, 5001)), ()),
                                (poison(randn(256, 4099)), ()), (all_nan, ())],
        "nanmedian_columns": [(raw128, ()), (rank_poison(7, 3001), ())]
                             + [(rank_poison(n, d), ()) for n, d in beyond],
    }
    # an even width on a start that is only 4-byte aligned: K2's 4-byte
    # copies, K1's 4-byte loads (8 and 17 rows) and copies (21 rows)
    def unaligned_rows(n, d):
        return randn(1, 1 + n * d)[0, 1:].view(n, d)

    unaligned = unaligned_rows(130, 4098)
    cases["pairwise_sq_distances_gram"].append((unaligned, (kernels.nanmedian_columns(unaligned),)))
    cases["pairwise_sq_distances"] += [(poison(unaligned_rows(n, 4098), False), ()) for n in (8, 17, 21)]
    for n, d in beyond:
        cases["coordinate_median"].append((rank_poison(n, d), ()))
        cases["coordinate_averaged_median"] += [(rank_poison(n, d), (n - n // 8,)), (rank_poison(n, d), (1,))]
        cases["coordinate_trimmed_mean"].append((rank_poison(n, d), (n // 16, n - 2 * (n // 16))))
    # the sort path at the main path's shapes beyond 64 rows (Bulyan's, the
    # median's and the trimmed mean's at n = 128, f = 8)
    sort_main = {"coordinate_median": (raw128, ()), "coordinate_averaged_median": (bulyan128, (94,)),
                 "coordinate_trimmed_mean": (raw128, (8, 112))}
    library = {
        # one PyTorch call computing the same function on these main inputs
        # (finite, or NaN-only for K6); the port never calls them
        "pairwise_sq_distances": lambda x: torch.cdist(x, x).square(),
        "pairwise_sq_distances_gram": lambda x: torch.cdist(x, x).square(),
        "coordinate_median": lambda x: torch.kthvalue(x, x.shape[0] // 2 + 1, dim=0).values,
        "average_nan_columns": lambda x: torch.nanmean(x, 0),
        # no one call for the centring: torch.nanmedian keeps the lower of an
        # even count's middle pair, and torch.nanquantile refuses inputs of
        # more than 2^24 values
    }

    def report(name, label, row, held):
        print("kernel %-27s %s (%d, %d): %.4f ms (on the card %s ms), plain %.3f ms, library %s ms, "
              "bound %.1f us (%s; operations %.1f us), max |err| %g, %d inputs held"
              % (name, label, row["shape"][0], row["shape"][1], row["ms"],
                 "not measured" if row["device_ms"] is None else "%.4f" % row["device_ms"], row["plain_ms"],
                 "%.3f" % row["library_ms"] if row["library_ms"] is not None else "-",
                 row["bound_ms"] * 1e3, row["bound_by"], row["operations_ms"] * 1e3, row["max_abs_err"], held))

    rows = []
    for name, inputs in cases.items():
        kernel, plain = getattr(kernels, name), kernels.PLAIN[name]
        errors = []
        for x, args in inputs + ([sort_main[name]] if name in sort_main else []):
            got = kernel(x, *args)
            torch.cuda.synchronize()
            errors.append(compare(name, got, plain(x, *args), torch, x, args))
        x, args = inputs[0]
        info = kernels.KERNELS[name]
        row = {"name": name, "route": "cuda", "source": info.source, "replaces": info.replaces, "launches": 0}
        row.update(timed_row(torch, kernels, name, x, args, library.get(name), errors[0]))
        row["max_abs_err_all_inputs"] = max(errors)
        report(name, info.label, row, len(errors))
        if name == "pairwise_sq_distances_gram":
            # the whole distance path on the raw rows: the centring, then K2
            row["distance_path_ms"] = time_ms(lambda: kernels.pairwise_sq_distances(x), torch, iters=20, warmup=5)
            print("distances pairwise_sq_distances raw (%d, %d): %.4f ms (centring + K2), torch.cdist %.3f ms"
                  % (x.shape[0], x.shape[1], row["distance_path_ms"], row["library_ms"]))
        if name == "pairwise_sq_distances":
            # K1 at the other widths it serves: Bulyan's 11 rows (registers),
            # 64, the most rows (staged tiles), and the digits legs' (8, d)
            others = [(bulyan_rows, errors[1]), (k1_wide, errors[2])]
            others += [(x, err) for (x, _), err in zip(inputs, errors) if x is digits_rows or x is digits_conv_rows]
            row["other_shapes"] = [timed_row(torch, kernels, name, other, (), library[name], err)
                                   for other, err in others]
            for other in row["other_shapes"]:
                report(name, info.label, other, 1)
        if name in sort_main:
            # the sort path beyond 64 rows, at its main-path shape
            x, args = sort_main[name]
            row["sort_path"] = timed_row(torch, kernels, name, x, args,
                                         library.get(name) if name == "coordinate_median" else None, errors[-1])
            report(name, info.label + " sort path", row["sort_path"], 1)
        rows.append(row)
    extension_kernel_shapes(torch, kernels, randn, rank_poison, report, rows, library)
    block_kernel_shapes(torch, kernels, randn, report, rows, library)
    # the distances switch form past 64 rows: K1 at n = 64, the centring and K2 at n = 65
    for n, want in ((64, {"pairwise_sq_distances"}), (65, {"pairwise_sq_distances_gram", "nanmedian_columns"})):
        before = kernels.launch_counts()
        kernels.pairwise_sq_distances(randn(n, 4099))
        torch.cuda.synchronize()
        after = kernels.launch_counts()
        launched = {k: after[k] - before[k] for k in after}
        check(launched == {k: int(k in want) for k in after},
              "distances at n=%d launched %s (want %s once each)" % (n, launched, sorted(want)))
    del main, bulyan_rows, k1_wide, bulyan_sel, raw128, bulyan128, udp, unaligned, cases, sort_main
    del digits_rows, digits_conv_rows
    torch.cuda.empty_cache()
    return rows


#: K2's row counts on the GAR extensions' path (bucket means, group summaries,
#: a tree's root), the centring's (an iterative rule's start at n = 8, the
#: smallest groups), and the transposed layouts (g, (n/g) d) K3 runs: the
#: hier leg (n = 32, g = 4), the tree leg's second level (8 summaries in
#: groups of 2) and first level (n = 64, g = 4), and hier at n = 64, g = 8
#: (no leg's; 8 rows of the widest layout, 28,106,912 values a column pass)
EXTENSION_GRAM_ROWS = (2, 4, 8, 16, 32)
EXTENSION_CENTRING_ROWS = (2, 3, 4, 8)
EXTENSION_TRANSPOSED = ((4, 8 * CNNET_D), (2, 8 * CNNET_D), (4, 16 * CNNET_D), (8, 8 * CNNET_D))


def held_shape(torch, kernels, report, by_name, library, name, x, args, label):
    """Hold kernel ``name`` against its plain version on ``x`` and time it
    there: a row of its kernel row's ``other_shapes``.  Returns (kernel's,
    plain version's)."""
    got = getattr(kernels, name)(x, *args)
    torch.cuda.synchronize()
    want = kernels.PLAIN[name](x, *args)
    err = compare(name, got, want, torch, x, args)
    row = timed_row(torch, kernels, name, x, args, library.get(name), err)
    row["label"] = label
    report(name, label, row, 1)
    by_name[name].setdefault("other_shapes", []).append(row)
    return got, want


#: the worker axis's column blocks at W = 2 (``parallel/mesh.py``): each rank
#: holds ceil(d/2) of cnnet's coordinates; K1 on the 8 workers' block, the
#: centring and K2 on 128 workers', K3, K5 (trim 2, keep 4) and K6 on 8
#: workers' (the bounded ranks' median and average-nan, the fused median)
BLOCK_D = -(-CNNET_D // 2)
BLOCK_SHAPES = (("pairwise_sq_distances", 8), ("nanmedian_columns", 128), ("pairwise_sq_distances_gram", 128),
                ("coordinate_median", 8), ("coordinate_trimmed_mean", 8), ("average_nan_columns", 8))
BLOCK_ARGS = {"coordinate_trimmed_mean": (2, 4)}


def block_kernel_shapes(torch, kernels, randn, report, rows, library):
    """Hold K1, the centring, K2, K3, K5 and K6 against their plain versions
    at the worker axis's block shapes (n, 878,341), clean (timed) and with
    a NaN row and +-inf values, and time them there."""
    by_name = {row["name"]: row for row in rows}
    for name, n in BLOCK_SHAPES:
        x = randn(n, BLOCK_D)
        args = (kernels.nanmedian_columns(x),) if name == "pairwise_sq_distances_gram" else BLOCK_ARGS.get(name, ())
        held_shape(torch, kernels, report, by_name, library, name, x, args, "block W=2")
        x[1] = float("nan")
        x[0, 5::11] = float("inf")
        x[n - 1, 3::13] = -float("inf")
        args = (kernels.nanmedian_columns(x),) if name == "pairwise_sq_distances_gram" else BLOCK_ARGS.get(name, ())
        compare(name, getattr(kernels, name)(x, *args), kernels.PLAIN[name](x, *args), torch, x, args)
        del x, args
    torch.cuda.empty_cache()


def extension_kernel_shapes(torch, kernels, randn, rank_poison, report, rows, library):
    """Hold K2, the centring and K3 against their plain versions at the GAR
    extensions' shapes, and time them there (each kernel row's
    ``other_shapes``).  K2 at 2-32 rows of cnnet's width (a NaN row and
    +inf values from 4 rows on), with Krum's selection identical on the two
    results (f = 1 from 4 rows); the centring at 2-8 rows (poisoned, and
    clean for the time), bit for bit; K3 on the transposed layouts (a NaN
    row, +-inf values), bit for bit."""
    from aggregathor_tpu_torch import gars

    by_name = {row["name"]: row for row in rows}

    def held(name, x, args, label):
        return held_shape(torch, kernels, report, by_name, library, name, x, args, label)

    for n in EXTENSION_GRAM_ROWS:
        x = randn(n, CNNET_D)
        if n >= 4:
            x[1] = float("nan")
            x[n - 1, 3::1000] = float("inf")
        got, want = held("pairwise_sq_distances_gram", x, (kernels.nanmedian_columns(x),), "K2 extension")
        if n >= 4:
            krum = gars.instantiate("krum", n, 1)
            check(torch.equal(krum.selection_weights(got), krum.selection_weights(want)),
                  "K2 at n=%d: Krum's selection differs from the plain version's" % n)
        del x, got, want
    for n in EXTENSION_CENTRING_ROWS:
        poisoned = rank_poison(n, CNNET_D)
        compare("nanmedian_columns", kernels.nanmedian_columns(poisoned), kernels.nanmedian_columns_plain(poisoned),
                torch)
        held("nanmedian_columns", randn(n, CNNET_D), (), "centring extension")
        del poisoned
    for n, d in EXTENSION_TRANSPOSED:
        x = randn(n, d)
        x[n // 2, ::7] = float("nan")
        x[0, 5::11] = float("inf")
        x[n - 1, 3::13] = -float("inf")
        held("coordinate_median", x, (), "K3 transposed")
        del x
    torch.cuda.empty_cache()


#: a leg's launches a step: ``--granularity leaf`` runs bucketed on the card
#: ("auto"), one batched launch for each distinct leaf size and none unbatched
PER_BUCKET = "per bucket"
#: the suspicion flags of JAX ``test_engine.py``'s quarantine test
SUSPICION = ["--worker-metrics", "--reputation-decay", "0.5", "--quarantine-threshold", "0.4", "--summary-delta", "10"]

LEGS = [
    # (label, runner arguments, the kernels each step must launch once)
    ("cnnet+krum", ["--aggregator", "krum", "--nb-workers", "8", "--nb-decl-byz-workers", "2",
                    "--nb-real-byz-workers", "2", "--attack", "signflip", "--max-step", "15",
                    "--evaluation-delta", "15"], ("pairwise_sq_distances",)),
    # augmentation in the step and the batches drawn on the card (the train
    # split held there); the same rule, attack and size as cnnet+krum
    ("cnnet-device+krum", ["--experiment-args", "augment:device", "--input-source", "device",
                           "--aggregator", "krum", "--nb-workers", "8", "--nb-decl-byz-workers", "2",
                           "--nb-real-byz-workers", "2", "--attack", "signflip", "--max-step", "15",
                           "--evaluation-delta", "15"], ("pairwise_sq_distances",)),
    ("cnnet+bulyan", ["--aggregator", "bulyan", "--nb-workers", "11", "--nb-decl-byz-workers", "2",
                      "--nb-real-byz-workers", "2", "--attack", "signflip", "--max-step", "5"],
     ("pairwise_sq_distances", "coordinate_averaged_median")),
    ("cnnet+median", ["--aggregator", "median", "--nb-workers", "8", "--nb-decl-byz-workers", "2",
                      "--nb-real-byz-workers", "2", "--attack", "signflip", "--max-step", "5"],
     ("coordinate_median",)),
    ("cnnet+trimmed-mean", ["--aggregator", "trimmed-mean", "--nb-workers", "8", "--nb-decl-byz-workers", "2",
                            "--nb-real-byz-workers", "2", "--attack", "signflip", "--max-step", "5"],
     ("coordinate_trimmed_mean",)),
    ("cnnet+averaged-median", ["--aggregator", "averaged-median", "--nb-workers", "8",
                               "--nb-decl-byz-workers", "2", "--nb-real-byz-workers", "2",
                               "--attack", "signflip", "--max-step", "5"],
     ("coordinate_averaged_median",)),
    ("cnnet+krum-n128", ["--aggregator", "krum", "--nb-workers", "128", "--nb-decl-byz-workers", "8",
                         "--nb-real-byz-workers", "8", "--attack", "signflip", "--max-step", "5"],
     ("pairwise_sq_distances_gram", "nanmedian_columns")),
    ("cnnet+bulyan-n128", ["--aggregator", "bulyan", "--nb-workers", "128", "--nb-decl-byz-workers", "8",
                           "--nb-real-byz-workers", "8", "--attack", "signflip", "--max-step", "3"],
     ("pairwise_sq_distances_gram", "nanmedian_columns", "coordinate_averaged_median")),
    ("cnnet+average-nan+UDP", ["--aggregator", "average-nan", "--nb-workers", "8", "--UDP", "4",
                               "--max-step", "5"], ("average_nan_columns",)),
    ("cnnet+krum+UDP", ["--aggregator", "krum", "--nb-workers", "8", "--nb-decl-byz-workers", "2",
                        "--UDP", "2", "--max-step", "5"], ("pairwise_sq_distances",)),
    ("cnnet+average+UDP-clever", ["--aggregator", "average", "--nb-workers", "8", "--UDP", "4",
                                  "--UDP-args", "clever:true", "--max-step", "5"], ()),
    # the engine's robustness options (a dict: launches a step, PER_BUCKET
    # batched once for each leaf size of the FlatMap, 9 for cnnet's 14 leaves)
    ("cnnet+krum-leaf", ["--aggregator", "krum", "--nb-workers", "8", "--nb-decl-byz-workers", "2",
                         "--nb-real-byz-workers", "2", "--attack", "signflip", "--granularity", "leaf",
                         "--max-step", "5"], {"pairwise_sq_distances": PER_BUCKET}),
    ("cnnet+krum-leaf-n128", ["--aggregator", "krum", "--nb-workers", "128", "--nb-decl-byz-workers", "8",
                              "--nb-real-byz-workers", "8", "--attack", "signflip", "--granularity", "leaf",
                              "--max-step", "3"],
     {"pairwise_sq_distances_gram": PER_BUCKET, "nanmedian_columns": PER_BUCKET}),
    ("cnnet+krum+suspicion", ["--aggregator", "krum", "--nb-workers", "8", "--nb-decl-byz-workers", "2",
                              "--nb-real-byz-workers", "2", "--attack", "gaussian", "--attack-args", "deviation:100",
                              *SUSPICION, "--flight", "64", "--max-step", "30"], ("pairwise_sq_distances",)),
    ("cnnet+average-nan+quarantine", ["--aggregator", "average-nan", "--nb-workers", "8", "--nb-decl-byz-workers",
                                      "2", "--nb-real-byz-workers", "2", "--attack", "gaussian", "--attack-args",
                                      "deviation:100", *SUSPICION, "--max-step", "10"], ("average_nan_columns",)),
    ("cnnet+krum+momentum-bf16", ["--aggregator", "krum", "--nb-workers", "8", "--nb-decl-byz-workers", "2",
                                  "--nb-real-byz-workers", "2", "--attack", "signflip", "--worker-momentum", "0.9",
                                  "--exchange-dtype", "bfloat16", "--max-step", "15"], ("pairwise_sq_distances",)),
    ("cnnet-bf16+krum", ["--experiment-args", "dtype:bfloat16", "--aggregator", "krum", "--nb-workers", "8",
                         "--nb-decl-byz-workers", "2", "--nb-real-byz-workers", "2", "--attack", "signflip",
                         "--max-step", "15"], ("pairwise_sq_distances",)),
    ("cnnet+krum+trace-ops", ["--aggregator", "krum", "--nb-workers", "8", "--nb-decl-byz-workers", "2",
                              "--trace-ops", "--max-step", "2"], ("pairwise_sq_distances",)),
    # the momentum buffer at n = 128 (0.9 GB) beside the 128 workers' activations
    ("cnnet+krum-n128+momentum", ["--aggregator", "krum", "--nb-workers", "128", "--nb-decl-byz-workers", "8",
                                  "--nb-real-byz-workers", "8", "--attack", "signflip", "--worker-momentum", "0.9",
                                  "--max-step", "3"], ("pairwise_sq_distances_gram", "nanmedian_columns")),
]


def check_suspicion(label, result, summary):
    """The last summary of a quarantine leg: the two gaussian attackers
    never selected (krum), trusted no more and quarantined, the others
    trusted (JAX ``test_engine.py`` ``test_reputation_quarantine_excludes_attacker``)."""
    reputation = summary["worker_reputation"]
    check(summary.get("nb_quarantined") == 2, "%s: nb_quarantined %s, want 2" % (label, summary.get("nb_quarantined")))
    check(max(reputation[:2]) < 0.1 and min(reputation[2:]) > 0.9, "%s: reputation %s" % (label, reputation))
    if "worker_participation" in summary:
        check(summary["worker_participation"][:2] == [0.0, 0.0],
              "%s: participation %s" % (label, summary["worker_participation"]))
    if "flight_rows" in summary:
        check(summary["flight_rows"] == result["steps"], "%s: %s flight rows" % (label, summary["flight_rows"]))
    return "reputation %s, participation %s, %d quarantined, %s flight rows" % (
        json.dumps([round(v, 4) for v in reputation]), json.dumps(summary.get("worker_participation")),
        summary["nb_quarantined"], summary.get("flight_rows", "-"))


def check_trace(label, result, output):
    lines = [line for line in output.splitlines() if line.startswith("TRACE step ")]
    check(len(lines) == 3 * result["steps"], "%s: %d TRACE lines in %d steps" % (label, len(lines), result["steps"]))
    return "%d TRACE lines, e.g. %r" % (len(lines), lines[-1])


#: per-leg checks beyond the launches and a finite loss
LEG_CHECKS = {
    "cnnet+krum+suspicion": check_suspicion,
    "cnnet+average-nan+quarantine": check_suspicion,
    "cnnet+krum+trace-ops": check_trace,
}


def main_path_phase(torch, kernels, runner, card, workdir, models):
    """Drive each leg through the runner; returns {kernel: launches} summed
    over the legs, the batched forms' under ``batched(name)``.

    Each leg writes its summaries under ``workdir``; a leg of ``LEG_CHECKS``
    is held to its check on its last summary (or, for --trace-ops, on what
    it printed)."""
    import contextlib
    import io

    from aggregathor_tpu_torch.core import FlatMap

    slices = FlatMap(models.instantiate("cnnet", []).init(0)).slices
    sizes = {size for _, _, _, size, _, _ in slices}
    print("cnnet's %d parameter leaves in %d sizes (granularity:leaf's batched launches a step), widths: %s"
          % (len(slices), len(sizes), ", ".join("%s %d" % (name, size) for name, _, _, size, _, _ in slices)))
    totals = zero_counts(kernels)
    steps_per_s = {}
    for label, argv, expected in LEGS:
        per_step = expected if isinstance(expected, dict) else dict.fromkeys(expected, 1)
        summary_dir = os.path.join(workdir, "summaries", label)
        kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        output = io.StringIO()
        # no wall-period evaluation inside the timed window (steps/s stays
        # comparable with earlier runs); the krum leg's step delta still fires
        with contextlib.redirect_stdout(output):
            result = runner.main(["--experiment", "cnnet", "--seed", "1", "--evaluation-period", "-1",
                                  "--summary-dir", summary_dir, *argv])
        sys.stdout.write(output.getvalue())
        counts, batched_counts = kernels.launch_counts(), kernels.batched_launch_counts()
        peak_mb = torch.cuda.max_memory_allocated() / 2**20
        steps = result["steps"]
        check(result["final_loss"] is not None and math.isfinite(result["final_loss"]), "%s: non-finite loss" % label)
        for name in kernels.KERNELS:
            launches = per_step.get(name, 0)
            want, want_batched = (0, steps * len(sizes)) if launches == PER_BUCKET else (steps * launches, 0)
            check(counts[name] == want and batched_counts[name] == want_batched,
                  "%s: %s launched %d times and %d batched in %d steps (want %d and %d)"
                  % (label, name, counts[name], batched_counts[name], steps, want, want_batched))
            totals[name] += counts[name]
            totals[batched(name)] += batched_counts[name]
        if any(batched_counts.values()):
            counts = dict(counts, **{batched(name): count for name, count in batched_counts.items() if count})
        extra = ""
        if label in LEG_CHECKS:
            [name] = os.listdir(summary_dir)
            summary = json.loads(open(os.path.join(summary_dir, name)).read().splitlines()[-1])
            extra = "; " + LEG_CHECKS[label](label, result, output.getvalue() if "trace" in label else summary)
        steps_per_s[label] = result["steps_per_s"]
        print("leg %-22s %d steps, %.3f steps/s excl. 1st on %s, final loss %.4f, accuracy %s, peak %.0f MB, "
              "launches %s%s" % (label, steps, result["steps_per_s"], card, result["final_loss"],
                                 "%.4f" % result["evaluation"]["accuracy"] if result["evaluation"] else "-",
                                 peak_mb, json.dumps(counts, sort_keys=True), extra))
    print("steps/s excl. 1st against cnnet+krum (%.3f) on %s: %s" % (
        steps_per_s["cnnet+krum"], card, ", ".join("%s %.3f (x%.2f)" % (label, value, value / steps_per_s["cnnet+krum"])
                                                    for label, value in steps_per_s.items() if label != "cnnet+krum")))
    return totals


def perf_line(result):
    """The runner's performance report, on one line."""
    p = result["perf"]
    tail = p["latency"] or {}
    return ("in-graph %.3f s, off-graph %.3f s of %.3f s, first step %.3f s, step latency p50/p95/p99 %s ms"
            % (p["in_graph_s"], p["off_graph_s"], p["total_s"], p["first_step_s"],
               " / ".join("%.2f" % (tail[k] * 1e3) for k in ("p50", "p95", "p99")) if tail else "-"))


def corpus_phase():
    """Point the loaders at the port's copy of the digits corpus (the card's
    machine has no scikit-learn) and check that the corpus is real."""
    from aggregathor_tpu_torch.models import datasets

    os.environ["AGGREGATHOR_DATA"] = datasets.DIGITS_DIR
    data = datasets.load_digits8x8()
    print("digits corpus: %s (%s, %d train / %d test images)"
          % ("synthetic" if data.synthetic else "real", datasets._find_npz("digits.npz") or "scikit-learn",
             len(data.y_train), len(data.y_test)))
    check(not data.synthetic, "the digits corpus is the synthetic stand-in: the digits legs need the real one")


DIGITS_LEGS = [
    # (label, runner arguments, the least final test accuracy): the
    # real-data anchors of docs/robustness.md, Multi-Krum n=8, f=2, no
    # attacker; the JAX package reached 0.961 and 0.975 there
    ("digits+krum", ["--experiment", "digits", "--aggregator", "krum", "--nb-workers", "8",
                     "--nb-decl-byz-workers", "2", "--max-step", "4000", "--learning-rate-args", "initial-rate:0.1"],
     0.95),
    ("digits-conv+krum", ["--experiment", "digits-conv", "--experiment-args", "batch-size:16", "--aggregator", "krum",
                          "--nb-workers", "8", "--nb-decl-byz-workers", "2", "--max-step", "400",
                          "--learning-rate-args", "initial-rate:0.05", "--evaluation-delta", "100",
                          "--evaluation-period", "-1"], 0.96),
    # the same digits anchor with its batches drawn on the card, 10 steps a
    # call; the floor from the port's CPU runs of this path over seeds 0-3
    ("digits+krum device", ["--experiment", "digits", "--aggregator", "krum", "--nb-workers", "8",
                            "--nb-decl-byz-workers", "2", "--max-step", "4000", "--learning-rate-args",
                            "initial-rate:0.1", "--input-source", "device", "--unroll", "10"], DIGITS_DEVICE_FLOOR),
]


def digits_phase(torch, kernels, runner, card):
    """The real-data anchors; returns {kernel: launches} summed over them.
    K1 must launch once a step and no other kernel at all.

    cuDNN is pinned to its deterministic algorithms here, so each anchor is
    one reproducible run: under the default ones, eight digits-conv runs on
    the card ended at 0.9639-0.9833, each run's own draw of the
    convolutions' summation order (the MLP has no convolution and repeats
    bit for bit either way)."""
    totals = {name: 0 for name in kernels.KERNELS}
    torch.backends.cudnn.deterministic = True
    for label, argv, floor in DIGITS_LEGS:
        kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        result = runner.main(argv)
        counts = kernels.launch_counts()
        steps, accuracy = result["steps"], result["evaluation"]["accuracy"]
        check(math.isfinite(result["final_loss"]), "%s: non-finite loss" % label)
        for name in kernels.KERNELS:
            want = steps if name == "pairwise_sq_distances" else 0
            check(counts[name] == want, "%s: %s launched %d times in %d steps (want %d)"
                  % (label, name, counts[name], steps, want))
            totals[name] += counts[name]
        print("leg %-22s %d steps, %.3f steps/s excl. 1st on %s, final loss %.4f, real test accuracy %.4f "
              "(floor %.2f), cross-entropy %.4f, peak %.0f MB, %s, launches %s"
              % (label, steps, result["steps_per_s"], card, result["final_loss"], accuracy, floor,
                 result["evaluation"]["cross-entropy"], torch.cuda.max_memory_allocated() / 2**20,
                 perf_line(result), json.dumps(counts, sort_keys=True)))
        check(accuracy >= floor, "%s: real test accuracy %.4f below %.2f" % (label, accuracy, floor))
    torch.backends.cudnn.deterministic = False
    return totals


class Child:
    """A child process of this script started beside card work: ``python3
    chip_smoke.py <mode> <out.json> [args]``, its output kept in a log and
    printed when it is joined, its result the JSON it wrote; killed if the
    parent ends first (``stop``)."""

    def __init__(self, label, mode, workdir, *args):
        self.label = label
        self.out = os.path.join(workdir, "%s.json" % mode.strip("-"))
        self.log_path = os.path.join(workdir, "%s.log" % mode.strip("-"))
        self.begin = time.perf_counter()
        self.result = None
        with open(self.log_path, "w") as log:
            self.proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), mode, self.out, *map(str, args)],
                                         cwd=os.path.dirname(os.path.abspath(__file__)), stdout=log,
                                         stderr=subprocess.STDOUT)

    def join(self, timeout=900):
        """The child's result; its log printed and its exit code checked the
        first time, with its seconds and how long the join waited."""
        if self.result is None:
            waited = time.perf_counter()
            try:
                code = self.proc.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                self.stop()
                fail("%s: the child did not end within %d s" % (self.label, timeout))
            waited = time.perf_counter() - waited
            with open(self.log_path) as log:
                sys.stdout.write(log.read())
            check(code == 0, "%s: the child exited %d (its log above)" % (self.label, code))
            with open(self.out) as fd:
                self.result = json.load(fd)
            print("phase %s: %.1f s in a child process, joined after waiting %.1f s"
                  % (self.label, time.perf_counter() - self.begin, waited))
        return self.result

    def stop(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def digits_child(out):
    """``chip_smoke.py --digits-anchors out.json``: the digits anchors
    (``digits_phase``) in a process of their own, beside the zoo's card
    legs; writes their {kernel: launches}."""
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs the port on a GPU")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from aggregathor_tpu_torch.cli import runner
    from aggregathor_tpu_torch.ops import kernels

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    corpus_phase()
    totals = digits_phase(torch, kernels, runner, card_line())
    with open(out, "w") as fd:
        json.dump(totals, fd)


def attack_phase(runner, workdir):
    """digitsAttack and mnistAttack: the poisoned stream trains and
    evaluates on the card.  Severity 2 (inputs x -1e12, labels permuted) is
    expected to end in the loud divergence error within a few steps under
    plain averaging, as on the JAX package (docs/robustness.md); severity 1
    trains on."""
    from aggregathor_tpu_torch.utils import UserException

    for experiment, severity, steps in (("digitsAttack", 2, 20), ("digitsAttack", 1, 100), ("mnistAttack", 1, 20)):
        tsv = os.path.join(workdir, "%s-%d.tsv" % (experiment, severity))
        argv = ["--experiment", experiment, "--experiment-args", "severity:%d" % severity, "--aggregator",
                "average", "--nb-workers", "8", "--nb-decl-byz-workers", "2", "--max-step", str(steps),
                "--learning-rate-args", "initial-rate:0.05", "--evaluation-delta", "10", "--evaluation-period", "-1",
                "--evaluation-file", tsv]
        try:
            result = runner.main(argv)
            outcome = "%d steps, final loss %g" % (result["steps"], result["final_loss"])
            check(math.isfinite(result["final_loss"]), "%s severity %d: non-finite loss" % (experiment, severity))
        except UserException as exc:
            check("diverged" in str(exc), "%s severity %d: %s" % (experiment, severity, exc))
            outcome = "stopped: %s" % exc
        rows = [line.split("\t") for line in open(tsv).read().splitlines()]
        check(rows and rows[0][1] == "1", "%s severity %d: no evaluation at step 1" % (experiment, severity))
        accuracy = [float(field.split(":")[1]) for row in rows for field in row[2:] if field.startswith("accuracy:")]
        check(all(0.0 <= a <= 1.0 for a in accuracy), "%s severity %d: accuracy out of range" % (experiment, severity))
        print("%s severity %d: %s; clean test accuracy by step %s"
              % (experiment, severity, outcome, ", ".join("%s: %.4f" % (row[1], a) for row, a in zip(rows, accuracy))))


#: the pipeline phase's legs (cnnet + krum n=8, f=2, 10 steps a call): the
#: flags after the shared ones and the gather threads; the first is the
#: synchronous reference whose losses every other leg must repeat bit for bit
PIPELINE_STEPS = 20
PIPELINE_LEGS = [
    ("sync", ["--prefetch", "0"], "4"),
    ("pipeline S=4", ["--prefetch", "2", "--input-slices", "4"], "4"),
    ("pipeline S=1", ["--prefetch", "2", "--input-slices", "1"], "4"),
    ("pipeline S=4, 1 gather thread", ["--prefetch", "2", "--input-slices", "4"], "1"),
]
INPUT_FAMILIES = ("input_gather_seconds_total", "input_put_seconds_total", "input_wait_seconds_total",
                  "input_chunks_total")


def _recorded_run(runner, argv):
    """runner.main(argv) with every call's per-step losses kept on the card
    (read after the run, so recording adds no synchronisation)."""
    from aggregathor_tpu_torch.parallel import RobustEngine

    losses = []
    build = RobustEngine.build_multi_step

    def recording(self, *args, **kwargs):
        multi = build(self, *args, **kwargs)

        def call(state, batches):
            state, many = multi(state, batches)
            losses.append(many["total_loss"])
            return state, many

        return call

    RobustEngine.build_multi_step = recording
    try:
        result = runner.main(argv)
    finally:
        RobustEngine.build_multi_step = build
    return result, [float(v) for chunk in losses for v in chunk.cpu()]


def _input_deltas(before, after):
    """The input_* counters' growth over one leg (the registry is
    process-wide and cumulative) and the leg's overlap, 1 - wait/busy."""
    delta = {name: after.get(name, 0.0) - before.get(name, 0.0) for name in INPUT_FAMILIES}
    busy = delta["input_gather_seconds_total"] + delta["input_put_seconds_total"]
    delta["overlap"] = max(0.0, min(1.0, 1.0 - delta["input_wait_seconds_total"] / busy)) if busy > 0 else None
    return delta


def pipeline_phase(torch, kernels, runner, card):
    """The chunk input pipeline on the card; returns {kernel: launches}.

    cnnet with its augmentation in the step (``augment:device``, so the host
    tier is the gather alone: 10 x 8 x 128 = 10,240 rows a chunk, over the
    pool's 4,096) + krum, n=8, f=2, r=2 signflip, ``--unroll 10``,
    ``PIPELINE_STEPS`` steps streamed, cuDNN deterministic: synchronous, and
    the pipeline at 4 and 1 slices and at 1 gather thread.  Every leg's losses must be the synchronous leg's bits (a
    ping-pong buffer refilled under a transfer would change them), K1 must
    launch once a step, and each leg prints its steps/s without the first
    chunk, its ``input_*`` deltas, overlap and the registry's
    ``input_overlap_fraction``.  Then cnnet with its host augmentation
    (stateful: the sequential gather, only the producer thread overlaps)
    and ``digits`` at ``--unroll 16`` (16 x 8 x 32 = 4,096 rows: the pool)
    through the pipeline, each against its synchronous twin bit for bit."""
    from aggregathor_tpu_torch.models import datasets
    from aggregathor_tpu_torch.obs import metrics as obs_metrics

    totals = {name: 0 for name in kernels.KERNELS}
    torch.backends.cudnn.deterministic = True
    gather_env = os.environ.get("AGGREGATHOR_GATHER_THREADS")
    base = ["--experiment", "cnnet", "--experiment-args", "augment:device", "--aggregator", "krum",
            "--nb-workers", "8", "--nb-decl-byz-workers", "2", "--nb-real-byz-workers", "2", "--attack", "signflip",
            "--unroll", "10", "--max-step", str(PIPELINE_STEPS), "--seed", "1", "--evaluation-delta", "-1",
            "--evaluation-period", "-1", "--summary-period", "-1"]
    out = {}

    def leg(label, argv, threads, want=None):
        os.environ["AGGREGATHOR_GATHER_THREADS"] = threads
        datasets._gather_pool = None  # the pool takes its size at creation
        kernels.reset_launch_counts()
        before = obs_metrics.REGISTRY.snapshot()
        result, losses = _recorded_run(runner, argv)
        after = obs_metrics.REGISTRY.snapshot()
        counts = kernels.launch_counts()
        steps, p, unroll = result["steps"], result["perf"], int(argv[argv.index("--unroll") + 1])
        check(len(losses) == steps and all(math.isfinite(v) for v in losses), "%s: losses %s" % (label, losses))
        for name in kernels.KERNELS:
            want_launches = steps if name == "pairwise_sq_distances" else 0
            check(counts[name] == want_launches, "%s: %s launched %d times in %d steps (want %d)"
                  % (label, name, counts[name], steps, want_launches))
            totals[name] += counts[name]
        if want is not None:
            check(losses == want, "%s: per-step losses differ from the synchronous run's: %s vs %s"
                  % (label, losses, want))
        pipelined = "--prefetch" in argv and argv[argv.index("--prefetch") + 1] != "0"
        expected = "ChunkPipeline" if pipelined else None
        check(result["input_pipeline"] == expected, "%s: fed by %s, want %s" % (label, result["input_pipeline"],
                                                                                 expected))
        delta = _input_deltas(before, after)
        rate = (steps - unroll) / (p["total_s"] - p["first_step_s"])
        print("pipeline leg %-30s %d steps, %.3f steps/s without the first call (%.3f excl. 1st step) on %s, fed "
              "by %s (%s gather thread(s)); input deltas %s; wait %s s; registry input_overlap_fraction %s; "
              "losses %s"
              % (label, steps, rate, result["steps_per_s"], card, result["input_pipeline"], threads,
                 json.dumps({k: v for k, v in delta.items()}), result["input_wait_s"],
                 after.get("input_overlap_fraction"), "bit-identical to sync" if want is not None else
                 "(the reference)"))
        out[label] = {"steps_per_s": rate, "input": delta}
        return losses

    try:
        (label, extra, threads), others = PIPELINE_LEGS[0], PIPELINE_LEGS[1:]
        reference = leg(label, base + extra, threads)
        for label, extra, threads in others:
            leg(label, base + extra, threads, want=reference)
        host = ["--experiment", "cnnet", "--aggregator", "krum", "--nb-workers", "8", "--nb-decl-byz-workers", "2",
                "--unroll", "10", "--max-step", "20", "--seed", "1", "--evaluation-delta", "-1",
                "--evaluation-period", "-1", "--summary-period", "-1"]
        want = leg("cnnet host augmentation sync", host + ["--prefetch", "0"], "4")
        leg("cnnet host augmentation pipeline", host + ["--prefetch", "2"], "4", want=want)
        digits = ["--experiment", "digits", "--aggregator", "krum", "--nb-workers", "8", "--nb-decl-byz-workers",
                  "2", "--unroll", "16", "--max-step", "96", "--learning-rate-args", "initial-rate:0.1",
                  "--evaluation-delta", "-1", "--evaluation-period", "-1", "--summary-period", "-1"]
        want = leg("digits sync", digits + ["--prefetch", "0"], "4")
        leg("digits pipeline (pool)", digits + ["--prefetch", "2", "--input-slices", "4"], "4", want=want)
    finally:
        torch.backends.cudnn.deterministic = False
        if gather_env is None:
            os.environ.pop("AGGREGATHOR_GATHER_THREADS", None)
        else:
            os.environ["AGGREGATHOR_GATHER_THREADS"] = gather_env
        datasets._gather_pool = None
    gather = {label: out[label]["input"]["input_gather_seconds_total"]
              for label in ("pipeline S=4", "pipeline S=4, 1 gather thread")}
    print("pipeline on %s: steps/s without the first call %s; gather seconds at 4 and 1 gather threads %s; "
          "against synchronous x%.3f (S=4) and x%.3f (S=1)"
          % (card, json.dumps({k: v["steps_per_s"] for k, v in out.items()}), json.dumps(gather),
             out["pipeline S=4"]["steps_per_s"] / out["sync"]["steps_per_s"],
             out["pipeline S=1"]["steps_per_s"] / out["sync"]["steps_per_s"]))
    return totals


def plane_phase(torch, kernels, runner, card, workdir, gar_ms):
    """The metrics plane on the card; returns {kernel: launches}.

    cnnet ``augment:device`` + median, n=8, f=2, through the chunk pipeline
    (``--unroll 10``), with ``--gar-probe``, ``--metrics-file``,
    ``--trace-file``, ``--run-id`` and the live exporter on an ephemeral port.
    The runner trains on a thread while this one reads the ready file and
    GETs ``/healthz``, ``/status`` and ``/metrics``.  Then: the metrics file
    parses with the port's parser and holds ``train_loss``,
    ``gar_probe_seconds`` > 0 and the ``input_*`` family; the span trace
    validates and holds ``host_gap``, ``input``, ``gar.aggregate``,
    ``input.gather`` and ``input.put``; the runner's probe calls are the
    warm-up and one a summary fire (the summary lines, each with its
    ``gar_seconds``), and K3 launched once a step and once a probe call.  ``gar_probe_seconds`` is printed beside the GAR phase's median
    n=8 time."""
    import threading
    import urllib.request

    from aggregathor_tpu_torch.obs import metrics as obs_metrics, trace

    paths = {name: os.path.join(workdir, "plane", name) for name in ("metrics.prom", "trace.json", "ready", "s")}
    os.makedirs(os.path.join(workdir, "plane"), exist_ok=True)
    argv = ["--experiment", "cnnet", "--experiment-args", "augment:device", "--aggregator", "median",
            "--nb-workers", "8", "--nb-decl-byz-workers", "2", "--nb-real-byz-workers", "2", "--attack", "signflip",
            "--unroll", "10", "--max-step", "60", "--seed", "1", "--summary-delta", "20", "--summary-period", "-1",
            "--evaluation-delta", "-1", "--evaluation-period", "-1", "--gar-probe", "--metrics-file",
            paths["metrics.prom"], "--trace-file", paths["trace.json"], "--run-id", "chip-plane", "--live-port", "0",
            "--live-ready-file", paths["ready"], "--summary-dir", paths["s"]]
    kernels.reset_launch_counts()
    outcome = {}

    def train():
        try:
            outcome["result"] = runner.main(argv)
        except BaseException as exc:  # surfaced below
            outcome["error"] = exc

    thread = threading.Thread(target=train, name="plane-runner")
    thread.start()
    scraped = {}
    deadline = time.monotonic() + 300
    while not os.path.exists(paths["ready"]) and thread.is_alive() and time.monotonic() < deadline:
        time.sleep(0.05)
    if os.path.exists(paths["ready"]):
        host, port = open(paths["ready"]).read().split()
        base = "http://%s:%s" % (host, port)
        scraped["/healthz"] = urllib.request.urlopen(base + "/healthz", timeout=30).read().decode()
        while True:  # /status once the first call has returned, while the rest trains
            scraped["/status"] = urllib.request.urlopen(base + "/status", timeout=30).read().decode()
            if json.loads(scraped["/status"])["step"] > 0 or not thread.is_alive() or time.monotonic() > deadline:
                break
            time.sleep(0.05)
        scraped["/metrics"] = urllib.request.urlopen(base + "/metrics", timeout=30).read().decode()
    thread.join(600)
    check(not thread.is_alive(), "plane: the runner did not finish")
    if "error" in outcome:
        raise outcome["error"]
    result = outcome["result"]
    counts = kernels.launch_counts()
    check(set(scraped) == {"/healthz", "/status", "/metrics"}, "plane: scraped %s" % sorted(scraped))
    check(json.loads(scraped["/healthz"]) == {"status": "ok", "run_id": "chip-plane"}, "plane: /healthz %s"
          % scraped["/healthz"])
    status = json.loads(scraped["/status"])
    check(status["run_id"] == "chip-plane" and status["max_step"] == 60, "plane: /status %s" % status)
    obs_metrics.parse_prometheus(scraped["/metrics"])
    families = obs_metrics.parse_prometheus(open(paths["metrics.prom"]).read())
    value = {name: family["samples"][0][2] for name, family in families.items() if family["samples"]}
    check("train_loss" in value and math.isfinite(value["train_loss"]), "plane: no finite train_loss")
    check(value.get("gar_probe_seconds", 0.0) > 0.0, "plane: gar_probe_seconds %s" % value.get("gar_probe_seconds"))
    missing = [name for name in INPUT_FAMILIES + ("input_queue_depth", "input_overlap_fraction")
               if name not in families]
    check(not missing, "plane: metrics file lacks %s" % missing)
    payload = json.load(open(paths["trace.json"]))
    names = {event["name"] for event in trace.validate_chrome_trace(payload)}
    missing = {"host_gap", "input", "gar.aggregate", "input.gather", "input.put"} - names
    check(not missing, "plane: the span trace lacks %s" % sorted(missing))
    check(payload["otherData"]["run_id"] == "chip-plane", "plane: trace run id %s" % payload["otherData"])
    steps, calls = result["steps"], result["gar_probe_calls"]
    [name] = os.listdir(paths["s"])
    fires = [json.loads(line) for line in open(os.path.join(paths["s"], name))]
    check(calls == 1 + len(fires) and all(f["gar_seconds"] > 0 and f["run_id"] == "chip-plane" for f in fires),
          "plane: %d probe calls, %d summary fires (want the warm-up and one a fire)" % (calls, len(fires)))
    for name in kernels.KERNELS:
        want = steps + calls if name == "coordinate_median" else 0
        check(counts[name] == want, "plane: %s launched %d times in %d steps and %d probe calls (want %d)"
              % (name, counts[name], steps, calls, want))
    print("plane on %s: %d steps through %s, /status %s, %d families in the metrics file, %d span events; "
          "gar_probe_seconds %.6f s (%.4f ms) beside the GAR phase's median n=8 %.4f ms; launches %s"
          % (card, steps, result["input_pipeline"], json.dumps(status), len(families), len(payload["traceEvents"]),
             value["gar_probe_seconds"], 1e3 * value["gar_probe_seconds"], gar_ms["median n=8"],
             json.dumps(counts, sort_keys=True)))
    return counts


def profiler_phase(kernels, runner, card, workdir):
    """``--trace`` on a krum leg (n=8, one step a call): the runner's
    torch.profiler window over steps 3-5 must export a Chrome trace that names
    K1's kernel (``rows_kernel``) among its device events; returns
    {kernel: launches}."""
    trace_dir = os.path.join(workdir, "profile")
    kernels.reset_launch_counts()
    result = runner.main(["--experiment", "cnnet", "--aggregator", "krum", "--nb-workers", "8",
                          "--nb-decl-byz-workers", "2", "--nb-real-byz-workers", "2", "--attack", "signflip",
                          "--max-step", "8", "--seed", "1", "--evaluation-delta", "-1", "--evaluation-period", "-1",
                          "--trace", "--trace-dir", trace_dir, "--run-id", "chip-profile"])
    counts = kernels.launch_counts()
    path = os.path.join(trace_dir, "chip-profile.pt.trace.json")
    check(os.path.exists(path), "profiler: no trace at %s" % path)
    events = json.load(open(path))["traceEvents"]
    device = [e for e in events if e.get("cat") == "kernel"]
    k1 = [e for e in device if "rows_kernel" in e.get("name", "")]
    check(k1, "profiler: K1 (rows_kernel) is not among the %d kernel events" % len(device))
    for name in kernels.KERNELS:
        want = result["steps"] if name == "pairwise_sq_distances" else 0
        check(counts[name] == want, "profiler: %s launched %d times (want %d)" % (name, counts[name], want))
    print("profiler on %s: %s, %d events, %d kernel events, %d of K1 (%s)"
          % (card, path, len(events), len(device), len(k1), k1[0]["name"][:80]))
    return counts


def observability_phase(kernels, runner, card, workdir):
    """``--xprof 2:4`` and ``--forensics`` on cnnet + krum (n=8, f=2): the
    profiler window writes one trace whose events hold the ``train step``
    annotations of steps 2 and 3 and the card's kernels, with the memory
    gauges above 0 in ``--metrics-file``; the forensics report of a
    deviation-100 gaussian coalition (r = 2) names workers 0 and 1 and
    observes every step.  K1 launches once a step; returns {kernel:
    launches}."""
    from aggregathor_tpu_torch.obs import metrics

    base = ["--experiment", "cnnet", "--aggregator", "krum", "--nb-workers", "8", "--nb-decl-byz-workers", "2",
            "--nb-real-byz-workers", "2", "--seed", "1", "--evaluation-delta", "-1", "--evaluation-period", "-1"]
    totals = {name: 0 for name in kernels.KERNELS}

    def leg(label, argv):
        kernels.reset_launch_counts()
        result = runner.main(base + argv)
        counts = kernels.launch_counts()
        for name in kernels.KERNELS:
            want = result["steps"] if name == "pairwise_sq_distances" else 0
            check(counts[name] == want, "%s: %s launched %d times (want %d)" % (label, name, counts[name], want))
            totals[name] += counts[name]
        return result

    prom = os.path.join(workdir, "xprof.prom")
    result = leg("xprof", ["--attack", "signflip", "--max-step", "6", "--xprof", "2:4", "--trace-dir",
                           os.path.join(workdir, "xprof"), "--metrics-file", prom, "--run-id", "chip-xprof"])
    path = result["xprof_trace"]
    check(path is not None and os.path.exists(path), "xprof: no trace written")
    events = json.load(open(path))["traceEvents"]
    names = {e.get("name") for e in events}
    device = [e for e in events if e.get("cat") == "kernel"]
    check({"train step 2", "train step 3"} <= names, "xprof: the step annotations are missing")
    check("train step 4" not in names and device, "xprof: the window is not steps 2-3 with the card's kernels")
    families = metrics.parse_prometheus(open(prom).read())
    memory = {name: families[name]["samples"][0][2] for name in ("device_memory_live_bytes", "device_memory_peak_bytes")}
    check(all(value > 0 for value in memory.values()), "xprof: memory gauges %s" % memory)
    print("xprof on %s: %s, %d events, %d kernel events; device memory live %.0f MB, peak %.0f MB"
          % (card, path, len(events), len(device), memory["device_memory_live_bytes"] / 2**20,
             memory["device_memory_peak_bytes"] / 2**20))
    report_path = os.path.join(workdir, "forensics.json")
    result = leg("forensics", ["--attack", "gaussian", "--attack-args", "deviation:100", "--max-step", "10",
                               "--forensics", report_path])
    report = json.load(open(report_path))
    check(report["suspects"] == [0, 1] and report["steps_observed"] == result["steps"] == 10,
          "forensics: suspects %s over %d steps (want [0, 1] over 10)" % (report["suspects"], report["steps_observed"]))
    check(os.path.exists(report_path[:-5] + ".md"), "forensics: no markdown report")
    print("forensics on %s: suspects %s, evidence %s" % (card, report["suspects"], [
        report["workers"][w]["evidence"] for w in (0, 1)]))
    return totals


#: the worker axis on one card: two gloo ranks share cuda:0 (NCCL refuses
#: two ranks on one card), their collectives staged through pinned host
#: memory, their compute on the card.  (label, rule, attack) of cnnet at
#: n = 8 (batch 16) and the GAR probes (rule, n, f) at cnnet's width
MULTIRANK_STEPS = 3
MULTIRANK_LEGS = (("krum", "krum", "signflip"), ("median", "median", "signflip"))
MULTIRANK_PROBES = (("krum", 128, 8), ("centered-clip", 8, 2))
#: the kernels a step (a probe call) launches on each rank
MULTIRANK_LAUNCHES = {"krum": {"pairwise_sq_distances": 1}, "median": {"coordinate_median": 1},
                      "probe krum": {"nanmedian_columns": 1, "pairwise_sq_distances_gram": 1},
                      "probe centered-clip": {"nanmedian_columns": 1}}


def multirank_leg(axis, rule, attack, steps=MULTIRANK_STEPS):
    """cnnet (batch 16) + ``rule`` at n = 8, f = r = 2 on ``axis``, at the
    runner's default learning rate (the main path's legs'): a warm-up step,
    then ``steps`` timed steps with the launch counts and the axis's
    collective time read over them."""
    import torch

    from aggregathor_tpu_torch import gars, models
    from aggregathor_tpu_torch.core import build_optimizer, build_schedule
    from aggregathor_tpu_torch.ops import kernels
    from aggregathor_tpu_torch.parallel import RobustEngine, attacks

    n, f, r = 8, 2, 2
    exp = models.instantiate("cnnet", ["batch-size:16"])
    tx = build_optimizer("sgd", build_schedule("fixed", []))
    engine = RobustEngine(gars.instantiate(rule, n, f), n, nb_real_byz=r, attack=attacks.instantiate(attack, n, r),
                          worker_metrics=True, axis=axis)
    step = engine.build_step(exp.loss, tx)
    state = engine.init_state(exp.init(1), tx, seed=1)
    it = exp.make_train_iterator(n, seed=2)
    batches = [next(it) for _ in range(steps + 1)]
    state, _ = step(state, engine.put_batch(batches[0]))
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    before = dict(axis.stats)
    out = {"loss": [], "support": [], "step_ms": []}
    for batch in batches[1:]:
        begin = time.perf_counter()
        state, metrics = step(state, engine.put_batch(batch))
        torch.cuda.synchronize()
        out["step_ms"].append((time.perf_counter() - begin) * 1e3)
        out["loss"].append(float(metrics["total_loss"]))
        part = metrics.get("worker_participation")
        out["support"].append(None if part is None else (part > 0).tolist())
    out["counts"] = kernels.launch_counts()
    out["collective_ms"] = (axis.stats["seconds"] - before["seconds"]) * 1e3 / steps
    out["collective_mb"] = (axis.stats["bytes"] - before["bytes"]) / 2**20 / steps
    out["params"] = torch.cat([state.params[k].detach().reshape(-1) for k in sorted(state.params)]).cpu().numpy()
    return out


def multirank_probe(axis, rule, n, f):
    """The GAR probe of ``rule`` at (n, cnnet's d) on ``axis``: a warm-up
    call, then one call with the launch counts read over it; returns this
    rank's aggregate block."""
    import torch

    from aggregathor_tpu_torch import gars
    from aggregathor_tpu_torch.ops import kernels
    from aggregathor_tpu_torch.parallel import RobustEngine

    probe = RobustEngine(gars.instantiate(rule, n, f), n, axis=axis.with_workers(n)).build_gar_probe(CNNET_D, seed=3)
    probe(0)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    begin = time.perf_counter()
    agg = probe(1)
    torch.cuda.synchronize()
    out = {"ms": (time.perf_counter() - begin) * 1e3, "counts": kernels.launch_counts(),
           "shape": list(probe.rows.shape), "agg": agg.cpu().numpy()}
    del probe
    torch.cuda.empty_cache()
    return out


def multirank_rank(axis):
    """One rank of ``multirank_phase`` (a spawned process re-imports this
    module, whose top level imports nothing of the port)."""
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    out = {label: multirank_leg(axis, rule, attack) for label, rule, attack in MULTIRANK_LEGS}
    out.update({"probe " + rule: multirank_probe(axis, rule, n, f) for rule, n, f in MULTIRANK_PROBES})
    return out


def multirank_phase(torch, kernels, card, two_ranks):
    """Two gloo ranks on ``cuda:0`` in two spawned processes
    (``parallel.mesh.spawn``, shared card): cnnet + krum (signflip) and
    median for ``MULTIRANK_STEPS`` steps at d = 1,756,682 and the GAR probes
    of krum at n = 128 and centered-clip at n = 8, held against one rank
    with the same weights and batches: losses within 1e-5 relative,
    selections identical, the parameters replicated bit for bit across the
    ranks (their distance to the one rank's printed), the probes' joined
    aggregate blocks within 1e-5 (1 + |x|) of the one-rank
    aggregate, and the launches exact on each rank (K1 once a step at (8,
    878,341), K3 once at (8, 878,341), the centring and K2 once a call at
    (128, 878,341)).  Prints the step ms of each and the staged collective
    ms and MB a step.  The two ranks ran in ``bounded_ranks_phase``'s spawn
    (``two_ranks["multirank"]``).  Returns {kernel: launches} summed over
    the ranks."""
    import numpy as np

    from aggregathor_tpu_torch.parallel.mesh import WorkerAxis

    ranks = two_ranks["multirank"]
    one_axis = WorkerAxis(8, 1, 0, "cuda")
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    one = {label: multirank_leg(one_axis, rule, attack) for label, rule, attack in MULTIRANK_LEGS}
    torch.backends.cudnn.deterministic = False
    totals = {name: 0 for name in kernels.KERNELS}
    for label, _, _ in MULTIRANK_LEGS:
        lead, other, want = ranks[0][label], ranks[1][label], one[label]
        check(lead["loss"] == other["loss"] and bool((lead["params"] == other["params"]).all()),
              "multirank %s: the ranks' losses or parameters differ" % label)
        check(lead["support"] == want["support"], "multirank %s: selections differ from one rank's" % label)
        rel = max(abs(a - b) / abs(b) for a, b in zip(lead["loss"], want["loss"]))
        check(rel <= 1e-5, "multirank %s: losses %s vs one rank's %s" % (label, lead["loss"], want["loss"]))
        # not held: a coordinate rule picks another worker's value where two
        # nearly tie, and the gradients of 4 and 8 vmapped workers differ in
        # their last bits (cuDNN on another batch), so the parameters drift
        params_err = float(abs(lead["params"] - want["params"]).max() / abs(want["params"]).max())
        print("multirank %s on %s: 2 ranks sharing the card, %d steps: step %.2f ms (one rank %.2f ms), staged "
              "collectives %.2f ms and %.1f MB a step and rank; loss rel err %.2g, parameters off one rank's by "
              "%.2g of the largest"
              % (label, card, MULTIRANK_STEPS, statistics.median(lead["step_ms"]), statistics.median(want["step_ms"]),
                 lead["collective_ms"], lead["collective_mb"], rel, params_err))
    for rule, n, f in MULTIRANK_PROBES:
        label = "probe " + rule
        single = multirank_probe(one_axis, rule, n, f)
        joined = np.concatenate([ranks[0][label]["agg"], ranks[1][label]["agg"]])[:CNNET_D]
        err = np.abs(joined - single["agg"])
        check(bool(np.all(err <= 1e-5 * (1 + np.abs(single["agg"])))),
              "multirank %s: the joined blocks differ from one rank's aggregate (max %g)" % (label, err.max()))
        print("multirank %s at (%d, %d) on %s: blocks %s, %.2f ms a call (one rank %.2f ms), max |err| %g"
              % (label, n, CNNET_D, card, ranks[0][label]["shape"], ranks[0][label]["ms"], single["ms"], err.max()))
    for label, per_step in MULTIRANK_LAUNCHES.items():
        calls = 1 if label.startswith("probe") else MULTIRANK_STEPS
        for rank, result in enumerate(ranks):
            counts = result[label]["counts"]
            for name in kernels.KERNELS:
                want = per_step.get(name, 0) * calls
                check(counts[name] == want, "multirank %s rank %d: %s launched %d times (want %d)"
                      % (label, rank, name, counts[name], want))
                totals[name] += counts[name]
    del one
    torch.cuda.empty_cache()
    return totals


#: the guardian legs on cnnet at full width: average under an inf coalition
#: (r = 2) breaks at step 2; the guardian rolls back and climbs its ladder.
#: (label, n, --guardian-args, the rungs it must apply, the overrides it
#: ends under, the kernels once a step there, the healthy run's rule)
GUARDIAN_LEGS = [
    ("A", 8, ["recover:5"], ["f+1", "gar=median"], "f=3 gar=median", ("coordinate_median",), "median"),
    ("B", 11, ["recover:5", "ladder:gar=bulyan"], ["gar=bulyan"], "f=2 gar=bulyan",
     ("pairwise_sq_distances", "coordinate_averaged_median"), "bulyan"),
]
GUARDIAN_BASE = ["--experiment", "cnnet", "--seed", "1", "--nb-decl-byz-workers", "2", "--nb-real-byz-workers", "2",
                 "--attack", "inf", "--max-step", "20", "--evaluation-delta", "-1", "--evaluation-period", "-1",
                 "--checkpoint-period", "-1", "--summary-delta", "5", "--summary-period", "-1"]
#: the healthy cost: cnnet + krum n=8, f=2, r=2 signflip, --guardian on
#: and off in turns
GUARDIAN_COST = ["--experiment", "cnnet", "--seed", "1", "--aggregator", "krum", "--nb-workers", "8",
                 "--nb-decl-byz-workers", "2", "--nb-real-byz-workers", "2", "--attack", "signflip",
                 "--max-step", "20", "--evaluation-delta", "-1", "--evaluation-period", "-1",
                 "--checkpoint-delta", "100", "--checkpoint-period", "-1"]


def _guardian_counters(snapshot):
    return {name: snapshot.get(name, 0.0) for name in
            ("guardian_rollbacks_total", "guardian_escalations_total", "guardian_recoveries_total")}


def _held_launches(label, counts, per_step):
    """Each kernel launched exactly ``per_step[name]`` times (0 if absent)."""
    for name in counts:
        check(counts[name] == per_step.get(name, 0), "%s: %s launched %d times (want %d)"
              % (label, name, counts[name], per_step.get(name, 0)))


def guardian_phase(torch, kernels, runner, card, workdir):
    """Rollback-and-escalate on the card; returns {kernel: launches}.

    Legs A and B (``GUARDIAN_LEGS``): cnnet (d = 1,756,682) under average and
    an inf coalition, with ``--guardian``, ``--flight 16 --flight-dump``,
    ``--journal``, ``--metrics-file`` and ``--trace-file``: each must roll
    back from step 2 once a rung it applies (to a fresh state: no snapshot
    read clean), recover once, and end with a finite loss; the rung's
    kernels launched once a step dispatched under it (``steps_by_overrides``,
    the abandoned calls included) and no other kernel; the journal holds
    one decision, rollback, escalation and flight post-mortem a rollback,
    one recovery, one start and one end; every rollback's dump lies at
    ``<root>.rollback-<step>.json`` and the registry's ``guardian_*``
    counters moved by the result's counts.  Each ``guardian.rollback``
    span's wall time is printed, with the steps to recovery, and the final
    loss beside a healthy run of the rule it escalated to (same argv, no
    guardian, that rule from step 0).  Leg C: ``digits`` trained healthy
    with median to a snapshot at step 6, then resumed under average and inf
    with ``--guardian``: it must roll back to step 6 with
    ``restored_snapshot``.  Last the healthy cost pair (``GUARDIAN_COST``,
    on, off, off, on): steps/s without the first step, K1 once a step."""
    from aggregathor_tpu_torch.obs import events as obs_events, metrics as obs_metrics, trace

    totals = {name: 0 for name in kernels.KERNELS}

    def run(label, argv):
        kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        result = runner.main(argv)
        counts = kernels.launch_counts()
        for name, count in counts.items():
            totals[name] += count
        return result, counts

    for label, n, guardian_args, rungs, escalated, there, healthy_rule in GUARDIAN_LEGS:
        where = os.path.join(workdir, "guardian", label)
        os.makedirs(where)
        paths = {name: os.path.join(where, name) for name in ("ckpt", "journal.jsonl", "m.prom", "trace.json",
                                                              "flight.json", "s")}
        before = _guardian_counters(obs_metrics.REGISTRY.snapshot())
        result, counts = run("guardian " + label, GUARDIAN_BASE + [
            "--aggregator", "average", "--nb-workers", str(n), "--guardian", "--guardian-args", *guardian_args,
            "--checkpoint-dir", paths["ckpt"], "--checkpoint-delta", "4", "--flight", "16", "--flight-dump",
            paths["flight.json"], "--journal", paths["journal.jsonl"], "--metrics-file", paths["m.prom"],
            "--trace-file", paths["trace.json"], "--summary-dir", paths["s"]])
        after = _guardian_counters(obs_metrics.REGISTRY.snapshot())
        rollbacks = result["rollbacks"]
        check(result["escalations"] == rungs, "guardian %s: rungs %s (want %s)" % (label, result["escalations"], rungs))
        check([(r["from_step"], r["to_step"], r["restored_snapshot"]) for r in rollbacks] == [(2, 0, False)] * len(rungs),
              "guardian %s: rollbacks %s" % (label, rollbacks))
        check(len(result["recovered"]) == 1, "guardian %s: recovered at %s" % (label, result["recovered"]))
        check(result["final_loss"] is not None and math.isfinite(result["final_loss"]),
              "guardian %s: final loss %s" % (label, result["final_loss"]))
        under = result["steps_by_overrides"]
        _held_launches("guardian " + label, counts, {name: under.get(escalated, 0) for name in there})
        check(under.get(escalated, 0) == result["steps"], "guardian %s: %s steps under %s, %d in the run"
              % (label, under.get(escalated), escalated, result["steps"]))
        journal = obs_events.load_journal(paths["journal.jsonl"])
        kinds = obs_events.counts_by_type(journal)
        want = {"run_start": 1, "guardian_rollback_decision": len(rungs), "guardian_rollback": len(rungs),
                "guardian_escalation": len(rungs), "flight_postmortem": len(rungs), "guardian_recovered": 1,
                "run_end": 1}
        check(kinds == want, "guardian %s: journal %s (want %s)" % (label, kinds, want))
        dumps = sorted({r["path"] for r in journal if r["type"] == "flight_postmortem"})
        wanted = sorted({os.path.join(where, "flight.rollback-%d.json" % r["from_step"]) for r in rollbacks})
        check(dumps == wanted and all(os.path.exists(p) for p in wanted) and not os.path.exists(paths["flight.json"]),
              "guardian %s: flight dumps %s (want %s, and no final one)" % (label, dumps, wanted))
        for dump in wanted:
            document = json.load(open(dump))
            check(document["reason"] == "guardian_rollback" and document["extra"]["at_step"] == 2,
                  "guardian %s: dump %s" % (label, {k: document.get(k) for k in ("reason", "extra")}))
        moved = {name: after[name] - before[name] for name in after}
        check(moved == {"guardian_rollbacks_total": len(rungs), "guardian_escalations_total": len(rungs),
                        "guardian_recoveries_total": 1}, "guardian %s: registry moved %s" % (label, moved))
        spans = [e for e in trace.validate_chrome_trace(json.load(open(paths["trace.json"])))
                 if e["name"] == "guardian.rollback" and e["ph"] == "X"]  # the watchdog's instant shares the name
        check(len(spans) == len(rungs), "guardian %s: %d guardian.rollback spans" % (label, len(spans)))
        healthy, healthy_counts = run("healthy " + healthy_rule, GUARDIAN_BASE + [
            "--aggregator", healthy_rule, "--nb-workers", str(n)])
        _held_launches("healthy " + healthy_rule, healthy_counts, {name: healthy["steps"] for name in there})
        print("guardian %s on %s: cnnet n=%d, rungs %s, rollbacks from step 2 at %s, recovered at step %s (%d steps "
              "after the last rollback; %d steps dispatched in all, by overrides %s); guardian.rollback wall %s ms; "
              "final loss %.4f against a healthy %s run's %.4f (x%.3f); %.3f steps/s excl. 1st; peak %.0f MB; "
              "launches %s" % (
                  label, card, n, rungs, [r["to_step"] for r in rollbacks], result["recovered"][0],
                  result["recovered"][0] - rollbacks[-1]["to_step"], sum(under.values()), json.dumps(under),
                  ", ".join("%.1f" % (s["dur"] / 1e3) for s in spans), result["final_loss"], healthy_rule,
                  healthy["final_loss"], result["final_loss"] / healthy["final_loss"], result["steps_per_s"],
                  torch.cuda.max_memory_allocated() / 2**20, json.dumps(counts, sort_keys=True)))

    # leg C: a resume into the hostile regime rolls back to the snapshot it
    # resumed from (the auto-restored step is the first last-known-good);
    # on digits and on cnnet, whose rollback then loads a full-width snapshot
    for experiment, extra in (("digits", ["--learning-rate-args", "initial-rate:0.1"]), ("cnnet", ["--seed", "1"])):
        where = os.path.join(workdir, "guardian", "C-" + experiment)
        base = ["--experiment", experiment, "--nb-workers", "8", "--nb-decl-byz-workers", "2", "--evaluation-delta",
                "-1", "--evaluation-period", "-1", "--checkpoint-period", "-1", "--checkpoint-dir",
                os.path.join(where, "ckpt"), *extra]
        _, counts = run("guardian C healthy", base + ["--aggregator", "median", "--max-step", "6"])
        _held_launches("guardian C healthy " + experiment, counts, {"coordinate_median": 6})
        result, counts = run("guardian C", base + [
            "--aggregator", "average", "--nb-real-byz-workers", "2", "--attack", "inf", "--max-step", "20",
            "--guardian", "--guardian-args", "ladder:gar=median", "recover:4", "--checkpoint-delta", "100",
            "--journal", os.path.join(where, "journal.jsonl"), "--trace-file", os.path.join(where, "trace.json")])
        rollbacks = result["rollbacks"]
        check(result["restored_step"] == 6 and [(r["to_step"], r["restored_snapshot"]) for r in rollbacks]
              == [(6, True)], "guardian C %s: restored %s, rollbacks %s" % (experiment, result["restored_step"],
                                                                           rollbacks))
        check(result["escalations"] == ["gar=median"] and len(result["recovered"]) == 1
              and math.isfinite(result["final_loss"]), "guardian C %s: %s" % (experiment, {k: result[k] for k in (
                  "escalations", "recovered", "final_loss")}))
        _held_launches("guardian C " + experiment, counts,
                       {"coordinate_median": result["steps_by_overrides"].get("f=2 gar=median", 0)})
        spans = {name: [e["dur"] / 1e3 for e in trace.validate_chrome_trace(json.load(open(os.path.join(
            where, "trace.json")))) if e["name"] == name and e["ph"] == "X"]
            for name in ("guardian.rollback", "checkpoint.restore")}
        check(len(spans["guardian.rollback"]) == 1 and len(spans["checkpoint.restore"]) == 2,
              "guardian C %s: spans %s" % (experiment, spans))
        print("guardian C on %s: %s resumed at step %d under average + inf, rolled back from step %d to the "
              "snapshot at step %d (restored_snapshot %s), recovered at step %s, final loss %.4f; guardian.rollback "
              "wall %.1f ms, of which the snapshot's restore %.1f ms (the auto-restore at start %.1f ms); "
              "launches %s" % (card, experiment, result["restored_step"], rollbacks[0]["from_step"],
                               rollbacks[0]["to_step"], rollbacks[0]["restored_snapshot"], result["recovered"][0],
                               result["final_loss"], spans["guardian.rollback"][0], spans["checkpoint.restore"][1],
                               spans["checkpoint.restore"][0], json.dumps(counts, sort_keys=True)))

    # the healthy cost: --guardian on and off in turns, two pairs (there
    # were four until the bounded ranks phase needed their seconds)
    rates = {"on": [], "off": []}
    for i, mode in enumerate(("on", "off", "off", "on")):
        argv = GUARDIAN_COST + ["--checkpoint-dir", os.path.join(workdir, "guardian", "cost-%d" % i)]
        result, counts = run("guardian cost " + mode, argv + (["--guardian"] if mode == "on" else []))
        _held_launches("guardian cost " + mode, counts, {"pairwise_sq_distances": result["steps"]})
        check(result["rollbacks"] == [], "guardian cost: a healthy run rolled back: %s" % result["rollbacks"])
        rates[mode].append(result["steps_per_s"])
    median = {mode: sorted(values)[len(values) // 2 - 1:len(values) // 2 + 1] for mode, values in rates.items()}
    median = {mode: sum(pair) / 2 for mode, pair in median.items()}
    print("guardian healthy cost on %s: cnnet + krum n=8 streamed, 20 steps, steps/s excl. 1st --guardian on %s, "
          "off %s (on, off, off, on): medians on %.3f, off %.3f, on/off x%.4f; spread on %.3f-%.3f, "
          "off %.3f-%.3f" % (card, ", ".join("%.3f" % v for v in rates["on"]), ", ".join("%.3f" % v for v in
                                                                                         rates["off"]),
                             median["on"], median["off"], median["on"] / median["off"], min(rates["on"]),
                             max(rates["on"]), min(rates["off"]), max(rates["off"])))
    return totals


#: the resumed run's losses against the uninterrupted run's, relative.  The
#: resume phase pins cuDNN to its deterministic algorithms: with the
#: default ones, two uninterrupted digits-conv runs on the card differ by up
#: to 34 % in a loss within 20 steps (the convolutions' backward adds in an
#: order of its own, and Multi-Krum's selection among close honest scores
#: amplifies the last bits); pinned, and for the MLP without any setting,
#: they agree bit for bit.  So the resumed losses must be the same bits too.
RESUME_RTOL = 0.0


def resume_phase(torch, runner, workdir, experiment, exp_args, argv, input_args=()):
    """20 steps uninterrupted, then 10 with checkpoints, a restore and 10
    more, under deterministic cuDNN: the restored state equals the saved
    one bit for bit, and the final state the uninterrupted run's; the losses
    of the steps past 10 that both runs summarize match (``RESUME_RTOL``;
    every step, or under ``--unroll`` each call's last); the TSV holds no
    step twice; the summary JSONL carries the run id and the four scalars.
    Returns the largest relative loss difference, and the same between the
    uninterrupted run and a twin under cuDNN's defaults."""
    from aggregathor_tpu_torch import gars, models
    from aggregathor_tpu_torch.core import build_optimizer, build_schedule, host_snapshot
    from aggregathor_tpu_torch.obs.checkpoint import Checkpoints
    from aggregathor_tpu_torch.parallel import RobustEngine

    def run(name, max_step, extra=()):
        directory = os.path.join(workdir, name)
        runner.main(["--experiment", experiment, "--experiment-args", *exp_args, *argv, *input_args,
                     "--max-step", str(max_step),
                     "--checkpoint-dir", directory,
                     "--summary-dir", directory, "--summary-delta", "1", "--evaluation-file",
                     os.path.join(directory, "eval.tsv"), "--evaluation-delta", "5", "--evaluation-period", "-1",
                     *extra])
        return directory

    def losses(directory):
        events = []
        for path in sorted(p for p in os.listdir(directory) if p.endswith(".jsonl")):
            events += [json.loads(line) for line in open(os.path.join(directory, path))]
        for event in events:
            check({"run_id", "step", "total_loss", "grad_norm", "learning_rate", "steps_per_s"} <= set(event),
                  "%s: summary event lacks a key: %s" % (experiment, sorted(event)))
        return {event["step"]: event["total_loss"] for event in events}

    # a twin with cuDNN's default algorithms, for the spread they make
    again = run("again", 20)
    torch.backends.cudnn.deterministic = True
    whole = run("whole", 20)
    split = run("split", 10, ("--checkpoint-delta", "10"))
    # the snapshot at step 10, loaded into a fresh state on the card, is the saved state bit for bit
    saved = torch.load(os.path.join(split, "model-10.ckpt"), weights_only=True)
    exp = models.instantiate(experiment, exp_args)
    tx = build_optimizer("sgd", build_schedule("fixed", []))
    exchange = argv[argv.index("--exchange") + 1] if "--exchange" in argv else None
    state = RobustEngine(gars.instantiate("krum", 8, 2), 8, device="cuda", exchange=exchange).init_state(
        exp.init(99), tx, seed=99)
    Checkpoints(split).restore(state)
    check(state.params[next(iter(state.params))].device.type == "cuda", "%s: restored off the card" % experiment)
    again_saved = host_snapshot(state)
    check(again_saved["step"] == saved["step"] == 10 and again_saved["opt_state"]["count"] == 10,
          "%s: restored step or count differs" % experiment)
    for name, value in saved["params"].items():
        check(torch.equal(value.view(torch.int32), again_saved["params"][name].view(torch.int32)),
              "%s: restored %s differs from the saved one" % (experiment, name))
    check(("ef" in saved) == (state.ef is not None), "%s: the snapshot's residuals" % experiment)
    if state.ef is not None:  # the error-feedback residuals, on the card, bit for bit
        check(state.ef.device.type == "cuda" and torch.equal(saved["ef"].view(torch.int32),
                                                            state.ef.cpu().view(torch.int32)),
              "%s: restored residuals differ from the saved ones" % experiment)
    run("split", 20, ("--checkpoint-delta", "10"))
    torch.backends.cudnn.deterministic = False
    steps = [int(line.split("\t")[1]) for line in open(os.path.join(split, "eval.tsv")).read().splitlines()]
    check(len(steps) == len(set(steps)) and steps == sorted(steps), "%s: TSV steps %s" % (experiment, steps))
    want, twin, got = losses(whole), losses(again), losses(split)
    if "--unroll" not in input_args:
        check(sorted(got) == list(range(1, 21)), "%s: resumed summary steps %s" % (experiment, sorted(got)))
    common = sorted(k for k in set(got) & set(want) if k > 10)
    check(20 in common, "%s: resumed summary steps %s, uninterrupted %s" % (experiment, sorted(got), sorted(want)))
    resumed = max(abs(got[k] - want[k]) / abs(want[k]) for k in common)
    spread = max(abs(twin[k] - want[k]) / abs(want[k]) for k in want)
    finals = [torch.load(os.path.join(d, "model-20.ckpt"), weights_only=True) for d in (whole, split)]
    for name, value in list(finals[0]["params"].items()) + ([("ef", finals[0]["ef"])] if "ef" in finals[0] else []):
        other = finals[1]["ef"] if name == "ef" else finals[1]["params"][name]
        check(torch.equal(value.view(torch.int32), other.view(torch.int32)),
              "%s: the resumed run's final %s differs from the uninterrupted run's" % (experiment, name))
    print("resume %s%s: restored state bit-identical to the saved one, final state to the uninterrupted run's%s; "
          "losses of steps %s within %.3g of the uninterrupted run's, relative (tolerance %g; deterministic cuDNN), "
          "the default cuDNN's twin within %.3g; TSV steps %s"
          % (experiment, " " + " ".join(input_args) if input_args else "",
             " (--exchange %s: the residuals too)" % exchange if exchange else "", common, resumed, RESUME_RTOL,
             spread, steps))
    check(resumed <= RESUME_RTOL, "%s: resumed losses off by %.3g" % (experiment, resumed))
    return resumed, spread


def reference_phase(torch, gars, kernels, models):
    """Rules and one engine step on the card against the same on the CPU."""
    from aggregathor_tpu_torch.core import build_optimizer, build_schedule
    from aggregathor_tpu_torch.parallel import RobustEngine, attacks
    from aggregathor_tpu_torch.parallel.lossy import LossyLink

    def agree(rule, x, f):
        gar = gars.instantiate(rule, x.shape[0], f)
        got, want = gar.aggregate(x.cuda()).cpu(), gar.aggregate(x)
        check(torch.equal(torch.isnan(got), torch.isnan(want)), "%s: NaN pattern differs from the CPU" % rule)
        finite = torch.isfinite(want)
        check(bool(torch.allclose(got[finite], want[finite], rtol=1e-5, atol=1e-5)),
              "%s: aggregate differs from the CPU" % rule)
        if gar.needs_distances:
            w_gpu = gar.selection_weights(kernels.pairwise_sq_distances(x.cuda())).cpu()
            w_cpu = gar.selection_weights(kernels.pairwise_sq_distances(x))
            check(torch.equal(w_gpu, w_cpu), "%s: selection differs from the CPU at n=%d" % (rule, x.shape[0]))

    gen = torch.Generator().manual_seed(7)
    n, f, d = 11, 2, 3001
    x = poison(torch.randn((n, d), generator=gen), columns=False)
    x[4] = float("nan")  # a dead worker on top of the poison
    rules = ("average", "average-nan", "krum", "median", "averaged-median", "bulyan", "trimmed-mean")
    for rule in rules:
        agree(rule, x, f)
    # beyond 64 workers (K2): honest rows at distinct scales, 8 attackers far
    # off, a dead worker and scattered NaN/inf in two more rows
    for n in (72, 128):
        x = torch.randn((n, 3001), generator=gen) * (1.0 + 0.02 * torch.arange(float(n)))[:, None]
        x[:8] += 25.0
        x[40] = float("nan")
        x[3, 5::97] = float("inf")
        x[60, 7::89] = float("nan")
        for rule in ("krum", "bulyan"):
            agree(rule, x, 8)
    # Krum near a tie: the selection's boundary scores differ by a margin
    # just above the distance kernels' measured error (K1 at n = 8, the
    # centring and K2 at n = 72 and 128)
    from aggregathor_tpu_torch.gars.krum import krum_scores

    for n, f, d, margin in NEAR_TIES:
        x, selected = krum_near_tie(torch, n, f, d, margin, n)
        gar = gars.instantiate("krum", n, f)
        on_card, on_cpu = kernels.pairwise_sq_distances(x.cuda()).cpu(), kernels.pairwise_sq_distances(x)
        check(torch.equal(gar.selection_weights(on_card.cuda()).cpu() > 0, gar.selection_weights(on_cpu) > 0)
              and torch.equal(gar.selection_weights(on_cpu) > 0, selected),
              "krum near a tie (n=%d, margin %g): the card's selection differs from the CPU's" % (n, margin))
        x64 = x.double()
        norms = torch.sum(x64 * x64, dim=1)
        exact = krum_scores(torch.clamp_min(norms[:, None] + norms[None, :] - 2.0 * (x64 @ x64.T), 0.0), n, f)
        print("krum near a tie n=%d d=%d margin %g: scores within %.3g (card) and %.3g (CPU) of float64, relative"
              % (n, d, margin, float(torch.max(torch.abs(krum_scores(on_card, n, f).double() - exact) / exact)),
                 float(torch.max(torch.abs(krum_scores(on_cpu, n, f).double() - exact) / exact))))

    def mlp_steps(device, lossy_link, rule):
        exp = models.instantiate("mnist", ["hidden:16", "batch-size:16"])
        tx = build_optimizer("sgd", build_schedule("fixed", ["initial-rate:0.05"]))
        attack = None if lossy_link else attacks.instantiate("signflip", 8, 2)
        engine = RobustEngine(gars.instantiate(rule, 8, 2), 8, nb_real_byz=0 if lossy_link else 2,
                              attack=attack, lossy_link=lossy_link, device=device)
        state = engine.init_state(exp.init(3), tx, seed=3)
        step = engine.build_step(exp.loss, tx)
        it = exp.make_train_iterator(8, seed=4)
        for _ in range(3):
            state, _ = step(state, engine.put_batch(next(it)))
        return torch.cat([p.detach().cpu().reshape(-1) for p in state.params.values()])

    for label, rule, udp_args in (("krum", "krum", None),
                                  ("average-nan under --UDP 4 at drop-rate 0.3", "average-nan",
                                   ["drop-rate:0.3", "packet-coords:1024", "min-coords:0"])):
        finals = [mlp_steps(device, LossyLink(4, udp_args) if udp_args else None, rule) for device in ("cuda", "cpu")]
        check(bool(torch.all(torch.isfinite(finals[0]))), "3 MLP %s steps on the card: non-finite parameters" % label)
        check(bool(torch.allclose(finals[0], finals[1], rtol=1e-4, atol=1e-5)),
              "3 MLP %s steps on the card differ from the CPU (max %g)"
              % (label, float((finals[0] - finals[1]).abs().max())))
    print("reference: %d rules on a poisoned (11, 3001) matrix, krum and bulyan on poisoned (72, 3001) and "
          "(128, 3001) matrices, krum's selection near a tie (%s), and 3 MLP steps of krum and of average-nan "
          "under --UDP agree with the CPU" % (len(rules), ", ".join("n=%d d=%d margin %g" % (n, d, m)
                                                                  for n, _, d, m in NEAR_TIES)))


def leaf_width_phase(torch, kernels, models):
    """The kernels of granularity:leaf at the narrow widths of cnnet's
    leaves (10 to 1,572,864 columns) against their plain versions, each
    matrix with a NaN row (a quarantined worker): K1 and K6 at n = 8, the
    centring and K2 at n = 128, at the tolerances of the kernel phase."""
    from aggregathor_tpu_torch.core import FlatMap

    widths = sorted({size for _, _, _, size, _, _ in FlatMap(models.instantiate("cnnet", []).init(0)).slices})
    gen = torch.Generator(device="cuda").manual_seed(9)
    worst = dict.fromkeys(("pairwise_sq_distances", "average_nan_columns", "nanmedian_columns",
                           "pairwise_sq_distances_gram"), 0.0)
    for d in widths:
        for n in (8, 128):
            x = torch.randn((n, d), device="cuda", generator=gen) * (1.0 + 0.05 * torch.arange(
                float(n), device="cuda"))[:, None]
            x[n // 2] = float("nan")
            if n == 8:
                cases = (("pairwise_sq_distances", ()), ("average_nan_columns", ()))
            else:
                cases = (("nanmedian_columns", ()), ("pairwise_sq_distances_gram", (kernels.nanmedian_columns(x),)))
            for name, args in cases:
                got, want = getattr(kernels, name)(x, *args), kernels.PLAIN[name](x, *args)
                worst[name] = max(worst[name], compare(name, got, want, torch, x, args))
            del x
    print("granularity:leaf widths %s: K1 and K6 at n=8, the centring and K2 at n=128 agree with their plain "
          "versions (max abs err %s)" % (widths, json.dumps(worst, sort_keys=True)))


def options_reference_phase(torch, gars, kernels, models, steps=5):
    """The engine's robustness options on the card against the same on the
    CPU from one init: the MLP with worker momentum, reputation, quarantine,
    worker metrics and granularity:leaf, krum under signflip x10 at n = 8
    (K1 on every leaf) and n = 72 (the centring and K2 on every leaf, down to
    the 10-wide logits bias), the quarantined rows NaN.  Each step's
    participation, reputations, quarantine count and masked rows must be
    identical, the parameters within the MLP phase's tolerance."""
    from aggregathor_tpu_torch.core import FlatMap, build_optimizer, build_schedule
    from aggregathor_tpu_torch.parallel import RobustEngine, attacks

    exp = models.instantiate("mnist", ["hidden:16", "batch-size:16"])
    nb_leaves = len(FlatMap(exp.init(3)).slices)
    nb_sizes = len({size for _, _, _, size, _, _ in FlatMap(exp.init(3)).slices})
    totals = zero_counts(kernels)

    def run(device, n, f):
        tx = build_optimizer("sgd", build_schedule("fixed", ["initial-rate:0.05"]))
        engine = RobustEngine(gars.instantiate("krum", n, f), n, nb_real_byz=f,
                              attack=attacks.instantiate("signflip", n, f, ["scale:10.0"]), worker_momentum=0.9,
                              worker_metrics=True, reputation_decay=0.5, quarantine_threshold=0.4,
                              granularity="leaf", device=device)
        state = engine.init_state(exp.init(3), tx, seed=3)
        step = engine.build_step(exp.loss, tx)
        it = exp.make_train_iterator(n, seed=4)
        trail = []
        for _ in range(steps):
            state, metrics = step(state, engine.put_batch(next(it)))
            trail.append({name: metrics[name].cpu() for name in
                          ("worker_participation", "worker_reputation", "nb_quarantined", "worker_sq_dist")})
        return trail, torch.cat([p.detach().cpu().reshape(-1) for p in state.params.values()])

    for n, f, launched in ((8, 2, ("pairwise_sq_distances",)),
                           (72, 8, ("pairwise_sq_distances_gram", "nanmedian_columns"))):
        kernels.reset_launch_counts()
        card, card_params = run("cuda", n, f)
        counts, unbatched = kernels.batched_launch_counts(), kernels.launch_counts()
        cpu, cpu_params = run("cpu", n, f)
        # bucketed on the card ("auto"), the per-leaf loop on the CPU
        check(counts == {name: steps * nb_sizes * (name in launched) for name in counts}
              and not any(unbatched.values()),
              "options n=%d: batched launches %s, launches %s (want %s batched once a leaf size a step)"
              % (n, counts, unbatched, launched))
        for name, count in counts.items():
            totals[batched(name)] += count
        for k, (a, b) in enumerate(zip(card, cpu)):
            for name in ("worker_participation", "worker_reputation", "nb_quarantined"):
                check(torch.equal(a[name], b[name]), "options n=%d step %d: %s %s on the card, %s on the CPU"
                      % (n, k, name, a[name].tolist(), b[name].tolist()))
            check(torch.equal(torch.isnan(a["worker_sq_dist"]), torch.isnan(b["worker_sq_dist"])),
                  "options n=%d step %d: the masked rows differ" % (n, k))
        check(int(card[-1]["nb_quarantined"]) == f and bool(torch.all(card[-1]["worker_participation"][:f] == 0)),
              "options n=%d: the attackers are not quarantined (%s)" % (n, card[-1]["nb_quarantined"]))
        check(bool(torch.allclose(card_params, cpu_params, rtol=1e-4, atol=1e-5)),
              "options n=%d: parameters differ from the CPU (max %g)"
              % (n, float((card_params - cpu_params).abs().max())))
        print("options on the card (bucketed) against the CPU (per-leaf loop), n=%d f=%d, %d steps of the MLP "
              "(momentum 0.9, reputation 0.5, quarantine 0.4, worker metrics, granularity:leaf over %d leaves in %d "
              "sizes): participation, reputations and %d quarantined identical, parameters within %.3g; batched "
              "launches %s" % (n, f, steps, nb_leaves, nb_sizes, int(card[-1]["nb_quarantined"]),
                               float((card_params - cpu_params).abs().max()), json.dumps(counts, sort_keys=True)))
    return totals


def vmap_phase(torch, gars, models, n=8):
    """The worker gradients of cnnet at n = 8: the engine's one vmapped pass
    against a per-worker loop of forward and backward passes on the same
    weights and batches.

    In float32 at the main path's batch 128 the gradients are fixed by the
    inputs only to ~1e-3: a ReLU input of dense1 within rounding of 0 flips
    its mask for one image, and the whole gradient upstream of it moves by
    ~1e-3 (seen against float64, for the loop and the vmap alike).  So the
    vmap is held to the loop in float64 at batch 128 (no input lies within
    float64's rounding of a kink; within ``VMAP_F64_RTOL`` of each row's
    largest entry) and in float32 at batch 8, where a flip is unlikely
    (within ``VMAP_RTOL``); and the float32 operations of the vmapped step
    are held, one by one, against float64 at the main path's shapes (1024
    images): cnnet's two convolutions forward, conv2's input gradient and
    both weight gradients (``models.cnnet.conv_weight_grad``), within
    ``VMAP_RTOL`` of the largest entry; cuDNN's float32 weight gradient at
    conv2, which the step does not use, is printed beside it.  The float32 vmap and loop at batch 128 are printed
    against float64.  The vmap takes no batching-rule fallback (warnings are
    errors); both are timed by CUDA events at batch 128, with the vmap's
    peak memory."""
    import warnings

    from torch.func import grad_and_value, vmap

    from aggregathor_tpu_torch.core import FlatMap
    from aggregathor_tpu_torch.models.cnnet import conv_weight_grad, max_pool_same
    from aggregathor_tpu_torch.parallel import RobustEngine

    engine = RobustEngine(gars.instantiate("average", n, 0), n, device="cuda")

    def setup(batch_size):
        exp = models.instantiate("cnnet", ["batch-size:%d" % batch_size])
        params = {name: value.to("cuda") for name, value in exp.init(1).items()}
        return exp, params, FlatMap(params), engine.put_batch(next(exp.make_train_iterator(n, seed=2)))

    def cast(exp, params, batch, dtype):
        exp.model.to(dtype)
        return ({name: value.to(dtype) for name, value in params.items()},
                {"image": batch["image"].to(dtype), "label": batch["label"]})

    def loop(exp, params, flatmap, batch, dtype=torch.float32):
        leaves, batch = cast(exp, params, batch, dtype)
        leaves = {name: value.requires_grad_(True) for name, value in leaves.items()}
        rows = torch.empty((n, flatmap.size), device="cuda", dtype=dtype)
        for w in range(n):
            loss = exp.loss(leaves, {key: value[w] for key, value in batch.items()})
            flatmap.flatten_into(rows[w], dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values())))))
        exp.model.float()
        return rows

    def vmapped64(exp, params, flatmap, batch):
        leaves, batch = cast(exp, params, batch, torch.float64)
        grads, _ = vmap(grad_and_value(exp.loss), in_dims=(None, 0))(leaves, batch)
        exp.model.float()
        return flatmap.flatten_rows(grads, torch.empty((n, flatmap.size), device="cuda", dtype=torch.float64))

    def max_rel(rows, want):
        return float(torch.max(torch.abs(rows.double() - want.double())
                               / torch.amax(torch.abs(want.double()), dim=1, keepdim=True)))

    def l2_rel(rows, want):
        return float(torch.max(torch.linalg.vector_norm(rows.double() - want, dim=1)
                               / torch.linalg.vector_norm(want, dim=1)))

    exp, params, flatmap, batch = setup(8)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        _, rows = engine._worker_gradients(params, batch, exp.loss, flatmap)
    small = max_rel(rows, loop(exp, params, flatmap, batch))
    check(small <= VMAP_RTOL, "vmap: float32 batch 8 gradients off the per-worker loop by %.3g of a row's largest "
          "entry" % small)

    exp, params, flatmap, batch = setup(128)
    exact = loop(exp, params, flatmap, batch, torch.float64)
    double = max_rel(vmapped64(exp, params, flatmap, batch), exact)
    check(double <= VMAP_F64_RTOL, "vmap: float64 batch 128 gradients off the per-worker loop by %.3g" % double)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        _, rows = engine._worker_gradients(params, batch, exp.loss, flatmap)
    torch.cuda.synchronize()
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    check(bool(torch.all(torch.isfinite(rows))), "vmap: non-finite gradient rows")
    looped = loop(exp, params, flatmap, batch)
    floor = {"vmap": (l2_rel(rows, exact), max_rel(rows, exact)), "loop": (l2_rel(looped, exact),
                                                                          max_rel(looped, exact))}
    vmap_ms = time_ms(lambda: engine._worker_gradients(params, batch, exp.loss, flatmap), torch, iters=10)
    loop_ms = time_ms(lambda: loop(exp, params, flatmap, batch), torch, iters=10)
    del rows, looped, exact

    # the float32 operations one by one at the vmapped step's shapes
    x = batch["image"].reshape((-1,) + tuple(batch["image"].shape[2:])).permute(0, 3, 1, 2).contiguous()
    gen = torch.Generator(device="cuda").manual_seed(3)
    m = exp.model.to("cuda")
    hidden = m.norm1(max_pool_same(torch.relu(torch.nn.functional.conv2d(x, m.conv1.weight, m.conv1.bias,
                                                                         padding=2)))).detach()
    grad1 = torch.randn((x.shape[0], 64, 32, 32), device="cuda", generator=gen)
    grad2 = torch.randn((x.shape[0], 64, 16, 16), device="cuda", generator=gen)

    def cudnn_wgrad(inp, grad_out, weight):
        return torch.ops.aten.convolution_backward(grad_out, inp, weight, None, [1, 1], [2, 2], [1, 1], False,
                                                   [0, 0], 1, [False, True, False])[1]

    def dgrad(inp, grad_out, weight):
        return torch.ops.aten.convolution_backward(grad_out, inp, weight, None, [1, 1], [2, 2], [1, 1], False,
                                                   [0, 0], 1, [True, False, False])[0]

    ops = {
        "conv1 forward": lambda t: torch.nn.functional.conv2d(x.to(t), m.conv1.weight.to(t), padding=2),
        "conv2 forward": lambda t: torch.nn.functional.conv2d(hidden.to(t), m.conv2.weight.to(t), padding=2),
        "conv2 input gradient": lambda t: dgrad(hidden.to(t), grad2.to(t), m.conv2.weight.to(t)),
        "conv1 weight gradient": lambda t: conv_weight_grad(x.to(t), grad1.to(t), m.conv1.weight.to(t)),
        "conv2 weight gradient": lambda t: conv_weight_grad(hidden.to(t), grad2.to(t), m.conv2.weight.to(t)),
    }
    op_errs = {}
    for name, op in ops.items():
        want = op(torch.float64)
        op_errs[name] = float(torch.max(torch.abs(op(torch.float32).double() - want)) / torch.max(torch.abs(want)))
        del want
    cudnn_conv2 = cudnn_wgrad(hidden, grad2, m.conv2.weight).double()
    want = cudnn_wgrad(hidden.double(), grad2.double(), m.conv2.weight.double())
    cudnn_err = float(torch.max(torch.abs(cudnn_conv2 - want)) / torch.max(torch.abs(want)))
    wgrad_ms = (time_ms(lambda: cudnn_wgrad(hidden, grad2, m.conv2.weight), torch),
                time_ms(lambda: conv_weight_grad(hidden, grad2, m.conv2.weight), torch))
    del cudnn_conv2, want, hidden, grad1, grad2, x, batch
    torch.cuda.empty_cache()
    print("vmap cnnet n=%d: float32 batch 8, vmapped rows within %.3g of the per-worker loop's (of each row's largest "
          "entry; tolerance %g); float64 batch 128 within %.3g (tolerance %g); float32 batch 128 against float64: "
          "vmapped %.3g in a row's 2-norm, %.3g of its largest entry, looped %.3g, %.3g; %.2f ms vmapped against "
          "%.2f ms looped (float32, batch 128, CUDA events, 10 calls); peak %.0f MB"
          % (n, small, VMAP_RTOL, double, VMAP_F64_RTOL, *floor["vmap"], *floor["loop"], vmap_ms, loop_ms, peak_mb))
    print("float32 operations of the vmapped step at %d images against float64 (of the largest entry; tolerance %g): "
          "%s; cuDNN's float32 conv2 weight gradient %.3g (%.3f ms against conv_weight_grad's %.3f ms)"
          % (n * exp.batch_size, VMAP_RTOL, ", ".join("%s %.3g" % kv for kv in op_errs.items()), cudnn_err,
             *wgrad_ms))
    for name, err in op_errs.items():
        check(err <= VMAP_RTOL, "%s: float32 off float64 by %.3g of the largest entry" % (name, err))


#: the bucketed granularity:leaf path (``leaf_bucketing_phase``).  B1 holds
#: each batched kernel at cnnet's buckets and at ResNet-50's largest (config
#: 3, slim-resnet_v1_50-digits32: 32 leaves of 256, 11 of 262,144), with the
#: rows each kernel's path gives it: K1 at krum's n = 8 and config 3's n =
#: 32, the centring and K2 at krum's n = 72, K3, K5 and K6 at n = 8 and 32,
#: K4 at n = 8 (beta 6) and Bulyan's t = 16 selections of config 3 (beta 2);
#: the kernels line's batched rows are timed at the 11 x 262,144 bucket
LEAF_RESNET_BUCKETS = ((32, 256), (11, 262144))
LEAF_ROWS = {"pairwise_sq_distances": (8, 32), "pairwise_sq_distances_gram": (72, 72), "nanmedian_columns": (72, 72),
             "coordinate_median": (8, 32), "coordinate_averaged_median": (8, 16), "coordinate_trimmed_mean": (8, 32),
             "average_nan_columns": (8, 32)}
LEAF_ARGS = {"coordinate_averaged_median": {8: (6,), 16: (2,)}, "coordinate_trimmed_mean": {8: (2, 4), 32: (7, 18)}}
LEAF_STEPS = 5
LEAF_ZOO_STEPS = 3
#: B4 (config 3 through the runner): the final loss of the bucketed run
#: within this share of the loop's (the same batches and selections; the
#: aggregates differ in float32 rounding, carried through two updates)
LEAF_ZOO_LOSS_RTOL = 1e-4


def _leaf_stack(torch, gen, leaves, n, width):
    """(leaves, n, width) float32 leaves on the card: a NaN row in the first
    leaf, and in every leaf rows 1 and 2 tied on their first columns."""
    x = torch.randn((leaves, n, width), device="cuda", generator=gen)
    x[0, n // 2] = float("nan")
    x[:, 1, : min(width, 5)] = x[:, 2, : min(width, 5)]
    return x


def _batched_call(kernels, name, x, args):
    """``name``'s batched form on the (L, n, s) stack ``x``, given K2 its
    stack of centres; returns (result, the arguments given)."""
    form, _ = kernels.BATCHED[name]
    if name == "pairwise_sq_distances_gram":
        args = (kernels.nanmedian_columns_batched(x),)
    return form(x, *args), args


def _batched_bounds(kernels, name, leaves, n, width):
    """``bounds`` of one batched call: the leaves' columns side by side, and
    K1's and K2's (n, n) output once a leaf."""
    nbytes, ops, counted, peak = bounds(kernels, name, n, leaves * width)
    if name in ("pairwise_sq_distances", "pairwise_sq_distances_gram"):
        nbytes += (leaves - 1) * n * n * 4
    return nbytes, ops, counted, peak


def leaf_bucketing_phase(torch, gars, kernels, models, runner, card):
    """The bucketed granularity:leaf path on the card (``leaf_bucketing=
    True``, "auto" on a card); returns {batched(kernel): launches} of its
    runs and the kernels line's rows of the batched forms.

    - B1: each batched kernel against its batched plain version (``compare``'s
      tolerances, leaf by leaf) at cnnet's buckets and ResNet-50's largest,
      a NaN row and ties in each; K3-K6 and the centring bit for bit against
      L unbatched launches; one batched launch a call; timed at (11, n,
      262,144) by CUDA events (the call) and torch.profiler (the card),
      beside the batched plain version, one library call (torch.cdist on the
      stack, torch.kthvalue and torch.nanmean along the rows) and the bound.
    - B2: cnnet + krum (n = 8, f = 2, signflip, worker metrics, reputation
      0.5, quarantine 0.4) per leaf, 5 steps bucketed and 5 through the loop
      from one init: participation, reputation and quarantine identical,
      parameters within the options phase's rtol 1e-4 / atol 1e-5; K1
      batched once a leaf size (9 a step) against once a leaf (14); steps/s
      and GAR ms a step each way.
    - B3: krum at n = 72 on cnnet's leaves: the batched centring and K2 (9
      a call against 14), participation identical, aggregates within rtol
      1e-5 / atol 1e-6; GAR ms each way.
    - B4: config 3 (ResNet-50 digits32 + Bulyan, n = 32, f = 7, batch 16)
      through the runner per leaf, 3 steps each way: K1 and K4 batched 22
      times a step against 161 unbatched; ms a step each way.
    - B5: median, trimmed-mean and average-nan per leaf on cnnet (n = 8),
      2 steps bucketed against the loop: K3, K5 and K6 batched 9 times a
      step."""
    import collections

    from aggregathor_tpu_torch.core import FlatMap, build_optimizer, build_schedule
    from aggregathor_tpu_torch.parallel import RobustEngine, attacks
    from aggregathor_tpu_torch.parallel.engine import gar_key

    begin = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(20261018)
    cnnet = models.instantiate("cnnet", [])
    slices = FlatMap(cnnet.init(0)).slices
    cnnet_buckets = sorted((count, size) for size, count in
                           collections.Counter(size for _, _, _, size, _, _ in slices).items())
    nb_sizes = len(cnnet_buckets)
    totals = zero_counts(kernels)
    library = {"pairwise_sq_distances": lambda x: torch.cdist(x, x).square(),
               "pairwise_sq_distances_gram": lambda x: torch.cdist(x, x).square(),
               "coordinate_median": lambda x: torch.kthvalue(x, x.shape[1] // 2 + 1, dim=1).values,
               "average_nan_columns": lambda x: torch.nanmean(x, 1)}

    # B1: the batched kernels on their own
    rows = []
    for name, (cnnet_rows, resnet_rows) in LEAF_ROWS.items():
        form, plain = kernels.BATCHED[name]
        errors, held = [], 0
        for buckets, n in ((cnnet_buckets, cnnet_rows), (LEAF_RESNET_BUCKETS, resnet_rows)):
            for leaves, width in buckets:
                x = _leaf_stack(torch, gen, leaves, n, width)
                args = LEAF_ARGS.get(name, {}).get(n, ())
                kernels.reset_launch_counts()
                got, args = _batched_call(kernels, name, x, args)
                torch.cuda.synchronize()
                check(kernels.batched_launch_counts()[name] == 1 and not any(kernels.launch_counts().values()),
                      "B1 %s (%d, %d, %d): not one batched launch" % (name, leaves, n, width))
                want = plain(x, *args)
                for b in range(leaves):
                    errors.append(compare(name, got[b], want[b], torch, x[b], tuple(a[b] for a in args
                                                                                    if torch.is_tensor(a))))
                if name not in ("pairwise_sq_distances", "pairwise_sq_distances_gram"):
                    one_by_one = torch.stack([getattr(kernels, name)(x[b], *args) for b in range(leaves)])
                    check(torch.equal(got.view(torch.int32), one_by_one.view(torch.int32)),
                          "B1 %s (%d, %d, %d): not the bits of %d unbatched launches"
                          % (name, leaves, n, width, leaves))
                held += leaves
                del x, got, want
        leaves, width = LEAF_RESNET_BUCKETS[-1]
        n = resnet_rows
        x = _leaf_stack(torch, gen, leaves, n, width)
        _, args = _batched_call(kernels, name, x, LEAF_ARGS.get(name, {}).get(n, ()))
        info = kernels.KERNELS[name]
        ms = time_ms(lambda: form(x, *args), torch, iters=20, warmup=5)
        card_ms = device_ms(lambda: form(x, *args), torch)
        plain_ms = time_ms(lambda: plain(x, *args), torch, iters=5, warmup=1)
        library_ms = time_ms(lambda: library[name](x), torch, iters=5) if name in library else None
        nbytes, ops, counted, peak = _batched_bounds(kernels, name, leaves, n, width)
        bytes_ms, ops_ms = nbytes / MEMORY_BYTES_PER_S * 1e3, ops / peak * 1e3
        row = {"name": batched(name), "route": "cuda", "source": info.source, "replaces": info.replaces,
               "launches": 0, "max_abs_err": max(errors), "ms": ms, "device_ms": card_ms, "plain_ms": plain_ms,
               "bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
               "library_ms": library_ms, "shape": [leaves, n, width], "operations": ops, "operations_ms": ops_ms,
               "operations_counted": counted, "operations_per_s": peak}
        rows.append(row)
        print("batched kernel %-27s %s (%d, %d, %d): %.4f ms (on the card %s ms), batched plain %.3f ms, library %s "
              "ms, bound %.1f us (%s), max |err| %g over %d leaves held; K3-K6 and the centring bit for bit against "
              "unbatched launches; on %s"
              % (name, info.label, leaves, n, width, ms, "not measured" if card_ms is None else "%.4f" % card_ms,
                 plain_ms, "-" if library_ms is None else "%.3f" % library_ms, row["bound_ms"] * 1e3, row["bound_by"],
                 row["max_abs_err"], held, card))
        del x
    torch.cuda.empty_cache()

    # B2: cnnet + krum per leaf, bucketed and through the loop, from one init
    def cnnet_run(rule, n, f, bucketing, steps, **options):
        tx = build_optimizer("sgd", build_schedule("fixed", ["initial-rate:0.05"]))
        engine = RobustEngine(gars.instantiate(rule, n, f), n, granularity="leaf", leaf_bucketing=bucketing,
                              device="cuda", **options)
        state = engine.init_state(cnnet.init(1), tx, seed=3)
        step = engine.build_step(cnnet.loss, tx)
        it = cnnet.make_train_iterator(n, seed=4)
        batches = [engine.put_batch(next(it)) for _ in range(steps)]
        kernels.reset_launch_counts()
        trail, start = [], None
        for k, batch in enumerate(batches):
            if k == 1:
                torch.cuda.synchronize()
                start = time.perf_counter()
            state, metrics = step(state, batch)
            trail.append({name: value.cpu() for name, value in metrics.items() if name.startswith("worker_")
                          or name == "nb_quarantined"})
        torch.cuda.synchronize()
        steps_per_s = (steps - 1) / (time.perf_counter() - start)
        counts = (kernels.launch_counts(), kernels.batched_launch_counts())
        return trail, torch.cat([p.detach().reshape(-1) for p in state.params.values()]), steps_per_s, counts

    krum_options = dict(nb_real_byz=2, attack=attacks.instantiate("signflip", 8, 2), worker_metrics=True,
                        reputation_decay=0.5, quarantine_threshold=0.4)
    bucket_trail, bucket_params, bucket_rate, (unbatched, batched_counts) = cnnet_run(
        "krum", 8, 2, "auto", LEAF_STEPS, **krum_options)
    check(not any(unbatched.values()) and batched_counts == {
        name: LEAF_STEPS * nb_sizes * (name == "pairwise_sq_distances") for name in batched_counts},
        "B2: bucketed launches %s, batched %s (want K1 batched %d a step)" % (unbatched, batched_counts, nb_sizes))
    for name, count in batched_counts.items():
        totals[batched(name)] += count
    loop_trail, loop_params, loop_rate, (loop_counts, _) = cnnet_run("krum", 8, 2, False, LEAF_STEPS, **krum_options)
    check(loop_counts["pairwise_sq_distances"] == LEAF_STEPS * len(slices),
          "B2: the loop launched K1 %d times (want %d)"
          % (loop_counts["pairwise_sq_distances"], LEAF_STEPS * len(slices)))
    for k, (a, b) in enumerate(zip(bucket_trail, loop_trail)):
        for name in ("worker_participation", "worker_reputation", "nb_quarantined"):
            check(torch.equal(a[name], b[name]), "B2 step %d: %s %s bucketed, %s per leaf"
                  % (k, name, a[name].tolist(), b[name].tolist()))
    check(bool(torch.allclose(bucket_params, loop_params, rtol=1e-4, atol=1e-5)),
          "B2: parameters differ (max %g)" % float((bucket_params - loop_params).abs().max()))
    flatmap = FlatMap(cnnet.init(0))
    gar_ms = {}
    with torch.no_grad():
        for n, f in ((8, 2), (72, 8)):
            x = torch.randn((n, CNNET_D), device="cuda", generator=gen)
            x[n // 2] = float("nan")
            engine = RobustEngine(gars.instantiate("krum", n, f), n, granularity="leaf", worker_metrics=True,
                                  device="cuda")
            key = gar_key(1, 0)
            outs = {}
            for way, fn in (("bucketed", engine._aggregate_per_leaf_bucketed), ("loop", engine._aggregate_per_leaf)):
                kernels.reset_launch_counts()
                outs[way] = fn(x, flatmap, None, key)
                torch.cuda.synchronize()
                outs[way + " counts"] = (kernels.launch_counts(), kernels.batched_launch_counts())
                gar_ms["krum n=%d %s" % (n, way)] = time_ms(lambda: fn(x, flatmap, None, key), torch, iters=10)
            if n == 72:
                # B3: the batched centring and K2 on every leaf size
                unbatched, batched_counts = outs["bucketed counts"]
                check(not any(unbatched.values()) and batched_counts == {
                    name: nb_sizes * (name in ("pairwise_sq_distances_gram", "nanmedian_columns"))
                    for name in batched_counts}, "B3: launches %s, batched %s" % (unbatched, batched_counts))
                for name, count in batched_counts.items():
                    totals[batched(name)] += count
                check(outs["loop counts"][0]["pairwise_sq_distances_gram"] == len(slices), "B3: the loop's K2 launches")
            (agg, part, wdist, _), (want, want_part, want_wdist, _) = outs["bucketed"], outs["loop"]
            check(torch.equal(part, want_part), "B3 n=%d: participation %s bucketed, %s per leaf"
                  % (n, part.tolist(), want_part.tolist()))
            check(bool(torch.allclose(agg, want, rtol=1e-5, atol=1e-6)) and bool(torch.allclose(
                wdist, want_wdist, rtol=1e-5, atol=1e-6, equal_nan=True)),
                "B3 n=%d: aggregate or worker distances differ (max %g)" % (n, float((agg - want).abs().max())))
            del x, outs, agg, want
    print("B2 cnnet+krum granularity:leaf n=8 on %s: %d steps bucketed (K1 batched %d a step) %.3f steps/s excl. 1st, "
          "per-leaf loop (K1 %d a step) %.3f steps/s; participation, reputation and quarantine identical, parameters "
          "within %.3g; B3 krum n=72 (centring and K2 batched %d a call against %d): participation identical; GAR ms a "
          "step %s" % (card, LEAF_STEPS, nb_sizes, bucket_rate, len(slices), loop_rate,
                       float((bucket_params - loop_params).abs().max()), nb_sizes, len(slices),
                       json.dumps(gar_ms, sort_keys=True)))
    torch.cuda.empty_cache()

    # B5: the coordinate-wise rules bucketed against the loop, 2 steps
    for rule, name in (("median", "coordinate_median"), ("trimmed-mean", "coordinate_trimmed_mean"),
                       ("average-nan", "average_nan_columns")):
        _, params, _, (unbatched, batched_counts) = cnnet_run(rule, 8, 2, True, 2)
        check(not any(unbatched.values()) and batched_counts == {k: 2 * nb_sizes * (k == name) for k in batched_counts},
              "B5 %s: launches %s, batched %s" % (rule, unbatched, batched_counts))
        totals[batched(name)] += batched_counts[name]
        _, want, _, _ = cnnet_run(rule, 8, 2, False, 2)
        check(bool(torch.allclose(params, want, rtol=1e-4, atol=1e-5)), "B5 %s: parameters differ" % rule)
    print("B5 median, trimmed-mean, average-nan per leaf on cnnet n=8: K3, K5, K6 batched %d a step, parameters within "
          "rtol 1e-4 / atol 1e-5 of the loop" % nb_sizes)

    # B4: config 3 through the runner, bucketed and through the loop
    zoo = "slim-resnet_v1_50-digits32"
    zoo_slices = FlatMap(models.instantiate(zoo, ["batch-size:16", "preprocessing:none"]).init(0)).slices
    zoo_sizes = len({size for _, _, _, size, _, _ in zoo_slices})
    argv = ["--experiment", zoo, "--experiment-args", "batch-size:16", "preprocessing:none", *ZOO_BULYAN,
            "--granularity", "leaf", "--max-step", str(LEAF_ZOO_STEPS), "--evaluation-period", "-1",
            "--evaluation-delta", "-1", "--seed", "1"]
    zoo_results = {}
    for way, flag in (("bucketed", "auto"), ("loop", "off")):
        result = runner.main(argv + ["--leaf-bucketing", flag])
        zoo_results[way] = result
        check(result["steps"] == LEAF_ZOO_STEPS and math.isfinite(result["final_loss"]), "B4 %s: run" % way)
        per_leaf = zoo_sizes if way == "bucketed" else len(zoo_slices)
        launched = result["batched_launches"] if way == "bucketed" else result["launches"]
        other = result["launches"] if way == "bucketed" else result["batched_launches"]
        for name in kernels.KERNELS:
            want = LEAF_ZOO_STEPS * per_leaf * (name in ("pairwise_sq_distances", "coordinate_averaged_median"))
            check(launched[name] == want and other[name] == 0, "B4 %s: %s launched %d (want %d), other form %d"
                  % (way, name, launched[name], want, other[name]))
        if way == "bucketed":
            for name, count in result["batched_launches"].items():
                totals[batched(name)] += count
    a, b = zoo_results["bucketed"]["final_loss"], zoo_results["loop"]["final_loss"]
    check(abs(a - b) <= LEAF_ZOO_LOSS_RTOL * abs(b), "B4: final loss %g bucketed, %g per leaf" % (a, b))
    print("B4 config 3 %s + bulyan n=%d f=%d batch 16 granularity:leaf (%d leaves, %d sizes) on %s: bucketed %.1f ms a "
          "step excl. 1st (K1 and K4 batched %d a step), per-leaf loop %.1f ms (%d a step); final loss %.6f vs %.6f"
          % (zoo, ZOO_N, ZOO_F, len(zoo_slices), zoo_sizes, card, 1e3 / zoo_results["bucketed"]["steps_per_s"],
             zoo_sizes, 1e3 / zoo_results["loop"]["steps_per_s"], len(zoo_slices), a, b))
    torch.cuda.empty_cache()
    print("leaf bucketing phase: %.1f s" % (time.perf_counter() - begin))
    return totals, rows


def gar_phase(torch, gars, models):
    """Each rule's ms on the cnnet-width matrix (the per-layer metric: GAR ms
    a step); then the engine's aggregation of krum at n = 8 and 128 on the
    whole rows (vector) and per parameter leaf (leaf, 14 leaves), and the
    O(n d) passes of the worker metrics (each worker's squared distance to
    the aggregate) and of the reputation (the same on the raw rows), each
    alone."""
    from aggregathor_tpu_torch.core import FlatMap
    from aggregathor_tpu_torch.parallel import RobustEngine

    gen = torch.Generator(device="cuda").manual_seed(5)
    out = {}
    for rule, n, f in (("krum", 8, 2), ("bulyan", 11, 2), ("median", 8, 2), ("trimmed-mean", 8, 2),
                       ("averaged-median", 8, 2), ("average", 8, 2), ("average-nan", 8, 2),
                       ("krum", 128, 8), ("bulyan", 128, 8), ("median", 128, 8), ("trimmed-mean", 128, 8)):
        x = torch.randn((n, CNNET_D), device="cuda", generator=gen)
        gar = gars.instantiate(rule, n, f)
        out["%s n=%d" % (rule, n)] = time_ms(lambda: gar.aggregate(x), torch, iters=10)
        del x
    print("GAR ms per step at d=%d: %s" % (CNNET_D, json.dumps(out, sort_keys=True)))
    flatmap = FlatMap(models.instantiate("cnnet", []).init(0))
    passes = {}
    with torch.no_grad():
        for n, f in ((8, 2), (128, 8)):
            x = torch.randn((n, CNNET_D), device="cuda", generator=gen)
            vector = RobustEngine(gars.instantiate("krum", n, f), n, device="cuda")
            leaf = RobustEngine(gars.instantiate("krum", n, f), n, granularity="leaf", device="cuda")
            passes["krum n=%d vector" % n] = time_ms(lambda: vector._aggregate_vector(x, None), torch, iters=10)
            passes["krum n=%d leaf" % n] = time_ms(lambda: leaf._aggregate_per_leaf(x, flatmap, None), torch, iters=10)
            agg = x[0].clone()
            metrics = RobustEngine(gars.instantiate("krum", n, f), n, worker_metrics=True, device="cuda")
            reputation = RobustEngine(gars.instantiate("krum", n, f), n, reputation_decay=0.5, device="cuda")
            passes["worker_metrics pass n=%d" % n] = time_ms(lambda: metrics._sq_dists(x, x, agg), torch, iters=10)
            passes["reputation pass n=%d" % n] = time_ms(lambda: reputation._sq_dists(x, x, agg), torch, iters=10)
            del x, agg
    print("engine aggregation ms per step at d=%d (vector: the whole rows, leaf: %d leaves), and the worker-metric "
          "and reputation passes: %s" % (CNNET_D, len(flatmap.slices), json.dumps(passes, sort_keys=True)))
    out.update(passes)
    torch.cuda.empty_cache()
    return out


#: aggregates of the card against the CPU: the one-pass and selecting rules
#: (bucketing, hier and tree over median, averaged-median, trimmed-mean,
#: average-nan and krum; dnc) within 1e-5 at unit scale, and the iterative
#: rules (centered-clip, geometric-median/rfa: sums of n rows in another
#: order, each iteration from the last) too: measured at most 2.4e-7 for
#: either kind on an NVIDIA H100 80GB HBM3 at 700 W (centered-clip 1.2e-7,
#: geometric-median and rfa 2.4e-7)
EXTENSION_TOL = 1e-5
ITERATIVE_TOL = 1e-5
ITERATIVE = ("centered-clip", "geometric-median", "rfa")
#: rounds of the GAR timings, each over every spec
GAR_TIME_ROUNDS = 2

#: (spec, n, f) held on the card against the CPU with NaN rows, each with
#: the kernels it reaches there
EXTENSION_SPECS = [
    ("bucketing:s=2,inner=krum", 16, 2),
    ("bucketing:s=3,inner=krum", 16, 2),
    ("hier:g=4,inner=median,outer=krum", 32, 2),
    ("hier:g=8,inner=median,outer=krum", 128, 8),
    ("tree:g=4x2,rules=median>median>krum,link=bf16", 128, 4),
    ("tree:g=4x2,rules=median>average-nan>krum", 128, 2),
    ("hier:g=4,inner=averaged-median,outer=krum", 32, 2),     # K4
    ("tree:g=4x2,rules=trimmed-mean>average-nan>krum", 128, 1),  # K5 and K6
]

_CNNET_LEG = ["--nb-decl-byz-workers", "2", "--nb-real-byz-workers", "2", "--attack", "signflip", "--max-step", "5",
              "--evaluation-delta", "-1"]
#: (label, runner arguments, {kernel: launches a step}) at cnnet's width
EXTENSION_LEGS = [
    ("cnnet+centered-clip", ["--aggregator", "centered-clip", "--nb-workers", "8", *_CNNET_LEG],
     {"nanmedian_columns": 1}),
    ("cnnet+rfa+worker-metrics", ["--aggregator", "rfa", "--nb-workers", "8", "--worker-metrics", *_CNNET_LEG],
     {"nanmedian_columns": 1}),
    ("cnnet+dnc", ["--aggregator", "dnc", "--nb-workers", "8", *_CNNET_LEG], {}),
    ("cnnet+bucketing", ["--aggregator", "bucketing:s=2,inner=krum", "--nb-workers", "16", "--unroll", "5",
                         *_CNNET_LEG], {"nanmedian_columns": 1, "pairwise_sq_distances_gram": 1}),
    ("cnnet+hier", ["--aggregator", "hier:g=4,inner=median,outer=krum", "--nb-workers", "32", *_CNNET_LEG],
     {"coordinate_median": 1, "nanmedian_columns": 1, "pairwise_sq_distances_gram": 1}),
    ("cnnet+tree", ["--aggregator", "tree:g=4x2,rules=median>median>krum", "--nb-workers", "64", *_CNNET_LEG],
     {"coordinate_median": 2, "nanmedian_columns": 1, "pairwise_sq_distances_gram": 1}),
    ("cnnet+centered-clip+UDP", ["--aggregator", "centered-clip", "--nb-workers", "8", "--nb-decl-byz-workers", "2",
                                 "--UDP", "2", "--max-step", "5", "--evaluation-delta", "-1"],
     {"nanmedian_columns": 1}),
    ("cnnet+krum-native", ["--aggregator", "krum-native", "--nb-workers", "8", *_CNNET_LEG],
     {"pairwise_sq_distances": 1}),
]


def gar_extensions_phase(torch, gars, kernels, runner, card, workdir, gar_ms):
    """The GAR extensions on the card.

    1. Each new rule and meta-rule spec on the card against the same rule on
       the CPU with the same key: ``reference_phase``'s poisoned (11, 3001)
       matrix with a dead row (dnc with a colluding signal, where its
       selection is decisive), and ``EXTENSION_SPECS`` with NaN rows at
       d = 3001: the same NaN pattern, the participation's support
       identical, the aggregates within ``EXTENSION_TOL`` (``ITERATIVE_TOL``
       for the iterative rules).  A ``*-native`` name's dense aggregate
       runs on the host, so there the card tier the engine runs for it
       (K1 and the rule, or a coordinate kernel) is held against the host
       library, on the poisoned matrix and on clean rows.
    2. ``EXTENSION_LEGS`` through the runner at cnnet's width, 5 steps:
       finite losses and exactly the launches a step each spec implies;
       the bucketing leg twice and resumed (2 + 3 steps), under cuDNN's
       deterministic algorithms: the same bits at step 5.
    3. GAR ms a step at cnnet's width (CUDA events; the median of
       ``GAR_TIME_ROUNDS`` rounds, each read printed) for every new rule and
       spec, beside ``gar_phase``'s krum and bulyan; krum-native's dense
       aggregate at n = 8 on the host; the n-sweep (``gars.scaling``) at
       n = 16, 32, 64, 128, its doc and verdict (reported, not gated).
    Returns {kernel: launches} of the legs."""
    import contextlib
    import io

    from aggregathor_tpu_torch.gars import scaling

    gen = torch.Generator().manual_seed(12)

    def agree(spec, x, f, key=7):
        gar = gars.instantiate(spec, x.shape[0], f)
        if spec.endswith("-native"):
            # the card tier the engine runs for the name (the inherited
            # _call_aggregate on K1's distances or a coordinate kernel)
            # against the host library the dense aggregate runs
            card = x.cuda()
            dist2 = torch.clamp_min(kernels.pairwise_sq_distances(card), 0.0) if gar.needs_distances else None
            got, want, parts = gar._call_aggregate(card, dist2).cpu(), gar.aggregate(x), (None, None)
        else:
            got, part_card = gar.aggregate_block_and_participation(x.cuda(), None, key=key)
            want, part_cpu = gar.aggregate_block_and_participation(x, None, key=key)
            got, parts = got.cpu(), (None if part_card is None else part_card.cpu(), part_cpu)
            check(torch.equal(gar.aggregate(x.cuda(), key=key).cpu().view(torch.int32), got.view(torch.int32)),
                  "%s: aggregate and its pair differ" % spec)
        check(torch.equal(torch.isnan(got), torch.isnan(want)), "%s: NaN pattern differs from the CPU" % spec)
        finite = torch.isfinite(want)
        err = float(torch.max(torch.abs(got[finite] - want[finite]))) if bool(finite.any()) else 0.0
        tol = ITERATIVE_TOL if spec.split(":")[0] in ITERATIVE else EXTENSION_TOL
        check(bool(torch.allclose(got[finite], want[finite], rtol=tol, atol=tol)),
              "%s: aggregate differs from the CPU (max %g)" % (spec, err))
        if parts[1] is not None:
            check(parts[0] is not None and torch.equal(parts[0] > 0, parts[1] > 0),
                  "%s: participation's support differs from the CPU" % spec)
            check(bool(torch.allclose(parts[0], parts[1], rtol=tol, atol=1e-7)),
                  "%s: participation differs from the CPU" % spec)
        return err

    n, f, d = 11, 2, 3001
    x = poison(torch.randn((n, d), generator=gen), columns=False)
    x[4] = float("nan")
    clean = torch.randn((n, d), generator=gen)
    errors = {}
    for spec in ("centered-clip", "geometric-median", "rfa", "bucketing:s=2,inner=krum"):
        errors["%s n=%d" % (spec, n)] = agree(spec, x, f)
    # the poisoned rows leave average, krum and bulyan no finite value to
    # compare, so the native names are also held on clean rows
    for spec in ("average-native", "average-nan-native", "median-native", "averaged-median-native", "krum-native",
                 "bulyan-native"):
        errors["%s n=%d" % (spec, n)] = max(agree(spec, x, f), agree(spec, clean, f))
    collude = torch.randn((12, d), generator=gen)
    collude[:3] += 50.0 * torch.randn((1, d), generator=gen)
    collude[5, 7] = float("nan")
    errors["dnc n=12"] = agree("dnc", collude, 3)
    for spec, n, f in EXTENSION_SPECS:
        x = torch.randn((n, d), generator=gen) * (1.0 + 0.02 * torch.arange(float(n)))[:, None]
        x[: f] += 25.0
        x[n // 2] = float("nan")
        x[n - 3, 5::97] = float("inf")
        errors["%s n=%d" % (spec, n)] = agree(spec, x, f)
    print("extensions: card against CPU, max |err| of the aggregates: %s" % json.dumps(errors, sort_keys=True))

    totals = {name: 0 for name in kernels.KERNELS}

    def leg(label, argv, per_step, extra=()):
        kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        output = io.StringIO()
        with contextlib.redirect_stdout(output):
            result = runner.main(["--experiment", "cnnet", "--seed", "1", "--evaluation-period", "-1",
                                  "--summary-dir", os.path.join(workdir, "extensions", label), *argv, *extra])
        counts = kernels.launch_counts()
        steps = result["steps"]
        check(result["final_loss"] is not None and math.isfinite(result["final_loss"]), "%s: non-finite loss" % label)
        for name in kernels.KERNELS:
            want = steps * per_step.get(name, 0)
            check(counts[name] == want, "%s: %s launched %d times in %d steps (want %d)"
                  % (label, name, counts[name], steps, want))
            totals[name] += counts[name]
        print("leg %-26s %d steps, %.3f steps/s excl. 1st on %s, final loss %.4f, peak %.0f MB, launches %s"
              % (label, steps, result["steps_per_s"], card, result["final_loss"],
                 torch.cuda.max_memory_allocated() / 2**20, json.dumps(counts, sort_keys=True)))
        return result

    for label, argv, per_step in EXTENSION_LEGS:
        if label != "cnnet+bucketing":
            leg(label, argv, per_step)
            continue
        # the key moves with the step inside a chunk; two runs repeat and a
        # resumed run ends with the uninterrupted run's bits
        torch.backends.cudnn.deterministic = True

        def final(name, max_step, extra_args=()):
            directory = os.path.join(workdir, "bucketing", name)
            leg("%s %s" % (label, name), argv, per_step, ["--checkpoint-dir", directory, "--checkpoint-period", "-1",
                                                          "--max-step", str(max_step), *extra_args])
            return torch.load(os.path.join(directory, "model-%d.ckpt" % max_step), weights_only=True)

        first, again = final("first", 5), final("again", 5)
        final("split", 2, ("--unroll", "1"))
        resumed = final("split", 5, ("--unroll", "1"))
        torch.backends.cudnn.deterministic = False
        for other, what in ((again, "a second run"), (resumed, "a run resumed at step 2")):
            for name, value in first["params"].items():
                check(torch.equal(value.view(torch.int32), other["params"][name].view(torch.int32)),
                      "cnnet+bucketing: %s differs from the first in %s" % (what, name))
        print("leg cnnet+bucketing: two runs and a run resumed at step 2 end with the same bits at step 5 "
              "(deterministic cuDNN)")

    reads = {}
    gen_card = torch.Generator(device="cuda").manual_seed(13)
    timed = [("centered-clip", 8, 2), ("rfa", 8, 2), ("dnc", 8, 2), ("bucketing:s=2,inner=krum", 16, 2),
             ("hier:g=4,inner=median,outer=krum", 32, 2), ("tree:g=4x2,rules=median>median>krum", 64, 2)]
    timed += [spec for spec in EXTENSION_SPECS if spec[:2] != ("bucketing:s=2,inner=krum", 16)
              and spec[:2] != ("hier:g=4,inner=median,outer=krum", 32)]
    with torch.no_grad():
        # GAR_TIME_ROUNDS rounds over every spec, each a mean of 10 calls:
        # the median is the spec's time and the spread says how far one
        # read can be trusted
        for _ in range(GAR_TIME_ROUNDS):
            for spec, n, f in timed:
                x = torch.randn((n, CNNET_D), device="cuda", generator=gen_card)
                gar = gars.instantiate(spec, n, f)
                reads.setdefault("%s n=%d" % (spec, n), []).append(time_ms(lambda: gar.aggregate(x, key=0), torch,
                                                                          iters=10))
                del x
        x = torch.randn((8, CNNET_D), device="cuda", generator=gen_card)
        host = gars.instantiate("krum-native", 8, 2)
        host.aggregate(x)
        begin = time.perf_counter()
        for _ in range(3):
            host.aggregate(x)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - begin) / 3 * 1e3
        del x
    ms = {label: statistics.median(values) for label, values in reads.items()}
    print("GAR ms per step at d=%d on %s: %s; beside gar_phase's krum n=8 %.4f, bulyan n=11 %.4f, krum n=128 %.4f, "
          "bulyan n=128 %.4f" % (CNNET_D, card, json.dumps(ms, sort_keys=True), gar_ms["krum n=8"],
                                 gar_ms["bulyan n=11"], gar_ms["krum n=128"], gar_ms["bulyan n=128"]))
    print("GAR ms per step, each of the %d rounds: %s" % (GAR_TIME_ROUNDS, json.dumps(reads, sort_keys=True)))
    print("host: krum-native's dense aggregate at (8, %d), the card's rows copied to the host and back: %.3f ms"
          % (CNNET_D, host_ms))
    torch.cuda.empty_cache()
    doc = scaling.run_sweep((16, 32, 64, 128), CNNET_D, reps=5, device="cuda")
    scaling.validate_scaling_doc(doc)
    print("n-sweep at d=%d on %s (schema %s):" % (CNNET_D, card, doc["schema"]))
    print(scaling.render_table(doc))
    print("n-sweep doc: %s" % json.dumps(doc, sort_keys=True))
    torch.cuda.empty_cache()
    return totals


def breakdown_phase(torch, gars, models, steps=4, experiment="cnnet", args=(), input_source="stream",
                    rule=("krum", 8, 2)):
    """Where a step's time goes (``rule`` = (name, n, f), r = f signflip;
    krum at n = 8, f = 2 and cnnet unless told otherwise), and how busy the
    card is.

    The phases are the engine's own step pieces, timed on the host clock with
    the card synchronized after each (so each phase's device work lands in
    it); the first step warms up and is not counted.  With the batches
    streamed, "host batch" is the iterator's numpy batch (cnnet: with the
    host augmentation) and "to device" its copy; with ``input_source``
    "device" (the train split on the card), "host batch" is the index draw
    on the CPU generators and its copy, and "to device" the gather on the
    card.  "augment" is the in-step augmentation (0 without one, and in a
    checkout that has none).  The busy share is the union of the card's
    kernel intervals over whole runner-like steps (batch production
    included), traced by torch.profiler, over their wall time."""
    from torch.profiler import ProfilerActivity, profile

    from aggregathor_tpu_torch.core import FlatMap, build_optimizer, build_schedule
    from aggregathor_tpu_torch.parallel import RobustEngine, attacks

    exp = models.instantiate(experiment, list(args))
    tx = build_optimizer("sgd", build_schedule("fixed", []))
    transform = getattr(exp, "device_transform", lambda: None)()
    rule_name, n, f = rule
    engine = RobustEngine(gars.instantiate(rule_name, n, f), n, nb_real_byz=f,
                          attack=attacks.instantiate("signflip", n, f), device="cuda",
                          **({"batch_transform": transform} if transform is not None else {}))
    state = engine.init_state(exp.init(1), tx, seed=1)
    flatmap = FlatMap(state.params)
    device_input = input_source == "device"
    if device_input:
        data = engine.replicate(exp.train_arrays())
        nb_examples = next(iter(data.values())).shape[0]
    else:
        it = exp.make_train_iterator(n, seed=2)
    augment = getattr(engine, "_augment", None)
    names = ("host batch", "to device", "augment", "worker gradients", "attack + aggregate", "update")
    totals = dict.fromkeys(names, 0.0)
    for s in range(steps + 1):
        marks = [time.perf_counter()]
        if device_input:
            index = engine._sample_indices(state.seed, state.step, nb_examples, exp.batch_size)
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            on_card = {key: value[index] for key, value in data.items()}
        else:
            batch = next(it)
            marks.append(time.perf_counter())
            on_card = engine.put_batch(batch)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        if augment is not None:
            on_card = augment(on_card, state.seed, state.step)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        _, rows = engine._worker_gradients(state.params, on_card, exp.loss, flatmap)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        with torch.no_grad():
            rows = engine._prepare_rows(engine._perturb_local(rows, state.seed, state.step)[0])
            rows = rows[0] if isinstance(rows, tuple) else rows  # (rows, raw rows) since the reputation
            agg = engine._aggregate_block(rows)
            agg = agg[0] if isinstance(agg, tuple) else agg  # (aggregate, participation) likewise
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            tx.apply(state.params, flatmap.inflate(agg), state.opt_state)
            state.step += 1
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
        if s:
            for name, start, end in zip(names, marks, marks[1:]):
                totals[name] += end - start
    per_step = {name: 1e3 * value / steps for name, value in totals.items()}

    if device_input:
        sampled = engine.build_sampled_multi_step(exp.loss, tx, 1, exp.batch_size)

        def one_step(state):
            state, metrics = sampled(state, data)
            return state, {"total_loss": metrics["total_loss"][-1]}
    else:
        step = engine.build_step(exp.loss, tx)

        def one_step(state):
            return step(state, engine.put_batch(next(it)))

    def run(count):
        nonlocal state
        start = time.perf_counter()
        for _ in range(count):
            state, metrics = one_step(state)
            float(metrics["total_loss"])
        torch.cuda.synchronize()
        return (time.perf_counter() - start) * 1e6

    step_us = run(steps) / steps  # untraced whole steps, the denominator of the busy share
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall_us = run(5)
    busy_us, nb_events = card_busy_us(torch, prof)
    intervals = nb_events
    busy = busy_us / 5 / step_us if intervals else None
    per_step["whole step"] = step_us / 1e3
    print("breakdown %s%s+%s n=%d %s input, ms/step over %d steps: %s; phases sum %.2f ms; whole step %.2f ms "
          "untraced; card busy %s ms/step over 5 traced steps (%.1f ms traced wall, torch.profiler, %d device "
          "events): busy share %s of the untraced step"
          % (experiment, "(%s)" % " ".join(args) if args else "", rule_name, n, input_source, steps,
             json.dumps({k: v for k, v in per_step.items() if k != "whole step"}),
             sum(v for k, v in per_step.items() if k != "whole step"), step_us / 1e3,
             "%.2f" % (busy_us / 5e3) if intervals else "not measured", wall_us / 1e3, nb_events,
             "%.3f" % busy if busy is not None else "not measured"))
    del state, engine
    torch.cuda.empty_cache()
    return per_step, busy


#: chaos_phase's schedules (``--chaos``): average-nan through a drop storm,
#: an empire coalition and stale stragglers, switching at CHAOS_SWITCHES;
#: and the calm -> always-late switch of JAX ``tests/test_chaos.py:207-227``
CHAOS_SCHEDULE = "0:calm 4:drop=0.3 8:attack=empire,epsilon=4.0 12:straggle=0.5,straggle-mode=stale"
CHAOS_SWITCHES = [4, 8, 12]
CHAOS_LATE = "0:calm 3:straggle=1.0,straggle-mode=drop"
#: (label, runner arguments, steps, the kernel launched once a step)
CHAOS_LEGS = [
    ("chaos average-nan", ["--aggregator", "average-nan", "--nb-real-byz-workers", "2", "--chaos", CHAOS_SCHEDULE,
                           "--chaos-args", "packet-coords:16250"], 16, "average_nan_columns"),
    ("chaos median late", ["--aggregator", "median", "--chaos", CHAOS_LATE, "--chaos-args", "straggle-workers:2"],
     10, "coordinate_median"),
]
#: the regimes timed alone at cnnet's width (average-nan, r = 2): ms a step against calm
#: chaos_phase's timed steps: (label, chaos schedule, --UDP 4 arguments)
CHAOS_TIMED = (("calm", None, None), ("drop=0.3", "0:drop=0.3", None),
               ("empire", "0:attack=empire,epsilon=4.0", None), ("stale 0.5", "0:straggle=0.5,straggle-mode=stale", None),
               ("UDP 4 at 0.3", None, ["drop-rate:0.3", "packet-coords:16250"]))


def _chaos_runner_leg(runner, kernels, label, experiment, exp_args, argv, steps, device, workdir):
    """One chaos leg through the runner on ``device`` (drawn on the device,
    a summary a step); returns (per-step losses, per-step regimes, switch
    events, stdout, launches)."""
    import contextlib
    import io

    directory = os.path.join(workdir, "%s-%s-%s" % (label.replace(" ", "_"), experiment, device))
    output = io.StringIO()
    kernels.reset_launch_counts()
    with contextlib.redirect_stdout(output):
        result = runner.main(["--experiment", experiment, "--experiment-args", *exp_args, "--seed", "1",
                              "--nb-workers", "8", "--nb-decl-byz-workers", "2", "--input-source", "device",
                              "--max-step", str(steps), "--evaluation-delta", "-1", "--evaluation-period", "-1",
                              "--summary-dir", directory, "--summary-delta", "1", "--device", device, *argv])
    counts = kernels.launch_counts()
    sys.stdout.write(output.getvalue())
    [name] = os.listdir(directory)
    events = [json.loads(line) for line in open(os.path.join(directory, name))]
    scalars = [e for e in events if "total_loss" in e]
    check([e["step"] for e in scalars] == list(range(1, steps + 1)), "%s: summary steps" % label)
    switches = [(e["step"], e["regime"]) for e in events if e.get("event") == "chaos_regime_switch"]
    check(result["steps"] == steps, "%s on %s: %d steps (want %d)" % (label, device, result["steps"], steps))
    return [e["total_loss"] for e in scalars], [e["chaos_regime"] for e in scalars], switches, output.getvalue(), counts


def _late_switch_losses(torch, gars, models, experiment, exp_args, device, steps=4):
    """build_step with average under CHAOS_LATE: (finite parameters after
    each step, the losses)."""
    from aggregathor_tpu_torch.chaos import ChaosSchedule
    from aggregathor_tpu_torch.core import build_optimizer, build_schedule
    from aggregathor_tpu_torch.parallel import RobustEngine

    exp = models.instantiate(experiment, exp_args)
    tx = build_optimizer("sgd", build_schedule("fixed", ["initial-rate:0.05"]))
    engine = RobustEngine(gars.instantiate("average", 8, 0), 8, chaos=ChaosSchedule(CHAOS_LATE, 8), device=device)
    state = engine.init_state(exp.init(1), tx, seed=1)
    step = engine.build_step(exp.loss, tx)
    it = exp.make_train_iterator(8, seed=2)
    finite, losses = [], []
    for _ in range(steps):
        state, metrics = step(state, engine.put_batch(next(it)))
        losses.append(float(metrics["total_loss"]))
        finite.append(all(bool(torch.all(torch.isfinite(p))) for p in state.params.values()))
    return finite, losses


def _same_losses(label, got, want, rtol=1e-5):
    """Per-step losses of the card and the CPU: the same non-finite steps,
    the finite ones within ``rtol`` relative; returns the largest difference."""
    worst = 0.0
    for step, (a, b) in enumerate(zip(got, want), 1):
        check(math.isfinite(a) == math.isfinite(b),
              "%s: step %d loss %r on the card, %r on the CPU" % (label, step, a, b))
        if math.isfinite(b):
            worst = max(worst, abs(a - b) / max(abs(b), 1e-30))
    check(len(got) == len(want) and worst <= rtol, "%s: card vs CPU losses off by %.3g (tolerance %g)"
          % (label, worst, rtol))
    return worst


def chaos_phase(torch, gars, kernels, models, runner, card, workdir):
    """The chaos schedule on the card (``--chaos``); returns {kernel: launches}.

    At cnnet's width, drawn on the card with its augmentation in the step:
    average-nan under CHAOS_SCHEDULE for 16 steps (finite, the regime log
    and ``chaos_regime_switch`` events at exactly CHAOS_SWITCHES, the
    summaries' regimes, K6 once a step), median under CHAOS_LATE with
    ``straggle-workers:2`` (finite, K3 once a step), and build_step with
    average under CHAOS_LATE (parameters finite through step 2, not at step
    3).  The same three on ``digits`` on the card and on the CPU: the masks
    come from CPU generators, so the losses agree within 1e-5 relative and
    the regimes exactly.  A micro campaign (``chaos.campaign.main``, digits,
    average and median x calm and empire, 25 steps) gives the same four
    verdicts on the card and the CPU.  Last, ms a step of each regime alone
    and of the ``--UDP 4`` link (the same masking as the storm) against calm
    at cnnet's width (average-nan, r = 2, one resident batch)."""
    from aggregathor_tpu_torch.chaos import ChaosSchedule, campaign
    from aggregathor_tpu_torch.core import build_optimizer, build_schedule
    from aggregathor_tpu_torch.parallel import RobustEngine
    from aggregathor_tpu_torch.parallel.lossy import LossyLink

    totals = {name: 0 for name in kernels.KERNELS}
    for label, argv, steps, kernel in CHAOS_LEGS:
        losses, regimes, switches, output, counts = _chaos_runner_leg(
            runner, kernels, label, "cnnet", ["augment:device"], argv, steps, "cuda", workdir)
        check(all(math.isfinite(v) for v in losses), "%s: non-finite loss %s" % (label, losses))
        for name in kernels.KERNELS:
            want = steps if name == kernel else 0
            check(counts[name] == want, "%s: %s launched %d times in %d steps (want %d)"
                  % (label, name, counts[name], steps, want))
            totals[name] += counts[name]
        r = int(argv[argv.index("--nb-real-byz-workers") + 1]) if "--nb-real-byz-workers" in argv else 0
        schedule = ChaosSchedule(argv[argv.index("--chaos") + 1], 8, nb_real_byz=r)
        check(regimes == [schedule.regime_at(s) for s in range(steps)], "%s: regimes %s" % (label, regimes))
        starts = [start for start, _ in schedule.transitions()[1:]]
        check([step for step, _ in switches] == starts, "%s: switch events at %s (want %s)" % (label, switches, starts))
        for start in starts:
            check("Chaos regime switch at step %d: now %s" % (start, schedule.describe(schedule.regime_at(start)))
                  in output, "%s: no regime log line at step %d" % (label, start))
        print("chaos leg %-18s cnnet on %s: %d steps, losses %s, regimes %s, switches %s, launches %s=%d"
              % (label, card, steps, ", ".join("%.4f" % v for v in losses), regimes, switches, kernel,
                 counts[kernel]))
    finite, losses = _late_switch_losses(torch, gars, models, "cnnet", [], "cuda")
    check(finite == [True, True, True, False], "build_step late switch on cnnet: finite after each step %s" % finite)
    print("chaos build_step average under %r on cnnet: parameters finite after steps 0-3 %s" % (CHAOS_LATE, finite))
    # digits on the card and on the CPU: the same masks, the same losses
    for label, argv, steps, kernel in CHAOS_LEGS:
        card_run = _chaos_runner_leg(runner, kernels, label, "digits", [], argv, steps, "cuda", workdir)
        cpu_run = _chaos_runner_leg(runner, kernels, label, "digits", [], argv, steps, "cpu", workdir)
        worst = _same_losses("digits " + label, card_run[0], cpu_run[0])
        check(card_run[1] == cpu_run[1] and card_run[2] == cpu_run[2], "digits %s: regimes or switches differ" % label)
        check(card_run[4][kernel] == steps and sum(card_run[4].values()) == steps,
              "digits %s: launches %s (want %s once a step)" % (label, card_run[4], kernel))
        totals[kernel] += card_run[4][kernel]
        print("chaos leg %-18s digits: card vs CPU losses within %.3g relative, regimes identical %s"
              % (label, worst, card_run[1]))
    late = {device: _late_switch_losses(torch, gars, models, "digits", [], device) for device in ("cuda", "cpu")}
    check(late["cuda"][0] == late["cpu"][0] == [True, True, True, False], "digits late switch: %s" % late)
    _same_losses("digits build_step late", late["cuda"][1], late["cpu"][1])
    # the micro campaign's verdicts, card and CPU
    verdicts = {}
    for device in ("cuda", "cpu"):
        path = os.path.join(workdir, "campaign-%s.json" % device)
        campaign.main(["--experiment", "digits", "--nb-workers", "8", "--nb-decl-byz-workers", "2",
                       "--nb-real-byz-workers", "2", "--gars", "average", "median", "--attacks", "empire,epsilon=4.0",
                       "--nb-steps", "25", "--output", path, "--device", device])
        matrix = json.load(open(path))
        check(matrix["schema"] == campaign.SCHEMA and len(matrix["cells"]) == 4, "campaign on %s: matrix" % device)
        verdicts[device] = {(c["gar"], c["scenario"]): (c["converged"], c["diverged"]) for c in matrix["cells"]}
    check(verdicts["cuda"] == verdicts["cpu"],
          "campaign verdicts card %s, CPU %s" % (verdicts["cuda"], verdicts["cpu"]))
    check(verdicts["cuda"][("median", "empire")] == (True, False) and not verdicts["cuda"][("average", "empire")][0],
          "campaign: median must converge and average fail under empire: %s" % verdicts["cuda"])
    print("chaos campaign digits 25 steps: verdicts (converged, diverged) on the card = on the CPU: %s"
          % sorted(verdicts["cuda"].items()))
    # each regime alone against calm, ms a step at cnnet's width
    exp = models.instantiate("cnnet", [])
    tx = build_optimizer("sgd", build_schedule("fixed", ["initial-rate:0.05"]))
    batch = next(exp.make_train_iterator(8, seed=2))
    timed = {}
    for label, spec, udp in CHAOS_TIMED:
        chaos = ChaosSchedule(spec, 8, nb_real_byz=2, args=["packet-coords:16250"]) if spec else None
        engine = RobustEngine(gars.instantiate("average-nan", 8, 2), 8, nb_real_byz=2 if chaos else 0, chaos=chaos,
                              lossy_link=LossyLink(4, udp) if udp else None, device="cuda")
        state = engine.init_state(exp.init(1), tx, seed=1)
        step = engine.build_step(exp.loss, tx)
        placed = engine.put_batch(batch)
        holder = {"state": state}

        def one():
            holder["state"], _ = step(holder["state"], placed)

        timed[label] = time_ms(one, torch, iters=8, warmup=2)
        del engine, state, holder
    print("chaos regimes alone, average-nan cnnet n=8 r=2, ms a step on %s: %s" % (card, ", ".join(
        "%s %.2f (x%.3f)" % (label, ms, ms / timed["calm"]) for label, ms in timed.items())))
    return totals


#: codec_phase's runner legs: cnnet + krum n = 8, r = 2 signflip, drawn on
#: the card, CODEC_STEPS steps each, under each wire
CODEC_STEPS = 10
CODEC_WIRES = ("f32", "int8:ef", "topk:frac=0.01,ef")


def _codec_rows(torch):
    """(8, d) float32 rows for the codec checks: unit normals poisoned (a
    NaN row, scattered +-inf and NaN, tied values, two equal rows), a row of
    half-way int8 quotients (scale 0.25 exactly) and a row whose largest
    magnitude, +-10, ties 30,000 times (more than top-k's 17,567)."""
    gen = torch.Generator().manual_seed(14)
    rows = poison(torch.randn((8, CNNET_D), generator=gen), columns=False)
    index = torch.arange(CNNET_D)
    rows[5] = ((index % 254).to(torch.float32) - 126.5) * 0.25
    rows[5, 0] = 127.0 * 0.25
    rows[3, 1000:31000] = torch.where(index[1000:31000] % 2 == 0, 10.0, -10.0)
    rows[3, 40000:50000] = 0.0
    return rows


def codec_phase(torch, kernels, runner, card, workdir):
    """The wire codecs on the card (``--exchange``); returns {kernel: launches}.

    On (8, 1,756,682) rows (``_codec_rows``): the int8 round trip and payload
    on the card equal the CPU's bit for bit; top-k at frac 0.01 (k = 17,567)
    keeps the CPU's indices, in its order, and values; the error-feedback
    image and residual equal the CPU's (NaN payloads aside: CUDA's arithmetic
    makes its own).  Each codec's encode and round trip
    timed by CUDA events beside its byte bound (int8 encode: 4d read, d + 4
    written a row; top-k: 4d read, 8k written; the round trip adds the
    decode's 4d written, and int8's d + 4 read).  Then cnnet + krum under
    each of CODEC_WIRES for CODEC_STEPS steps: finite losses, K1 once a
    step, ``bytes_on_wire_total`` grown by steps x n x bytes_per_row, and
    ms a step against the f32 wire."""
    from aggregathor_tpu_torch.obs import metrics as obs_metrics
    from aggregathor_tpu_torch.parallel import compress

    rows = _codec_rows(torch)
    residual = torch.randn((8, CNNET_D), generator=torch.Generator().manual_seed(15)) * 0.01
    cuda_rows, cuda_residual = rows.cuda(), residual.cuda()
    int8, topk = compress.Int8Codec(), compress.parse_exchange_spec("topk:frac=0.01,ef")[1]
    k = topk._k_for(CNNET_D)
    def same_bits(got, want):
        # a NaN's payload is the device's own (CUDA's arithmetic makes
        # 0x7fffffff where the CPU keeps its operand's): NaN at the same
        # places, every other value bit for bit
        got = got.cpu()
        if not got.is_floating_point():
            return torch.equal(got, want)
        nan = torch.isnan(want)
        return torch.equal(torch.isnan(got), nan) and torch.equal(got[~nan].view(torch.int32),
                                                                   want[~nan].view(torch.int32))

    for codec in (int8, topk):
        name = codec.spec()
        card_payload, cpu_payload = codec.encode(cuda_rows), codec.encode(rows)
        for key in cpu_payload:
            check(same_bits(card_payload[key], cpu_payload[key]),
                  "%s: the card's payload %r differs from the CPU's" % (name, key))
        image, new = codec.ef_roundtrip(cuda_rows, cuda_residual)
        want_image, want_new = codec.ef_roundtrip(rows, residual)
        check(same_bits(image, want_image), "%s: the card's error-feedback image differs from the CPU's" % name)
        check(same_bits(new, want_new), "%s: the card's error-feedback residual differs from the CPU's" % name)
    kept = topk.encode(cuda_rows)["i"].cpu()
    check(kept[3].tolist() == list(range(1000, 1000 + k)), "topk: the tied +-10 run kept %s..." % kept[3, :4].tolist())
    check(kept[4].tolist() == torch.nonzero(torch.isnan(rows[4]))[:k, 0].tolist(),
          "topk: the NaN row kept other indices than its first k NaN")
    check(torch.equal(int8.encode(cuda_rows)["q"][5, 1:254].cpu(),
                      torch.round(torch.arange(1, 254, dtype=torch.float32) - 126.5).to(torch.int8)),
          "int8: the half-way quotients did not round to even")
    print("codecs on %s: int8 and topk (k=%d) payloads, images and error-feedback residuals at (8, %d) "
          "bit-identical to the CPU's (NaN/+-inf rows, half-way quotients, a 30,000-long tie at the cut)"
          % (card, k, CNNET_D))
    n, d = 8, CNNET_D
    bounds_bytes = {
        "int8 encode": n * (4 * d + d + 4), "int8 roundtrip": n * (4 * d + 2 * (d + 4) + 4 * d),
        "topk encode": n * (4 * d + 8 * k), "topk roundtrip": n * (4 * d + 8 * k + 8 * k + 4 * d),
    }
    times = {
        "int8 encode": time_ms(lambda: int8.encode(cuda_rows), torch),
        "int8 roundtrip": time_ms(lambda: int8.roundtrip(cuda_rows), torch),
        "topk encode": time_ms(lambda: topk.encode(cuda_rows), torch),
        "topk roundtrip": time_ms(lambda: topk.roundtrip(cuda_rows), torch),
    }
    del cuda_rows, cuda_residual, image, new, card_payload
    base = ["--experiment", "cnnet", "--experiment-args", "augment:device", "--input-source", "device", "--seed", "1",
            "--aggregator", "krum", "--nb-workers", "8", "--nb-decl-byz-workers", "2", "--nb-real-byz-workers", "2",
            "--attack", "signflip", "--max-step", str(CODEC_STEPS), "--evaluation-delta", "-1",
            "--evaluation-period", "-1"]
    totals = {name: 0 for name in kernels.KERNELS}
    step_ms = {}
    for wire in CODEC_WIRES:
        before = obs_metrics.REGISTRY.snapshot().get("bytes_on_wire_total", 0.0)
        kernels.reset_launch_counts()
        result = runner.main(base + ["--exchange", wire])
        counts = kernels.launch_counts()
        grown = obs_metrics.REGISTRY.snapshot()["bytes_on_wire_total"] - before
        check(math.isfinite(result["final_loss"]), "codec %s: non-finite loss" % wire)
        for name in kernels.KERNELS:
            want = CODEC_STEPS if name == "pairwise_sq_distances" else 0
            check(counts[name] == want, "codec %s: %s launched %d times (want %d)" % (wire, name, counts[name], want))
            totals[name] += counts[name]
        _, codec = compress.parse_exchange_spec(wire)
        want_bytes = CODEC_STEPS * n * compress.bytes_per_row(d, codec=codec)
        check(grown == want_bytes, "codec %s: bytes_on_wire_total grew %d (want %d)" % (wire, grown, want_bytes))
        step_ms[wire] = 1e3 / result["steps_per_s"]
        print("codec leg %-18s cnnet+krum on %s: %d steps, final loss %.4f, %.2f ms a step excl. 1st, wire %d bytes "
              "(%.2fx), launches K1=%d" % (wire, card, CODEC_STEPS, result["final_loss"], step_ms[wire], grown,
                                          compress.compression_ratio(d, codec=codec), counts["pairwise_sq_distances"]))
    print("codec times at (8, %d) on %s (CUDA events; bound = bytes / %.2f TB/s): %s; step ms against the f32 wire "
          "(%.2f): %s" % (d, card, MEMORY_BYTES_PER_S / 1e12, ", ".join(
              "%s %.4f ms (bound %.4f)" % (label, ms, bounds_bytes[label] / MEMORY_BYTES_PER_S * 1e3)
              for label, ms in times.items()), step_ms["f32"], ", ".join(
              "%s %.2f (x%.3f)" % (wire, step_ms[wire], step_ms[wire] / step_ms["f32"]) for wire in CODEC_WIRES[1:])))
    return totals



#: bounded_phase: cnnet at its published width, n = 8, f = 2, batch 128,
#: streamed; the first round's loss of the synchronous protocol against the
#: fused step within BOUNDED_LOSS_RTOL relative: the same weights and
#: batches, but one worker's forward alone against the eight vmapped, whose
#: convolutions and cross-entropy means sum in other orders (float32, a few
#: ulps of each worker's loss)
BOUNDED_ROUNDS = 4
BOUNDED_LOSS_RTOL = 1e-5
BOUNDED_KERNELS = {"krum": "pairwise_sq_distances", "median": "coordinate_median",
                   "trimmed-mean": "coordinate_trimmed_mean", "average-nan": "average_nan_columns"}
#: the stragglers of legs C and D: the deadline is many times a warm
#: round's honest arrivals (leg B prints a round's ms), so a host stall of a
#: few hundred ms does not time out an honest worker; the stall is four
#: deadlines, so workers 0-1 sit out every warm round of a leg
BOUNDED_STRAGGLERS = ["--chaos", "0:straggle=1.0", "--chaos-args", "straggle-workers:2", "--straggler-stall", "4.0",
                      "--step-deadline", "1.0"]


def _bounded_stack(torch, gars, models, rule, lr=0.05, **engine_kw):
    """(experiment, optimizer, engine on the card) for cnnet + ``rule``, n = 8, f = 2."""
    from aggregathor_tpu_torch.core import build_optimizer, build_schedule
    from aggregathor_tpu_torch.parallel import RobustEngine

    exp = models.instantiate("cnnet", [])
    tx = build_optimizer("sgd", build_schedule("fixed", ["initial-rate:%s" % lr]))
    return exp, tx, RobustEngine(gars.instantiate(rule, 8, 2), 8, device=engine_kw.pop("device", "cuda"),
                                 **engine_kw)


def _bounded_rounds(torch, step, state, batches):
    """Run ``step`` over the placed ``batches``; per round (ms to the round's
    end on the card, ms from its close to the update's end, metrics)."""
    out = []
    for batch in batches:
        begin = time.monotonic()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        end = time.monotonic()
        closed = getattr(step, "last_closed_at", None)
        out.append(((end - begin) * 1e3, (end - closed) * 1e3 if closed else None, metrics))
    return state, out


def _bounded_runner_leg(runner, kernels, label, argv, workdir, steps):
    """One bounded-wait leg of cnnet through the runner (streamed, n = 8,
    f = 2), with its journal and forensics report; returns (result, journal
    records, forensics report, launches)."""
    from aggregathor_tpu_torch.obs import events

    directory = os.path.join(workdir, "bounded-%s" % label)
    os.makedirs(directory)
    kernels.reset_launch_counts()
    result = runner.main(["--experiment", "cnnet", "--seed", "1", "--nb-workers", "8", "--nb-decl-byz-workers", "2",
                          "--max-step", str(steps), "--evaluation-delta", "-1", "--evaluation-period", "-1",
                          "--journal", os.path.join(directory, "j.jsonl"),
                          "--forensics", os.path.join(directory, "f.json"), *argv])
    counts = kernels.launch_counts()
    check(result["steps"] == steps and result["final_loss"] is not None and math.isfinite(result["final_loss"]),
          "bounded %s: %s steps, final loss %s" % (label, result["steps"], result["final_loss"]))
    return (result, events.load_journal(os.path.join(directory, "j.jsonl")),
            json.load(open(os.path.join(directory, "f.json"))), counts)


def bounded_phase(torch, gars, kernels, models, runner, card, workdir):
    """Bounded-wait on the card (``--step-deadline``); returns {kernel: launches}.

    cnnet at d = 1,756,682, n = 8, f = 2, batch 128, streamed, cuDNN pinned
    to its deterministic algorithms.  A: the bounded aggregate at (8, d) on
    the card against the CPU, workers 0-1 timed out, then stale at ages
    [3, 1] (reweighted), for krum, median, trimmed-mean and average-nan: the
    same masks and coefficients, krum's selection identical, the aggregate
    (the update of zero parameters at lr 1) within 1e-5 relative, the rule's
    kernel once a call.  B: the synchronous protocol (no deadline, no stall)
    against the fused step on the same batches, both rounds' ms; the first
    round's loss within BOUNDED_LOSS_RTOL; three traced rounds give the
    card's busy share, and the eight submissions run one after another
    without threads their time.  C: two persistent stragglers
    through the runner (BOUNDED_STRAGGLERS, krum): every warm round times
    out exactly workers 0-1, a ``bounded_round`` each, each under 0.5 s on
    the journal's clock, forensics names ``stragglers == [0, 1]``, K1 once
    a round.  D: ``--stale-infill --stale-max-age 2`` under median, then
    with ``--stale-reweight``: stale at rounds 1-2, NaN drops after (JAX
    ``test_bounded.py:283-321``), coefficients 1/2 and 1/3, K3 once a round.
    E: ``--deadline-percentile 71.4`` from a 0.5 s window under two
    stragglers, average-nan: the window's trajectory, the honest arrivals' p50/p95 and
    the ms from the close to the update; the window ends below its start.
    F: ``int8:ef`` with ``incremental`` against the stacked path: the same
    losses bit for bit, the overlap fraction.  G: three persistent
    stragglers at f = 2 under ``--guardian`` (average-nan): a rollback for
    ``straggler_timeouts`` and the ``f+1`` escalation.  H: a 2 ms deadline
    under average-nan: no exception, arrivals + timeouts = n each round, the
    skipped units counted, ``close()`` within its bound.  No kernel is
    built in the phase (``build.add_build_listener``)."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from aggregathor_tpu_torch.chaos import ChaosSchedule
    from aggregathor_tpu_torch.obs.metrics import MetricsRegistry
    from aggregathor_tpu_torch.ops import build
    from aggregathor_tpu_torch.parallel.bounded import BoundedWaitStep, HostStragglerModel
    from aggregathor_tpu_torch.parallel.deadline import DeadlineController

    torch.backends.cudnn.deterministic = True
    builds = []

    def note_build(*args):
        builds.append(args)

    build.add_build_listener(note_build)
    totals = {name: 0 for name in kernels.KERNELS}
    n = 8
    # A: the aggregate, card against CPU
    template = {k: torch.zeros_like(v) for k, v in models.instantiate("cnnet", []).init(0).items()}
    d = sum(v.numel() for v in template.values())
    rows = torch.randn((n, d), generator=torch.Generator().manual_seed(15)) * torch.linspace(0.5, 2.0, n)[:, None]
    rows[5] *= 40.0  # an outlier
    arrived = torch.tensor([False, False] + [True] * 6)
    cases = (("timed out", False, torch.zeros(n, dtype=torch.bool), {}),
             ("stale [3, 1]", True, torch.tensor([True, True] + [False] * 6),
              {"stale_age": torch.tensor([3, 1] + [0] * 6, dtype=torch.int32)}))
    for rule, kernel in BOUNDED_KERNELS.items():
        for label, reweight, stale, extras in cases:
            got = {}
            for device in ("cuda", "cpu"):
                exp, tx, engine = _bounded_stack(torch, gars, models, rule, lr=1.0, worker_metrics=True,
                                                 device=device)
                agg = engine.build_bounded_aggregate(tx, template, stale_reweight=reweight)
                state = engine.init_state(template, tx, seed=1)
                kernels.reset_launch_counts()
                state, m = agg(state, rows.to(device), torch.ones(n, device=device), arrived.to(device),
                               stale.to(device), {k: v.to(device) for k, v in extras.items()})
                if device == "cuda":
                    counts = kernels.launch_counts()
                    check({k: c for k, c in counts.items() if c} == {kernel: 1},
                          "bounded A %s %s: launches %s (want %s once)" % (rule, label, counts, kernel))
                    totals[kernel] += 1
                got[device] = ({k: v.cpu() for k, v in m.items() if k != "probe"},
                               -torch.cat([state.params[name].detach().cpu().reshape(-1)
                                           for name in sorted(state.params)]))
            (card_m, card_agg), (cpu_m, cpu_agg) = got["cuda"], got["cpu"]
            for key in ("straggler_timeout", "stale_infill", "nb_timeouts", "nb_stale", "stale_reweight_coeff") + (
                    ("worker_participation",) if rule == "krum" else ()):
                check((key in card_m) == (key in cpu_m) and (key not in cpu_m or torch.equal(card_m[key], cpu_m[key])),
                      "bounded A %s %s: %s differs on the card" % (rule, label, key))
            check(torch.equal(torch.isnan(card_agg), torch.isnan(cpu_agg)), "bounded A %s %s: NaN pattern" % (rule, label))
            finite = torch.isfinite(cpu_agg)
            err = torch.abs(card_agg[finite] - cpu_agg[finite])
            worst = float((err / torch.clamp(torch.abs(cpu_agg[finite]), min=1.0)).max())
            check(worst <= 1e-5, "bounded A %s %s: aggregate off the CPU's by %.3g" % (rule, label, worst))
            print("bounded A %-12s %-12s on %s against the CPU: masks, coefficients%s identical, aggregate within "
                  "%.3g relative, %s once" % (rule, label, card, " and selection" if rule == "krum" else "", worst,
                                              kernel))
    del rows
    # B: the synchronous protocol against the fused step
    exp, tx, engine = _bounded_stack(torch, gars, models, "krum")
    init = exp.init(1)
    it = exp.make_train_iterator(n, seed=2)
    batches = [engine.put_batch(next(it)) for _ in range(BOUNDED_ROUNDS)]
    step = BoundedWaitStep(engine, exp.loss, tx, init)
    kernels.reset_launch_counts()
    try:
        state, sync = _bounded_rounds(torch, step, engine.init_state(init, tx, seed=1), batches)
        check(kernels.launch_counts()["pairwise_sq_distances"] == BOUNDED_ROUNDS, "bounded B: K1 once a round")
        totals["pairwise_sq_distances"] += BOUNDED_ROUNDS
        # where a round's time goes: the card's busy share over three
        # traced rounds, and the same eight submissions one after another on
        # the caller's thread and stream (no threads, no streams)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            begin = time.monotonic()
            state, _ = _bounded_rounds(torch, step, state, batches[:3])
            traced_ms = (time.monotonic() - begin) * 1e3
        busy_us, nb_events = card_busy_us(torch, prof)
    finally:
        step.close()
    grad_fn, sequential = engine.build_worker_grad(exp.loss), []
    for batch in batches[:3]:
        begin = time.monotonic()
        params = {k: v.detach().clone() for k, v in state.params.items()}
        for w in range(n):
            grad_fn(params, {k: v[w] for k, v in batch.items()}, state.seed, state.step, w)
        torch.cuda.synchronize()
        sequential.append((time.monotonic() - begin) * 1e3)
    fused_step, fused_state, fused = engine.build_step(exp.loss, tx), engine.init_state(init, tx, seed=1), []
    for batch in batches:
        begin = time.monotonic()
        fused_state, metrics = fused_step(fused_state, batch)
        torch.cuda.synchronize()
        fused.append(((time.monotonic() - begin) * 1e3, float(metrics["total_loss"])))
    first, want = float(sync[0][2]["total_loss"]), fused[0][1]
    check(abs(first - want) <= BOUNDED_LOSS_RTOL * abs(want), "bounded B: first loss %r vs the fused %r" % (first, want))
    check(all(not bool(m["straggler_timeout"].any()) for _, _, m in sync), "bounded B: a timeout without a deadline")
    sync_ms = [ms for ms, _, _ in sync[1:]]
    fused_ms = [ms for ms, _ in fused[1:]]
    print("bounded B synchronous protocol cnnet+krum on %s: round ms excl. 1st %s (median %.2f) against the fused "
          "step's %s (median %.2f); first loss %.6f vs %.6f (rel %.2g); losses %s vs %s" % (
              card, ", ".join("%.2f" % v for v in sync_ms), statistics.median(sync_ms),
              ", ".join("%.2f" % v for v in fused_ms), statistics.median(fused_ms), first, want,
              abs(first - want) / abs(want), ", ".join("%.4f" % float(m["total_loss"]) for _, _, m in sync),
              ", ".join("%.4f" % loss for _, loss in fused)))
    print("bounded B where a synchronous round goes on %s: the card busy %.2f ms a round over 3 traced rounds (%.1f "
          "ms traced wall, %d device events, torch.profiler): busy share %.3f of the untraced median round; the 8 "
          "submissions alone, one after another on one thread and stream: %s ms" % (
              card, busy_us / 3e3, traced_ms, nb_events, busy_us / 3e3 / statistics.median(sync_ms),
              ", ".join("%.2f" % v for v in sequential)))
    del fused_state, batches
    # C: two persistent stragglers through the runner
    result, journal, report, counts = _bounded_runner_leg(runner, kernels, "C", ["--aggregator", "krum"]
                                                          + BOUNDED_STRAGGLERS, workdir, 8)
    rounds = [r for r in journal if r["type"] == "bounded_round"]
    check([r["step"] for r in rounds] == list(range(1, 8)), "bounded C: bounded_round steps %s"
          % [r["step"] for r in rounds])
    check(all(r["timed_out"] == [0, 1] for r in rounds), "bounded C: timed out %s" % [r["timed_out"] for r in rounds])
    closes = [r["t_mono"] for r in rounds]
    durations = [b - a for a, b in zip(closes, closes[1:])]
    check(max(durations) < 0.5, "bounded C: a warm round took %.3f s" % max(durations))
    check(report["stragglers"] == [0, 1], "bounded C: forensics stragglers %s" % report["stragglers"])
    check(counts["pairwise_sq_distances"] == 8 and sum(counts.values()) == 8, "bounded C: launches %s" % counts)
    totals["pairwise_sq_distances"] += 8
    print("bounded C 2 stragglers (stall 4.0 s, deadline 1.0 s) cnnet+krum on %s: rounds 2-7 closed after %s s; "
          "skipped %s; forensics stragglers %s; K1 %d; steps/s excl. 1st %.3f" % (
              card, ", ".join("%.3f" % v for v in durations), [r["skipped_units"] for r in rounds],
              report["stragglers"], counts["pairwise_sq_distances"], result["steps_per_s"]))
    # D: stale infill, naive then reweighted
    for extra in ([], ["--stale-reweight"]):
        label = "D" + ("-reweight" if extra else "")
        result, journal, report, counts = _bounded_runner_leg(
            runner, kernels, label, ["--aggregator", "median", "--stale-infill", "--stale-max-age", "2"]
            + BOUNDED_STRAGGLERS + extra, workdir, 5)
        rounds = [r for r in journal if r["type"] == "bounded_round"]
        stale = [r["stale_infill"] for r in rounds]
        check(stale == [[0, 1], [0, 1], [], []] and all(r["timed_out"] == [0, 1] for r in rounds),
              "bounded %s: stale %s, timed out %s" % (label, stale, [r["timed_out"] for r in rounds]))
        weights = [(r["step"], r["worker"], r["coefficient"]) for r in journal if r["type"] == "stale_reweight"]
        want = [(1, 0, 0.5), (1, 1, 0.5), (2, 0, 1 / 3), (2, 1, 1 / 3)] if extra else []
        check(weights == want, "bounded %s: reweights %s" % (label, weights))
        check(counts["coordinate_median"] == 5 and sum(counts.values()) == 5, "bounded %s: launches %s"
              % (label, counts))
        totals["coordinate_median"] += 5
        print("bounded %-10s median on %s: stale rows by round %s, then NaN drops; reweights %s; K3 %d" % (
            label, card, stale, weights, counts["coordinate_median"]))
    # E: the adaptive window (average-nan: an honest worker the window cuts
    # off is one more NaN row, which the rule absorbs at any count)
    exp, tx, engine = _bounded_stack(torch, gars, models, "average-nan")
    it = exp.make_train_iterator(n, seed=3)
    controller = DeadlineController(0.5, percentile=71.4, floor=0.01, ema=0.3)
    model = HostStragglerModel(n, 1.0, chaos=ChaosSchedule("0:calm 1:straggle=1.0", n, args=["straggle-workers:2"]))
    step = BoundedWaitStep(engine, exp.loss, tx, init, deadline=0.5, straggler_model=model, controller=controller)
    windows, honest, to_update, round_ms = [controller.window], [], [], []
    kernels.reset_launch_counts()
    try:
        state = engine.init_state(init, tx, seed=1)
        for _ in range(16):
            state, out = _bounded_rounds(torch, step, state, [engine.put_batch(next(it))])
            ms, after_close, metrics = out[0]
            round_ms.append(ms)
            to_update.append(after_close)
            windows.append(controller.window)
            honest.extend(float(a) for a in step.last_arrivals[2:] if math.isfinite(a))
    finally:
        step.close()
    check(windows[-1] < windows[0], "bounded E: the window ended at %.4f s, not below %.4f" % (windows[-1], windows[0]))
    check(math.isfinite(float(metrics["total_loss"])), "bounded E: non-finite loss")
    p50, p95 = np.percentile(honest, 50) * 1e3, np.percentile(honest, 95) * 1e3
    check(kernels.launch_counts()["average_nan_columns"] == 16, "bounded E: K6 once a round")
    totals["average_nan_columns"] += 16
    print("bounded E --deadline-percentile 71.4 from 0.5 s, 2 stragglers, cnnet+average-nan on %s: window s %s; honest "
          "arrivals p50 %.2f ms p95 %.2f ms (%d); round ms %s; ms from the close to the update %s (median %.2f)" % (
              card, ", ".join("%.4f" % w for w in windows), p50, p95, len(honest),
              ", ".join("%.1f" % v for v in round_ms), ", ".join("%.2f" % v for v in to_update[1:]),
              statistics.median(to_update[1:])))
    # F: incremental against stacked, int8:ef
    runs = {}
    for incremental in (False, True):
        exp, tx, engine = _bounded_stack(torch, gars, models, "krum", exchange="int8:ef")
        it = exp.make_train_iterator(n, seed=4)
        model = HostStragglerModel(n, 30.0, chaos=ChaosSchedule("0:calm 1:straggle=1.0", n,
                                                                args=["straggle-workers:2"]))
        registry = MetricsRegistry()
        step = BoundedWaitStep(engine, exp.loss, tx, init, deadline=0.5, straggler_model=model, registry=registry,
                               stale_infill=True, incremental=incremental)
        try:
            _, out = _bounded_rounds(torch, step, engine.init_state(init, tx, seed=1),
                                     [engine.put_batch(next(it)) for _ in range(5)])
        finally:
            step.close()
        runs[incremental] = ([m["total_loss"].cpu() for _, _, m in out], [ms for ms, _, _ in out],
                             registry.snapshot(), step)
    check(all(torch.equal(a.view(torch.int32), b.view(torch.int32)) for a, b in zip(runs[False][0], runs[True][0])),
          "bounded F: incremental losses %s vs stacked %s" % (runs[True][0], runs[False][0]))
    snapshot, fold_step = runs[True][2], runs[True][3]
    print("bounded F int8:ef incremental vs stacked cnnet+krum on %s: losses bit-identical %s; overlap fraction %.3f "
          "(%d of %d folds); round ms stacked %s, incremental %s" % (
              card, ", ".join("%.6f" % float(v) for v in runs[True][0]),
              fold_step.overlapped_folds_total / max(fold_step.folds_total, 1), fold_step.overlapped_folds_total,
              fold_step.folds_total, ", ".join("%.1f" % v for v in runs[False][1]),
              ", ".join("%.1f" % v for v in runs[True][1])))
    check(snapshot["exchange_folds_total"] == fold_step.folds_total > 0, "bounded F: fold counter")
    # G: the guardian escalates for timeouts beyond f
    result, journal, report, counts = _bounded_runner_leg(
        runner, kernels, "G", ["--aggregator", "average-nan", "--chaos", "0:calm 1:straggle=1.0", "--chaos-args",
                               "straggle-workers:3", "--straggler-stall", "1.0", "--step-deadline", "0.3",
                               "--guardian", "--guardian-args", "patience:2", "recover:2",
                               "--checkpoint-dir", os.path.join(workdir, "bounded-G-ckpt"), "--checkpoint-delta", "1",
                               "--checkpoint-period", "-1"], workdir, 8)
    decisions = [r for r in journal if r["type"] == "guardian_rollback_decision"]
    check(decisions and decisions[0]["reason"] == "straggler_timeouts" and result["escalations"][:1] == ["f+1"],
          "bounded G: decisions %s, escalations %s" % (decisions, result["escalations"]))
    check(sum(counts.values()) == counts["average_nan_columns"] > 0, "bounded G: launches %s" % counts)
    totals["average_nan_columns"] += counts["average_nan_columns"]
    print("bounded G 3 stragglers at f=2 under --guardian, average-nan on %s: rollbacks %s, escalations %s, K6 %d"
          % (card, [(r["from_step"], r["to_step"], r["reason"]) for r in result["rollbacks"]], result["escalations"],
             counts["average_nan_columns"]))
    # H: a deadline below the honest compute
    exp, tx, engine = _bounded_stack(torch, gars, models, "average-nan")
    it = exp.make_train_iterator(n, seed=5)
    registry = MetricsRegistry()
    step = BoundedWaitStep(engine, exp.loss, tx, init, deadline=0.002, registry=registry)
    kernels.reset_launch_counts()
    try:
        _, out = _bounded_rounds(torch, step, engine.init_state(init, tx, seed=1),
                                 [engine.put_batch(next(it)) for _ in range(8)])
    finally:
        begin = time.monotonic()
        step.close()
        closed_in = time.monotonic() - begin
    torch.cuda.synchronize()
    snapshot = registry.snapshot()
    late = [int(m["nb_timeouts"]) for _, _, m in out]
    arrivals = [int((~m["straggler_timeout"]).sum()) for _, _, m in out]
    skipped = int(sum(snapshot.get("straggler_skipped_rounds_total", {}).values()))
    check(all(a + t == n for a, t in zip(arrivals, late)) and sum(late) > 0, "bounded H: arrivals %s timeouts %s"
          % (arrivals, late))
    check(sum(snapshot["straggler_timeouts_total"].values()) == sum(late), "bounded H: timeout counter")
    check(closed_in < 5.5, "bounded H: close() took %.2f s" % closed_in)
    check(kernels.launch_counts()["average_nan_columns"] == 8, "bounded H: K6 once a round")
    totals["average_nan_columns"] += 8
    print("bounded H deadline 2 ms average-nan cnnet on %s: arrivals %s, timeouts %s, skipped units %d, round ms %s, "
          "close() %.3f s" % (card, arrivals, late, skipped, ", ".join("%.1f" % ms for ms, _, _ in out), closed_in))
    build.remove_build_listener(note_build)
    check(not builds, "bounded: kernels built during the phase: %s" % builds)
    torch.backends.cudnn.deterministic = False
    return totals


#: bounded_ranks_phase: two gloo ranks sharing cuda:0 run bounded-wait
#: rounds of cnnet at its published width (n = 8, f = 2, batch 128,
#: streamed), workers 0 (rank 0) and 5 (rank 1) stalled past the window
#: from round 1 on; (rule, rounds, the kernel it launches once a round on
#: each rank's (8, 878,341) block)
BOUNDED_RANKS_LEGS = (("krum", 3, "pairwise_sq_distances"), ("median", 2, "coordinate_median"),
                      ("average-nan", 2, "average_nan_columns"))
BOUNDED_RANKS_LATE = (0, 5)
BOUNDED_RANKS_STALL = 4.0
BOUNDED_RANKS_DEADLINE = 1.0
BOUNDED_RANKS_RTOL = 1e-5


class LateWorkers:
    """bounded_ranks_phase's straggler model: from round 1 on, each worker
    of ``BOUNDED_RANKS_LATE`` holds its submission ``BOUNDED_RANKS_STALL``
    seconds (a round closes after ``BOUNDED_RANKS_DEADLINE``)."""

    def delay(self, step, worker):
        return BOUNDED_RANKS_STALL if step >= 1 and worker in BOUNDED_RANKS_LATE else 0.0


def bounded_ranks_leg(axis, rule, rounds):
    """``rounds`` bounded-wait rounds of cnnet + ``rule`` on ``axis``, from
    round 0 (no deadline) on, the launch counts and the axis's collectives
    read over them; per round its masks, krum's participation, its loss,
    its ms to the update's end and the verdicts' gather ms."""
    import torch

    from aggregathor_tpu_torch import gars, models
    from aggregathor_tpu_torch.core import build_optimizer, build_schedule
    from aggregathor_tpu_torch.ops import kernels
    from aggregathor_tpu_torch.parallel import RobustEngine
    from aggregathor_tpu_torch.parallel.bounded import BoundedWaitStep

    n = 8
    exp = models.instantiate("cnnet", [])
    tx = build_optimizer("sgd", build_schedule("fixed", ["initial-rate:0.05"]))
    engine = RobustEngine(gars.instantiate(rule, n, 2), n, worker_metrics=rule == "krum", axis=axis)
    init = exp.init(1)
    it = exp.make_train_iterator(n, seed=2)
    batches = [engine.put_batch(next(it)) for _ in range(rounds)]
    # the reshard's share of the staged bytes: its all_to_all, counted
    reshard = {"bytes": 0}
    all_to_all = axis.all_to_all

    def counted(pieces):
        reshard["bytes"] += pieces.numel() * pieces.element_size()
        return all_to_all(pieces)

    axis.all_to_all = counted
    step = BoundedWaitStep(engine, exp.loss, tx, init, deadline=BOUNDED_RANKS_DEADLINE, straggler_model=LateWorkers())
    state = engine.init_state(init, tx, seed=1)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    before = dict(axis.stats)
    out = {"rounds": [], "round_ms": [], "gather_ms": []}
    try:
        for batch in batches:
            begin = time.perf_counter()
            state, metrics = step(state, batch)
            torch.cuda.synchronize()
            out["round_ms"].append((time.perf_counter() - begin) * 1e3)
            out["gather_ms"].append(step.last_gather_s * 1e3)
            out["rounds"].append({key: metrics[key].cpu().numpy() for key in
                                  ("straggler_timeout", "stale_infill", "worker_participation", "total_loss")
                                  if key in metrics})
    finally:
        step.close()
        del axis.all_to_all
    out["counts"] = kernels.launch_counts()
    out["batched"] = sum(kernels.batched_launch_counts().values())
    out["staged_mb"] = (axis.stats["bytes"] - before["bytes"]) / 2**20 / rounds
    out["reshard_mb"] = reshard["bytes"] / 2**20 / rounds
    out["params"] = torch.cat([state.params[k].detach().reshape(-1) for k in sorted(state.params)]).cpu().numpy()
    del state, batches, engine
    torch.cuda.empty_cache()
    return out


def bounded_ranks_rank(axis):
    """One rank of ``bounded_ranks_phase`` (a spawned process re-imports
    this module, whose top level imports nothing of the port); also the
    one-rank run, on a one-rank axis.  Counts the kernels built meanwhile."""
    import torch

    from aggregathor_tpu_torch.ops import build

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    builds = []

    def note_build(*args):
        builds.append(args)

    build.add_build_listener(note_build)
    try:
        out = {rule: bounded_ranks_leg(axis, rule, rounds) for rule, rounds, _ in BOUNDED_RANKS_LEGS}
    finally:
        build.remove_build_listener(note_build)
    out["builds"] = builds
    return out


def two_rank_legs(axis):
    """One rank of ``bounded_ranks_phase`` and of ``multirank_phase``: both
    phases' legs in one spawn, so a rank starts (and warms cnnet on the card)
    once."""
    return {"bounded": bounded_ranks_rank(axis), "multirank": multirank_rank(axis)}


def bounded_ranks_phase(torch, kernels, card, two_ranks):
    """Bounded-wait over two gloo ranks spawned on ``cuda:0``
    (``parallel.mesh.spawn``, shared card; its collectives staged through
    pinned host memory, so its times say nothing of NVLink): cnnet at d =
    1,756,682, n = 8, f = 2, batch 128, streamed, cuDNN pinned, a fixed 1 s
    deadline, workers 0 and 5 stalled 4 s from round 1 on; four rounds of
    krum, then two each of median and average-nan (NaN-drop timeouts).
    Held against one rank on the card with the same weights and batches:
    the masks equal, krum's selections identical, the parameters
    bit-identical across the ranks and within 1e-5 relative of the one
    rank's; the launches exact on each rank (K1, K3, K6 once a round on
    the (8, 878,341) block, nothing batched); no kernel built in the
    phase.  Prints each rank's round ms, the verdicts' gather ms and the
    staged MB a round (the reshard's share).  The spawn runs
    ``multirank_phase``'s legs too (``two_rank_legs``), kept in
    ``two_ranks["multirank"]``.  Returns {kernel: launches} summed over the
    ranks."""
    import numpy as np

    from aggregathor_tpu_torch.parallel import mesh
    from aggregathor_tpu_torch.parallel.mesh import WorkerAxis

    begin = time.perf_counter()
    spawned = mesh.spawn(two_rank_legs, 2, 8, device="cuda", shared_card=True, timeout=900)
    two_ranks["multirank"] = [rank["multirank"] for rank in spawned]
    ranks = [rank["bounded"] for rank in spawned]
    spawned_s = time.perf_counter() - begin
    one = bounded_ranks_rank(WorkerAxis(8, 1, 0, "cuda"))
    torch.backends.cudnn.deterministic = False
    block = -(-CNNET_D // 2)
    totals = {name: 0 for name in kernels.KERNELS}
    for rank, result in enumerate(ranks + [one]):
        check(not result["builds"], "bounded ranks: %s kernels built in %s" % (
            result["builds"], "rank %d" % rank if rank < 2 else "the one rank"))
    late = np.isin(np.arange(8), BOUNDED_RANKS_LATE)
    for rule, rounds, kernel in BOUNDED_RANKS_LEGS:
        lead, other, want = ranks[0][rule], ranks[1][rule], one[rule]
        a, b = lead["params"], other["params"]
        check(bool((a == b).all()), "bounded ranks %s: the ranks' parameters differ (%d of %d entries; NaN %d and %d; "
              "largest difference %.3g; losses %s and %s)" % (
                  rule, int((a != b).sum()), a.size, int(np.isnan(a).sum()), int(np.isnan(b).sum()),
                  float(np.nanmax(np.abs(a - b))) if np.isfinite(a - b).any() else float("nan"),
                  [float(r["total_loss"]) for r in lead["rounds"]], [float(r["total_loss"]) for r in other["rounds"]]))
        for i, (a, b, c) in enumerate(zip(lead["rounds"], other["rounds"], want["rounds"])):
            for key in c:
                same = np.array_equal(a[key], b[key]) and (key == "total_loss" or np.array_equal(a[key], c[key]))
                check(same, "bounded ranks %s round %d: %s differs (ranks %s, %s; one rank %s)"
                      % (rule, i, key, a[key], b[key], c[key]))
            check(a["straggler_timeout"].tolist() == (late if i else np.zeros(8, bool)).tolist(),
                  "bounded ranks %s round %d: timed out %s" % (rule, i, a["straggler_timeout"]))
            rel = abs(float(a["total_loss"]) - float(c["total_loss"])) / abs(float(c["total_loss"]))
            check(rel <= BOUNDED_RANKS_RTOL, "bounded ranks %s round %d: loss %r vs one rank's %r"
                  % (rule, i, float(a["total_loss"]), float(c["total_loss"])))
        err = float(np.abs(lead["params"] - want["params"]).max() / np.abs(want["params"]).max())
        check(err <= BOUNDED_RANKS_RTOL, "bounded ranks %s: parameters off one rank's by %.3g" % (rule, err))
        for rank, result in enumerate(ranks):
            counts = result[rule]["counts"]
            check(counts == {name: rounds if name == kernel else 0 for name in kernels.KERNELS}
                  and not result[rule]["batched"], "bounded ranks %s rank %d: launches %s (want %s %d)"
                  % (rule, rank, counts, kernel, rounds))
            totals[kernel] += counts[kernel]
        print("bounded ranks %s on %s: 2 ranks sharing the card (gloo, staged), %d rounds, workers %s late past a "
              "%.1f s window from round 1: round ms rank 0 %s, rank 1 %s (one rank %s); verdict gather ms %s; staged "
              "%.2f MB a round and rank, the reshard %.2f; %s once a round a rank on (8, %d); parameters off one "
              "rank's by %.3g of the largest"
              % (rule, card, rounds, list(BOUNDED_RANKS_LATE), BOUNDED_RANKS_DEADLINE,
                 ", ".join("%.1f" % v for v in lead["round_ms"]), ", ".join("%.1f" % v for v in other["round_ms"]),
                 ", ".join("%.1f" % v for v in want["round_ms"]), ", ".join("%.2f" % v for v in lead["gather_ms"]),
                 lead["staged_mb"], lead["reshard_mb"], kernel, block, err))
    print("bounded ranks phase on %s: %.1f s (the spawn's %.1f s, the multirank phase's legs included)"
          % (card, time.perf_counter() - begin, spawned_s))
    torch.cuda.empty_cache()
    return totals


#: secure_phase: cnnet + krum, n = 8, f = 2, r = 2 under a schedule that
#: forges steps 2-4 and tampers from step 5 on (every rejected row is the
#: coalition's); 12 steps, as the first few after the build vary and the
#: digest tax is the difference of two legs' mean step times
SECURE_STEPS = 12
SECURE_SCHEDULE = "0:calm 2:forge=1.0 5:tamper=1.0"
SECURE_REJECTED_STEPS = SECURE_STEPS - 2


def _secure_leg(runner, kernels, label, argv, workdir, steps=SECURE_STEPS):
    """One cnnet leg through the runner (drawn on the card, n = 8): returns
    (result, launches, its directory)."""
    directory = os.path.join(workdir, "secure-%s" % label)
    os.makedirs(directory, exist_ok=True)
    kernels.reset_launch_counts()
    result = runner.main(["--experiment", "cnnet", "--experiment-args", "augment:device", "--input-source", "device",
                          "--seed", "1", "--nb-workers", "8", "--max-step", str(steps), "--evaluation-delta", "-1",
                          "--evaluation-period", "-1", *argv])
    counts = kernels.launch_counts()
    check(result["final_loss"] is not None and math.isfinite(result["final_loss"]),
          "secure %s: final loss %s" % (label, result["final_loss"]))
    return result, counts, directory


def _secure_engine_ms(torch, steps=12):
    """{secure: median ms of the engine's cnnet + krum step alone, drawn on
    the card and synchronised} under SECURE_SCHEDULE, the first two steps
    left out."""
    from aggregathor_tpu_torch import gars, models
    from aggregathor_tpu_torch.chaos import ChaosSchedule
    from aggregathor_tpu_torch.core import build_optimizer, build_schedule
    from aggregathor_tpu_torch.parallel import RobustEngine

    exp = models.instantiate("cnnet", ["augment:device"])
    out = {}
    for secure in (False, True):
        engine = RobustEngine(gars.instantiate("krum", 8, 2), 8, nb_real_byz=2, secure=secure,
                              chaos=ChaosSchedule(SECURE_SCHEDULE, 8, nb_real_byz=2),
                              batch_transform=exp.device_transform(), device="cuda")
        tx = build_optimizer("sgd", build_schedule("fixed", ["initial-rate:0.05"]))
        state, data = engine.init_state(exp.init(1), tx, seed=1), engine.replicate(exp.train_arrays())
        multi = engine.build_sampled_multi_step(exp.loss, tx, 1, exp.batch_size)
        times = []
        for _ in range(steps):
            torch.cuda.synchronize()
            begin = time.perf_counter()
            state, _ = multi(state, data)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - begin) * 1e3)
        out[secure] = statistics.median(times[2:])
    return out


def secure_phase(torch, kernels, runner, card, workdir):
    """Secure submission, masking and the checkpoints' crypto on the card
    (``secure/``); returns {kernel: launches}.

    At cnnet's d = 1,756,682: ``row_digest`` of (8, d) rows on the card
    equals the CPU's bit for bit, clean and poisoned (NaN, +-inf, -0.0 and
    subnormal coordinates), timed at (1, d) and (8, d) beside its byte bound
    (4d read a row); ``masked_group_mean`` at bucketing's (4, 2, d) equals
    the CPU's bit for bit, masked and unmasked, and masked equals unmasked,
    both timed.  Then cnnet + krum (n = 8, f = 2, r = 2) through the
    runner for SECURE_STEPS steps under SECURE_SCHEDULE with ``--secure``:
    K1 once a step, the forensics report names workers 0 and 1 with
    SECURE_REJECTED_STEPS ``forgery`` entries each and no other worker,
    ``secure_forgeries_total`` the same, the loss finite, and the host's
    ``secure.verify`` span read from ``--trace-file``; the same argv without
    ``--secure`` (the forged rows enter the rule) gives the digest tax, ms a
    step of both, beside the engine's step alone with and without
    (``_secure_engine_ms``).  average-nan under ``--secure``: K6 once a step over the
    rejected NaN rows.  ``--encrypt-checkpoints`` under custody: a save, a
    resume that restores it (tag, manifest, decryption), then one flipped
    byte refused.  ``--secure-mask`` with ``bucketing:s=2,inner=krum`` (f =
    1): the centring and K2 once a step on the 4 bucket means (the inner
    krum's distances, as for unmasked bucketing), ms a step against the
    same leg unmasked."""
    from aggregathor_tpu_torch.obs import metrics as obs_metrics
    from aggregathor_tpu_torch.secure import GroupMasking, manifest_path, masked_group_mean, row_digest
    from aggregathor_tpu_torch.utils import UserException

    d = CNNET_D
    rows = torch.randn((8, d), generator=torch.Generator().manual_seed(21))
    poisoned = rows.clone()
    poisoned[1] = float("nan")
    poisoned[2, ::7], poisoned[3, 1::7] = float("inf"), float("-inf")
    poisoned[4, ::3], poisoned[5, ::11] = -0.0, 1e-40
    for label, x in (("clean", rows), ("poisoned", poisoned)):
        check(torch.equal(row_digest(x.cuda()).cpu(), row_digest(x)),
              "row_digest of the %s (8, %d) rows differs between the card and the CPU" % (label, d))
    cuda_rows = rows.cuda()
    digest_ms = {1: time_ms(lambda: row_digest(cuda_rows[0]), torch), 8: time_ms(lambda: row_digest(cuda_rows), torch)}
    grouped = (rows * 10.0).view(4, 2, d)
    grouped[1, 0, ::5] = float("nan")
    grouped[2, 1, :3] = torch.tensor([2.0 ** 31, 2.0 ** 32, -3.4e38])
    key = 12345
    masked_cpu = masked_group_mean(grouped, key, GroupMasking.from_secret(b"s"))
    cuda_grouped = grouped.cuda()
    masked = masked_group_mean(cuda_grouped, key, GroupMasking.from_secret(b"s"))
    plain = masked_group_mean(cuda_grouped, key, GroupMasking.from_secret(b"s", enabled=False))
    check(torch.equal(masked.cpu().view(torch.int32), masked_cpu.view(torch.int32)),
          "masked_group_mean at (4, 2, %d) differs between the card and the CPU" % d)
    check(torch.equal(masked.view(torch.int32), plain.view(torch.int32)), "masked differs from unmasked on the card")
    check(bool(torch.isnan(masked[1]).all()) and bool(torch.isfinite(masked[[0, 3]]).all()),
          "masked_group_mean: the NaN row's bucket must be NaN, the clean ones finite")
    mask_ms = {label: time_ms(lambda m=m: masked_group_mean(cuda_grouped, key, m), torch, iters=5)
               for label, m in (("masked", GroupMasking.from_secret(b"s")),
                                ("unmasked", GroupMasking.from_secret(b"s", enabled=False)))}
    del cuda_rows, cuda_grouped, masked, plain
    print("secure on %s: row_digest at (8, %d) bit-identical to the CPU's, clean and poisoned; %.4f ms at (1, d), "
          "%.4f ms at (8, d), %.4f ms a row (CUDA events; bound 4d bytes a row: %.4f ms); masked_group_mean at "
          "(4, 2, d) bit-identical to the CPU's, masked == unmasked: masked %.3f ms, unmasked %.3f ms"
          % (card, d, digest_ms[1], digest_ms[8], digest_ms[8] / 8, 4 * d / MEMORY_BYTES_PER_S * 1e3,
             mask_ms["masked"], mask_ms["unmasked"]))

    totals = {name: 0 for name in kernels.KERNELS}

    def held(label, counts, kernel, result):
        wanted = (kernel,) if isinstance(kernel, str) else kernel
        want = {name: result["steps"] if name in wanted else 0 for name in kernels.KERNELS}
        check(counts == want, "secure %s: launches %s (want %s)" % (label, counts, want))
        for name, count in counts.items():
            totals[name] += count

    krum = ["--aggregator", "krum", "--nb-decl-byz-workers", "2", "--nb-real-byz-workers", "2",
            "--chaos", SECURE_SCHEDULE]
    secure = ["--secure", "--session-secret", "s"]
    def observed(label):
        # both legs of the tax keep the same observers: the forensics feed
        # and the span trace
        directory = os.path.join(workdir, "secure-%s" % label)
        return ["--forensics", os.path.join(directory, "f.json"), "--trace-file", os.path.join(directory, "t.json")]

    before = obs_metrics.REGISTRY.snapshot()
    result, counts, directory = _secure_leg(runner, kernels, "krum", krum + secure + observed("krum"), workdir)
    forensics, span_trace = os.path.join(directory, "f.json"), os.path.join(directory, "t.json")
    held("krum", counts, "pairwise_sq_distances", result)
    report = json.load(open(forensics))
    named = {entry["worker"]: entry["evidence"].get("forgery", 0) for entry in report["workers"]}
    check(named == {w: SECURE_REJECTED_STEPS if w < 2 else 0 for w in range(8)},
          "secure krum: forgery evidence %s (want workers 0 and 1, %d each)" % (named, SECURE_REJECTED_STEPS))
    after = obs_metrics.REGISTRY.snapshot()
    crypto_ms = sum(after[name] - before.get(name, 0.0) for name in (
        "secure_sign_seconds_total", "secure_verify_seconds_total")) / SECURE_STEPS * 1e3
    after, before = after.get("secure_forgeries_total", {}), before.get("secure_forgeries_total", {})
    forged = {w: after.get("worker=%d" % w, 0.0) - before.get("worker=%d" % w, 0.0) for w in range(8)}
    check(forged == {w: float(SECURE_REJECTED_STEPS) if w < 2 else 0.0 for w in range(8)},
          "secure krum: secure_forgeries_total grew %s" % forged)
    spans = [e["dur"] for e in json.load(open(span_trace))["traceEvents"] if e.get("name") == "secure.verify"]
    check(len(spans) == SECURE_STEPS, "secure krum: %d secure.verify spans (want %d)" % (len(spans), SECURE_STEPS))
    plain_result, counts, _ = _secure_leg(runner, kernels, "krum-plain", krum + observed("krum-plain"), workdir)
    held("krum-plain", counts, "pairwise_sq_distances", plain_result)
    secure_ms, plain_ms = 1e3 / result["steps_per_s"], 1e3 / plain_result["steps_per_s"]
    engine_ms = _secure_engine_ms(torch)
    print("secure leg cnnet+krum on %s: %d steps, final loss %.4f, %.2f ms a step excl. 1st; without --secure "
          "%.2f ms (digest tax %.2f ms, x%.3f); the engine's step alone, synchronised, median of 10: secure %.2f "
          "ms, plain %.2f ms; secure.verify %.3f ms a step on the host (mean of %d spans, the wait for the "
          "card's call included), of which signing and verifying %.3f ms; forgery evidence %s; launches K1=%d"
          % (card, SECURE_STEPS, result["final_loss"], secure_ms, plain_ms, secure_ms - plain_ms,
             secure_ms / plain_ms, engine_ms[True], engine_ms[False], statistics.mean(spans) / 1e3, len(spans),
             crypto_ms, named, result["launches"]["pairwise_sq_distances"]))
    result, counts, _ = _secure_leg(runner, kernels, "average-nan", [
        "--aggregator", "average-nan", "--nb-decl-byz-workers", "2", "--nb-real-byz-workers", "2",
        "--chaos", SECURE_SCHEDULE] + secure, workdir)
    held("average-nan", counts, "average_nan_columns", result)
    # encrypted checkpoints under custody: save, resume, a flipped byte
    ckpt = os.path.join(workdir, "secure-ckpt")
    crypto = secure + ["--encrypt-checkpoints", "--checkpoint-dir", ckpt, "--checkpoint-delta", "2",
                       "--checkpoint-period", "-1"]
    result, counts, _ = _secure_leg(runner, kernels, "ckpt-a", krum + crypto, workdir, steps=4)
    held("ckpt-a", counts, "pairwise_sq_distances", result)
    latest = os.path.join(ckpt, "model-4.ckpt")
    check(open(latest, "rb").read(5) == b"ATPC1" and os.path.exists(manifest_path(latest))
          and os.path.exists(latest + ".tag"), "secure ckpt: model-4 is not an encrypted, tagged, signed snapshot")
    result, counts, _ = _secure_leg(runner, kernels, "ckpt-b", krum + crypto, workdir, steps=6)
    check(result["restored_step"] == 4 and result["steps"] == 2, "secure ckpt: resumed from %s for %s steps"
          % (result["restored_step"], result["steps"]))
    held("ckpt-b", counts, "pairwise_sq_distances", result)
    latest = os.path.join(ckpt, "model-6.ckpt")
    with open(latest, "r+b") as fd:
        fd.seek(1000)
        byte = fd.read(1)
        fd.seek(1000)
        fd.write(bytes([byte[0] ^ 0x01]))
    try:
        _secure_leg(runner, kernels, "ckpt-c", krum + crypto, workdir, steps=8)
        fail("secure ckpt: a snapshot with one flipped byte was restored")
    except UserException as exc:
        check("failed HMAC verification" in str(exc), "secure ckpt: refused for another reason: %s" % exc)
    print("secure checkpoints on %s: cnnet encrypted, tagged and signed at steps 2 and 4, resumed from 4 to 6 "
          "(tag, custody, decryption), a flipped byte of model-6 refused at its tag" % card)
    # masking: the 4 bucket means of s = 2, krum with f = 1 on them
    bucket = ["--aggregator", "bucketing:s=2,inner=krum", "--nb-decl-byz-workers", "1", "--nb-real-byz-workers", "1",
              "--attack", "signflip"]
    mask_result, counts, _ = _secure_leg(runner, kernels, "masked", bucket + ["--secure-mask", "--session-secret", "s"],
                                         workdir)
    # krum's distances of the bucket means: the centring and K2 (sub_rule_distances)
    bucket_kernels = ("nanmedian_columns", "pairwise_sq_distances_gram")
    held("masked", counts, bucket_kernels, mask_result)
    result, counts, _ = _secure_leg(runner, kernels, "unmasked", bucket, workdir)
    held("unmasked", counts, bucket_kernels, result)
    print("secure-mask leg cnnet bucketing:s=2,inner=krum on %s: %d steps, final loss %.4f, %.2f ms a step excl. "
          "1st; unmasked %.2f ms; launches centring=%d K2=%d"
          % (card, SECURE_STEPS, mask_result["final_loss"], 1e3 / mask_result["steps_per_s"],
             1e3 / result["steps_per_s"], mask_result["launches"]["nanmedian_columns"],
             mask_result["launches"]["pairwise_sq_distances_gram"]))
    return totals


#: the zoo on the card (``zoo_phase``): config 3 of BASELINE.md, ResNet-50 +
#: Bulyan, at n = 32 with the largest f Bulyan admits there (n >= 4f + 3);
#: t = n - 2f - 2 = 16 selections, beta = t - 2f = 2
ZOO_N, ZOO_F = 32, 7
ZOO_D = {"slim-resnet_v1_50-digits32": 23519690, "slim-resnet_v1_50-imagenet": 25557032}
ZOO_BULYAN = ["--aggregator", "bulyan", "--nb-workers", str(ZOO_N), "--nb-decl-byz-workers", str(ZOO_F),
              "--nb-real-byz-workers", str(ZOO_F), "--attack", "signflip"]
ZOO_LEGS = [
    # (label, runner arguments, kernels each step launches once)
    ("Z1 resnet_v1_50-digits32+bulyan", ["--experiment", "slim-resnet_v1_50-digits32", "--experiment-args",
                                         "batch-size:16", "preprocessing:none", *ZOO_BULYAN, "--max-step", "6"],
     ("pairwise_sq_distances", "coordinate_averaged_median")),
    ("Z2 resnet_v1_50-imagenet+bulyan", ["--experiment", "slim-resnet_v1_50-imagenet", "--experiment-args",
                                         "image-size:224", "batch-size:2", *ZOO_BULYAN, "--max-step", "3"],
     ("pairwise_sq_distances", "coordinate_averaged_median")),
    ("Z3 resnet_v1_18-digits32+krum", ["--experiment", "slim-resnet_v1_18-digits32", "--experiment-args",
                                       "batch-size:8", "preprocessing:none", "--aggregator", "krum", "--nb-workers",
                                       "8", "--nb-decl-byz-workers", "2", "--learning-rate", "polynomial",
                                       "--learning-rate-args", "initial-rate:0.05", "end-rate:0.005",
                                       "decay-step:400", "--max-step", "400", "--evaluation-delta", "100"],
     ("pairwise_sq_distances",)),
]
#: Z3's least real test accuracy (the JAX package reached 0.944 at 400 steps,
#: docs/robustness.md)
ZOO_ANCHOR_FLOOR = 0.92
#: Z4's wall-time budget for all 34 nets, seconds
ZOO_NAMES_BUDGET_S = 120.0
#: the ImageNet 7x7/2 stem of Z2 (2 images a worker), beside Z1's ResNet-50
#: convs: (label, in, out, kernel, stride, padding, size, batch)
ZOO_STEM_SHAPE = ("stem 7x7/2 3->64 pad 3", 3, 64, 7, 2, ((3, 3), (3, 3)), 224, 2)
#: Z5: the card's worker gradients and aggregate against the port's CPU step
#: in float32, each within this share of its largest magnitude: a ReLU whose
#: input lies within rounding of 0 flips between the two summation orders
#: and moves a row by up to ~1e-2 of its largest entry (the port's CPU
#: against JAX's CPU: 1.4e-2 on resnet_v1_18); and in float64, where no
#: such flip happens, within ZOO_CARD_CPU_F64_RTOL
ZOO_CARD_CPU_RTOL = 2e-2
ZOO_CARD_CPU_F64_RTOL = 1e-9
#: the vmap fallback's warning: a batching rule is missing
VMAP_FALLBACK = ".*performance drop because we have not yet implemented the batching rule.*"


def zoo_conv_shapes(torch):
    """The distinct conv shapes of ResNet-50 on Z1 (digits32: one input
    channel, the 3x3/1 stem, 32x32; n = 32 workers of 16 images), read off
    the model by a forward of one image, and Z2's ImageNet stem:
    [(label, in, out, kernel, stride, padding, size, batch)]."""
    from aggregathor_tpu_torch.models.common import Conv
    from aggregathor_tpu_torch.models.resnet import ResNet

    model = ResNet(50, 10, small_inputs=True, channels=1)
    seen = {}

    def hook(module, inputs, output):
        (kh, kw), (s, _) = module.weight.shape[-2:], module.stride
        cout, cin = module.weight.shape[:2]
        size = inputs[0].shape[-1]
        key = (cin, cout, kh, s, size)
        seen.setdefault(key, ("%dx%d/%d %d->%d at %d" % (kh, kw, s, cin, cout, size), cin, cout, kh, s,
                              module.padding, size, 16))

    handles = [m.register_forward_hook(hook) for m in model.modules() if isinstance(m, Conv)]
    with torch.no_grad():
        model(torch.zeros((1, 32, 32, 1)))
    for handle in handles:
        handle.remove()
    return list(seen.values()) + [ZOO_STEM_SHAPE]


def zoo_weight_grads(torch):
    """cuDNN's float32 weight gradient of each ResNet-50 conv shape on the
    zoo legs (``zoo_conv_shapes``), vmapped over the n = 32 workers as the
    engine runs it, held against float64 on the card: the largest |error| a
    worker over that worker's largest |entry|.  A shape within
    ``VMAP_RTOL`` takes the float32 path; one beyond must be in
    ``common.F64_WEIGHT_GRAD_SHAPES`` (and is held there).  Returns {label:
    (cuDNN's error, the taken path's error, float32 ms, float64 ms, listed)}."""
    from torch.func import grad, vmap

    from aggregathor_tpu_torch.models import common

    gen = torch.Generator(device="cuda").manual_seed(20261018)
    out = {}
    for label, cin, cout, k, s, padding, size, batch in zoo_conv_shapes(torch):
        x = torch.randn((ZOO_N, batch, cin, size, size), device="cuda", generator=gen)
        w = torch.randn((cout, cin, k, k), device="cuda", generator=gen) / math.sqrt(cin * k * k)
        osize = -(-size // s) if padding == "SAME" else (size + 6 - k) // s + 1
        g = torch.randn((ZOO_N, batch, cout, osize, osize), device="cuda", generator=gen)
        listed = ((k, k), (s, s), cin, cout) in common.F64_WEIGHT_GRAD_SHAPES

        def wgrad(weight, xb, gb, f64_weight_grad=False):
            return grad(lambda v: (common.conv2d(xb, v, None, (s, s), padding, 1, f64_weight_grad) * gb).sum())(weight)

        def run(dtype, f64_weight_grad=False):
            return vmap(lambda xb, gb: wgrad(w.to(dtype), xb.to(dtype), gb.to(dtype), f64_weight_grad))(x, g)

        want = run(torch.float64)
        got = run(torch.float32, listed)
        torch.cuda.synchronize()
        scale = want.abs().flatten(1).max(dim=1).values
        err = float(((got.double() - want).abs().flatten(1).max(dim=1).values / scale).max())
        f32_ms = time_ms(lambda: run(torch.float32), torch, iters=5, warmup=1)
        f64_ms = time_ms(lambda: run(torch.float32, True), torch, iters=5, warmup=1)
        # cuDNN's float32 error even where the float64 path is taken: the measurement behind the choice
        cudnn = err if not listed else float(((run(torch.float32).double() - want).abs().flatten(1).max(dim=1).values
                                              / scale).max())
        print("zoo weight gradient %-26s x (%d, %d, %d, %d, %d) on %s: cuDNN float32 %.3g of the largest entry, "
              "%s %.3g (tolerance %g); float32 %.3f ms, float64 weight gradient %.3f ms"
              % (label, ZOO_N, batch, cin, size, size, card_line(), cudnn,
                 "taken: the float64 path" if listed else "taken: cuDNN float32", err, VMAP_RTOL, f32_ms, f64_ms))
        out[label] = (cudnn, err, f32_ms, f64_ms, listed)
        del x, g, want, got
    torch.cuda.empty_cache()
    wrong = [label for label, (cudnn, err, _, _, listed) in out.items() if err > VMAP_RTOL]
    check(not wrong, "zoo weight gradient beyond %g of the largest entry at %s: list those shapes in "
          "F64_WEIGHT_GRAD_SHAPES" % (VMAP_RTOL, ", ".join(wrong)))
    return out


def _zoo_leg(torch, kernels, runner, label, argv, expected):
    """Drive one zoo leg through the runner with the vmap fallback an error;
    check its launches a step; returns (result, counts, peak MB)."""
    import contextlib
    import io
    import warnings

    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    output = io.StringIO()
    with warnings.catch_warnings(), contextlib.redirect_stdout(output), contextlib.redirect_stderr(output):
        warnings.filterwarnings("error", message=VMAP_FALLBACK)
        result = runner.main(["--seed", "1", "--evaluation-period", "-1", *argv])
    text = output.getvalue()
    sys.stdout.write("".join(line + "\n" for line in text.splitlines() if "Training" in line or "stand-in" in line))
    counts = kernels.launch_counts()
    steps = result["steps"]
    check(result["final_loss"] is not None and math.isfinite(result["final_loss"]), "%s: non-finite loss" % label)
    for name in kernels.KERNELS:
        want = steps * (1 if name in expected else 0)
        check(counts[name] == want, "%s: %s launched %d times in %d steps (want %d)"
              % (label, name, counts[name], steps, want))
    return result, counts, torch.cuda.max_memory_allocated() / 2**20, text


def zoo_z5_half(torch, gars, kernels, models, device):
    """One half of Z5 on ``device``: one Bulyan step of resnet_v1_50 on
    digits32 (n = 7, f = 1, batch 2) from ``init(3)`` and the iterator's
    seed-4 batch, on experiments of its own (a second one converted to
    float64 for the float64 gradients); returns CPU copies of the initial weights, the worker rows,
    Bulyan's selection weights, the aggregate and the rows in float64.  The
    CPU half runs on a thread beside the zoo's card legs."""
    from aggregathor_tpu_torch.core import FlatMap
    from aggregathor_tpu_torch.parallel import RobustEngine

    n, f = 7, 1
    args = ("slim-resnet_v1_50-digits32", ["batch-size:2", "preprocessing:none"])
    exp = models.instantiate(*args)
    params = exp.init(3)
    batch = next(exp.make_train_iterator(n, seed=4))
    engine = RobustEngine(gars.instantiate("bulyan", n, f), n, device=device)
    on = {k: v.to(device) for k, v in params.items()}
    _, rows = engine._worker_gradients(on, engine.put_batch(batch), exp.loss, FlatMap(on))
    weights = engine.gar.selection_weights(kernels.pairwise_sq_distances(rows)).cpu()
    aggregate = engine.gar.aggregate(rows).cpu()
    # the same gradients in float64 (every layer's compute dtype float64):
    # the card's convs, norms and pools against the CPU's, on an experiment
    # converted before its first call (off the main thread the loss runs a
    # copy of the module made at that call, models.thread_module)
    exp = models.instantiate(*args)
    exp.model.double()
    for m in exp.model.modules():
        if isinstance(getattr(m, "dtype", None), torch.dtype):
            m.dtype = torch.float64
    on = {k: v.double().to(device) for k, v in params.items()}
    images = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
    grads = torch.func.vmap(torch.func.grad(exp.loss), in_dims=(None, 0))(on, images)
    f64 = torch.cat([grads[name].flatten(1) for name in sorted(grads)], dim=1).cpu()
    return {k: v.cpu() for k, v in params.items()}, rows.cpu(), weights, aggregate, f64


def zoo_card_cpu(torch, gars, kernels, models, cpu_half):
    """Z5: the card's half (``zoo_z5_half``) against the CPU's, ``cpu_half``
    (a future of the thread that ran it): the same initial weights, the
    worker gradients and the aggregate within ``ZOO_CARD_CPU_RTOL`` of
    their largest magnitudes, Bulyan's selections identical, and the float64
    gradients within ``ZOO_CARD_CPU_F64_RTOL``."""
    begin = time.perf_counter()
    card = zoo_z5_half(torch, gars, kernels, models, "cuda")
    waited = time.perf_counter()
    cpu = cpu_half.result()
    waited = time.perf_counter() - waited
    (p_card, r_card, w_card, a_card, f_card), (p_cpu, r_cpu, w_cpu, a_cpu, f_cpu) = card, cpu
    check(all(torch.equal(p_card[k], p_cpu[k]) for k in p_cpu), "zoo Z5: the two halves' initial weights differ")
    row_err = float(((r_card - r_cpu).abs().max(dim=1).values / r_cpu.abs().max(dim=1).values).max())
    agg_err = float((a_card - a_cpu).abs().max() / a_cpu.abs().max())
    same = torch.equal(w_card > 0, w_cpu > 0)
    f64_err = float(((f_card - f_cpu).abs().max(dim=1).values / f_cpu.abs().max(dim=1).values).max())
    print("zoo Z5 resnet_v1_50-digits32 bulyan n=7 f=1 batch 2, card vs CPU from one init and batch on %s: worker "
          "gradients %.3g, aggregate %.3g of their largest magnitudes (tolerance %g), Bulyan's selections %s; in "
          "float64 the worker gradients %.3g (tolerance %g); the card's half %.1f s, then %.1f s waiting for the "
          "CPU's (run on a thread beside the zoo's legs)"
          % (card_line(), row_err, agg_err, ZOO_CARD_CPU_RTOL, "identical" if same else "DIFFER", f64_err,
             ZOO_CARD_CPU_F64_RTOL, time.perf_counter() - begin - waited, waited))
    check(row_err <= ZOO_CARD_CPU_RTOL and agg_err <= ZOO_CARD_CPU_RTOL, "zoo Z5: card and CPU differ")
    check(same, "zoo Z5: Bulyan's selections differ between the card and the CPU")
    check(f64_err <= ZOO_CARD_CPU_F64_RTOL, "zoo Z5: card and CPU differ in float64")


def zoo_kernel_rows(torch, kernels):
    """K1 (staged tiles) and K4 (registers, beta = 2) at the zoo's widths:
    held against their plain versions and timed, as the kernel phase's rows."""
    gen = torch.Generator(device="cuda").manual_seed(20261019)
    library = {"pairwise_sq_distances": lambda x: torch.cdist(x, x).square(), "coordinate_averaged_median": None}
    rows = []
    for experiment, d in ZOO_D.items():
        for name, n, args in (("pairwise_sq_distances", ZOO_N, ()),
                              ("coordinate_averaged_median", ZOO_N - 2 * ZOO_F - 2, (ZOO_N - 4 * ZOO_F - 2,))):
            x = torch.randn((n, d), device="cuda", generator=gen)
            got = getattr(kernels, name)(x, *args)
            torch.cuda.synchronize()
            err = compare(name, got, kernels.PLAIN[name](x, *args), torch, x, args)
            row = timed_row(torch, kernels, name, x, args, library[name], err)
            for iters in (5, 2, 1):  # 20 traced calls lost events at these widths: fewer
                if row["device_ms"] is None:
                    row["device_ms"] = device_ms(lambda: getattr(kernels, name)(x, *args), torch, iters=iters)
            row.update(name=name, experiment=experiment)
            print("zoo kernel %-27s (%d, %d) %s: %.4f ms (on the card %s ms), plain %.3f ms, library %s ms, bound "
                  "%.3f ms (%s), max |err| %g, on %s"
                  % (name, n, d, experiment, row["ms"], "not measured" if row["device_ms"] is None
                     else "%.4f" % row["device_ms"], row["plain_ms"],
                     "%.3f" % row["library_ms"] if row["library_ms"] is not None else "none",
                     row["bound_ms"], row["bound_by"], err, card_line()))
            rows.append(row)
            del x, got
            torch.cuda.empty_cache()
    return rows


def zoo_phase(torch, gars, kernels, models, runner, card, beside=None):
    """The model zoo on the card (``models/zoo.py``); returns {kernel:
    launches} over its legs.  ``beside()``, when given, is called before Z4:
    it waits for work started beside the card legs before it (the digits
    anchors' child), so that Z4's budget is its own.

    - the conv weight gradient: cuDNN's float32 one against float64 at
      every ResNet-50 conv shape of the legs (``zoo_weight_grads``);
    - Z1: ``slim-resnet_v1_50-digits32`` + Bulyan at n = 32, f = 7 (r = 7
      signflip), batch 16 a worker, 6 steps: d = 23,519,690, K1 (staged
      tiles) and K4 (beta = 2) once a step; its breakdown, and the
      gradient phase with every weight gradient in float64;
    - Z2: ``slim-resnet_v1_50-imagenet`` at 224x224 (the synthetic
      stand-in), batch 2, the same rule, 3 steps: d = 25,557,032;
    - Z3: ``slim-resnet_v1_18-digits32`` + krum (n = 8, f = 2), batch 8,
      polynomial decay 0.05 -> 0.005 over 400 steps: real test accuracy >=
      ``ZOO_ANCHOR_FLOOR``;
    - Z4: each of the 34 nets on digits32, median at n = 3, batch 2, 2 steps:
      finite losses, K3 once a step, no vmap fallback, within
      ``ZOO_NAMES_BUDGET_S``;
    - Z5: card against CPU (``zoo_card_cpu``), the CPU's half on a thread
      from the phase's start, beside the card legs;
    - K1 and K4 at Z1's and Z2's widths (``zoo_kernel_rows``).
    Every leg runs with the vmap fallback's warning turned into an error."""
    from aggregathor_tpu_torch.models import zoo

    totals = {name: 0 for name in kernels.KERNELS}
    pool = concurrent.futures.ThreadPoolExecutor(1)
    cpu_half = pool.submit(zoo_z5_half, torch, gars, kernels, models, "cpu")
    pool.shutdown(wait=False)
    zoo_weight_grads(torch)
    # Z1's memory, reckoned before the run: the (32, d) float32 rows, three
    # more (n, d) buffers in select_combine, and the vmap's activations
    d = ZOO_D["slim-resnet_v1_50-digits32"]
    print("zoo Z1 memory reckoned: rows %.2f GB, select_combine's buffers %.2f GB, activations of %d images at "
          "32x32 ~%.0f GB (~47 MB an image)" % (ZOO_N * d * 4 / 1e9, 3 * ZOO_N * d * 4 / 1e9, ZOO_N * 16,
                                               ZOO_N * 16 * 47e6 / 1e9))
    for label, argv, expected in ZOO_LEGS:
        start = time.perf_counter()
        result, counts, peak_mb, text = _zoo_leg(torch, kernels, runner, label, argv, expected)
        for name, count in counts.items():
            totals[name] += count
        experiment = argv[1]
        if experiment in ZOO_D:
            check("d=%d" % ZOO_D[experiment] in text, "%s: d is not %d" % (label, ZOO_D[experiment]))
        accuracy = result["evaluation"]["accuracy"] if result["evaluation"] else None
        print("zoo leg %s: %d steps, %.3f steps/s excl. 1st on %s, final loss %.4f, accuracy %s, peak %.0f MB, "
              "%.1f s, launches %s" % (label, result["steps"], result["steps_per_s"], card, result["final_loss"],
                                       "%.4f" % accuracy if accuracy is not None else "-", peak_mb,
                                       time.perf_counter() - start, json.dumps(counts, sort_keys=True)))
        if label.startswith("Z3"):
            check(accuracy is not None and accuracy >= ZOO_ANCHOR_FLOOR,
                  "%s: test accuracy %s < %g" % (label, accuracy, ZOO_ANCHOR_FLOOR))
        if label.startswith("Z1"):
            per_step, _ = breakdown_phase(torch, gars, models, steps=3, experiment=argv[1],
                                          args=["batch-size:16", "preprocessing:none"],
                                          rule=("bulyan", ZOO_N, ZOO_F))
            print("zoo Z1 split at d = %d on %s: worker gradients %.2f ms, attack + aggregate %.2f ms a step "
                  "(gradient share %.3f of the two)"
                  % (d, card, per_step["worker gradients"], per_step["attack + aggregate"],
                     per_step["worker gradients"] / (per_step["worker gradients"] + per_step["attack + aggregate"])))
            zoo_f64_cost(torch, gars, models, argv[1])
    if beside is not None:
        beside()
    # Z4: every name of the factory
    start = time.perf_counter()
    for name in sorted(zoo.MODEL_FACTORY):
        t0 = time.perf_counter()
        result, counts, peak_mb, text = _zoo_leg(
            torch, kernels, runner, "Z4 " + name,
            ["--experiment", "slim-%s-digits32" % name, "--experiment-args", "batch-size:2", "preprocessing:none",
             "--aggregator", "median", "--nb-workers", "3", "--nb-decl-byz-workers", "1", "--max-step", "2",
             "--evaluation-delta", "-1"], ("coordinate_median",))
        for kernel, count in counts.items():
            totals[kernel] += count
        width = [line for line in text.splitlines() if "Training" in line][0].rsplit("d=", 1)[1]
        print("zoo Z4 %-20s d=%s, final loss %.4f, %.1f ms a step excl. 1st, %.1f s with set-up, peak %.0f MB"
              % (name, width, result["final_loss"], 1e3 / result["steps_per_s"], time.perf_counter() - t0, peak_mb))
    elapsed = time.perf_counter() - start
    print("zoo Z4: the %d nets in %.1f s on %s (budget %.0f s)" % (len(zoo.MODEL_FACTORY), elapsed, card,
                                                                    ZOO_NAMES_BUDGET_S))
    check(elapsed <= ZOO_NAMES_BUDGET_S, "zoo Z4 took %.1f s (budget %.0f s)" % (elapsed, ZOO_NAMES_BUDGET_S))
    zoo_card_cpu(torch, gars, kernels, models, cpu_half)
    zoo_kernel_rows(torch, kernels)
    return totals


def zoo_f64_cost(torch, gars, models, experiment):
    """Z1's worker-gradient phase with cuDNN's float32 weight gradients and
    with every conv's weight gradient in float64: the cost a blanket float64
    rule would add."""
    from aggregathor_tpu_torch.core import FlatMap
    from aggregathor_tpu_torch.models.common import Conv
    from aggregathor_tpu_torch.parallel import RobustEngine

    exp = models.instantiate(experiment, ["batch-size:16", "preprocessing:none"])
    engine = RobustEngine(gars.instantiate("bulyan", ZOO_N, ZOO_F), ZOO_N, device="cuda")
    params = {k: v.cuda() for k, v in exp.init(1).items()}
    batch = engine.put_batch(next(exp.make_train_iterator(ZOO_N, seed=2)))
    flatmap = FlatMap(params)
    convs = [m for m in exp.model.modules() if isinstance(m, Conv)]
    times = {}
    for label, flag in (("float32", False), ("float64 weight gradients", True)):
        for m in convs:
            m.f64_weight_grad = flag
        times[label] = time_ms(lambda: engine._worker_gradients(params, batch, exp.loss, flatmap), torch,
                               iters=2, warmup=1)
    print("zoo Z1 worker gradients (n = %d, batch 16, resnet_v1_50) on %s: %.1f ms with cuDNN's float32 weight "
          "gradients, %.1f ms with all %d convs' in float64" % (ZOO_N, card_line(), times["float32"],
                                                                times["float64 weight gradients"], len(convs)))
    del params, batch, engine
    torch.cuda.empty_cache()


#: BASELINE config 5 at the JAX package's single-chip widths (config 5f,
#: benchmarks/train_configs.py:147-160): d = 8,917,248 over 12 leaves, krum at
#: n = 8, f = r = 2 (signflip).  The bytes are the Python stdlib's
#: (``corpus-source:code``, vocab max(1024, 256) = 1024, so d is unchanged):
#: the Markov stream at vocab 1024 draws a (1024, 1024, 1024) float64
#: transition table of 8.6 GB (1024^3 float64 values) for each experiment
#: built, host work that is not the system under test
TFM_ARGS = ["d-model:256", "heads:4", "layers:8", "seq:256", "batch-size:8", "vocab:1024", "corpus-source:code",
            "corpus:500000"]
TFM_D = 8917248
TFM_LEAVES = 12
#: the 12 leaves' sizes: embed and unembed 262,144, final_norm 256, the two
#: stacked norms 2,048, wq/wk/wv/wo 524,288, the three MLP weights 2,097,152
TFM_LEAF_SIZES = 5
TFM_BUCKETS = 75  # 9 stacked leaves x 8 layers + 3 under granularity layer
TFM_BASE = ["--experiment", "transformer", "--experiment-args", *TFM_ARGS, "--nb-workers", "8",
            "--nb-decl-byz-workers", "2", "--nb-real-byz-workers", "2", "--attack", "signflip",
            "--evaluation-period", "-1", "--evaluation-delta", "-1"]
TFM_SHARDED = ["--mesh", "1,1,1", "--microbatches", "2"]
#: (label, argv, steps, {kernel: launches a step})
TFM_LEGS = [
    # flat leaf runs bucketed on the card: K1 batched once a leaf size
    ("T1 config 5f flat leaf", ["--aggregator", "krum", "--granularity", "leaf"], 6,
     {batched("pairwise_sq_distances"): TFM_LEAF_SIZES}),
    ("T2 config 5 sharded layer", ["--aggregator", "krum", "--granularity", "layer", *TFM_SHARDED], 6,
     {"nanmedian_columns": TFM_BUCKETS, "pairwise_sq_distances_gram": TFM_BUCKETS}),
    ("T3 sharded global", ["--aggregator", "krum", "--granularity", "global", *TFM_SHARDED], 5,
     {"nanmedian_columns": TFM_LEAVES, "pairwise_sq_distances_gram": TFM_LEAVES}),
    ("T3 sharded median", ["--aggregator", "median", "--granularity", "layer", *TFM_SHARDED], 5,
     {"coordinate_median": TFM_BUCKETS}),
]
#: T4: the card's first sharded step against the CPU's, from one init and
#: batch: each bucket's aggregate within this share of its largest magnitude
#: (float32 gradients summed in other orders over 16,384 tokens), the loss
#: within it relative.  A control step on the card with TF32 matmuls must
#: land outside it, so a gradient path that slipped to a lower precision
#: fails T4
TFM_CARD_CPU_RTOL = 1e-5
#: T5: the (1, 2, 2) grid against one rank, and the card's grid against the
#: CPU's, each leaf within this share of its largest magnitude
TFM_GRID_RTOL = 1e-5
TFM_GRID_A = dict(vocab_size=1024, d_model=256, n_heads=4, n_layers=4)
TFM_GRID_B = dict(vocab_size=1024, d_model=128, n_heads=2, n_layers=4, n_experts=4)
#: T6 (docs/robustness.md:326-331): the held-out nll below this share of the
#: corpus's own unigram entropy (JAX tests/test_transformer.py:441-470)
TFM_REAL_SHARE = 0.95


def _tfm_leg(torch, kernels, runner, label, argv, steps, per_step):
    """One transformer leg through the runner: exact launches a step,
    finite loss; returns (result, peak MB)."""
    import contextlib
    import io

    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    output = io.StringIO()
    with contextlib.redirect_stdout(output), contextlib.redirect_stderr(output):
        result = runner.main(["--seed", "1", *TFM_BASE, *argv, "--max-step", str(steps)])
    sys.stdout.write("".join(line + "\n" for line in output.getvalue().splitlines() if "Training" in line))
    counts = dict(kernels.launch_counts(), **{batched(name): count
                                              for name, count in kernels.batched_launch_counts().items()})
    check(result["final_loss"] is not None and math.isfinite(result["final_loss"]), "%s: non-finite loss" % label)
    check(result["steps"] == steps, "%s: ran %d steps (want %d)" % (label, result["steps"], steps))
    for name in counts:
        want = steps * per_step.get(name, 0)
        check(counts[name] == want, "%s: %s launched %d times in %d steps (want %d)"
              % (label, name, counts[name], steps, want))
    return result, counts, torch.cuda.max_memory_allocated() / 2**20


def _tfm_engine(gars, attacks, rule, device, **options):
    from aggregathor_tpu_torch.parallel import RobustEngine

    n, f, r = 8, 2, 2
    return RobustEngine(gars.instantiate(rule, n, f), n, nb_real_byz=r, attack=attacks.instantiate("signflip", n, r),
                        device=device, **options)


def _tfm_buckets(engine, grads):
    """The (n, d_b) rows of every bucket of a sharded step's gradients
    (before the attack), in the step's order."""
    buckets = []
    for name in sorted(grads):
        rows = engine._gather_rows(engine._leaf_buckets(grads[name], engine._specs[name]))
        buckets += [rows[b] for b in range(rows.shape[0])]
    return buckets


def _tfm_times(torch, gars, models):
    """Gradient, GAR and distance ms a step of T1 (flat, leaf) and T2
    (sharded, layer) on one batch, by CUDA events (3 calls after one)."""
    from aggregathor_tpu_torch.core import FlatMap, build_optimizer, build_schedule
    from aggregathor_tpu_torch.parallel import attacks
    from aggregathor_tpu_torch.parallel.engine import gar_key

    exp = models.instantiate("transformer", TFM_ARGS)
    batch = next(exp.make_train_iterator(8, seed=2))
    tx = build_optimizer("sgd", build_schedule("fixed", []))
    out = {}
    flat = _tfm_engine(gars, attacks, "krum", "cuda", granularity="leaf")
    state = flat.init_state(exp.init(1), tx, seed=1)
    fmap, on = FlatMap(state.params), flat.put_batch(batch)
    check(fmap.size == TFM_D and len(fmap.slices) == TFM_LEAVES, "transformer: d = %d over %d leaves (want %d over %d)"
          % (fmap.size, len(fmap.slices), TFM_D, TFM_LEAVES))
    out["T1 gradient"] = time_ms(lambda: flat._worker_gradients(state.params, on, exp.loss, fmap), torch, 3, 1)
    _, rows = flat._worker_gradients(state.params, on, exp.loss, fmap)
    with torch.no_grad():
        out["T1 GAR"] = time_ms(lambda: flat._aggregate_per_leaf(rows, fmap, None, gar_key(1, 0)), torch, 3, 1)
    del state, rows
    sharded = _tfm_engine(gars, attacks, "krum", "cuda", sharding="sharded", granularity="layer")
    state = sharded.init_state(exp.sharded_init(1), exp.sharded_specs(), tx, seed=1)
    check(sharded.model_dim == TFM_D, "transformer: the sharded d = %d" % sharded.model_dim)
    loss, on = exp.sharded_loss(1, 2), sharded.put_batch(batch)
    out["T2 gradient"] = time_ms(lambda: sharded._sharded_worker_gradients(state.params, on, loss), torch, 3, 1)
    _, grads = sharded._sharded_worker_gradients(state.params, on, loss)
    buckets = _tfm_buckets(sharded, grads)
    from aggregathor_tpu_torch.gars.common import centered_gram_sq_distances

    gar = sharded.gar
    with torch.no_grad():
        out["T2 distances"] = time_ms(lambda: [centered_gram_sq_distances(b) for b in buckets], torch, 3, 1)
        out["T2 GAR"] = time_ms(lambda: [gar.aggregate_block(b, centered_gram_sq_distances(b)) for b in buckets],
                                torch, 3, 1)
    del state, grads, buckets
    torch.cuda.empty_cache()
    return out


def _tfm_card_cpu(torch, gars, models):
    """T4: T2's first step (the gradients, each bucket's distances, Krum's
    selection and aggregate) on the card and on the port's CPU from the same
    carried-over weights and batch; then the card's step again with TF32
    matmuls, the control that the tolerance must reject."""
    from aggregathor_tpu_torch.core import build_optimizer, build_schedule
    from aggregathor_tpu_torch.gars.common import centered_gram_sq_distances
    from aggregathor_tpu_torch.parallel import attacks

    exp = models.instantiate("transformer", TFM_ARGS)
    batch = next(exp.make_train_iterator(8, seed=2))
    weights = exp.sharded_init(1)(1)
    tx = build_optimizer("sgd", build_schedule("fixed", []))
    def first_step(device):
        engine = _tfm_engine(gars, attacks, "krum", device, sharding="sharded", granularity="layer")
        state = engine.init_state(lambda seed: weights, exp.sharded_specs(), tx, seed=1)
        losses, grads = engine._sharded_worker_gradients(state.params, engine.put_batch(batch),
                                                         exp.sharded_loss(1, 2))
        with torch.no_grad():
            sel, aggs = [], []
            for bucket in _tfm_buckets(engine, grads):
                dist2 = centered_gram_sq_distances(bucket)
                sel.append((engine.gar.selection_weights(dist2) > 0).cpu())
                aggs.append(engine.gar.aggregate_block(bucket, dist2).cpu())
        return losses.cpu(), sel, aggs

    got = {}
    # the CPU's step on a thread beside the card's two (the TF32 flag is
    # the card's alone)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        cpu = pool.submit(first_step, "cpu")
        for run in ("cuda", "tf32"):
            torch.backends.cuda.matmul.allow_tf32 = run == "tf32"
            try:
                got[run] = first_step("cuda")
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
        got["cpu"] = cpu.result()

    def compare(card):
        (lc, sc, ac), (lh, sh, ah) = got[card], got["cpu"]
        same = all(torch.equal(a, b) for a, b in zip(sc, sh))
        agg_err = max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(ac, ah))
        return same, agg_err, float(((lc - lh).abs() / lh.abs()).max())

    (same, agg_err, loss_err), (c_same, c_agg, c_loss) = compare("cuda"), compare("tf32")
    print("transformer T4 config 5 sharded layer, first step card vs CPU from one init and batch on %s: %d buckets, "
          "Krum's selections %s, aggregates within %.3g of their largest magnitude, losses within %.3g relative "
          "(tolerance %g); the control with TF32 matmuls: selections %s, aggregates %.3g, losses %.3g"
          % (card_line(), len(got["cuda"][1]), "identical" if same else "DIFFER", agg_err, loss_err,
             TFM_CARD_CPU_RTOL, "identical" if c_same else "differ", c_agg, c_loss))
    check(len(got["cuda"][1]) == TFM_BUCKETS, "transformer T4: %d buckets (want %d)"
          % (len(got["cuda"][1]), TFM_BUCKETS))
    check(same, "transformer T4: Krum's selections differ between the card and the CPU")
    check(agg_err <= TFM_CARD_CPU_RTOL and loss_err <= TFM_CARD_CPU_RTOL, "transformer T4: card and CPU differ")
    check(not c_same or c_agg > TFM_CARD_CPU_RTOL or c_loss > TFM_CARD_CPU_RTOL,
          "transformer T4: the tolerance %g does not reject the TF32 control" % TFM_CARD_CPU_RTOL)


def transformer_grid_rank(axis, cases, bounded=()):
    """One rank of T5 and of U1/U2 (a spawned process re-imports this
    module): for each ``(case, weights, batches)`` of ``cases``, the sharded
    engine on the case's grid, median at n = 4, f = 1, layer, from the
    global ``weights``; per-step losses and this rank's launches, the global
    parameters on rank 0.  Then each ``(leg, weights, batches, journal)`` of
    ``bounded`` (``sharded_bounded_leg``).  Returns both lists."""
    import torch

    from aggregathor_tpu_torch.parallel import mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    out = []
    for case, weights, batches in cases:
        W, PP, TP = case["mesh"]
        out.append(_tfm_grid_run(mesh.make_mesh(W, TP, PP, device=axis.device), case, weights, batches))
    legs = []
    for leg, weights, batches, journal in bounded:
        W, PP, TP = leg[1]
        legs.append(sharded_bounded_leg(mesh.make_mesh(W, TP, PP, device=axis.device), leg, weights, batches,
                                        journal))
    return out, legs


def _tfm_grid_run(grid, case, weights, batches):
    """The sharded engine on ``grid``, median at n = 4, f = 1, layer, from
    the global ``weights``, one step a batch."""
    import torch

    from aggregathor_tpu_torch import gars
    from aggregathor_tpu_torch.core import build_optimizer, build_schedule
    from aggregathor_tpu_torch.models import transformer as tfm
    from aggregathor_tpu_torch.ops import kernels
    from aggregathor_tpu_torch.parallel import ShardedRobustEngine

    cfg = tfm.TransformerConfig(**case["cfg"])
    pp = grid.shape["pipe"]
    tx = build_optimizer("sgd", build_schedule("fixed", ["initial-rate:0.1"]))
    engine = ShardedRobustEngine(grid, gars.instantiate("median", 4, 1), nb_workers=4, granularity="layer",
                                 device=grid.device)
    state = engine.init_state(lambda seed: {k: torch.as_tensor(v) for k, v in weights.items()},
                              tfm.param_specs(cfg), tx, seed=1)
    step = engine.build_step(tfm.make_pipeline_loss(cfg, pp, 2), tx)
    kernels.reset_launch_counts()
    out = {"loss": [], "ms": []}
    for batch in batches:
        begin = time.perf_counter()
        state, metrics = step(state, engine.put_batch(batch))
        out["loss"].append(float(metrics["total_loss"]))
        out["ms"].append((time.perf_counter() - begin) * 1e3)
    out["counts"] = kernels.launch_counts()
    if grid.device.type == "cuda":
        out["peak_mb"] = torch.cuda.max_memory_allocated() / 2**20
    snapshot = engine.global_state(state)
    out["params"] = None if grid.rank else {k: v.detach().cpu().numpy() for k, v in snapshot.params.items()}
    return out


#: U1, U2: bounded-wait on the sharded engine, config 5 at its published
#: width (TFM_ARGS' model, d = 8,917,248), n = 8, batch 8 of 256 tokens, in
#: T5's spawn of four gloo ranks sharing the card, a fixed 1 s window, the
#: first unit (workers 0 .. k - 1) stalled ``SB_STALL`` s from round 1 on;
#: (label, grid (W, PP, TP), rule, f, rounds, the kernel each rank launches
#: once a round on its (8, ceil(d / 4)) column block)
SB_LEGS = (("U1", (4, 1, 1), "krum", 2, 3, "pairwise_sq_distances"),
           ("U2", (2, 2, 1), "average-nan", 4, 2, "average_nan_columns"))
SB_CFG = dict(vocab_size=1024, d_model=256, n_heads=4, n_layers=8)
SB_N, SB_BATCH, SB_SEQ = 8, 8, 256
SB_STALL = 4.0
SB_DEADLINE = 1.0
SB_RTOL = 1e-5
SB_BLOCK = -(-TFM_D // 4)


class FirstUnitLate:
    """The straggler model of U1 and U2: from round 1 on, workers 0 .. k - 1
    (the first unit) hold their submissions ``SB_STALL`` seconds."""

    def __init__(self, k):
        self.k = k

    def delay(self, step, worker):
        return SB_STALL if step >= 1 and worker < self.k else 0.0


def _sb_staged(axes):
    """(bytes, seconds) of the distinct collective counters of ``axes``."""
    seen = {id(axis.stats): axis.stats for axis in axes if axis is not None}
    return sum(v["bytes"] for v in seen.values()), sum(v["seconds"] for v in seen.values())


def sharded_bounded_leg(grid, leg, weights, batches, journal):
    """One leg of U1/U2 on ``grid`` (``BoundedWaitStep`` over the sharded
    engine, granularity global), the lead's journal in ``journal``: per
    round the masks, the loss, its ms to the update's end and the verdicts'
    gather ms; this rank's launches over the rounds, the kernels built after
    round 0, the staged MB a round (the submission's groups' share and
    seconds apart); the global parameters (rank 0)."""
    import torch

    from aggregathor_tpu_torch import gars
    from aggregathor_tpu_torch.core import build_optimizer, build_schedule
    from aggregathor_tpu_torch.models import transformer as tfm
    from aggregathor_tpu_torch.obs import events
    from aggregathor_tpu_torch.ops import build, kernels
    from aggregathor_tpu_torch.parallel import RobustEngine
    from aggregathor_tpu_torch.parallel.bounded import BoundedWaitStep

    import numpy as np

    label, (W, PP, TP), rule, f, rounds, _ = leg
    cfg = tfm.TransformerConfig(**SB_CFG)
    tx = build_optimizer("sgd", build_schedule("fixed", ["initial-rate:0.05"]))
    engine = RobustEngine(gars.instantiate(rule, SB_N, f), SB_N, sharding="sharded", mesh=grid, granularity="global",
                          device=grid.device)
    template = {name: torch.as_tensor(value) for name, value in weights.items()}
    state = engine.init_state(lambda seed: template, tfm.param_specs(cfg), tx, seed=1)
    if grid.rank == 0:
        events.install(journal, run_id=label)
    step = BoundedWaitStep(engine, tfm.make_pipeline_loss(cfg, PP, 1), tx, template, deadline=SB_DEADLINE,
                           straggler_model=FirstUnitLate(SB_N // W))
    placed = [engine.put_batch(batch) for batch in batches[:rounds]]
    own = step.grad_fn.grid if hasattr(step.grad_fn, "grid") and step.grad_fn.grid is not grid else None
    axes = [grid.world, grid.worker, grid.pipe, grid.model, grid.group, engine.axis]
    sub = [own.pipe, own.model, own.group] if own is not None else []
    builds = []

    def note_build(*args):
        builds.append(args)

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    before, sub_before = _sb_staged(axes + sub), _sb_staged(sub)
    out = {"rounds": [], "round_ms": [], "gather_ms": [], "arrival_s": []}
    try:
        for i, batch in enumerate(placed):
            if i == 1:
                build.add_build_listener(note_build)  # what builds after the first round
            begin = time.perf_counter()
            state, metrics = step(state, batch)
            torch.cuda.synchronize()
            out["round_ms"].append((time.perf_counter() - begin) * 1e3)
            out["gather_ms"].append(step.last_gather_s * 1e3)
            arrivals = step.last_arrivals
            out["arrival_s"].append(float(arrivals[np.isfinite(arrivals)].max()))
            out["rounds"].append({key: metrics[key].cpu().numpy() for key in
                                  ("straggler_timeout", "stale_infill", "worker_participation", "total_loss")
                                  if key in metrics})
    finally:
        build.remove_build_listener(note_build)
        step.close()
        if grid.rank == 0:
            events.uninstall()
    out["counts"] = kernels.launch_counts()
    out["batched"] = sum(kernels.batched_launch_counts().values())
    after, sub_after = _sb_staged(axes + sub), _sb_staged(sub)
    out["staged_mb"] = (after[0] - before[0]) / 2**20 / rounds
    out["sub_mb"] = (sub_after[0] - sub_before[0]) / 2**20 / rounds
    out["sub_ms"] = (sub_after[1] - sub_before[1]) * 1e3 / rounds
    out["builds"] = builds
    snapshot = engine.global_state(state)
    out["params"] = None if grid.rank else {k: v.detach().cpu().numpy() for k, v in snapshot.params.items()}
    del state, snapshot, placed, engine, step
    torch.cuda.empty_cache()
    return out


def _sb_flat(torch, leg, weights, batches):
    """The one-rank flat bounded engine on the card from the same (merged)
    weights and batches, the same unit's workers late: per round the masks
    and loss, the parameters."""
    from aggregathor_tpu_torch import gars
    from aggregathor_tpu_torch.core import build_optimizer, build_schedule
    from aggregathor_tpu_torch.models import transformer as tfm
    from aggregathor_tpu_torch.parallel import RobustEngine
    from aggregathor_tpu_torch.parallel.bounded import BoundedWaitStep

    label, (W, _, _), rule, f, rounds, _ = leg
    cfg = tfm.TransformerConfig(**SB_CFG)
    tx = build_optimizer("sgd", build_schedule("fixed", ["initial-rate:0.05"]))
    engine = RobustEngine(gars.instantiate(rule, SB_N, f), SB_N, device="cuda")
    params = {name: torch.as_tensor(value) for name, value in weights.items()}
    state = engine.init_state(params, tx, seed=1)
    step = BoundedWaitStep(engine, lambda p, b: tfm.loss_dense(p, b, cfg), tx, params, deadline=SB_DEADLINE,
                           straggler_model=FirstUnitLate(SB_N // W))
    out = {"rounds": [], "round_ms": []}
    try:
        for batch in batches[:rounds]:
            begin = time.perf_counter()
            state, metrics = step(state, engine.put_batch(batch))
            torch.cuda.synchronize()
            out["round_ms"].append((time.perf_counter() - begin) * 1e3)
            out["rounds"].append({key: metrics[key].cpu().numpy() for key in ("straggler_timeout", "total_loss")})
    finally:
        step.close()
    out["params"] = {k: v.detach().cpu().numpy() for k, v in state.params.items()}
    del state, engine, step
    torch.cuda.empty_cache()
    return out


def _sb_inputs():
    """U1/U2's global weights by the grid's PP (stacked leaves (PP, L/PP,
    ...): the same values), the merged (one-stage) weights and the batches."""
    import numpy as np
    import torch

    from aggregathor_tpu_torch.models import transformer as tfm

    merged = {k: v.numpy() for k, v in tfm.init_params(tfm.TransformerConfig(**SB_CFG),
                                                      torch.Generator().manual_seed(23), 1).items()}

    def staged(pp):
        return {k: v if k in tfm.NON_STACKED_LEAVES else v.reshape((pp, v.shape[1] // pp) + v.shape[2:])
                for k, v in merged.items()}

    rng = np.random.default_rng(29)
    batches = [{"tokens": rng.integers(0, SB_CFG["vocab_size"], size=(SB_N, SB_BATCH, SB_SEQ)).astype(np.int32),
                "targets": rng.integers(0, SB_CFG["vocab_size"], size=(SB_N, SB_BATCH, SB_SEQ)).astype(np.int32)}
               for _ in range(max(leg[4] for leg in SB_LEGS))]
    return {leg[0]: staged(leg[1][1]) for leg in SB_LEGS}, merged, batches


def _sb_check(torch, kernels, spawned, merged, batches, journals):
    """U1/U2 held against the one-rank flat bounded engine and their
    contract (module docstring); returns {kernel: launches} over the ranks."""
    import numpy as np

    from aggregathor_tpu_torch.obs import events

    totals = {name: 0 for name in kernels.KERNELS}
    for index, leg in enumerate(SB_LEGS):
        label, shape, rule, f, rounds, kernel = leg
        W, k = shape[0], SB_N // shape[0]
        ranks = [rank[1][index] for rank in spawned]
        begin = time.perf_counter()
        flat = _sb_flat(torch, leg, merged, batches)
        flat_s = time.perf_counter() - begin
        for rank, result in enumerate(ranks):
            check(not result["builds"], "sharded bounded %s rank %d: %s built after the first round"
                  % (label, rank, result["builds"]))
            check(result["counts"] == {name: rounds if name == kernel else 0 for name in kernels.KERNELS}
                  and not result["batched"], "sharded bounded %s rank %d: launches %s (want %s %d)"
                  % (label, rank, result["counts"], kernel, rounds))
            totals[kernel] += result["counts"][kernel]
        late = np.arange(SB_N) < k
        for i in range(rounds):
            want = late if i else np.zeros(SB_N, bool)
            for rank, result in enumerate(ranks):
                got = result["rounds"][i]
                check(got["straggler_timeout"].tolist() == want.tolist() == flat["rounds"][i]["straggler_timeout"]
                      .tolist(), "sharded bounded %s round %d rank %d: timed out %s (one rank %s)"
                      % (label, i, rank, got["straggler_timeout"], flat["rounds"][i]["straggler_timeout"]))
                check(np.array_equal(got["total_loss"], ranks[0]["rounds"][i]["total_loss"]),
                      "sharded bounded %s round %d: the ranks' losses differ" % (label, i))
            rel = abs(float(ranks[0]["rounds"][i]["total_loss"]) - float(flat["rounds"][i]["total_loss"])) / abs(
                float(flat["rounds"][i]["total_loss"]))
            check(rel <= SB_RTOL, "sharded bounded %s round %d: loss %r vs one rank's %r" % (
                label, i, float(ranks[0]["rounds"][i]["total_loss"]), float(flat["rounds"][i]["total_loss"])))
        grid_params = ranks[0]["params"]
        err = max(float(np.abs(grid_params[name].reshape(value.shape) - value).max() / np.abs(value).max())
                  for name, value in flat["params"].items())
        check(err <= SB_RTOL, "sharded bounded %s: parameters off the one rank's by %.3g" % (label, err))
        journal = [r for r in events.load_journal(journals[label]) if r["type"] in ("bounded_round", "submesh_timeout")]
        forfeits = [(r["step"], r["group"], r["forfeited"]) for r in journal if r["type"] == "submesh_timeout"]
        skipped = [(r["step"], r["skipped_units"]) for r in journal if r["type"] == "bounded_round"]
        check(forfeits and all(g == 0 and n == k for _, g, n in forfeits), "sharded bounded %s: forfeits %s"
              % (label, forfeits))
        # a warm round either judged the unit late (a submesh_timeout) or
        # skipped it, still submitting an earlier round (bounded_round)
        judged = {s for s, _, _ in forfeits} | {s for s, units in skipped if units == [0]}
        check(judged == set(range(1, rounds)), "sharded bounded %s: rounds judged %s, skipped %s"
              % (label, forfeits, skipped))
        print("sharded bounded %s at %s on %s, 4 gloo ranks sharing the card (staged): config 5 d = %d, n = %d, %s "
              "f = %d, %d rounds, unit 0 (workers 0-%d) stalled %.0f s past a %.1f s window from round 1: masks %s "
              "every warm round, submesh_timeout %s, skipped %s; round ms by rank %s (one rank %s, %.1f s); the latest "
              "arrived unit's s %s (rank 0); verdict gather ms rank 0 %s; staged %.2f MB a round and rank (rank 0; the submission's groups %.2f MB, "
              "%.1f ms); %s once a round a rank on (8, %d): %s; parameters off the one rank's by %.3g of the "
              "largest; no kernel built after round 0"
              % (label, shape, card_line(), TFM_D, SB_N, rule, f, rounds, k - 1, SB_STALL, SB_DEADLINE,
                 late.astype(int).tolist(), forfeits, skipped,
                 "; ".join(", ".join("%.0f" % v for v in r["round_ms"]) for r in ranks),
                 ", ".join("%.0f" % v for v in flat["round_ms"]), flat_s,
                 ", ".join("%.3f" % v for v in ranks[0]["arrival_s"]), ", ".join("%.2f" % v for v in ranks[0]["gather_ms"]), ranks[0]["staged_mb"], ranks[0]["sub_mb"],
                 ranks[0]["sub_ms"], kernel, SB_BLOCK, [r["counts"][kernel] for r in ranks], err))
    return totals


def _tfm_grid_phase(torch, kernels):
    """T5: four gloo ranks sharing the card at (1, 2, 2) (``shared_card``, as
    ``multirank_phase``): T5a dense, 2 steps, against one rank on the card
    from the same weights and batches; T5b switch-MoE, 1 step, against the
    same four-rank grid on the CPU; in the same spawn U1 and U2
    (``sharded_bounded_leg``, ``_sb_check``).  Returns {kernel: launches}
    over the card's ranks."""
    import numpy as np

    from aggregathor_tpu_torch.models import transformer as tfm
    from aggregathor_tpu_torch.parallel import mesh

    rng = np.random.default_rng(17)

    def batches(seq, steps):
        return [{"tokens": rng.integers(0, 1024, size=(4, 8, seq)).astype(np.int32),
                 "targets": rng.integers(0, 1024, size=(4, 8, seq)).astype(np.int32)} for _ in range(steps)]

    def leaf_err(got, want):
        return max(float(np.abs(got[k] - want[k]).max() / np.abs(want[k]).max()) for k in want)

    totals = {name: 0 for name in kernels.KERNELS}
    legs = (("T5a dense", TFM_GRID_A, 256, 2, "one rank on the card"),
            ("T5b switch-MoE", TFM_GRID_B, 128, 1, "the grid on the CPU"))
    cases = []
    for _, cfg, seq, steps, _ in legs:
        weights = {k: v.numpy() for k, v in tfm.init_params(tfm.TransformerConfig(**cfg),
                                                            torch.Generator().manual_seed(5), 2).items()}
        cases.append(({"cfg": cfg, "mesh": (1, 2, 2)}, weights, batches(seq, steps)))
    sb_weights, sb_merged, sb_batches = _sb_inputs()
    journals = tempfile.mkdtemp(prefix="chip_smoke-sb-")
    sb_journals = {leg[0]: os.path.join(journals, "%s.jsonl" % leg[0]) for leg in SB_LEGS}
    bounded = [(leg, sb_weights[leg[0]], sb_batches, sb_journals[leg[0]]) for leg in SB_LEGS]
    begin = time.perf_counter()
    # T5b's four CPU ranks run beside the card's spawn, which holds T5's two
    # legs and U1/U2: the card's ranks start (a CUDA context each) once
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        cpu_future = pool.submit(mesh.spawn, transformer_grid_rank, 4, 4, ([cases[1]],), device="cpu", timeout=900)
        spawned = mesh.spawn(transformer_grid_rank, 4, 4, (cases, bounded), device="cuda", shared_card=True,
                             timeout=900)
        wall = time.perf_counter() - begin
        cpu = cpu_future.result()
    print("transformer T5 and U1/U2: one spawn of 4 gloo ranks sharing %s, %.1f s with the ranks' start"
          % (card_line(), wall))
    try:
        for kernel, count in _sb_check(torch, kernels, spawned, sb_merged, sb_batches, sb_journals).items():
            totals[kernel] += count
    finally:
        shutil.rmtree(journals, ignore_errors=True)
    for index, (label, cfg, seq, steps, other) in enumerate(legs):
        case, weights, data = cases[index]
        ranks = [rank[0][index] for rank in spawned]
        if other.startswith("one"):
            single = _tfm_grid_run(mesh.make_mesh(1, 1, 1, device="cuda"), {"cfg": cfg}, tfm.merge_stages(weights),
                                   data)
            want = single["params"]
            got = {k: v.reshape(want[k].shape) for k, v in ranks[0]["params"].items()}
        else:
            single, want, got = cpu[0][0][0], cpu[0][0][0]["params"], ranks[0]["params"]
        err = leaf_err(got, want)
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(ranks[0]["loss"], single["loss"]))
        buckets = 9 + (1 if cfg.get("n_experts") else 0)
        per_step = buckets * cfg["n_layers"] // 2 + 3  # the rank's stage: half the layers
        print("transformer %s at (1, 2, 2), 4 gloo ranks sharing %s (collectives staged through the host: says "
              "nothing of NVLink): %d steps (both legs %.1f s with the ranks' start), step %.0f ms on rank 0 (the "
              "last); "
              "parameters within "
              "%.3g of %s (tolerance %g), losses %.3g relative; launches a rank %s; peak %.0f MB on rank 0"
              % (label, card_line(), steps, wall, ranks[0]["ms"][-1], err, other, TFM_GRID_RTOL,
                 loss_err, [r["counts"]["coordinate_median"] for r in ranks], ranks[0]["peak_mb"]))
        check(err <= TFM_GRID_RTOL and loss_err <= TFM_GRID_RTOL, "transformer %s: the grid differs from %s"
              % (label, other))
        for rank, result in enumerate(ranks):
            for name in kernels.KERNELS:
                want_count = steps * per_step if name == "coordinate_median" else 0
                check(result["counts"][name] == want_count, "transformer %s rank %d: %s launched %d times (want %d)"
                      % (label, rank, name, result["counts"][name], want_count))
                totals[name] += result["counts"][name]
    return totals


def _tfm_real_bytes(runner):
    """T6: real bytes (docs/robustness.md:326-331): flat krum n = 4, f = 1,
    adam 3e-3, 150 steps, and the sharded engine at (1, 1, 1), layer,
    median, 100 steps; the held-out nll below ``TFM_REAL_SHARE`` times the
    corpus's unigram entropy."""
    import numpy as np

    from aggregathor_tpu_torch import models

    args = ["corpus-source:code", "corpus:500000", "d-model:64", "layers:2"]
    exp = models.instantiate("transformer", args)
    counts = np.bincount(exp.corpus, minlength=256).astype(np.float64)
    p = counts / counts.sum()
    unigram = float(-(p[p > 0] * np.log(p[p > 0])).sum())
    base = ["--seed", "1", "--experiment", "transformer", "--experiment-args", *args, "--nb-workers", "4",
            "--nb-decl-byz-workers", "1", "--optimizer", "adam", "--learning-rate-args", "initial-rate:0.003",
            "--evaluation-period", "-1"]
    for label, argv, steps in (("flat krum", ["--aggregator", "krum"], 150),
                               ("sharded (1,1,1) layer median", ["--aggregator", "median", "--mesh", "1,1,1",
                                                                 "--granularity", "layer"], 100)):
        begin = time.perf_counter()
        result = runner.main(base + argv + ["--max-step", str(steps), "--evaluation-delta", str(steps)])
        nll = result["evaluation"]["nll"]
        print("transformer T6 real bytes (the Python stdlib of this machine, %d train bytes), %s, %d steps in %.1f "
              "s on %s: held-out nll %.3f nats (%.3f bits/byte) against the corpus's unigram entropy %.3f nats "
              "(%.3f bits/byte), bar %.3f" % (len(exp.corpus), label, steps, time.perf_counter() - begin, card_line(),
                                              nll, nll / math.log(2), unigram, unigram / math.log(2),
                                              TFM_REAL_SHARE * unigram))
        check(nll < TFM_REAL_SHARE * unigram, "transformer T6 %s: held-out nll %.3f not below %.3f"
              % (label, nll, TFM_REAL_SHARE * unigram))


def tfm_kernel_rows(torch, kernels):
    """K1, the centring, K2 and K3 at the transformer's bucket and leaf
    widths (n = 8), and K1, K3 and K6 at U1/U2's column block (8, ceil(d /
    4)) (K6 with U2's forfeited unit, rows 0-3, NaN): held against their
    plain versions and timed."""
    gen = torch.Generator(device="cuda").manual_seed(20261020)
    library = {"pairwise_sq_distances": lambda x: torch.cdist(x, x).square(),
               "pairwise_sq_distances_gram": lambda x: torch.cdist(x, x).square(), "nanmedian_columns": None,
               "coordinate_median": lambda x: torch.kthvalue(x, x.shape[0] // 2 + 1, dim=0).values,
               "average_nan_columns": lambda x: torch.nanmean(x, 0)}
    shapes = {"pairwise_sq_distances": (2097152, 262144, 256, SB_BLOCK),  # T1's leaves: w_gate, embed, a norm
              "nanmedian_columns": (262144, 65536, 256),        # T2's buckets: w_gate's layer, wq's, a norm
              "pairwise_sq_distances_gram": (2097152, 262144, 65536, 256),  # and T3's global leaves
              "coordinate_median": (262144, 65536, 256, SB_BLOCK), "average_nan_columns": (SB_BLOCK,)}
    rows = []
    for name, widths in shapes.items():
        for d in widths:
            x = torch.randn((8, d), device="cuda", generator=gen)
            if name == "average_nan_columns":
                x[:SB_N // 2] = float("nan")
            args = (kernels.nanmedian_columns(x),) if name == "pairwise_sq_distances_gram" else ()
            got = getattr(kernels, name)(x, *args)
            torch.cuda.synchronize()
            err = compare(name, got, kernels.PLAIN[name](x, *args), torch, x, args)
            row = timed_row(torch, kernels, name, x, args, library[name], err)
            row["name"] = name
            print("transformer kernel %-27s (8, %d): %.4f ms (on the card %s ms), plain %.3f ms, library %s ms, "
                  "bound %.2f us (%s), max |err| %g, on %s"
                  % (name, d, row["ms"], "not measured" if row["device_ms"] is None else "%.4f" % row["device_ms"],
                     row["plain_ms"], "%.3f" % row["library_ms"] if row["library_ms"] is not None else "none",
                     row["bound_ms"] * 1e3, row["bound_by"], err, card_line()))
            rows.append(row)
            del x, got
    torch.cuda.empty_cache()
    return rows


def transformer_phase(torch, gars, kernels, models, runner, card, kernel_rows):
    """The transformer and the sharded engine on the card (BASELINE config
    5; ``models/transformer.py``, ``RobustEngine(sharding="sharded")``);
    returns {kernel: launches} over its legs and appends the kernel rows at
    its widths to ``kernel_rows``.

    - T1 config 5f through the runner, flat, granularity leaf (bucketed on
      the card): K1 batched once a leaf size (5 a step for 12 leaves), d =
      8,917,248;
    - T2 the same model sharded at (1, 1, 1), layer: the centring and K2 once
      a bucket (75 a step);
    - T3 global (12 + 12 a step) and median (K3 75 a step);
      each prints steps/s excluding the first, and the engine's gradient,
      GAR and distance ms a step, and the peak MB;
    - T4 the first sharded step card vs CPU: Krum's selections identical;
    - T5 four gloo ranks sharing the card at (1, 2, 2): the pipe ring, ring
      attention, the Megatron-SP MLP and the MoE all-to-all on CUDA tensors;
    - T6 real bytes, flat and sharded, below the unigram bar."""
    begin = time.perf_counter()
    parts = {}
    totals = zero_counts(kernels)
    results = {}
    for label, argv, steps, per_step in TFM_LEGS:
        result, counts, peak_mb = _tfm_leg(torch, kernels, runner, label, argv, steps, per_step)
        results[label] = result
        for name, count in counts.items():
            totals[name] += count
        print("transformer %s, %s, %d steps on %s: d = %d, %.3f steps/s excl. 1st, loss %.4f, launches a step %s, "
              "peak %.0f MB" % (label, " ".join(argv), steps, card, TFM_D, result["steps_per_s"], result["final_loss"],
                                per_step, peak_mb))
    parts["T1-T3"] = time.perf_counter() - begin
    times = _tfm_times(torch, gars, models)
    parts["phases"] = time.perf_counter() - begin - sum(parts.values())
    print("transformer step phases on %s (CUDA events, one batch): T1 flat leaf gradient %.1f ms, GAR %.1f ms (12 "
          "K1); T2 sharded layer gradient %.1f ms, GAR %.1f ms (75 buckets), of which distances %.1f ms (75 "
          "centring + 75 K2)" % (card, times["T1 gradient"], times["T1 GAR"], times["T2 gradient"], times["T2 GAR"],
                                 times["T2 distances"]))
    _tfm_card_cpu(torch, gars, models)
    parts["T4"] = time.perf_counter() - begin - sum(parts.values())
    for name, count in _tfm_grid_phase(torch, kernels).items():
        totals[name] += count
    parts["T5, U1-U2"] = time.perf_counter() - begin - sum(parts.values())
    _tfm_real_bytes(runner)
    parts["T6"] = time.perf_counter() - begin - sum(parts.values())
    kernel_rows.extend(tfm_kernel_rows(torch, kernels))
    parts["kernels"] = time.perf_counter() - begin - sum(parts.values())
    print("transformer phase: %.1f s (%s)" % (time.perf_counter() - begin,
                                            ", ".join("%s %.1f s" % item for item in parts.items())))
    return totals


SERVE_STEPS = 4
SERVE_SECRET = "serve-secret"
SERVE_TOP = 64
SERVE_REQUESTS = (1, 3, 17, 64, 100)
SERVE_ZOO = "slim-resnet_v1_50-digits32"
SERVE_ZOO_D = 23519690
SERVE_ZOO_BUCKETS = (1, 2, 4, 8, 16, 32)
SERVE_ZOO_CALLS = 20
#: the vote's matrix widths, bucket x 10 classes: buckets 4, 32 and 64
SERVE_WIDTHS = (40, 320, 640)
#: (kernel, rule) of the other vote rules' engine legs at R = 5, f = 2
SERVE_RULES = (("coordinate_averaged_median", "averaged-median"), ("coordinate_trimmed_mean", "trimmed-mean"),
               ("average_nan_columns", "average-nan"), ("pairwise_sq_distances", "krum"))


def _serve_metrics(base):
    """{(family, kernel label or None): value} of the serving child's
    Prometheus exposition."""
    import urllib.request

    from aggregathor_tpu_torch.obs.metrics import parse_prometheus

    with urllib.request.urlopen(base + "/metrics", timeout=30) as response:
        parsed = parse_prometheus(response.read().decode())
    return {(name, labels.get("kernel")): value for family in parsed.values()
            for name, labels, value in family["samples"]}


def _serve_post(base, rows):
    """(HTTP code, body, ms) of one /predict."""
    import urllib.error
    import urllib.request

    request = urllib.request.Request(base + "/predict", data=json.dumps({"inputs": rows.tolist()}).encode(),
                                     headers={"Content-Type": "application/json"})
    begin = time.perf_counter()
    try:
        with urllib.request.urlopen(request, timeout=120) as response:
            return response.status, json.loads(response.read()), (time.perf_counter() - begin) * 1e3
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read()), (time.perf_counter() - begin) * 1e3


def _build_snapshot(build):
    """{file: (size, mtime)} of the kernel build directory."""
    root = build.build_dir()
    return {name: (os.stat(os.path.join(root, name)).st_size, os.stat(os.path.join(root, name)).st_mtime_ns)
            for name in sorted(os.listdir(root))}


def _clean_logits(torch, exp, params, rows, top):
    """The clean replica's float32 logits on the card, a lone forward at
    each chunk's bucket (as the engine pads), cut to the rows."""
    import numpy as np

    from aggregathor_tpu_torch.serve import bucket_ladder, choose_bucket

    ladder = bucket_ladder(top)
    out = []
    for start in range(0, len(rows), top):
        part = rows[start:start + top]
        pad = np.zeros((choose_bucket(len(part), ladder),) + part.shape[1:], np.float32)
        pad[:len(part)] = part
        with torch.no_grad():
            out.append(exp.predict_logits(params, torch.from_numpy(pad).to("cuda")).float()[:len(part)].cpu())
    return torch.cat(out).numpy()


def _serve_s1(torch, kernels, runner, card, workdir, totals):
    """S1: train cnnet under --secure, serve it from a cli.serve subprocess."""
    import numpy as np

    from aggregathor_tpu_torch import gars, models
    from aggregathor_tpu_torch.cli import serve as serve_cli
    from aggregathor_tpu_torch.ops import build
    from aggregathor_tpu_torch.serve import InferenceEngine

    ckpt = os.path.join(workdir, "serve-ck")
    train = ["--experiment", "cnnet", "--experiment-args", "augment:device", "--input-source", "device", "--seed",
             "1", "--aggregator", "median", "--nb-workers", "8", "--nb-decl-byz-workers", "2", "--evaluation-delta",
             "-1", "--evaluation-period", "-1", "--checkpoint-dir", ckpt, "--checkpoint-delta", "2",
             "--checkpoint-period", "-1", "--secure", "--session-secret", SERVE_SECRET]
    kernels.reset_launch_counts()
    result = runner.main(train + ["--max-step", str(SERVE_STEPS)])
    counts = kernels.launch_counts()
    check(result["final_loss"] is not None and math.isfinite(result["final_loss"]), "serve S1: training diverged")
    check(counts["coordinate_median"] == SERVE_STEPS, "serve S1: K3 %d times in %d steps"
          % (counts["coordinate_median"], SERVE_STEPS))
    for name, count in counts.items():
        totals[name] += count
    ready, log_path = os.path.join(workdir, "serve-ready"), os.path.join(workdir, "serve.log")
    argv = [sys.executable, "-m", "aggregathor_tpu_torch.cli.serve", "--experiment", "cnnet", "--ckpt-dir", ckpt,
            "--replicas", "3", "--gar", "median", "--poison-replica", "1:nan", "--port", "0", "--ready-file", ready,
            "--session-secret", SERVE_SECRET, "--max-batch", str(SERVE_TOP)]
    begin = time.perf_counter()
    with open(log_path, "w") as log:
        child = subprocess.Popen(argv, cwd=os.path.dirname(os.path.abspath(__file__)), stdout=log,
                                 stderr=subprocess.STDOUT)
    try:
        while not os.path.exists(ready) and child.poll() is None and time.perf_counter() - begin < 300:
            time.sleep(0.1)
        if not os.path.exists(ready):
            fail("serve S1: no ready file (exit %s): %s" % (child.poll(), open(log_path).read()[-3000:]))
        startup_s = time.perf_counter() - begin
        snapshot = _build_snapshot(build)
        host, port, pid = open(ready).read().split()
        base = "http://%s:%s" % (host, port)
        import urllib.request

        with urllib.request.urlopen(base + "/healthz", timeout=30) as response:
            health = json.loads(response.read())
        check(health["custody_verified"] is True, "serve S1: custody not verified: %s" % health)
        check(health["weights_step"] == SERVE_STEPS, "serve S1: weights step %s" % health["weights_step"])
        metrics = _serve_metrics(base)
        k3_before = metrics[("serve_kernel_launches", "coordinate_median")]
        check(k3_before == 7, "serve S1: warmup launched K3 %s times over 7 buckets" % k3_before)

        exp = models.instantiate("cnnet", [])
        args = serve_cli.build_parser().parse_args(["--experiment", "cnnet", "--ckpt-dir", ckpt, "--replicas", "1",
                                                    "--session-secret", SERVE_SECRET])
        clean = {k: v.to("cuda") for k, v in serve_cli.load_replicas(args, exp)[0][0].items()}
        rng = np.random.default_rng(20261018)
        served = 0
        for rows in SERVE_REQUESTS:
            x = rng.random((rows, 32, 32, 3), np.float32)
            want = _clean_logits(torch, exp, clean, x, SERVE_TOP)
            if rows > SERVE_TOP:
                code, body, _ = _serve_post(base, x)
                check(code == 400 and "ladder top" in body.get("error", ""),
                      "serve S1: a %d-row request was not refused: %s %s" % (rows, code, body))
            preds, times = [], []
            for start in range(0, rows, SERVE_TOP):  # split client-side, as the 400 asks
                code, body, ms = _serve_post(base, x[start:start + SERVE_TOP])
                check(code == 200, "serve S1: %d rows: HTTP %s %s" % (rows, code, body))
                check(body["disagreement"][0] == 0.0 and body["disagreement"][1] is None
                      and body["disagreement"][2] == 0.0,
                      "serve S1: %d rows: disagreement %s, not [0, null, 0]" % (rows, body["disagreement"]))
                preds += body["predictions"]
                times.append(ms)
                served += 1
            check(preds == np.argmax(want, axis=-1).tolist(), "serve S1: %d rows: predictions differ from the "
                  "clean replica's" % rows)
            print("serve S1 cnnet /predict %d rows on %s: %s ms over HTTP (%d request(s)), the clean replica's "
                  "predictions, disagreement [0, null, 0]" % (rows, card, " + ".join("%.2f" % t for t in times),
                                                              len(times)))
        metrics = _serve_metrics(base)
        k3 = metrics[("serve_kernel_launches", "coordinate_median")] - k3_before
        check(k3 == served, "serve S1: K3 %d times for %d served buckets" % (k3, served))

        # the same vote in-process, on the logits themselves
        replicas = [clean, {k: torch.full_like(v, float("nan")) for k, v in clean.items()}, clean]
        engine = InferenceEngine(exp, replicas, gar=gars.instantiate("median", 3, 1), max_batch=SERVE_TOP)
        kernels.reset_launch_counts()
        engine.warmup()
        for rows in SERVE_REQUESTS:
            x = rng.random((rows, 32, 32, 3), np.float32)
            got = engine.predict(x)["logits"]
            check(np.array_equal(got.view(np.int32), _clean_logits(torch, exp, clean, x, SERVE_TOP).view(np.int32)),
                  "serve S1: the in-process vote at %d rows is not the clean logits bit for bit" % rows)
        in_process = kernels.launch_counts()["coordinate_median"]
        want = sum(-(-rows // SERVE_TOP) for rows in SERVE_REQUESTS) + len(engine.buckets)
        check(in_process == want, "serve S1: the in-process engine launched K3 %d times, not %d" % (in_process, want))
        totals["coordinate_median"] += in_process
        del engine, replicas

        # a newer step, then SIGHUP: requests keep flowing, the step moves
        kernels.reset_launch_counts()
        runner.main(train + ["--max-step", str(SERVE_STEPS + 2)])
        for name, count in kernels.launch_counts().items():
            totals[name] += count
        import threading

        seen, stop = [], threading.Event()

        def traffic():
            x = np.random.default_rng(7).random((3, 32, 32, 3), np.float32)
            while not stop.is_set():
                code, body, _ = _serve_post(base, x)
                seen.append((code, body.get("weights_step")))
                if body.get("weights_step") == SERVE_STEPS + 2:
                    return

        thread = threading.Thread(target=traffic, daemon=True)
        thread.start()
        time.sleep(0.2)
        reload_begin = time.perf_counter()
        child.send_signal(signal.SIGHUP)
        thread.join(120)
        stop.set()
        reload_s = time.perf_counter() - reload_begin
        codes = sorted({code for code, _ in seen})
        steps = [step for _, step in seen]
        check(codes == [200], "serve S1: requests failed during the reload: %s" % codes)
        check(steps and steps[-1] == SERVE_STEPS + 2 and steps == sorted(steps),
              "serve S1: weights_step did not move to %d: %s" % (SERVE_STEPS + 2, steps[-5:]))
        metrics = _serve_metrics(base)
        k3_total = metrics[("serve_kernel_launches", "coordinate_median")] - k3_before
        check(k3_total == served + len(seen), "serve S1: K3 %d times for %d served buckets"
              % (k3_total, served + len(seen)))
        totals["coordinate_median"] += int(k3_total) + 7
        check(metrics[("serve_kernel_builds", None)] == 0 and _build_snapshot(build) == snapshot,
              "serve S1: a kernel library was built after the ready file")
        child.send_signal(signal.SIGTERM)
        code = child.wait(120)
        check(code == 0, "serve S1: cli.serve exited %s after SIGTERM" % code)
        print("serve S1 on %s: cli.serve ready in %.1f s (3 replicas, median, replica 1 NaN, custody verified); "
              "SIGHUP to step %d in %.2f s under %d requests, none failed; K3 %d launches in the child (7 warmup + "
              "%d buckets), no kernel built after the ready file; SIGTERM exit 0"
              % (card, startup_s, SERVE_STEPS + 2, reload_s, len(seen), k3_total + 7, k3_total))
    finally:
        if child.poll() is None:
            child.kill()
            child.wait(30)


def _serve_s2(torch, gars, kernels, models, card, totals):
    """S2: ResNet-50 on digits32 in an in-process engine, R = 3, one NaN
    replica, buckets 1-32: the vote bit for bit, latency a bucket."""
    import numpy as np

    from aggregathor_tpu_torch.chaos.replica_faults import corrupt_params
    from aggregathor_tpu_torch.ops import build
    from aggregathor_tpu_torch.serve import InferenceEngine

    exp = models.instantiate(SERVE_ZOO, [])
    params = exp.init(3)
    d = sum(v.numel() for v in params.values())
    check(d == SERVE_ZOO_D, "serve S2: d = %d, not %d" % (d, SERVE_ZOO_D))
    replicas = [params, corrupt_params(params, "nan"), params]
    engine = InferenceEngine(exp, replicas, gar=gars.instantiate("median", 3, 1), buckets=SERVE_ZOO_BUCKETS)
    clean = {k: v.to("cuda") for k, v in params.items()}
    kernels.reset_launch_counts()
    engine.warmup()
    launches = kernels.launch_counts()["coordinate_median"]
    built = []
    build.add_build_listener(built.append)
    rng = np.random.default_rng(11)
    rows = []

    def predict(x):  # counts the engine's own K3 launches, not the timings'
        nonlocal launches
        before = kernels.launch_counts()["coordinate_median"]
        out = engine.predict(x)
        launches += kernels.launch_counts()["coordinate_median"] - before
        return out

    try:
        for bucket in SERVE_ZOO_BUCKETS + (48,):  # 48: chunks of 32 and 16
            x = rng.random((bucket,) + engine.sample_shape, np.float32)
            got = predict(x)
            want = _clean_logits(torch, exp, clean, x, SERVE_ZOO_BUCKETS[-1])
            check(np.array_equal(got["logits"].view(np.int32), want.view(np.int32)),
                  "serve S2: %d rows: the vote is not the clean logits bit for bit" % bucket)
            check(got["disagreement"][0] == 0.0 and np.isposinf(got["disagreement"][1])
                  and got["disagreement"][2] == 0.0, "serve S2: disagreement %s" % got["disagreement"])
            if bucket == 48:
                continue
            times = []
            for _ in range(SERVE_ZOO_CALLS):
                begin = time.perf_counter()
                predict(x)
                times.append((time.perf_counter() - begin) * 1e3)
            times.sort()
            flat = torch.randn((3, bucket * 10), device="cuda")
            flat[1] = float("nan")
            vote_ms = time_ms(lambda: kernels.coordinate_median(flat), torch, iters=50, warmup=5)
            stack = engine._live[0]
            forward_ms = time_ms(lambda: [exp.predict_logits({k: v[r] for k, v in stack.items()},
                                                             torch.from_numpy(x).to("cuda")) for r in range(3)],
                                 torch, iters=10, warmup=2)
            p50, p99 = times[len(times) // 2], times[min(len(times) - 1, int(0.99 * len(times)))]
            rows.append((bucket, p50, p99, forward_ms, vote_ms))
            print("serve S2 %s R=3 median bucket %d on %s: predict p50 %.2f ms, p99 %.2f ms (%d calls, eager); the "
                  "three forwards %.2f ms, the K3 vote (3, %d) %.4f ms = %.4f of p50"
                  % (SERVE_ZOO, bucket, card, p50, p99, SERVE_ZOO_CALLS, forward_ms, bucket * 10, vote_ms,
                     vote_ms / p50))
        # one K3 a bucket call: the warmup, a check and the timed calls a
        # bucket, and 48 rows in two chunks
        want = len(SERVE_ZOO_BUCKETS) * (2 + SERVE_ZOO_CALLS) + 2
        check(launches == want, "serve S2: K3 launched %d times, not %d" % (launches, want))
        check(built == [] and engine.compile_count == len(SERVE_ZOO_BUCKETS),
              "serve S2: a kernel built or a new bucket shape after the warmup")
    finally:
        build.remove_build_listener(built.append)
    totals["coordinate_median"] += launches
    del engine, replicas, clean
    torch.cuda.empty_cache()
    return rows


def _serve_s3(torch, gars, kernels, models, card, totals):
    """S3: the vote kernels at (R, bucket x 10) held against their plain
    versions and timed; an engine a rule; the ContinuousBatcher's lanes."""
    import numpy as np

    from aggregathor_tpu_torch.chaos.replica_faults import corrupt_params
    from aggregathor_tpu_torch.serve import ContinuousBatcher, InferenceEngine

    gen = torch.Generator(device="cuda").manual_seed(20261019)
    library = {"coordinate_median": lambda x: torch.kthvalue(x, x.shape[0] // 2 + 1, dim=0).values,
               "coordinate_averaged_median": None, "coordinate_trimmed_mean": None,
               "average_nan_columns": lambda x: torch.nanmean(x, 0),
               "pairwise_sq_distances": lambda x: torch.cdist(x, x).square()}

    def args_of(name, n):
        f = (n - 1) // 2
        return {"coordinate_averaged_median": (n - f,), "coordinate_trimmed_mean": (f, n - 2 * f)}.get(name, ())

    rows, held = [], 0
    for name in library:
        for n in (3, 5, 7):
            for d in SERVE_WIDTHS:
                x = poison(torch.randn((n, d), device="cuda", generator=gen),
                           columns=name != "pairwise_sq_distances")
                args = args_of(name, n)
                got = getattr(kernels, name)(x, *args)
                torch.cuda.synchronize()
                err = compare(name, got, kernels.PLAIN[name](x, *args), torch, x, args)
                held += 1
                if d == SERVE_WIDTHS[-1] and n == (3 if name == "coordinate_median" else 5):
                    row = timed_row(torch, kernels, name, x, args, library[name], err)
                    row["name"] = name
                    rows.append(row)
                    print("serve kernel %-27s (%d, %d), poisoned: %.4f ms (on the card %s ms), plain %.3f ms, "
                          "library %s ms, bound %.3f us (%s), max |err| %g, on %s"
                          % (name, n, d, row["ms"], "not measured" if row["device_ms"] is None
                             else "%.4f" % row["device_ms"], row["plain_ms"],
                             "%.3f" % row["library_ms"] if row["library_ms"] is not None else "none",
                             row["bound_ms"] * 1e3, row["bound_by"], err, card))
    print("serve S3: %d (kernel, R, width) cases held against their plain versions (R = 3, 5, 7; widths %s)"
          % (held, list(SERVE_WIDTHS)))

    exp = models.instantiate("cnnet", [])
    params = exp.init(5)
    replicas = [params] * 3 + [corrupt_params(params, "nan")] * 2
    x = np.random.default_rng(13).random((50, 32, 32, 3), np.float32)
    for name, rule in SERVE_RULES:
        engine = InferenceEngine(exp, replicas, gar=gars.instantiate(rule, 5, 2), buckets=(4, 64))
        clean = InferenceEngine(exp, [params], buckets=(4, 64)).predict(x)
        kernels.reset_launch_counts()
        engine.warmup()
        out = engine.predict(x[:3]), engine.predict(x)
        counts = kernels.launch_counts()
        check(counts[name] == 4, "serve S3 %s: %s launched %d times for 4 bucket calls" % (rule, name, counts[name]))
        check(np.array_equal(out[1]["predictions"], clean["predictions"]),
              "serve S3 %s: the vote over two NaN replicas is not the clean predictions" % rule)
        for kernel, count in counts.items():
            totals[kernel] += count
        print("serve S3 cnnet R=5 %s on %s: %s once a bucket call (4), the clean predictions over two NaN "
              "replicas, disagreement %s" % (rule, card, name, out[1]["disagreement"].tolist()))

    engine = InferenceEngine(exp, [params, corrupt_params(params, "nan"), params],
                             gar=gars.instantiate("median", 3, 1), max_batch=SERVE_TOP)
    engine.warmup()
    request = x[:4]
    for lanes in (1, 2):
        batcher = ContinuousBatcher(engine.predict, engine.buckets, queue_bound=4096, nb_lanes=lanes)
        before = kernels.launch_counts()["coordinate_median"]
        begin = time.perf_counter()
        tickets = [batcher.submit(request) for _ in range(256)]
        for ticket in tickets:
            ticket.wait(120.0)
        seconds = time.perf_counter() - begin
        totals["coordinate_median"] += kernels.launch_counts()["coordinate_median"] - before
        print("serve S3 ContinuousBatcher cnnet R=3 median, %d lane(s), 256 requests of 4 rows submitted at once, "
              "on %s: %.1f requests/s, %d batches (%.1f rows a batch)"
              % (lanes, card, 256 / seconds, batcher.batch_count, batcher.served_rows / batcher.batch_count))
        batcher.close()
    return rows


def serve_phase(torch, gars, kernels, models, runner, card, workdir, kernel_rows):
    """Serving on the card (``serve/``, ``cli/serve.py``): S1 cnnet through
    the serve CLI, S2 ResNet-50 on digits32 in-process, S3 the other vote
    kernels and the batcher (module docstring); returns {kernel: launches}
    and appends the kernel rows at the vote's shapes to ``kernel_rows``."""
    begin = time.perf_counter()
    totals = {name: 0 for name in kernels.KERNELS}
    parts = {}
    _serve_s1(torch, kernels, runner, card, workdir, totals)
    parts["S1"] = time.perf_counter() - begin
    _serve_s2(torch, gars, kernels, models, card, totals)
    parts["S2"] = time.perf_counter() - begin - sum(parts.values())
    kernel_rows.extend(_serve_s3(torch, gars, kernels, models, card, totals))
    parts["S3"] = time.perf_counter() - begin - sum(parts.values())
    print("serve phase: %.1f s (%s), launches %s" % (time.perf_counter() - begin, ", ".join(
        "%s %.1f s" % item for item in parts.items()), {k: v for k, v in totals.items() if v}))
    return totals


TOPO_N = 32
TOPO_STEPS = 6
#: seconds: far above a warm round of 32 cnnet submissions on the card, so
#: no honest unit times out and only the injected faults decide
TOPO_DEADLINE = "60"
TOPO_F1 = "tree:g=4x2,rules=median>median>krum,redundancy=2"
TOPO_F1B = "tree:g=4x2,rules=median>median>median,agg-f=1x1"
TOPO_SCHEDULE = "0:corrupt-agg=1.1 3:straggle-agg=2.1"
#: launches a step: the two median levels run in the emissions and in the
#: step's rule (K3 twice each), then the root (krum: the centring and K2 at
#: 4 rows; median: K3)
TOPO_LAUNCHES = {"F1": {"coordinate_median": 4, "nanmedian_columns": 1, "pairwise_sq_distances_gram": 1},
                 "F1b": {"coordinate_median": 5}}
TOPO_F2 = "tree:g=8,rules=krum>median"
TOPO_F2_N = 64
TOPO_EMIT_TOL = 1e-5
#: the kernels' shapes on the tree's path: F1's levels on the transposed
#: layout, F1's root and F2's units
TOPO_SHAPES = (("coordinate_median", 4, 8 * CNNET_D, "F1 level 1"), ("coordinate_median", 2, 4 * CNNET_D, "F1 level 2"),
               ("nanmedian_columns", 4, CNNET_D, "F1 root"), ("pairwise_sq_distances_gram", 4, CNNET_D, "F1 root"),
               ("nanmedian_columns", 8, CNNET_D, "F2 unit"), ("pairwise_sq_distances_gram", 8, CNNET_D, "F2 unit"))
TOPO_SLO_STEPS = 12


def _topology_leg(torch, runner, kernels, label, spec, schedule, workdir):
    """One ``--topology`` run of cnnet at n = 32, f = 1 through the runner
    with a checkpoint at its end; the masks each round's ``process_round``
    returned are recorded.  Returns (result, {step: loss}, journal's topology
    records, forensics report, masks, final parameters, launches, seconds,
    per-level emission seconds)."""
    from aggregathor_tpu_torch.obs import events, metrics as obs_metrics
    from aggregathor_tpu_torch.topology import tree as topology_tree

    directory = os.path.join(workdir, "topology-%s" % label)
    os.makedirs(os.path.join(directory, "sum"))
    masks = []
    process_round = topology_tree.TreeAggregator.process_round

    def recorded(self, *args, **kwargs):
        out = process_round(self, *args, **kwargs)
        masks.append((out[0].copy(), out[1].copy()))
        return out

    def level_seconds():
        family = {f.name: f for f in obs_metrics.REGISTRY.families()}.get("topology_level_seconds_total")
        return {} if family is None else {values[0]: child.value for values, child in family.children().items()}

    argv = ["--experiment", "cnnet", "--seed", "1", "--nb-workers", str(TOPO_N), "--nb-decl-byz-workers", "1",
            "--aggregator", "tree", "--topology", spec, "--step-deadline", TOPO_DEADLINE, "--max-step",
            str(TOPO_STEPS), "--evaluation-delta", "-1", "--evaluation-period", "-1", "--checkpoint-dir", directory,
            "--checkpoint-delta", str(TOPO_STEPS), "--checkpoint-period", "-1", "--summary-dir",
            os.path.join(directory, "sum"), "--summary-delta", "1", "--journal", os.path.join(directory, "j.jsonl"),
            "--forensics", os.path.join(directory, "f.json")]
    if schedule:
        argv += ["--chaos", schedule]
    before = level_seconds()
    topology_tree.TreeAggregator.process_round = recorded
    try:
        kernels.reset_launch_counts()
        begin = time.perf_counter()
        result = runner.main(argv)
        seconds = time.perf_counter() - begin
        counts = kernels.launch_counts()
    finally:
        topology_tree.TreeAggregator.process_round = process_round
    levels = {level: value - before.get(level, 0.0) for level, value in level_seconds().items()}
    losses = {}
    for name in os.listdir(os.path.join(directory, "sum")):
        for line in open(os.path.join(directory, "sum", name)):
            event = json.loads(line)
            if "total_loss" in event:
                losses[event["step"]] = event["total_loss"]
    check(sorted(losses) == list(range(1, TOPO_STEPS + 1)) and all(math.isfinite(v) for v in losses.values()),
          "topology %s: losses %s" % (label, losses))
    journal = [r for r in events.load_journal(os.path.join(directory, "j.jsonl")) if r["type"].startswith("topology_")]
    report = json.load(open(os.path.join(directory, "f.json")))
    params = torch.load(os.path.join(directory, "model-%d.ckpt" % TOPO_STEPS), weights_only=True)["params"]
    check(len(masks) == TOPO_STEPS, "topology %s: %d rounds through the tree" % (label, len(masks)))
    return result, losses, journal, report, masks, params, counts, seconds, levels


def _topology_f1(torch, runner, kernels, card, workdir, totals):
    """F1 and F1b through the runner (``topology_phase``)."""
    import numpy as np

    torch.backends.cudnn.deterministic = True
    try:
        legs = {label: _topology_leg(torch, runner, kernels, label, spec, schedule, workdir)
                for label, spec, schedule in (("F1", TOPO_F1, TOPO_SCHEDULE), ("F1-calm", TOPO_F1, None),
                                              ("F1b", TOPO_F1B, TOPO_SCHEDULE))}
    finally:
        torch.backends.cudnn.deterministic = False
    for label, leg in legs.items():
        per_step = TOPO_LAUNCHES[label.split("-")[0]]
        counts = leg[6]
        for name, count in counts.items():
            check(count == per_step.get(name, 0) * TOPO_STEPS,
                  "topology %s: %s launched %d times in %d steps, not %d a step"
                  % (label, name, count, TOPO_STEPS, per_step.get(name, 0)))
            totals[name] += count
        print("topology %s on %s: %s, cnnet n=%d f=1 d=%d, %d steps in %.1f s (%.2f steps/s after the first), "
              "losses %s, launches %s, emission ms a round by level %s"
              % (label, card, TOPO_F1B if label == "F1b" else TOPO_F1, TOPO_N, CNNET_D, TOPO_STEPS, leg[7],
                 leg[0]["steps_per_s"], ["%.4f" % leg[1][k] for k in sorted(leg[1])],
                 {k: v for k, v in counts.items() if v},
                 {level: round(value / TOPO_STEPS * 1e3, 3) for level, value in sorted(leg[8].items())}))
    # F1: both faults reconstructed from a shadow, nothing excluded, the
    # masks and the parameters those of the run without the schedule
    _, _, journal, report, masks, params, _, _, _ = legs["F1"]
    view = [(r["type"], r["step"], r["level"], r["unit"], r.get("excluded"), r.get("shadow"), r.get("trigger"))
            for r in journal]
    want = []
    for step in range(TOPO_STEPS):
        if step < 3:
            want += [("topology_corruption_verdict", step, 1, 1, False, None, None),
                     ("topology_reconstruction", step, 1, 1, None, 2, "forgery")]
        else:
            want += [("topology_level_timeout", step, 2, 1, False, None, None),
                     ("topology_reconstruction", step, 2, 1, None, 2, "timeout")]
    check(view == want, "topology F1: journal %s" % view[:6])
    check(report["corrupt_subaggregators"] == ["1.1"], "topology F1: forensics %s" % report["corrupt_subaggregators"])
    check(all(a.all() and not s.any() for a, s in masks), "topology F1: a reconstructed fault cleared a mask")
    calm = legs["F1-calm"]
    check(calm[2] == [] and all(a.all() for a, _ in calm[4]), "topology F1-calm: the calm run faulted")
    for name, value in params.items():
        check(torch.equal(value.view(torch.int32), calm[5][name].view(torch.int32)),
              "topology F1: %s differs from the run without the schedule" % name)
    check(legs["F1"][1] == calm[1], "topology F1: losses differ from the run without the schedule")
    # F1b: no redundancy, so both faulted subtrees are excluded, their leaf
    # spans cleared from the masks the aggregate reads
    _, _, journal, report, masks, _, _, _, _ = legs["F1b"]
    view = [(r["type"], r["step"], r["level"], r["unit"], r["excluded"]) for r in journal]
    want = [("topology_corruption_verdict", step, 1, 1, True) if step < 3 else
            ("topology_level_timeout", step, 2, 1, True) for step in range(TOPO_STEPS)]
    check(view == want, "topology F1b: journal %s" % view[:6])
    for step, (arrived, stale) in enumerate(masks):
        cleared = list(range(4, 8)) if step < 3 else list(range(8, 16))
        check(np.nonzero(~arrived)[0].tolist() == cleared and not stale.any(),
              "topology F1b: round %d cleared %s, not %s" % (step, np.nonzero(~arrived)[0].tolist(), cleared))
    print("topology F1 on %s: unit 1.1 forged at steps 0-2 and unit 2.1 late at 3-5, each served by shadow 2 "
          "(journal and forensics name them), masks untouched, parameters bit-identical to the run without the "
          "schedule; F1b (no redundancy, budgets [1, 2, 3]): both subtrees excluded, leaves 4-7 then 8-15 cleared, "
          "losses finite" % card)


def _topology_f2(torch, kernels, card):
    """F2: the emissions alone at ``TOPO_F2`` on the card's rows against the
    CPU's plain emission of the same rows."""
    import numpy as np

    from aggregathor_tpu_torch.topology import TreeAggregator, parse_topology_spec

    n, key = TOPO_F2_N, 7
    gen = torch.Generator(device="cuda").manual_seed(20261021)
    rows = torch.randn((n, CNNET_D), device="cuda", generator=gen)
    valid = np.ones(n, bool)
    valid[[3, 17]] = False  # two leaf timeouts: NaN rows in units 0 and 2
    card_tree, cpu_tree = (TreeAggregator(parse_topology_spec(TOPO_F2, n, 1)) for _ in range(2))
    card_tree.bind(n, CNNET_D)
    cpu_tree.bind(n, CNNET_D)
    card_tree.emissions(rows, valid, key)  # builds nothing new: warm the allocator
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    begin = time.perf_counter()
    emitted = card_tree.emissions(rows, valid, key)
    host_ms = (time.perf_counter() - begin) * 1e3
    counts = {k: v for k, v in kernels.launch_counts().items() if v}
    units = card_tree.spec.nb_units[0]
    check(counts == {"nanmedian_columns": units, "pairwise_sq_distances_gram": units},
          "topology F2: launches %s, not the centring and K2 once a unit of %d" % (counts, units))
    want = cpu_tree.emissions(rows.cpu(), valid, key)
    errors, equal_digests = [], 0
    for (got, digests, _), (ref, ref_digests, _) in zip(emitted, want):
        got = got.cpu()
        check(torch.equal(torch.isnan(got), torch.isnan(ref)), "topology F2: NaN pattern differs")
        finite = torch.isfinite(ref)
        err = torch.abs(got[finite] - ref[finite])
        errors.append(float(err.max()) if err.numel() else 0.0)
        check(bool(torch.all(err <= TOPO_EMIT_TOL * (1.0 + torch.abs(ref[finite])))),
              "topology F2: summaries off by %g" % errors[-1])
        for unit in range(got.shape[0]):
            if torch.equal(got[unit].view(torch.int32), ref[unit].view(torch.int32)):
                check(np.array_equal(digests[unit], ref_digests[unit]), "topology F2: unit %d's digest" % unit)
                equal_digests += 1
    masked = card_tree._leaf_rows(rows, torch.as_tensor(valid, device="cuda"))
    level_ms = time_ms(lambda: card_tree.emit_level(0, masked, key), torch, iters=10, warmup=2)
    check(card_tree.cache_size() == 1, "topology F2: %d shapes a level" % card_tree.cache_size())
    print("topology F2 on %s: %s emissions at n=%d d=%d, launches %s (the centring and K2 at 8 rows a unit), level 1 "
          "%.3f ms on the card (CUDA events), %.3f ms a call with the digests' copy; summaries within %s of the CPU's "
          "plain emission (tolerance %g), %d of %d units bit-equal with equal digests"
          % (card, TOPO_F2, n, CNNET_D, counts, level_ms, host_ms, errors, TOPO_EMIT_TOL, equal_digests, units))
    del rows, masked, emitted
    torch.cuda.empty_cache()


def _topology_f3(runner, kernels, card, workdir, totals):
    """F3: the sentinel through the runner: capture, PASS, REGRESS."""
    directory = os.path.join(workdir, "topology-slo")
    os.makedirs(directory)
    baseline, verdict = os.path.join(directory, "slo.json"), os.path.join(directory, "verdict.json")
    argv = ["--experiment", "cnnet", "--seed", "1", "--aggregator", "krum", "--nb-workers", "8",
            "--nb-decl-byz-workers", "2", "--max-step", str(TOPO_SLO_STEPS), "--evaluation-delta", "-1",
            "--evaluation-period", "-1"]
    kernels.reset_launch_counts()
    captured = runner.main(argv + ["--slo-capture", baseline])
    doc = json.load(open(baseline))
    check(doc["schema"] == "aggregathor.obs.slo.v1" and doc["metrics"]["steps_per_s"] > 0,
          "topology F3: capture %s" % doc)
    # the judged run repeats the captured one, warm: a tolerance of half
    # keeps the PASS clear of the host's noise
    doc["tolerances"]["steps_per_s"] = 0.5
    json.dump(doc, open(baseline, "w"))
    judged = runner.main(argv + ["--slo-baseline", baseline, "--slo-verdict", verdict])
    passed = json.load(open(verdict))
    check(passed["schema"] == "aggregathor.obs.slo.v1.verdict" and passed["verdict"] == "PASS",
          "topology F3: the repeated run's verdict %s" % passed)
    doc["metrics"]["steps_per_s"] *= 10.0
    json.dump(doc, open(baseline, "w"))
    runner.main(argv + ["--slo-baseline", baseline, "--slo-verdict", verdict])
    regressed = json.load(open(verdict))
    check(regressed["verdict"] == "REGRESS" and regressed["regressed"] == 1, "topology F3: ×10 baseline %s"
          % regressed)
    for name, count in kernels.launch_counts().items():
        totals[name] += count
    print("topology F3 on %s: cnnet + krum n=8, %d steps: captured %.2f steps/s, the repeat %.2f steps/s PASS "
          "(tolerance 0.5), against ×10 REGRESS; verdict schema %s"
          % (card, TOPO_SLO_STEPS, captured["steps_per_s"], judged["steps_per_s"], regressed["schema"]))


def _topology_f4(workdir, card):
    """F4: ``cli.supervise`` over one ``cli.serve`` child serving cnnet on the
    card (serve S1's checkpoints); the child SIGKILLed is restarted and
    answers ``/healthz``; ``cli.postmortem`` over the journals exits 0."""
    import urllib.request

    directory = os.path.join(workdir, "topology-fleet")
    os.makedirs(directory)
    serve_ready, sup_ready = os.path.join(directory, "serve-ready"), os.path.join(directory, "sup-ready")
    serve_journal, sup_journal = os.path.join(directory, "serve.jsonl"), os.path.join(directory, "sup.jsonl")
    fleet = {"instances": [{
        "name": "serve", "role": "serve", "ready_file": serve_ready, "journal": serve_journal, "cause_flag": True,
        "log": os.path.join(directory, "serve.log"), "cwd": os.path.dirname(os.path.abspath(__file__)),
        "argv": ["{python}", "-m", "aggregathor_tpu_torch.cli.serve", "--experiment", "cnnet", "--ckpt-dir",
                 os.path.join(workdir, "serve-ck"), "--replicas", "3", "--gar", "median", "--port", "0",
                 "--ready-file", serve_ready, "--session-secret", SERVE_SECRET, "--journal", serve_journal]}]}
    spec = os.path.join(directory, "fleet.json")
    json.dump(fleet, open(spec, "w"))
    log_path = os.path.join(directory, "supervise.log")
    begin = time.perf_counter()
    with open(log_path, "w") as log:
        supervisor = subprocess.Popen(
            [sys.executable, "-m", "aggregathor_tpu_torch.cli.supervise", "--fleet", spec, "--tick-interval", "0.25",
             "--down-after", "2", "--supervisor-args", "patience:0.5", "--ready-file", sup_ready, "--journal",
             sup_journal], cwd=os.path.dirname(os.path.abspath(__file__)), stdout=log, stderr=subprocess.STDOUT)

    def healthz(timeout):
        deadline = time.perf_counter() + timeout
        while time.perf_counter() < deadline and supervisor.poll() is None:
            if os.path.exists(serve_ready):
                host, port, pid = open(serve_ready).read().split()
                try:
                    with urllib.request.urlopen("http://%s:%s/healthz" % (host, port), timeout=5) as response:
                        return int(pid), json.loads(response.read())
                except OSError:
                    pass
            time.sleep(0.2)
        fail("topology F4: no /healthz answer (supervisor exit %s): %s" % (supervisor.poll(),
                                                                         open(log_path).read()[-3000:]))

    try:
        first, health = healthz(300)
        ready_s = time.perf_counter() - begin
        check(health["custody_verified"] is True, "topology F4: %s" % health)
        killed_at = time.perf_counter()
        os.kill(first, signal.SIGKILL)
        while os.path.exists(serve_ready) and open(serve_ready).read().split()[2] == str(first):
            check(time.perf_counter() - killed_at < 300, "topology F4: the child was not restarted")
            time.sleep(0.2)
        second, health = healthz(300)
        restart_s = time.perf_counter() - killed_at
        check(second != first and health["custody_verified"] is True, "topology F4: restarted child %s" % health)
    finally:
        if supervisor.poll() is None:
            supervisor.send_signal(signal.SIGTERM)
            try:
                supervisor.wait(120)
            except subprocess.TimeoutExpired:
                supervisor.kill()
                supervisor.wait(30)
    check(supervisor.returncode == 0, "topology F4: cli.supervise exited %s" % supervisor.returncode)
    report = os.path.join(directory, "postmortem.json")
    code = subprocess.run([sys.executable, "-m", "aggregathor_tpu_torch.cli.postmortem", "--journal",
                           "supervisor=" + sup_journal, "--journal", "serve=" + serve_journal, "--report", report,
                           "--quiet"], cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
                          timeout=120).returncode
    story = json.load(open(report))
    check(code == 0 and story["verdict"] == "PASS", "topology F4: postmortem exit %d, %s" % (code, story))
    restarts = [c for c in story["chains"] if c["kind"] == "spawn"]
    check(restarts, "topology F4: no spawn chain in the postmortem: %s" % story["chains"])
    print("topology F4 on %s: cli.supervise spawned cli.serve (cnnet, 3 replicas, median) ready in %.1f s; SIGKILL "
          "pid %d, restarted as pid %d answering /healthz in %.1f s; cli.postmortem exit 0 (%d events, %d spawn "
          "chain(s))" % (card, ready_s, first, second, restart_s, story["events_total"], len(restarts)))


def topology_kernel_rows(torch, kernels):
    """K3, the centring and K2 at the tree's shapes (``TOPO_SHAPES``), held
    against their plain versions and timed."""
    gen = torch.Generator(device="cuda").manual_seed(20261022)
    library = {"pairwise_sq_distances_gram": lambda x: torch.cdist(x, x).square(), "nanmedian_columns": None,
               "coordinate_median": lambda x: torch.kthvalue(x, x.shape[0] // 2 + 1, dim=0).values}
    rows = []
    for name, n, d, label in TOPO_SHAPES:
        x = torch.randn((n, d), device="cuda", generator=gen)
        args = (kernels.nanmedian_columns(x),) if name == "pairwise_sq_distances_gram" else ()
        got = getattr(kernels, name)(x, *args)
        torch.cuda.synchronize()
        err = compare(name, got, kernels.PLAIN[name](x, *args), torch, x, args)
        row = timed_row(torch, kernels, name, x, args, library[name], err)
        row["name"], row["label"] = name, label
        print("topology kernel %-27s (%d, %d) %s: %.4f ms (on the card %s ms), plain %.3f ms, library %s ms, "
              "bound %.2f us (%s), max |err| %g, on %s"
              % (name, n, d, label, row["ms"], "not measured" if row["device_ms"] is None else "%.4f"
                 % row["device_ms"], row["plain_ms"], "%.3f" % row["library_ms"] if row["library_ms"] is not None
                 else "none", row["bound_ms"] * 1e3, row["bound_by"], err, card_line()))
        rows.append(row)
        del x, got
    torch.cuda.empty_cache()
    return rows


def topology_phase(torch, kernels, runner, card, workdir, kernel_rows):
    """The fleet planes on the card: F1 and F1b the tree's protocol through
    the runner, F2 its emissions alone, F3 the sentinel, F4 the supervisor
    and the postmortem (module docstring); returns {kernel: launches} of the
    runner legs and appends the kernel rows at the tree's shapes."""
    begin = time.perf_counter()
    totals = {name: 0 for name in kernels.KERNELS}
    parts = {}
    # F4's supervised child starts, dies and restarts beside F1 and F2 (its
    # own processes; F3's sentinel compares timed runs, so it runs alone)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        f4 = pool.submit(_topology_f4, workdir, card)
        _topology_f1(torch, runner, kernels, card, workdir, totals)
        parts["F1"] = time.perf_counter() - begin
        _topology_f2(torch, kernels, card)
        kernel_rows.extend(topology_kernel_rows(torch, kernels))
        parts["F2"] = time.perf_counter() - begin - sum(parts.values())
        f4.result()
        parts["F4 (beside F1, F2)"] = time.perf_counter() - begin - sum(parts.values())
    _topology_f3(runner, kernels, card, workdir, totals)
    parts["F3"] = time.perf_counter() - begin - sum(parts.values())
    print("topology phase: %.1f s (%s), launches %s" % (time.perf_counter() - begin, ", ".join(
        "%s %.1f s" % item for item in parts.items()), {k: v for k, v in totals.items() if v}))
    return totals


#: the kernels the GAR contract sweep must reach on the card, and the specs
#: that reach each (the centring and K2 through bucketing's 4 bucket means)
ANALYSIS_REACH = {
    "pairwise_sq_distances": ("krum",),
    "nanmedian_columns": ("bucketing:s=2,inner=krum",),
    "pairwise_sq_distances_gram": ("bucketing:s=2,inner=krum",),
    "coordinate_median": ("median",),
    "coordinate_averaged_median": ("averaged-median", "bulyan"),
    "coordinate_trimmed_mean": ("trimmed-mean",),
    "average_nan_columns": ("average-nan",),
}
#: the analysis phase's budget (seconds, both widths on the card)
ANALYSIS_BUDGET_S = 60.0


def gar_sweep_child(out, d):
    """``chip_smoke.py --gar-sweep-cpu out.json d``: the port's GAR contract
    sweep on the CPU at width ``d`` (the kernels' plain versions), at the
    lowest priority and on 4 threads, beside the card's phases; writes its
    findings' fingerprints."""
    os.nice(19)
    import torch

    torch.set_num_threads(4)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from aggregathor_tpu_torch.analysis import gar_contract

    begin = time.perf_counter()
    findings = gar_contract.check(device="cpu", d=int(d))
    print("analysis: the CPU sweep at d = %d, %d specs, in %.1f s: %d finding(s)"
          % (int(d), len(gar_contract.default_specs()), time.perf_counter() - begin, len(findings)))
    with open(out, "w") as fd:
        json.dump(sorted(f.fingerprint for f in findings), fd)


def analysis_phase(torch, kernels, build, card, cpu_sweep):
    """The port's GAR contract sweep (``analysis/gar_contract.py``) on the
    card through K1-K6 and the centring, every spec of JAX's list at d =
    ``PROBE_D`` and at cnnet's width: its findings must be the CPU's at the
    same width, fingerprint for fingerprint (``PROBE_D``: in this process;
    cnnet's width: ``cpu_sweep``, the child started after the build); each
    kernel of ``ANALYSIS_REACH`` launched by its specs (launch counts read
    around each spec); no kernel built during the phase (the build
    listener); within ``ANALYSIS_BUDGET_S``.  Returns {kernel: launches}."""
    from aggregathor_tpu_torch.analysis import gar_contract

    begin = time.perf_counter()
    totals = {name: 0 for name in kernels.KERNELS}
    builds = []

    def note_build(*args):
        builds.append(args)

    build.add_build_listener(note_build)
    try:
        for d in (gar_contract.PROBE_D, CNNET_D):
            start = time.perf_counter()
            found, by_spec = [], {}
            for spec in gar_contract.default_specs():
                kernels.reset_launch_counts()
                found += [f.fingerprint for f in gar_contract.check_spec(spec, "cuda", d)]
                torch.cuda.synchronize()
                by_spec[spec] = kernels.launch_counts()
                for name, count in by_spec[spec].items():
                    totals[name] += count
            seconds = time.perf_counter() - start
            if d == gar_contract.PROBE_D:
                cpu = sorted(f.fingerprint for f in gar_contract.check(device="cpu", d=d))
            else:
                cpu = cpu_sweep.join()
            reached = {name: {spec: by_spec[spec][name] for spec in specs} for name, specs in ANALYSIS_REACH.items()}
            print("analysis: the GAR contract sweep at d = %d on %s, %d specs in %.1f s: %d finding(s) on the card, "
                  "%d on the CPU; launches by the reaching specs %s; the sweep's launches %s"
                  % (d, card, len(by_spec), seconds, len(found), len(cpu), json.dumps(reached, sort_keys=True),
                     json.dumps({k: sum(c[k] for c in by_spec.values()) for k in kernels.KERNELS}, sort_keys=True)))
            check(sorted(found) == cpu, "analysis: the card's findings at d = %d differ from the CPU's: card %s, "
                  "CPU %s" % (d, sorted(set(found) - set(cpu)), sorted(set(cpu) - set(found))))
            for name, counts in reached.items():
                for spec, count in counts.items():
                    check(count > 0, "analysis: %s launched no %s at d = %d" % (spec, name, d))
    finally:
        build.remove_build_listener(note_build)
    check(not builds, "analysis: kernels built during the phase: %s" % builds)
    seconds = time.perf_counter() - begin
    print("analysis phase: %.1f s (budget %.0f s) on %s, launches %s"
          % (seconds, ANALYSIS_BUDGET_S, card, {k: v for k, v in totals.items() if v}))
    check(seconds <= ANALYSIS_BUDGET_S, "analysis: %.1f s over its budget of %.0f s" % (seconds, ANALYSIS_BUDGET_S))
    return totals


def smoke_phases(torch, gars, models, runner, build, kernels, card, workdir, children):
    """Every phase from the kernels' to the resumes, in order; returns the
    kernel rows and the main path's {kernel: launches}.  ``children``: the
    child processes started beside card work, which the caller stops."""
    rows = timed_phase("kernels", lambda: kernel_phase(torch, kernels))
    timed_phase("vmap", lambda: vmap_phase(torch, gars, models))
    totals = timed_phase("main path", lambda: main_path_phase(torch, kernels, runner, card, workdir, models))
    timed_phase("reference", lambda: reference_phase(torch, gars, kernels, models))
    timed_phase("leaf widths", lambda: leaf_width_phase(torch, kernels, models))
    for kernel, count in timed_phase("options reference", lambda: options_reference_phase(
            torch, gars, kernels, models)).items():
        totals[kernel] += count
    leaf_counts, batched_rows = timed_phase("leaf bucketing", lambda: leaf_bucketing_phase(
        torch, gars, kernels, models, runner, card))
    for kernel, count in leaf_counts.items():
        totals[kernel] += count
    rows += batched_rows
    gar_ms = timed_phase("gar", lambda: gar_phase(torch, gars, models))
    for kernel, count in timed_phase("gar extensions", lambda: gar_extensions_phase(
            torch, gars, kernels, runner, card, workdir, gar_ms)).items():
        totals[kernel] += count
    for kernel, count in timed_phase("analysis", lambda: analysis_phase(torch, kernels, build, card,
                                                                        children[0])).items():
        totals[kernel] += count
    timed_phase("corpus", corpus_phase)
    tfm_rows, serve_rows, topology_rows, two_ranks = [], [], [], {}
    phases = (
        ("pipeline", lambda: pipeline_phase(torch, kernels, runner, card)),
        ("plane", lambda: plane_phase(torch, kernels, runner, card, workdir, gar_ms)),
        ("profiler", lambda: profiler_phase(kernels, runner, card, workdir)),
        ("observability", lambda: observability_phase(kernels, runner, card, workdir)),
        ("guardian", lambda: guardian_phase(torch, kernels, runner, card, workdir)),
        ("chaos", lambda: chaos_phase(torch, gars, kernels, models, runner, card, workdir)),
        ("codec", lambda: codec_phase(torch, kernels, runner, card, workdir)),
        ("bounded", lambda: bounded_phase(torch, gars, kernels, models, runner, card, workdir)),
        ("bounded ranks", lambda: bounded_ranks_phase(torch, kernels, card, two_ranks)),
        ("secure", lambda: secure_phase(torch, kernels, runner, card, workdir)),
        ("zoo", lambda: zoo_beside_digits(torch, gars, kernels, models, runner, card, workdir, children)),
        ("transformer", lambda: transformer_phase(torch, gars, kernels, models, runner, card, tfm_rows)),
        ("serve", lambda: serve_phase(torch, gars, kernels, models, runner, card, workdir, serve_rows)),
        ("topology", lambda: topology_phase(torch, kernels, runner, card, workdir, topology_rows)),
        ("multirank", lambda: multirank_phase(torch, kernels, card, two_ranks)))
    for label, phase in phases:
        for kernel, count in timed_phase(label, phase).items():
            totals[kernel] += count
    for row in rows:
        check(totals[row["name"]] > 0, "%s was never launched on the main path" % row["name"])
        row["launches"] = totals[row["name"]]
        if row["name"] in kernels.KERNELS:
            row["batched_launches"] = totals[batched(row["name"])]
        row["transformer_shapes"] = [r for r in tfm_rows if r["name"] == row["name"]]
        row["serve_shapes"] = [r for r in serve_rows if r["name"] == row["name"]]
        row["topology_shapes"] = [r for r in topology_rows if r["name"] == row["name"]]
    timed_phase("attack", lambda: attack_phase(runner, workdir))
    resume_begin = time.perf_counter()
    krum = ["--aggregator", "krum", "--nb-workers", "8", "--nb-decl-byz-workers", "2"]
    resume_phase(torch, runner, os.path.join(workdir, "mlp"), "digits", [], krum + [
        "--learning-rate-args", "initial-rate:0.1"])
    resume_phase(torch, runner, os.path.join(workdir, "conv"), "digits-conv", ["batch-size:16"], krum + [
        "--learning-rate-args", "initial-rate:0.05"])
    # the batches drawn on the card, 4 steps a call: 10 = 2 calls and a
    # tail of 2, the resumed 10 the same, the uninterrupted 20 five calls
    device_input = ("--input-source", "device", "--unroll", "4")
    resume_phase(torch, runner, os.path.join(workdir, "mlp-device"), "digits", [], krum + [
        "--learning-rate-args", "initial-rate:0.1"], device_input)
    resume_phase(torch, runner, os.path.join(workdir, "conv-device"), "digits-conv", ["batch-size:16"], krum + [
        "--learning-rate-args", "initial-rate:0.05"], device_input)
    # the int8 wire with error feedback: the residuals resume bit for bit too
    resume_phase(torch, runner, os.path.join(workdir, "conv-int8"), "digits-conv", ["batch-size:16"], krum + [
        "--learning-rate-args", "initial-rate:0.05", "--exchange", "int8:ef"])
    print("phase resume: %.1f s" % (time.perf_counter() - resume_begin))
    return rows, totals


def zoo_beside_digits(torch, gars, kernels, models, runner, card, workdir, children):
    """The zoo phase with the digits anchors in a child process beside its
    card legs (joined before Z4, so that Z4's budget is its own) and Z5's
    CPU half on a thread; returns {kernel: launches} of both."""
    digits = Child("digits", "--digits-anchors", workdir)
    children.append(digits)
    counts = zoo_phase(torch, gars, kernels, models, runner, card, beside=digits.join)
    for kernel, count in digits.join().items():
        counts[kernel] += count
    return counts


def timed_phase(label, phase):
    """``phase()``, its seconds printed as ``phase <label>: <s> s``."""
    begin = time.perf_counter()
    out = phase()
    print("phase %s: %.1f s" % (label, time.perf_counter() - begin))
    return out


def main():
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs the port on a GPU")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from aggregathor_tpu_torch import gars, models
    from aggregathor_tpu_torch.cli import runner
    from aggregathor_tpu_torch.ops import build, kernels

    card = card_line()
    print(card)
    name = torch.cuda.get_device_name(0)
    print("torch %s, CUDA %s, %s" % (torch.__version__, torch.version.cuda, name))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    t0 = time.perf_counter()
    reports = build.build_all()
    print("built %s in %.1f s into %s" % (sorted(reports) or "nothing (cached)", time.perf_counter() - t0,
                                          build.build_dir()))

    with tempfile.TemporaryDirectory(prefix="chip_smoke-") as workdir:
        children = [Child("analysis CPU sweep", "--gar-sweep-cpu", workdir, CNNET_D)]
        try:
            rows, totals = smoke_phases(torch, gars, models, runner, build, kernels, card, workdir, children)
        finally:
            for child in children:
                child.stop()
    breakdown_begin = time.perf_counter()
    for source in ("stream", "device"):
        breakdown_phase(torch, gars, models, input_source=source,
                        args=["augment:device"] if source == "device" else [])
        breakdown_phase(torch, gars, models, experiment="digits-conv", args=["batch-size:16"], input_source=source)
    # cnnet in bf16 drawn on the card: the gradient phase without the host batch
    breakdown_phase(torch, gars, models, input_source="device", args=["augment:device", "dtype:bfloat16"])
    print("phase breakdown: %.1f s" % (time.perf_counter() - breakdown_begin))
    print("chip_smoke: %.1f s" % (time.perf_counter() - t0))

    print("held against their plain versions: %s" % ", ".join(
        "%s (%s)" % (row["name"], kernels.KERNELS[row["name"].replace("_batched", "")].label) for row in rows))
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--digits-anchors"]:
        digits_child(sys.argv[2])
    elif sys.argv[1:2] == ["--gar-sweep-cpu"]:
        gar_sweep_child(sys.argv[2], sys.argv[3])
    else:
        main()
