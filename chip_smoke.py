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
   f=2; (11, 1,756,682), Bulyan's distances; (128, 1,756,682) centred by
   its column median, Krum's distances at n=128 (K2) -- and on poisoned
   inputs: NaN and +-inf rows and columns, tied values, a majority-NaN
   column, widths that are no multiple of the kernels' chunks, n=256 (and
   n=64 for K1, n=65..256 for K2).  Tolerances: K3 bit-exact (the kernel
   returns an original value); K4, K5, K6: same NaN/inf pattern, |a - b| <=
   1e-6 (1 + |b|) (sums of unit-scale float32 values in another order); K1:
   same NaN pattern, relative 1e-5 (a sum of d squares in another order; the
   diagonal must be 0 in both); K2: same non-finite pattern, diagonal 0, and
   off it |a - b| <= 1e-5 (|x_i|^2 + |x_j|^2) on the centred rows (a Gram
   form's terms are as large as the squared norms, so its error scales with
   them, not with the distance).  Beyond 64 rows K3/K4/K5 and the median
   centring in front of K2 (``nanmedian_columns``, bit-exact like K3) run
   their sort path: held at the main path's shapes (K3 and K5 (8, 112) at
   (128, 1,756,682), K4 beta=94 at (110, 1,756,682), the centring on the raw
   (128, 1,756,682)) and on poisoned inputs at n = 65, 127, 128, 129, 256
   and 1000, and at 1030 on the re-reading path (NaN/+-inf rows and columns, an all-NaN and a majority-NaN
   column, signed zeros, ties, widths off the blocks' column counts).  Each
   kernel is timed with CUDA events at its main-path shape (K3-K5 also at
   their sort-path shape) beside its plain version, one PyTorch library call
   where one computes the same function, and its bound: max(bytes moved /
   3.35 TB/s, operations / 67 TFLOP/s), the operations of the sort path
   being its compare-exchanges.  Distances of 64 rows must launch K1 and of
   65 the centring and K2.
3. Drive the port's runner on the card: cnnet + krum (n=8, f=2, r=2
   signflip) for 30 steps at d = 1,756,682, then a few steps each of
   bulyan (n=11, f=2), median, trimmed-mean, averaged-median, krum at n=128
   (the centring and K2), bulyan at n=128 (the centring, K2, and K4 on the
   sort path), and the lossy link: average-nan (K6) and krum under --UDP, and
   average under --UDP with CLEVER infill.  Every launch count is set to 0
   just before a leg and read just after: each leg must have launched its
   kernels once a step, and its loss must be finite.  Then each rule's
   aggregate of a small poisoned matrix on the card is held against the
   same rule on the CPU (Krum's and Bulyan's selections must be identical,
   at n=11 and at n=72), three MLP steps on the card against the same steps
   on the CPU, without and with --UDP-style loss, and each rule's time on
   the (n, d) cnnet matrix is read (GAR ms a step).
   Last, a cnnet + krum step is split into its phases (host batch, transfer,
   worker gradients, attack + aggregate, update) and the card's busy share
   over whole steps is traced with torch.profiler.
4. Print the kernels held against their plain versions, the JSON kernel
   table, and last the JSON result line.
"""

import json
import os
import subprocess
import sys
import time

MEMORY_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FP32_OPS_PER_S = 67e12        # H100 SXM, FP32 outside the tensor cores
CNNET_D = 1756682


def fail(message):
    print("chip_smoke: FAILED: %s" % message, file=sys.stderr)
    sys.exit(1)


def check(condition, message):
    if not condition:
        fail(message)


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


def compare(name, a, b, torch, x=None):
    """Max |a - b| over finite entries, after the exactness checks of ``name``
    (``x``: the input rows, for K2's tolerance)."""
    check(a.shape == b.shape, "%s: shape %s != %s" % (name, tuple(a.shape), tuple(b.shape)))
    check(torch.equal(torch.isnan(a), torch.isnan(b)), "%s: NaN pattern differs" % name)
    if name == "pairwise_sq_distances_gram":
        check(torch.equal(torch.isfinite(a), torch.isfinite(b)), "K2: non-finite pattern differs")
        diagonal = torch.diagonal(b)
        check(bool(torch.all(torch.diagonal(a)[torch.isfinite(diagonal)] == 0)), "K2: diagonal not 0")
        check(torch.equal(torch.nan_to_num(a), torch.nan_to_num(a.T)), "K2: not symmetric")
        norms = torch.sum(torch.square(x.double()), dim=1)
        scale = norms[:, None] + norms[None, :]
        off = torch.isfinite(b) & ~torch.eye(b.shape[0], dtype=torch.bool, device=b.device)
        err = torch.abs(a.double() - b.double())[off]
        max_err = float(err.max()) if err.numel() else 0.0
        check(bool(torch.all(err <= 1e-5 * scale[off])), "K2: outside tolerance (max err %g)" % max_err)
        return max_err
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
    """(bytes, operations, what the operations count) of one call at (n, d)."""
    if name == "pairwise_sq_distances":
        return n * d * 4 + n * n * 4, n * (n + 1) // 2 * d * 3, "3 per pair and column"
    if name == "pairwise_sq_distances_gram":
        return n * d * 4 + n * n * 4, n * (n + 1) // 2 * d * 2, "an FMA per pair and column"
    if name == "average_nan_columns":
        return n * d * 4 + d * 4, 2 * n * d + d, "a test and an add per value"
    if n <= 64 and name != "nanmedian_columns":
        passes = 2 if name == "coordinate_averaged_median" else 1
        return n * d * 4 + d * 4, passes * n * n * d + n * d, "n^2 compares per rank pass"
    # the sort path: P log2(P) (log2(P) + 1) / 4 compare-exchanges of a min
    # and a max per column and sort (two sorts for K4), n steps of the row pass
    p = kernels.sort_shape(n)[0]
    log_p = p.bit_length() - 1
    sorts = 2 if name == "coordinate_averaged_median" else 1
    return n * d * 4 + d * 4, sorts * (p * log_p * (log_p + 1) // 2 + n) * d, "the sort's min/max"


def timed_row(torch, kernels, name, x, args, library, max_abs_err):
    """Time kernel, plain version and library call at x; the JSON row's numbers."""
    kernel, plain = getattr(kernels, name), kernels.PLAIN[name]
    n, d = x.shape
    ms = time_ms(lambda: kernel(x, *args), torch, iters=20 if n > 64 else 50, warmup=5)
    plain_ms = time_ms(lambda: plain(x, *args), torch, iters=5)
    library_ms = time_ms(lambda: library(x), torch, iters=5) if library else None
    nbytes, ops, counted = bounds(kernels, name, n, d)
    bytes_ms, ops_ms = nbytes / MEMORY_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations", "library_ms": library_ms,
            "shape": [n, d], "max_abs_err": max_abs_err, "operations": ops, "operations_ms": ops_ms,
            "operations_counted": counted}


def kernel_phase(torch, kernels):
    """Hold each kernel against its plain version; time it at the main shape."""
    gen = torch.Generator(device="cuda").manual_seed(20261016)

    def randn(n, d):
        return torch.randn((n, d), device="cuda", generator=gen)

    def centred(x):
        return x - kernels.nanmedian_columns(x)[None, :]

    def gram_poison(n, d):
        x = poison(randn(n, d), columns=False)
        x[: n // 2 + 1, 19] = float("nan")  # a majority-NaN column
        return centred(x)

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
    bulyan_sel = randn(5, CNNET_D)
    raw128 = randn(128, CNNET_D)
    krum128 = centred(raw128)
    bulyan128 = raw128[:110].contiguous()  # Bulyan's t = 110 selections at n = 128, f = 8
    udp = lossy(8, CNNET_D)
    all_nan = randn(7, 3001)
    all_nan[:, 100] = float("nan")
    # beyond 64 rows (the sort path up to 1024, the re-reading path beyond):
    # widths off the sort blocks' 32/16/8 columns
    beyond = [(n, 4099 if n <= 256 else 1025) for n in (65, 127, 128, 129, 256, 1000, 1030)]
    cases = {
        "pairwise_sq_distances": [(main, ()), (bulyan_rows, ()), (poison(randn(8, 100003), False), ()),
                                  (poison(randn(11, 5001), False), ()), (poison(randn(64, 20011), False), ()),
                                  (poison(randn(3, 129), False), ())],
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
        "pairwise_sq_distances_gram": [(krum128, ()), (gram_poison(65, 20011), ()), (gram_poison(72, 129), ()),
                                       (gram_poison(130, 5001), ()), (gram_poison(256, 4099), ())],
        "average_nan_columns": [(udp, ()), (poison(randn(8, 100003)), ()), (poison(randn(11, 5001)), ()),
                                (poison(randn(256, 4099)), ()), (all_nan, ())],
        "nanmedian_columns": [(raw128, ()), (rank_poison(7, 3001), ())]
                             + [(rank_poison(n, d), ()) for n, d in beyond],
    }
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
        print("kernel %-27s %s (%d, %d): %.4f ms, plain %.3f ms, library %s ms, bound %.1f us (%s; "
              "operations %.1f us), max |err| %g, %d inputs held"
              % (name, label, row["shape"][0], row["shape"][1], row["ms"], row["plain_ms"],
                 "%.3f" % row["library_ms"] if row["library_ms"] is not None else "-",
                 row["bound_ms"] * 1e3, row["bound_by"], row["operations_ms"] * 1e3, row["max_abs_err"], held))

    rows = []
    for name, inputs in cases.items():
        kernel, plain = getattr(kernels, name), kernels.PLAIN[name]
        errors = []
        for x, args in inputs + ([sort_main[name]] if name in sort_main else []):
            got = kernel(x, *args)
            torch.cuda.synchronize()
            errors.append(compare(name, got, plain(x, *args), torch, x))
        x, args = inputs[0]
        info = kernels.KERNELS[name]
        row = {"name": name, "route": "cuda", "source": info.source, "replaces": info.replaces, "launches": 0}
        row.update(timed_row(torch, kernels, name, x, args, library.get(name), errors[0]))
        row["max_abs_err_all_inputs"] = max(errors)
        report(name, info.label, row, len(errors))
        if name in sort_main:
            # the sort path beyond 64 rows, at its main-path shape
            x, args = sort_main[name]
            row["sort_path"] = timed_row(torch, kernels, name, x, args,
                                         library.get(name) if name == "coordinate_median" else None, errors[-1])
            report(name, info.label + " sort path", row["sort_path"], 1)
        rows.append(row)
    # the distances switch form past 64 rows: K1 at n = 64, the centring and K2 at n = 65
    for n, want in ((64, {"pairwise_sq_distances"}), (65, {"pairwise_sq_distances_gram", "nanmedian_columns"})):
        before = kernels.launch_counts()
        kernels.pairwise_sq_distances(randn(n, 4099))
        torch.cuda.synchronize()
        after = kernels.launch_counts()
        launched = {k: after[k] - before[k] for k in after}
        check(launched == {k: int(k in want) for k in after},
              "distances at n=%d launched %s (want %s once each)" % (n, launched, sorted(want)))
    del main, bulyan_rows, bulyan_sel, krum128, raw128, bulyan128, udp, cases, sort_main
    torch.cuda.empty_cache()
    return rows


LEGS = [
    # (label, runner arguments, the kernels each step must launch once)
    ("cnnet+krum", ["--aggregator", "krum", "--nb-workers", "8", "--nb-decl-byz-workers", "2",
                    "--nb-real-byz-workers", "2", "--attack", "signflip", "--max-step", "30",
                    "--evaluation-delta", "30"], ("pairwise_sq_distances",)),
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
]


def main_path_phase(torch, kernels, runner, card):
    """Drive each leg through the runner; returns {kernel: launches} summed over the legs."""
    totals = {name: 0 for name in kernels.KERNELS}
    for label, argv, expected in LEGS:
        kernels.reset_launch_counts()
        result = runner.main(["--experiment", "cnnet", "--seed", "1", *argv])
        counts = kernels.launch_counts()
        steps = result["steps"]
        check(result["final_loss"] is not None and result["final_loss"] == result["final_loss"]
              and abs(result["final_loss"]) != float("inf"), "%s: non-finite loss" % label)
        for name in kernels.KERNELS:
            want = steps if name in expected else 0
            check(counts[name] == want, "%s: %s launched %d times in %d steps (want %d)"
                  % (label, name, counts[name], steps, want))
            totals[name] += counts[name]
        print("leg %-22s %d steps, %.3f steps/s excl. 1st on %s, final loss %.4f, accuracy %.4f, launches %s"
              % (label, steps, result["steps_per_s"], card, result["final_loss"],
                 result["evaluation"]["accuracy"], json.dumps(counts, sort_keys=True)))
    return totals


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
    x = torch.randn((72, 3001), generator=gen) * (1.0 + 0.02 * torch.arange(72.0))[:, None]
    x[:8] += 25.0
    x[40] = float("nan")
    x[3, 5::97] = float("inf")
    x[60, 7::89] = float("nan")
    for rule in ("krum", "bulyan"):
        agree(rule, x, 8)

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
    print("reference: %d rules on a poisoned (11, 3001) matrix, krum and bulyan on a poisoned (72, 3001) "
          "matrix, and 3 MLP steps of krum and of average-nan under --UDP agree with the CPU" % len(rules))


def gar_phase(torch, gars):
    """Each rule's ms on the cnnet-width matrix (the per-layer metric: GAR ms a step)."""
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
    return out


def breakdown_phase(torch, gars, models, steps=10):
    """Where a cnnet + krum step's time goes, and how busy the card is.

    The phases are the engine's own step pieces, timed on the host clock with
    the card synchronized after each (so each phase's device work lands in
    it); the first step warms up and is not counted.  The busy share is the
    union of the card's kernel intervals over whole runner-like steps (batch
    production included), traced by torch.profiler, over their wall time."""
    from torch.profiler import ProfilerActivity, profile

    from aggregathor_tpu_torch.core import FlatMap, build_optimizer, build_schedule
    from aggregathor_tpu_torch.parallel import RobustEngine, attacks

    exp = models.instantiate("cnnet", [])
    tx = build_optimizer("sgd", build_schedule("fixed", []))
    engine = RobustEngine(gars.instantiate("krum", 8, 2), 8, nb_real_byz=2,
                          attack=attacks.instantiate("signflip", 8, 2), device="cuda")
    state = engine.init_state(exp.init(1), tx, seed=1)
    flatmap = FlatMap(state.params)
    it = exp.make_train_iterator(8, seed=2)
    names = ("host batch", "to device", "worker gradients", "attack + aggregate", "update")
    totals = dict.fromkeys(names, 0.0)
    for s in range(steps + 1):
        marks = [time.perf_counter()]
        batch = next(it)
        marks.append(time.perf_counter())
        on_card = engine.put_batch(batch)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        _, rows = engine._worker_gradients(state.params, on_card, exp.loss, flatmap)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        with torch.no_grad():
            rows = engine._prepare_rows(engine._perturb_local(rows, state.seed, state.step))
            agg = engine._aggregate_block(rows)
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

    step = engine.build_step(exp.loss, tx)

    def run(count):
        nonlocal state
        start = time.perf_counter()
        for _ in range(count):
            state, metrics = step(state, engine.put_batch(next(it)))
            float(metrics["total_loss"])
        torch.cuda.synchronize()
        return (time.perf_counter() - start) * 1e6

    step_us = run(steps) / steps  # untraced whole steps, the denominator of the busy share
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall_us = run(5)
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
    busy = busy_us / 5 / step_us if intervals else None
    print("breakdown cnnet+krum n=8 ms/step over %d steps: %s; phases sum %.2f ms; whole step %.2f ms untraced; "
          "card busy %s ms/step over 5 traced steps (%.1f ms traced wall, torch.profiler, %d device events): "
          "busy share %s of the untraced step"
          % (steps, json.dumps(per_step), sum(per_step.values()), step_us / 1e3,
             "%.2f" % (busy_us / 5e3) if intervals else "not measured", wall_us / 1e3, len(intervals),
             "%.3f" % busy if busy is not None else "not measured"))
    return per_step, busy


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

    rows = kernel_phase(torch, kernels)
    totals = main_path_phase(torch, kernels, runner, card)
    for row in rows:
        check(totals[row["name"]] > 0, "%s was never launched on the main path" % row["name"])
        row["launches"] = totals[row["name"]]
    reference_phase(torch, gars, kernels, models)
    gar_phase(torch, gars)
    breakdown_phase(torch, gars, models)

    print("held against their plain versions: %s" % ", ".join(
        "%s (%s)" % (row["name"], kernels.KERNELS[row["name"]].label) for row in rows))
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
