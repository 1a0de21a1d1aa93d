#!/usr/bin/env python3
"""Time the port's distance and rank kernels of any checkout on one GPU.

    python3 scripts/torch_rank_timing.py [--root CHECKOUT] [--parts k1,rank,end-to-end,breakdown,input]
                                         [--k1-rows 8,11,16,20,21,64]

Times, with ``chip_smoke.time_ms`` (CUDA events, 20 calls after 3 warm-up
calls), on random (seeded) cnnet-width inputs
(d = 1,756,682, the cnnet gradient length):

- ``k1``: K1 ``pairwise_sq_distances`` at (n, d) for each n of
  ``--k1-rows`` (by default Krum's and Bulyan's main path, 8 and 11, both
  sides of its switch from registers to staged tiles, 16, 20 and 21, and
  64, the most rows it serves), each also by ``chip_smoke.device_ms``
  (torch.profiler: the card's own time, without the host's between calls);
- ``rank``: K3 ``coordinate_median`` at (128, d), beside ``torch.kthvalue``
  (the library call computing the same upper median on finite input);
  K4 ``coordinate_averaged_median`` at (110, d) with beta = 94: Bulyan's
  last phase at n = 128, f = 8; K5 ``coordinate_trimmed_mean`` at (128, d)
  with trim 8 and keep 112; the median centring in front of K2,
  ``nanmedian_columns``, at (128, d); the distance path
  ``pairwise_sq_distances`` on the raw (128, d) (the centring and K2),
  with its peak device memory above the input's, and K2
  ``pairwise_sq_distances_gram`` alone on the centred (128, d) (both calls
  take the same arguments in every version of the port); GAR ms per step
  of krum and bulyan at n = 128, f = 8 on (128, d);
- ``end-to-end``: GAR ms per step of krum at n = 8, f = 2; steps/s
  (excluding the first) of ``chip_smoke.LEGS``' legs of 8 workers, each run
  for ``LEG_STEPS`` steps through the checkout's runner (a leg only where
  the checkout's runner has all of its flags, such as ``--input-source``
  or ``--granularity``); and ``chip_smoke.breakdown_phase``'s split of a
  cnnet + krum step at n = 8;
- ``breakdown``: ``chip_smoke.breakdown_phase`` for cnnet + krum and
  ``digits-conv`` (batch 16) + krum at n = 8 with the batches streamed and,
  where the checkout's engine has ``build_sampled_multi_step``, drawn on the
  card (cnnet then augments in the step): each phase's ms, the whole
  step's and the card's busy share;
- ``input``: the runner's input paths (cuDNN deterministic) on cnnet
  ``augment:device`` + krum (n = 8, f = 2, r = 2 signflip, ``INPUT_STEPS``
  steps): streamed one step a call with the prefetch thread, streamed 10
  steps a call synchronously (``--prefetch 0``) and prefetched
  (``--prefetch 2``: the checkout's chunk path, the ``ChunkPipeline`` where
  it has one, else the whole-chunk prefetcher), and drawn on the card one
  and 10 steps a call; then the streamed chunk path synchronous and
  prefetched on cnnet with its host augmentation (the sequential gather)
  and on ``digits`` + krum n = 8 at ``--unroll 16`` for
  ``DIGITS_INPUT_STEPS`` steps on the real corpus (the gather pool); for
  each, steps/s without the first call, the step latency p50 and the
  in-graph share of the runner's report.

``--root`` names the checkout whose ``aggregathor_tpu_torch`` is imported
(default: the one holding this script), so the same inputs and timer serve
an older commit unpacked beside the working tree: run parent, change, change,
parent in one call to compare two versions on one card (``chip_smoke.py``
times only its own checkout).  Prints the card's name and power limit, then
one JSON object as its last line.  Imports torch only.
"""

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: steps of each leg in the end-to-end part (chip_smoke's legs take 5 to 30)
LEG_STEPS = 20
#: steps of each run in the input part (10-step calls: the first call and 4 more)
INPUT_STEPS = 50
#: steps of the digits runs (16-step calls: the first call and 9 more)
DIGITS_INPUT_STEPS = 160
_KRUM = ["--aggregator", "krum", "--nb-workers", "8", "--nb-decl-byz-workers", "2"]
_CNNET_DEVICE = ["--experiment", "cnnet", "--experiment-args", "augment:device", *_KRUM,
                 "--nb-real-byz-workers", "2", "--attack", "signflip", "--max-step", str(INPUT_STEPS)]
_CNNET_HOST = ["--experiment", "cnnet", *_KRUM, "--nb-real-byz-workers", "2", "--attack", "signflip",
               "--max-step", str(INPUT_STEPS)]
_DIGITS = ["--experiment", "digits", *_KRUM, "--learning-rate-args", "initial-rate:0.1",
           "--max-step", str(DIGITS_INPUT_STEPS)]
INPUT_CASES = [
    # (label, runner arguments before the shared ones, then --unroll K and the input flags)
    ("stream unroll 1 prefetch 2", _CNNET_DEVICE, ["--unroll", "1", "--prefetch", "2"]),
    ("stream unroll 10 prefetch 0", _CNNET_DEVICE, ["--unroll", "10", "--prefetch", "0"]),
    ("stream unroll 10 prefetch 2", _CNNET_DEVICE, ["--unroll", "10", "--prefetch", "2"]),
    ("device unroll 1", _CNNET_DEVICE, ["--unroll", "1", "--input-source", "device"]),
    ("device unroll 10", _CNNET_DEVICE, ["--unroll", "10", "--input-source", "device"]),
    ("cnnet host augmentation stream unroll 10 prefetch 0", _CNNET_HOST, ["--unroll", "10", "--prefetch", "0"]),
    ("cnnet host augmentation stream unroll 10 prefetch 2", _CNNET_HOST, ["--unroll", "10", "--prefetch", "2"]),
    ("digits stream unroll 16 prefetch 0", _DIGITS, ["--unroll", "16", "--prefetch", "0"]),
    ("digits stream unroll 16 prefetch 2", _DIGITS, ["--unroll", "16", "--prefetch", "2"]),
]


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=HERE)
    parser.add_argument("--parts", default="k1,rank", help="what to time: k1, rank, end-to-end, breakdown, input")
    parser.add_argument("--k1-rows", default="8,11,16,20,21,64", help="the row counts K1 is timed at")
    args = parser.parse_args()
    parts = set(args.parts.split(","))
    import torch

    if not torch.cuda.is_available():
        sys.exit("torch_rank_timing: no CUDA device")
    sys.path.insert(0, HERE)
    # this checkout's timers, legs and step split, for every root
    from chip_smoke import CNNET_D, LEGS, breakdown_phase, card_line, device_ms, time_ms

    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from aggregathor_tpu_torch import gars, models
    from aggregathor_tpu_torch.cli import runner
    from aggregathor_tpu_torch.ops import build, kernels
    from aggregathor_tpu_torch.parallel import RobustEngine

    device_input = hasattr(RobustEngine, "build_sampled_multi_step")

    card = card_line()
    print(card)
    build.build_all()
    gen = torch.Generator(device="cuda").manual_seed(20261016)
    out = {"root": root, "card": card}
    if "k1" in parts:
        for n in map(int, args.k1_rows.split(",")):
            x = torch.randn((n, CNNET_D), device="cuda", generator=gen)
            out["K1 pairwise_sq_distances (%d, d)" % n] = time_ms(lambda: kernels.pairwise_sq_distances(x), torch)
            out["K1 pairwise_sq_distances (%d, d) on the card" % n] = device_ms(
                lambda: kernels.pairwise_sq_distances(x), torch)
            del x
    if "end-to-end" in parts:
        x = torch.randn((8, CNNET_D), device="cuda", generator=gen)
        gar = gars.instantiate("krum", 8, 2)
        out["GAR krum n=8"] = time_ms(lambda: gar.aggregate(x), torch)
        del x
        known = runner.build_parser()._option_string_actions  # the checkout's runner flags
        for label, argv, _ in LEGS:
            if argv[argv.index("--nb-workers") + 1] != "8" or any(
                    arg.startswith("--") and arg not in known for arg in argv):
                continue
            argv = list(argv)
            argv[argv.index("--max-step") + 1] = str(LEG_STEPS)
            result = runner.main(["--experiment", "cnnet", "--seed", "1", *argv])
            out["leg %s steps/s" % label] = result["steps_per_s"]
        phases, busy = breakdown_phase(torch, gars, models)
        for phase, ms in phases.items():
            out["breakdown krum n=8 %s ms" % phase] = ms
        out["breakdown krum n=8 busy share"] = busy
    if "breakdown" in parts:
        cases = [("cnnet", [], "stream"), ("digits-conv", ["batch-size:16"], "stream")]
        if device_input:
            cases += [("cnnet", ["augment:device"], "device"), ("digits-conv", ["batch-size:16"], "device")]
        for experiment, exp_args, source in cases:
            phases, busy = breakdown_phase(torch, gars, models, experiment=experiment, args=exp_args,
                                           input_source=source)
            for phase, ms in phases.items():
                out["breakdown %s %s %s ms" % (experiment, source, phase)] = ms
            out["breakdown %s %s busy share" % (experiment, source)] = busy
    if "input" in parts:
        from aggregathor_tpu_torch.models import datasets

        # the port's copy of the real digits corpus, as chip_smoke's corpus_phase
        # points the loaders at it (cnnet keeps its CIFAR-10 stand-in)
        os.environ["AGGREGATHOR_DATA"] = datasets.DIGITS_DIR
        torch.backends.cudnn.deterministic = True
        for label, case, extra in INPUT_CASES:
            result = runner.main([*case, "--seed", "1", "--evaluation-delta", "-1", "--evaluation-period", "-1",
                                  "--summary-period", "-1", *extra])
            p, first = result["perf"], int(extra[1])
            out["input %s steps/s" % label] = (result["steps"] - first) / (p["total_s"] - p["first_step_s"])
            out["input %s step latency p50 ms" % label] = 1e3 * p["latency"]["p50"]
            out["input %s in-graph share" % label] = p["in_graph_s"] / p["total_s"]
            out["input %s fed by" % label] = result.get("input_pipeline", "-")
        torch.backends.cudnn.deterministic = False
    if "rank" in parts:
        rank_timings(torch, kernels, gars, gen, out, CNNET_D, time_ms)
    for key, value in out.items():
        if isinstance(value, float):
            print("%-55s %.4f %s" % (key, value, "MB" if "MB" in key else "ms" if "ms" in key else ""))
    print(json.dumps(out))


def rank_timings(torch, kernels, gars, gen, out, d, time_ms):
    """The ``rank`` part, into ``out``."""
    x128 = torch.randn((128, d), device="cuda", generator=gen)
    x110 = x128[:110].contiguous()
    out.update({
        "K3 coordinate_median (128, d)": time_ms(lambda: kernels.coordinate_median(x128), torch),
        "torch.kthvalue (128, d)": time_ms(lambda: torch.kthvalue(x128, 65, dim=0).values, torch),
        "K4 coordinate_averaged_median (110, d) beta=94":
            time_ms(lambda: kernels.coordinate_averaged_median(x110, 94), torch),
        "K5 coordinate_trimmed_mean (128, d) trim=8 keep=112":
            time_ms(lambda: kernels.coordinate_trimmed_mean(x128, 8, 112), torch),
        "centring nanmedian_columns (128, d)": time_ms(lambda: kernels.nanmedian_columns(x128), torch),
        "distances pairwise_sq_distances raw (128, d)": time_ms(lambda: kernels.pairwise_sq_distances(x128), torch),
    })
    centred = x128 - kernels.nanmedian_columns(x128)[None, :]
    out["K2 pairwise_sq_distances_gram centred (128, d)"] = time_ms(
        lambda: kernels.pairwise_sq_distances_gram(centred), torch)
    del centred
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kernels.pairwise_sq_distances(x128)
    torch.cuda.synchronize()
    out["distances peak MB above the input (128, d)"] = (torch.cuda.max_memory_allocated() - base) / 2**20
    for rule in ("krum", "bulyan"):
        gar = gars.instantiate(rule, 128, 8)
        out["GAR %s n=128" % rule] = time_ms(lambda: gar.aggregate(x128), torch)


if __name__ == "__main__":
    main()
