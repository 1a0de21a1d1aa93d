#!/usr/bin/env python3
"""Time the port's kernels beyond 64 rows of any checkout on one GPU.

    python3 scripts/torch_rank_timing.py [--root CHECKOUT]

Times, with ``chip_smoke.time_ms`` (CUDA events, 20 calls after 3 warm-up
calls), on random (seeded) cnnet-width inputs
(d = 1,756,682, the cnnet gradient length):

- K3 ``coordinate_median`` at (128, d), beside ``torch.kthvalue`` (the
  library call computing the same upper median on finite input);
- K4 ``coordinate_averaged_median`` at (110, d) with beta = 94: Bulyan's last
  phase at n = 128, f = 8;
- K5 ``coordinate_trimmed_mean`` at (128, d) with trim 8 and keep 112;
- the median centring in front of K2, ``nanmedian_columns``, at (128, d);
- the distance path ``pairwise_sq_distances`` on the raw (128, d) (the
  centring and K2), with its peak device memory above the input's, and K2
  ``pairwise_sq_distances_gram`` alone on the centred (128, d) (both calls
  take the same arguments in every version of the port);
- GAR ms per step of krum and bulyan at n = 128, f = 8 on (128, d).

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


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=HERE)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("torch_rank_timing: no CUDA device")
    sys.path.insert(0, HERE)
    from chip_smoke import CNNET_D, card_line, time_ms  # this checkout's timer, for every root

    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from aggregathor_tpu_torch import gars
    from aggregathor_tpu_torch.ops import build, kernels

    card = card_line()
    print(card)
    build.build_all()
    gen = torch.Generator(device="cuda").manual_seed(20261016)
    x128 = torch.randn((128, CNNET_D), device="cuda", generator=gen)
    x110 = x128[:110].contiguous()
    out = {
        "root": root,
        "card": card,
        "K3 coordinate_median (128, d)": time_ms(lambda: kernels.coordinate_median(x128), torch),
        "torch.kthvalue (128, d)": time_ms(lambda: torch.kthvalue(x128, 65, dim=0).values, torch),
        "K4 coordinate_averaged_median (110, d) beta=94":
            time_ms(lambda: kernels.coordinate_averaged_median(x110, 94), torch),
        "K5 coordinate_trimmed_mean (128, d) trim=8 keep=112":
            time_ms(lambda: kernels.coordinate_trimmed_mean(x128, 8, 112), torch),
        "centring nanmedian_columns (128, d)": time_ms(lambda: kernels.nanmedian_columns(x128), torch),
        "distances pairwise_sq_distances raw (128, d)": time_ms(lambda: kernels.pairwise_sq_distances(x128), torch),
    }
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
    for key, value in out.items():
        if isinstance(value, float):
            print("%-55s %.4f %s" % (key, value, "MB" if "MB" in key else "ms"))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
