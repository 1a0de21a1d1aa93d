#!/usr/bin/env python3
"""Where a bounded-wait round's time goes on the GPU (PyTorch port).

    python3 scripts/torch_bounded_timing.py [--rounds 8] [--pairs 2]

cnnet at its published width (d = 1,756,682), n = 8 workers, batch 128,
krum, cuDNN pinned to its deterministic algorithms, on one card:

1. One worker's gradient, timed by wall clock around a synchronize over 10
   calls: ``torch.func.grad_and_value`` (the transform the fused step
   vmaps), ``torch.autograd.grad`` on leaves of their own (what
   ``RobustEngine.build_worker_grad`` runs), the forward alone, and the
   whole submission.
2. Synchronous bounded-wait rounds (``BoundedWaitStep`` without a
   deadline) with one thread at a time enqueueing a submission (the
   step's ``_dispatch_lock``) and with the eight threads enqueueing at once
   (the lock replaced by a no-op), in ``--pairs`` pairs ordered A B B A;
   the fused step and the eight submissions one after another on one
   thread in the same call.  Each: the median round ms after the first
   two rounds, the honest arrivals' p50/p95.

Prints the card's name and power limit first.  Needs a CUDA device.
"""

import argparse
import contextlib
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def wall_ms(torch, fn, reps=10):
    fn()
    torch.cuda.synchronize()
    begin = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - begin) / reps * 1e3


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--rounds", type=int, default=8, help="rounds a timed run")
    parser.add_argument("--pairs", type=int, default=2, help="A B B A pairs of lock on / off")
    args = parser.parse_args()
    import torch
    from torch.func import grad_and_value

    from aggregathor_tpu_torch import gars, models
    from aggregathor_tpu_torch.core import build_optimizer, build_schedule
    from aggregathor_tpu_torch.parallel import RobustEngine
    from aggregathor_tpu_torch.parallel.bounded import BoundedWaitStep

    if not torch.cuda.is_available():
        sys.exit("torch_bounded_timing: needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    n = 8
    exp = models.instantiate("cnnet", [])
    tx = build_optimizer("sgd", build_schedule("fixed", ["initial-rate:0.05"]))
    engine = RobustEngine(gars.instantiate("krum", n, 2), n, device="cuda")
    init = exp.init(1)
    params = {k: v.cuda() for k, v in init.items()}
    it = exp.make_train_iterator(n, seed=2)
    batches = [engine.put_batch(next(it)) for _ in range(args.rounds)]
    one = {k: v[0] for k, v in batches[0].items()}
    grad_fn = engine.build_worker_grad(exp.loss)

    def functorch_grad():
        grad_and_value(exp.loss)({k: v.detach() for k, v in params.items()}, one)

    def autograd_grad():
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        torch.autograd.grad(exp.loss(leaves, one), list(leaves.values()))

    def forward():
        with torch.no_grad():
            exp.loss(params, one)

    print("one worker's gradient, cnnet batch 128, ms: grad_and_value %.2f, autograd.grad %.2f, forward %.2f, "
          "the submission (build_worker_grad) %.2f" % (
              wall_ms(torch, functorch_grad), wall_ms(torch, autograd_grad), wall_ms(torch, forward),
              wall_ms(torch, lambda: grad_fn(params, one, 1, 0, 0))))

    def bounded(lock):
        step = BoundedWaitStep(engine, exp.loss, tx, init)
        if not lock:
            step._dispatch_lock = contextlib.nullcontext()
        state = engine.init_state(init, tx, seed=1)
        rounds, arrivals = [], []
        try:
            for batch in batches:
                begin = time.monotonic()
                state, _ = step(state, batch)
                torch.cuda.synchronize()
                rounds.append((time.monotonic() - begin) * 1e3)
                arrivals.extend(step.last_arrivals * 1e3)
        finally:
            step.close()
        honest = sorted(arrivals[2 * n:])
        return rounds[2:], honest

    def fused():
        step, state, rounds = engine.build_step(exp.loss, tx), engine.init_state(init, tx, seed=1), []
        for batch in batches:
            begin = time.monotonic()
            state, _ = step(state, batch)
            torch.cuda.synchronize()
            rounds.append((time.monotonic() - begin) * 1e3)
        return rounds[2:]

    def sequential():
        state, rounds = engine.init_state(init, tx, seed=1), []
        for batch in batches:
            begin = time.monotonic()
            for w in range(n):
                grad_fn(params, {k: v[w] for k, v in batch.items()}, state.seed, state.step, w)
            torch.cuda.synchronize()
            rounds.append((time.monotonic() - begin) * 1e3)
        return rounds[2:]

    for lock in ([True, False, False, True] * args.pairs)[:2 * args.pairs]:
        rounds, honest = bounded(lock)
        print("synchronous round, %s: ms %s (median %.2f); arrivals p50 %.2f p95 %.2f ms" % (
            "one thread enqueues at a time" if lock else "eight threads enqueue at once",
            ", ".join("%.1f" % v for v in rounds), statistics.median(rounds), honest[len(honest) // 2],
            honest[int(0.95 * (len(honest) - 1))]))
    rounds = fused()
    print("fused step (one vmap): ms %s (median %.2f)" % (", ".join("%.1f" % v for v in rounds),
                                                        statistics.median(rounds)))
    rounds = sequential()
    print("eight submissions one after another, one thread: ms %s (median %.2f)" % (
        ", ".join("%.1f" % v for v in rounds), statistics.median(rounds)))


if __name__ == "__main__":
    main()
