"""Rank targets of the port's multi-rank tests.

Spawned ranks re-import the module of their target, so it lives here and
imports only numpy, torch and the port, never jax or the JAX package (the
test files do).  ``run_cases(axis, cases)`` builds the port's engine on the
given worker axis for each case and steps it on the given global batches;
each rank keeps its k workers of them.
"""

import numpy as np
import torch

from aggregathor_tpu_torch import gars, models
from aggregathor_tpu_torch.core import build_optimizer, build_schedule
from aggregathor_tpu_torch.parallel import RobustEngine, attacks
from aggregathor_tpu_torch.parallel.lossy import LossyLink


def run_case(axis, case, weights, batches):
    """One case on ``axis``: per-step losses, worker metrics and the final
    parameters (numpy), and the axis's rank."""
    axis = axis.with_workers(case["n"])
    torch.manual_seed(0)
    exp = models.instantiate(case["experiment"], case["exp_args"])
    n, f, r = case["n"], case["f"], case["r"]
    attack = attacks.instantiate(case["attack"], n, r) if case.get("attack") else None
    lossy = LossyLink(case["udp"], case["udp_args"]) if case.get("udp") else None
    tx = build_optimizer("sgd", build_schedule("fixed", ["initial-rate:%s" % case.get("lr", 0.05)]))
    engine = RobustEngine(gars.instantiate(case["rule"], n, f), n, nb_real_byz=r, attack=attack, lossy_link=lossy,
                          worker_metrics=True, device="cpu", axis=axis, **case.get("options", {}))
    step = engine.build_step(exp.loss, tx)
    state = engine.init_state({name: torch.as_tensor(value) for name, value in weights.items()}, tx,
                              seed=case.get("seed", 1))
    out = {"rank": axis.rank, "loss": [], "participation": [], "worker_sq_dist": [], "worker_nan": []}
    for batch in batches:
        state, metrics = step(state, engine.put_batch(batch))
        out["loss"].append(float(metrics["total_loss"]))
        part = metrics.get("worker_participation")
        out["participation"].append(None if part is None else part.numpy().copy())
        out["worker_sq_dist"].append(metrics["worker_sq_dist"].numpy().copy())
        out["worker_nan"].append(metrics["probe"]["worker_nan_rows"].numpy().copy())
    out["params"] = {name: value.detach().numpy().copy() for name, value in state.params.items()}
    return out


def run_cases(axis, cases):
    """Every ``(case, weights, batches)`` of ``cases`` on this rank."""
    return [run_case(axis, *case) for case in cases]


def run_jobs(axis, jobs):
    """Every ``(function name, args)`` of ``jobs``, in order, on this rank:
    one spawn serves several checks."""
    return [globals()[name](axis, *args) for name, args in jobs]


def flat(params):
    return np.concatenate([np.ravel(params[name]) for name in sorted(params)])


def probe_blocks(axis, rule, n, f, d):
    """``(this rank's GAR-probe aggregate block, gathered test tensors)``:
    the probe at (n, d) on the axis, and a bf16, a bool and an all_to_all
    exchange of known values (W = 2)."""
    engine = RobustEngine(gars.instantiate(rule, n, f), n, device="cpu", axis=axis)
    agg = engine.build_gar_probe(d, seed=0)(0).numpy().copy()
    if axis.size == 1:
        return agg, None
    r = float(axis.rank)
    gathered = {
        "bf16": axis.all_gather(torch.tensor([0.5 + r, -1.5 - r], dtype=torch.bfloat16)).float().numpy(),
        "bool": axis.all_gather(torch.tensor([axis.rank == 0, axis.rank == 1])).numpy(),
        # piece i of rank j reaches rank i, in rank order
        "a2a": axis.all_to_all(torch.tensor([[10.0 * r], [10.0 * r + 1]])).reshape(-1).numpy(),
    }
    return agg, gathered


def _engine_and_state(axis, case, weights):
    exp = models.instantiate(case["experiment"], case["exp_args"])
    n, f, r = case["n"], case["f"], case["r"]
    attack = attacks.instantiate(case["attack"], n, r) if case.get("attack") else None
    tx = build_optimizer("sgd", build_schedule("fixed", ["initial-rate:%s" % case.get("lr", 0.05)]))
    engine = RobustEngine(gars.instantiate(case["rule"], n, f), n, nb_real_byz=r, attack=attack, device="cpu",
                          axis=axis)
    state = engine.init_state({name: torch.as_tensor(value) for name, value in weights.items()}, tx,
                              seed=case.get("seed", 1))
    return engine, exp, tx, state


def save_after(axis, case, weights, batches, directory):
    """Step through ``batches``; the lead snapshots the state into ``directory``."""
    from aggregathor_tpu_torch.obs.checkpoint import Checkpoints

    engine, exp, tx, state = _engine_and_state(axis, case, weights)
    step = engine.build_step(exp.loss, tx)
    for batch in batches:
        state, _ = step(state, engine.put_batch(batch))
    if axis.lead:
        Checkpoints(directory, "snap").save(state)
    return int(state.step)


def resume_from(axis, case, weights, batches, directory):
    """The lead restores the latest snapshot of ``directory``, every rank
    receives it, then steps through ``batches``."""
    from aggregathor_tpu_torch.core.train_state import broadcast_state
    from aggregathor_tpu_torch.obs.checkpoint import Checkpoints

    engine, exp, tx, state = _engine_and_state(axis, case, weights)
    step = engine.build_step(exp.loss, tx)
    if axis.lead:
        state, _ = Checkpoints(directory, "snap").restore(state)
    broadcast_state(state, axis)
    for batch in batches:
        state, _ = step(state, engine.put_batch(batch))
    return {"step": int(state.step), "params": {name: value.detach().numpy().copy()
                                                for name, value in state.params.items()}}


def run_sampled(axis, case, weights, steps):
    """``steps`` steps of the engine's device-sampled trainer (each worker's
    batch drawn from its (seed, step, w, 4) stream out of the resident train
    split), in two calls; returns the per-step losses and the parameters."""
    engine, exp, tx, state = _engine_and_state(axis, case, weights)
    multi = engine.build_sampled_multi_step(exp.loss, tx, steps // 2, exp.batch_size)
    data = engine.replicate(exp.train_arrays())
    losses = []
    for _ in range(2):
        state, many = multi(state, data)
        losses.extend(float(v) for v in many["total_loss"])
    return {"loss": losses, "params": {name: value.detach().numpy().copy() for name, value in state.params.items()}}
