"""Rank targets of the port's multi-rank tests.

Spawned ranks re-import the module of their target, so it lives here and
imports only numpy, torch and the port, never jax or the JAX package (the
test files do).  ``run_cases(axis, cases)`` builds the port's engine on the
given worker axis for each case and steps it on the given global batches;
each rank keeps its k workers of them.  A case's ``chaos`` (a schedule
spec, with ``chaos_args``) is built here, on each rank, and its
``mask_secret`` masks the rule's groups (``secure.enable_masking``).
"""

import numpy as np
import torch

from aggregathor_tpu_torch import gars, models
from aggregathor_tpu_torch.chaos import ChaosSchedule
from aggregathor_tpu_torch.core import build_optimizer, build_schedule
from aggregathor_tpu_torch.parallel import RobustEngine, attacks
from aggregathor_tpu_torch.parallel.lossy import LossyLink


def _chaos(case):
    if not case.get("chaos"):
        return None
    return ChaosSchedule(case["chaos"], case["n"], nb_real_byz=case["r"], args=case.get("chaos_args", []))


def run_case(axis, case, weights, batches):
    """One case on ``axis``: per-step losses, worker metrics, chaos regimes
    and the final parameters (numpy), and the axis's rank."""
    axis = axis.with_workers(case["n"])
    torch.manual_seed(0)
    exp = models.instantiate(case["experiment"], case["exp_args"])
    n, f, r = case["n"], case["f"], case["r"]
    attack = attacks.instantiate(case["attack"], n, r) if case.get("attack") else None
    lossy = LossyLink(case["udp"], case["udp_args"]) if case.get("udp") else None
    tx = build_optimizer("sgd", build_schedule("fixed", ["initial-rate:%s" % case.get("lr", 0.05)]))
    gar = gars.instantiate(case["rule"], n, f)
    if case.get("mask_secret"):
        from aggregathor_tpu_torch.secure import GroupMasking, enable_masking

        enable_masking(gar, GroupMasking.from_secret(case["mask_secret"]))
    engine = RobustEngine(gar, n, nb_real_byz=r, attack=attack, lossy_link=lossy, worker_metrics=True, device="cpu",
                          axis=axis, chaos=_chaos(case), **case.get("options", {}))
    step = engine.build_step(exp.loss, tx)
    state = engine.init_state({name: torch.as_tensor(value) for name, value in weights.items()}, tx,
                              seed=case.get("seed", 1))
    out = {"rank": axis.rank, "loss": [], "participation": [], "worker_sq_dist": [], "worker_nan": [], "regime": [],
           "secure": []}
    for batch in batches:
        state, metrics = step(state, engine.put_batch(batch))
        if "secure" in metrics:
            out["secure"].append({name: value.numpy().copy() for name, value in metrics["secure"].items()})
        out["loss"].append(float(metrics["total_loss"]))
        out["regime"].append(int(metrics["chaos_regime"]) if "chaos_regime" in metrics else None)
        part = metrics.get("worker_participation")
        out["participation"].append(None if part is None else part.numpy().copy())
        out["worker_sq_dist"].append(metrics["worker_sq_dist"].numpy().copy())
        out["worker_nan"].append(metrics["probe"]["worker_nan_rows"].numpy().copy())
    out["params"] = {name: value.detach().numpy().copy() for name, value in state.params.items()}
    out["ef"] = None if state.ef is None else engine.gather_ef(state).numpy().copy()
    return out


def handshakes(axis, weights):
    """The bring-up handshake on this rank: equal secrets and parameters
    (returns W), rank 1 with a wrong secret, rank 1 with other parameters
    (each returns the UserException's message, or None)."""
    from aggregathor_tpu_torch.parallel.auth import authenticate_processes
    from aggregathor_tpu_torch.utils import UserException

    params = {name: torch.as_tensor(value) for name, value in weights.items()}
    out = {"equal": authenticate_processes(b"s3cret", params, axis=axis)}
    for name, secret, mine in (
            ("wrong_secret", b"wrong" if axis.rank == 1 else b"s3cret", params),
            ("diverged", b"s3cret", {k: v + float(axis.rank) for k, v in params.items()})):
        try:
            authenticate_processes(secret, mine, axis=axis)
            out[name] = None
        except UserException as exc:
            out[name] = str(exc)
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
                          axis=axis, chaos=_chaos(case), **case.get("options", {}))
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
    ef_rows = engine.gather_ef(state)  # every rank: a collective at W > 1
    if axis.lead:
        Checkpoints(directory, case.get("snapshot", "snap")).save(state, ef=ef_rows)
    return int(state.step)


def resume_from(axis, case, weights, batches, directory):
    """The lead restores the latest snapshot of ``directory``, every rank
    receives it, then steps through ``batches``."""
    from aggregathor_tpu_torch.core.train_state import broadcast_state
    from aggregathor_tpu_torch.obs.checkpoint import Checkpoints

    engine, exp, tx, state = _engine_and_state(axis, case, weights)
    step = engine.build_step(exp.loss, tx)
    if axis.lead:
        state, _ = Checkpoints(directory, case.get("snapshot", "snap"), nb_workers=case["n"]).restore(state)
    broadcast_state(state, axis)
    restored_ef = engine.gather_ef(state)
    restored_ef = None if restored_ef is None else restored_ef.numpy().copy()
    for batch in batches:
        state, _ = step(state, engine.put_batch(batch))
    ef = engine.gather_ef(state)
    return {"step": int(state.step), "params": {name: value.detach().numpy().copy()
                                                for name, value in state.params.items()},
            "restored_ef": restored_ef, "ef": None if ef is None else ef.numpy().copy()}


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


# --------------------------------------------------------------------------- #
# the (worker, pipe, model) grid: the transformer's collectives and the
# sharded engine (tests/test_torch_sharded_ranks.py)


def _cfg(kwargs):
    from aggregathor_tpu_torch.models import transformer as tfm

    return tfm.TransformerConfig(**kwargs)


def ring_check(grid, seed):
    """Ring attention over the model axis against the dense form on this
    rank's sequence block: the output and the gradients of a fixed
    projection of it (the ppermute's transpose); max abs errors."""
    from aggregathor_tpu_torch.models import transformer as tfm

    rng = np.random.default_rng(seed)
    q, k, v, w = (torch.tensor(rng.normal(size=(2, 16, 2, 8)), dtype=torch.float32) for _ in range(4))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    dense = tfm.ring_attention(*leaves, torch.arange(16), None)
    dgrads = torch.autograd.grad(torch.sum(dense * w), leaves)
    T, m = grid.model.size, grid.model.rank
    sb = 16 // T
    cut = slice(m * sb, (m + 1) * sb)
    blocks = [t[:, cut].clone().requires_grad_(True) for t in (q, k, v)]
    ringed = tfm.ring_attention(*blocks, m * sb + torch.arange(sb), grid.model)
    rgrads = torch.autograd.grad(torch.sum(ringed * w[:, cut]), blocks)
    errors = [float(torch.max(torch.abs(ringed - dense[:, cut])))]
    errors += [float(torch.max(torch.abs(a - b[:, cut]))) for a, b in zip(rgrads, dgrads)]
    return errors


def pipeline_check(grid, cfg_kwargs, weights, batch, microbatches):
    """The pipelined, sharded loss of this rank's blocks against the dense
    loss of the merged weights: (the submesh's summed partial losses, the
    dense loss, the largest relative gradient error over the leaves, each
    rank's gradient summed over its replication axes and held against the
    dense gradient's block)."""
    from aggregathor_tpu_torch.models import transformer as tfm
    from aggregathor_tpu_torch.parallel.engine import IN_GROUP_AXES

    cfg = _cfg(cfg_kwargs)
    specs = tfm.param_specs(cfg)
    pp = grid.shape["pipe"]
    glob = {name: torch.as_tensor(value) for name, value in weights.items()}
    engine = RobustEngine(gars.instantiate("average", grid.shape["worker"], 0), grid.shape["worker"],
                          sharding="sharded", mesh=grid, device="cpu")
    local = {name: engine._shard(value, specs[name]).clone().requires_grad_(True) for name, value in glob.items()}
    tb = {key: torch.as_tensor(value) for key, value in batch.items()}
    loss = tfm.make_pipeline_loss(cfg, pp, microbatches)(local, tb, grid)
    names = sorted(local)
    loss.backward()  # every collective's backward runs (parallel/collectives.py)
    grads = [local[name].grad for name in names]
    total = float(grid.psum(loss.detach(), IN_GROUP_AXES))
    merged = {name: value.clone().requires_grad_(True) for name, value in
              tfm.merge_stages(glob).items()}
    dense = tfm.loss_dense(merged, tb, cfg)
    dgrads = dict(zip(sorted(merged), torch.autograd.grad(dense, [merged[name] for name in sorted(merged)])))
    worst = 0.0
    for name, grad in zip(names, grads):
        grad = torch.zeros_like(local[name]) if grad is None else grad
        grad = grid.psum(grad, engine._replication_axes(specs[name]))
        want = dgrads[name]
        if name not in tfm.NON_STACKED_LEAVES:
            want = want.reshape(glob[name].shape)
        want = engine._shard(want, specs[name])
        worst = max(worst, float(torch.max(torch.abs(grad - want)) / torch.max(torch.abs(want))))
    return total, float(dense), worst


def sharded_steps(grid, case, weights, batches):
    """The sharded engine on ``grid`` from the global ``weights``: per-step
    losses, participations and the final global parameters (rank 0 only)."""
    from aggregathor_tpu_torch.models import transformer as tfm
    from aggregathor_tpu_torch.parallel import ShardedRobustEngine

    cfg = _cfg(case["cfg"])
    n = case["n"]
    tx = build_optimizer("sgd", build_schedule("fixed", ["initial-rate:%s" % case.get("lr", 0.1)]))
    engine = ShardedRobustEngine(grid, gars.instantiate(case["rule"], n, case["f"]), nb_workers=n,
                                 granularity=case["granularity"], worker_metrics=True, device="cpu")
    state = engine.init_state(lambda seed: {k: torch.as_tensor(v) for k, v in weights.items()},
                              tfm.param_specs(cfg), tx, seed=1)
    step = engine.build_step(tfm.make_pipeline_loss(cfg, grid.shape["pipe"], case.get("microbatches", 2)), tx)
    out = {"loss": [], "participation": []}
    for batch in batches:
        state, metrics = step(state, engine.put_batch(batch))
        out["loss"].append(float(metrics["total_loss"]))
        part = metrics.get("worker_participation")
        out["participation"].append(None if part is None else part.numpy().copy())
    snapshot = engine.global_state(state)
    if grid.rank != 0:
        return None
    out["params"] = {name: value.detach().numpy().copy() for name, value in snapshot.params.items()}
    return out


def grid_jobs(axis, grids):
    """For each ``(shape, jobs)`` of ``grids``, in order, the ``jobs``
    ((name, args) pairs of this module's grid targets) on a (W, PP, TP) grid
    over the spawned ranks: one spawn serves every grid shape of its world
    size (each ``make_mesh`` makes its own groups)."""
    from aggregathor_tpu_torch.parallel import mesh

    out = []
    for shape, jobs in grids:
        grid = mesh.make_mesh(shape[0], shape[2], shape[1], device="cpu")
        out.append([globals()[name](grid, *args) for name, args in jobs])
    return out


# --------------------------------------------------------------------------- #
# bounded-wait over the worker axis (tests/test_torch_bounded_ranks.py)


def injected_loss(params, batch):
    """The port's side of ``tests/torch_injected.py``'s linear loss: a
    worker's gradient is its batch's rows, exactly."""
    return sum(torch.sum(params[name] * batch["g_" + name]) for name in sorted(params))


class ChosenStragglers:
    """A straggler model both packages' ``BoundedWaitStep`` accept: from
    step ``start`` on, each worker of ``workers`` holds its submission
    ``stall`` seconds."""

    def __init__(self, workers, stall, start=1):
        self.workers, self.stall, self.start = frozenset(workers), float(stall), int(start)

    def delay(self, step, worker):
        return self.stall if step >= self.start and worker in self.workers else 0.0


def _gathered_rows(axis, tensor):
    """Every worker's (n, ...) rows of the ranks' (k, ...) ``tensor``."""
    if axis.size == 1:
        return tensor
    return axis.all_gather(tensor).reshape((axis.nb_workers,) + tuple(tensor.shape[1:]))


def bounded_case(axis, case, weights, batches, journal=None):
    """One bounded-wait run of ``case`` on ``axis``: ``BoundedWaitStep`` over
    the port's engine and the injected loss from ``weights`` (numpy), each
    rank keeping its k workers of the global ``batches``.  Returns, per
    round, the masks, counts, coefficients, loss, participation, NaN rows,
    digests, the window and the gathered arrivals; the parameters, every
    worker's momentum and residual rows, the registry's snapshot, the
    recorded wire payloads ``{(step, worker): ...}`` of this rank's workers;
    the lead writes its journal to ``journal``.  The engine runs on the
    axis's device.  Under ``case["fail"]`` = (step, worker) that submission
    raises, and the run returns the rank's error message instead."""
    from aggregathor_tpu_torch.obs import events
    from aggregathor_tpu_torch.obs.metrics import MetricsRegistry
    from aggregathor_tpu_torch.parallel.bounded import BoundedWaitStep
    from aggregathor_tpu_torch.parallel.deadline import DeadlineController

    n, f = case["n"], case["f"]
    axis = axis.with_workers(n)
    tx = build_optimizer("sgd", build_schedule("fixed", ["initial-rate:%s" % case.get("lr", 0.05)]))
    # the axis's device (the CPU, or a card) is the engine's
    engine = RobustEngine(gars.instantiate(case["rule"], n, f), n, axis=axis,
                          **case.get("options", {}))
    params = {name: torch.as_tensor(value) for name, value in weights.items()}
    model = ChosenStragglers(case["stragglers"], case.get("stall", 30.0), case.get("stall_from", 1)) \
        if case.get("stragglers") else None
    controller = DeadlineController(**case["controller"]) if case.get("controller") else None
    topology = None
    if case.get("topology"):
        from aggregathor_tpu_torch.topology import TreeAggregator, parse_topology_spec

        spec, schedule = case["topology"]
        topology = TreeAggregator(parse_topology_spec(spec, n, f))
        topology.schedule = ChaosSchedule(schedule, n, allow_topology_faults=True)
    registry = MetricsRegistry()
    if journal is not None and axis.lead:
        events.install(journal, run_id="bounded")
    loss = injected_loss
    if case.get("l2"):
        from aggregathor_tpu_torch.cli.runner import make_regularized_loss

        loss = make_regularized_loss(loss, None, case["l2"])
    step = BoundedWaitStep(engine, loss, tx, params, straggler_model=model, controller=controller,
                           topology=topology, registry=registry, **case.get("step", {}))
    payloads = {}
    original = step.grad_fn
    fail = case.get("fail")  # (step, worker): that submission raises

    def recording(*args, **kwargs):
        if fail is not None and (int(args[3]), int(args[4])) == tuple(fail):
            raise ValueError("injected submission failure")
        out = original(*args, **kwargs)
        row = out["row"]
        payloads[int(args[3]), int(args[4])] = ({key: value.cpu().numpy() for key, value in row.items()}
                                                if isinstance(row, dict) else row.cpu().numpy())
        return out

    step.grad_fn = recording
    out = {"rank": axis.rank, "rounds": []}
    try:
        state = engine.init_state(params, tx, seed=1)
        for batch in batches:
            try:
                state, metrics = step(state, engine.put_batch(batch))
            except RuntimeError as exc:
                if fail is None:
                    raise
                out["error"] = str(exc)  # every rank raises after the round's gather
                return out
            got = {key: metrics[key].cpu().numpy() for key in
                   ("straggler_timeout", "stale_infill", "nb_timeouts", "nb_stale", "total_loss",
                    "stale_reweight_coeff", "worker_participation") if key in metrics}
            got["worker_nan"] = metrics["probe"]["worker_nan_rows"].cpu().numpy()
            if "secure" in metrics:
                got["secure"] = {name: value.cpu().numpy() for name, value in metrics["secure"].items()}
            got["arrivals"] = step.last_arrivals.copy()
            got["window"] = None if controller is None else controller.window
            got["gather_s"] = step.last_gather_s
            out["rounds"].append(got)
    finally:
        step.close()
        if journal is not None and axis.lead:
            events.uninstall()
    out["params"] = {name: value.detach().cpu().numpy() for name, value in state.params.items()}
    out["momentum"] = None if state.momentum is None else _gathered_rows(axis, state.momentum).cpu().numpy()
    out["ef"] = None if state.ef is None else engine.gather_ef(state).cpu().numpy()
    out["timeouts_total"] = step.timeouts_total.copy()
    out["stale_total"] = step.stale_total.copy()
    out["registry"] = registry.snapshot()
    out["payloads"] = payloads
    return out


def bounded_cases(axis, cases, journal_dir=None):
    """Every ``(id, case, weights, batches)`` of ``cases`` on this rank, the
    lead's journals in ``journal_dir`` (``<id>-W<size>.jsonl``)."""
    import os

    return {name: bounded_case(axis, case, weights, batches,
                               None if journal_dir is None else os.path.join(journal_dir, "%s-W%d.jsonl"
                                                                             % (name, axis.size)))
            for name, case, weights, batches in cases}


# --------------------------------------------------------------------------- #
# bounded-wait on the sharded engine (tests/test_torch_sharded_bounded.py)


def sharded_injected_loss(specs):
    """The sharded engine's local partial of ``injected_loss``: a rank's
    blocks against its blocks of a worker's whole rows, each leaf scaled by
    1/(its replication), so the submesh's sum is the linear loss and each
    completed gradient block is the rows' block."""

    def block(value, spec, grid):
        for dim, name in enumerate(spec):
            if name is not None:
                axis = grid.axis(name)
                size = value.shape[dim] // axis.size
                value = value.narrow(dim, axis.rank * size, size)
        return value

    def loss(params, batch, grid):
        total = 0.0
        for name in sorted(params):
            spec = tuple(specs[name])
            scale = 1.0
            for axis in ("pipe", "model"):
                if axis not in spec:
                    scale /= grid.shape[axis]
            total = total + scale * torch.sum(params[name] * block(batch["g_" + name], spec, grid))
        return total

    return loss


def sharded_bounded_case(grid, case, weights, batches, journal=None):
    """One bounded-wait run of ``case`` on the sharded engine over ``grid``
    (granularity global), the injected transformer rows of ``batches``
    (global, each rank keeping its unit's k workers), from the global
    ``weights``: per round the masks, counts, coefficients, loss, the
    gathered arrivals and the window; the global parameters (rank 0); the
    lead writes its journal to ``journal``."""
    from aggregathor_tpu_torch.models import transformer as tfm
    from aggregathor_tpu_torch.obs import events
    from aggregathor_tpu_torch.obs.metrics import MetricsRegistry
    from aggregathor_tpu_torch.parallel.bounded import BoundedWaitStep
    from aggregathor_tpu_torch.parallel.deadline import DeadlineController

    n, f = case["n"], case["f"]
    specs = tfm.param_specs(tfm.TransformerConfig(**case["cfg"]))
    tx = build_optimizer("sgd", build_schedule("fixed", ["initial-rate:%s" % case.get("lr", 0.05)]))
    engine = RobustEngine(gars.instantiate(case["rule"], n, f), n, sharding="sharded", mesh=grid,
                          granularity="global", device=grid.device, **case.get("options", {}))
    params = {name: torch.as_tensor(value) for name, value in weights.items()}
    model = ChosenStragglers(case["stragglers"], case.get("stall", 30.0)) if case.get("stragglers") else None
    controller = DeadlineController(**case["controller"]) if case.get("controller") else None
    registry = MetricsRegistry()
    lead = grid.rank == 0
    if journal is not None and lead:
        events.install(journal, run_id="sharded-bounded")
    state = engine.init_state(lambda seed: params, specs, tx, seed=1)
    loss = sharded_injected_loss(specs)
    if case.get("l2"):
        # each leaf's term scaled by 1/(its replication): the submesh's sum
        # counts it once
        from aggregathor_tpu_torch.cli.runner import make_regularized_loss

        loss = make_regularized_loss(loss, None, case["l2"], sharded=engine)
    step = BoundedWaitStep(engine, loss, tx, params, straggler_model=model, controller=controller,
                           registry=registry, **case.get("step", {}))
    out = {"rank": grid.rank, "rounds": [], "nb_units": step.nb_units, "group_size": step.group_size}
    try:
        for batch in batches:
            state, metrics = step(state, engine.put_batch(batch))
            got = {key: metrics[key].cpu().numpy() for key in
                   ("straggler_timeout", "stale_infill", "nb_timeouts", "nb_stale", "total_loss",
                    "stale_reweight_coeff", "worker_participation") if key in metrics}
            got["worker_nan"] = metrics["probe"]["worker_nan_rows"].cpu().numpy()
            if "secure" in metrics:
                got["secure"] = {name: value.cpu().numpy() for name, value in metrics["secure"].items()}
            got["arrivals"] = step.last_arrivals.copy()
            got["window"] = None if controller is None else controller.window
            out["rounds"].append(got)
    finally:
        step.close()
        if journal is not None and lead:
            events.uninstall()
    snapshot = engine.global_state(state)  # every rank: a collective over the submesh
    out["params"] = {name: value.detach().cpu().numpy() for name, value in snapshot.params.items()}
    out["local"] = {name: value.detach().cpu().numpy() for name, value in state.params.items()}
    out["timeouts_total"] = step.timeouts_total.copy()
    out["registry"] = registry.snapshot()
    return out


def sharded_bounded_cases(axis, grids, journal_dir=None):
    """For each ``(shape, cases)`` of ``grids``, in order, every ``(id,
    case, weights, batches)`` of ``cases`` on a (W, PP, TP) grid over the
    spawned ranks, the lead's journals in ``journal_dir``
    (``<id>-<W>x<PP>x<TP>.jsonl``)."""
    import os

    from aggregathor_tpu_torch.parallel import mesh

    out = {}
    for shape, cases in grids:
        grid = mesh.make_mesh(shape[0], shape[2], shape[1], device=axis.device)
        tag = "x".join(str(v) for v in shape)
        out[tag] = {name: sharded_bounded_case(grid, case, weights, batches, None if journal_dir is None else
                                               os.path.join(journal_dir, "%s-%s.jsonl" % (name, tag)))
                    for name, case, weights, batches in cases}
    return out
