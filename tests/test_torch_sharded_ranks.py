"""The port's grid over spawned gloo ranks on the CPU against the dense
forms and the JAX package's sharded engine (its 8-device virtual mesh).

One spawn of four ranks serves both grid shapes.  The module's fixture
starts it on a thread beside two threads for the JAX references, so they
compile while the ranks run (JAX's compile, seconds a case at a 4-device
mesh, is the file's cost; the ranks' jobs take about as long together).

- (1, 2, 2): ring attention at T = 2 equals the dense attention, output
  and gradients (the ring's transpose) within 1e-5; the pipelined loss of
  two stages x two model shards equals the dense loss of the merged
  weights (rtol 1e-5) and each rank's replication-summed gradient block
  the dense gradient's (1e-4 of the leaf's largest entry); one sharded
  step of a switch-MoE model (median, layer) equals JAX's sharded engine at
  the same mesh (rtol 1e-4: MoE capacity and the aux loss are per shard,
  so only equal meshes compare);
- (2, 2, 1): ``average`` under ``global`` equals manual SGD on the dense
  per-worker gradients (rtol 5e-4, JAX ``tests/test_transformer.py:94-120``);
- krum under layer, leaf and global on the dense model at both grids, the
  worker metrics on, two steps equal JAX's sharded engine at the same mesh:
  the selections identical (the participation within 1e-6: at (1, 2, 2) the
  distances and the participation are summed over the model axis), the
  parameters within rtol 1e-4.
"""

import concurrent.futures
import functools

import jax
import numpy as np
import pytest
import torch

from aggregathor_tpu import gars as jgars
from aggregathor_tpu.core import build_optimizer as jax_optimizer
from aggregathor_tpu.core import build_schedule as jax_schedule
from aggregathor_tpu.models import transformer as jtfm
from aggregathor_tpu.parallel import ShardedRobustEngine as JaxSharded
from aggregathor_tpu.parallel import make_mesh as jax_mesh
from aggregathor_tpu_torch.models import transformer as tfm
from aggregathor_tpu_torch.models.common import params_from_jax
from aggregathor_tpu_torch.parallel import mesh

import torch_rank_cases as cases_module

from torch_threads import pinned_threads  # noqa: F401  (a fixture: the xdist worker's intra-op pool)

DENSE = dict(vocab_size=17, d_model=16, n_heads=2, n_layers=2)
MOE = dict(vocab_size=17, d_model=16, n_heads=2, n_layers=2, n_experts=4)
GRANULARITIES = ("layer", "leaf", "global")


def _batches(n, steps, seed, bsz=2, seq=8):
    rng = np.random.default_rng(seed)
    return [{"tokens": rng.integers(0, 17, size=(n, bsz, seq)).astype(np.int32),
             "targets": rng.integers(0, 17, size=(n, bsz, seq)).astype(np.int32)} for _ in range(steps)]


def _weights(cfg_kwargs, n_stages, seed):
    """Stage-stacked weights in JAX's layout, from the port's own draws
    (``tests/test_torch_transformer.py`` holds their shapes to JAX's)."""
    cfg = tfm.TransformerConfig(**cfg_kwargs)
    return {k: v.numpy() for k, v in tfm.init_params(cfg, torch.Generator().manual_seed(seed), n_stages=n_stages).items()}


def _krum(granularity):
    return {"cfg": DENSE, "n": 6, "f": 1, "rule": "krum", "granularity": granularity}


@functools.lru_cache(maxsize=None)
def _inputs():
    """The weights and batches of both grids, drawn once (not at
    collection, which every test worker runs)."""
    dense, moe, w221 = _weights(DENSE, 2, 3), _weights(MOE, 2, 4), _weights(DENSE, 2, 6)
    batches221 = _batches(6, 2, 12)
    return dict(dense=dense, moe=moe, batch={k: v[0] for k, v in _batches(1, 1, 9)[0].items()},
                moe_batches=_batches(4, 1, 11), krum_batches=_batches(6, 2, 13), w221=w221,
                batches221=batches221, two221=[{k: v[:2] for k, v in batches221[0].items()}])


def _grids():
    x = _inputs()
    moe_case = {"cfg": MOE, "n": 4, "f": 1, "rule": "median", "granularity": "layer"}
    average = {"cfg": DENSE, "n": 2, "f": 0, "rule": "average", "granularity": "global"}
    return [
        ((1, 2, 2), [("ring_check", (5,)), ("pipeline_check", (DENSE, x["dense"], x["batch"], 2)),
                     ("sharded_steps", (moe_case, x["moe"], x["moe_batches"]))]
         + [("sharded_steps", (_krum(g), x["dense"], x["krum_batches"])) for g in GRANULARITIES]),
        ((2, 2, 1), [("sharded_steps", (average, x["w221"], x["two221"]))]
         + [("sharded_steps", (_krum(g), x["w221"], x["batches221"])) for g in GRANULARITIES]),
    ]


def _jax_run(shape, cfg_kwargs, rule, n, f, granularity, weights, batches):
    W, PP, TP = shape
    cfg = jtfm.TransformerConfig(**cfg_kwargs)
    tx = jax_optimizer("sgd", jax_schedule("fixed", ["initial-rate:0.1"]))
    engine = JaxSharded(jax_mesh(nb_workers=W, model_parallelism=TP, pipeline_parallelism=PP),
                        jgars.instantiate(rule, n, f), nb_workers=n, granularity=granularity, worker_metrics=True)
    state = engine.init_state(lambda key: weights, jtfm.param_specs(cfg), tx, seed=1)
    step = engine.build_step(jtfm.make_pipeline_loss(cfg, PP, 2), tx, state)
    out = {"loss": [], "participation": []}
    for batch in batches:
        state, metrics = step(state, engine.shard_batch(batch))
        out["loss"].append(float(metrics["total_loss"]))
        part = metrics.get("worker_participation")
        out["participation"].append(None if part is None else np.asarray(part))
    out["params"] = {k: np.asarray(v) for k, v in jax.device_get(state.params).items()}
    return out


def _references():
    """JAX's runs, by name: the MoE step and krum at each (grid, granularity)."""
    x = _inputs()
    out = {"moe": ((1, 2, 2), MOE, "median", 4, 1, "layer", x["moe"], x["moe_batches"])}
    for g in GRANULARITIES:
        out[(1, 2, 2), g] = ((1, 2, 2), DENSE, "krum", 6, 1, g, x["dense"], x["krum_batches"])
        out[(2, 2, 1), g] = ((2, 2, 1), DENSE, "krum", 6, 1, g, x["w221"], x["batches221"])
    return out


@pytest.fixture(scope="module")
def runs():
    """``(ranks, references)``: the spawn's results (rank-major, then grid,
    then job) and JAX's runs, futures on threads: the spawn's, and two for
    the references (a third adds nothing: JAX traces under the GIL)."""
    cases = _references()
    pool = concurrent.futures.ThreadPoolExecutor(3)
    ranks = pool.submit(mesh.spawn, cases_module.grid_jobs, 4, 4, (_grids(),), device="cpu")
    references = {name: pool.submit(_jax_run, *args) for name, args in cases.items()}
    yield ranks, references
    pool.shutdown(wait=True)


def _check_run(got, want, label):
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4, err_msg=label)
    for a, b in zip(got["participation"], want["participation"]):
        if b is not None:
            np.testing.assert_allclose(a, b, atol=1e-6, err_msg=label)
    for name, value in want["params"].items():
        np.testing.assert_allclose(got["params"][name], value, rtol=1e-4, atol=1e-6 * np.abs(value).max(),
                                   err_msg="%s %s" % (label, name))


def test_grid_1_2_2_ring_pipeline_and_moe_step_match(runs):
    ranks, references = runs
    results = [per_rank[0] for per_rank in ranks.result()]
    for ring, (total, dense, worst), *_ in results:
        assert max(ring) < 1e-5, ring
        np.testing.assert_allclose(total, dense, rtol=1e-5)
        assert worst < 1e-4, worst
    _check_run(results[0][2], references["moe"].result(), "moe median layer")


def test_grid_2_2_1_average_manual_sgd_and_krum_match(runs):
    ranks, references = runs
    x = _inputs()
    got_average, *got_krum = ranks.result()[0][1]
    # the oracle: the dense per-worker gradients, averaged, one SGD step
    cfg = tfm.TransformerConfig(**DENSE)
    merged = tfm.merge_stages(params_from_jax(x["w221"]))
    grads = []
    for i in range(2):
        leaves = {k: v.clone().requires_grad_(True) for k, v in merged.items()}
        loss = tfm.loss_dense(leaves, {k: torch.as_tensor(v[i]) for k, v in x["two221"][0].items()}, cfg)
        grads.append(dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values())))))
    got = tfm.merge_stages({k: torch.as_tensor(v) for k, v in got_average["params"].items()})
    for name, value in merged.items():
        expect = value - 0.1 * (grads[0][name] + grads[1][name]) / 2
        np.testing.assert_allclose(got[name].numpy(), expect.numpy(), rtol=5e-4, atol=1e-5, err_msg=name)
    for g, run in zip(GRANULARITIES, got_krum):
        if g != "leaf":  # leaf: test_grid_krum_matches_jax
            _check_run(run, references[(2, 2, 1), g].result(), "krum " + g)


@pytest.mark.parametrize("grid,granularity", [((1, 2, 2), g) for g in GRANULARITIES] + [((2, 2, 1), "leaf")],
                         ids=["1-2-2-layer", "1-2-2-leaf", "1-2-2-global", "2-2-1-leaf"])
def test_grid_krum_matches_jax(runs, grid, granularity):
    ranks, references = runs
    index = {(1, 2, 2): 0, (2, 2, 1): 1}[grid]
    first = {(1, 2, 2): 3, (2, 2, 1): 1}[grid]  # the grid's first krum job
    got = ranks.result()[0][index][first + GRANULARITIES.index(granularity)]
    _check_run(got, references[grid, granularity].result(), "krum %s at %s" % (granularity, grid))
