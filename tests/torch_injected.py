"""Injected gradient rows for the engine parity tests: a linear loss whose
gradient is each worker's given rows, over a flax model's parameter tree.

A rule's per-coordinate selections (Bulyan's averaged median, the
coordinate-wise rules) break near-ties by the float32 rounding of their
inputs.  A model's gradients round one way or another with the size of
torch's intra-op pool, whose reductions split with it, so a near-tie can
flip between pool sizes (ROADMAP trap ay: mnist Bulyan, a deviation gap of
4e-9 at step 2).  The rows a linear loss hands back are exact on both
engines at every pool size.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from aggregathor_tpu_torch.models.common import params_from_jax


def injected(init, n, steps, seed=6):
    """``(jax loss, port loss, [(jax batch, port batch)] * steps)`` for the
    flax tree ``init``: worker w's row of leaf i is a shared direction plus
    noise at scale (w + 1) / 2, so the rules' scores stand apart; the port's
    batch holds the same rows in its own layout (``params_from_jax``)."""
    leaves, treedef = jax.tree_util.tree_flatten(init)
    names = ["g%d" % i for i in range(len(leaves))]
    rng = np.random.default_rng(seed)
    scales = (np.arange(n) + 1.0) / 2.0
    batches = []
    for _ in range(steps):
        rows = []
        for leaf in leaves:
            shape = np.shape(leaf)
            noise = rng.normal(size=(n,) + shape) * scales.reshape((n,) + (1,) * len(shape))
            rows.append((rng.normal(size=shape) + noise).astype(np.float32))
        workers = [params_from_jax(jax.tree_util.tree_unflatten(treedef, [row[w] for row in rows])) for w in range(n)]
        port = {"g_" + name: np.stack([worker[name].numpy() for worker in workers]) for name in workers[0]}
        batches.append((dict(zip(names, rows)), port))

    def jax_loss(params, batch):
        return sum(jnp.sum(leaf * batch[name]) for name, leaf in zip(names, jax.tree_util.tree_leaves(params)))

    def port_loss(params, batch):
        return sum(torch.sum(params[name] * batch["g_" + name]) for name in sorted(params))

    return jax_loss, port_loss, batches
