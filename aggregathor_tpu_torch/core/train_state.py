"""The train state: one canonical copy of the parameters and its optimizer state.

Counterpart of ``aggregathor_tpu/core/train_state.py`` for the main path
and the lossy link's CLEVER carry; the other side buffers of the JAX state
(worker momentum, reputation, flight ring, error feedback) belong to
features this package does not port yet.  ``host_snapshot`` and
``load_snapshot`` take a state to the host and back, for checkpoints.
"""

import dataclasses


@dataclasses.dataclass
class TrainState:
    """Parameters (name -> tensor, torch layout), optimizer state, the number
    of completed steps, the run's seed (the per-step random streams are
    derived from ``(seed, step, worker, tag)``) and ``carry``: the (n, d) rows
    received last step, which a packet lost under ``clever:true`` keeps (None
    unless the engine carries them)."""

    params: dict
    opt_state: dict
    step: int = 0
    seed: int = 0
    carry: object = None


def _host_tree(tree):
    """A CPU copy of a (nested dict of) tensors; other leaves as they are.
    The copy is taken now: the optimizer updates the live tensors in place."""
    if isinstance(tree, dict):
        return {key: _host_tree(value) for key, value in tree.items()}
    if hasattr(tree, "detach"):
        return tree.detach().to("cpu", copy=True)
    return tree


def host_snapshot(state):
    """``{"step", "seed", "params", "opt_state"}`` with CPU copies of every
    tensor; the carry is left out (a transport buffer, not model state)."""
    return {"step": int(state.step), "seed": int(state.seed),
            "params": _host_tree(state.params), "opt_state": _host_tree(state.opt_state)}


def _load_tree(live, saved):
    """Copy ``saved`` into ``live`` in place (tensors) or by key (others)."""
    for key, value in saved.items():
        if isinstance(value, dict):
            _load_tree(live[key], value)
        elif hasattr(value, "detach"):
            live[key].copy_(value)
        else:
            live[key] = value


def load_snapshot(state, snapshot):
    """Load a ``host_snapshot`` into the live ``state`` on its device, in
    place; the carry stays as it is.  Returns ``state``."""
    import torch

    with torch.no_grad():
        _load_tree(state.params, snapshot["params"])
        _load_tree(state.opt_state, snapshot["opt_state"])
    state.step = int(snapshot["step"])
    state.seed = int(snapshot["seed"])
    return state
