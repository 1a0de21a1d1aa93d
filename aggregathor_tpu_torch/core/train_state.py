"""The train state: one canonical copy of the parameters and its optimizer state.

Counterpart of ``aggregathor_tpu/core/train_state.py``.  Beside the
parameters ride the engine's side buffers, each present only when its
feature is on: the lossy link's CLEVER carry, the worker momentum and its
update count, the reputation EMA, the health probe's loss EMA and the
flight recorder's ring.  None of them is saved: ``host_snapshot`` takes
the step, the seed, the parameters and the optimizer state to the host,
and ``load_snapshot`` loads those back and resets the momentum, the
reputation, the loss EMA and the ring in place, as a restore from the JAX
package's fresh template does (the error-feedback buffer of the wire codec
is not ported).  ``broadcast_state`` hands the lead's parameters, optimizer
state, step and seed to every rank of a worker axis the same way.
"""

import dataclasses

import torch

from ..guardian.probe import EMA_UNSET


@dataclasses.dataclass
class TrainState:
    """Parameters (name -> tensor, torch layout), optimizer state, the number
    of completed steps, the run's seed (the per-step random streams are
    derived from ``(seed, step, worker, tag)``), and the side buffers:

    - ``carry``: the (n, d) rows received last step, which a packet lost
      under ``clever:true`` keeps;
    - ``momentum``: the (n, d) worker momenta, and ``momentum_steps`` the
      momentum updates since it was zeroed (its bias correction counts
      these, not ``step``, so it restarts with the buffer);
    - ``reputation``: the (n,) reputation EMA, 1.0 = trusted;
    - ``loss_ema``: the probe's 0-d EMA of |loss| (``EMA_UNSET`` = none yet);
    - ``flight``: the flight recorder's ring (lane name -> tensor).

    Each is None unless the engine's feature is on."""

    params: dict
    opt_state: dict
    step: int = 0
    seed: int = 0
    carry: object = None
    momentum: object = None
    momentum_steps: int = 0
    reputation: object = None
    loss_ema: object = None
    flight: object = None


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
    tensor; the side buffers are left out (none is model state)."""
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


def _reset_side_buffers(state):
    """Put the momentum, reputation, loss EMA and flight ring back to their
    initial values, in place: momentum zeroed with no update counted,
    everyone trusted, no EMA, every ring slot empty (integer lanes -1, float
    lanes NaN).  The carry stays as it is."""
    if state.momentum is not None:
        state.momentum.zero_()
    state.momentum_steps = 0
    if state.reputation is not None:
        state.reputation.fill_(1.0)
    if state.loss_ema is not None:
        state.loss_ema.fill_(EMA_UNSET)
    for lane in (state.flight or {}).values():
        lane.fill_(float("nan") if lane.is_floating_point() else -1)
    return state


def load_snapshot(state, snapshot):
    """Load a ``host_snapshot`` into the live ``state`` on its device, in
    place, and reset its side buffers (``_reset_side_buffers``).  Returns
    ``state``."""
    with torch.no_grad():
        _load_tree(state.params, snapshot["params"])
        _load_tree(state.opt_state, snapshot["opt_state"])
        _reset_side_buffers(state)
    state.step = int(snapshot["step"])
    state.seed = int(snapshot["seed"])
    return state


def _leaves(tree, prefix=""):
    """(dotted name, leaf) pairs of a nested dict, in sorted key order."""
    for key in sorted(tree):
        value = tree[key]
        if isinstance(value, dict):
            yield from _leaves(value, "%s%s/" % (prefix, key))
        else:
            yield prefix + str(key), value


def broadcast_state(state, axis):
    """The lead's parameters, optimizer state, step and seed on every rank
    of ``axis``, loaded in place (a rank's side buffers reset, as
    ``load_snapshot`` resets them): what a restore on the lead gives the
    other ranks.  Integer leaves (the optimizer's count) ride with the step
    and the seed.  A no-op at W = 1."""
    if axis.size == 1:
        return state
    with torch.no_grad():
        numbers = [int(state.step), int(state.seed)]
        slots = []
        for tree in (state.params, state.opt_state):
            for name, value in _leaves(tree):
                if isinstance(value, torch.Tensor):
                    value.copy_(axis.broadcast(value))
                else:
                    numbers.append(int(value))
                    slots.append((tree, name))
        received = axis.broadcast(torch.tensor(numbers, dtype=torch.int64, device=axis.device)).tolist()
        if axis.lead:
            return state
        state.step, state.seed = int(received[0]), int(received[1])
        for (tree, name), value in zip(slots, received[2:]):
            *path, leaf = name.split("/")
            for key in path:
                tree = tree[key]
            tree[leaf] = int(value)
        _reset_side_buffers(state)
    return state
