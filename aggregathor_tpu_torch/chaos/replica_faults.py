"""Replica-parameter fault modes: the chaos regimes of the serving path.

Counterpart of ``aggregathor_tpu/chaos/replica_faults.py``.  Training chaos
corrupts per-worker gradients (``schedule.py``); serving chaos corrupts a
replica's parameters:

- ``nan``          a crashed or truncated replica: every parameter reads NaN;
- ``scale[=X]``    a corrupted replica: parameters multiplied by X (100);
- ``zero``         a wiped replica: all-zero parameters;
- ``noise[=S]``    a perturbed replica: Gaussian noise of S times each
  leaf's standard deviation added (0.1);
- ``stale``        an out-of-date replica, resolved by the caller to an
  earlier checkpoint (no transform here).

Spec grammar (``--poison-replica``)::

  SPEC := INDEX ":" MODE ("=" VALUE)?     e.g.  1:nan   2:scale=50   0:stale

``corrupt_params`` takes the port's parameter dict (name -> tensor, torch
layout) and draws its noise leaf by leaf in the JAX package's leaf order and
layout (``core.flatten.FlatMap``) from numpy's ``default_rng(seed)``, so a
replica corrupted here is the JAX package's replica, bit for bit.  Its
serving callers come with the serving plane.
"""

import numpy as np
import torch

from ..utils import UserException

#: modes that transform a parameter dict (stale is resolved by the caller)
PARAM_FAULTS = ("nan", "scale", "zero", "noise")

#: every accepted mode name
REPLICA_FAULTS = PARAM_FAULTS + ("stale",)

#: process-level fault keys of the schedule DSL (``kill=`` SIGKILLs the
#: named fleet instance at regime entry, ``hang=`` SIGSTOPs it); a
#: ``ChaosSchedule`` refuses them unless built with
#: ``allow_process_faults=True`` (the fleet plane)
PROCESS_FAULTS = ("kill", "hang")

_DEFAULTS = {"scale": 100.0, "noise": 0.1}


def parse_process_targets(key, value):
    """A process-fault target list -> tuple of instance names.  Grammar:
    ``NAME("+"NAME)*`` (``,`` already separates regime settings); the
    names are checked for shape only."""
    if key not in PROCESS_FAULTS:
        raise UserException("Unknown process fault %r (accepted: %s)" % (key, ", ".join(PROCESS_FAULTS)))
    targets = tuple(value.split("+"))
    for target in targets:
        if not target or target != target.strip():
            raise UserException("Chaos %s=%r: empty or padded instance name in target list "
                                "(expected NAME or NAME+NAME)" % (key, value))
        if any(c in target for c in ":,= "):
            raise UserException("Chaos %s=%r: instance name %r may not contain ':' ',' '=' or spaces"
                                % (key, value, target))
    if len(set(targets)) != len(targets):
        raise UserException("Chaos %s=%r names the same instance twice" % (key, value))
    return targets


def parse_poison(spec):
    """One ``INDEX:MODE[=VALUE]`` spec -> (index, mode, value); ``value`` is
    None for the modes without a knob (nan, zero, stale)."""
    if ":" not in spec:
        raise UserException("Poison spec %r: expected INDEX:MODE[=VALUE] (modes: %s)"
                            % (spec, ", ".join(REPLICA_FAULTS)))
    index_text, mode = spec.split(":", 1)
    try:
        index = int(index_text)
    except ValueError:
        raise UserException("Poison spec %r: replica index %r is not an integer" % (spec, index_text))
    if index < 0:
        raise UserException("Poison spec %r: replica index must be >= 0" % (spec,))
    value = None
    if "=" in mode:
        mode, value_text = mode.split("=", 1)
        try:
            value = float(value_text)
        except ValueError:
            raise UserException("Poison spec %r: value %r is not a number" % (spec, value_text))
    if mode not in REPLICA_FAULTS:
        raise UserException("Unknown replica fault %r (accepted: %s)" % (mode, ", ".join(REPLICA_FAULTS)))
    if value is not None and mode not in _DEFAULTS:
        raise UserException("Replica fault %r takes no value (got %r)" % (mode, value))
    if value is None:
        value = _DEFAULTS.get(mode)
    return index, mode, value


def corrupt_params(params, mode, value=None, seed=0):
    """A corrupted copy of a replica's parameters (name -> tensor, torch
    layout; the copy on the tensors' devices).  ``stale`` is a restore-time
    mode and is refused here."""
    from ..core.flatten import FlatMap

    if mode not in PARAM_FAULTS:
        raise UserException("corrupt_params handles %s; %r is resolved at restore time"
                            % ("/".join(PARAM_FAULTS), mode))
    if value is None:
        value = _DEFAULTS.get(mode)
    rng = np.random.default_rng(seed)
    out = {}
    for name, _, _, _, shape, perm in FlatMap(params).slices:  # the JAX leaf order
        tensor = params[name].detach()
        leaf = tensor.cpu().numpy()
        if perm:
            leaf = np.transpose(leaf, perm)  # the JAX layout, as the draws see it
        if mode == "nan":
            leaf = np.full_like(leaf, np.nan)
        elif mode == "zero":
            leaf = np.zeros_like(leaf)
        elif mode == "scale":
            leaf = leaf * np.asarray(value, leaf.dtype)
        else:  # noise
            sigma = float(np.std(leaf)) or 1.0
            leaf = leaf + rng.normal(0.0, float(value) * sigma, size=shape).astype(leaf.dtype)
        if perm:
            leaf = np.transpose(leaf, np.argsort(perm))
        out[name] = torch.from_numpy(np.ascontiguousarray(leaf)).to(tensor.device)
    return out
