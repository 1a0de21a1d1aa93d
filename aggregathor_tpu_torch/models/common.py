"""Shared pieces of the image models: initialization and the flax weight bridge.

``params_from_jax`` turns a flax parameter tree (given as numpy arrays, with
or without its top-level ``"params"`` key) into the port's parameter dict;
``params_to_jax`` is its inverse.  Names and layouts follow the bridge in
``core/flatten.py``: ``<module>/kernel`` HWIO <-> ``<module>.weight`` OIHW,
``<module>/kernel`` (in, out) <-> ``<module>.weight`` (out, in),
``<module>/scale`` <-> ``<module>.weight``, ``<module>/bias`` <-> ``<module>.bias``.
"""

import math

import numpy as np
import torch

from ..core.flatten import jax_leaf

#: the compute dtypes experiments accept (parameters always stay float32)
COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def check_dtype(name):
    """The torch dtype of a ``dtype:`` experiment arg, or a UserException
    (never a silent float32)."""
    from ..utils import UserException

    if name not in COMPUTE_DTYPES:
        raise UserException("Unknown dtype %r (accepted: %s)" % (name, ", ".join(sorted(COMPUTE_DTYPES))))
    return COMPUTE_DTYPES[name]


#: flax's default kernel init is lecun_normal: a normal truncated at two
#: standard deviations, rescaled so the variance is 1/fan_in
_TRUNCATED_STDDEV = 0.87962566103423978


def init_params(model, generator):
    """A fresh parameter dict for ``model``, drawn from ``generator`` the way
    flax initializes the JAX models (not the same numbers): kernels
    lecun-normal, biases zero, norm scales one."""
    params = {}
    for name, p in model.named_parameters():
        value = torch.empty(p.shape, dtype=torch.float32)
        path, _ = jax_leaf(name, p.dim())
        if path[-1] == "kernel":
            fan_in = p[0].numel()  # (out, in[, h, w]): everything but the output axis
            std = math.sqrt(1.0 / fan_in) / _TRUNCATED_STDDEV
            torch.nn.init.trunc_normal_(value, std=std, a=-2.0 * std, b=2.0 * std, generator=generator)
        elif path[-1] == "scale":
            value.fill_(1.0)
        else:
            value.zero_()
        params[name] = value
    return params


def _walk(tree, prefix=()):
    for key in sorted(tree):
        value = tree[key]
        if isinstance(value, dict) or hasattr(value, "items"):
            yield from _walk(dict(value), prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(value)


def params_from_jax(tree):
    """flax parameters (nested dict of numpy arrays) -> {torch name: tensor}."""
    tree = dict(tree)
    if set(tree) == {"params"}:
        tree = dict(tree["params"])
    params = {}
    for path, value in _walk(tree):
        module, leaf = ".".join(path[:-1]), path[-1]
        if leaf == "kernel" and value.ndim == 4:
            value = value.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        elif leaf == "kernel" and value.ndim == 2:
            value = value.T  # (in, out) -> (out, in)
        elif leaf not in ("scale", "bias"):
            raise ValueError("no torch counterpart for flax leaf %r" % "/".join(path))
        name = module + "." + ("bias" if leaf == "bias" else "weight")
        params[name] = torch.tensor(np.ascontiguousarray(value), dtype=torch.float32)
    return params


def params_to_jax(params):
    """{torch name: tensor} -> flax parameters {"params": nested numpy dict}."""
    tree = {}
    for name, tensor in params.items():
        path, perm = jax_leaf(name, tensor.dim())
        value = tensor.detach().cpu()
        value = value.permute(perm) if perm else value
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.ascontiguousarray(value.numpy())
    return {"params": tree}
