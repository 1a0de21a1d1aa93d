"""Gradient flatten/inflate in the JAX package's coordinate order.

The GARs work on 1-D gradient vectors, one row per worker.  The JAX package
lays a row out in jax pytree leaf order (flax parameter dicts flatten with
sorted keys: ``conv1.bias, conv1.kernel, conv2..., norm1.bias, norm1.scale``)
with flax layouts (conv kernels HWIO, Dense kernels (in, out)).  Attacks,
Krum's selection and any comparison of aggregated vectors depend on that
order, so the port keeps it: ``FlatMap`` permutes torch-layout tensors (conv
weights OIHW, Linear weights (out, in)) into the JAX layout when it
flattens, and back when it inflates.

Naming bridge (also used by ``models.common.params_from_jax``): a torch
parameter ``<module>.weight`` of rank 4 is the flax ``<module>/kernel`` in
HWIO, of rank 2 the ``<module>/kernel`` in (in, out), of rank 1 a norm's
``<module>/scale``; ``<module>.bias`` is ``<module>/bias``.  A name with no
module (the transformer's ``wq``, ``embed``, ...) is a leaf of a plain JAX
dict, in the JAX layout already: its path is the name, with no permutation.
"""

import torch

#: torch -> JAX layout permutations of a ``weight`` by rank
_KERNEL_PERMS = {4: (2, 3, 1, 0), 2: (1, 0)}


def jax_leaf(name, ndim):
    """(jax path tuple, permutation torch -> JAX layout or None) of a torch
    parameter name such as ``conv1.weight``."""
    module, _, leaf = name.rpartition(".")
    if not module:
        return (name,), None
    path = tuple(module.split("."))
    if leaf == "bias":
        return path + ("bias",), None
    if leaf == "weight" and ndim in _KERNEL_PERMS:
        return path + ("kernel",), _KERNEL_PERMS[ndim]
    if leaf == "weight" and ndim == 1:
        return path + ("scale",), None
    raise ValueError("no JAX counterpart for parameter %r of rank %d" % (name, ndim))


def _inverse(perm):
    inv = [0] * len(perm)
    for i, p in enumerate(perm):
        inv[p] = i
    return tuple(inv)


class FlatMap:
    """Leaf layout of a parameter dict, in JAX flattening order.

    Attributes:
      slices: list of (torch name, jax path, offset, size, jax shape, perm)
              in flattening order; ``perm`` maps the torch layout to the JAX
              one (None when they agree).
      size:   total number of coordinates d.
    """

    def __init__(self, params):
        entries = []
        for name, tensor in params.items():
            path, perm = jax_leaf(name, tensor.dim())
            shape = tuple(tensor.shape[i] for i in perm) if perm else tuple(tensor.shape)
            entries.append((path, name, perm, shape, tensor.numel()))
        entries.sort(key=lambda entry: entry[0])
        self.slices = []
        offset = 0
        for path, name, perm, shape, size in entries:
            self.slices.append((name, "/".join(path), offset, size, shape, perm))
            offset += size
        self.size = offset

    def flatten_into(self, row, tensors):
        """Write the torch-layout ``tensors`` (name -> tensor) into the (d,)
        vector ``row`` in JAX order and layout; returns ``row``."""
        for name, _, offset, size, shape, perm in self.slices:
            value = tensors[name]
            row[offset:offset + size].view(shape).copy_(value.permute(perm) if perm else value)
        return row

    def flatten_rows(self, tensors, rows=None):
        """The n workers' torch-layout ``tensors`` (name -> (n, *shape)) as
        one float32 (n, d) matrix in JAX order and layout, one copy per leaf;
        row w equals ``flatten_into`` of worker w's leaves bit for bit.
        Writes into ``rows`` when given; returns the matrix."""
        first = next(iter(tensors.values()))
        n = first.shape[0]
        if rows is None:
            rows = torch.empty((n, self.size), dtype=torch.float32, device=first.device)
        for name, _, offset, size, shape, perm in self.slices:
            value = tensors[name]
            if perm:
                value = value.permute((0,) + tuple(axis + 1 for axis in perm))
            rows[:, offset:offset + size].unflatten(1, shape).copy_(value)
        return rows

    def flatten(self, tensors):
        """A fresh float32 (d,) vector of ``tensors`` in JAX order and layout."""
        first = next(iter(tensors.values()))
        row = torch.empty(self.size, dtype=torch.float32, device=first.device)
        return self.flatten_into(row, tensors)

    def inflate(self, flat):
        """Views of the (d,) vector ``flat`` as torch-layout tensors, by name."""
        out = {}
        for name, _, offset, size, shape, perm in self.slices:
            view = flat[offset:offset + size].view(shape)
            out[name] = view.permute(_inverse(perm)) if perm else view
        return out
