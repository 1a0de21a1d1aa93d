"""Differentiable collectives over one axis of the (worker, pipe, model) grid.

Counterpart of the ``jax.lax`` collectives the JAX transformer calls inside
``shard_map`` (``models/transformer.py``): JAX differentiates them through
their transposes; here each is a ``torch.autograd.Function`` whose backward
is that transpose, over a ``parallel.mesh.WorkerAxis`` (its group, its
size T and this process's index in it):

- ``ppermute(x, axis, shift)``: rank i's ``x`` lands on rank (i + shift)
  mod T (``lax.ppermute`` on a ring); the transpose is the inverse ring
  (shift -> -shift).  Both directions are one ``dist.batch_isend_irecv`` of
  a send and a receive, so no rank waits on a peer that waits on it.
- ``all_gather_tiled(x, axis, dim)``: the T blocks joined along ``dim``
  (``lax.all_gather(tiled=True)``); the transpose is the reduce-scatter
  of the sum.
- ``psum_scatter_tiled(x, axis, dim)``: the sum over the ranks, rank i
  keeping block i along ``dim`` (``lax.psum_scatter(tiled=True)``); the
  transpose is the tiled all-gather.
- ``all_to_all(x, axis)``: block i of the leading (T, ...) dim goes to rank
  i (``lax.all_to_all`` with split = concat = 0, tiled); the transpose is
  the same exchange, which is its own inverse.

gloo has no reduce-scatter, so the reduce-scatter (the forward of
``psum_scatter_tiled``, the backward of ``all_gather_tiled``) is an
``all_reduce`` of the whole tensor followed by this rank's slice, on every
backend.  At T = 1 (or ``axis`` None) each is the identity and no
collective runs, as JAX's size-1 axes.

Autograd runs a collective's backward only when the collective's output
reaches the loss.  Every rank of the group must run it all the same (its
peers wait on it), so an output that a rank does not use (a GPipe stage's
activation that no later tick reads) is tied to the loss with ``anchor``,
whose backward hands it a zero cotangent, as the transpose of JAX's scan
hands the discarded values.  An input that does not require a gradient (a
pipeline bubble's zeros) is made a leaf that does, so that every rank
builds a backward node for every collective.  Differentiate with
``loss.backward()``: ``torch.autograd.grad(loss, inputs)`` skips the
backward nodes that lead to none of ``inputs``, and a bubble's collective
is such a node on one rank and not on its peer.  On one rank the backward
nodes run in reverse order of their creation (the autograd engine's ready
queue is ordered by sequence number), and every rank creates them in the
same order, so the ranks meet in the same order in the backward pass too.
"""

import torch


def _tracked(x):
    """``x``, or under autograd a leaf copy of it that requires a gradient,
    so that the collective gets a backward node on every rank."""
    if torch.is_grad_enabled() and not x.requires_grad:
        return x.detach().requires_grad_(True)
    return x


def _active(axis):
    return axis is not None and axis.size > 1


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, shift):
        ctx.axis, ctx.shift = axis, shift
        return axis.ppermute(x, shift)

    @staticmethod
    def backward(ctx, grad):
        return ctx.axis.ppermute(grad, -ctx.shift), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim, ctx.block = axis, dim, x.shape[dim]
        return torch.cat(axis.all_gather(x).unbind(0), dim=dim)

    @staticmethod
    def backward(ctx, grad):
        summed = ctx.axis.all_reduce_sum(grad)
        return summed.narrow(ctx.dim, ctx.axis.rank * ctx.block, ctx.block).contiguous(), None, None


class _PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        block = x.shape[dim] // axis.size
        return axis.all_reduce_sum(x).narrow(dim, axis.rank * block, block).contiguous()

    @staticmethod
    def backward(ctx, grad):
        return torch.cat(ctx.axis.all_gather(grad).unbind(0), dim=ctx.dim), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return axis.all_to_all(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.axis.all_to_all(grad), None


class _Anchor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, value, *dangling):
        ctx.shapes = [(t.shape, t.dtype, t.device) for t in dangling]
        return value.clone()

    @staticmethod
    def backward(ctx, grad):
        return (grad,) + tuple(torch.zeros(shape, dtype=dtype, device=device) for shape, dtype, device in ctx.shapes)


def ppermute(x, axis, shift=1):
    """Rank i's ``x`` on rank (i + shift) mod T of ``axis``."""
    if not _active(axis):
        return x
    return _PPermute.apply(_tracked(x), axis, int(shift))


def all_gather_tiled(x, axis, dim):
    """The ranks' ``x`` joined along ``dim``, in rank order."""
    if not _active(axis):
        return x
    return _AllGather.apply(_tracked(x), axis, int(dim))


def psum_scatter_tiled(x, axis, dim):
    """Block ``rank`` along ``dim`` of the ranks' sum of ``x``."""
    if not _active(axis):
        return x
    return _PsumScatter.apply(_tracked(x), axis, int(dim))


def all_to_all(x, axis):
    """Block i of ``x``'s leading (T, ...) dim on rank i; block j of the
    result came from rank j."""
    if not _active(axis):
        return x
    return _AllToAll.apply(_tracked(x), axis)


def anchor(value, dangling):
    """``value``, with the tensors of ``dangling`` tied to it: each gets a
    zero cotangent when ``value`` is differentiated (see the module
    docstring).  ``value`` itself when nothing dangles or outside autograd."""
    dangling = [t for t in dangling if t.requires_grad]
    if not dangling or not torch.is_grad_enabled():
        return value
    return _Anchor.apply(value, *dangling)
