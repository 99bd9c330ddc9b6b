"""Collectives of the sharded renderer over ``torch.distributed`` process
groups: what the JAX package gets from ``jax.lax`` inside ``shard_map``.

Every function takes a process group, or None for a mesh axis of size 1;
with None it is the identity and calls nothing of ``torch.distributed``.

Gradients across ranks. ``torch.distributed.all_reduce`` is invisible to
autograd, so each collective that carries a differentiable value is a
``torch.autograd.Function`` whose backward is its transpose, itself a
collective: the backward of ``psum`` is a ``psum`` of the cotangents, the
backward of ``gather_rows`` is the sum over ranks of the cotangents of a
rank's own rows. ``pmin`` and ``pmax`` carry no gradient (min t is taken
detached, ids and occlusion bits are integers). Every rank runs the same
program and seeds its own copy of the loss with 1, so the transposes
together differentiate the SUM of the ranks' losses, world times the loss;
``replicate``, through which the Scene leaves enter the sharded renderer,
closes the scheme: its backward is ONE all-reduce of all leaf cotangents,
flattened into one buffer, divided by the world size. Each rank then holds
the whole gradient of the loss: the part that reaches a leaf through the
replicated shading and the parts through every shard's and every row
band's hits, each counted once. (Taking ``psum``'s backward as the identity
would lose the other shards' parts; summing over ranks without the 1/world
weight would count the replicated part once per rank.)

Transport. NCCL moves CUDA tensors itself. gloo moves CPU tensors; a CUDA
tensor under gloo (several ranks sharing one card, or CPU-only hosts) is
staged through the host here, in ``_all_reduce``, and nowhere else. The
transport changes how bytes travel between ranks, never where a rank
computes.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def _all_reduce(x: torch.Tensor, op, group) -> torch.Tensor:
    """A new tensor: the reduction of ``x`` over ``group``'s ranks."""
    if x.is_cuda and dist.get_backend(group) == "gloo":
        host = x.cpu()
        dist.all_reduce(host, op=op, group=group)
        return host.to(x.device)
    out = x.clone()
    dist.all_reduce(out, op=op, group=group)
    return out


def pmin(x: torch.Tensor, group) -> torch.Tensor:
    """Elementwise minimum over the group's ranks; no gradient."""
    if group is None:
        return x
    return _all_reduce(x.detach(), dist.ReduceOp.MIN, group)


def pmax(x: torch.Tensor, group) -> torch.Tensor:
    """Elementwise maximum over the group's ranks; no gradient."""
    if group is None:
        return x
    return _all_reduce(x.detach(), dist.ReduceOp.MAX, group)


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, dist.ReduceOp.SUM, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous(), dist.ReduceOp.SUM, ctx.group), None


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """Elementwise sum over the group's ranks; its backward is the sum of
    the ranks' cotangents."""
    if group is None:
        return x
    return _PSum.apply(x, group)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, band, group, index):
        n = dist.get_world_size(group)
        rows = band.shape[0]
        ctx.group, ctx.rows = group, slice(index * rows, (index + 1) * rows)
        full = band.new_zeros((n * rows, *band.shape[1:]))
        full[ctx.rows] = band
        return _all_reduce(full, dist.ReduceOp.SUM, group)

    @staticmethod
    def backward(ctx, g):
        total = _all_reduce(g.contiguous(), dist.ReduceOp.SUM, ctx.group)
        return total[ctx.rows].clone(), None, None


def gather_rows(band: torch.Tensor, group, index: int) -> torch.Tensor:
    """The whole image on every rank from the ranks' row bands: rank
    ``index`` of ``group`` contributes rows [index*rows, (index+1)*rows).
    One all-reduce of a zero-filled image (every transport has it; gloo has
    no all-gather of CUDA tensors). Its backward hands a rank the sum over
    ranks of the cotangents of its own rows."""
    if group is None:
        return band
    return _GatherRows.apply(band, group, index)


class _Replicate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, world, *leaves):
        ctx.world = world
        ctx.set_materialize_grads(False)
        return tuple(t.view_as(t) for t in leaves)

    @staticmethod
    def backward(ctx, *grads):
        live = [g for g in grads if g is not None]
        if not live:
            return (None, *grads)
        flat = _all_reduce(torch.cat([g.reshape(-1) for g in live]),
                           dist.ReduceOp.SUM, None) / ctx.world
        parts = iter(flat.split([g.numel() for g in live]))
        return (None, *(None if g is None else next(parts).view_as(g)
                        for g in grads))


def replicate(leaves, world: int):
    """The replicated parameters as they enter the sharded computation of a
    mesh of ``world`` ranks (all processes). Forward: the same tensors.
    Backward: the one fused all-reduce of the gradient scheme (see the
    module docstring): the leaves' cotangents in one flat buffer, summed
    over all ranks and divided by ``world``."""
    if world == 1:
        return tuple(leaves)
    return _Replicate.apply(world, *leaves)
