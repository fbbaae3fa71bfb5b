"""Differentiable collectives for the sharded steps (``torch.distributed``).

Each sharded layer runs on the rank's own shards as plain tensors, the way
the reference's ``shard_map`` bodies do; these functions are its explicit
collectives, with the backward that the layer's placement needs.  A
tensor said to be *replicated* over a group holds the same value on every
rank of it, and so does its gradient (DTensor's convention for
``Replicate()``).

* :func:`copy_to` — identity; backward all-reduces (a replicated input
  whose ranks each use a different part of it);
* :func:`reduce_from` — all-reduce; backward identity (rank partials that
  sum to a replicated value);
* :func:`gather_rep` — all-gather along ``dim``; backward keeps the
  rank's own chunk (the output is replicated);
* :func:`gather_rs` — all-gather along ``dim``; backward reduce-scatters
  (every rank uses the whole gathered tensor);
* :func:`all_to_all` — ``all_to_all_single`` of equal chunks of dim 0,
  its own inverse in the backward.

``group=None`` stands for a group of one rank: every function is then the
identity.  Nothing here picks a backend; the group's own does the work
(gloo on CPU tensors, NCCL on the card).
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The group's tensors concatenated along ``dim`` in rank order (no
    autograd); ``x`` itself for a group of one."""
    if size(group) == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def reduce_scatter(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Sum over the group, then keep the rank's chunk of ``dim``."""
    n = size(group)
    if n == 1:
        return x
    if dist.get_backend(group) != "gloo":
        xm = x.movedim(dim, 0).contiguous()
        out = torch.empty((xm.shape[0] // n,) + xm.shape[1:], dtype=x.dtype,
                          device=x.device)
        dist.reduce_scatter_tensor(out, xm, group=group)
        return out.movedim(0, dim).contiguous()
    # gloo alone has no reduce-scatter: all-reduce, then the rank's chunk.
    x = x.contiguous().clone()
    dist.all_reduce(x, group=group)
    return x.chunk(n, dim=dim)[rank(group)].contiguous()


def all_reduce_(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce (no autograd); identity for a group of one."""
    if size(group) > 1:
        dist.all_reduce(x, op=op, group=group)
    return x


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherRep(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        n = size(ctx.group)
        return g.chunk(n, dim=ctx.dim)[rank(ctx.group)].contiguous(), None, None


class _GatherRS(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.group, ctx.dim), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        out = torch.empty_like(g)
        dist.all_to_all_single(out, g, group=ctx.group)
        return out, None


def copy_to(x, group):
    return x if size(group) == 1 else _CopyTo.apply(x, group)


def reduce_from(x, group):
    return x if size(group) == 1 else _ReduceFrom.apply(x, group)


def gather_rep(x, group, dim: int):
    return x if size(group) == 1 else _GatherRep.apply(x, group, dim)


def gather_rs(x, group, dim: int):
    return x if size(group) == 1 else _GatherRS.apply(x, group, dim)


def all_to_all(x, group):
    return x if size(group) == 1 else _AllToAll.apply(x, group)


def chunk_of(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The rank's equal chunk of ``dim`` (no communication)."""
    n = size(group)
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"into {n} equal chunks")
    return x.chunk(n, dim=dim)[rank(group)]
