"""Collectives with their backward, for code that computes the same values
on every rank of a group (the replicated activations of tensor and sequence
parallelism): each autograd Function's backward is what makes every rank end
with the gradient of one copy of the loss.

  copy_to(x)       forward identity           backward all-reduce (sum)
  reduce_from(x)   forward all-reduce (sum)   backward identity
  split(x, dim)    forward this rank's slice  backward all-gather
  gather(x, dim)   forward all-gather         backward this rank's slice
  gather_rs(x)     forward all-gather (dim 0) backward reduce-scatter (sum)

`gather` is for a result every rank then uses whole and alike (its incoming
gradient is the same on every rank); `gather_rs` for one that each rank uses
with its own rows of something else (K / V under its local queries), whose
gradient is a sum of every rank's part. A group of one rank makes each of
them the identity.
"""

from __future__ import annotations

import sys

import torch
import torch.distributed as dist


def is_dtensor(t) -> bool:
    """True for a DTensor; never imports torch.distributed.tensor (~1 s), for
    where nothing imported it no DTensor can exist."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(t, mod.DTensor)


def local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (a view: writes reach the DTensor), any other
    tensor itself."""
    return t.to_local() if is_dtensor(t) else t


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    x = x.movedim(dim, 0).contiguous()
    out = x.new_empty((n * x.shape[0], *x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    return out.movedim(0, dim)


def _slice(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n, r = dist.get_world_size(group), dist.get_rank(group)
    size = x.shape[dim] // n
    return x.narrow(dim, r * size, size).contiguous()


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.clone(memory_format=torch.contiguous_format)  # the input may be saved for another backward
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _slice(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.group, ctx.dim), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _slice(g, ctx.group, ctx.dim), None, None


class _GatherRS(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_gather(x, group, 0)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        out = g.new_empty((g.shape[0] // dist.get_world_size(ctx.group), *g.shape[1:]))
        dist.reduce_scatter_tensor(out, g, group=ctx.group)
        return out, None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    return x if group_size(group) == 1 else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    return x if group_size(group) == 1 else _ReduceFrom.apply(x, group)


def split(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    return x if group_size(group) == 1 else _Split.apply(x, group, dim)


def gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    return x if group_size(group) == 1 else _Gather.apply(x, group, dim)


def gather_rs(x: torch.Tensor, group) -> torch.Tensor:
    return x if group_size(group) == 1 else _GatherRS.apply(x, group)


def gather_values(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """All-gather of a tensor that needs no gradient (metadata, tokens)."""
    return x if group_size(group) == 1 else _all_gather(x, group, dim)
