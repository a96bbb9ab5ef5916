"""The parallel layer's collectives over torch.distributed, with their
backward stated (the port's counterpart of the psum / all-gather /
ppermute that XLA inserts for gns_tpu's meshes).

  all_reduce_sum(x, group)     forward: the sum over the group's ranks;
                               backward: the sum of the ranks' output
                               gradients (the transpose of a psum whose
                               output every rank differentiates). Under
                               the edge partition's rule every rank scales
                               its copy of the loss by 1/|group|, so the
                               summed gradient is the true one
                               (parallel/edge_partition.py).
  reduce_from_tp(x, group)     Megatron's "g": the sum forward, the
                               identity backward (every rank already holds
                               the whole output gradient).
  copy_to_tp(x, group)         Megatron's "f": the identity forward, the
                               sum of the ranks' input gradients backward.
  all_gather_rows(x, group, dim)  equal blocks concatenated along `dim` in
                               rank order; backward: the sum of the ranks'
                               gradients, this rank's block kept.
  send / recv / broadcast_     point to point and from one rank, no
                               autograd (the pipeline moves gradients by
                               hand).

The backend is whatever the caller's process group is: NCCL with CUDA
tensors, gloo with CPU tensors. gloo has no point-to-point path for CUDA
tensors, so `send` / `recv` stage a CUDA tensor through host memory
under gloo, and only there. Every call adds one to COUNTS under its
kind, where it issues the collective and nowhere else, so a caller can
hold a path's collectives against the count its code predicts.
"""

from __future__ import annotations

from collections import Counter

import torch
import torch.distributed as dist

COUNTS: Counter = Counter()


def reset_counts() -> None:
    COUNTS.clear()


def _gloo_cuda(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    COUNTS["all_reduce"] += 1
    dist.all_reduce(t, group=group)
    return t


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous().clone(), ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous().clone(), ctx.group), None


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.size = group, dim, x.shape[dim]
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        COUNTS["all_gather"] += 1
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g):
        total = _all_reduce(g.contiguous().clone(), ctx.group)
        rank = dist.get_rank(ctx.group)
        return total.narrow(ctx.dim, rank * ctx.size, ctx.size), None, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over `group`; identity when group is None (no partition)."""
    return x if group is None else _AllReduceSum.apply(x, group)


def reduce_from_tp(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _ReduceFromTP.apply(x, group)


def copy_to_tp(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _CopyToTP.apply(x, group)


def all_gather_rows(x: torch.Tensor, group, dim: int = 1) -> torch.Tensor:
    return x if group is None else _AllGatherRows.apply(x, group, dim)


def all_gather_list(x: torch.Tensor, group) -> list:
    """Every rank's `x` (same shape on every rank), in group-rank order; no
    autograd."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    COUNTS["all_gather"] += 1
    dist.all_gather(parts, x.contiguous(), group=group)
    return parts


def all_reduce_(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce of a tensor outside autograd."""
    COUNTS["all_reduce"] += 1
    dist.all_reduce(x, op=op, group=group)
    return x


def broadcast_(x: torch.Tensor, src_group_rank: int, group) -> torch.Tensor:
    """In place: every rank of `group` gets group rank `src_group_rank`'s x."""
    COUNTS["broadcast"] += 1
    dist.broadcast(x, src=dist.get_global_rank(group, src_group_rank), group=group)
    return x


def send(x: torch.Tensor, dst_group_rank: int, group) -> None:
    COUNTS["send"] += 1
    dst = dist.get_global_rank(group, dst_group_rank)
    if _gloo_cuda(x, group):
        # gloo moves no CUDA tensor point to point: stage through the host
        dist.send(x.detach().cpu(), dst=dst, group=group)
    else:
        dist.send(x.detach().contiguous(), dst=dst, group=group)


def recv(like: torch.Tensor, src_group_rank: int, group) -> torch.Tensor:
    """A new tensor of `like`'s shape, dtype and device from src."""
    COUNTS["recv"] += 1
    src = dist.get_global_rank(group, src_group_rank)
    if _gloo_cuda(like, group):
        # gloo moves no CUDA tensor point to point: stage through the host
        buf = torch.empty(like.shape, dtype=like.dtype)
        dist.recv(buf, src=src, group=group)
        return buf.to(like.device)
    buf = torch.empty_like(like)
    dist.recv(buf, src=src, group=group)
    return buf
