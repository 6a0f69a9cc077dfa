"""The collectives the port's parallel paths call, and their autograd forms.

Every collective goes through `_call`, which turns a backend's report of a
lost peer into `PeerLostError`: a peer that died (its sockets closed or
reset) or wedged past the group's timeout (`peer_lost` says which errors
those are). The trainer exits on it with a retryable code, so the operator
rolls the gang instead of failing the job. Every other error (out of
memory, a shape that differs between ranks, a CUDA error) propagates as it
is: it would fail again after a roll, so it fails the job.

Reductions run in f32 whatever the tensor's dtype: gloo's bf16 support
varies by build, and a sum of bf16 partials rounded once stays closer to
the one-process result. Gathers move the bytes as they are (bf16 as the
same bits typed fp16, which every backend takes: a copy does no
arithmetic).

The autograd forms are Megatron's: `copy_to` (identity forward, all-reduce
of the gradient backward: the input of the column-parallel layers that
read it, once for all of them),
`reduce_from` (all-reduce forward, identity backward: the output of a
row-parallel layer), `gather_from` (all-gather forward, the local slice
backward: every rank computes the same loss from the gathered tensor), and
`sum_across` (all-reduce both ways: a statistic of data split across
ranks, such as batch-norm moments).
"""

from __future__ import annotations

import re
from dataclasses import dataclass

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class TpShard:
    """How a layer holds its tensor-parallel shard: `mode` "col" (output
    dimension), "row" (input dimension) or "rows" (an embedding's table
    rows); shard `index` of `size` over `group`; `gather` all-gathers a
    column-parallel layer's output."""

    mode: str
    group: object
    index: int
    size: int
    gather: bool = False


class PeerLostError(RuntimeError):
    """A collective failed: a peer of the group is gone or wedged."""


# The backends' words for a lost peer. gloo raises a plain RuntimeError
# ("Read error ...: Connection reset by peer", "Connection closed by peer",
# "Timed out waiting 5000ms for recv operation to complete"); NCCL a
# DistBackendError ("remote process exited or there was a network error",
# a communicator aborted by its watchdog's timeout).
_PEER_LOST = re.compile(r"connection (?:closed|reset) by peer|broken pipe|timed out|"
                        r"remote process exited|network error|communicator was aborted",
                        re.IGNORECASE)


def peer_lost(e: BaseException) -> bool:
    """Whether a collective's error says a peer of the group is gone or
    wedged: the store's and the network's errors, and a backend's error
    in _PEER_LOST's words. An out-of-memory error never is."""
    if isinstance(e, torch.OutOfMemoryError):
        return False
    if isinstance(e, (dist.DistNetworkError, dist.DistStoreError)):
        return True
    return isinstance(e, RuntimeError) and bool(_PEER_LOST.search(str(e)))


def _call(fn, *args, **kwargs):
    try:
        return fn(*args, **kwargs)
    except RuntimeError as e:
        if peer_lost(e):
            raise PeerLostError(f"{fn.__name__} failed: {e}") from e
        raise


def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """The reduction of `t` over `group` (a new tensor of t's dtype; t
    itself when the group is None)."""
    if group is None:
        return t
    buf = t.detach().float().clone()
    _call(dist.all_reduce, buf, op=op, group=group)
    return buf.to(t.dtype)


def all_reduce_flat(tensors: list[torch.Tensor], group) -> list[torch.Tensor]:
    """The sums of `tensors` over `group` in one all-reduce of an f32
    bucket; each result in its tensor's dtype and shape."""
    if group is None or not tensors:
        return list(tensors)
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    _call(dist.all_reduce, flat, group=group)
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].view(t.shape).to(t.dtype))
        at += t.numel()
    return out


def reduce_scatter_flat(tensors: list[torch.Tensor], dims: list[int],
                        group) -> list[torch.Tensor]:
    """This rank's shards of the sums of `tensors` over `group`, each
    tensor split into equal shards along its `dims` entry, in one
    reduce-scatter of an f32 bucket laid out rank by rank (rank j's part
    holds shard j of every tensor); each shard in its tensor's dtype."""
    if group is None or not tensors:
        return list(tensors)
    n, r = dist.get_world_size(group), dist.get_rank(group)
    parts = [torch.cat([local_slice(t.detach(), d, j, n).reshape(-1).float()
                        for t, d in zip(tensors, dims)]) for j in range(n)]
    out = torch.empty_like(parts[0])
    _call(dist.reduce_scatter, out, parts, group=group)
    shards, at = [], 0
    for t, d in zip(tensors, dims):
        shape = local_slice(t, d, r, n).shape
        shards.append(out[at:at + shape.numel()].view(shape).to(t.dtype))
        at += shape.numel()
    return shards


def all_gather_into(shards: list[torch.Tensor], fulls: list[torch.Tensor],
                    dims: list[int], group) -> None:
    """Write each full tensor of `fulls` in place from its shards (this
    rank's `shards`, split along `dims` as reduce_scatter_flat splits, all
    of one dtype): one all-gather of a flat bucket, its bytes as they
    are."""
    if group is None:
        for s, f in zip(shards, fulls):
            f.copy_(s)
        return
    if not shards:
        return
    dtype = shards[0].dtype
    src = torch.cat([s.detach().reshape(-1) for s in shards])
    wire = src.view(torch.float16) if dtype == torch.bfloat16 else src
    parts = [torch.empty_like(wire) for _ in range(dist.get_world_size(group))]
    _call(dist.all_gather, parts, wire, group=group)
    for j, part in enumerate(parts):
        part, at = part.view(dtype), 0
        for full, d in zip(fulls, dims):
            dst = local_slice(full, d, j, len(parts))
            dst.copy_(part[at:at + dst.numel()].view(dst.shape))
            at += dst.numel()


def all_gather(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The shards of `group`'s ranks, in rank order, concatenated along
    `dim` (t itself when the group is None)."""
    if group is None:
        return t
    src = t.detach().contiguous()
    if src.dtype == torch.bfloat16:
        src = src.view(torch.float16)
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    _call(dist.all_gather, parts, src, group=group)
    return torch.cat(parts, dim=dim).view(t.dtype)


def broadcast_int(value: int, group=None, device=None) -> int:
    """Rank 0's `value` on every rank of the world (or `group`, from its
    first rank)."""
    t = torch.tensor([value], dtype=torch.int64, device=device)
    src = 0 if group is None else dist.get_global_rank(group, 0)
    _call(dist.broadcast, t, src=src, group=group)
    return int(t.item())


def local_slice(t: torch.Tensor, dim: int, index: int, count: int) -> torch.Tensor:
    """Shard `index` of `count` equal shards of `t` along `dim`."""
    n = t.shape[dim] // count
    return t.narrow(dim, index * n, n)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        size = dist.get_world_size(ctx.group)
        return local_slice(g, ctx.dim, dist.get_rank(ctx.group), size), None, None


class _SumAcross(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _ReduceFrom.apply(x, group)


def gather_from(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return x if group is None else _GatherFrom.apply(x, dim, group)


def sum_across(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _SumAcross.apply(x, group)
