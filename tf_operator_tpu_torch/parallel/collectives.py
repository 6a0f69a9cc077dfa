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
ranks, such as batch-norm moments). zero-3's `gather_params` all-gathers a
layer's fsdp shards in one flat bucket in the forward and reduce-scatters
their gradients in the backward. Sequence parallelism's two are JAX's:
`rotate` (ppermute of K and V together to the next rank of the ring; the
gradients go to the previous one) and `all_to_all` (the tiled
lax.all_to_all; its backward is the reverse all-to-all).

In an NCCL world every rank captures its step's collectives in a CUDA
graph (graphed_step.py), so none of those the step runs reads the host:
each makes its buffers on the device and waits on its work at once, which
under a capture only orders the stream after the collective. Those that
read the host (broadcast_int, all_gather_int, agree_int) run outside the
step. Outside a capture, `_call` then waits for the collective on the host
through the trainer's watchdog (peer_watch.wait), so a lost peer raises
PeerLostError within distributed.TIMEOUT instead of blocking the host.

The ring's point-to-point buffers on NCCL persist (`_ring_buffer`: one
send and one receive buffer a shape): every rotation copies its K and V
into the send buffer and its result out of the receive buffer on the
current stream, so NCCL's stream touches no other memory. Inside a CUDA
graph's capture a block that NCCL's stream used cannot be handed out again,
so fresh buffers would each stay in the graph's pool for its life.

gloo's point-to-point ops take no CUDA tensor (the process aborts), so
where the backend is gloo and the tensors live on a GPU (two ranks sharing
one card) `rotate`, `send` and `recv` (the pipeline's hops) stage their
bytes through pinned host buffers; gloo's all_to_all_single takes CUDA
tensors as they are.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Callable

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


def _call(fn, *args, wait: bool = True, **kwargs):
    """fn(*args, **kwargs), a lost peer's error as PeerLostError; then, with
    `wait`, the host waits for it through the watchdog (a no-op but in an
    NCCL world outside a capture)."""
    from tf_operator_tpu_torch.parallel import peer_watch

    try:
        out = fn(*args, **kwargs)
    except RuntimeError as e:
        if peer_lost(e):
            raise PeerLostError(f"{fn.__name__} failed: {e}") from e
        raise
    if wait:
        peer_watch.wait(fn.__name__)
    return out


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


def all_gather_int(value: int, device=None) -> list[int]:
    """Every rank's `value`, by rank, on every rank of the world: one
    all-reduce of a vector in which each rank fills its own slot. Unlike a
    broadcast, no rank can finish it without hearing from every other."""
    t = torch.zeros(dist.get_world_size(), dtype=torch.int64, device=device)
    t[dist.get_rank()] = value
    _call(dist.all_reduce, t)
    return [int(v) for v in t.tolist()]


def agree_int(value: int, what: Callable[[int, int], str], device=None) -> None:
    """Hold every rank's `value` against process 0's, on every rank at
    once (all_gather_int). Where they differ, a rank that differs raises
    RuntimeError (the job is misconfigured: exit 1), and a rank that agrees
    with process 0 raises PeerLostError (its disagreeing peers leave: exit
    138, retryable), without a further collective, so no rank's verdict
    depends on a send into a peer that is leaving. `what(mine, process 0's)`
    words the disagreement."""
    seen = all_gather_int(value, device)
    if len(set(seen)) == 1:
        return
    if value != seen[0]:
        raise RuntimeError(what(value, seen[0]))
    others = [r for r, v in enumerate(seen) if v != seen[0]]
    raise PeerLostError(f"process(es) {others} leave the job; process {others[0]} reports: "
                        f"{what(seen[others[0]], seen[0])}")


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


class _GatherParams(torch.autograd.Function):
    """fsdp shards -> full tensors in one all-gather; the backward
    reduce-scatters the full tensors' gradients back to the shards (one f32
    bucket), so they come out summed over the group."""

    @staticmethod
    def forward(ctx, dims, group, *shards):
        n = dist.get_world_size(group)
        fulls = []
        for s, d in zip(shards, dims):
            shape = list(s.shape)
            shape[d] *= n
            fulls.append(s.new_empty(shape))
        all_gather_into(list(shards), fulls, list(dims), group)
        ctx.dims, ctx.group = dims, group
        ctx.shapes = [f.shape for f in fulls]
        ctx.dtype, ctx.device = fulls[0].dtype, fulls[0].device
        return tuple(fulls)

    @staticmethod
    def backward(ctx, *grads):
        grads = [torch.zeros(shape, dtype=ctx.dtype, device=ctx.device) if g is None else g
                 for g, shape in zip(grads, ctx.shapes)]
        return (None, None, *reduce_scatter_flat(grads, list(ctx.dims), ctx.group))


def gather_params(shards: list[torch.Tensor], dims: list[int], group) -> list[torch.Tensor]:
    """The full tensors of a layer's fsdp `shards` (each split along its
    `dims` entry over `group`), differentiable: their gradients reach the
    shards reduce-scattered, summed over the group."""
    if group is None or not shards:
        return list(shards)
    return list(_GatherParams.apply(tuple(dims), group, *shards))


def _wire(x: torch.Tensor) -> torch.Tensor:
    """x's bytes as a collective moves them (bf16 as fp16, see above)."""
    return x.view(torch.float16) if x.dtype == torch.bfloat16 else x


def _pinned(x: torch.Tensor) -> torch.Tensor:
    """An empty pinned host buffer of x's shape and dtype."""
    return torch.empty(x.shape, dtype=x.dtype, pin_memory=True)


_RING_BUFFERS: dict = {}


def _ring_buffer(kind: str, numel: int, dtype: torch.dtype, device) -> torch.Tensor:
    """The persistent flat `kind` ("send" or "recv") buffer of the ring's
    point-to-point exchanges at (device, dtype, numel) on NCCL (module
    docstring): made at its first use, which is the graph's warm-up."""
    key = (kind, torch.device(device), dtype, numel)
    buf = _RING_BUFFERS.get(key)
    if buf is None:
        buf = _RING_BUFFERS[key] = torch.empty(numel, dtype=dtype, device=device)
    return buf


def _exchange(parts: list[torch.Tensor], dst: int, src: int, group) -> torch.Tensor:
    """Send `parts` (as one flat buffer, in order) to group rank `dst` and
    receive one of their size from group rank `src`, in one batch of
    point-to-point ops; returns the received flat tensor (a fresh one)."""
    numel = sum(p.numel() for p in parts)
    first = parts[0]
    backend = dist.get_backend(group)
    if first.is_cuda and backend != "gloo":
        send = _ring_buffer("send", numel, first.dtype, first.device)
        at = 0
        for p in parts:
            send[at:at + p.numel()].view(p.shape).copy_(p)
            at += p.numel()
        recv = _ring_buffer("recv", numel, first.dtype, first.device)
    else:
        send = torch.cat([p.reshape(-1) for p in parts])
        recv = torch.empty_like(send)
    out = recv
    staged = first.is_cuda and backend == "gloo"
    if staged:
        send, recv = _pinned(_wire(send)).copy_(_wire(send)), _pinned(_wire(out))
    else:
        send, recv = _wire(send), _wire(out)
    ops = [dist.P2POp(dist.isend, send, dist.get_global_rank(group, dst), group=group),
           dist.P2POp(dist.irecv, recv, dist.get_global_rank(group, src), group=group)]
    for work in _call(dist.batch_isend_irecv, ops, wait=False):
        _call(work.wait)
    if staged:
        _wire(out).copy_(recv)
    elif first.is_cuda and backend != "gloo":
        out = out.clone()
    return out


def send(x: torch.Tensor, dst: int, group, tag: int = 0) -> None:
    """Send x to group rank `dst` (the pipeline's hop); under gloo a CUDA
    tensor goes through a pinned host buffer."""
    buf = _wire(x.detach().contiguous())
    if buf.is_cuda and dist.get_backend(group) == "gloo":
        buf = _pinned(buf).copy_(buf)
    _call(dist.send, buf, dist.get_global_rank(group, dst), group=group, tag=tag)


def recv(shape, dtype: torch.dtype, device, src: int, group, tag: int = 0) -> torch.Tensor:
    """A tensor of `shape` and `dtype` on `device` received from group rank
    `src` (send's other end)."""
    out = torch.empty(shape, dtype=dtype, device=device)
    staged = out.is_cuda and dist.get_backend(group) == "gloo"
    buf = _pinned(_wire(out)) if staged else _wire(out)
    _call(dist.recv, buf, dist.get_global_rank(group, src), group=group, tag=tag)
    if staged:
        _wire(out).copy_(buf)
    return out


def _shift(k: torch.Tensor, v: torch.Tensor, group, step: int):
    """(k, v) of the rank `step` places before this one in `group`'s ring
    (step 1: the previous rank's; -1: the next one's), sent as one buffer."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    out = _exchange([k, v], (r + step) % n, (r - step) % n, group)
    return out[:k.numel()].view(k.shape), out[k.numel():].view(v.shape)


class _Rotate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, k, v, group):
        ctx.group = group
        return _shift(k.contiguous(), v.contiguous(), group, 1)

    @staticmethod
    def backward(ctx, gk, gv):
        return (*_shift(gk.contiguous(), gv.contiguous(), ctx.group, -1), None)


def rotate(k: torch.Tensor, v: torch.Tensor, group) -> tuple[torch.Tensor, torch.Tensor]:
    """JAX's ppermute of k and v to the next rank of `group`'s ring (rank
    r gets rank r - 1's), in one paired exchange; the gradients travel the
    other way."""
    if group is None:
        return k, v
    return _Rotate.apply(k, v, group)


def _all_to_all(x: torch.Tensor, split_dim: int, concat_dim: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    send = torch.stack(x.chunk(n, dim=split_dim)).contiguous()
    recv = torch.empty_like(send)
    _call(dist.all_to_all_single, _wire(recv), _wire(send), group=group)
    return torch.cat(recv.unbind(0), dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_dim, concat_dim, group):
        ctx.dims, ctx.group = (split_dim, concat_dim), group
        return _all_to_all(x, split_dim, concat_dim, group)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return _all_to_all(g, concat_dim, split_dim, ctx.group), None, None, None


def all_to_all(x: torch.Tensor, split_dim: int, concat_dim: int, group) -> torch.Tensor:
    """JAX's tiled lax.all_to_all over `group`: x split into equal chunks
    along split_dim, chunk j to rank j, the chunks received concatenated
    along concat_dim in rank order."""
    if group is None:
        return x
    return _AllToAll.apply(x, split_dim, concat_dim, group)
