"""Autograd-aware collectives over a process group (the port's own; the
JAX package gets them from ``jax.lax`` inside ``shard_map``).

Every differentiable operator is a ``torch.autograd.Function`` whose
backward is the transpose of its forward:

  * ``all_gather(x, group, dim)``: the ranks' equal blocks concatenated
    along ``dim`` in group order; backward: the reduce-scatter sum (each
    rank's block of the summed upstream gradients), the transpose of
    ``jax.lax.all_gather``;
  * ``all_reduce(x, group)``: the sum; backward: the sum of the upstream
    gradients (each rank's value feeds every rank's output), as for
    BatchNorm's moments over the data group;
  * ``scatter_rows(x, group, dim)``: the graph convs' way in -- x is the
    same on every rank of the group and each rank keeps its contiguous
    block along ``dim``; backward: the all-gather of the blocks'
    gradients (a sum over disjoint blocks), the same on every rank;
  * ``gather_rows(x, group, dim)``: the way out -- the blocks all-gathered
    into the whole, which every rank then uses alike; backward: this
    rank's block of the upstream gradient (the same on every rank);
  * ``all_reduce_replicated(x, group)``: a sum whose result every rank
    then uses alike (the label build's owner-side fetch, where each
    winner is nonzero on one rank only); backward: the upstream gradient
    as it is;
  * ``replicated(x, group)``: x, the same on every rank of the group, used
    by each rank for its own part of the work (the targets of the gather
    schedule's graph conv, which every rank of the graph group holds
    whole); backward: the sum of the ranks' gradients, the same on every
    rank (the transpose of ``all_reduce_replicated``).

A group of None (an axis of size 1) makes each of them the identity.

Transport: NCCL takes CUDA tensors as they are. gloo takes CPU tensors
and, on CUDA tensors, supports fewer operations than on CPU ones, so on
gloo every CUDA tensor is copied into a pinned host buffer, the operation
runs on the host copy, and the result is copied back to the device. Sums of
bfloat16 or float16 tensors are taken in float32 on either transport (gloo
has no bfloat16 sum on every version) and rounded back once; gathers,
broadcasts and sends over gloo move bfloat16 bits as bytes.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

_LOW = (torch.bfloat16, torch.float16)


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _staged(t: torch.Tensor, group) -> bool:
    """Whether a tensor crosses this group's transport through the host."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _to_host(t: torch.Tensor) -> torch.Tensor:
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)  # CUDA -> pinned: returns when the copy is done
    return host


def _bits(t: torch.Tensor, group) -> torch.Tensor:
    """gloo moves bfloat16 bits as bytes (its type switch has uint8 on every
    version, neither int16 nor, on every version, bfloat16): the last axis
    twice as long. NCCL takes bfloat16 itself."""
    if t.dtype == torch.bfloat16 and dist.get_backend(group) == "gloo":
        return t.view(torch.uint8)
    return t


def _raw_all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    x = x.contiguous()
    staged = _staged(x, group)
    wire = _bits(_to_host(x) if staged else x, group)
    parts = [torch.empty_like(wire) for _ in range(group_size(group))]
    dist.all_gather(parts, wire, group=group)
    out = torch.cat([p.view(x.dtype) for p in parts], dim=dim)
    return out.to(x.device, non_blocking=True) if staged else out


def _raw_all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    staged = _staged(x, group)
    wire = _to_host(x) if staged else x.clone()
    if wire.dtype in _LOW:
        wire = wire.float()
    dist.all_reduce(wire, group=group)
    return wire.to(device=x.device, dtype=x.dtype, non_blocking=True)


def _block(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    s = group_size(group)
    n = x.shape[dim] // s
    return x.narrow(dim, dist.get_rank(group) * n, n).contiguous()


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _raw_all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        # the reduce-scatter sum, as an all-reduce and this rank's block
        return _block(_raw_all_reduce(g, ctx.group), ctx.group,
                      ctx.dim), None, None


class _Gathered(torch.autograd.Function):
    """``all_gather``'s gradient for a whole the caller assembled itself
    (the ring schedule's target shards)."""

    @staticmethod
    def forward(ctx, x, whole, group, dim):
        ctx.group, ctx.dim = group, dim
        return whole

    @staticmethod
    def backward(ctx, g):
        return _block(_raw_all_reduce(g, ctx.group), ctx.group,
                      ctx.dim), None, None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _raw_all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _raw_all_reduce(g, ctx.group), None


class _AllReduceReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _raw_all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Replicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _raw_all_reduce(g, ctx.group), None


class _ScatterRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _block(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _raw_all_gather(g, ctx.group, ctx.dim), None, None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _raw_all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _block(g, ctx.group, ctx.dim), None, None


def all_gather(x: torch.Tensor, group, dim: int = 1) -> torch.Tensor:
    return x if group_size(group) == 1 else _AllGather.apply(x, group, dim)


def gathered(x: torch.Tensor, whole: torch.Tensor, group,
             dim: int = 1) -> torch.Tensor:
    """``whole``, the ranks' blocks x already concatenated along ``dim``,
    with ``all_gather``'s gradient to x."""
    return whole if group_size(group) == 1 \
        else _Gathered.apply(x, whole, group, dim)


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    return x if group_size(group) == 1 else _AllReduce.apply(x, group)


def all_reduce_replicated(x: torch.Tensor, group) -> torch.Tensor:
    return x if group_size(group) == 1 \
        else _AllReduceReplicated.apply(x, group)


def replicated(x: torch.Tensor, group) -> torch.Tensor:
    return x if group_size(group) == 1 else _Replicated.apply(x, group)


def scatter_rows(x: torch.Tensor, group, dim: int = 1) -> torch.Tensor:
    return x if group_size(group) == 1 else _ScatterRows.apply(x, group, dim)


def gather_rows(x: torch.Tensor, group, dim: int = 1) -> torch.Tensor:
    return x if group_size(group) == 1 else _GatherRows.apply(x, group, dim)


@torch.no_grad()
def broadcast_(t: torch.Tensor, src: int, group=None) -> None:
    """Overwrite t in place with global rank ``src``'s (over the world when
    ``group`` is None, as in ``torch.distributed``)."""
    staged = _staged(t, group)
    wire = _to_host(t) if staged else t
    bits = _bits(wire.contiguous(), group)
    dist.broadcast(bits, src=src, group=group)
    if staged or bits.data_ptr() != t.data_ptr():
        t.copy_(bits.view(t.dtype))


@torch.no_grad()
def reduce_mean_(tensors: list[torch.Tensor], group, count: int) -> None:
    """Replace each tensor in place by the sum over ``group`` (the world
    when None) of every rank's, divided by ``count``. One flat fp32 buffer,
    one all-reduce."""
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    staged = _staged(flat, group)
    wire = _to_host(flat) if staged else flat
    dist.all_reduce(wire, group=group)
    if staged:
        flat.copy_(wire)
    flat.div_(count)
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view_as(t))
        offset += n


class RingTransfer:
    """One ring step over a graph group: send x to the next rank and
    receive the previous rank's tensor of the same shape, started at
    construction (isend / irecv) and finished by ``wait()``, so the caller
    computes on the shard in hand meanwhile."""

    def __init__(self, x: torch.Tensor, ranks: tuple[int, ...], me: int,
                 group):
        x = x.contiguous()
        self.dtype, self.device = x.dtype, x.device
        self.staged = _staged(x, group)
        send = _bits(_to_host(x) if self.staged else x, group)
        self.recv = torch.empty_like(send)
        s = len(ranks)
        self.works = [dist.isend(send, ranks[(me + 1) % s], group=group),
                      dist.irecv(self.recv, ranks[(me - 1) % s],
                                 group=group)]
        self._send = send  # alive until the send completes

    def wait(self) -> torch.Tensor:
        for w in self.works:
            w.wait()
        out = self.recv.view(self.dtype)
        return out.to(self.device, non_blocking=True) if self.staged else out
