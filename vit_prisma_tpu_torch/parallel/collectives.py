"""Explicit collectives over one axis of a ``(data, model)`` device mesh.

The port keeps a shard as plain local tensors on each rank (the hand-written
kernels take ``data_ptr()``s of local contiguous tensors), so the
collectives that GSPMD inserts in the JAX package are written out here.
:class:`Axis` is one mesh axis as this rank sees it: its process group, its
size and this rank's index on it.  An axis of size 1 makes every collective
the identity (the input itself, no copy), so a world of one runs the
unsharded arithmetic to the bit.

The differentiable pair is Megatron's: :meth:`Axis.reduce_from` sums partial
results in the forward and passes the gradient through unchanged (the
computation after it is replicated on the axis), and :meth:`Axis.copy_to`
is the identity in the forward and sums the partial gradients in the
backward (the input of a column-parallel product).  :meth:`Axis.gather` and
:meth:`Axis.own` move a tensor between its local slice and the whole along
one dimension, each the other's backward, so a hook that sees the whole
tensor also sees the whole gradient.

The collectives are ``all_reduce``, ``all_gather`` and, for the store's
row exchange alone, ``all_to_all_single``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist


class Axis:
    """One mesh axis seen from this rank: ``group`` (None with ``size`` 1),
    ``size`` and ``rank`` (this rank's index along the axis)."""

    __slots__ = ("group", "size", "rank")

    def __init__(self, group=None, size: int = 1, rank: int = 0):
        self.group, self.size, self.rank = group, size, rank

    def __repr__(self):
        return f"Axis(size={self.size}, rank={self.rank})"

    # -- plain (non-differentiable) collectives ----------------------------
    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the axis, as a new tensor (``t`` itself on
        an axis of one)."""
        if self.size == 1:
            return t
        out = t.detach().clone().contiguous()
        dist.all_reduce(out, group=self.group)
        return out

    def mean(self, t: torch.Tensor) -> torch.Tensor:
        """The mean of ``t`` over the axis (equal shards: the global mean of
        per-shard means)."""
        if self.size == 1:
            return t
        return self.sum(t) / self.size

    def all_gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The axis's tensors concatenated along ``dim`` in rank order."""
        if self.size == 1:
            return t
        t = t.detach().contiguous()
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t, group=self.group)
        return torch.cat(parts, dim=dim)

    def all_to_all(self, send: torch.Tensor, send_counts: Sequence[int],
                   recv_counts: Sequence[int]) -> torch.Tensor:
        """Rows ``send`` split by ``send_counts`` (rank order) to the axis's
        ranks; returns the rows received, by source rank."""
        if self.size == 1:
            return send
        send = send.contiguous()
        recv = torch.empty((sum(recv_counts),) + tuple(send.shape[1:]), dtype=send.dtype,
                           device=send.device)
        dist.all_to_all_single(recv, send, list(recv_counts), list(send_counts),
                               group=self.group)
        return recv

    def slice(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's contiguous slice of ``t`` along ``dim`` (the size
        along ``dim`` must divide by the axis)."""
        if self.size == 1:
            return t
        n = t.shape[dim] // self.size
        return t.narrow(dim, self.rank * n, n)

    # -- differentiable collectives ------------------------------------------
    def reduce_from(self, t: torch.Tensor) -> torch.Tensor:
        """Forward: the sum over the axis; backward: the identity."""
        return t if self.size == 1 else _ReduceFrom.apply(t, self)

    def copy_to(self, t: torch.Tensor) -> torch.Tensor:
        """Forward: the identity; backward: the sum of the gradients over
        the axis."""
        return t if self.size == 1 else _CopyTo.apply(t, self)

    def gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Forward: the whole tensor from the slices along ``dim``;
        backward: this rank's slice of the gradient."""
        return t if self.size == 1 else _Gather.apply(t, self, dim)

    def own(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Forward: this rank's slice along ``dim``; backward: the whole
        gradient, gathered from the slices."""
        return t if self.size == 1 else _Own.apply(t, self, dim)


SINGLE = Axis()


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axis):
        return axis.sum(t)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axis):
        ctx.axis = axis
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.sum(g), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return axis.all_gather(t, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.slice(g, ctx.dim).contiguous(), None, None


class _Own(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return axis.slice(t, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.all_gather(g, ctx.dim), None, None


def hook_whole(hooks, name: str, local: torch.Tensor, axis: Optional[Axis], dim: int,
               editable: bool = True) -> torch.Tensor:
    """Fire the hook point ``name`` on the whole tensor of a value sharded
    along ``dim`` over ``axis``, and return this rank's slice of what the
    hook returns.  Nothing is gathered when no hook wants ``name``."""
    if axis is None or axis.size == 1:
        return hooks(name, local, editable=editable)
    if not hooks.wants(name):
        return local
    whole = hooks(name, axis.gather(local, dim), editable=editable)
    return axis.own(whole, dim)


def exchange_rows(rows: torch.Tensor, held: List[torch.Tensor], need: List[torch.Tensor],
                  axis: Axis, take=None) -> torch.Tensor:
    """Give each rank of ``axis`` the rows it needs of a row space spread
    over the axis.

    ``held[r]`` lists the positions (in the row space) of rank ``r``'s rows,
    in its local order (``rows`` are this rank's, ``rows[i]`` at
    ``held[rank][i]``); ``need[r]`` the positions rank ``r`` needs, in the
    order it needs them.  Every rank passes the same ``held`` and ``need``.
    Each rank gathers, by ``take`` (a row gather, kernel B3 on the card),
    the rows each other rank needs from it, grouped by destination; one
    ``all_to_all_single`` moves every row once; a second gather puts the
    received rows in the needed order.  Returns this rank's needed rows."""
    if take is None:
        take = lambda x, idx: x.index_select(0, idx)
    dev = rows.device
    me = axis.rank
    if axis.size == 1:
        n = int(held[0].numel())
        owner_index = torch.empty(n, dtype=torch.int64, device=dev)
        owner_index[held[0]] = torch.arange(n, device=dev)
        return take(rows, owner_index[need[0]])
    n_space = int(sum(h.numel() for h in held))
    owner = torch.empty(n_space, dtype=torch.int64, device=dev)
    local = torch.empty(n_space, dtype=torch.int64, device=dev)
    for r, h in enumerate(held):
        owner[h] = r
        local[h] = torch.arange(h.numel(), device=dev)
    send_idx, send_counts = [], []
    for e in range(axis.size):
        mine = need[e][owner[need[e]] == me]
        send_idx.append(local[mine])
        send_counts.append(int(mine.numel()))
    need_owner = owner[need[me]]
    recv_counts = torch.bincount(need_owner, minlength=axis.size).tolist()
    send = take(rows, torch.cat(send_idx))
    recv = axis.all_to_all(send, send_counts, recv_counts)
    # recv holds my needed rows ordered by (source rank, my need order)
    order = torch.sort(need_owner, stable=True).indices
    back = torch.empty_like(order)
    back[order] = torch.arange(order.numel(), device=dev)
    return take(recv, back)


class ShardAxes:
    """The two axes a sharded SAE step reduces over: ``data`` (rows) and
    ``model`` (features of a single SAE).  The default is a world of one,
    whose collectives are all the identity."""

    __slots__ = ("data", "model")

    def __init__(self, data: Axis = SINGLE, model: Axis = SINGLE):
        self.data, self.model = data, model

    def __repr__(self):
        return f"ShardAxes(data={self.data}, model={self.model})"


NO_SHARDING = ShardAxes()
