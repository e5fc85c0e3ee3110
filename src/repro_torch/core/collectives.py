"""Cross-shard sums over the DistEGNN graph axis (``torch.distributed``).

The reference runs one process per host and ``psum``s over the ``graph``
axis of a ``shard_map``.  The port runs one process (rank) per shard over
a ``torch.distributed`` group; :class:`GraphAxis` is the handle that the
model, the losses and the train step take where the reference takes an
``axis_name``.

:func:`graph_sum` is the port's ``psum``: an ``all_gather`` and then a sum
in rank order, ``((s0 + s1) + s2) + s3``, so that every rank gets the same
bits on every run whatever the backend's own reduction order — the
port's rule of fixed-order sums with no float atomics, carried over to
collectives.  It is a ``torch.autograd.Function`` (``all_reduce`` has no
gradient, DESIGN.md §6.1): its backward sums the cotangents across ranks
the same way, as ``psum``'s transpose does.  :func:`graph_sum_async`
issues the gather and returns a :class:`PendingSum` whose ``wait()``
finishes it, for the overlapped layer schedule.  A group of one rank is
the exact identity, and needs no process group.

Backend (:func:`pick_backend`): NCCL when every rank has a GPU of its own,
gloo when ranks share one GPU (NCCL refuses two ranks on one device) or
run on the CPU; chosen up front, never switched on failure.  gloo takes
CUDA tensors for ``all_gather`` and ``all_reduce`` (it stages them
through host memory itself: ``tools/collective_probe.py``), so the sums
hand it the ranks' tensors as they are.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

Tensor = torch.Tensor


def pick_backend(device: torch.device, world_size: int,
                 n_gpus: Optional[int] = None) -> str:
    """``'nccl'`` when ranks run on CUDA with a GPU each, else ``'gloo'``."""
    if device.type != "cuda":
        return "gloo"
    if n_gpus is None:
        n_gpus = torch.cuda.device_count()
    return "nccl" if n_gpus >= world_size else "gloo"


class GraphAxis(NamedTuple):
    """This rank's place on the graph axis: the process group (``None``
    for the default group), the rank, the world size, the device the
    rank's tensors live on, and the backend."""

    group: object = None
    rank: int = 0
    size: int = 1
    device: torch.device = torch.device("cpu")
    backend: str = "none"


def _gather(t: Tensor, axis: GraphAxis, async_op: bool):
    """Issue an ``all_gather`` of ``t``; returns ``(buffers, (work,
    operand))``."""
    import torch.distributed as dist

    src = t.detach().contiguous()
    bufs = [torch.empty_like(src) for _ in range(axis.size)]
    work = dist.all_gather(bufs, src, group=axis.group, async_op=async_op)
    return bufs, (work, src)  # the operand lives until the work is done


def _rank_order_sum(bufs: list) -> Tensor:
    acc = bufs[0]
    for b in bufs[1:]:
        acc = acc + b
    return acc


def sum_across(t: Tensor, axis: GraphAxis) -> Tensor:
    """Rank-order sum of ``t`` over the axis, outside autograd."""
    if axis.size == 1:
        return t
    bufs, _ = _gather(t, axis, async_op=False)
    return _rank_order_sum(bufs)


class _GraphSum(torch.autograd.Function):
    """``forward(t, axis, *gathered)``: the rank-order sum of the gathered
    copies (``t`` is this rank's own operand, kept for autograd);
    ``backward``: the rank-order sum of every rank's cotangent."""

    @staticmethod
    def forward(ctx, t, axis, *gathered):
        ctx.axis = axis
        return _rank_order_sum(list(gathered))

    @staticmethod
    def backward(ctx, g):
        return (sum_across(g.contiguous(), ctx.axis), None,
                *([None] * ctx.axis.size))


class PendingSum:
    """A :func:`graph_sum_async` in flight; :meth:`wait` returns the sum."""

    def __init__(self, t: Tensor, axis: GraphAxis):
        self.t, self.axis = t, axis
        self.bufs, self.work = (None, None) if axis.size == 1 else _gather(
            t, axis, async_op=True)

    def wait(self) -> Tensor:
        if self.axis.size == 1:
            return self.t
        self.work[0].wait()
        return _GraphSum.apply(self.t, self.axis, *self.bufs)


def graph_sum_async(t: Tensor, axis: GraphAxis) -> PendingSum:
    """Issue the cross-rank sum of ``t`` now and finish it later."""
    return PendingSum(t, axis)


def graph_sum(t: Tensor, axis: Optional[GraphAxis]) -> Tensor:
    """``psum`` over the graph axis: every rank's ``t`` added in rank order,
    differentiable; ``t`` itself for ``axis=None`` or a one-rank axis."""
    if axis is None:
        return t
    return graph_sum_async(t, axis).wait()


class _Fanout(torch.autograd.Function):
    """``k`` views of one tensor whose cotangents add in index order."""

    @staticmethod
    def forward(ctx, t, k):
        return tuple(t.view_as(t) for _ in range(k))

    @staticmethod
    def backward(ctx, *gs):
        acc = gs[0]
        for g in gs[1:]:
            acc = acc + g
        return acc, None


def fanout(t: Tensor, k: int) -> tuple:
    """``k`` aliases of ``t``, one for each of its consumers: the gradient
    of ``t`` is then ``((g0 + g1) + g2) + …`` in that order, whatever order
    autograd visits the consumers in.  The two DistEGNN layer schedules
    create a layer's consumers of ``x`` and ``h`` in different orders; this
    keeps their gradients bitwise equal."""
    if not t.requires_grad:
        return (t,) * k
    return _Fanout.apply(t, k)


class PendingParts:
    """Several tensors summed over the axis as one packed collective:
    :meth:`wait` returns them reduced, in their shapes.  With no axis (or
    a one-rank axis) the tensors come back as they are."""

    def __init__(self, parts: tuple, axis: Optional[GraphAxis]):
        self.parts = tuple(parts)
        self.pending = None
        if axis is not None and axis.size > 1:
            flat = torch.cat([p.reshape(-1) for p in self.parts])
            self.pending = graph_sum_async(flat, axis)

    def wait(self) -> tuple:
        if self.pending is None:
            return self.parts
        flat, out, i = self.pending.wait(), [], 0
        for p in self.parts:
            out.append(flat[i:i + p.numel()].reshape(p.shape))
            i += p.numel()
        return tuple(out)


def graph_sum_parts(parts: tuple, axis: Optional[GraphAxis]) -> tuple:
    """:func:`graph_sum` of several tensors in one collective."""
    return PendingParts(parts, axis).wait()


def max_across(values: list, axis: Optional[GraphAxis]) -> list:
    """Elementwise max of integer lists over the axis (exact, so any
    reduction order gives it)."""
    if axis is None or axis.size == 1 or not values:
        return [int(v) for v in values]
    import torch.distributed as dist

    dev = axis.device if axis.backend == "nccl" else torch.device("cpu")
    t = torch.tensor([int(v) for v in values], dtype=torch.int64, device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=axis.group)
    return [int(v) for v in t.tolist()]


def gather_across(t: Tensor, axis: Optional[GraphAxis]) -> list:
    """Every rank's ``t`` (one shape on every rank), in rank order, outside
    autograd; ``[t]`` on no axis or a one-rank axis."""
    if axis is None or axis.size == 1:
        return [t]
    bufs, _ = _gather(t, axis, async_op=False)
    return bufs


def max_across_f32(t: Tensor, axis: Optional[GraphAxis]) -> Tensor:
    """Elementwise max over the axis of non-negative f32 values, exact.

    The values go as their int32 bit patterns, which order as non-negative
    floats do (NaN is first made +inf, which loses no comparison it
    should win), reduced as int64 MAX: what gloo is known to reduce on
    CUDA tensors (``tools/collective_probe.py``)."""
    t = torch.nan_to_num(t, nan=float("inf"))
    if axis is None or axis.size == 1:
        return t
    import torch.distributed as dist

    bits = t.contiguous().view(torch.int32).to(torch.int64)
    dist.all_reduce(bits, op=dist.ReduceOp.MAX, group=axis.group)
    return bits.to(torch.int32).view(torch.float32)
