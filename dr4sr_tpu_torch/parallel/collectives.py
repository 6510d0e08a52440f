"""Collectives over one mesh axis, and the gradients JAX's autodiff gives them.

JAX differentiates ``psum``, ``all_gather`` and ``ppermute`` itself; here
each differentiable collective is a ``torch.autograd.Function`` whose
backward rule is written out:

* :func:`all_reduce_sum` — forward: the sum over the axis. Backward:
  identity. Every rank of the axis then holds the same sum and computes
  the same loss from it, so the cotangent each rank receives already is
  the whole cotangent of the sum; summing it over the axis again (what
  ``torch.distributed.nn.all_reduce`` does in its backward) would scale
  the gradient by the axis size. This is JAX's rule for a ``psum`` whose
  result is used replicated (``ep_gather``'s, ``parallel/ep.py``).
* :func:`gather_seq` — forward: all-gather of the ranks' chunks along
  ``dim``, in rank order. Backward: the rank's own chunk of the (replicated)
  cotangent, no communication. Right where every rank of the axis computes
  the same loss from the gathered tensor (CP's ``model`` group, the EP
  table that the graph models propagate).
* :func:`split_seq` — forward: the rank's chunk along ``dim`` of a
  replicated tensor, no communication. Backward: all-gather of the chunks'
  cotangents.
* :func:`gather_rows` — forward: all-gather of the ranks' rows along
  ``dim``, in rank order (as :func:`gather_seq`). Backward: the sum over the
  axis of the ranks' cotangents, then this rank's rows (a reduce-scatter,
  made as an all-reduce and the rank's chunk): JAX's transpose of
  ``all_gather``. This is the rule under data parallelism, where each rank's
  loss is its own share of the global loss: rank r's rows are negatives in
  rank s's InfoNCE, so s's cotangent of r's rows must reach r.
  :func:`gather_seq`'s rule would drop it silently, and the gradient
  all-reduce that follows sums parameter gradients only.

Each backward is itself made of these functions, so a second derivative
(DR4SR+'s Hessian-vector products, ``create_graph=True``) differentiates
it: :func:`gather_seq` and :func:`split_seq` are each other's transpose,
so are :func:`gather_rows` and the reduce-scatter, and the transpose of
:func:`all_reduce_sum`'s identity is the sum of the ranks' cotangents. That
last one moves data only in a second derivative, where the ranks'
cotangents of a replicated sum differ: under EP each ``model`` rank's
share of a Hessian-vector product reaches the gathered embeddings only
through its own table rows, and the whole cotangent is their sum.

The plain collectives below (:func:`all_reduce_`, :func:`all_gather`,
:func:`broadcast_`, :func:`gather_objects`, :func:`ring_exchange`) take no
gradient.

Every call adds to :data:`COUNTER`, by kind and axis, its calls and the
bytes of its result on this rank (an all-reduce: the tensor; an all-gather:
the gathered tensor; a ring exchange: the tensors sent). The tests read the
counter where the JAX package's tests read collective ops out of the
compiled HLO. A call made while a CUDA graph captures runs at each replay,
not at the capture: ``ops/graphs.py::CudaGraphs`` takes the capture's counts
back out (:meth:`CollectiveCounter.counts`, :meth:`CollectiveCounter.restore`)
and adds them at every replay (:meth:`CollectiveCounter.add_counts`).

Under NCCL every collective here can be captured: a collective orders the
NCCL stream after the current one and back by events, and ``work.wait()``
makes the current stream wait; nothing waits on the host or allocates
host memory. The communicators must exist before a capture, which a
step run once eagerly makes.

A world of one (``Axis.size == 1``) makes no call and counts nothing.

Point-to-point sends of CUDA tensors go through pinned host memory when the
axis's backend is gloo (decided by the backend's name, never by catching an
error): gloo's send and receive take host memory. Every other collective
takes the tensors where they are. gloo stages CUDA tensors through the
host in its collectives too, so no gloo collective of CUDA tensors can be
captured (``train.fused.capture_refusal`` refuses the configuration).
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Axis:
    """One axis of the mesh as this rank sees it: its name, process group
    (None for a world of one), size, this rank's index on it, and the global
    ranks of the group in index order."""

    name: str
    group: Optional[dist.ProcessGroup] = None
    size: int = 1
    index: int = 0
    ranks: Tuple[int, ...] = (0,)

    @property
    def backend(self) -> Optional[str]:
        return None if self.group is None else str(dist.get_backend(self.group))

    def chunk(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's contiguous 1/size of ``x`` along ``dim``."""
        n = x.shape[dim]
        if n % self.size:
            raise ValueError(f"axis {self.name!r} of size {self.size} does not divide {n}")
        c = n // self.size
        return x.narrow(dim, self.index * c, c)


LOCAL = Axis("local")  # the axis of one rank: every collective is the identity


class CollectiveCounter:
    """Calls and result bytes of each kind of collective, by axis."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.calls: Dict[Tuple[str, str], int] = defaultdict(int)
        self.bytes: Dict[Tuple[str, str], int] = defaultdict(int)

    def add(self, kind: str, axis: Axis, nbytes: int) -> None:
        self.calls[(kind, axis.name)] += 1
        self.bytes[(kind, axis.name)] += int(nbytes)

    def counts(self) -> Tuple[Dict[Tuple[str, str], int], Dict[Tuple[str, str], int]]:
        """Copies of the calls and the bytes, by (kind, axis)."""
        return dict(self.calls), dict(self.bytes)

    def restore(self, counts) -> None:
        """The counts back to ``counts`` (:meth:`counts`)."""
        self.calls, self.bytes = defaultdict(int, counts[0]), defaultdict(int, counts[1])

    def add_counts(self, counts) -> None:
        """``counts`` (calls and bytes by (kind, axis)) added."""
        for mine, theirs in zip((self.calls, self.bytes), counts):
            for key, n in theirs.items():
                mine[key] += n

    def snapshot(self) -> Dict[str, Dict[str, int]]:
        """``{"<kind>:<axis>": {"calls": n, "bytes": b}}``."""
        return {f"{kind}:{axis}": {"calls": self.calls[(kind, axis)],
                                   "bytes": self.bytes[(kind, axis)]}
                for kind, axis in sorted(self.calls)}


COUNTER = CollectiveCounter()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def all_reduce_(t: torch.Tensor, axis: Axis, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce of ``t`` over ``axis`` (sum by default); no gradient."""
    if axis.size > 1:
        dist.all_reduce(t, op=op, group=axis.group)
        COUNTER.add("all_reduce", axis, _nbytes(t))
    return t


def all_gather(t: torch.Tensor, axis: Axis, dim: int = 0) -> torch.Tensor:
    """The ranks' ``t`` concatenated along ``dim`` in rank order; no gradient."""
    if axis.size == 1:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(axis.size)]
    dist.all_gather(parts, t, group=axis.group)
    out = torch.cat(parts, dim=dim)
    COUNTER.add("all_gather", axis, _nbytes(out))
    return out


def broadcast_(t: torch.Tensor, axis: Axis, src_index: int = 0) -> torch.Tensor:
    """``t`` of the rank at ``src_index`` on the axis, in place on every rank."""
    if axis.size > 1:
        dist.broadcast(t, src=axis.ranks[src_index], group=axis.group)
        COUNTER.add("broadcast", axis, _nbytes(t))
    return t


def gather_objects(obj, axis: Axis) -> list:
    """Every rank's picklable ``obj``, in rank order (a checkpoint's
    per-rank generator states); counts its calls, not its bytes."""
    if axis.size == 1:
        return [obj]
    out = [None] * axis.size
    dist.all_gather_object(out, obj, group=axis.group)
    COUNTER.add("gather_objects", axis, 0)
    return out


def stages_through_host(axis: Axis, t: torch.Tensor) -> bool:
    """Whether :func:`ring_exchange` copies ``t`` through pinned host memory:
    a CUDA tensor on a gloo axis."""
    return t.is_cuda and axis.backend == "gloo"


def ring_exchange(tensors: Sequence[torch.Tensor], axis: Axis) -> List[torch.Tensor]:
    """Send each tensor to the next rank of the ring (index + 1) and receive
    the previous rank's, in one batch of point-to-point operations; returns
    the received tensors (new storage). No gradient."""
    if axis.size == 1:
        return [t.clone() for t in tensors]
    nxt = axis.ranks[(axis.index + 1) % axis.size]
    prv = axis.ranks[(axis.index - 1) % axis.size]
    ops, received = [], []
    for t in tensors:
        t = t.contiguous()
        staged = stages_through_host(axis, t)
        if staged and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"a ring exchange over the gloo axis {axis.name!r} stages "
                               f"through host memory, which a CUDA graph cannot hold")
        send = t.to("cpu").pin_memory() if staged else t
        recv = torch.empty(send.shape, dtype=send.dtype, device=send.device,
                           pin_memory=staged)
        ops.append(dist.P2POp(dist.isend, send, nxt, axis.group))
        ops.append(dist.P2POp(dist.irecv, recv, prv, axis.group))
        received.append((recv, t.device, staged))
        COUNTER.add("send", axis, _nbytes(t))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return [r.to(device, non_blocking=False) if staged else r for r, device, staged in received]


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return all_reduce_(x.clone(), axis)

    @staticmethod
    def backward(ctx, grad):
        if not torch.is_grad_enabled():  # a first derivative: the identity
            return grad, None
        return _SumOfCotangents.apply(grad, ctx.axis), None


class _SumOfCotangents(torch.autograd.Function):
    """The identity, whose backward sums over the axis: the transpose of
    :class:`_AllReduceSum`'s backward."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad, ctx.axis), None


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, grad):
        return _SplitSeq.apply(grad, ctx.axis, ctx.dim), None, None


class _SplitSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return axis.chunk(x, dim).contiguous()

    @staticmethod
    def backward(ctx, grad):
        return _GatherSeq.apply(grad, ctx.axis, ctx.dim), None, None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, grad):
        return _ReduceScatterRows.apply(grad, ctx.axis, ctx.dim), None, None


class _ReduceScatterRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return axis.chunk(all_reduce_(x.contiguous().clone(), axis), dim).contiguous()

    @staticmethod
    def backward(ctx, grad):
        return _GatherRows.apply(grad, ctx.axis, ctx.dim), None, None


def all_reduce_sum(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Sum over ``axis``; its gradient passes through unchanged (see above)."""
    if axis.size == 1:
        return x
    return _AllReduceSum.apply(x, axis)


def gather_seq(x: torch.Tensor, axis: Axis, dim: int = 2) -> torch.Tensor:
    """All-gather of the ranks' chunks along ``dim``; the gradient of each
    rank's chunk is its slice of the gathered tensor's gradient."""
    if axis.size == 1:
        return x
    return _GatherSeq.apply(x, axis, dim)


def split_seq(x: torch.Tensor, axis: Axis, dim: int = 2) -> torch.Tensor:
    """This rank's chunk along ``dim``; the gradient is all-gathered."""
    if axis.size == 1:
        return x
    return _SplitSeq.apply(x, axis, dim)


def gather_rows(x: torch.Tensor, axis: Axis, dim: int = 0) -> torch.Tensor:
    """All-gather of the ranks' rows along ``dim``; the gradient of each
    rank's rows is the sum over the axis of the gathered tensor's
    gradients, at this rank's rows (see above)."""
    if axis.size == 1:
        return x
    return _GatherRows.apply(x, axis, dim)
