"""Collectives over one axis of a mesh, seen from one rank.

JAX runs its multi-device paths from one controller that sees every
device, and XLA inserts the collectives (``lax.ppermute``, ``psum``, the
all-gather behind an output spec). The port runs one process per rank,
each running the same host loop, and moves data between ranks through a
:class:`Comm`:

* :class:`LocalComm`, one rank: every collective is the identity;
* :class:`DistComm`, a ``torch.distributed`` process group: NCCL on the
  card, gloo on the CPU. Gloo has ``broadcast`` and ``all_reduce`` for
  CUDA tensors and nothing else, so under gloo the other collectives of a
  CUDA tensor go through pinned host memory: the choice is made from the
  backend and the tensor's device, never by catching an error;
* :class:`ThreadComm`, n ranks as n threads of one process (the CPU
  tests run every shard coordinate of a path this way, with no process
  group).

Sums (:meth:`Comm.all_reduce_sum`: gradients and batch statistics) give
every rank the same bits. A process group sums with its backend's
``all_reduce``, in the backend's order (NCCL's ring moves about
2 (n-1)/n of the tensor a rank); threads add the ranks' tensors in rank
order. The two orders round float32 differently, so a thread run and a
gloo run of the same inputs agree to float32 rounding, not bit for bit.
"""

from __future__ import annotations

import threading
from typing import List, Optional

import torch
import torch.distributed as dist

# the gloo collectives that take CUDA tensors
_GLOO_CUDA_OPS = ("broadcast", "all_reduce")


class Comm:
    """``rank`` of ``size`` along one mesh axis. The collectives below
    are built on three primitives: ``_all_gather`` (equal shapes),
    ``_gather`` (equal shapes, to ``root``) and ``_broadcast``."""

    rank = 0
    size = 1

    def all_gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's ``t`` (equal shapes), in rank order."""
        return self._all_gather(t.contiguous())

    def gather_v(self, t: torch.Tensor, root: int = 0
                 ) -> Optional[List[torch.Tensor]]:
        """Every rank's ``t`` (first dims may differ) on ``root``, in rank
        order; None on the other ranks."""
        sizes = self._sizes(t)
        parts = self._gather(_pad_rows(t, max(sizes)), root)
        if parts is None:
            return None
        return [p[:n] for p, n in zip(parts, sizes)]

    def broadcast(self, t: torch.Tensor, root: int = 0) -> torch.Tensor:
        """``root``'s ``t`` on every rank, written into ``t``."""
        self._broadcast(t, root)
        return t

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over the ranks (the same bits on every rank), here
        added in rank order."""
        parts = self._all_gather(t.contiguous())
        out = parts[0].clone()
        for p in parts[1:]:
            out += p
        return out

    def _sizes(self, t: torch.Tensor) -> List[int]:
        n = torch.tensor([t.shape[0]], dtype=torch.int64, device=t.device)
        return [int(s) for s in torch.cat(self._all_gather(n)).tolist()]


def _pad_rows(t: torch.Tensor, rows: int) -> torch.Tensor:
    t = t.contiguous()
    if t.shape[0] == rows:
        return t
    out = t.new_zeros((rows,) + tuple(t.shape[1:]))
    out[:t.shape[0]] = t
    return out


class LocalComm(Comm):
    """One rank: the mesh of one device when no process group is up.
    (A process group of one rank still runs its collectives: on the card
    that is NCCL at world size 1.)"""

    def _all_gather(self, t):
        return [t]

    def _gather(self, t, root):
        return [t]

    def _broadcast(self, t, root):
        pass


class DistComm(Comm):
    """A ``torch.distributed`` process group as a mesh axis."""

    def __init__(self, group):
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.backend = str(dist.get_backend(group)).lower()

    def _global(self, rank: int) -> int:
        return dist.get_global_rank(self.group, rank)

    def _host_staged(self, t: torch.Tensor, op: str) -> bool:
        return (t.is_cuda and self.backend == "gloo"
                and op not in _GLOO_CUDA_OPS)

    def _all_gather(self, t):
        if self._host_staged(t, "all_gather"):
            return [p.to(t.device, non_blocking=True)
                    for p in self._all_gather(_pinned(t))]
        out = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(out, t, group=self.group)
        return out

    def _gather(self, t, root):
        if self._host_staged(t, "gather"):
            parts = self._gather(_pinned(t), root)
            return None if parts is None else [
                p.to(t.device, non_blocking=True) for p in parts]
        out = ([torch.empty_like(t) for _ in range(self.size)]
               if self.rank == root else None)
        dist.gather(t, out, dst=self._global(root), group=self.group)
        return out

    def _broadcast(self, t, root):
        dist.broadcast(t, src=self._global(root), group=self.group)

    def all_reduce_sum(self, t):
        out = t.contiguous().clone()
        dist.all_reduce(out, group=self.group)
        return out


def _pinned(t: torch.Tensor) -> torch.Tensor:
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host


class ThreadHub:
    """The meeting point of ``size`` threads that act as ranks. A rank
    that fails calls :meth:`abort`, so the others fail at their next
    collective instead of waiting out the timeout."""

    def __init__(self, size: int, timeout: float = 60.0):
        self.size = size
        self.slots: List[Optional[torch.Tensor]] = [None] * size
        self.barrier = threading.Barrier(size, timeout=timeout)

    def abort(self) -> None:
        self.barrier.abort()


class ThreadComm(Comm):
    """Rank ``rank`` of a :class:`ThreadHub`."""

    def __init__(self, hub: ThreadHub, rank: int):
        self.hub = hub
        self.rank = rank
        self.size = hub.size

    def _exchange(self, t: torch.Tensor) -> List[torch.Tensor]:
        hub = self.hub
        hub.slots[self.rank] = t
        hub.barrier.wait()
        out = [s.clone() for s in hub.slots]
        hub.barrier.wait()          # nobody writes before all have read
        return out

    def _all_gather(self, t):
        return self._exchange(t)

    def _gather(self, t, root):
        parts = self._exchange(t)
        return parts if self.rank == root else None

    def _broadcast(self, t, root):
        t.copy_(self._exchange(t)[root])


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks whose gradient is the sum of the ranks'
    gradients: the batch statistics of a batch norm under data
    parallelism."""

    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return comm.all_reduce_sum(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.comm.all_reduce_sum(grad.contiguous()), None


def all_reduce_sum_ad(x: torch.Tensor, comm: Comm) -> torch.Tensor:
    """:meth:`Comm.all_reduce_sum` with a gradient."""
    return _AllReduceSum.apply(x, comm)
