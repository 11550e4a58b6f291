"""The collectives a data-parallel trainer needs over a DataMesh: a sum,
a mean, a gather of the world axis to every rank, a broadcast, a check
that replicated state agrees and a barrier. All but the barrier are
written with ``all_reduce`` and ``broadcast`` alone, the two collectives
gloo runs on CUDA tensors, so a group of ranks on one card (gloo) runs
the same code as NCCL across cards. On a mesh of one rank none calls a
collective, and the sum, the gather and the broadcast return their
input."""

from __future__ import annotations

from typing import Iterable

import torch

from .sharding import DataMesh


def _dist():
    import torch.distributed as dist

    return dist


def all_sum(mesh: DataMesh, x: torch.Tensor) -> torch.Tensor:
    """The elementwise sum of ``x`` over the ranks (a new tensor)."""
    if mesh.size == 1:
        return x
    y = x.contiguous().clone()
    _dist().all_reduce(y, group=mesh.group)
    return y


def all_mean(mesh: DataMesh, x: torch.Tensor, count) -> torch.Tensor:
    """The mean of values of which each rank holds the sum ``x``, over
    ``count`` values in all."""
    if mesh.size == 1:
        return x / count
    return all_sum(mesh, x) / count


def gather_worlds(mesh: DataMesh, x: torch.Tensor,
                  dim: int = 0) -> torch.Tensor:
    """Every rank's share [..., W / N, ...] of a world axis at ``dim``
    into the global [..., W, ...] on every rank: each rank writes its
    worlds into zeros and the ranks sum. Exact for integer and boolean
    tensors; a float -0.0 comes back as +0.0."""
    if mesh.size == 1:
        return x
    dtype = x.dtype
    if dtype == torch.bool:
        x = x.to(torch.int32)
    shape = list(x.shape)
    shape[dim] = mesh.num_worlds
    out = torch.zeros(shape, dtype=x.dtype, device=x.device)
    out.narrow(dim, mesh.world_lo, mesh.local_worlds).copy_(x)
    _dist().all_reduce(out, group=mesh.group)
    return out.to(torch.bool) if dtype == torch.bool else out


def broadcast(mesh: DataMesh, x: torch.Tensor, src: int = 0) -> torch.Tensor:
    """Rank ``src``'s ``x`` on every rank (a new tensor): where ranks
    compute a replicated value by an order that is not fixed (atomics),
    one rank's result is taken."""
    if mesh.size == 1:
        return x
    dist = _dist()
    y = x.contiguous().clone()
    dist.broadcast(y, src=dist.get_global_rank(mesh.group, src)
                   if mesh.group is not None else src, group=mesh.group)
    return y


def barrier(mesh: DataMesh) -> None:
    if mesh.size > 1:
        _dist().barrier(group=mesh.group)


def check_replicated(mesh: DataMesh, tensors: Iterable[torch.Tensor],
                     what: str) -> None:
    """Raise RuntimeError unless every rank holds the same ``tensors``
    (compared by a float64 digest of each against rank 0's)."""
    if mesh.size == 1:
        return
    digest = torch.stack([t.detach().to(torch.float64).sum()
                          + t.detach().to(torch.float64).abs().sum() * 1e-3
                          for t in tensors])
    if not torch.equal(broadcast(mesh, digest), digest):
        raise RuntimeError(f"rank {mesh.rank} disagrees with rank 0 on "
                           f"the replicated {what}")
