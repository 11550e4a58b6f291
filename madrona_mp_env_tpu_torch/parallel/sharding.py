"""World sharding for data parallelism (the JAX package's
parallel/sharding.py).

Worlds never talk to each other in the sim, so scale-out is pure data
parallelism: one process per rank, rank r of N owning the W / N
consecutive worlds [r W / N, (r + 1) W / N) on its own device, stepped by
``Env(num_worlds=W / N, world_offset=r W / N)`` bit for bit as the whole
batch would step them. The policy parameters, the optimizer state and
the normalizer are replicated; the trainer reduces across ranks by hand
(parallel/collectives.py) wherever the one-process update reduces over
worlds or actors.

``TRAIN_STATE_LAYOUT`` is the per-field table of JAX's
``train_state_shardings``: the env state, the current observations and
the assignment follow the world axis, both recurrent states the actor
axis of their policy blocks, and everything else (the block tables
``train_perm`` / ``past_perm`` included, which index the global flat
actor axis) is replicated. A rank's share of a policy block is ragged:
``Blocks`` holds which of its actors sit in each block.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, List, Optional, Tuple

import torch

# TrainState fields held per rank: "worlds" along the world axis (dim 0),
# "actors" along the policy-block actor axis; every other field is
# replicated
TRAIN_STATE_LAYOUT = {
    "env_state": "worlds",
    "cur_obs": "worlds",
    "assignment": "worlds",
    "rnn_states": "actors",
    "past_rnn_states": "actors",
}


@dataclass(frozen=True)
class DataMesh:
    """A 1-D data mesh: ``size`` ranks of ``group`` (a torch.distributed
    process group; None with one process) sharing ``num_worlds`` worlds,
    this process being ``rank``."""

    num_worlds: int
    rank: int = 0
    size: int = 1
    group: Any = None

    def __post_init__(self):
        if self.num_worlds % self.size:
            raise ValueError(f"{self.num_worlds} worlds do not shard over "
                             f"{self.size} ranks")
        if not 0 <= self.rank < self.size:
            raise ValueError(f"rank {self.rank} of {self.size}")

    @property
    def local_worlds(self) -> int:
        return self.num_worlds // self.size

    @property
    def world_lo(self) -> int:
        return self.rank * self.local_worlds

    @property
    def world_hi(self) -> int:
        return self.world_lo + self.local_worlds


def make_data_mesh(num_worlds: int, group=None) -> DataMesh:
    """The mesh of ``group``'s ranks (this process must be one of them);
    ``group`` None: one process. Raises ValueError unless the ranks
    divide ``num_worlds``, as JAX's device_put of a world-sharded array
    does."""
    if group is None:
        return DataMesh(num_worlds)
    import torch.distributed as dist

    return DataMesh(num_worlds, dist.get_rank(group),
                    dist.get_world_size(group), group)


def world_slice(mesh: DataMesh) -> slice:
    """This rank's worlds of the global world axis."""
    return slice(mesh.world_lo, mesh.world_hi)


def shard_env_state(mesh: DataMesh, env_state):
    """This rank's worlds of a global WorldState [W, ...]."""
    return dataclasses.replace(env_state, **{
        k: v[world_slice(mesh)] for k, v in env_state.leaves().items()})


class Blocks:
    """One process's view of a policy-block table ``perm`` [n, size] (the
    global flat actor index of each member of each block).

    With the whole actor range (one process) the layout is the JAX
    package's, [n, size, ...]. A rank keeps the members it owns, block by
    block in table order, on one ragged axis [N, ...]: ``counts`` per
    block, ``loc`` [N] their local flat actor indices, ``rows`` [N] their
    rows ``e * size + j`` of the global table (their share of a global
    draw or minibatch), ``inv`` [n * size] the local member of each
    global row or -1. ``identity``: the table is every actor of the range
    in index order (one train policy, no acting past policy)."""

    def __init__(self, perm: torch.Tensor, identity: bool = False,
                 lo: Optional[int] = None, hi: Optional[int] = None):
        self.perm = perm
        self.n, self.size = perm.shape[0], perm.shape[1]
        self.identity = identity
        self.counts: Optional[List[int]] = None
        if lo is None:
            return
        flat = perm.reshape(-1)
        own = (flat >= lo) & (flat < hi)
        self.rows = torch.nonzero(own).reshape(-1)
        self.loc = flat[self.rows] - lo
        self.counts = own.reshape(self.n, self.size).sum(1).tolist()
        self.inv = torch.full((flat.numel(),), -1, dtype=torch.int64,
                              device=perm.device)
        self.inv[self.rows] = torch.arange(self.rows.numel(),
                                           device=perm.device)

    @property
    def ragged(self) -> bool:
        return self.counts is not None

    @property
    def shape(self) -> Tuple[int, ...]:
        """The leading axes of this process's block tensors."""
        return (sum(self.counts),) if self.ragged else (self.n, self.size)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """[W, A, ...] (this process's worlds) -> block layout."""
        tail = x.shape[2:]
        flat = x.reshape((-1,) + tail)
        if self.identity:
            return flat if self.ragged else flat.reshape((1, -1) + tail)
        return flat[self.loc] if self.ragged else flat[self.perm]

    def scatter(self, flat: torch.Tensor, b: torch.Tensor) -> None:
        """Write block-layout values ``b`` into flat actors [W * A, ...]."""
        if self.ragged:
            flat[self.loc] = b
        else:
            flat[self.perm.reshape(-1)] = b.reshape((-1,) + b.shape[2:])

    def split(self, x: torch.Tensor, dim: int = 0) -> List[torch.Tensor]:
        """The blocks of a ragged ``x`` along its block axis ``dim``."""
        return list(x.split(self.counts, dim))

    def join(self, parts: List[torch.Tensor], dim: int = 0) -> torch.Tensor:
        """``split``'s inverse."""
        return torch.cat(parts, dim)


def shard_train_state(mesh: DataMesh, ts):
    """This rank's share of a one-process TrainState, as TRAIN_STATE_LAYOUT
    says: the world-axis fields sliced, each recurrent state's members of
    this rank (Blocks order), the rest as it is."""
    A = ts.assignment.shape[1]
    lo, hi = mesh.world_lo * A, mesh.world_hi * A
    out = {}
    for name, kind in TRAIN_STATE_LAYOUT.items():
        x = getattr(ts, name)
        if kind == "worlds":
            out[name] = (shard_env_state(mesh, x) if name == "env_state"
                         else {k: v[world_slice(mesh)] for k, v in x.items()}
                         if isinstance(x, dict) else x[world_slice(mesh)])
        else:
            perm = ts.train_perm if name == "rnn_states" else ts.past_perm
            rows = Blocks(perm, lo=lo, hi=hi).rows
            out[name] = x.reshape(x.shape[:2] + (perm.numel(),
                                                 x.shape[-1]))[:, :, rows]
    return dataclasses.replace(ts, **out)
