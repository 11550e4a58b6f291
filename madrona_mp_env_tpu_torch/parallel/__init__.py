"""Data parallelism over torch.distributed (the JAX package's parallel/):
the world-sharded env and the replicated learner of sharding.py, the
process-group setup of distributed.py and the collectives the trainer
reduces with (collectives.py)."""

from .collectives import (all_mean, all_sum, barrier, broadcast,
                          check_replicated, gather_worlds)
from .distributed import (free_init_method, global_init, global_mesh,
                          init_distributed, launch)
from .sharding import (TRAIN_STATE_LAYOUT, Blocks, DataMesh, make_data_mesh,
                       shard_env_state, shard_train_state, world_slice)

__all__ = [
    "Blocks",
    "DataMesh",
    "TRAIN_STATE_LAYOUT",
    "all_mean",
    "all_sum",
    "barrier",
    "broadcast",
    "check_replicated",
    "free_init_method",
    "gather_worlds",
    "global_init",
    "global_mesh",
    "init_distributed",
    "launch",
    "make_data_mesh",
    "shard_env_state",
    "shard_train_state",
    "world_slice",
]
