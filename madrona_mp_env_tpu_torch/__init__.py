"""madrona_mp_env_tpu_torch: the PyTorch + CUDA port of madrona_mp_env_tpu.

The batched Zone env step on an NVIDIA Hopper GPU. Plain tensor code is
PyTorch with [W, A, ...] batch dimensions; every ray / sphere-cast sweep
on the step's path is a hand-written CUDA kernel (``csrc/``, built with
nvcc for sm_90a on first use) with its plain PyTorch version beside it,
which the CPU runs. The JAX package beside this one is the reference the
port is tested against; this package imports neither JAX nor it.
"""

from .config import EnvConfig, RewardMode, SimFlags, Task, WeaponStats
from .sim.env import Env
from .sim.types import Actions, WorldState

__all__ = [
    "Actions",
    "Env",
    "EnvConfig",
    "RewardMode",
    "SimFlags",
    "Task",
    "WeaponStats",
    "WorldState",
]
