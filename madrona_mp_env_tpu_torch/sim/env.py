"""Batched environment wrapper (the SimManager + Manager of the reference,
src/bindings.cpp:38-108, src/mgr.cpp).

    env = Env(cfg, scene_dir, num_worlds=1024, seed=5)   # on the GPU
    state, obs = env.reset()
    state, out = env.step(state, actions)

The state is a WorldState of [num_worlds, ...] tensors on ``env.device``;
``step`` runs the whole batch eagerly. ``device=None`` means the first
CUDA device and raises when there is none; pass ``device="cpu"`` to run
the plain PyTorch versions of the kernels on the CPU.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from .. import consts
from ..config import EnvConfig, RewardMode, SimFlags, Task
from ..assets.map_data import load_map
from ..utils import rng
from . import step as step_mod
from .types import Actions, WorldState, init_world_state

# configuration this port runs; everything else raises at construction
_PORTED_FLAGS = (SimFlags.StaggerStarts | SimFlags.RandomFlipTeams
                 | SimFlags.SimEvalMode | SimFlags.NavmeshSpawn
                 | SimFlags.NoRespawn)


def _check_ported(cfg: EnvConfig) -> None:
    if cfg.task != Task.Zone or cfg.reward_mode != RewardMode.Default:
        raise NotImplementedError(
            "the PyTorch port runs Task.Zone with RewardMode.Default only"
        )
    extra = SimFlags(cfg.sim_flags & ~_PORTED_FLAGS)
    if extra:
        raise NotImplementedError(f"not ported: {extra!r}")


def resolve_device(device=None) -> torch.device:
    """None -> the first CUDA device, raising without one."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the plain "
                "PyTorch path on the CPU"
            )
        device = "cuda"
    return torch.device(device)


class Env:
    """Batched multiplayer FPS environment (Zone task)."""

    def __init__(self, cfg: EnvConfig, scene_dir: str, num_worlds: int,
                 seed: int = 5, device=None):
        _check_ported(cfg)
        self.cfg = cfg
        self.num_worlds = num_worlds
        self.device = resolve_device(device)
        self.map_data = load_map(scene_dir, cfg, device=self.device)
        self.init_key = rng.prng_key(seed, device=self.device)

    def init_state(self) -> WorldState:
        """Blank pre-reset state of all worlds."""
        return init_world_state(self.cfg, self.map_data.num_goal_regions,
                                self.num_worlds, device=self.device)

    def default_sim_ctrl(self) -> Tuple[int, ...]:
        """TrainControl [evalMode, randomizeEpisodeLength,
        randomizeTeamSides] (reference mgr.cpp:1397-1413)."""
        f = self.cfg.has_flag
        return (int(f(SimFlags.SimEvalMode)), int(f(SimFlags.StaggerStarts)),
                int(f(SimFlags.RandomFlipTeams)))

    def reset(self, sim_ctrl: Optional[Sequence[int]] = None
              ) -> Tuple[WorldState, Dict[str, torch.Tensor]]:
        sim_ctrl = self._ctrl(sim_ctrl)
        return step_mod.init_and_observe(
            self.cfg, self.map_data, self.init_state(), self.init_key,
            sim_ctrl,
        )

    def step(self, state: WorldState, actions: Actions,
             sim_ctrl: Optional[Sequence[int]] = None,
             force_reset: Optional[torch.Tensor] = None):
        if bool((state.policy_idx == consts.a_star_policy_id).any()):
            raise NotImplementedError("the scripted A* bot is not ported")
        if force_reset is None:
            force_reset = torch.zeros(self.num_worlds, dtype=torch.int32,
                                      device=self.device)
        return step_mod.step_batched(
            self.cfg, self.map_data, state, actions, self.init_key,
            self._ctrl(sim_ctrl), force_reset,
        )

    def zero_actions(self) -> Actions:
        return Actions.zeros(self.num_worlds, self.cfg.num_agents,
                             device=self.device)

    def _ctrl(self, sim_ctrl) -> Tuple[int, ...]:
        if sim_ctrl is None:
            return self.default_sim_ctrl()
        return tuple(int(x) for x in sim_ctrl)
