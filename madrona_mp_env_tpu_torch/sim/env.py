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
from ..config import EnvConfig, SimFlags
from ..assets.map_data import MapData, load_map, map_key
from ..utils import rng
from . import step as step_mod
from .types import Actions, WorldState, init_world_state

_DEFAULT_TRAJECTORY_PROB = EnvConfig.__dataclass_fields__[
    "trajectory_curriculum_prob"].default


def _check_config(cfg: EnvConfig, curriculum_path) -> None:
    """Every flag and field of the JAX package's Env runs here
    (StaticFlipTeams, as there, is read by no system) but the trajectory
    curriculum restore, which needs the data pipeline; and the full-team
    interface needs two teams, which Explore's one agent is not (the JAX
    package's team reshape fails there)."""
    if (curriculum_path is not None or cfg.trajectory_curriculum_prob
            != _DEFAULT_TRAJECTORY_PROB):
        raise NotImplementedError(
            "the trajectory curriculum restore (curriculum_path, "
            "trajectory_curriculum_prob) is not ported: ROADMAP Queue 1 "
            "item 7")
    if cfg.has_flag(SimFlags.FullTeamPolicy) and cfg.num_agents != (
            2 * cfg.team_size):
        raise ValueError("SimFlags.FullTeamPolicy needs two full teams; "
                         f"{cfg.task.name} has {cfg.num_agents} agent(s)")


def _check_spawn_tables(m) -> None:
    """The spawn-usage tables hold consts.max_spawns boxes a side. The
    mid-map extras of SpawnInMiddle overflow them on both bundled maps
    (208 and 196 boxes); the JAX package's initial spawn fails there too
    (a broadcast of the 128-wide table against the boxes)."""
    ns = m.side_spawns.shape[1]
    if ns > consts.max_spawns:
        raise ValueError(
            f"{ns} spawn boxes on a side ({m.num_extra_side_spawns.tolist()} "
            f"from SpawnInMiddle) exceed the usage tables' "
            f"{consts.max_spawns}")


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
    """Batched multiplayer FPS environment (every Task, RewardMode and
    SimFlag, the spawn curriculum; ``curriculum_path`` raises)."""

    def __init__(self, cfg: EnvConfig, scene_dir: str, num_worlds: int,
                 seed: int = 5, device=None,
                 map_data: Optional[MapData] = None,
                 curriculum_path: Optional[str] = None):
        """``map_data``: a map that load_map loaded on ``device`` for a
        configuration of the same map_key, shared instead of loading
        ``scene_dir`` again; raises ValueError on another key or kind of
        device."""
        _check_config(cfg, curriculum_path)
        self.cfg = cfg
        self.num_worlds = num_worlds
        self.device = resolve_device(device)
        if map_data is None:
            map_data = load_map(scene_dir, cfg, device=self.device)
        elif (map_data.key != map_key(scene_dir, cfg)
              or map_data.world_min.device.type != self.device.type):
            raise ValueError("map_data was loaded for another scene, "
                             "map configuration or device")
        self.map_data = map_data
        _check_spawn_tables(self.map_data)
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
