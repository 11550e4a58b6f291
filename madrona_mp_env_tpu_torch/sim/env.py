"""Batched environment wrapper (the SimManager + Manager of the reference,
src/bindings.cpp:38-108, src/mgr.cpp).

    env = Env(cfg, scene_dir, num_worlds=1024, seed=5)   # on the GPU
    state, obs = env.reset()
    state, out = env.step(state, actions)

The state is a WorldState of [num_worlds, ...] tensors on ``env.device``;
``step`` runs the whole batch eagerly. ``device=None`` means the first
CUDA device and raises when there is none; pass ``device="cpu"`` to run
the plain PyTorch versions of the kernels on the CPU.

Record and replay: ``Env(..., collect_log=True)`` makes every step return
"step_log", "snapshot" and "game_events" (data/export.py; the writers of
data/recorder.py pack them), and ``replay_step`` drives the worlds from a
recorded step log (sim/replay.py). ``curriculum_path``: a
CurriculumSnapshot file (data/build_trajectory_curriculum.py) whose
snapshots a reset restores with probability
EnvConfig.trajectory_curriculum_prob outside eval mode (sim/reset.py).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from .. import consts
from ..config import EnvConfig, SimFlags
from ..assets.map_data import MapData, load_map, map_key
from ..utils import rng
from . import replay as replay_mod
from . import step as step_mod
from .types import Actions, WorldState, init_world_state


def _check_config(cfg: EnvConfig) -> None:
    """Every flag and field of the JAX package's Env runs here
    (StaticFlipTeams, as there, is read by no system); but the full-team
    interface needs two teams, which Explore's one agent is not (the JAX
    package's team reshape fails there)."""
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
    SimFlag, the spawn and trajectory curricula, record and replay)."""

    def __init__(self, cfg: EnvConfig, scene_dir: str, num_worlds: int,
                 seed: int = 5, device=None,
                 map_data: Optional[MapData] = None,
                 collect_log: bool = False,
                 curriculum_path: Optional[str] = None,
                 world_offset: int = 0):
        """``map_data``: a map that load_map loaded on ``device`` for a
        configuration of the same map_key (the curriculum file's
        snapshots included), shared instead of loading ``scene_dir``
        again; raises ValueError on another key or kind of device.
        ``world_offset``: the global number of the first world, for a
        data-parallel rank that steps worlds [world_offset, world_offset
        + num_worlds) of a larger batch (parallel/sharding.py); its
        resets and steps are those worlds' of the whole batch, bit for
        bit."""
        _check_config(cfg)
        self.cfg = cfg
        self.num_worlds = num_worlds
        self.world_offset = world_offset
        self.device = resolve_device(device)
        self.collect_log = collect_log
        snaps = None
        if curriculum_path is not None:
            from ..data.formats import load_curriculum_snapshots

            snaps = load_curriculum_snapshots(curriculum_path)
        if map_data is None:
            map_data = load_map(scene_dir, cfg, device=self.device,
                                curriculum_snapshots=snaps)
        elif (map_data.key != map_key(scene_dir, cfg, snaps)
              or map_data.world_min.device.type != self.device.type):
            raise ValueError("map_data was loaded for another scene, "
                             "map configuration, curriculum or device")
        self.map_data = map_data
        _check_spawn_tables(self.map_data)
        self.init_key = rng.prng_key(seed, device=self.device)

    def init_state(self) -> WorldState:
        """Blank pre-reset state of all worlds."""
        return init_world_state(self.cfg, self.map_data.num_goal_regions,
                                self.num_worlds, device=self.device,
                                world_offset=self.world_offset)

    def default_sim_ctrl(self, eval_mode: bool = False) -> Tuple[int, ...]:
        """TrainControl [evalMode, randomizeEpisodeLength,
        randomizeTeamSides] (reference mgr.cpp:1397-1413); in
        ``eval_mode`` (1, 0, 0)."""
        if eval_mode:
            return (1, 0, 0)
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
            self._ctrl(sim_ctrl), force_reset, collect_log=self.collect_log,
        )

    def replay_step(self, state: WorldState, step_log,
                    sim_ctrl: Optional[Sequence[int]] = None,
                    force_reset: Optional[torch.Tensor] = None):
        """Step every world from a recorded step log (tensors or numpy
        arrays, [num_worlds, 12, ...] and cur_step [num_worlds]: one step
        of data/recorder.py ReplayLogReader) instead of simulating it
        (pvpReplaySystem, reference sim.cpp:4794-4843); ``sim_ctrl``
        defaults to eval mode."""
        if sim_ctrl is None:
            sim_ctrl = self.default_sim_ctrl(eval_mode=True)
        if force_reset is None:
            force_reset = torch.zeros(self.num_worlds, dtype=torch.int32,
                                      device=self.device)
        log = {k: torch.as_tensor(v, device=self.device)
               for k, v in step_log.items()}
        return replay_mod.replay_step(
            self.cfg, self.map_data, state, log, self.init_key,
            self._ctrl(sim_ctrl), force_reset)

    def zero_actions(self) -> Actions:
        return Actions.zeros(self.num_worlds, self.cfg.num_agents,
                             device=self.device)

    def _ctrl(self, sim_ctrl) -> Tuple[int, ...]:
        if sim_ctrl is None:
            return self.default_sim_ctrl()
        return tuple(int(x) for x in sim_ctrl)
