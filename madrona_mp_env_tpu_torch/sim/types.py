"""Simulation state: dataclasses of batched tensors.

The reference's ECS schema (reference src/types.hpp) flattened into a
struct of arrays with a leading world axis: every leaf is [W, ...], per
agent [W, A, ...]. Dynamic ECS entities (breadcrumbs) become fixed pools.

uint32 leaves of the JAX package's state (explore bits, spawn usage steps,
episode counters, the episode key) are held in int64 tensors with values
in [0, 2^32); ``world_state_from_numpy`` / ``world_state_to_numpy`` carry
a state across from or to the JAX package's numpy leaves.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from .. import consts
from ..config import EnvConfig

OTHER_OB_DIM = 32  # PlayerCommon(23) + rel(5) + combat(4) / opp flags(4)
SELF_OB_DIM = 43  # width of the "self" observation

# explore grid bit-packing: 81 columns -> 3 x u32 words per row
EXPLORE_WORDS = (consts.explore_grid_width + 31) // 32

U32 = torch.int64  # holder dtype of uint32 leaves
_U32_LEAVES = {
    "explore_bits", "spawn_a_used", "spawn_b_used", "spawn_respawn_used",
    "episode_idx", "episode_counter", "episode_key",
}


class Pose:
    Stand = 0
    Crouch = 1
    Prone = 2


class WorldCurriculum:
    LearnShooting = 0
    FullMatch = 1


class _Leaves:
    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    def leaves(self) -> Dict[str, torch.Tensor]:
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)}


@dataclass
class Actions(_Leaves):
    """Per-agent actions [W, A] (reference src/types.hpp:173-193).

    discrete: moveAmount [0,2], moveAngle [0,7], fire {0: none, 1: fire,
    2: reload}, stand {0,1,2}; aim buckets yaw [0,12], pitch [0,6];
    continuous aim rates (rad/s) are zero for policy agents."""

    move_amount: torch.Tensor
    move_angle: torch.Tensor
    fire: torch.Tensor
    stand: torch.Tensor
    aim_yaw: torch.Tensor
    aim_pitch: torch.Tensor
    aim_yaw_rate: torch.Tensor
    aim_pitch_rate: torch.Tensor

    @classmethod
    def zeros(cls, num_worlds: int, num_agents: int, device=None):
        shape = (num_worlds, num_agents)

        def zi(v=0):
            return torch.full(shape, v, dtype=torch.int32, device=device)

        zf = torch.zeros(shape, dtype=torch.float32, device=device)
        return cls(
            move_amount=zi(), move_angle=zi(), fire=zi(), stand=zi(),
            aim_yaw=zi(consts.discrete_aim_num_yaw_buckets // 2),
            aim_pitch=zi(consts.discrete_aim_num_pitch_buckets // 2),
            aim_yaw_rate=zf, aim_pitch_rate=zf.clone(),
        )


@dataclass
class WorldState(_Leaves):
    """Full game state of W worlds; A = agents per world. Field meanings
    follow the JAX package's WorldState one for one."""

    # kinematics
    pos: torch.Tensor  # [W, A, 3]
    vel: torch.Tensor  # [W, A, 3]
    yaw: torch.Tensor  # [W, A]
    pitch: torch.Tensor
    stand_cur: torch.Tensor  # i32 Pose
    stand_tgt: torch.Tensor
    stand_transition: torch.Tensor
    max_vel: torch.Tensor
    # combat
    hp: torch.Tensor
    mag_bullets: torch.Tensor
    mag_reloading: torch.Tensor
    alive: torch.Tensor  # f32 0/1
    damage_dealt: torch.Tensor  # [W, A, team_size]
    respawn_steps: torch.Tensor
    autoheal_steps: torch.Tensor
    landed_shot_on: torch.Tensor
    successful_kill: torch.Tensor
    was_shot_count: torch.Tensor
    was_killed: torch.Tensor
    fired_shot_t: torch.Tensor
    in_zone: torch.Tensor
    min_dist_to_zone: torch.Tensor
    has_died: torch.Tensor
    reloaded_full_mag: torch.Tensor
    weapon_type: torch.Tensor
    aim_vel_yaw: torch.Tensor
    aim_vel_pitch: torch.Tensor
    # explore tracker
    start_pos: torch.Tensor  # [W, A, 3]
    explore_bits: torch.Tensor  # [W, A, 81, 3] u32 values
    new_cells: torch.Tensor
    # breadcrumbs
    crumb_pos: torch.Tensor  # [W, C, 3]
    crumb_penalty: torch.Tensor  # [W, C]
    crumb_team: torch.Tensor
    crumb_owner: torch.Tensor
    crumb_total_penalty: torch.Tensor  # [W, A]
    crumb_last: torch.Tensor
    crumb_steps_since: torch.Tensor
    # last-known opponent observations
    last_known_obs: torch.Tensor  # [W, A, team_size, 32]
    last_known_pos: torch.Tensor  # [W, A, team_size, 3]
    # previous-step sensor state
    prev_fwd_depth: torch.Tensor  # [W, A, 2, 32]
    prev_can_see: torch.Tensor  # [W, A, team_size]
    prev_teammate_vis: torch.Tensor
    was_reset: torch.Tensor  # [W] bool
    ft_last_known: torch.Tensor  # [W, 2, team_size, 14 + team_size]
    # match level
    team_a: torch.Tensor  # [W]
    cur_step: torch.Tensor
    is_finished: torch.Tensor
    win_result: torch.Tensor
    team_kills: torch.Tensor  # [W, 2]
    team_points: torch.Tensor
    zone_stats: torch.Tensor  # [W, max_zones, 5]
    subzone_ctrl: torch.Tensor  # [W, 8]
    subzone_contested: torch.Tensor
    in_subzone: torch.Tensor  # [W, A]
    min_dist_subzone: torch.Tensor
    zone_cur: torch.Tensor  # [W]
    zone_controlling: torch.Tensor
    zone_contested: torch.Tensor
    zone_captured: torch.Tensor
    zone_earned_point: torch.Tensor
    zone_steps_remaining: torch.Tensor
    zone_steps_until_point: torch.Tensor
    spawn_a_used: torch.Tensor  # [W, max_spawns] u32 values
    spawn_b_used: torch.Tensor
    spawn_respawn_used: torch.Tensor
    # episode bookkeeping / RNG
    world_idx: torch.Tensor  # [W] i32
    episode_idx: torch.Tensor  # [W] u32 values
    episode_counter: torch.Tensor
    episode_key: torch.Tensor  # [W, 2] u32 values
    world_curriculum: torch.Tensor
    curr_spawn_active: torch.Tensor
    curr_spawn_tier: torch.Tensor
    curr_spawn_idx: torch.Tensor
    # per-agent training metadata
    policy_idx: torch.Tensor  # [W, A]
    reward_coefs: torch.Tensor  # [W, A, 9]
    reward: torch.Tensor
    done: torch.Tensor
    # analytics filters
    filters_last_match: torch.Tensor  # [W, 2, 3]
    filters_last_all_matched: torch.Tensor  # [W, 2]
    # goal regions
    goal_min_dist: torch.Tensor  # [W, G]
    goal_team_rewards: torch.Tensor  # [W, 2]
    team_rewards: torch.Tensor  # [W, 2]


def init_world_state(cfg: EnvConfig, num_goal_regions: int, num_worlds: int,
                     device=None) -> WorldState:
    """Zero-initialized state of W worlds before the first reset."""
    W = num_worlds
    A = cfg.num_agents
    T = cfg.team_size
    C = cfg.breadcrumb_pool_size
    G = max(num_goal_regions, 1)
    f, i, b = torch.float32, torch.int32, torch.bool

    def full(shape, v, dtype):
        return torch.full((W,) + tuple(shape), v, dtype=dtype, device=device)

    coefs = torch.tensor(cfg.reward_defaults.as_tuple(), dtype=f,
                         device=device)
    return WorldState(
        pos=full((A, 3), 0.0, f), vel=full((A, 3), 0.0, f),
        yaw=full((A,), 0.0, f), pitch=full((A,), 0.0, f),
        stand_cur=full((A,), 0, i), stand_tgt=full((A,), 0, i),
        stand_transition=full((A,), 0, i),
        max_vel=full((A,), consts.max_walk_velocity, f),
        hp=full((A,), 100.0, f), mag_bullets=full((A,), 0, i),
        mag_reloading=full((A,), 0, i), alive=full((A,), 0.0, f),
        damage_dealt=full((A, T), 0.0, f), respawn_steps=full((A,), 0, i),
        autoheal_steps=full((A,), 0, i), landed_shot_on=full((A,), -1, i),
        successful_kill=full((A,), False, b),
        was_shot_count=full((A,), 0, i), was_killed=full((A,), False, b),
        fired_shot_t=full((A,), -float("inf"), f),
        in_zone=full((A,), False, b),
        min_dist_to_zone=full((A,), float("inf"), f),
        has_died=full((A,), False, b),
        reloaded_full_mag=full((A,), False, b),
        weapon_type=full((A,), 0, i),
        aim_vel_yaw=full((A,), 0.0, f), aim_vel_pitch=full((A,), 0.0, f),
        start_pos=full((A, 3), 0.0, f),
        explore_bits=full(
            (A, consts.explore_grid_height, EXPLORE_WORDS), 0, U32
        ),
        new_cells=full((A,), 0, i),
        crumb_pos=full((C, 3), 0.0, f), crumb_penalty=full((C,), 0.0, f),
        crumb_team=full((C,), -1, i), crumb_owner=full((C,), -1, i),
        crumb_total_penalty=full((A,), 0.0, f),
        crumb_last=full((A,), -1, i), crumb_steps_since=full((A,), 0, i),
        last_known_obs=full((A, T, OTHER_OB_DIM), 0.0, f),
        last_known_pos=full((A, T, 3), -1000.0, f),
        prev_fwd_depth=full(
            (A, consts.fwd_lidar_height, consts.fwd_lidar_width), 0.0, f
        ),
        prev_can_see=full((A, T), False, b),
        prev_teammate_vis=full((A, T), False, b),
        was_reset=full((), False, b),
        ft_last_known=full((2, T, 14 + T), 0.0, f),
        team_a=full((), 0, i), cur_step=full((), 0, i),
        is_finished=full((), False, b), win_result=full((), -1, i),
        team_kills=full((2,), 0, i), team_points=full((2,), 0, i),
        zone_stats=full((consts.max_zones, 5), 0, i),
        subzone_ctrl=full((8,), -1, i),
        subzone_contested=full((8,), False, b),
        in_subzone=full((A,), False, b),
        min_dist_subzone=full((A,), float("inf"), f),
        zone_cur=full((), 0, i), zone_controlling=full((), -1, i),
        zone_contested=full((), False, b), zone_captured=full((), False, b),
        zone_earned_point=full((), False, b),
        zone_steps_remaining=full((), consts.num_steps_per_zone, i),
        zone_steps_until_point=full((), consts.zone_point_interval, i),
        spawn_a_used=full((consts.max_spawns,), 0xFFFFFFFF, U32),
        spawn_b_used=full((consts.max_spawns,), 0xFFFFFFFF, U32),
        spawn_respawn_used=full((consts.max_spawns,), 0xFFFFFFFF, U32),
        world_idx=torch.arange(W, dtype=i, device=device),
        episode_idx=full((), 0, U32), episode_counter=full((), 0, U32),
        episode_key=full((2,), 0, U32),
        world_curriculum=full((), WorldCurriculum.FullMatch, i),
        curr_spawn_active=full((), False, b),
        curr_spawn_tier=full((), 0, i), curr_spawn_idx=full((), 0, i),
        policy_idx=full((A,), 0, i),
        reward_coefs=coefs.expand(W, A, -1).clone(),
        reward=full((A,), 0.0, f), done=full((A,), 0, i),
        filters_last_match=full((2, 3), -(10 ** 6), i),
        filters_last_all_matched=full((2,), -(10 ** 6), i),
        goal_min_dist=full((G,), float("inf"), f),
        goal_team_rewards=full((2,), 0.0, f),
        team_rewards=full((2,), 0.0, f),
    )


def world_state_from_numpy(leaves: Dict[str, np.ndarray],
                           device=None) -> WorldState:
    """A WorldState from the JAX package's state leaves as numpy arrays
    (each [W, ...]): uint32 leaves widen to int64, the rest keep dtype."""
    kw = {}
    for f in dataclasses.fields(WorldState):
        x = np.asarray(leaves[f.name])
        if f.name in _U32_LEAVES:
            x = x.astype(np.int64)
        kw[f.name] = torch.as_tensor(x.copy(), device=device)
    return WorldState(**kw)


def world_state_to_numpy(state: WorldState) -> Dict[str, np.ndarray]:
    """The JAX package's leaf layout: uint32 leaves narrow back."""
    out = {}
    for name, x in state.leaves().items():
        a = x.detach().cpu().numpy()
        out[name] = a.astype(np.uint32) if name in _U32_LEAVES else a
    return out
