"""Episode reset / world init (resetSystem + initWorld, reference
src/sim.cpp:732-872; resetPersistentEntities, src/level_gen.cpp:330-582).

A reset is a masked update: the fresh-episode state is computed for every
world and selected per world by the reset predicate. The trajectory
curriculum restore, the LearnShooting world curriculum and the spawn
curriculum are not ported.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import consts
from ..config import EnvConfig
from ..assets.map_data import MapData
from ..utils import rng
from .spawn import spawn_agents
from .types import WorldState


def init_world(cfg: EnvConfig, m: MapData, state: WorldState,
               init_key: torch.Tensor, sim_ctrl, triggered_reset
               ) -> WorldState:
    """Fresh-episode state of every world (initWorld +
    resetPersistentEntities). sim_ctrl: host ints [eval, randomize episode
    length, randomize team sides]; triggered_reset [W] bool."""
    W, A = state.hp.shape
    dev = state.hp.device

    ep_key = rng.episode_key(init_key, state.episode_idx, state.world_idx)
    base = rng.step_key(ep_key, -1)
    keys = rng.split(base, 6)  # flip, stagger, zone, spawn, curr, coef
    k_flip, k_stagger, k_zone, k_spawn = (keys[:, j] for j in range(4))

    flip = bool(sim_ctrl[2]) & (rng.uniform(k_flip) < 0.5)
    team_a = flip.to(torch.int32)
    stagger = triggered_reset & bool(sim_ctrl[1])
    cur_step = torch.where(
        stagger, rng.randint(k_stagger, (), 0, cfg.episode_len - 1), 0
    ).to(torch.int32)
    zone_cur = rng.randint(k_zone, (), 0, m.num_zones)  # Task.Zone

    f, i, b = torch.float32, torch.int32, torch.bool

    def full(shape, v, dtype):
        return torch.full((W,) + tuple(shape), v, dtype=dtype, device=dev)

    coefs = torch.tensor(cfg.reward_defaults.as_tuple(), dtype=f, device=dev)
    state = state.replace(
        curr_spawn_active=full((), False, b),
        curr_spawn_tier=full((), 0, i),
        curr_spawn_idx=full((), 0, i),
        team_a=team_a,
        cur_step=cur_step,
        is_finished=full((), False, b),
        win_result=full((), -1, i),
        team_kills=full((2,), 0, i),
        team_points=full((2,), 0, i),
        zone_stats=torch.zeros_like(state.zone_stats),
        zone_cur=zone_cur,
        zone_controlling=full((), -1, i),
        zone_contested=full((), False, b),
        zone_captured=full((), False, b),
        zone_earned_point=full((), False, b),
        zone_steps_remaining=full((), consts.num_steps_per_zone, i),
        zone_steps_until_point=full((), consts.zone_point_interval, i),
        episode_key=ep_key,
        # agents -> far away + dead so spawn_agents respawns everyone
        pos=full((A, 3), 3.0e37, f),
        vel=full((A, 3), 0.0, f),
        alive=full((A,), 0.0, f),
        hp=full((A,), 0.0, f),
        respawn_steps=full((A,), 0, i),
        autoheal_steps=full((A,), 0, i),
        landed_shot_on=full((A,), -1, i),
        successful_kill=full((A,), False, b),
        was_shot_count=full((A,), 0, i),
        was_killed=full((A,), False, b),
        fired_shot_t=full((A,), -float("inf"), f),
        has_died=full((A,), False, b),
        reloaded_full_mag=full((A,), False, b),
        in_zone=full((A,), False, b),
        min_dist_to_zone=full((A,), float("inf"), f),
        subzone_ctrl=full((8,), -1, i),
        subzone_contested=full((8,), False, b),
        in_subzone=full((A,), False, b),
        min_dist_subzone=full((A,), float("inf"), f),
        damage_dealt=torch.zeros_like(state.damage_dealt),
        aim_vel_yaw=full((A,), 0.0, f),
        aim_vel_pitch=full((A,), 0.0, f),
        # not cleared here: last-known obs, crumbs and explore bits are
        # cleared lazily by their owning systems via was_reset
        spawn_a_used=torch.full_like(state.spawn_a_used, 0xFFFFFFFF),
        spawn_b_used=torch.full_like(state.spawn_b_used, 0xFFFFFFFF),
        spawn_respawn_used=torch.full_like(state.spawn_respawn_used,
                                           0xFFFFFFFF),
        reward_coefs=coefs.expand(W, A, -1).clone(),
        filters_last_match=full((2, 3), -(10 ** 6), i),
        filters_last_all_matched=full((2,), -(10 ** 6), i),
        goal_min_dist=torch.full_like(state.goal_min_dist, float("inf")),
        goal_team_rewards=full((2,), 0.0, f),
    )
    state = spawn_agents(cfg, m, state, k_spawn, is_respawn=False)
    return state.replace(start_pos=state.pos)


def reset_system(cfg: EnvConfig, m: MapData, state: WorldState,
                 init_key: torch.Tensor, sim_ctrl, force_reset: torch.Tensor
                 ) -> WorldState:
    """resetSystem (sim.cpp:835-872): reset the worlds whose match ended
    (auto reset) or that are forced; force_reset [W]."""
    should = force_reset != 0
    if cfg.auto_reset:
        should = should | state.is_finished
    pre = state.replace(
        episode_idx=torch.where(should, state.episode_counter,
                                state.episode_idx),
        episode_counter=(state.episode_counter + should.to(torch.int64))
        & 0xFFFFFFFF,
        was_reset=should,
    )
    fresh = init_world(cfg, m, pre, init_key, sim_ctrl,
                       triggered_reset=force_reset != 0)

    def sel(new, old):
        return torch.where(should.reshape((-1,) + (1,) * (old.dim() - 1)),
                           new, old)

    return WorldState(**{
        fl.name: sel(getattr(fresh, fl.name), getattr(pre, fl.name))
        for fl in dataclasses.fields(WorldState)
    })
