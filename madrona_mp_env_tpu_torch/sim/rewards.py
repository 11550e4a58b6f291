"""Reward systems.

zoneRewardSystem (reference src/sim.cpp:3849-3996), tdmRewardSystem
(sim.cpp:3599-3705), zoneCaptureDefendRewardSystem (sim.cpp:4089-4209),
flankRewardSystem (sim.cpp:4211-4290), exploreRewardSystem
(sim.cpp:3538-3551), turretRewardSystem (sim/turret.py) and
subzoneRewardSystem (sim/subzones.py); in a LearnShooting world
(SimFlags.EnableCurriculum) learnShootingRewardSystem (sim.cpp:3707-3733)
replaces the task's reward of Zone, TDM and ZoneCaptureDefend and keeps
the zone distance; then pvpTeamReward (per-team mean,
sim.cpp:4292-4313) and pvpFinalReward (team-spirit blend,
sim.cpp:4315-4339). Coefficients come from the per-agent reward_coefs
tensor (RewardHyperParams, types.hpp:254-264).
"""

from __future__ import annotations

import torch

from .. import config as cfgmod
from .. import consts
from ..config import EnvConfig, RewardMode, SimFlags, Task
from ..assets.map_data import MapData
from ..ops import geom
from .types import WorldCurriculum, WorldState
from .zones import zone_center_dist


def learn_shooting_reward(state: WorldState):
    """+0.5 for a landed shot, else -0.05 for a shot fired, minus 0.5 for
    reloading a full magazine [W, A]."""
    r = torch.zeros_like(state.reward)
    r = r + torch.where(state.landed_shot_on >= 0, 0.5,
                        torch.where(state.fired_shot_t >= 0.0, -0.05, 0.0))
    return r - torch.where(state.reloaded_full_mag, 0.5, 0.0)


def _team_spread_bonus(cfg: EnvConfig, m: MapData, state: WorldState,
                       teams):
    """Team-area bonus (sim.cpp:3969-3995): sum |cross| over consecutive
    teammate pairs relative to self, normalized by the world area."""
    A = cfg.num_agents
    ts = cfg.team_size
    dev = state.pos.device
    agent = torch.arange(A, device=dev)
    mate = (teams[:, None] == teams[None, :]) & (agent[:, None]
                                                 != agent[None, :])
    # teammates of each agent in index order: [A, ts - 1]
    order = torch.argsort(torch.where(mate, agent[None, :], A), dim=-1,
                          stable=True)[:, : ts - 1]
    pos_xy = state.pos[..., :2]
    e = pos_xy[:, order] - pos_xy[:, :, None, :]  # [W, A, ts - 1, 2]
    e1 = e[:, :, :-1]
    e2 = e[:, :, 1:]
    cross = torch.abs(e1[..., 0] * e2[..., 1] - e1[..., 1] * e2[..., 0])
    poly2x = _seq_sum(cross)
    diff = m.world_max[:2] - m.world_min[:2]
    bounds_area = diff[0] * diff[1]
    return poly2x / (2.0 * bounds_area) * 1e-2


def _seq_sum(x):
    """Sum over the last axis in index order, from 0."""
    out = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    for k in range(x.shape[-1]):
        out = out + x[..., k]
    return out


def refresh_flank_los(cfg: EnvConfig, m: MapData, state: WorldState
                      ) -> WorldState:
    """flankRewardSystem raycasts the LOS with the current (post-movement)
    positions (sim.cpp:4228-4267): this step's visibility table, traced
    here (K1 for the world, the capsules in plain PyTorch), goes into the
    prev_can_see / prev_teammate_vis slots that the Flank branch reads.
    The observation tail overwrites both after the reset as before."""
    from . import observations

    vis, _ = observations.visibility_system(cfg, m, state)
    ts = cfg.team_size
    return state.replace(prev_can_see=vis[..., :ts],
                         prev_teammate_vis=vis[..., ts:])


def _combat_reward(state: WorldState, rc, kill_reward, death_penalty,
                   reload_penalty):
    """The terms the PvP reward systems share."""
    r = -rc[..., cfgmod.RC_BREADCRUMB_SCALE] * state.crumb_total_penalty
    r = r - torch.where(state.reloaded_full_mag, reload_penalty, 0.0)
    r = r + torch.where(state.successful_kill, kill_reward, 0.0)
    r = r + torch.where(state.landed_shot_on >= 0,
                        rc[..., cfgmod.RC_SHOT_SCALE], 0.0)
    r = r - torch.where(state.was_killed, death_penalty, 0.0)
    r = r - torch.where(state.was_shot_count > 0,
                        rc[..., cfgmod.RC_SHOT_SCALE], 0.0)
    return r + state.new_cells.to(torch.float32) * rc[
        ..., cfgmod.RC_EXPLORE_SCALE]


def _zone_approach(m: MapData, state: WorldState, rc):
    """The shaped approach to the zone (10x before the agent's first
    death): (reward, new min distance)."""
    dist = zone_center_dist(m, state.zone_cur, state.pos)
    closer = (~state.in_zone) & (dist < state.min_dist_to_zone)
    scale = rc[..., cfgmod.RC_ZONE_DIST_SCALE] * torch.where(
        state.has_died, 1.0, 10.0
    )
    approach = torch.where(closer, scale * (state.min_dist_to_zone - dist),
                           0.0)
    return approach, torch.where(closer, dist, state.min_dist_to_zone)


def _zone_ctrl_reward(state: WorldState, rc, teams, penalize_other=True):
    """Zone control and the earned point; ``penalize_other`` also takes
    both off while the other team holds the zone."""
    ctrl = state.zone_controlling[:, None]
    mine = ctrl == teams
    other = (ctrl != -1) & (~mine)
    earned = state.zone_earned_point[:, None]
    ctrl_s = rc[..., cfgmod.RC_ZONE_TEAM_CTRL_SCALE]
    point_s = rc[..., cfgmod.RC_ZONE_EARNED_POINT_SCALE]
    rz = torch.where(mine, ctrl_s, 0.0)
    rz = rz + torch.where(mine & earned, point_s, 0.0)
    if penalize_other:
        rz = rz - torch.where(other, ctrl_s, 0.0)
        rz = rz - torch.where(other & earned, point_s, 0.0)
    return rz


def _flank_reward(cfg: EnvConfig, state: WorldState, rc, teams):
    """flankRewardSystem (sim.cpp:4211-4290) on this step's LOS
    (refresh_flank_los): +0.001 per teammate >= 100 away or not visible,
    +0.001 per opponent that cannot see the agent (its slot in the
    opponent's row is its team offset), the behind-shot bonus (1 on a
    kill, else 0.2), the explore bonus."""
    W, A = state.hp.shape
    ts = cfg.team_size
    dev = state.pos.device
    agent = torch.arange(A, device=dev)
    slot = torch.arange(ts, device=dev)
    own_idx = teams[:, None].long() * ts + slot  # [A, ts]
    d = state.pos[:, own_idx] - state.pos[:, :, None]
    spread_ok = (geom.dot(d, d) >= 100.0 * 100.0) | ~state.prev_teammate_vis
    r = 0.001 * ((own_idx != agent[:, None]) & spread_ok).sum(-1)
    opp_idx = (1 - teams[:, None].long()) * ts + slot
    opp_sees_me = state.prev_can_see[:, opp_idx, (agent % ts)[:, None]]
    r = r + 0.001 * (~opp_sees_me).sum(-1)
    tgt = state.landed_shot_on
    tgt_yaw = torch.gather(state.yaw, 1, torch.clamp(tgt, 0, A - 1).long())
    behind = torch.abs(tgt_yaw - state.yaw) > consts.pi
    r = r + torch.where((tgt >= 0) & behind,
                        torch.where(state.successful_kill, 1.0, 0.2), 0.0)
    return r + state.new_cells.to(torch.float32) * rc[
        ..., cfgmod.RC_EXPLORE_SCALE]


def clear_dead_and_blend(cfg: EnvConfig, state: WorldState, r
                         ) -> WorldState:
    """Clear the dead agents' transient combat flags (sim.cpp:3959-3967)
    and the explore counter, then the team mean and the team-spirit blend,
    members summed in index order."""
    W, A = state.hp.shape
    dead = state.alive == 0.0
    state = state.replace(
        successful_kill=torch.where(dead, False, state.successful_kill),
        landed_shot_on=torch.where(dead, -1, state.landed_shot_on),
        was_killed=torch.where(dead, False, state.was_killed),
        was_shot_count=torch.where(dead, 0, state.was_shot_count),
        fired_shot_t=torch.where(dead, -float("inf"), state.fired_shot_t),
        new_cells=torch.zeros_like(state.new_cells),
    )
    ts = cfg.team_size
    teams = torch.arange(A, device=r.device) // ts
    team_sum = _seq_sum(r.reshape(W, 2, ts))
    # divide by a tensor: ATen's CUDA division by a Python scalar
    # multiplies by its reciprocal, which the CPU and K5 do not
    team_mean = team_sum / torch.full((), float(ts), device=r.device)
    spirit = state.reward_coefs[..., cfgmod.RC_TEAM_SPIRIT]
    blended = r * (1.0 - spirit) + team_mean[:, teams] * spirit
    return state.replace(reward=blended, team_rewards=team_mean)


def reward_system(cfg: EnvConfig, m: MapData, state: WorldState
                  ) -> WorldState:
    """The task's reward (the sub-zone variant replaces it when
    SimFlags.SubZones is on, sim.cpp:5715-5735), then the team terms."""
    if cfg.has_flag(SimFlags.SubZones):
        from .subzones import subzone_reward_system

        return subzone_reward_system(cfg, m, state)
    if cfg.task == Task.Turret:
        from .turret import turret_reward_system

        return turret_reward_system(cfg, state)
    if cfg.task == Task.Explore:
        # +0.05 a new cell, else -0.005; no team terms
        new_cells = state.new_cells.to(torch.float32)
        return state.replace(
            reward=torch.where(new_cells > 0, 0.05 * new_cells, -0.005),
            new_cells=torch.zeros_like(state.new_cells))

    A = cfg.num_agents
    teams = (torch.arange(A, device=state.pos.device) // cfg.team_size).to(
        torch.int32)
    rc = state.reward_coefs
    new_min = state.min_dist_to_zone
    if cfg.task == Task.Zone and cfg.reward_mode == RewardMode.Default:
        r = _combat_reward(state, rc, 1.0, 1.5, 0.5)
        approach, new_min = _zone_approach(m, state, rc)
        r = r + torch.where(state.in_zone, rc[..., cfgmod.RC_IN_ZONE_SCALE],
                            0.0)
        r = r + approach
        r = r + _zone_ctrl_reward(state, rc, teams)
        r = r + torch.where(state.alive == 0.0, 0.0,
                            _team_spread_bonus(cfg, m, state, teams))
    elif cfg.task == Task.Zone:
        r = _flank_reward(cfg, state, rc, teams)
    elif cfg.task == Task.TDM:
        # the imitation-goal shaping (sim.cpp:3628-3639) needs TDMEpisode
        # data, which the reference never loads; omitted as in the JAX
        # package
        r = _combat_reward(state, rc, 1.0, 1.0, 0.01)
    else:  # ZoneCaptureDefend: no breadcrumb term
        r = _combat_reward(state, rc, 1.0, 1.0, 0.01)
        r = r + rc[..., cfgmod.RC_BREADCRUMB_SCALE] * state.crumb_total_penalty
        r = r + 0.02 * state.goal_team_rewards[:, teams.long()]
        _, new_min = _zone_approach(m, state, rc)
        r = r + _zone_ctrl_reward(state, rc, teams, penalize_other=False)
        # the terminal win / loss bonus (sim.cpp:4188-4198)
        win = state.win_result[:, None]
        terminal = torch.where(win == 2, -5.0,
                               torch.where(win == teams, 20.0, -20.0))
        r = r + torch.where(state.is_finished[:, None], terminal, 0.0)
    if cfg.has_flag(SimFlags.EnableCurriculum):
        ls = (state.world_curriculum == WorldCurriculum.LearnShooting)[:,
                                                                       None]
        r = torch.where(ls, learn_shooting_reward(state), r)
        new_min = torch.where(ls, state.min_dist_to_zone, new_min)
    state = state.replace(min_dist_to_zone=new_min)
    return clear_dead_and_blend(cfg, state, r)
