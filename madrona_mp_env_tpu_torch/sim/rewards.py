"""Zone rewards (RewardMode.Default).

zoneRewardSystem (reference src/sim.cpp:3849-3996), then pvpTeamReward
(per-team mean, sim.cpp:4292-4313) and pvpFinalReward (team-spirit blend,
sim.cpp:4315-4339). Coefficients come from the per-agent reward_coefs
tensor (RewardHyperParams, types.hpp:254-264).
"""

from __future__ import annotations

import torch

from .. import config as cfgmod
from ..config import EnvConfig
from ..assets.map_data import MapData
from .types import WorldState
from .zones import zone_center_dist


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


def reward_system(cfg: EnvConfig, m: MapData, state: WorldState
                  ) -> WorldState:
    W, A = state.hp.shape
    dev = state.pos.device
    teams = (torch.arange(A, device=dev) // cfg.team_size).to(torch.int32)
    rc = state.reward_coefs
    dead = state.alive == 0.0

    # shared PvP terms: kill 1.0, death 1.5, reload 0.5
    r = -rc[..., cfgmod.RC_BREADCRUMB_SCALE] * state.crumb_total_penalty
    r = r - torch.where(state.reloaded_full_mag, 0.5, 0.0)
    r = r + torch.where(state.successful_kill, 1.0, 0.0)
    r = r + torch.where(state.landed_shot_on >= 0,
                        rc[..., cfgmod.RC_SHOT_SCALE], 0.0)
    r = r - torch.where(state.was_killed, 1.5, 0.0)
    r = r - torch.where(state.was_shot_count > 0,
                        rc[..., cfgmod.RC_SHOT_SCALE], 0.0)
    r = r + state.new_cells.to(torch.float32) * rc[
        ..., cfgmod.RC_EXPLORE_SCALE]

    # shaped approach to the zone (10x before the agent's first death)
    dist = zone_center_dist(m, state.zone_cur, state.pos)
    closer = (~state.in_zone) & (dist < state.min_dist_to_zone)
    scale = rc[..., cfgmod.RC_ZONE_DIST_SCALE] * torch.where(
        state.has_died, 1.0, 10.0
    )
    approach = torch.where(closer, scale * (state.min_dist_to_zone - dist),
                           0.0)
    new_min = torch.where(closer, dist, state.min_dist_to_zone)

    r = r + torch.where(state.in_zone, rc[..., cfgmod.RC_IN_ZONE_SCALE], 0.0)
    r = r + approach

    # zone control (+ the earned point), both signs
    ctrl = state.zone_controlling[:, None]
    mine = ctrl == teams
    other = (ctrl != -1) & (~mine)
    earned = state.zone_earned_point[:, None]
    ctrl_s = rc[..., cfgmod.RC_ZONE_TEAM_CTRL_SCALE]
    point_s = rc[..., cfgmod.RC_ZONE_EARNED_POINT_SCALE]
    rz = torch.where(mine, ctrl_s, 0.0)
    rz = rz + torch.where(mine & earned, point_s, 0.0)
    rz = rz - torch.where(other, ctrl_s, 0.0)
    rz = rz - torch.where(other & earned, point_s, 0.0)
    r = r + rz
    r = r + torch.where(dead, 0.0,
                        _team_spread_bonus(cfg, m, state, teams))

    # dead agents: clear transient combat flags (sim.cpp:3959-3967)
    state = state.replace(
        successful_kill=torch.where(dead, False, state.successful_kill),
        landed_shot_on=torch.where(dead, -1, state.landed_shot_on),
        was_killed=torch.where(dead, False, state.was_killed),
        was_shot_count=torch.where(dead, 0, state.was_shot_count),
        fired_shot_t=torch.where(dead, -float("inf"), state.fired_shot_t),
        min_dist_to_zone=new_min,
        new_cells=torch.zeros_like(state.new_cells),
    )

    # team mean + team-spirit blend; members summed in index order
    ts = cfg.team_size
    team_sum = _seq_sum(r.reshape(W, 2, ts))
    # divide by a tensor: ATen's CUDA division by a Python scalar
    # multiplies by its reciprocal, which the CPU and K5 do not
    team_mean = team_sum / torch.full((), float(ts), device=r.device)
    spirit = rc[..., cfgmod.RC_TEAM_SPIRIT]
    blended = r * (1.0 - spirit) + team_mean[:, teams.long()] * spirit
    return state.replace(reward=blended, team_rewards=team_mean)
