"""Zone state machine + match scoring.

zoneSystem (reference src/sim.cpp:1892-1976): zone rotation every 600
controlled steps, membership in the rotated-AABB frame, contested and
controlling logic. zoneMatchInfoSystem (sim.cpp:4470-4673): step counter,
kill tally, a point every 20 controlled steps, win at 125 points, zone
stats. Per-world scalars are [W] tensors.
"""

from __future__ import annotations

import torch

from .. import consts
from ..config import EnvConfig
from ..assets.map_data import MapData, ZF_CENTER, ZF_COS, ZF_MAX, ZF_MIN, ZF_SIN
from ..ops import geom
from .types import WorldState

ZS_SWAPS, ZS_CAP_A, ZS_CAP_B, ZS_CONTESTED, ZS_ACTIVE = range(5)


def _teams(cfg: EnvConfig, device) -> torch.Tensor:
    return (torch.arange(cfg.num_agents, device=device) // cfg.team_size
            ).to(torch.int32)


def zone_membership(m: MapData, zone_idx, pos):
    """In-zone per agent: zone_idx [W], pos [W, A, 3] (sim.cpp:1920-1953).
    The agent's point, lifted by half a standing height, is rotated into
    the zone's frame (rotate_z by -rot) and tested against the rotated
    box, whose corners and trig come from m.zone_frames."""
    f = m.zone_frames[zone_idx.long()][:, None]  # [W, 1, cols]
    c, s = f[..., ZF_COS], f[..., ZF_SIN]
    px, py, pz = pos[..., 0], pos[..., 1], pos[..., 2]
    x = c * px - s * py
    y = s * px + c * py
    z = pz + consts.stand_height / 2.0
    return ((x >= f[..., ZF_MIN]) & (x <= f[..., ZF_MAX])
            & (y >= f[..., ZF_MIN + 1]) & (y <= f[..., ZF_MAX + 1])
            & (z >= f[..., ZF_MIN + 2]) & (z <= f[..., ZF_MAX + 2]))


def zone_center_dist(m: MapData, zone_idx, pos):
    """Distance of each agent from its world's zone centre: [W, A]."""
    center = m.zone_frames[zone_idx.long(), ZF_CENTER:ZF_CENTER + 3]
    return geom.norm(pos - center[:, None])


def zone_system(cfg: EnvConfig, m: MapData, state: WorldState):
    teams = _teams(cfg, state.pos.device)
    steps_remaining = state.zone_steps_remaining - (
        state.zone_controlling != -1).to(torch.int32)

    rotate = steps_remaining == 0
    new_zone = torch.where(state.zone_cur + 1 == m.num_zones, 0,
                           state.zone_cur + 1)
    zone_cur = torch.where(rotate, new_zone, state.zone_cur)
    zone_captured = torch.where(rotate, False, state.zone_captured)
    steps_remaining = torch.where(rotate, consts.num_steps_per_zone,
                                  steps_remaining)
    steps_until_point = torch.where(rotate, consts.zone_point_interval,
                                    state.zone_steps_until_point)

    # on rotation, reset each agent's min dist to the new zone centre
    dist_center = zone_center_dist(m, zone_cur, state.pos)
    min_dist_to_zone = torch.where(rotate[:, None], dist_center,
                                   state.min_dist_to_zone)

    in_zone = zone_membership(m, zone_cur, state.pos)
    num_a = (in_zone & (teams == 0)).sum(-1)
    num_b = (in_zone & (teams == 1)).sum(-1)

    steps_until_point = steps_until_point - 1
    contested = (num_a > 0) & (num_b > 0)
    nobody = (num_a == 0) & (num_b == 0)
    controlling = state.zone_controlling
    reset_ctrl = contested | nobody
    a_takes = (num_a > 0) & (num_b == 0) & (controlling != 0)
    b_takes = (num_b > 0) & (num_a == 0) & (controlling != 1)
    new_controlling = torch.where(
        reset_ctrl, -1,
        torch.where(a_takes, 0, torch.where(b_takes, 1, controlling)),
    )
    changed = reset_ctrl | a_takes | b_takes
    captured = torch.where(changed, False, zone_captured)
    steps_until_point = torch.where(changed, consts.zone_point_interval,
                                    steps_until_point)

    return state.replace(
        zone_cur=zone_cur,
        zone_controlling=new_controlling.to(torch.int32),
        zone_contested=contested,
        zone_captured=captured,
        zone_steps_remaining=steps_remaining,
        zone_steps_until_point=steps_until_point,
        in_zone=in_zone,
        min_dist_to_zone=min_dist_to_zone,
    )


def zone_match_info_system(cfg: EnvConfig, m: MapData, state: WorldState,
                           force_reset: torch.Tensor):
    """zoneMatchInfoSystem for Task.Zone; force_reset [W] bool. Returns
    (state, new_captured [W])."""
    teams = _teams(cfg, state.pos.device)
    cur_step = state.cur_step + 1
    match_finished = (cur_step >= cfg.episode_len) | force_reset

    first = (cur_step == 1)[:, None]
    team_kills = torch.where(first, 0, state.team_kills)
    team_points = torch.where(first, 0, state.team_points)
    win_result = torch.where(cur_step == 1, -1, state.win_result)

    # kill tally from the victim's side (sim.cpp:4502-4506)
    kills_on_team = torch.stack(
        [(state.was_killed & (teams == 1)).sum(-1),
         (state.was_killed & (teams == 0)).sum(-1)], dim=-1,
    )
    team_kills = team_kills + kills_on_team

    earned = state.zone_steps_until_point == 0
    steps_until_point = torch.where(earned, consts.zone_point_interval,
                                    state.zone_steps_until_point)
    new_captured = earned & (~state.zone_captured)
    zone_captured = state.zone_captured | earned

    ctrl = torch.clamp(state.zone_controlling, 0, 1).long()
    point = torch.nn.functional.one_hot(ctrl, 2).to(torch.int32)
    team_points = team_points + torch.where(earned[:, None], point, 0)
    match_finished = match_finished | (
        team_points >= consts.zone_win_points).any(-1)

    # zone stats (sim.cpp:4573-4589)
    zs = state.zone_stats.clone()
    w = torch.arange(zs.shape[0], device=zs.device)
    zi = state.zone_cur.long()
    zs[w, zi, ZS_ACTIVE] += 1
    zs[w, zi, ZS_CAP_A + ctrl] += zone_captured.to(torch.int32)
    zs[w, zi, ZS_CONTESTED] += state.zone_contested.to(torch.int32)
    zs[w, zi, ZS_SWAPS] += new_captured.to(torch.int32)

    result = torch.where(
        team_points[:, 0] > team_points[:, 1], 0,
        torch.where(team_points[:, 1] > team_points[:, 0], 1, 2),
    )
    win_result = torch.where(match_finished, result, win_result)

    return state.replace(
        cur_step=cur_step,
        is_finished=match_finished,
        team_kills=team_kills.to(torch.int32),
        team_points=team_points.to(torch.int32),
        win_result=win_result.to(torch.int32),
        zone_captured=zone_captured,
        zone_earned_point=earned,
        zone_steps_until_point=steps_until_point,
        zone_stats=zs,
    ), new_captured
