"""SubZones: per-policy capture sub-objectives (SimFlags.SubZones).

subzoneSystem (reference src/sim.cpp:1978-2043) and subzoneRewardSystem
(sim.cpp:3734-3847): 8 static rotated-AABB sub-zones (map zones 1 and 2
and 6 hardcoded boxes, level_gen.cpp:283-326; MapData.subzone_min /
subzone_max / subzone_rot, built with numpy at load); each agent is
assigned the sub-zone of its policy id (clamped), and a contested /
controlling state machine per sub-zone drives an individual in-zone,
approach and control reward.
"""

from __future__ import annotations

import torch

from .. import config as cfgmod
from .. import consts
from ..config import EnvConfig
from ..assets.map_data import MapData
from ..ops import geom
from .types import WorldState

NUM_SUBZONES = 8


def agent_subzone_idx(state: WorldState) -> torch.Tensor:
    """[W, A] sub-zone of each agent: its policy id, clamped
    (sim.cpp:1996-1998)."""
    return torch.clamp(state.policy_idx, 0, NUM_SUBZONES - 1).long()


def subzone_system(cfg: EnvConfig, m: MapData, state: WorldState
                   ) -> WorldState:
    """Membership of each agent in its own sub-zone, then each sub-zone's
    contested / controlling state."""
    A = cfg.num_agents
    teams = torch.arange(A, device=state.pos.device) // cfg.team_size
    assign = agent_subzone_idx(state)
    pos = state.pos + geom.lift(torch.full_like(state.hp,
                                                consts.stand_height / 2.0))
    rot = -m.subzone_rot[assign]  # [W, A]
    p_zf = geom.rotate_z(pos, rot)
    mn_zf = geom.rotate_z(m.subzone_min[assign], rot)
    mx_zf = geom.rotate_z(m.subzone_max[assign], rot)
    inside = ((p_zf >= mn_zf) & (p_zf <= mx_zf)).all(-1) & (state.alive
                                                            > 0.0)
    min_dist = torch.where(inside, 0.0, state.min_dist_subzone)

    onehot = assign[..., None] == torch.arange(NUM_SUBZONES,
                                               device=assign.device)
    w = inside[..., None] & onehot  # [W, A, S]
    num_a = (w & (teams == 0)[:, None]).sum(1)
    num_b = (w & (teams == 1)[:, None]).sum(1)
    contested = (num_a > 0) & (num_b > 0)
    empty = (num_a == 0) & (num_b == 0)
    ctrl = torch.where(contested | empty, -1, torch.where(num_a > 0, 0, 1))
    return state.replace(
        in_subzone=inside,
        min_dist_subzone=min_dist,
        subzone_ctrl=ctrl.to(torch.int32),
        subzone_contested=contested,
    )


def subzone_reward_system(cfg: EnvConfig, m: MapData, state: WorldState
                          ) -> WorldState:
    """Breadcrumb penalty, -0.5 wasted reload, +3 kill, +-shot scale, -1.5
    death, the explore bonus, the in-zone bonus or the shaped approach to
    the agent's sub-zone (10x before its first death), +-zone control
    scale while the sub-zone is held; then the team-spirit blend."""
    from .rewards import clear_dead_and_blend

    A = cfg.num_agents
    teams = torch.arange(A, device=state.pos.device) // cfg.team_size
    rc = state.reward_coefs
    assign = agent_subzone_idx(state)
    f32 = torch.float32

    r = -rc[..., cfgmod.RC_BREADCRUMB_SCALE] * state.crumb_total_penalty
    r = r - 0.5 * state.reloaded_full_mag.to(f32)
    r = r + 3.0 * state.successful_kill.to(f32)
    r = r + rc[..., cfgmod.RC_SHOT_SCALE] * (state.landed_shot_on >= 0).to(
        f32)
    r = r - 1.5 * state.was_killed.to(f32)
    r = r - rc[..., cfgmod.RC_SHOT_SCALE] * (state.was_shot_count > 0).to(
        f32)
    r = r + state.new_cells.to(f32) * rc[..., cfgmod.RC_EXPLORE_SCALE]

    center = 0.5 * (m.subzone_min[assign] + m.subzone_max[assign])
    dist = geom.norm(center - state.pos)
    approaching = ~state.in_subzone & (dist < state.min_dist_subzone)
    dist_scale = rc[..., cfgmod.RC_ZONE_DIST_SCALE] * torch.where(
        state.has_died, 1.0, 10.0)
    approach = torch.where(approaching,
                           dist_scale * (state.min_dist_subzone - dist), 0.0)
    r = r + torch.where(state.in_subzone, rc[..., cfgmod.RC_IN_ZONE_SCALE],
                        approach)
    new_min = torch.where(approaching, dist, state.min_dist_subzone)

    ctrl = torch.gather(state.subzone_ctrl, 1, assign)
    ctrl_s = rc[..., cfgmod.RC_ZONE_TEAM_CTRL_SCALE]
    r = r + torch.where(ctrl == -1, 0.0,
                        torch.where(ctrl == teams, ctrl_s, -ctrl_s))
    state = state.replace(min_dist_subzone=new_min)
    return clear_dead_and_blend(cfg, state, r)
