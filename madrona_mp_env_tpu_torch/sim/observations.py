"""Observation tail: sensor rays, LOS visibility, opponent masks,
egocentric obs, lidar.

opponentsWriteVisibilitySystem (reference src/sim.cpp:2526-2560,
isAgentVisible in src/utils.cpp:186-271), pvpOpponentMasksSystem
(sim.cpp:2562-2614), pvpObservationsSystem (sim.cpp:2645-3052) and
pvpLidarSystem (sim.cpp:3324-3506) over [W, A, ...] tensors. All of an
agent's sensor rays (4 LOS samples per opponent + 2x32 forward + 2x8 rear
lidar) share its position as origin with a z offset per run, and go
through two launches per step: the fan vs the world (ops/raycast.py
fan_route: K2 over the whole soup, K6 over the agent's PVS cell on big
maps, K9 over its sensor-ray table cell with MPENV_FAN_V9=1, or K7 over
the whole soup when a run is not a multiple of 8, as an odd team size's
LOS run is) and the same rays vs the agent capsules (kernel K3).

Observation keys match the reference trainInterface (mgr.cpp:2383-2430).
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from .. import consts
from ..config import EnvConfig
from ..assets.map_data import MapData
from ..ops import geom
from ..ops.culling import cell_index, ray_cell_index
from ..ops.raycast import (fan_route, ray_fans_culled, ray_fans_culled_v9,
                           ray_fans_vs_tris, ray_fans_vs_tris_flat)
from ..ops.raycast_cull import fan_capsules
from .combat import eye_offset, view_height
from .types import WorldState

# frustum constants (Sim::Sim, sim.cpp:5869-5882): 90 deg fov, 16:9
_F = 1.0
_ASPECT = 16.0 / 9.0
_WX = (_F / _ASPECT) / math.hypot(_F / _ASPECT, 1.0)
_WY = 1.0 / math.hypot(_F / _ASPECT, 1.0)
_HX = _F / math.hypot(_F, 1.0)
_HY = 1.0 / math.hypot(_F, 1.0)


def _index_tables(cfg: EnvConfig, device):
    """teams [A]; opp_idx [A, ts] (j-th opponent of agent a); mate_idx
    [A, ts - 1] (teammates in index order)."""
    A, ts = cfg.num_agents, cfg.team_size
    agent = torch.arange(A, device=device)
    teams = agent // ts
    opp_idx = (1 - teams[:, None]) * ts + torch.arange(ts, device=device)
    mate = (teams[:, None] == teams[None, :]) & (agent[:, None]
                                                 != agent[None, :])
    mate_idx = torch.argsort(torch.where(mate, agent[None, :], A), dim=-1,
                             stable=True)[:, : ts - 1]
    return teams.to(torch.int32), opp_idx, mate_idx


def _los_geometry(cfg: EnvConfig, state: WorldState):
    """LOS sample rays, 4 per opponent (isAgentVisible, utils.cpp:186-271):
    target bottom, target eye and the eye shifted +-0.9 r along the
    viewer's aim right."""
    _, opp_idx, _ = _index_tables(cfg, state.pos.device)
    eye = state.pos + eye_offset(state.stand_cur)
    fwd, right, up = geom.aim_vectors(state.yaw, state.pitch)
    r_up = torch.tensor([0.0, 0.0, 1.0], device=state.pos.device)
    bottom = state.pos + r_up * consts.agent_radius
    top = state.pos + eye_offset(state.stand_cur)
    delta_r = (right * (0.9 * consts.agent_radius))[:, :, None, :]
    t_bottom = bottom[:, opp_idx]  # [W, A, ts, 3]
    t_top = top[:, opp_idx]
    samples = torch.stack(
        [t_bottom, t_top, t_top - delta_r, t_top + delta_r], dim=3
    )  # [W, A, ts, 4, 3]
    to_s = samples - eye[:, :, None, None, :]
    vx = geom.dot(to_s, right[:, :, None, None, :])
    vy = geom.dot(to_s, fwd[:, :, None, None, :])
    vz = geom.dot(to_s, up[:, :, None, None, :])
    in_front = vy > 0.0
    in_frustum = (
        (vy * _WY - torch.abs(vx) * _WX > -consts.agent_radius)
        & (vy * _HY - torch.abs(vz) * _HX > -consts.agent_radius)
    )
    dist = geom.norm(to_s)
    far_enough = dist >= consts.agent_radius
    ray_d = to_s / torch.clamp(dist[..., None], min=1e-30)
    return {
        "opp_idx": opp_idx,
        "ray_d": ray_d,
        "pretests": in_front & in_frustum & far_enough,
    }


def _lidar_fan_components(state, n_w, n_h, theta_range, theta_offset,
                          aim_frame):
    """Beam directions (dx, dy, dz), each [W, A, H*W] with rays H-major,
    and per-row origin z offsets [W, A, H]."""
    if aim_frame:
        fwd, right, _ = geom.aim_vectors(state.yaw, state.pitch)
    else:
        fwd, right = geom.body_fwd_right(state.yaw)
    dev = state.pos.device
    idx = torch.arange(n_w, dtype=torch.float32, device=dev)
    theta = theta_range * (idx / (n_w - 1)) + theta_offset
    x = -torch.cos(theta)
    y = torch.sin(theta)
    u = [x * right[..., k:k + 1] + y * fwd[..., k:k + 1] for k in range(3)]
    n = geom.sqrt(u[0] * u[0] + u[1] * u[1] + u[2] * u[2])
    nm = torch.clamp(n, min=1e-30)
    ok = n > 0.0
    d = [torch.where(ok, c / nm, 0.0).repeat(1, 1, n_h) for c in u]

    top_height = view_height(state.stand_cur) + consts.agent_radius
    h_range = top_height - 2.0 * consts.agent_radius
    hs = torch.arange(n_h, dtype=torch.float32, device=dev) / (n_h - 1)
    z = consts.agent_radius + h_range[..., None] * hs
    return tuple(d), z


def sensor_fan(cfg: EnvConfig, state: WorldState):
    """Every agent's sensor rays as one fan per agent: origin = its
    position, per-run z offsets. Returns the LOS geometry, dirs (dx, dy,
    dz) each [W, A, F], zg [W, A, G] and the static run lengths."""
    W, A = state.hp.shape
    los = _los_geometry(cfg, state)
    ray_d = los["ray_d"]
    n_los = los["opp_idx"].shape[1] * 4
    fwd_d, fwd_z = _lidar_fan_components(
        state, consts.fwd_lidar_width, consts.fwd_lidar_height,
        0.75 * consts.pi, 0.5 * (1.0 - 0.75) * consts.pi, aim_frame=True,
    )
    rear_d, rear_z = _lidar_fan_components(
        state, consts.rear_lidar_width, consts.rear_lidar_height,
        -consts.pi, 0.0, aim_frame=False,
    )
    dirs = tuple(
        torch.cat([ray_d[..., k].reshape(W, A, n_los), fwd_d[k], rear_d[k]],
                  dim=-1)
        for k in range(3)
    )
    zg = torch.cat([view_height(state.stand_cur)[..., None], fwd_z, rear_z],
                   dim=-1)
    zgroups = (n_los,) + (consts.fwd_lidar_width,) * consts.fwd_lidar_height \
        + (consts.rear_lidar_width,) * consts.rear_lidar_height
    return los, dirs, zg, zgroups


def build_sensor_rays(cfg: EnvConfig, m: MapData, state: WorldState):
    """All sensor rays of every agent in two launches (world fan K2, K6,
    K9 or K7, capsule fan K3). Returns the LOS geometry and world/capsule
    hits."""
    W, A = state.hp.shape
    los, dirs, zg, zgroups = sensor_fan(cfg, state)
    n_tgt = los["opp_idx"].shape[1]
    n_los = n_tgt * 4
    Fn = dirs[0].shape[-1]
    zoff = torch.repeat_interleave(
        zg, torch.as_tensor(zgroups, device=zg.device), dim=-1
    )
    pos = state.pos.reshape(W * A, 3)
    flat_dirs = tuple(c.reshape(W * A, Fn) for c in dirs)
    # the fans start at state.pos, so its cell is the cell of record
    route = fan_route(zgroups, m)
    if route == "v9":
        t = ray_fans_culled_v9(pos, zoff.reshape(W * A, Fn), flat_dirs,
                               ray_cell_index(m.ray_cells, pos),
                               m.ray_cells, m.tris)
    elif route == "culled":
        t = ray_fans_culled(pos, zg.reshape(W * A, -1), flat_dirs, zgroups,
                            cell_index(m.cells, pos), m.cells, m.tris)
    elif route == "dense":
        t = ray_fans_vs_tris(pos, zg.reshape(W * A, -1), flat_dirs, zgroups,
                             m.tris)
    else:  # the JAX fallback: stacked directions, per-ray offsets
        t = ray_fans_vs_tris_flat(pos, zoff.reshape(W * A, Fn),
                                  torch.stack(flat_dirs, dim=-1), m.tris)
    t = t.reshape(W, A, Fn)
    t_cap, cap_idx = fan_capsules(state.pos, zoff, dirs, state.alive > 0.0)

    H_f, W_f = consts.fwd_lidar_height, consts.fwd_lidar_width
    H_r, W_r = consts.rear_lidar_height, consts.rear_lidar_width
    s0, s1 = n_los, n_los + H_f * W_f
    out = {"los": los}
    for name, (lo, hi, shape) in {
        "los": (0, s0, (n_tgt, 4)),
        "fwd": (s0, s1, (H_f, W_f)),
        "rear": (s1, Fn, (H_r, W_r)),
    }.items():
        out[f"{name}_t"] = t[..., lo:hi].reshape(W, A, *shape)
        out[f"{name}_cap_t"] = t_cap[..., lo:hi].reshape(W, A, *shape)
        out[f"{name}_cap_idx"] = cap_idx[..., lo:hi].reshape(W, A, *shape)
    return out


def _hit_agent(t_world, cap_t, cap_idx):
    """Capsule index where a capsule is hit before the world, else -1."""
    return torch.where(cap_t < t_world, cap_idx, -1)


def visibility_system(cfg: EnvConfig, state: WorldState, sensor):
    """can_see [W, A, ts]: a sample ray passes the pretests and its first
    hit is the target's capsule."""
    los = sensor["los"]
    opp_idx = los["opp_idx"]
    hit = _hit_agent(sensor["los_t"], sensor["los_cap_t"],
                     sensor["los_cap_idx"])
    ray_ok = hit == opp_idx[:, :, None]
    can_see = (los["pretests"] & ray_ok).any(-1)
    alive = state.alive > 0.0
    return can_see & alive[..., None] & alive[:, opp_idx], opp_idx


def opponent_masks_system(cfg: EnvConfig, state: WorldState, can_see,
                          opp_idx):
    """Team-shared knowledge: any teammate sees the opponent, or the
    opponent fired recently."""
    W, A = state.hp.shape
    ts = cfg.team_size
    team_any = can_see.reshape(W, 2, ts, ts).any(2)  # [W, team, slot]
    teams = torch.arange(A, device=can_see.device) // ts
    shared = team_any[:, teams]
    opp_fired = (state.fired_shot_t >= 0.0)[:, opp_idx]
    alive = state.alive > 0.0
    masks = (shared | opp_fired) & alive[..., None] & alive[:, opp_idx]
    return masks.to(torch.float32)


def _normalized_pos(m: MapData, p):
    rng = m.world_max - m.world_min
    return torch.clamp((p - m.world_min) / rng, 0.0, 1.0)


def _common_ob(cfg: EnvConfig, m: MapData, state: WorldState):
    """PlayerCommonObservation [W, A_obs, A_tgt, 23], target velocity in
    each observer's body frame."""
    W, A = state.hp.shape
    alive = state.alive > 0.0
    npos = _normalized_pos(m, state.pos)
    facing_yaw = 0.5 * ((state.yaw / consts.pi) + 1.0)
    facing_pitch = 0.5 * (state.pitch / (0.25 * consts.pi) + 1.0)
    rel_vel = geom.rotate_z(state.vel[:, None, :, :],
                            -state.yaw[:, :, None])  # [W, A, A, 3]
    stand = torch.cat([
        F.one_hot(state.stand_cur.long(), 3).float(),
        F.one_hot(state.stand_tgt.long(), 3).float(),
        (state.stand_transition.float()
         / consts.pose_transition_speed)[..., None],
    ], dim=-1)
    weapon = F.one_hot(state.weapon_type.long(),
                       consts.max_num_weapon_types).float()
    per_target = torch.cat([
        torch.ones_like(state.yaw)[..., None], alive.float()[..., None],
        npos, facing_yaw[..., None], facing_pitch[..., None],
    ], dim=-1)  # [W, A, 7]
    tail = torch.cat([
        state.aim_vel_yaw[..., None], state.aim_vel_pitch[..., None], stand,
        state.in_zone.float()[..., None], weapon,
    ], dim=-1)  # [W, A, 13]
    ob = torch.cat([
        per_target[:, None].expand(W, A, A, 7), rel_vel,
        tail[:, None].expand(W, A, A, 13),
    ], dim=-1)
    valid_only = torch.zeros(23, device=ob.device)
    valid_only[0] = 1.0
    return torch.where(alive[:, None, :, None], ob, valid_only)


def _rel_ob(state: WorldState):
    """toPlayerDist/Yaw/Pitch and relativeFacingYaw/Pitch
    [W, A_obs, A_tgt, 5] (fillOtherPlayerCommonOb, sim.cpp:2948-2995)."""
    to_other = state.pos[:, None, :, :] - state.pos[:, :, None, :]
    dist = geom.norm(to_other)
    close = dist < 1e-2
    dirn = to_other / torch.clamp(dist[..., None], min=1e-30)
    new_yaw, new_pitch = geom.yaw_pitch_to(dirn)
    yaw_delta = geom.wrap_pi(new_yaw - state.yaw[:, :, None])
    pitch_delta = new_pitch - state.pitch[:, :, None]
    rf_yaw = geom.wrap_pi(state.yaw[:, None, :] - state.yaw[:, :, None])
    rf_pitch = state.pitch[:, None, :] - state.pitch[:, :, None]
    return torch.stack([
        torch.where(close, 0.0, dist), torch.where(close, 0.0, yaw_delta),
        torch.where(close, 0.0, pitch_delta), rf_yaw, rf_pitch,
    ], dim=-1)


def _combat_ob(state: WorldState):
    """CombatStateObservation [W, A, 4] (sim.cpp:2776-2791)."""
    return torch.stack([
        state.hp / 100.0,
        state.mag_bullets.float(),
        state.mag_reloading.float(),
        state.autoheal_steps.float()
        / consts.num_out_of_combat_steps_before_autoheal,
    ], dim=-1)


def _zone_ob(cfg: EnvConfig, m: MapData, state: WorldState, teams):
    """ZoneObservation [W, A, 16] (sim.cpp:2800-2874)."""
    W, A = state.hp.shape
    zi = state.zone_cur.long()
    zc = 0.5 * (m.zone_min[zi] + m.zone_max[zi])  # [W, 3]
    n_center = _normalized_pos(m, zc)
    to_c = zc[:, None, :] - state.pos
    dist = geom.norm(to_c)
    close = dist < 1e-2
    dirn = to_c / torch.clamp(dist[..., None], min=1e-30)
    ny, npi = geom.yaw_pitch_to(dirn)
    yd = geom.wrap_pi(ny - state.yaw)
    pd = npi - state.pitch
    ctrl = state.zone_controlling[:, None]
    mine = (ctrl == teams).float()
    enemy = ((ctrl != -1) & (ctrl != teams)).float()

    def per_world(x):
        return x.float()[:, None].expand(W, A)

    return torch.cat([
        n_center[:, None].expand(W, A, 3),
        torch.stack([
            torch.where(close, 0.0, dist), torch.where(close, 0.0, yd),
            torch.where(close, 0.0, pd), mine, enemy,
            per_world(state.zone_contested), per_world(state.zone_captured),
            per_world(state.zone_steps_until_point.float()
                      / consts.zone_point_interval),
            per_world(state.zone_steps_remaining.float()
                      / consts.num_steps_per_zone),
        ], dim=-1),
        # 4 slots as in the reference; a fifth zone (town_map has five)
        # gets all zeros, as jax.nn.one_hot gives out of range
        (zi[:, None] == torch.arange(4, device=zi.device)).float()[
            :, None].expand(W, A, 4),
    ], dim=-1)


def _dead_fill(x):
    fill = torch.zeros(x.shape[-1], device=x.device)
    fill[0] = 1.0
    return fill


def observations_system(cfg: EnvConfig, m: MapData, state: WorldState,
                        can_see, opp_idx, opponent_masks
                        ) -> tuple[WorldState, Dict[str, torch.Tensor]]:
    """pvpObservationsSystem (sim.cpp:2645-3052): (state, obs without
    lidar)."""
    W, A = state.hp.shape
    ts = cfg.team_size
    dev = state.pos.device
    teams, _, mate_idx = _index_tables(cfg, dev)
    alive = state.alive > 0.0
    ar = torch.arange(A, device=dev)

    common = _common_ob(cfg, m, state)
    rel = _rel_ob(state)
    combat = _combat_ob(state)
    npos = _normalized_pos(m, state.pos)

    self_ob = torch.cat([common[:, ar, ar], combat,
                         _zone_ob(cfg, m, state, teams)], dim=-1)
    self_ob = torch.where(alive[..., None], self_ob, _dead_fill(self_ob))
    self_pos_ob = torch.where(alive[..., None], npos, 0.0)

    mate_ob = torch.cat([common[:, ar[:, None], mate_idx],
                         rel[:, ar[:, None], mate_idx],
                         combat[:, mate_idx]], dim=-1)
    mate_alive = alive[:, mate_idx]
    mate_ob = torch.where(mate_alive[..., None], mate_ob, _dead_fill(mate_ob))
    mate_pos = torch.where(mate_alive[..., None], npos[:, mate_idx], 0.0)

    knows = opponent_masks
    opp_ob = torch.cat([
        common[:, ar[:, None], opp_idx], rel[:, ar[:, None], opp_idx],
        state.was_shot_count.float()[:, opp_idx][..., None],
        (state.fired_shot_t >= 0.0).float()[:, opp_idx][..., None],
        can_see.float()[..., None], knows[..., None],
    ], dim=-1)
    opp_alive = alive[:, opp_idx]
    opp_ob = torch.where(opp_alive[..., None], opp_ob, _dead_fill(opp_ob))
    opp_pos = torch.where(opp_alive[..., None], npos[:, opp_idx], 0.0)

    # last-known update (sim.cpp:3010-3051), lazily cleared after a reset
    wr = state.was_reset[:, None, None, None]
    last_obs = torch.where(wr, 0.0, state.last_known_obs)
    last_pos = torch.where(wr, -1000.0, state.last_known_pos)
    clear = ((~opp_alive) | state.was_killed[:, opp_idx])[..., None]
    last_obs = torch.where(clear, 0.0, last_obs)
    last_pos = torch.where(clear, -1000.0, last_pos)
    known = ((knows > 0.0) & opp_alive)[..., None]
    last_obs = torch.where(known, opp_ob, last_obs)
    last_pos = torch.where(known, opp_pos, last_pos)

    team_matched = (
        state.cur_step[:, None]
        - state.filters_last_all_matched[:, torch.clamp(teams, 0, 1).long()]
        < 5
    ).float()

    state = state.replace(last_known_obs=last_obs, last_known_pos=last_pos,
                          prev_can_see=can_see)
    obs = {
        "self": self_ob,
        "self_pos": self_pos_ob,
        "teammates": mate_ob,
        "teammate_positions": mate_pos,
        "opponents": opp_ob,
        "opponent_positions": opp_pos,
        "opponents_last_known": last_obs,
        "opponent_last_known_positions": last_pos,
        "opponent_masks": knows,
        "filters_state": team_matched[..., None],
        "hp": state.hp[..., None] / 100.0,
        "magazine": torch.stack([state.mag_bullets.float(),
                                 state.mag_reloading.float()], dim=-1),
        "alive": state.alive[..., None],
        "reward_coefs": state.reward_coefs,
        # vestigial minimaps (registered but never written by the
        # reference, SURVEY.md section 2.1)
        "agent_map": torch.zeros(W, A, 16, 16, 4, device=dev),
        "unmasked_agent_map": torch.zeros(W, A, 16, 16, 4, device=dev),
    }
    return state, obs


def lidar_system(cfg: EnvConfig, m: MapData, state: WorldState, sensor):
    """Forward (2x32 over 0.75 pi, aim frame) and rear (2x8 over -pi, body
    frame) lidar; each beam gives (depth, isWall, isTeammate,
    isOpponent)."""
    dev = state.pos.device
    teams, _, _ = _index_tables(cfg, dev)
    A = teams.shape[0]
    max_dist = m.max_dist

    def fan(t_world, cap_t, cap_idx):
        hit_agent = _hit_agent(t_world, cap_t, cap_idx)
        t = torch.minimum(t_world, cap_t)
        hit = ~torch.isinf(t)
        depth = torch.where(hit, torch.minimum(t, max_dist), -1.0)
        agent_hit = hit & (hit_agent >= 0)
        same = teams[torch.clamp(hit_agent, 0, A - 1).long()] == teams[
            :, None, None]
        return torch.stack([
            depth, (hit & (hit_agent == -1)).float(),
            (agent_hit & same).float(), (agent_hit & ~same).float(),
        ], dim=-1)

    fwd = fan(sensor["fwd_t"], sensor["fwd_cap_t"], sensor["fwd_cap_idx"])
    rear = fan(sensor["rear_t"], sensor["rear_cap_t"], sensor["rear_cap_idx"])
    state = state.replace(prev_fwd_depth=fwd[..., 0])
    return state, {"fwd_lidar": fwd, "rear_lidar": rear}


def observe_tail(cfg: EnvConfig, m: MapData, state: WorldState):
    """sensor rays -> visibility -> masks -> obs -> lidar."""
    sensor = build_sensor_rays(cfg, m, state)
    can_see, opp_idx = visibility_system(cfg, state, sensor)
    masks = opponent_masks_system(cfg, state, can_see, opp_idx)
    state, obs = observations_system(cfg, m, state, can_see, opp_idx, masks)
    state, lidar_obs = lidar_system(cfg, m, state, sensor)
    obs.update(lidar_obs)
    return state, obs
