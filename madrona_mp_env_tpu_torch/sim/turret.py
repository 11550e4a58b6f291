"""Turret task: scripted auto-aim turrets as the opposing team.

turretFireSystem's targeting and slew (reference src/sim.cpp:1617-1792),
turretMatchInfoSystem (sim.cpp:4675-4708) and turretRewardSystem
(sim.cpp:4341-4394). As in the JAX package, the turrets are team 1's agent
rows: spawned at navmesh points and never respawned (sim/spawn.py), held
in place and aimed by this controller's actions, and firing through the
regular fire system with the turret weapon (EnvConfig.effective_weapons),
so visibility, observations, lidar and damage treat them as agents.

The line of sight from each row to each of the agent team's eyes is one
ray vs the world (kernel K1, ops/raycast.py ray_vs_tris): W * A * ts rays
a step.
"""

from __future__ import annotations

import math

import torch

from .. import consts
from ..config import EnvConfig, Task
from ..assets.map_data import MapData
from ..ops import geom
from ..ops.raycast import ray_vs_tris
from .combat import view_height
from .types import Actions, WorldState

# max_aim_turn = discreteTurnDelta() * (numTurnBuckets / 2) * deltaT
# (sim.cpp:1634-1637)
MAX_AIM_TURN = (consts.discrete_turn_delta * (consts.num_turn_buckets // 2)
                * consts.delta_t)


def turret_mask(cfg: EnvConfig, device=None) -> torch.Tensor:
    """[A] bool: the turret rows (team 1 in the Turret task)."""
    teams = torch.arange(cfg.num_agents, device=device) // cfg.team_size
    if cfg.task != Task.Turret:
        return torch.zeros_like(teams, dtype=torch.bool)
    return teams == 1


def best_target(fwd, to_n, dist, candidate, in_front=False):
    """The most aligned candidate target, the closer on a tie
    (sim.cpp:1670-1683): any angle within one frame's slew counts as
    centred. fwd [W, A, 3]; to_n [W, A, n, 3]; dist, candidate [W, A, n].
    ``in_front`` also drops targets behind (hlBattleSystem). Returns
    (best [W, A] index into n, eff_cos [W, A, n])."""
    cos_angle = geom.dot(fwd[:, :, None, :], to_n)
    eff_cos = torch.where(cos_angle > math.cos(MAX_AIM_TURN), 1.0,
                          cos_angle)
    if in_front:
        candidate = candidate & (eff_cos > 0.0)
    eff_cos = torch.where(candidate, eff_cos, -float("inf"))
    return torch.argmax(eff_cos * 1e7 - dist, dim=-1), eff_cos


def turret_ai_system(cfg: EnvConfig, m: MapData, state: WorldState,
                     actions: Actions) -> Actions:
    """Overwrite the turret rows' actions with the auto-aim controller:
    aim at the best visible agent at <= MAX_AIM_TURN a step, fire when
    centred, reload when empty (sim.cpp:1638-1745)."""
    if cfg.task != Task.Turret:
        return actions
    ts = cfg.team_size
    is_turret = turret_mask(cfg, state.pos.device)

    fire_from = state.pos + geom.lift(torch.full_like(
        state.hp, consts.stand_height - consts.agent_radius))
    fwd, _, _ = geom.aim_vectors(state.yaw, state.pitch)

    # targets: the agent team's rows at eye height (one LOS sample, the
    # capsule top, against the reference's four)
    tgt_pos = state.pos[:, :ts] + geom.lift(
        view_height(state.stand_cur[:, :ts]))
    tgt_alive = state.alive[:, :ts] > 0.0
    to_tgt = tgt_pos[:, None] - fire_from[:, :, None]  # [W, A, ts, 3]
    dist = geom.norm(to_tgt)
    to_n = to_tgt / torch.clamp(dist[..., None], min=1e-9)

    t_world = ray_vs_tris(fire_from[:, :, None].expand_as(to_tgt), to_n,
                          m.tris)
    visible = (t_world >= dist - 1e-3) & tgt_alive[:, None]
    best, _ = best_target(fwd, to_n, dist, visible)
    has_tgt = torch.gather(visible, 2, best[..., None])[..., 0]
    bt = torch.gather(to_n, 2, best[..., None, None].expand(-1, -1, 1, 3)
                      )[:, :, 0]
    new_yaw, new_pitch = geom.yaw_pitch_to(bt)

    yaw_delta = new_yaw - state.yaw
    yaw_delta = torch.where(yaw_delta > consts.pi,
                            yaw_delta - 2 * consts.pi, yaw_delta)
    yaw_delta = torch.where(yaw_delta < -consts.pi,
                            yaw_delta + 2 * consts.pi, yaw_delta)
    pitch_delta = new_pitch - state.pitch
    not_centered = ((torch.abs(yaw_delta) > MAX_AIM_TURN)
                    | (torch.abs(pitch_delta) > MAX_AIM_TURN))
    yaw_delta = torch.where(
        has_tgt, torch.clamp(yaw_delta, -MAX_AIM_TURN, MAX_AIM_TURN), 0.0)
    pitch_delta = torch.where(
        has_tgt, torch.clamp(pitch_delta, -MAX_AIM_TURN, MAX_AIM_TURN), 0.0)

    # reload when empty (sim.cpp:1728-1732), fire when centred
    reload_now = state.mag_bullets == 0
    fire_now = (has_tgt & ~not_centered & ~(state.mag_reloading > 0)
                & ~reload_now)
    fire = torch.where(reload_now, 2, torch.where(fire_now, 1, 0)).to(
        torch.int32)

    def overlay(base, turret_val):
        return torch.where(is_turret, turret_val, base).to(base.dtype)

    return actions.replace(
        move_amount=overlay(actions.move_amount, 0),
        move_angle=overlay(actions.move_angle, 0),
        stand=overlay(actions.stand, 0),
        fire=overlay(actions.fire, fire),
        aim_yaw_rate=overlay(actions.aim_yaw_rate,
                             yaw_delta / consts.delta_t),
        aim_pitch_rate=overlay(actions.aim_pitch_rate,
                               pitch_delta / consts.delta_t),
        aim_yaw=overlay(actions.aim_yaw,
                        consts.discrete_aim_num_yaw_buckets // 2),
        aim_pitch=overlay(actions.aim_pitch,
                          consts.discrete_aim_num_pitch_buckets // 2),
    )


def turret_match_info_system(cfg: EnvConfig, state: WorldState,
                             force_reset: torch.Tensor):
    """turretMatchInfoSystem: the match ends when every agent or every
    turret is dead, or at the episode's end; the agents win (0) when the
    turrets are all dead, else the turrets (1). Returns (state,
    new_captured [W], all False)."""
    ts = cfg.team_size
    agents_alive = (state.alive[:, :ts] > 0.0).any(-1)
    turrets_alive = (state.alive[:, ts:] > 0.0).any(-1)
    cur_step = state.cur_step + 1
    finished = (~agents_alive | ~turrets_alive
                | (cur_step >= cfg.episode_len) | force_reset)
    win = torch.where(finished & ~turrets_alive, 0,
                      torch.where(finished, 1, -1))
    return state.replace(
        cur_step=cur_step, is_finished=finished,
        win_result=win.to(torch.int32),
    ), torch.zeros_like(finished)


def turret_reward_system(cfg: EnvConfig, state: WorldState) -> WorldState:
    """turretRewardSystem: -0.0075 a step, +0.005 a new explore cell, +1
    per kill of the agent team, +0.05 per own landed shot and +0.05 per
    teammate's, -1 killed, -0.05 shot. The turret rows get 0, and there is
    no team-spirit blend."""
    is_turret = turret_mask(cfg, state.pos.device)
    new_cells = state.new_cells.to(torch.float32)
    landed = (state.landed_shot_on >= 0).to(torch.float32)
    kills = state.successful_kill.to(torch.float32)
    team_kills = torch.where(is_turret, 0.0, kills).sum(-1, keepdim=True)
    team_landed = torch.where(is_turret, 0.0, landed).sum(-1, keepdim=True)
    r = (-0.0075 + 0.005 * new_cells + team_kills + 0.05 * landed
         + 0.05 * (team_landed - landed)
         - 1.0 * state.was_killed.to(torch.float32)
         - 0.05 * (state.was_shot_count > 0).to(torch.float32))
    r = torch.where(is_turret, 0.0, r)
    return state.replace(reward=r,
                         new_cells=torch.zeros_like(state.new_cells))
