"""The full-team interface: team-level observations, reward and done.

The reference's FullTeamInterface (src/types.hpp:1040-1152), filled by
fullTeamObservationsSystem (src/sim.cpp:3054-3302) and
fullTeamDoneRewardSystem (sim.cpp:4720-4749), as the JAX package's
sim/full_team.py builds it, over every world at once: one policy controls
a whole team and sees every teammate and enemy plus a global zone and
match observation. Leaves are [W, 2 (team), ...]; team t's members are
agents t * ts .. t * ts + ts - 1.

common (per player, 14 + ts floats): isValid, id one-hot [ts], isAlive,
    position normalized to the world box (not clamped), facing yaw and
    pitch normalized, velocity (raw), stand one-hot [3], inZone; every
    field but isValid, id and isAlive zeroed for a dead player
players = common + hp / 100, magazine / 30, isReloading,
    autoheal steps / 150
enemies = common + wasHit, firedShot, hasLOS [ts] (which teammate sees
    it), teamKnowsLocation (last: the policy reads its mask there)
last_known_enemies = common, copied while the team knows the enemy,
    kept otherwise, cleared on the enemy's death and at a reset
global = team id one-hot [2], fraction of the match remaining, zone
    (centre normalized, mine, the enemy's, contested, captured, steps to
    the next point / 20, steps remaining / 600, zone id one-hot [4])

The system reads the visibility table and the lidar of the step's
observation tail (K2 or K6 and K3 launch there); it launches no kernel of
its own.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch.nn import functional as F

from .. import consts
from ..config import EnvConfig, Task
from ..assets.map_data import MapData
from .types import WorldState


def _div(x, c: float):
    """x / c dividing by a tensor: ATen's CUDA division by a Python scalar
    multiplies by its reciprocal, the CPU's divides."""
    return x / torch.full((), float(c), device=x.device)


def _normalized_pos(m: MapData, p):
    return (p - m.world_min) / (m.world_max - m.world_min)


def common_obs(cfg: EnvConfig, m: MapData, state: WorldState):
    """Each agent's common observation [W, A, 14 + ts] and alive [W, A],
    its id the one-hot of its slot in its team."""
    W, A = state.hp.shape
    ts = cfg.team_size
    dev = state.pos.device
    alive = state.alive > 0.0
    live = alive.to(torch.float32)[..., None]
    yaw_n = 0.5 * (state.yaw / consts.pi + 1.0)
    pitch_n = 0.5 * (state.pitch / (0.25 * consts.pi) + 1.0)
    slot = torch.arange(A, device=dev) % ts
    ob = torch.cat([
        torch.ones(W, A, 1, device=dev),  # isValid
        F.one_hot(slot, ts).to(torch.float32).expand(W, A, ts),
        live,
        _normalized_pos(m, state.pos) * live,
        yaw_n[..., None] * live,
        pitch_n[..., None] * live,
        state.vel * live,
        F.one_hot(state.stand_cur.long(), 3).to(torch.float32) * live,
        state.in_zone.to(torch.float32)[..., None] * live,
    ], dim=-1)
    return ob, alive


def _global_obs(cfg: EnvConfig, m: MapData, state: WorldState):
    """[W, 2, 16]: team id, match fraction remaining, zone observation."""
    W = state.hp.shape[0]
    dev = state.pos.device
    frac = _div(float(cfg.episode_len) - state.cur_step.to(torch.float32),
                cfg.episode_len)
    if cfg.task == Task.TDM:
        zone = torch.zeros(W, 2, 13, device=dev)
        zone[..., 7] = 1.0
    else:
        zi = state.zone_cur.long()
        center = 0.5 * (m.zone_min[zi] + m.zone_max[zi])
        ncenter = _normalized_pos(m, center)  # [W, 3]
        ctrl = state.zone_controlling[:, None]
        team = torch.arange(2, device=dev)
        per_world = torch.stack([
            state.zone_contested.to(torch.float32),
            state.zone_captured.to(torch.float32),
            _div(state.zone_steps_until_point.to(torch.float32),
                 consts.zone_point_interval),
            _div(state.zone_steps_remaining.to(torch.float32),
                 consts.num_steps_per_zone),
        ], dim=-1)  # [W, 4]
        zone = torch.cat([
            ncenter[:, None].expand(W, 2, 3),
            (ctrl == team).to(torch.float32)[..., None],
            ((ctrl != -1) & (ctrl != team)).to(torch.float32)[..., None],
            per_world[:, None].expand(W, 2, 4),
            # a fifth zone (town_map's) is all zeros, as jax.nn.one_hot
            (zi[:, None] == torch.arange(4, device=dev)).to(
                torch.float32)[:, None].expand(W, 2, 4),
        ], dim=-1)
    team_ids = torch.tensor([[0.0, 1.0], [1.0, 0.0]], device=dev)
    return torch.cat([team_ids.expand(W, 2, 2),
                      frac[:, None, None].expand(W, 2, 1), zone], dim=-1)


def full_team_observations_system(
        cfg: EnvConfig, m: MapData, state: WorldState, can_see,
        fwd_lidar, rear_lidar) -> Tuple[Dict[str, torch.Tensor],
                                        torch.Tensor]:
    """Both teams' full-team observations from the step's can_see [W, A,
    ts] (viewer x opponent slot) and lidar ([W, A, 2, 32, 4], [W, A, 2,
    8, 4]). Returns (obs, the new ft_last_known [W, 2, ts, 14 + ts])."""
    W, A = state.hp.shape
    ts = cfg.team_size
    common, alive = common_obs(cfg, m, state)
    common = common.reshape(W, 2, ts, -1)
    live = alive.reshape(W, 2, ts).to(torch.float32)[..., None]
    enemy = torch.tensor([1, 0], device=common.device)  # the other team

    hp = _div(state.hp, 100.0)
    mag = _div(state.mag_bullets.to(torch.float32), 30.0)
    rel = (state.mag_reloading > 0).to(torch.float32)
    heal = _div(state.autoheal_steps.to(torch.float32),
                consts.num_out_of_combat_steps_before_autoheal)
    players = torch.cat([
        common,
        torch.stack([hp, mag, rel, heal], -1).reshape(W, 2, ts, 4) * live,
    ], dim=-1)

    # the enemies of team t are team 1 - t's members
    common_en = common[:, enemy]
    live_en = live[:, enemy]
    was_hit = state.was_shot_count.to(torch.float32).reshape(W, 2, ts)[
        :, enemy]
    fired = (state.fired_shot_t >= 0.0).to(torch.float32).reshape(
        W, 2, ts)[:, enemy]
    # hasLOS[i, j]: member j of team t sees enemy slot i
    has_los = can_see.to(torch.float32).reshape(W, 2, ts, ts).transpose(
        -1, -2)
    knows = ((has_los.sum(-1) > 0.0) | (fired > 0.0)).to(torch.float32)
    enemies = torch.cat([
        common_en, was_hit[..., None] * live_en, fired[..., None] * live_en,
        has_los * live_en, knows[..., None] * live_en,
    ], dim=-1)

    # last known: the enemy's common observation while the team knows its
    # location, kept otherwise, cleared at a reset and on its death
    # (sim.cpp:3263-3293)
    prev = torch.where(state.was_reset[:, None, None, None], 0.0,
                       state.ft_last_known)
    known_now = (knows > 0.0) & (live_en[..., 0] > 0.0)
    killed = state.was_killed.reshape(W, 2, ts)[:, enemy]
    lk = torch.where(known_now[..., None], common_en, prev)
    lk = torch.where(killed[..., None], 0.0, lk)

    obs = {
        "full_team_global": _global_obs(cfg, m, state),
        "full_team_players": players,
        "full_team_enemies": enemies,
        "full_team_last_known_enemies": lk,
        "full_team_fwd_lidar": fwd_lidar.reshape(W, 2, ts,
                                                 *fwd_lidar.shape[2:]),
        "full_team_rear_lidar": rear_lidar.reshape(W, 2, ts,
                                                   *rear_lidar.shape[2:]),
    }
    return obs, lk


def full_team_done_reward(cfg: EnvConfig, state: WorldState):
    """fullTeamDoneRewardSystem (sim.cpp:4720-4749): a team's reward is
    the sum of its members' (in index order), done when every member is
    done. Returns ([W, 2] float32, [W, 2] int32)."""
    W = state.hp.shape[0]
    ts = cfg.team_size
    r = state.reward.reshape(W, 2, ts)
    total = r[..., 0]
    for k in range(1, ts):
        total = total + r[..., k]
    done = (state.done.reshape(W, 2, ts) != 0).all(-1).to(torch.int32)
    return total, done
