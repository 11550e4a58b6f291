"""Scripted A* bot (the JAX package's sim/bot.py), batched over worlds.

planAStarAISystem (reference src/sim.cpp:5041-5172): agents whose policy
idx is aStarPolicyID (-1) are driven by a navmesh-pathfinding bot: walk to
the active zone by the all-pairs next-hop table, steer toward the next
waypoint, fire when any opponent is visible, avoid walls by the previous
step's forward lidar. applyBotActionsSystem (sim.cpp:2057-2092) overlays
the bot's actions onto the policy's. Plain PyTorch on every device, as the
JAX planner is plain jnp; ``step_batched`` runs it only when some agent
is a bot.
"""

from __future__ import annotations

import torch

from .. import consts
from ..assets.map_data import MapData
from ..config import EnvConfig
from ..ops import geom
from ..utils import rng
from .types import Actions, WorldState


def _nearest_nav_tri(m: MapData, p: torch.Tensor) -> torch.Tensor:
    """NearestNavTri (sim.cpp:4975-5013): the first nav triangle that
    contains p in 2D (the same side of its three edges), else the one with
    the nearest centroid. p [..., >= 2] -> [...] int64."""
    a2 = m.nav_verts[m.nav_tri_indices][..., :2]  # [T, 3, 2]
    e = torch.roll(a2, -1, dims=1) - a2
    vp = p[..., None, None, :2] - a2  # [..., T, 3, 2]
    cz = e[..., 0] * vp[..., 1] - e[..., 1] * vp[..., 0]  # [..., T, 3]
    gtz = cz > 0.0
    contained = gtz.all(-1) | (~gtz).all(-1)  # [..., T]
    # argmax and argmin return the first extreme index, as jnp's do
    first = torch.argmax(contained.to(torch.int32), dim=-1)
    d = p[..., None, :2] - m.nav_centroids[:, :2]  # [..., T, 2]
    nearest = torch.argmin(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1],
                           dim=-1)
    return torch.where(contained.any(-1), first, nearest)


def plan_bot_actions(cfg: EnvConfig, m: MapData, state: WorldState,
                     key: torch.Tensor) -> Actions:
    """HardcodedBotAction of every agent of every world ([W, A] leaves;
    ``key`` [W, 2] the per-world BOT system key). apply_bot_actions keeps
    them for the bot agents only."""
    W, A = state.yaw.shape
    dev = state.pos.device
    i32 = torch.int32

    r_pitch = rng.randint(key, (A,), 0, 2)  # [W, A]
    reload = state.mag_bullets == 0
    fire = state.prev_can_see.any(-1)  # any opponent visible

    # pathfind to the active zone's centre
    zc = 0.5 * (m.zone_min[state.zone_cur] + m.zone_max[state.zone_cur])
    pos2 = state.pos[..., :2]  # [W, A, 2]
    start_tri = _nearest_nav_tri(m, pos2)  # [W, A]
    goal_tri = _nearest_nav_tri(m, zc)  # [W]
    next_tri = m.nav_next_hop()[start_tri, goal_tri[:, None]]  # [W, A]
    at_goal = next_tri == goal_tri[:, None]
    unreachable = next_tri == -1
    num_nav = m.nav_centroids.shape[0]
    waypoint = torch.where(
        at_goal[..., None], zc[:, None, :2],
        m.nav_centroids[next_tri.clamp(0, num_nav - 1), :2])
    waypoint = torch.where(unreachable[..., None], 0.0, waypoint)

    fwd_x, fwd_y = -torch.sin(state.yaw), torch.cos(state.yaw)
    to_tgt = waypoint - pos2
    tx, ty = to_tgt[..., 0], to_tgt[..., 1]
    dist = geom.sqrt(tx * tx + ty * ty).clamp(min=1e-30)
    dir_x, dir_y = tx / dist, ty / dist
    facing = fwd_x * dir_x + fwd_y * dir_y > 0.6
    move_amount = facing.to(i32)
    cross_z = fwd_x * dir_y - fwd_y * dir_x
    r_yaw = torch.where(cross_z < 0.0, move_amount, 4 - move_amount)
    move_amount = move_amount * 2
    move_angle = torch.zeros((W, A), dtype=i32, device=dev)

    # lidar-based wall avoidance (sim.cpp:5112-5155); the sums count
    # integers below 2^24, exact in any order
    close = state.prev_fwd_depth < 16.0  # [W, A, H, Wl]
    w_idx = torch.arange(consts.fwd_lidar_width, dtype=torch.float32,
                         device=dev)
    count = close.sum((2, 3)).to(torch.float32)
    ang_sum = (close * w_idx).sum((2, 3))
    has_close = count > 0.0
    coll_ang = torch.where(has_close, ang_sum / count.clamp(min=1.0), 0.0)
    width = torch.full_like(coll_ang, float(consts.fwd_lidar_width))
    segment = (coll_ang / width * 8.0).to(i32)  # 0..7: coll_ang <= 31
    # the reference's select: segments 0, 1-2, 3-4, 5-6, 7 -> angles 2..6
    avoid_angle = (segment + 1) // 2 + 2
    avoid_amount = torch.where((segment == 3) | (segment == 4), 2, 1)
    move_angle = torch.where(has_close, avoid_angle, move_angle)
    move_amount = torch.where(has_close, avoid_amount, move_amount).to(i32)

    fire = (fire & ~reload).to(i32)
    r_yaw = torch.where(fire == 1, 2, r_yaw)

    # yaw / pitch rotate buckets [0, 4] as continuous aim rates
    # (applyBotActionsSystem, sim.cpp:2077-2090)
    half = consts.num_turn_buckets // 2
    yaw_rate = consts.discrete_turn_delta * (r_yaw - half).to(torch.float32)
    pitch_rate = consts.discrete_turn_delta * (r_pitch - half).to(
        torch.float32)

    # applyBotActionsSystem maps only HardcodedBotAction.fire into the
    # discrete action (sim.cpp:2070-2075): the bot's reload intent is
    # dropped in the reference, so bots never reload
    def full(v):
        return torch.full((W, A), v, dtype=i32, device=dev)

    return Actions(
        move_amount=move_amount, move_angle=move_angle, fire=fire,
        stand=full(0), aim_yaw=full(consts.discrete_aim_num_yaw_buckets // 2),
        aim_pitch=full(consts.discrete_aim_num_pitch_buckets // 2),
        aim_yaw_rate=yaw_rate, aim_pitch_rate=pitch_rate,
    )


def apply_bot_actions(cfg: EnvConfig, state: WorldState, actions: Actions,
                      bot_actions: Actions) -> Actions:
    """Each leaf of ``bot_actions`` where policy_idx == aStarPolicyID, of
    ``actions`` elsewhere (applyBotActionsSystem, sim.cpp:2057-2092)."""
    is_bot = state.policy_idx == consts.a_star_policy_id
    ours, theirs = bot_actions.leaves(), actions.leaves()
    return Actions(**{k: torch.where(is_bot, ours[k].to(v.dtype), v)
                      for k, v in theirs.items()})


def bot_overlay(cfg: EnvConfig, m: MapData, state: WorldState,
                actions: Actions) -> Actions:
    """Plan with each world's BOT key of this step (the core's step key)
    and overlay the plan on the bot agents."""
    stepk = rng.step_key(state.episode_key, state.cur_step)
    bot = plan_bot_actions(cfg, m, state,
                           rng.system_key(stepk, rng.Salt.BOT))
    return apply_bot_actions(cfg, state, actions, bot)
