"""Movement chain: accel/pose -> aim -> collide-and-slide -> fall.

pvpMovementSystem (reference sim.cpp:2093-2199), pvpContinuousAimSystem
(sim.cpp:2266-2282), pvpDiscreteAimSystem (sim.cpp:2284-2334),
applyVelocitySystem (sim.cpp:889-1028) and fallSystem (sim.cpp:1041-1095)
over all worlds and agents at once ([W, A] leaves). The sphere casts are
batched into four launches by data dependency: L1 = 7 casts per agent
from the start position (slope, low, high, 4 unstick probes), L2 = slide
+ unstick ground check, L3 = ground snap, and the fall cast. A
``CastRoute`` says which sweep serves each batch: L1 against the agent's
short-table cell (K4 culled) or the whole soup (K4 dense), and L2, L3
and fall against the MOVE_MARGIN short tables (K4' packed) or the whole
soup. ``cast_route`` reads the JAX package's switches: MPENV_SC_CULL
("1" by default) and MPENV_SC_PACK (``use_sc_pack``), which put every
batch on the short tables on every map the repo ships.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch

from .. import consts
from ..config import EnvConfig
from ..assets.map_data import MapData
from ..ops import geom
from ..ops.culling import short_cell_index
from ..ops import raycast
from ..ops.raycast import (sc_normals_from_idx, sphere_cast,
                           sphere_cast_culled, sphere_cast_packed)
from .types import Actions, Pose, WorldState

# unstick probes treat anything clear beyond this as fully open: the
# reference argmaxes unclamped distances (src/sim.cpp:1000); the clamp
# keeps the choice identical between the dense and the culled casts, and
# an escape needs only ~2r of room
UNSTICK_RANGE = 64.0

# nonlinear discrete-aim turn tables (sim.cpp:2300-2323)
_YAW_TURNS = [0.0, 0.00390625, 0.0078125, 0.015625, 0.03125, 0.0625, 0.125]
_PITCH_TURNS = [0.0, 0.0078125, 0.015625, 0.03125]


def _up(like: torch.Tensor) -> torch.Tensor:
    return torch.tensor([0.0, 0.0, 1.0], device=like.device)


def movement_system(cfg: EnvConfig, state: WorldState, actions: Actions):
    """Deceleration, pose transitions, acceleration, velocity clamp."""
    alive = state.alive > 0.0

    v = state.vel
    v_len = geom.norm(v)
    v_norm = torch.where(v_len[..., None] > 0.0,
                         v / torch.clamp(v_len[..., None], min=1e-30), 0.0)
    v_len_d = torch.clamp(v_len - consts.deaccelerate_rate * consts.delta_t,
                          min=0.0)
    v = v_norm * v_len_d[..., None]

    trans = state.stand_transition
    cur = state.stand_cur
    tgt = state.stand_tgt
    ticking = trans > 0
    trans = torch.where(ticking, trans - 1, trans)
    cur = torch.where(ticking & (trans == 0), tgt, cur)

    action_pose = actions.stand
    changed = action_pose != tgt
    new_tgt = torch.where(changed, action_pose, tgt)
    dist = torch.abs(new_tgt - cur)
    trans = torch.where(changed, dist * (consts.pose_transition_speed // 2),
                        trans)
    tgt = new_tgt

    accel_max = torch.where(
        cur == Pose.Crouch, 100.0,
        torch.where(cur == Pose.Prone, 50.0, 3000.0),
    )
    move_amount = actions.move_amount.to(torch.float32) * (
        accel_max / (consts.num_move_amount_buckets - 1)
    )
    move_angle = actions.move_angle.to(torch.float32) * (
        2.0 * consts.pi / consts.num_move_angle_buckets
    )
    f_x = move_amount * torch.sin(move_angle)
    f_y = move_amount * torch.cos(move_angle)

    body_fwd, body_right = geom.body_fwd_right(state.yaw)
    accel = body_right * f_x[..., None] + body_fwd * f_y[..., None]
    v = v + accel * consts.delta_t

    respawn_steps = torch.where((move_amount != 0.0) & alive, 0,
                                state.respawn_steps)

    tgt_max = torch.where(
        cur == Pose.Stand,
        torch.where(actions.move_amount == 2, consts.max_run_velocity,
                    consts.max_walk_velocity),
        torch.where(cur == Pose.Crouch, consts.max_crouch_velocity,
                    consts.max_prone_velocity),
    )
    max_vel_adjust = torch.clamp(tgt_max - state.max_vel, -510.0, 510.0)

    v_len2 = geom.norm(v)
    nonzero = v_len2 > 0.0
    # maxVelocity only updates when velocity is nonzero (early return)
    max_vel = torch.where(nonzero & alive, state.max_vel + max_vel_adjust,
                          state.max_vel)
    v_norm2 = torch.where(nonzero[..., None],
                          v / torch.clamp(v_len2[..., None], min=1e-30), 0.0)
    v = v_norm2 * torch.minimum(v_len2, max_vel)[..., None]

    return state.replace(
        vel=torch.where(alive[..., None], v, state.vel),
        stand_cur=torch.where(alive, cur, state.stand_cur),
        stand_tgt=torch.where(alive, tgt, state.stand_tgt),
        stand_transition=torch.where(alive, trans, state.stand_transition),
        max_vel=torch.where(alive, max_vel, state.max_vel),
        respawn_steps=respawn_steps,
    )


def aim_systems(cfg: EnvConfig, state: WorldState, actions: Actions):
    """Continuous + discrete aim (both run every step in the reference)."""
    alive = state.alive > 0.0
    dev = state.yaw.device

    yaw = state.yaw + actions.aim_yaw_rate * consts.delta_t
    pitch = state.pitch + actions.aim_pitch_rate * consts.delta_t
    yaw, pitch = geom.compute_aim(yaw, pitch)

    yaw_turns = torch.tensor(_YAW_TURNS, dtype=torch.float32, device=dev)
    pitch_turns = torch.tensor(_PITCH_TURNS, dtype=torch.float32, device=dev)
    yaw_turns = yaw_turns * consts.pi
    pitch_turns = pitch_turns * consts.pi
    yb = actions.aim_yaw - consts.discrete_aim_num_yaw_buckets // 2
    pb = actions.aim_pitch - consts.discrete_aim_num_pitch_buckets // 2
    yaw = yaw + torch.sign(yb) * yaw_turns[torch.abs(yb).long()]
    pitch = pitch + torch.sign(pb) * pitch_turns[torch.abs(pb).long()]
    yaw, pitch = geom.compute_aim(yaw, pitch)

    return state.replace(
        yaw=torch.where(alive, yaw, state.yaw),
        pitch=torch.where(alive, pitch, state.pitch),
    )


def pose_heights(cur):
    """(top, low) sphere-centre offsets above the feet for a pose."""
    r = consts.agent_radius
    buf = 0.05 * r
    top = torch.where(
        cur == Pose.Crouch, consts.crouch_height - r,
        torch.where(cur == Pose.Prone, consts.prone_height,
                    consts.stand_height - r),
    )
    low = torch.where(cur == Pose.Prone, consts.prone_height - r + buf,
                      consts.prone_height)
    return top, low


def l1_casts(x, v_norm, top, low):
    """The 7 casts per agent that start at x: slope (down from top), low
    and high forward casts, and 4 unstick probes along v_norm rotated by
    k * pi / 2. Returns o, d [W, A, 7, 3] and the probe dirs [W, A, 4, 3]."""
    r = consts.agent_radius
    buf = 0.05 * r
    up = _up(x)
    down = torch.broadcast_to(-up, x.shape)
    o_slope = x + up * top[..., None]
    o_low = x + v_norm * (buf * 0.5) + up * low[..., None]
    o_high = x + v_norm * (buf * 0.5) + up * top[..., None]
    un_dirs = torch.stack(
        [geom.rotate_z(v_norm, torch.tensor(k * consts.pi * 0.5,
                                            device=x.device))
         for k in range(4)],
        dim=-2,
    )
    o_un = (x[..., None, :] - un_dirs * (2.0 * r)
            + up * low[..., None, None])
    o1 = torch.cat([torch.stack([o_slope, o_low, o_high], dim=-2), o_un],
                   dim=-2)
    d1 = torch.cat([torch.stack([down, v_norm, v_norm], dim=-2), un_dirs],
                   dim=-2)
    return o1, d1, un_dirs


def use_sc_pack(m: MapData) -> bool:
    """MPENV_SC_PACK: "1" sends the L2, L3 and fall casts through the
    packed short-table entry (K4'), "0" through the dense sweep (K4 dense),
    "auto" (default) packs when T >= 4 K_mv, the JAX package's gate (its
    sim/movement.py _use_sc_pack): simple_map 256 >= 4 x 48, town_map
    6144 >= 4 x 256."""
    mode = os.environ.get("MPENV_SC_PACK", "auto")
    if mode in ("0", "1"):
        return mode == "1"
    return m.tris.num_tris >= 4 * m.short_mv.K


@dataclass(frozen=True)
class CastRoute:
    """Which sweep serves each batch of the movement pair's casts.

    culled: the L1 batch against the agent's short-table cell (K4
        culled), else over the whole soup (K4 dense);
    packed: the L2, L3 and fall casts against the MOVE_MARGIN tables
        (K4'), else over the whole soup (K4 dense);
    plain: the plain PyTorch versions of those sweeps on any device (the
        plain version of the fused movement kernel), else the entries,
        which launch the kernels on the card.
    """

    culled: bool = True
    packed: bool = True
    plain: bool = False


# the fused movement probe's two entries (tools/probes/
# movement_fused_probe.py): the step's own route, and every cast over the
# whole soup (MPENV_SC_CULL=0 MPENV_SC_PACK=0)
ROUTES = {"culled": CastRoute(True, True), "dense": CastRoute(False, False)}


def cast_route(m: MapData) -> CastRoute:
    """The route the environment chooses: MPENV_SC_CULL "0" sends the L1
    batch over the whole soup (default "1": the short tables, as the JAX
    package's switch of that name), ``use_sc_pack`` the others."""
    culled = (m.short is not None
              and os.environ.get("MPENV_SC_CULL", "1") == "1")
    return CastRoute(culled=culled, packed=use_sc_pack(m))


def move_cells(m: MapData, pos: torch.Tensor, packed=None):
    """The MOVE_MARGIN short-table cell [W * A] of each agent for the L2,
    L3 and fall casts, or None when they sweep the whole soup (packed
    False; None: as ``use_sc_pack`` says)."""
    if not (use_sc_pack(m) if packed is None else packed):
        return None
    return short_cell_index(m.short_mv, pos).reshape(-1)


def _late_casts(m: MapData, o, d, mv_cells, plain=False):
    """The L2, L3 and fall casts o, d [W, A, CPA, 3] -> t [W, A, CPA]: the
    packed entry against each agent's MOVE_MARGIN cell, or the dense
    sweep when ``mv_cells`` is None (their plain versions when ``plain``).
    Neither's winner row is read."""
    r = consts.agent_radius
    if mv_cells is None:
        sweep = raycast._sphere_cast_dense if plain else sphere_cast
        return sweep(o, d, r, m.tris)[0]
    W, A, CPA = o.shape[:3]
    sweep = raycast._sphere_cast_culled_plain if plain else sphere_cast_packed
    t, _ = sweep(o.reshape(W * A, CPA, 3), d.reshape(W * A, CPA, 3), r,
                 mv_cells, m.short_mv, m.tris)
    return t.reshape(W, A, CPA)


def _l1_sweep(m: MapData, o1, d1, x, route: CastRoute):
    """The L1 batch o1, d1 [W, A, 7, 3] -> (t, winner row) [W, A, 7]:
    against each agent's short-table cell of x, or over the whole soup."""
    r = consts.agent_radius
    if not route.culled:
        sweep = raycast._sphere_cast_dense if route.plain else sphere_cast
        return sweep(o1, d1, r, m.tris)
    W, A = x.shape[0], x.shape[1]
    cells = short_cell_index(m.short, x).reshape(W * A)
    sweep = (raycast._sphere_cast_culled_plain if route.plain
             else sphere_cast_culled)
    t1, idx1 = sweep(o1.reshape(W * A, 7, 3), d1.reshape(W * A, 7, 3), r,
                     cells, m.short, m.tris)
    return t1.reshape(W, A, 7), idx1.reshape(W, A, 7)


def apply_velocity_system(cfg: EnvConfig, m: MapData, state: WorldState,
                          route: CastRoute = None):
    """Capsule collide-and-slide via sphere casts; the new position and
    velocity are committed at once (updateMoveStateSystem). ``route``
    (default: ``cast_route(m)``) says which sweep serves each batch."""
    if route is None:
        route = cast_route(m)
    r = consts.agent_radius
    buf = 0.05 * r
    x = state.pos
    up = _up(x)
    down = torch.broadcast_to(-up, x.shape)

    v = state.vel * torch.tensor([1.0, 1.0, 0.0], device=x.device)
    v_len = geom.norm(v)
    moving = v_len > 0.0
    v_norm = torch.where(moving[..., None],
                         v / torch.clamp(v_len[..., None], min=1e-30), 0.0)
    move_dist = v_len * consts.delta_t

    top, low = pose_heights(state.stand_cur)
    is_prone = state.stand_cur == Pose.Prone

    # ---- L1: slope + two forward casts + 4 unstick probes (all from x) ----
    o1, d1, un_dirs = l1_casts(x, v_norm, top, low)
    W, A = x.shape[0], x.shape[1]
    t1, idx1 = _l1_sweep(m, o1, d1, x, route)
    # contact normals only for the three casts that consume them
    n3 = sc_normals_from_idx(o1[..., :3, :], d1[..., :3, :], r,
                             idx1[..., :3], m.tris)
    t_s, n_s = t1[..., 0], n3[..., 0, :]
    t_low, n_low = t1[..., 1], n3[..., 1, :]
    t_high, n_high = t1[..., 2], n3[..., 2, :]
    t_un = t1[..., 3:7]

    slope_block = (
        (n_s[..., 2] > 0.0) & (n_s[..., 2] < 0.7)
        & (geom.dot(n_s, v_norm) < 0.0)
    )

    t_high = torch.where(is_prone, t_low, t_high)
    n_high = torch.where(is_prone[..., None], n_low, n_high)

    high_closer = t_high < t_low
    low_dist_raw = torch.where(high_closer, t_high, t_low)
    normal = torch.where(high_closer[..., None], n_high, n_low)

    stuck = (t_low == 0.0) | (t_high == 0.0)
    low_dist = torch.clamp(low_dist_raw - buf, min=0.0)
    hit_pos = x + v_norm * torch.minimum(low_dist, move_dist)[..., None]

    # unstick resolution (sim.cpp:984-1012), probe distances range-clamped
    t_un_val = torch.where(t_un > UNSTICK_RANGE, 3.0e38, t_un)
    furthest, best_dir_idx = t_un_val.max(dim=-1)
    any_dir = furthest > 0.0
    un_step = torch.clamp(furthest - 2.0 * r, max=-buf)
    best_dir = torch.gather(
        un_dirs, -2, best_dir_idx[..., None, None].expand(W, A, 1, 3)
    )[..., 0, :]
    un_pos = x + best_dir * un_step[..., None]
    un_gc = un_pos + up * top[..., None]

    # ---- L2: one slide step + unstick ground check ----
    slide_dir = geom.normalize(geom.cross(torch.broadcast_to(up, normal.shape),
                                          normal))
    flip = geom.dot(slide_dir, v_norm) < 0.0
    slide_dir = torch.where(flip[..., None], -slide_dir, slide_dir)
    o_slide = x + v_norm * low_dist[..., None] + up * torch.where(
        high_closer, top, low
    )[..., None]
    # the agent's cell of record is its start position x, as in JAX
    mv_cells = move_cells(m, x, route.packed)
    t2 = _late_casts(m, torch.stack([o_slide, un_gc], dim=-2),
                     torch.stack([slide_dir, down], dim=-2), mv_cells,
                     route.plain)
    t_slide = t2[..., 0]
    t_ground_un = t2[..., 1]

    slide_needed = move_dist > low_dist
    slide_dist = torch.clamp(t_slide - buf, min=0.0)
    slide_dist = torch.minimum(slide_dist,
                               torch.clamp(move_dist - low_dist, min=0.0))
    hit_pos = torch.where(
        (slide_needed & (slide_dist > 0.0))[..., None],
        hit_pos + slide_dir * slide_dist[..., None],
        hit_pos,
    )

    # ---- L3: ground snap under the slid position ----
    gc_pos = hit_pos + up * top[..., None]
    t_ground = _late_casts(m, gc_pos[..., None, :], down[..., None, :],
                           mv_cells, route.plain)[..., 0]

    need_unstick = (t_ground <= 0.0) | stuck
    un = need_unstick & any_dir
    hit_pos = torch.where(un[..., None], un_pos, hit_pos)
    gc_pos = torch.where(un[..., None], un_gc, gc_pos)
    t_ground = torch.where(un, t_ground_un, t_ground)
    no_ground = torch.isinf(t_ground)

    # stay top-of-capsule above ground; the fall system drops us
    fall_dist = torch.minimum(t_ground, top) + r
    new_pos = gc_pos - up * fall_dist[..., None]

    to_new = new_pos - x
    valid_move = geom.norm(to_new) > 0.0
    no_move = (~moving) | slope_block | no_ground | (~valid_move)
    out_pos = torch.where(no_move[..., None], x, new_pos)
    # the reference zeroes velocity on every early-return path
    out_vel = torch.where(no_move[..., None], 0.0, to_new / consts.delta_t)
    return state.replace(pos=out_pos, vel=out_vel)


def fall_system(cfg: EnvConfig, m: MapData, state: WorldState,
                route: CastRoute = None):
    """Gravity-limited ground snap; its cast reads the MOVE_MARGIN cell of
    the (post-move) position, or sweeps the whole soup, as ``route``
    (default: ``cast_route(m)``) says."""
    if route is None:
        route = cast_route(m)
    r = consts.agent_radius
    cast_offset = r
    up = _up(state.pos)
    o = state.pos + up * (r + cast_offset)
    t_ground = _late_casts(m, o[..., None, :],
                           torch.broadcast_to(-up, o.shape)[..., None, :],
                           move_cells(m, state.pos, route.packed),
                           route.plain)[..., 0]

    no_fall = torch.isinf(t_ground) | (t_ground < cast_offset)
    fall_dist = torch.clamp(t_ground - cast_offset,
                            max=consts.fall_rate * consts.delta_t)
    new_pos = state.pos - up * fall_dist[..., None]
    keep = no_fall | ~(state.alive > 0.0)
    return state.replace(
        pos=torch.where(keep[..., None], state.pos, new_pos)
    )
