"""Agent spawning (spawnAgents / standardSpawnPoint, reference
src/utils.cpp:273-948).

Spawn selection is sequential over the agents of a world (each spawned
agent changes the next one's scoring and the usage-recency tables), so
the core is a Python loop over the A agents with every world in the batch
dimension. The random draws are batched outside the loop, one draw per
purpose, keyed exactly as the JAX package keys them.

Paths: the initial spawn with usage-recency retry (SpawnInMiddle draws
between the default boxes and the mid-map extras) and the scored respawn,
then the overrides in the JAX package's order: the LearnShooting point
(SimFlags.EnableCurriculum, in a LearnShooting world: x in [-700, 700],
|y| up to 350 on the standard point's side of y = 0), NavmeshSpawn,
HardcodedSpawns (first spawn only), the spawn curriculum (first spawn
only, in an episode that drew it: a point of the team's region of the
episode's pair, facing the other region) and the Turret task's turret
rows (navmesh points, a random yaw, never respawned); RandomizeHPMagazine
draws hp and the magazine.
"""

from __future__ import annotations

import functools

import torch

from .. import consts
from ..config import EnvConfig, SimFlags, Task
from ..assets.map_data import MapData
from ..ops import geom
from ..utils import rng
from .types import Pose, WorldCurriculum, WorldState

_BIG = 1e18

# hardcoded spawn table (reference src/utils.cpp:503-543): x, y, z, yaw;
# 3 per side
HARDCODED_SPAWNS = (
    (510.0, 179.1, -64.0, -2.05),
    (525.8, 17.1, -64.0, -0.80),
    (434.3, 184.7, -64.0, -1.80),
    (1037.2, 449.0, -56.0, 2.37),
    (1094.3, 200.1, -56.0, 1.41),
    (1045.8, 416.8, -56.0, 2.37),
)


@functools.lru_cache(maxsize=None)
def _hardcoded_spawns(device: torch.device) -> torch.Tensor:
    """HARDCODED_SPAWNS [6, 4] on ``device``, copied there once."""
    return torch.tensor(HARDCODED_SPAWNS, dtype=torch.float32, device=device)


def _tri_point(m: MapData, tri, uv):
    """Points of navmesh triangles tri [...] at barycentric uniforms uv
    [..., 2], folded into the triangle -> [..., 3]."""
    flip = uv.sum(-1) > 1.0
    uv = torch.where(flip[..., None], 1.0 - uv, uv)
    w = 1.0 - uv[..., 0] - uv[..., 1]
    pts = m.nav_verts[m.nav_tri_indices[tri]]  # [..., 3, 3]
    return (pts[..., 0, :] * uv[..., 0:1] + pts[..., 1, :] * uv[..., 1:2]
            + pts[..., 2, :] * w[..., None])


def _sample_navmesh_points(u, m: MapData):
    """Uniform-by-area navmesh points: u [..., 3] uniforms -> [..., 3]
    (madrona::Navmesh::samplePoint)."""
    tri = torch.searchsorted(m.nav_area_cdf, u[..., 0].contiguous())
    tri = torch.clamp(tri, 0, m.nav_area_cdf.shape[0] - 1)
    return _tri_point(m, tri, u[..., 1:3])


def _curriculum_points(m: MapData, state: WorldState, side_all, u_misc):
    """The spawn curriculum's points and yaws [W, A] (curriculumSpawnPoint,
    utils.cpp:653-717): each agent takes a uniform triangle of its side's
    region of the episode's (tier, pair) and a uniform point in it, facing
    the other region."""
    tier = state.curr_spawn_tier.long()
    idx = state.curr_spawn_idx.long()
    is_a = side_all == 0  # [W, A]
    tri_list = torch.where(is_a[..., None],
                           m.curr_spawn_a_tris[tier, idx][:, None],
                           m.curr_spawn_b_tris[tier, idx][:, None])
    yaw = torch.where(is_a, m.curr_spawn_a_yaw[tier, idx][:, None],
                      m.curr_spawn_b_yaw[tier, idx][:, None])
    n_valid = torch.clamp((tri_list >= 0).sum(-1).to(torch.int32), min=1)
    pick = (u_misc[..., 0] * n_valid.to(torch.float32)).to(torch.int32)
    pick = torch.clamp(pick, 0, tri_list.shape[-1] - 1).long()
    tri = torch.clamp(torch.gather(tri_list, -1, pick[..., None])[..., 0],
                      0, m.nav_tri_indices.shape[0] - 1)
    return _tri_point(m, tri, u_misc[..., 1:3]), yaw


def _sample_in_spawn(u4, row):
    """Point and yaw inside a spawn box row [..., 8]."""
    mn, mx = row[..., 0:3], row[..., 3:6]
    pt = mn + u4[..., :3] * (mx - mn)
    yaw = row[..., 6] + u4[..., 3] * (row[..., 7] - row[..., 6])
    return pt, yaw


def _u32_sub(a, b):
    return (a - b) & 0xFFFFFFFF


def spawn_agents(cfg: EnvConfig, m: MapData, state: WorldState,
                 key: torch.Tensor, is_respawn: bool) -> WorldState:
    """Spawn every dead agent of every world; key [W, 2]."""
    W, A = state.hp.shape
    dev = state.hp.device
    ts = cfg.team_size
    agent = torch.arange(A, device=dev)
    teams = (agent // ts).to(torch.int32)

    kmid, kbody = rng.split(key, 2).unbind(-2)
    if cfg.has_flag(SimFlags.SpawnInMiddle):
        use_middle = rng.uniform(kmid) < 0.5  # [W]
    else:
        use_middle = None
    cur_step_u32 = state.cur_step.to(torch.int64) & 0xFFFFFFFF  # [W]
    zc = state.zone_cur.long()
    zone_center = 0.5 * (m.zone_min[zc] + m.zone_max[zc])  # [W, 3]
    dead = state.alive == 0.0
    turret = cfg.task == Task.Turret
    is_turret_row = (teams == 1) if turret else torch.zeros_like(teams,
                                                                  dtype=bool)
    if turret and is_respawn:
        dead = dead & ~is_turret_row

    ks = rng.split(kbody, 8)  # [W, 8, 2]
    u_cand = rng.uniform(ks[:, 0], (A, 6))
    u_box = rng.uniform(ks[:, 1], (A, 4))
    u_nav = rng.uniform(ks[:, 3], (A, 4))
    weapon = rng.randint(ks[:, 4], (A,), 0, len(cfg.weapons))
    curriculum = cfg.has_flag(SimFlags.EnableCurriculum)
    if curriculum:
        learn_shooting = (state.world_curriculum
                          == WorldCurriculum.LearnShooting)  # [W]
        u_ls = rng.uniform(ks[:, 2], (A, 2))
        ls_x = -700.0 + u_ls[..., 0] * 1400.0  # [W, A]
    spawn_curr = (cfg.enable_spawn_curriculum and m.has_spawn_curriculum
                  and not is_respawn)

    side_all = torch.where(teams == state.team_a[:, None], 0, 1)  # [W, A]
    if cfg.has_flag(SimFlags.HardcodedSpawns) and not is_respawn:
        hc_idx = torch.clamp(torch.where(side_all == 0, 0, 3)
                             + (agent - teams * ts), 0, 5)
        hc_rows = _hardcoded_spawns(dev)[hc_idx]  # [W, A, 4]
    else:
        hc_rows = None
    # the curriculum's pick and uv, the turret's yaw
    u_misc = (rng.uniform(ks[:, 7], (A, 4)) if turret or spawn_curr
              else None)
    if spawn_curr:
        sc_pts, sc_yaws = _curriculum_points(m, state, side_all, u_misc)
        sc_active = state.curr_spawn_active  # [W]

    rows = m.common_respawns  # [Nc, 8]
    nc = rows.shape[0]
    centers = 0.5 * (rows[:, 0:3] + rows[:, 3:6])
    n_def = m.num_default_side_spawns
    n_extra = m.num_extra_side_spawns
    ns = m.side_spawns.shape[1]
    ns_full = state.spawn_a_used.shape[1]
    ns_iota = torch.arange(ns_full, device=dev)

    pos_c = state.pos
    alive_c = state.alive
    side_used_c = torch.stack([state.spawn_a_used, state.spawn_b_used], 1)
    respawn_used_c = state.spawn_respawn_used

    respawn_scored = is_respawn and nc > 0
    if respawn_scored:
        # spawn-box-to-agent distances; a column is refreshed as its agent
        # respawns (an agent only moves at its own iteration)
        d_mat = geom.norm(centers[None, :, None, :] - pos_c[:, None, :, :])
        dist_zone = geom.norm(centers[None] - zone_center[:, None])
        zone_bonus = torch.where(dist_zone < 100.0, 1000000.0, 0.0)

    pts_l, yaws_l = [], []
    for i in range(A):
        team = int(i // ts)
        is_a = side_all[:, i] == 0  # [W]
        box_u = u_box[:, i]  # [W, 4]

        if respawn_scored:
            used = respawn_used_c[:, :nc]
            used_now = used == cur_step_u32[:, None]
            elapsed = torch.floor(
                consts.delta_t
                * _u32_sub(cur_step_u32[:, None], used).to(torch.float32)
            )
            score = torch.where(elapsed < 3.0, 0.1 * (3.0 - elapsed), 0.0)
            others = (alive_c > 0.0) & (agent != i)  # [W, A]
            near = d_mat < 4.0 * consts.agent_radius
            opp = teams != team
            per_agent = torch.where(
                near, 100000.0,
                torch.where(opp, 0.01 / torch.clamp(d_mat, min=1e-6), 0.0),
            )
            score = score + torch.where(others[:, None, :], per_agent,
                                        0.0).sum(-1)
            score = score + zone_bonus
            score = torch.where(used_now, _BIG, score)
            best = torch.argmin(score, dim=-1)  # [W]
            spawn_row = rows[best] + 0.0
            pt, yaw = _sample_in_spawn(box_u, spawn_row)
            respawn_used = torch.where(
                torch.arange(respawn_used_c.shape[1], device=dev)[None]
                == best[:, None], cur_step_u32[:, None], respawn_used_c,
            )
            side_used = side_used_c
        else:
            # initial spawn with usage-recency retry (utils.cpp:340-389)
            nd_s = torch.where(is_a, int(n_def[0]), int(n_def[1]))
            if use_middle is None:
                offset, count = 0, torch.clamp(nd_s, min=1)
            else:
                ne_s = torch.where(is_a, int(n_extra[0]), int(n_extra[1]))
                offset = torch.where(use_middle, nd_s, 0)[:, None]
                count = torch.clamp(torch.where(use_middle, ne_s, nd_s),
                                    min=1)
            cands = offset + torch.minimum(
                (u_cand[:, i] * count[:, None].to(torch.float32)).to(
                    torch.int32),
                count[:, None] - 1,
            )  # [W, 6]
            usage = torch.where(is_a[:, None], side_used_c[:, 0],
                                side_used_c[:, 1])  # [W, Ns_full]
            used_now = usage == cur_step_u32[:, None]
            cand_used = (
                (cands[:, :, None] == ns_iota) & used_now[:, None, :]
            ).any(-1)  # [W, 6]
            valid = ~cand_used[:, :5]
            first = torch.argmax(valid.to(torch.int32), dim=-1)
            chosen = torch.where(
                valid.any(-1),
                torch.gather(cands, 1, first[:, None])[:, 0],
                cands[:, 5],
            )
            side_rows = torch.where(is_a[:, None, None], m.side_spawns[0],
                                    m.side_spawns[1])  # [W, Ns, 8]
            read = torch.clamp(chosen, 0, ns - 1).long()
            spawn_row = torch.gather(
                side_rows, 1, read[:, None, None].expand(W, 1, 8)
            )[:, 0] + 0.0
            pt, yaw = _sample_in_spawn(box_u, spawn_row)
            side = torch.where(is_a, 0, 1)
            write = (
                (torch.arange(2, device=dev)[None, :, None] == side[:, None,
                                                                    None])
                & (ns_iota[None, None, :] == chosen[:, None, None])
            )
            side_used = torch.where(write, cur_step_u32[:, None, None],
                                    side_used_c)
            respawn_used = respawn_used_c

        if curriculum:
            # the LearnShooting point, on the standard point's side of y = 0
            ls_y = torch.where(pt[:, 1] > 0.0, u_ls[:, i, 1] * 350.0,
                               -u_ls[:, i, 1] * 350.0)
            ls_pt = torch.stack([ls_x[:, i], ls_y, torch.zeros_like(ls_y)],
                                -1)
            pt = torch.where(learn_shooting[:, None], ls_pt, pt)
        if cfg.has_flag(SimFlags.NavmeshSpawn) or (turret and i >= ts):
            nav_pt = _sample_navmesh_points(u_nav[:, i, :3], m)
        if cfg.has_flag(SimFlags.NavmeshSpawn):
            pt = nav_pt
            yaw = u_nav[:, i, 3] * 2.0 * consts.pi
        if hc_rows is not None:
            pt, yaw = hc_rows[:, i, 0:3], hc_rows[:, i, 3]
        if spawn_curr:
            pt = torch.where(sc_active[:, None], sc_pts[:, i], pt)
            yaw = torch.where(sc_active, sc_yaws[:, i], yaw)
        if turret and i >= ts:
            # a turret row: a navmesh point and a random yaw
            pt = nav_pt
            yaw = u_misc[:, i, 3] * 2.0 * consts.pi

        do = dead[:, i]  # [W]
        commit = do[:, None] & (agent == i)  # [W, A]
        pos_c = torch.where(commit[..., None], pt[:, None, :], pos_c)
        alive_c = torch.where(commit, 1.0, alive_c)
        side_used_c = torch.where(do[:, None, None], side_used, side_used_c)
        respawn_used_c = torch.where(do[:, None], respawn_used,
                                     respawn_used_c)
        if respawn_scored:
            d_col = geom.norm(centers[None] - pt[:, None, :])  # [W, Nc]
            d_mat = torch.where(commit[:, None, :], d_col[:, :, None], d_mat)
        pts_l.append(pt)
        yaws_l.append(yaw)

    pts = torch.stack(pts_l, dim=1)  # [W, A, 3]
    yaws = torch.stack(yaws_l, dim=1)

    if turret:
        # the turret weapon follows the user's table
        # (EnvConfig.effective_weapons)
        weapon = torch.where(is_turret_row, len(cfg.weapons), weapon)
    mag_size = m.weapon_mag_size[weapon.long()]
    if cfg.has_flag(SimFlags.RandomizeHPMagazine):
        hp = rng.randint(ks[:, 5], (A,), 1, 11).to(torch.float32) * 10.0
        u_mag = rng.uniform(ks[:, 6], (A,))
        mag = torch.minimum((u_mag * mag_size.to(torch.float32)).to(
            torch.int32), mag_size - 1)
    else:
        hp = torch.full_like(state.hp, 100.0)
        mag = mag_size

    # zone membership at spawn
    rot = m.zone_rot[zc]  # [W]
    p_zf = geom.rotate_z(pts, -rot[:, None])
    zmin_f = geom.rotate_z(m.zone_min[zc], -rot)[:, None]
    zmax_f = geom.rotate_z(m.zone_max[zc], -rot)[:, None]
    in_zone = ((p_zf >= zmin_f) & (p_zf <= zmax_f)).all(-1)
    raised = pts + geom.lift(
        torch.full_like(pts[..., 2], consts.stand_height / 2.0))
    min_dist_zone = geom.norm(raised - zone_center[:, None])

    d = dead
    yaw, pitch = geom.compute_aim(yaws, torch.zeros_like(yaws))
    return state.replace(
        pos=pos_c,
        vel=torch.where(d[..., None], 0.0, state.vel),
        yaw=torch.where(d, yaw, state.yaw),
        pitch=torch.where(d, pitch, state.pitch),
        alive=torch.maximum(state.alive, d.to(torch.float32)),
        hp=torch.where(d, hp, state.hp),
        mag_bullets=torch.where(d, mag, state.mag_bullets),
        mag_reloading=torch.where(d, 0, state.mag_reloading),
        weapon_type=torch.where(d, weapon, state.weapon_type),
        respawn_steps=torch.where(
            d, 0 if is_respawn else consts.respawn_invincible_steps,
            state.respawn_steps,
        ),
        autoheal_steps=torch.where(d, 0, state.autoheal_steps),
        in_zone=torch.where(d, in_zone, state.in_zone),
        min_dist_to_zone=torch.where(d, min_dist_zone,
                                     state.min_dist_to_zone),
        stand_cur=torch.where(d, Pose.Stand, state.stand_cur),
        stand_tgt=torch.where(d, Pose.Stand, state.stand_tgt),
        stand_transition=torch.where(d, 0, state.stand_transition),
        max_vel=torch.where(d, consts.max_walk_velocity, state.max_vel),
        aim_vel_yaw=torch.where(d, 0.0, state.aim_vel_yaw),
        aim_vel_pitch=torch.where(d, 0.0, state.aim_vel_pitch),
        spawn_a_used=side_used_c[:, 0],
        spawn_b_used=side_used_c[:, 1],
        spawn_respawn_used=respawn_used_c,
    )
