"""Device-resident map data bundle.

Everything the reference's Manager::Impl::init uploads (reference
src/mgr.cpp:1213-1913) that this port's step reads: collision soup, the
PVS cell tables of big maps, the sensor-ray tables where the map has
them, the short-range culling tables (two margins), navmesh spawn
tables, the spawn curriculum's region pairs, spawn boxes, zones, weapon
stats, goal regions and the trajectory curriculum's snapshots. Tensors
live on the Env's device.
"""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from .. import consts
from ..config import EnvConfig, SimFlags
from ..ops.culling import (MOVE_MARGIN, CellTables, RayTables, ShortTables,
                           load_or_build_cell_tables,
                           load_or_build_ray_tables, load_short_tables,
                           spawn_box_points)
from ..ops.geom import norm, rotate_z
from ..ops.raycast import TriSoup, make_tri_soup, morton_sort_tris
from . import formats
from .navmesh import all_pairs_next_hop, build_navmesh_tables, tri_adjacency
from .spawn_curriculum import NUM_TIERS, build_spawn_curriculum


@dataclass
class MapData:
    tris: TriSoup
    world_min: torch.Tensor  # [3]
    world_max: torch.Tensor  # [3]
    # PVS tables of the sensor fans (None: the map has no culling.npz)
    cells: Optional[CellTables]
    # sensor-ray tables (None: no culling_ray.npz); the fans sweep them
    # under MPENV_FAN_V9=1 (ops/raycast.py use_fan_v9)
    ray_cells: Optional[RayTables]
    short: ShortTables  # SHORT_MARGIN: the L1 7-cast batch
    short_mv: ShortTables  # MOVE_MARGIN: the L2, L3 and fall casts

    nav_verts: torch.Tensor  # [V, 3]
    nav_tri_indices: torch.Tensor  # [T, 3] i64
    nav_centroids: torch.Tensor  # [T, 3]
    nav_area_cdf: torch.Tensor  # [T]

    # spawn boxes (aabb_min(3), aabb_max(3), yaw_min, yaw_max); side a/b
    # stacked [2, N, 8], per side [defaults..., extras...]
    side_spawns: torch.Tensor
    num_default_side_spawns: np.ndarray  # [2] host ints
    num_extra_side_spawns: np.ndarray  # [2]
    common_respawns: torch.Tensor  # [Nc, 8]
    num_common_respawns: int

    zone_min: torch.Tensor  # [max_zones, 3]
    zone_max: torch.Tensor
    zone_rot: torch.Tensor  # [max_zones]
    num_zones: int
    # [max_zones, ZONE_FRAME_COLS] membership and distance constants
    # (zone_frames); the zone system and the fused tail both read them
    zone_frames: torch.Tensor

    weapon_mag_size: torch.Tensor  # [NW] i32
    weapon_reload_time: torch.Tensor
    weapon_dmg: torch.Tensor  # [NW] f32
    weapon_accuracy: torch.Tensor

    goal_sub_min: torch.Tensor  # [G, S, 3]
    goal_sub_max: torch.Tensor
    goal_sub_rot: torch.Tensor  # [G, S]
    goal_num_sub: torch.Tensor  # [G] i32
    goal_attacker_team: torch.Tensor  # [G] bool
    goal_reward_strength: torch.Tensor  # [G]
    num_goal_regions: int

    # the 8 sub-zones of SimFlags.SubZones (sim/subzones.py): [8, 3] boxes
    # and [8] rotations, map zones 1-2 then the hardcoded boxes
    subzone_min: torch.Tensor
    subzone_max: torch.Tensor
    subzone_rot: torch.Tensor

    # the 5-tier navmesh spawn curriculum (EnvConfig.enable_spawn_curriculum;
    # assets/spawn_curriculum.py): per tier, pairs of navmesh regions
    # [5, S, K] (-1 pad), each side's facing yaw [5, S] and the pairs a
    # tier has [5]; one-entry placeholders when the flag is off
    curr_spawn_a_tris: torch.Tensor
    curr_spawn_b_tris: torch.Tensor
    curr_spawn_a_yaw: torch.Tensor
    curr_spawn_b_yaw: torch.Tensor
    curr_spawn_counts: torch.Tensor
    # every tier has a pair: only then do resets draw from the curriculum.
    # On a map where some tier is empty the flag silently does nothing, as
    # in the JAX package (its load_map's has_sc)
    has_spawn_curriculum: bool
    # the trajectory curriculum's snapshots (data/formats.py
    # CURRICULUM_DTYPE; restored by sim/reset.py): match state [S, 5] i32
    # (step, zone, controller, steps remaining, until point) and players
    # [S, 12, 9] f32 (pos xyz, yaw, pitch, bullets, reloading, hp,
    # flags); one zero entry and a count of 0 without a curriculum file
    curriculum_match_state: torch.Tensor
    curriculum_players: torch.Tensor
    num_curriculum_snapshots: int
    # map_key of the scene and configuration it was loaded for
    key: tuple = field(default=(), repr=False)

    # [T, T] next-hop table of the scripted bot; built by nav_next_hop()
    _next_hop: Optional[torch.Tensor] = field(default=None, repr=False)

    @property
    def max_dist(self) -> torch.Tensor:
        return norm(self.world_max - self.world_min)

    def nav_next_hop(self) -> torch.Tensor:
        """next_hop[start, goal] [T, T] int64 on the map's device (-1:
        unreachable), built on the host on the first call (an O(T^3)
        Floyd-Warshall, navmesh.all_pairs_next_hop) and kept."""
        if self._next_hop is None:
            tri = self.nav_tri_indices.cpu().numpy()
            cent = self.nav_centroids.cpu().numpy().astype(np.float64)
            hop = all_pairs_next_hop(cent, tri_adjacency(tri))
            self._next_hop = torch.as_tensor(
                hop, dtype=torch.int64, device=self.nav_centroids.device)
        return self._next_hop


_HARDCODED_GOAL_REGIONS = [
    # (sub_regions [(min, max, rot)], attacker_team, reward_strength)
    (
        [((625.0, 510.0, -64.0),
          (900.0, 540.0, -56.0 + consts.stand_height * 1.5), 0.0)],
        True,
        1.0,
    ),
    (
        [
            ((938.0, 440.0, -56.0),
             (1030.0, 539.0, -56.0 + consts.stand_height * 1.5), 0.0),
            ((545.0, 102.0, -64.0),
             (630.0, 134.0, -56.0 + consts.stand_height * 1.5), 0.0),
        ],
        True,
        1.0,
    ),
]


# hardcoded sub-zone boxes 2..7 (reference level_gen.cpp:290-326)
HARDCODED_SUBZONES = np.asarray(
    [
        [[-950.0, -500.0, 0.0], [-50.0, 500.0, 1000.0]],
        [[50.0, -500.0, 0.0], [950.0, 500.0, 1000.0]],
        [[-1000.0, -1650.0, 0.0], [-50.0, -600.0, 1000.0]],
        [[50.0, -1650.0, 0.0], [1000.0, -600.0, 1000.0]],
        [[-1000.0, 600.0, 0.0], [-50.0, 1650.0, 1000.0]],
        [[1000.0, 600.0, 0.0], [50.0, 1650.0, 1000.0]],
    ],
    np.float32,
)


def mid_map_extra_spawns(cfg: EnvConfig, tri_verts: np.ndarray):
    """Mid-map spawn cells for SpawnInMiddle (reference
    src/mgr.cpp:1243-1300): a 20 x 20 grid over [-280, -200]..[280, 200];
    the cells that overlap no collision triangle's AABB become spawn boxes,
    the left half side A's extras and the right half side B's. Returns
    ([Na, 8], [Nb, 8]) rows, empty without the flag."""
    empty = np.zeros((0, 8), np.float32)
    if not cfg.has_flag(SimFlags.SpawnInMiddle):
        return empty, empty
    region_min = np.array([-280.0, -200.0, 0.5], np.float32)
    region_max = np.array([280.0, 200.0, 0.5], np.float32)
    cell_dim = 20
    diff = region_max - region_min
    cw, ch = diff[0] / cell_dim, diff[1] / cell_dim
    tri_min = tri_verts.min(axis=1)
    tri_max = tri_verts.max(axis=1)
    a_rows, b_rows = [], []
    for y in range(cell_dim):
        for x in range(cell_dim):
            cmin = region_min + np.array([cw * x, ch * y, 0.5], np.float32)
            cmax = cmin + np.array([cw, ch, 0.5], np.float32)
            overlaps = np.any(np.all(tri_min <= cmax, axis=-1)
                              & np.all(tri_max >= cmin, axis=-1))
            if not overlaps:
                row = np.concatenate([cmin, cmax, [0.0, 2.0 * np.pi]]
                                     ).astype(np.float32)
                (b_rows if x >= cell_dim // 2 else a_rows).append(row)
    return (np.stack(a_rows) if a_rows else empty,
            np.stack(b_rows) if b_rows else empty)


def subzone_boxes(zmin: np.ndarray, zmax: np.ndarray, zrot: np.ndarray):
    """[8, 3] mins, [8, 3] maxs, [8] rotations: sub-zones 0-1 are map
    zones 1-2 (level_gen.cpp:283-289), 2-7 the hardcoded boxes."""
    mins = np.concatenate([zmin[1:3], HARDCODED_SUBZONES[:, 0]], axis=0)
    maxs = np.concatenate([zmax[1:3], HARDCODED_SUBZONES[:, 1]], axis=0)
    rots = np.concatenate([zrot[1:3], np.zeros((6,), np.float32)], axis=0)
    return mins, maxs, rots


# columns of MapData.zone_frames
ZF_CENTER = 0  # 3: 0.5 * (zone_min + zone_max)
ZF_COS, ZF_SIN = 3, 4  # cos(-rot), sin(-rot)
ZF_MIN = 5  # 3: zone_min rotated by -rot (x, y; z kept)
ZF_MAX = 8  # 3: zone_max rotated by -rot
ZONE_FRAME_COLS = 11


def zone_frames(zmin: torch.Tensor, zmax: torch.Tensor,
                zrot: torch.Tensor) -> torch.Tensor:
    """Per-zone constants of zoneSystem's membership test in the zone's
    rotated frame (reference src/sim.cpp:1920-1953) and of the distance to
    its centre: [Z, ZONE_FRAME_COLS] float32. Computed once per map on the
    CPU with the port's own arithmetic (geom.rotate_z), so the CPU path,
    the card's plain path and the fused-tail kernel read the same bits."""
    zmin, zmax, zrot = (x.detach().cpu() for x in (zmin, zmax, zrot))
    ang = -zrot
    return torch.cat([
        0.5 * (zmin + zmax),
        torch.cos(ang)[:, None], torch.sin(ang)[:, None],
        rotate_z(zmin, ang), rotate_z(zmax, ang),
    ], dim=-1).contiguous()


def map_key(scene_dir: str, cfg: EnvConfig,
            curriculum_snapshots: Optional[np.ndarray] = None) -> tuple:
    """What a loaded map depends on of its scene, configuration (the cfg
    fields load_map reads) and trajectory-curriculum snapshots (a digest
    of their bytes): configurations of one key can share one MapData."""
    snaps = None
    if curriculum_snapshots is not None and len(curriculum_snapshots):
        snaps = hashlib.sha256(
            np.ascontiguousarray(curriculum_snapshots).tobytes()).hexdigest()
    return (os.path.realpath(scene_dir), cfg.effective_weapons,
            cfg.has_flag(SimFlags.SpawnInMiddle),
            cfg.enable_spawn_curriculum, snaps)


def walkable_points(nav_raw: formats.NavmeshData,
                    spawns: formats.SpawnData) -> np.ndarray:
    """The table builders' battery origins [M, 3]: navmesh vertices and
    triangle centroids, and grids over the spawn boxes (at map edges the
    navmesh-driven sampler under-covers; every episode's first sensor
    fans start inside them)."""
    return np.concatenate(
        [
            nav_raw.verts,
            nav_raw.verts[nav_raw.tri_indices].mean(axis=1),
            spawn_box_points(
                (spawns.a_spawns, spawns.b_spawns, spawns.common_respawns)
            ),
        ],
        axis=0,
    ).astype(np.float32)


def load_map(scene_dir: str, cfg: EnvConfig, device=None,
             tri_pad: int = 128,
             curriculum_snapshots: Optional[np.ndarray] = None,
             build_culling: bool = False) -> MapData:
    """Load a map directory (collisions.bin, navmesh.bin, spawns.bin,
    zones.bin, culling.npz and culling_ray.npz when present,
    culling_short.npz and culling_short_mv.npz) onto ``device``, with the
    trajectory curriculum's ``curriculum_snapshots`` (records of
    data/formats.py CURRICULUM_DTYPE, load_curriculum_snapshots).
    ``build_culling=True`` builds a missing or stale culling.npz and
    culling_ray.npz with the builders' defaults (ops/culling.py; slow) on
    ``device``, None meaning the first CUDA device, and writes them into
    the map directory."""
    col = formats.load_collision_data(
        os.path.join(scene_dir, "collisions.bin")
    )
    nav_raw = formats.load_navmesh(os.path.join(scene_dir, "navmesh.bin"))
    nav = build_navmesh_tables(nav_raw)
    spawns = formats.load_spawns(os.path.join(scene_dir, "spawns.bin"))
    zones = formats.load_zones(os.path.join(scene_dir, "zones.bin"))

    # one canonical triangle order (Morton) shared by the soup and the
    # culling tables: candidate rows address the soup's rows
    tri_verts = morton_sort_tris(col.tri_verts)
    soup = make_tri_soup(tri_verts, pad_to=tri_pad, device=device)
    walkable = walkable_points(nav_raw, spawns) if build_culling else None
    cells = load_or_build_cell_tables(tri_verts, scene_dir, build_culling,
                                      device, walkable_points=walkable)
    ray_cells = load_or_build_ray_tables(tri_verts, scene_dir, build_culling,
                                         device, walkable_points=walkable)
    short = load_short_tables(tri_verts, scene_dir, device=device)
    short_mv = load_short_tables(tri_verts, scene_dir, margin=MOVE_MARGIN,
                                 tag="_mv", device=device)

    a_sp, b_sp = spawns.a_spawns, spawns.b_spawns
    num_default = np.array([len(a_sp), len(b_sp)], np.int32)
    extra_a, extra_b = mid_map_extra_spawns(cfg, col.tri_verts)
    a_sp = np.concatenate([a_sp, extra_a], axis=0)
    b_sp = np.concatenate([b_sp, extra_b], axis=0)
    n_side = max(len(a_sp), len(b_sp), 1)
    side = np.zeros((2, n_side, 8), np.float32)
    side[0, : len(a_sp)] = a_sp
    side[1, : len(b_sp)] = b_sp

    nz = zones.aabb_min.shape[0]
    zmin = np.zeros((consts.max_zones, 3), np.float32)
    zmax = np.zeros((consts.max_zones, 3), np.float32)
    zrot = np.zeros((consts.max_zones,), np.float32)
    zmin[:nz] = zones.aabb_min
    zmax[:nz] = zones.aabb_max
    zrot[:nz] = zones.rotations

    sub_min, sub_max, sub_rot = subzone_boxes(zmin, zmax, zrot)
    weapons = cfg.effective_weapons
    num_goals = len(_HARDCODED_GOAL_REGIONS)
    max_sub = 3
    gmin = np.zeros((num_goals, max_sub, 3), np.float32)
    gmax = np.zeros((num_goals, max_sub, 3), np.float32)
    grot = np.zeros((num_goals, max_sub), np.float32)
    gnum = np.zeros((num_goals,), np.int32)
    gatt = np.zeros((num_goals,), bool)
    gstr = np.zeros((num_goals,), np.float32)
    for gi, (subs, att, strength) in enumerate(_HARDCODED_GOAL_REGIONS):
        gnum[gi] = len(subs)
        gatt[gi] = att
        gstr[gi] = strength
        for si, (mn, mx, rot) in enumerate(subs):
            gmin[gi, si] = mn
            gmax[gi, si] = mx
            grot[gi, si] = rot

    def dev(x, dtype=None):
        return torch.as_tensor(np.asarray(x, dtype), device=device)

    # the spawn curriculum's tables, built (or read from their cache) only
    # when the flag is on
    if cfg.enable_spawn_curriculum:
        sc = build_spawn_curriculum(nav)
        sc_tables = (sc.a_tris, sc.b_tris, sc.a_yaw, sc.b_yaw,
                     sc.num_spawns)
    else:
        sc_tables = (np.full((NUM_TIERS, 1, 1), -1, np.int32),
                     np.full((NUM_TIERS, 1, 1), -1, np.int32),
                     np.zeros((NUM_TIERS, 1), np.float32),
                     np.zeros((NUM_TIERS, 1), np.float32),
                     np.zeros((NUM_TIERS,), np.int32))

    if curriculum_snapshots is not None and len(curriculum_snapshots):
        cms = curriculum_snapshots["match_state"]
        cpl = curriculum_snapshots["players"]
    else:
        cms = np.zeros((1, 5), np.int32)
        cpl = np.zeros((1, 2 * consts.max_team_size, 9), np.float32)
    n_snap = 0 if curriculum_snapshots is None else len(curriculum_snapshots)

    return MapData(
        tris=soup,
        world_min=dev(col.world_bounds_min),
        world_max=dev(col.world_bounds_max),
        cells=cells,
        ray_cells=ray_cells,
        short=short,
        short_mv=short_mv,
        nav_verts=dev(nav.verts),
        nav_tri_indices=dev(nav.tri_indices, np.int64),
        nav_centroids=dev(nav.centroids),
        nav_area_cdf=dev(nav.area_cdf),
        side_spawns=dev(side),
        num_default_side_spawns=num_default,
        num_extra_side_spawns=np.array([len(extra_a), len(extra_b)],
                                       np.int32),
        common_respawns=dev(spawns.common_respawns),
        num_common_respawns=int(spawns.common_respawns.shape[0]),
        zone_min=dev(zmin),
        zone_max=dev(zmax),
        zone_rot=dev(zrot),
        num_zones=nz,
        zone_frames=zone_frames(torch.as_tensor(zmin), torch.as_tensor(zmax),
                                torch.as_tensor(zrot)).to(device),
        weapon_mag_size=dev([w.mag_size for w in weapons], np.int32),
        weapon_reload_time=dev([w.reload_time for w in weapons], np.int32),
        weapon_dmg=dev([w.dmg_per_bullet for w in weapons], np.float32),
        weapon_accuracy=dev([w.accuracy_scale for w in weapons], np.float32),
        goal_sub_min=dev(gmin),
        goal_sub_max=dev(gmax),
        goal_sub_rot=dev(grot),
        goal_num_sub=dev(gnum),
        goal_attacker_team=dev(gatt),
        goal_reward_strength=dev(gstr),
        num_goal_regions=num_goals,
        subzone_min=dev(sub_min),
        subzone_max=dev(sub_max),
        subzone_rot=dev(sub_rot),
        curr_spawn_a_tris=dev(sc_tables[0], np.int64),
        curr_spawn_b_tris=dev(sc_tables[1], np.int64),
        curr_spawn_a_yaw=dev(sc_tables[2]),
        curr_spawn_b_yaw=dev(sc_tables[3]),
        curr_spawn_counts=dev(sc_tables[4]),
        has_spawn_curriculum=bool((sc_tables[4] > 0).all()),
        curriculum_match_state=dev(cms, np.int32),
        curriculum_players=dev(cpl, np.float32),
        num_curriculum_snapshots=n_snap,
        key=map_key(scene_dir, cfg, curriculum_snapshots),
    )
