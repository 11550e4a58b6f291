"""Device-resident map data bundle.

Everything the reference's Manager::Impl::init uploads (reference
src/mgr.cpp:1213-1913) that this port's step reads: collision soup, the
PVS cell tables of big maps, the short-range culling tables (two
margins), navmesh spawn tables, spawn boxes, zones,
weapon stats and goal regions. Tensors live on the Env's device.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .. import consts
from ..config import EnvConfig
from ..ops.culling import (MOVE_MARGIN, CellTables, ShortTables,
                           load_cell_tables, load_short_tables)
from ..ops.geom import norm, rotate_z
from ..ops.raycast import TriSoup, make_tri_soup, morton_sort_tris
from . import formats
from .navmesh import build_navmesh_tables


@dataclass
class MapData:
    tris: TriSoup
    world_min: torch.Tensor  # [3]
    world_max: torch.Tensor  # [3]
    # PVS tables of the sensor fans (None: the map has no culling.npz)
    cells: Optional[CellTables]
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

    @property
    def max_dist(self) -> torch.Tensor:
        return norm(self.world_max - self.world_min)


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


def load_map(scene_dir: str, cfg: EnvConfig, device=None,
             tri_pad: int = 128) -> MapData:
    """Load a map directory (collisions.bin, navmesh.bin, spawns.bin,
    zones.bin, culling.npz when present, culling_short.npz and
    culling_short_mv.npz) onto ``device``."""
    col = formats.load_collision_data(
        os.path.join(scene_dir, "collisions.bin")
    )
    nav = build_navmesh_tables(
        formats.load_navmesh(os.path.join(scene_dir, "navmesh.bin"))
    )
    spawns = formats.load_spawns(os.path.join(scene_dir, "spawns.bin"))
    zones = formats.load_zones(os.path.join(scene_dir, "zones.bin"))

    # one canonical triangle order (Morton) shared by the soup and the
    # culling tables: candidate rows address the soup's rows
    tri_verts = morton_sort_tris(col.tri_verts)
    soup = make_tri_soup(tri_verts, pad_to=tri_pad, device=device)
    cells = load_cell_tables(tri_verts, scene_dir, device=device)
    short = load_short_tables(tri_verts, scene_dir, device=device)
    short_mv = load_short_tables(tri_verts, scene_dir, margin=MOVE_MARGIN,
                                 tag="_mv", device=device)

    a_sp, b_sp = spawns.a_spawns, spawns.b_spawns
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

    weapons = cfg.weapons
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

    return MapData(
        tris=soup,
        world_min=dev(col.world_bounds_min),
        world_max=dev(col.world_bounds_max),
        cells=cells,
        short=short,
        short_mv=short_mv,
        nav_verts=dev(nav.verts),
        nav_tri_indices=dev(nav.tri_indices, np.int64),
        nav_centroids=dev(nav.centroids),
        nav_area_cdf=dev(nav.area_cdf),
        side_spawns=dev(side),
        num_default_side_spawns=np.array([len(a_sp), len(b_sp)], np.int32),
        num_extra_side_spawns=np.zeros((2,), np.int32),
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
    )
