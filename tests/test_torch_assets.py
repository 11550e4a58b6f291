"""The port's map loading equals the JAX package's MapData exactly: the
Morton-ordered soup, the committed short culling tables, spawns, zones,
weapons, goal regions and the navmesh spawn tables; and the port's packers
of the JAX kernels' constant tables give the JAX MapData's tables.
Tolerance: none (same float32 bits)."""

import numpy as np
import pytest

import madrona_mp_env_tpu as mp
import madrona_mp_env_tpu_torch as mt
from madrona_mp_env_tpu.assets import formats as jformats
from madrona_mp_env_tpu.assets.map_data import load_map as jload_map
from madrona_mp_env_tpu.ops import culling as jculling
from madrona_mp_env_tpu.ops import raycast_pallas as jrp
from madrona_mp_env_tpu_torch.assets.map_data import load_map
from madrona_mp_env_tpu_torch.ops import culling, raycast, raycast_cull


def _cfg(lib):
    return lib.EnvConfig(
        task=lib.Task.Zone, team_size=6,
        sim_flags=lib.SimFlags.StaggerStarts | lib.SimFlags.RandomFlipTeams,
    )


@pytest.fixture(scope="module")
def maps(simple_map_dir):
    return (jload_map(simple_map_dir, _cfg(mp)),
            load_map(simple_map_dir, _cfg(mt), device="cpu"))


def _eq(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and np.array_equal(a, b)


def test_morton_order_and_hash(simple_map_dir):
    col = jformats.load_collision_data(f"{simple_map_dir}/collisions.bin")
    want = jrp.morton_sort_tris(col.tri_verts)
    got = raycast.morton_sort_tris(col.tri_verts)
    assert _eq(want, got)
    assert culling._tri_hash(got) == jculling._tri_hash(want)


def test_soup(maps):
    jm, tm = maps
    for name in ("v0", "e1", "e2", "normal", "valid"):
        assert _eq(getattr(jm.tris, name), getattr(tm.tris, name)), name
    rows = tm.tris.tri_rows.numpy()
    assert _eq(rows[:, 0:3], jm.tris.v0) and _eq(rows[:, 9:12],
                                                 jm.tris.normal)


def test_short_tables(maps):
    jm, tm = maps
    js, ts = jm.short, tm.short
    assert (js.nx, js.ny, js.K, js.cell_size) == (ts.nx, ts.ny, ts.K,
                                                  ts.cell_size)
    assert _eq(js.grid_min, ts.grid_min)
    assert _eq(js.cand, ts.cand)


def _sorted_verts(simple_map_dir):
    col = jformats.load_collision_data(f"{simple_map_dir}/collisions.bin")
    return raycast.morton_sort_tris(col.tri_verts)


def test_packed_constants(simple_map_dir, maps):
    jm, tm = maps
    tv = _sorted_verts(simple_map_dir)
    T = tm.tris.num_tris
    assert _eq(jm.tris.packed, raycast.pack_tri_consts(tv, pad_to=T))
    assert _eq(jm.tris.sc_packed, raycast_cull.pack_sc2_consts(tv, pad_to=T))


def test_short_table_constants(simple_map_dir, maps):
    """JAX's per-candidate [C * K, 41] table: each candidate's sc2
    constants (zeros for padding) and its global row in column 40 (2^24
    for padding), rebuilt from the port's packer and candidate rows."""
    jm, tm = maps
    full = raycast_cull.pack_sc2_consts(_sorted_verts(simple_map_dir),
                                        pad_to=1).T
    full = np.concatenate([full, np.zeros((1, full.shape[1]), np.float32)])
    cand = tm.short.cand.numpy()
    table = full[np.where(cand >= 0, cand, len(full) - 1)]
    gid = np.where(cand >= 0, cand, 2 ** 24).astype(np.float32)[:, None]
    assert _eq(jm.short.table, np.concatenate([table, gid], axis=1))


def test_short_cell_index(maps):
    import torch

    jm, tm = maps
    g = np.random.default_rng(3)
    pos = g.uniform(-2200, 2200, size=(500, 3)).astype(np.float32)
    want = np.asarray(jculling.short_cell_index(jm.short, pos))
    got = culling.short_cell_index(tm.short, torch.as_tensor(pos)).numpy()
    assert _eq(want, got)


def test_spawns_zones_weapons_goals(maps):
    jm, tm = maps
    for name in ("world_min", "world_max", "side_spawns",
                 "num_default_side_spawns", "common_respawns", "zone_min",
                 "zone_max", "zone_rot", "weapon_mag_size",
                 "weapon_reload_time", "weapon_dmg", "weapon_accuracy",
                 "goal_sub_min", "goal_sub_max", "goal_sub_rot",
                 "goal_num_sub", "goal_attacker_team",
                 "goal_reward_strength"):
        assert _eq(getattr(jm, name), getattr(tm, name)), name
    assert _eq(jm.num_extra_side_spawns, tm.num_extra_side_spawns)
    assert (jm.num_zones, jm.num_common_respawns, jm.num_goal_regions) == (
        tm.num_zones, tm.num_common_respawns, tm.num_goal_regions)
    assert float(jm.max_dist) == float(tm.max_dist)


def test_navmesh_spawn_tables(maps):
    jm, tm = maps
    for name in ("nav_verts", "nav_tri_indices", "nav_centroids",
                 "nav_area_cdf"):
        assert _eq(getattr(jm, name), getattr(tm, name)), name


def test_navmesh_spawn_points(maps):
    """Uniform-by-area navmesh points (the NavmeshSpawn override) from the
    same uniforms; JAX eager, so the same roundings."""
    import torch

    from madrona_mp_env_tpu.sim import spawn as jspawn
    from madrona_mp_env_tpu_torch.sim import spawn

    jm, tm = maps
    u = np.random.default_rng(4).random((64, 3), dtype=np.float32)
    want = np.asarray(jspawn._sample_navmesh_points(u, jm))
    got = spawn._sample_navmesh_points(torch.as_tensor(u), tm).numpy()
    assert _eq(want, got)
