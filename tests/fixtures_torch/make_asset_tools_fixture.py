"""Write the fixture of tests/test_torch_asset_tools.py: the JAX package's
offline asset tools on small inputs.

The inputs are made by this module's own helpers (numpy, no JAX), which
the test calls too; the test checks them against the stored ones first.
The JAX builders run eagerly (``jax.disable_jit()``): jitted XLA fuses
multiply-adds, a ground height an ulp off moves a battery origin, and a
graze can then set another (cell, triangle) bit; the port matches eager
JAX bit for bit. asset_tools_jax.npz holds:

- ``synth/*``: ``culling.build_cell_tables`` on tests/test_culling.py's
  synthetic arena at its battery (6 cells a side, 1,500 rays and 300
  casts a cell, rounds of 2^13 rays and 2^11 casts) cut to 3 rounds:
  ``cand_idx``, ``K``, ``k_raw`` and each round's new bits (parsed from
  its progress lines); ``verify_tables``' mismatch counts on those tables
  (20,000 rays, 4,000 casts);
- ``sc/*``: 4,096 casts drawn as the battery draws them (its origin
  sampler with the build's ground heights, seed SC_SEED, unit normal
  directions) and their (t, winner row) over the padded soup from the
  builder's own sphere-cast closure (``sc_idx_fn``, taken from the
  ``jax.jit`` it passes through);
- ``ray/*``: ``build_ray_tables`` on simple_map (100 rays a cell, rounds
  of 2^13 rays, 2 rounds) and ``verify_ray_tables`` (40,000 rays);
- ``nav/<map>/{tri,adj,next_hop}``: the JAX package's numpy
  ``_tri_adjacency`` and ``_all_pairs_next_hop`` on each bundled map's
  navmesh (float64 centroids of the float32 triangle means), which
  tests/test_torch_bot.py holds the port's tables to;
- ``town/<file>``, ``convert_<case>/<file>``: sha256 of the four .bin
  files of ``tools/make_town_map.py --blocks 2 --seed 3 --cell-size 20``
  and of ``tools/convert_assets.py`` on tests/test_assets_tools.py's two
  inputs (with a navmesh .obj, and the navmesh built from the collision
  mesh).

Regenerate (only after a deliberate change of the JAX reference or of the
inputs):

    JAX_PLATFORMS=cpu python tests/fixtures_torch/make_asset_tools_fixture.py

About 3 minutes; it refuses any JAX backend other than the CPU.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import os
import re
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
PATH = os.path.join(HERE, "asset_tools_jax.npz")

SYNTH_KW = dict(cells_per_side=6, rays_per_cell=1500, casts_per_cell=300,
                round_rays=1 << 13, round_casts=1 << 11, max_rounds=3)
SYNTH_VERIFY = dict(n_rays=20000, n_casts=4000)
RAY_KW = dict(rays_per_cell=100, round_rays=1 << 13, max_rounds=2)
RAY_VERIFY = dict(n_rays=40000)
SC_CASTS = 4096
SC_SEED = 11
SC_RADIUS = 15.0
TOWN_ARGS = ["--blocks", "2", "--seed", "3", "--cell-size", "20.0"]
BINS = ("collisions.bin", "navmesh.bin", "spawns.bin", "zones.bin")
CONVERT_CASES = ("navmesh_obj", "built_navmesh")
NAV_MAPS = ("simple_map", "town_map")


def synth_map(seed=0, n_walls=12, extent=400.0, h=120.0):
    """tests/test_culling.py's closed arena: floor, perimeter and random
    interior walls."""
    rng = np.random.default_rng(seed)
    tris = []

    def quad(p0, p1, p2, p3):
        tris.append([p0, p1, p2])
        tris.append([p0, p2, p3])

    e = extent
    quad([-e, -e, 0], [e, -e, 0], [e, e, 0], [-e, e, 0])  # floor
    for (a, b) in [((-e, -e), (e, -e)), ((e, -e), (e, e)),
                   ((e, e), (-e, e)), ((-e, e), (-e, -e))]:
        quad([a[0], a[1], 0], [b[0], b[1], 0], [b[0], b[1], h],
             [a[0], a[1], h])
    for _ in range(n_walls):
        cx, cy = rng.uniform(-0.7 * e, 0.7 * e, 2)
        L = rng.uniform(60, 220)
        ang = rng.uniform(0, np.pi)
        dx, dy = L * np.cos(ang), L * np.sin(ang)
        quad([cx - dx, cy - dy, 0], [cx + dx, cy + dy, 0],
             [cx + dx, cy + dy, h], [cx - dx, cy - dy, h])
    return np.asarray(tris, np.float32)


def synth_inputs():
    """(Morton-ordered triangles [T, 3, 3], walkable points [M, 3]) of the
    arena, as tests/test_culling.py's fixture makes them."""
    from madrona_mp_env_tpu_torch.ops.raycast import morton_sort_tris

    tv = morton_sort_tris(synth_map(n_walls=30, extent=600.0, h=300.0))
    g = np.linspace(-560, 560, 17)
    xx, yy = np.meshgrid(g, g)
    wp = np.stack([xx.ravel(), yy.ravel(), np.ones(xx.size)], axis=1)
    return tv.astype(np.float32), wp.astype(np.float32)


def map_inputs(scene_dir):
    """(Morton-ordered triangles, walkable points) of a map directory, as
    load_map hands them to the builders."""
    from madrona_mp_env_tpu_torch.assets import formats
    from madrona_mp_env_tpu_torch.assets.map_data import walkable_points
    from madrona_mp_env_tpu_torch.ops.raycast import morton_sort_tris

    col = formats.load_collision_data(
        os.path.join(scene_dir, "collisions.bin"))
    nav = formats.load_navmesh(os.path.join(scene_dir, "navmesh.bin"))
    spawns = formats.load_spawns(os.path.join(scene_dir, "spawns.bin"))
    return morton_sort_tris(col.tri_verts), walkable_points(nav, spawns)


def nav_inputs(scene_dir):
    """(triangle indices [T, 3] int32, float64 centroids [T, 3]) of a map's
    navmesh, as MapData holds them."""
    from madrona_mp_env_tpu_torch.assets import formats

    nav = formats.load_navmesh(os.path.join(scene_dir, "navmesh.bin"))
    tri = nav.tri_indices.astype(np.int32)
    cent = nav.verts.astype(np.float32)[tri].mean(axis=1)
    return tri, cent.astype(np.float64)


def _write_obj(path, lines):
    with open(path, "w") as f:
        f.write("\n".join(lines))


def _box_obj(size, z=0.0):
    """A quad floor + one wall (tests/test_assets_tools.py)."""
    s = size
    return [
        f"v {-s} {-s} {z}", f"v {s} {-s} {z}", f"v {s} {s} {z}",
        f"v {-s} {s} {z}",
        f"v {-s} {-s} {z}", f"v {-s} {s} {z}", f"v {-s} {s} {z + 100}",
        f"v {-s} {-s} {z + 100}",
        "f 1 2 3 4",
        "f 5 6 7 8",
    ]


def _slab_obj(s=400.0):
    """A closed floor slab, top at z = 0 (tests/test_assets_tools.py)."""
    return [
        f"v {-s} {-s} -20", f"v {s} {-s} -20", f"v {s} {s} -20",
        f"v {-s} {s} -20",
        f"v {-s} {-s} 0", f"v {s} {-s} 0", f"v {s} {s} 0",
        f"v {-s} {s} 0",
        "f 1 4 3 2",
        "f 5 6 7 8",
    ]


def convert_inputs(case, tmp):
    """Write tests/test_assets_tools.py's inputs of ``case`` into tmp:
    (collision obj, navmesh obj or None, scene json)."""
    col = os.path.join(tmp, "col.obj")
    nav = None
    rot = 0.5
    if case == "navmesh_obj":
        _write_obj(col, _box_obj(400.0))
        nav = os.path.join(tmp, "nav.obj")
        _write_obj(nav, _box_obj(350.0))
    else:
        _write_obj(col, _slab_obj())
        rot = 0.0
    scene = {
        "a_spawns": [
            {"min": [-300, -300, 0], "max": [-200, -200, 0], "yaw": [0, 1]}
        ],
        "b_spawns": [
            {"min": [200, 200, 0], "max": [300, 300, 0], "yaw": [2, 3]}
        ],
        "respawns": [
            {"min": [-50, -50, 0], "max": [50, 50, 0], "yaw": [0, 6.28]}
        ],
        "zones": [
            {"min": [-100, -100, 0], "max": [100, 100, 200],
             "rotation": rot}
        ],
    }
    js = os.path.join(tmp, "scene.json")
    with open(js, "w") as f:
        json.dump(scene, f)
    return col, nav, js


def bin_digests(out_dir):
    """{file: sha256 hex} of a map directory's four .bin files."""
    out = {}
    for name in BINS:
        with open(os.path.join(out_dir, name), "rb") as f:
            out[name] = hashlib.sha256(f.read()).hexdigest()
    return out


def round_bits(progress_text):
    """Each convergence round's new bits from a builder's progress lines."""
    return np.asarray([int(x) for x in re.findall(r"\+(\d+) bits",
                                                  progress_text)], np.int64)


class _JitRecorder:
    """Stands for the ``jax`` module inside the JAX culling module: every
    function it would jit is kept (and run as is, eagerly under
    disable_jit); the rest is the real module."""

    def __init__(self, jax):
        self._jax, self.fns = jax, []

    def jit(self, fn):
        self.fns.append(fn)
        return fn

    def __getattr__(self, name):
        return getattr(self._jax, name)


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    if jax.default_backend() != "cpu":
        raise SystemExit("run with JAX_PLATFORMS=cpu")
    sys.path.insert(0, REPO)
    from madrona_mp_env_tpu.assets import navmesh as jnav
    from madrona_mp_env_tpu.ops import culling as jc
    from madrona_mp_env_tpu.tools import convert_assets, make_town_map

    out = {}

    # the synthetic arena's PVS tables, the builder's sphere-cast closure
    # on its first casts, and the check
    tv, wp = synth_inputs()
    out["synth/tv"], out["synth/wp"] = tv, wp
    rec = _JitRecorder(jax)
    jc.jax = rec
    buf = io.StringIO()
    try:
        with jax.disable_jit(), contextlib.redirect_stdout(buf):
            raw = jc.build_cell_tables(tv, walkable_points=wp, progress=True,
                                       **SYNTH_KW)
    finally:
        jc.jax = jax
    out["synth/cand_idx"] = raw["cand_idx"]
    out["synth/K"], out["synth/k_raw"] = raw["K"], raw["k_raw"]
    out["synth/round_bits"] = round_bits(buf.getvalue())
    with jax.disable_jit():
        res = jc.verify_tables(tv, jc.pack_tables(raw, tv),
                               walkable_points=wp, **SYNTH_VERIFY)
    out["synth/ray_mismatch"] = res["ray_mismatch"]
    out["synth/sc_mismatch"] = res["sc_mismatch"]

    # the jitted closures in build order: ray_idx_fn, ground_fn, sc_idx_fn
    ground_fn, sc_fn = rec.fns[1], rec.fns[2]
    rng = np.random.default_rng(SC_SEED)
    sample = jc._make_origin_sampler(
        rng, wp, ground_fn, np.asarray(raw["grid_min"]), int(raw["nx"]),
        int(raw["ny"]), float(raw["cell_size"]),
        float(tv.reshape(-1, 3)[:, 2].min() - 10.0),
        float(tv.reshape(-1, 3)[:, 2].max() + 50.0))
    with jax.disable_jit():
        o = sample(SC_CASTS)
        d = rng.normal(size=(SC_CASTS, 3)).astype(np.float32)
        d = d / np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-9)
        t, idx = sc_fn(jax.numpy.asarray(o), jax.numpy.asarray(d))
    out["sc/o"], out["sc/d"] = o, d
    out["sc/t"], out["sc/idx"] = np.asarray(t), np.asarray(idx)

    # simple_map's sensor-ray tables and their check
    tv, wp = map_inputs(os.path.join(REPO, "data", "simple_map"))
    out["ray/tv"], out["ray/wp"] = tv, wp
    buf = io.StringIO()
    with jax.disable_jit(), contextlib.redirect_stdout(buf):
        raw = jc.build_ray_tables(tv, walkable_points=wp, progress=True,
                                  **RAY_KW)
        res = jc.verify_ray_tables(tv, jc.pack_ray_tables(raw, tv),
                                   walkable_points=wp, **RAY_VERIFY)
    out["ray/cand_idx"] = raw["cand_idx"]
    out["ray/K"], out["ray/k_raw"] = raw["K"], raw["k_raw"]
    out["ray/round_bits"] = round_bits(buf.getvalue())
    out["ray/ray_mismatch"] = res["ray_mismatch"]

    # the navmesh tables of the scripted bot (numpy)
    for scene in NAV_MAPS:
        tri, cent = nav_inputs(os.path.join(REPO, "data", scene))
        adj = jnav._tri_adjacency(tri)
        out[f"nav/{scene}/tri"], out[f"nav/{scene}/adj"] = tri, adj
        out[f"nav/{scene}/next_hop"] = jnav._all_pairs_next_hop(cent, adj)

    # the map tools (numpy): digests of their files
    with tempfile.TemporaryDirectory() as tmp:
        town = os.path.join(tmp, "town")
        with contextlib.redirect_stdout(io.StringIO()):
            make_town_map.main(["--out", town] + TOWN_ARGS)
        for k, v in bin_digests(town).items():
            out[f"town/{k}"] = np.asarray(v)
        for case in CONVERT_CASES:
            d = os.path.join(tmp, case)
            os.makedirs(d)
            col, nav, js = convert_inputs(case, d)
            with contextlib.redirect_stdout(io.StringIO()):
                convert_assets.convert(col, nav, js, os.path.join(d, "map"))
            for k, v in bin_digests(os.path.join(d, "map")).items():
                out[f"convert_{case}/{k}"] = np.asarray(v)

    np.savez_compressed(PATH, **out)
    print(f"wrote {PATH}: synth K {out['synth/K']} rounds "
          f"{out['synth/round_bits'].tolist()} mismatches "
          f"{out['synth/ray_mismatch']}/{out['synth/sc_mismatch']}; ray K "
          f"{out['ray/K']} rounds {out['ray/round_bits'].tolist()} "
          f"mismatches {out['ray/ray_mismatch']}")


if __name__ == "__main__":
    main()
