"""Build and verify a map directory's PVS culling tables on the card.

Usage:
    python -m madrona_mp_env_tpu_torch.tools.build_culling data/town_map \
        --k-max 1152 [--cells 16] [--rays-per-cell 60000] [--verify] \
        [--device cuda|cpu]

Writes ``<scene_dir>/culling.npz`` (ops/culling.py build_cell_tables:
the ray battery as plain PyTorch sweeps and the sphere-cast battery on K4
dense, on ``--device``; the binning on the host), which load_map picks
up; an existing file that matches the map's triangles is loaded, not
rebuilt. The offline counterpart of the reference's BVH build
(src/mesh_bvh_builder.cpp): run once per map. Open maps need a larger
``--k-max`` (town_map: 1152). ``--verify`` checks the tables on a fresh
battery (verify_tables: K1 and K4 dense against the culled sweeps) and
fails when a query kind's miss rate exceeds ``--miss-rate-tol``. The last
line is a JSON object of the build's and check's seconds, the build's
device seconds and chunks, and K1's and K4 dense's launches.
"""

from __future__ import annotations

import argparse
import json
import os
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("scene_dir")
    ap.add_argument("--cells", type=int, default=16)
    ap.add_argument("--rays-per-cell", type=int, default=60000)
    ap.add_argument("--casts-per-cell", type=int, default=12000)
    ap.add_argument("--k-max", type=int, default=256,
                    help="max candidate-set size; open maps (town) need "
                         "~1.2k — the fan gate still pays at T/K >= 4")
    ap.add_argument("--verify", action="store_true")
    ap.add_argument("--miss-rate-tol", type=float, default=1e-5,
                    help="max acceptable residual PVS miss rate per query")
    ap.add_argument("--verify-rays", type=int, default=500000)
    ap.add_argument("--verify-casts", type=int, default=100000)
    ap.add_argument("--device", default="cuda",
                    help="where the batteries run (cpu: the plain sweeps)")
    args = ap.parse_args(argv)

    from ..assets import formats
    from ..assets.map_data import walkable_points
    from ..ops import culling, raycast

    device = culling.builder_device(args.device)
    col = formats.load_collision_data(
        os.path.join(args.scene_dir, "collisions.bin"))
    nav = formats.load_navmesh(os.path.join(args.scene_dir, "navmesh.bin"))
    spawns = formats.load_spawns(os.path.join(args.scene_dir, "spawns.bin"))
    tri_verts = raycast.morton_sort_tris(col.tri_verts)
    walkable = walkable_points(nav, spawns)

    launches = (raycast.ray_vs_tris, raycast.sphere_cast)
    for fn in launches:
        fn.launches = 0
    stats = {}
    t0 = time.perf_counter()
    tables = culling.load_or_build_cell_tables(
        tri_verts,
        cache_dir=args.scene_dir,
        build_if_missing=True,
        device=device,
        walkable_points=walkable,
        cells_per_side=args.cells,
        rays_per_cell=args.rays_per_cell,
        casts_per_cell=args.casts_per_cell,
        k_max=args.k_max,
        progress=True,
        stats=stats,
    )
    build_s = time.perf_counter() - t0
    print(f"tables: grid {tables.nx}x{tables.ny}, K={tables.K}, "
          f"built/loaded in {build_s:.1f}s on {device}", flush=True)
    out = {"build_s": build_s, "K": tables.K, "device": str(device),
           "built": bool(stats), **{f"build_{k}": v for k, v in stats.items()
                                    if k != "round_bits"},
           "rounds": len(stats.get("round_bits", ())),
           "build_launches": {fn.__name__: fn.launches for fn in launches}}

    if args.verify:
        for fn in launches:
            fn.launches = 0
        t0 = time.perf_counter()
        res = culling.verify_tables(
            tri_verts, tables,
            n_rays=args.verify_rays, n_casts=args.verify_casts,
            walkable_points=walkable,
        )
        verify_s = time.perf_counter() - t0
        print(f"verify ({verify_s:.1f}s): {res}")
        # the battery is Monte Carlo: a long tail of edge-grazing rays
        # keeps surfacing rare (cell, tri) bits, so the residual miss
        # rate is measured here, not assumed zero
        ray_rate = res["ray_mismatch"] / max(res["n_rays"], 1)
        sc_rate = res["sc_mismatch"] / max(res["n_casts"], 1)
        print(f"residual miss rate: ray {ray_rate:.2e}, cast {sc_rate:.2e}")
        out.update(verify_s=verify_s, **res, verify_launches={
            fn.__name__: fn.launches for fn in launches})
    print(json.dumps(out), flush=True)
    if args.verify and max(ray_rate, sc_rate) > args.miss_rate_tol:
        raise AssertionError(f"miss rate above {args.miss_rate_tol}: {res}")
    return out


if __name__ == "__main__":
    main()
