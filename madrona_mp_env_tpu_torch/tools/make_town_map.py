"""Procedural 'town' map generator — the big-map scalability scene.

simple_map (the reference's bundled scene) is ~250 triangles, small
enough that the sensor fans sweep the whole soup (K2). This tool
generates a deterministic multi-thousand-triangle town — street grid,
jittered building blocks with door gaps, border walls — plus spawns/zones,
and runs the full asset pipeline on it (collision bin, navmesh BUILT from
the collision geometry via assets/nav_build.py, spawn/zone bins): numpy
on the host, byte for byte the files of the JAX package's tool. It is the
scene where the fans sweep per-cell candidates (K6, ops/culling.py PVS
tables, tools/build_culling.py); `tools/kernel_bench.py --scene
town_map` and `tools/profile_step.py --scene town_map` measure it.

Usage:
    python -m madrona_mp_env_tpu_torch.tools.make_town_map --out data/town_map \
        [--blocks 6] [--seed 7]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np


def box(lo, hi):
    """12-triangle axis-aligned box (outward winding)."""
    x0, y0, z0 = lo
    x1, y1, z1 = hi
    v = np.array(
        [
            [x0, y0, z0], [x1, y0, z0], [x1, y1, z0], [x0, y1, z0],
            [x0, y0, z1], [x1, y0, z1], [x1, y1, z1], [x0, y1, z1],
        ],
        np.float32,
    )
    f = np.array(
        [
            (0, 2, 1), (0, 3, 2),
            (4, 5, 6), (4, 6, 7),
            (0, 1, 5), (0, 5, 4),
            (1, 2, 6), (1, 6, 5),
            (2, 3, 7), (2, 7, 6),
            (3, 0, 4), (3, 4, 7),
        ],
        np.int64,
    )
    return v, f


def build_town(blocks: int = 6, seed: int = 7):
    """Returns (verts [V,3], faces [F,3], scene dict).

    Layout: a (2*blocks+1)^2 half-extent town — `blocks` x `blocks` city
    blocks separated by streets; each block carries 1-4 buildings with a
    door gap on a random side (two wall slabs + a lintel instead of one
    solid box, so interiors are walkable through the gap)."""
    rng = np.random.default_rng(seed)
    street = 220.0  # street width
    block = 480.0  # city-block pitch
    pitch = street + block
    half = blocks * pitch / 2 + street / 2
    wall_h = 160.0
    verts, faces, nv = [], [], 0

    def add(v, f):
        nonlocal nv
        verts.append(v)
        faces.append(f + nv)
        nv += len(v)

    # floor slab + border walls
    add(*box((-half - 40, -half - 40, -25), (half + 40, half + 40, 0)))
    for lo, hi in (
        ((-half - 40, -half - 40, 0), (half + 40, -half, wall_h)),
        ((-half - 40, half, 0), (half + 40, half + 40, wall_h)),
        ((-half - 40, -half, 0), (-half, half, wall_h)),
        ((half, -half, 0), (half + 40, half, wall_h)),
    ):
        add(*box(lo, hi))

    for bx in range(blocks):
        for by in range(blocks):
            cx = -half + street + bx * pitch + block / 2
            cy = -half + street + by * pitch + block / 2
            n_bld = int(rng.integers(1, 4))
            for _ in range(n_bld):
                w = float(rng.uniform(110, 200))
                d = float(rng.uniform(110, 200))
                h = float(rng.uniform(90, wall_h))
                ox = float(rng.uniform(-block / 2 + w / 2 + 20,
                                       block / 2 - w / 2 - 20))
                oy = float(rng.uniform(-block / 2 + d / 2 + 20,
                                       block / 2 - d / 2 - 20))
                x0, x1 = cx + ox - w / 2, cx + ox + w / 2
                y0, y1 = cy + oy - d / 2, cy + oy + d / 2
                side = int(rng.integers(0, 4))
                door_w, door_h, thick = 70.0, 75.0, 18.0
                if side < 2:  # door on a y-facing wall
                    yw0, yw1 = (y0, y0 + thick) if side == 0 else (y1 - thick, y1)
                    dx = float(rng.uniform(x0 + door_w / 2 + 10,
                                           x1 - door_w / 2 - 10))
                    add(*box((x0, yw0, 0), (dx - door_w / 2, yw1, h)))
                    add(*box((dx + door_w / 2, yw0, 0), (x1, yw1, h)))
                    add(*box((dx - door_w / 2, yw0, door_h),
                             (dx + door_w / 2, yw1, h)))
                    others = [
                        ((x0, y1 - thick, 0), (x1, y1, h)) if side == 0
                        else ((x0, y0, 0), (x1, y0 + thick, h)),
                        ((x0, y0 + thick, 0), (x0 + thick, y1 - thick, h)),
                        ((x1 - thick, y0 + thick, 0), (x1, y1 - thick, h)),
                    ]
                else:  # door on an x-facing wall
                    xw0, xw1 = (x0, x0 + thick) if side == 2 else (x1 - thick, x1)
                    dy = float(rng.uniform(y0 + door_w / 2 + 10,
                                           y1 - door_w / 2 - 10))
                    add(*box((xw0, y0, 0), (xw1, dy - door_w / 2, h)))
                    add(*box((xw0, dy + door_w / 2, 0), (xw1, y1, h)))
                    add(*box((xw0, dy - door_w / 2, door_h),
                             (xw1, dy + door_w / 2, h)))
                    others = [
                        ((x1 - thick, y0, 0), (x1, y1, h)) if side == 2
                        else ((x0, y0, 0), (x0 + thick, y1, h)),
                        ((x0 + thick, y0, 0), (x1 - thick, y0 + thick, h)),
                        ((x0 + thick, y1 - thick, 0), (x1 - thick, y1, h)),
                    ]
                for lo, hi in others:
                    add(*box(lo, hi))
                # flat roof slab
                add(*box((x0, y0, h), (x1, y1, h + 12.0)))

    verts = np.concatenate(verts, axis=0)
    faces = np.concatenate(faces, axis=0)

    sp = half - street / 2  # spawn street centerline
    sb = 90.0

    def sbox(x, y):
        return {
            "min": [x - sb, y - sb, 0.0],
            "max": [x + sb, y + sb, 10.0],
            "yaw": [-np.pi, np.pi],
        }

    scene = {
        "a_spawns": [sbox(-sp, -sp), sbox(0.0, -sp), sbox(sp, -sp)],
        "b_spawns": [sbox(-sp, sp), sbox(0.0, sp), sbox(sp, sp)],
        "respawns": [sbox(-sp, 0.0), sbox(sp, 0.0)],
        "zones": [
            {
                "min": [c[0] - 160.0, c[1] - 160.0, 0.0],
                "max": [c[0] + 160.0, c[1] + 160.0, 120.0],
                "rotation": 0.0,
            }
            for c in (
                (0.0, 0.0),
                (-pitch, 0.0),
                (pitch, 0.0),
                (0.0, -pitch),
                (0.0, pitch),
            )
        ],
    }
    return verts, faces, scene


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--blocks", type=int, default=6)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--cell-size", type=float, default=15.0,
                    help="navmesh voxel size; the reference default "
                         "(agent_radius/4) is too fine for a town-sized "
                         "map to rasterize in reasonable time")
    args = ap.parse_args(argv)

    verts, faces, scene = build_town(args.blocks, args.seed)
    print(f"town: {len(verts)} verts, {len(faces)} tris", flush=True)

    from ..assets.nav_build import NavBuildParams, build_navmesh, \
        result_to_tris
    from .convert_assets import (
        write_collisions, write_navmesh, write_spawns, write_zones,
    )

    os.makedirs(args.out, exist_ok=True)
    tri_verts = verts[faces]
    write_collisions(
        os.path.join(args.out, "collisions.bin"), verts, faces
    )
    seeds = []
    for k in ("a_spawns", "b_spawns", "respawns"):
        for e in scene[k]:
            seeds.append(0.5 * (np.asarray(e["min"]) + np.asarray(e["max"])))
    res = build_navmesh(
        tri_verts.astype(np.float32),
        NavBuildParams(cell_size=args.cell_size),
        keep_seeds=np.asarray(seeds, np.float32),
    )
    nv, nt = result_to_tris(res)
    print(f"navmesh: {len(nv)} verts, {len(nt)} tris, "
          f"{res.num_regions} regions", flush=True)
    write_navmesh(os.path.join(args.out, "navmesh.bin"), nv, nt)
    write_spawns(os.path.join(args.out, "spawns.bin"), scene)
    write_zones(os.path.join(args.out, "zones.bin"), scene)
    print(f"wrote town map to {args.out}")


if __name__ == "__main__":
    main()
