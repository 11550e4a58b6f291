"""Offline asset converter: source geometry -> the four binary map files.

Equivalent of the reference's ``convert_assets`` tool
(src/convert_assets.cpp): turns source meshes + a JSON scene description
into the map directory consumed by the env
(collisions.bin / navmesh.bin / spawns.bin / zones.bin — formats in
assets/formats.py, reference src/map_importer.cpp:223-567).

The collision mesh and navmesh come from Wavefront .obj files (the navmesh
.obj is the walkable-surface mesh — the reference builds it with its
vendored Recast pipeline, src/nav/nav_build.cpp; any navmesh authoring tool
that exports .obj works here). Spawns and zones come from a JSON file:

{
  "a_spawns":  [{"min": [x,y,z], "max": [x,y,z], "yaw": [lo, hi]}, ...],
  "b_spawns":  [...],
  "respawns":  [...],
  "zones":     [{"min": [x,y,z], "max": [x,y,z], "rotation": 0.0}, ...]
}

Usage:
    python -m madrona_mp_env_tpu_torch.tools.convert_assets \\
        --collision-obj map.obj --navmesh-obj navmesh.obj \\
        --scene-json scene.json --out data/my_map
"""

from __future__ import annotations

import argparse
import json
import os
import struct

import numpy as np


def load_obj(path: str):
    """Minimal .obj reader: vertices + (fan-triangulated) faces."""
    verts = []
    faces = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append([float(x) for x in parts[1:4]])
            elif parts[0] == "f":
                idx = [int(p.split("/")[0]) - 1 for p in parts[1:]]
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return (
        np.asarray(verts, np.float32),
        np.asarray(faces, np.uint32).reshape(-1, 3),
    )


def write_collisions(path: str, verts: np.ndarray, tris: np.ndarray,
                     margin: float = 10.0):
    """collisions.bin (importCollisionData layout,
    map_importer.cpp:223-256): one mesh, one default material."""
    lo = verts.min(axis=0) - margin
    hi = verts.max(axis=0) + margin
    with open(path, "wb") as f:
        np.concatenate([lo, hi]).astype(np.float32).tofile(f)
        name = b"default\x00"
        f.write(struct.pack("<Q", 1))  # num materials
        f.write(struct.pack("<Q", len(name)))
        f.write(name)
        np.zeros(1, np.uint32).tofile(f)  # material flags
        f.write(struct.pack("<Q", 1))  # num meshes
        f.write(struct.pack("<Q", len(verts)))
        f.write(struct.pack("<Q", len(tris)))
        verts.astype(np.float32).tofile(f)
        tris.astype(np.uint32).tofile(f)
        np.zeros(len(tris), np.uint32).tofile(f)  # tri materials
        np.asarray(
            [[0, len(verts), 0, len(tris)]], np.uint32
        ).tofile(f)  # mesh info


def write_navmesh(path: str, verts: np.ndarray, tris: np.ndarray):
    """navmesh.bin (importNavmesh layout, map_importer.cpp:421-506)."""
    with open(path, "wb") as f:
        f.write(struct.pack("<I", len(verts)))
        verts.astype(np.float32).tofile(f)
        f.write(struct.pack("<I", len(tris)))
        np.full(len(tris), 3, np.uint32).tofile(f)  # face vert counts
        f.write(struct.pack("<I", tris.size))
        tris.astype(np.uint32).tofile(f)


def _spawn_rows(entries):
    rows = np.zeros((len(entries), 8), np.float32)
    for i, e in enumerate(entries):
        rows[i, 0:3] = e["min"]
        rows[i, 3:6] = e["max"]
        yaw = e.get("yaw", [0.0, 0.0])
        rows[i, 6:8] = yaw
    return rows


def write_spawns(path: str, scene: dict):
    """spawns.bin (loadMapSpawnData layout, map_importer.cpp:508-543)."""
    with open(path, "wb") as f:
        for key in ("a_spawns", "b_spawns", "respawns"):
            rows = _spawn_rows(scene.get(key, []))
            f.write(struct.pack("<I", len(rows)))
            rows.tofile(f)


def write_zones(path: str, scene: dict):
    """zones.bin (loadMapZones layout, map_importer.cpp:545-567)."""
    zones = scene.get("zones", [])
    with open(path, "wb") as f:
        f.write(struct.pack("<I", len(zones)))
        aabbs = np.zeros((len(zones), 6), np.float32)
        rots = np.zeros((len(zones),), np.float32)
        for i, z in enumerate(zones):
            aabbs[i, 0:3] = z["min"]
            aabbs[i, 3:6] = z["max"]
            rots[i] = z.get("rotation", 0.0)
        aabbs.tofile(f)
        rots.tofile(f)


def convert(collision_obj: str, navmesh_obj: str | None, scene_json: str,
            out_dir: str):
    os.makedirs(out_dir, exist_ok=True)
    cv, ct = load_obj(collision_obj)
    write_collisions(os.path.join(out_dir, "collisions.bin"), cv, ct)
    with open(scene_json) as f:
        scene = json.load(f)
    if navmesh_obj is not None:
        nv, nt = load_obj(navmesh_obj)
    else:
        # build the navmesh from the collision geometry itself (the
        # reference's Recast pipeline, src/nav/nav_build.cpp
        # buildNavmeshFromSourceObjects); spawn boxes seed reachability
        # pruning so sealed interiors don't mesh
        from ..assets.nav_build import build_navmesh, result_to_tris

        seeds = []
        for key in ("a_spawns", "b_spawns", "respawns"):
            for e in scene.get(key, []):
                seeds.append(
                    0.5 * (np.asarray(e["min"]) + np.asarray(e["max"]))
                )
        res = build_navmesh(
            cv[ct.astype(np.int64)],
            keep_seeds=np.asarray(seeds, np.float32) if seeds else None,
        )
        nv, nt = result_to_tris(res)
        print(
            f"built navmesh from collision geometry: "
            f"{len(nv)} verts, {len(res.polys)} polys, "
            f"{res.num_regions} regions"
        )
    write_navmesh(os.path.join(out_dir, "navmesh.bin"), nv, nt)
    write_spawns(os.path.join(out_dir, "spawns.bin"), scene)
    write_zones(os.path.join(out_dir, "zones.bin"), scene)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--collision-obj", required=True)
    ap.add_argument("--navmesh-obj", default=None,
                    help="pre-authored walkable mesh; omit to BUILD the "
                         "navmesh from the collision geometry")
    ap.add_argument("--scene-json", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    convert(args.collision_obj, args.navmesh_obj, args.scene_json, args.out)
    print(f"wrote map to {args.out}")


if __name__ == "__main__":
    main()
