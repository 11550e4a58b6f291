"""Binary map file readers.

Pure NumPy readers for the reference's asset formats — the host-side half of
the asset pipeline (reference src/map_importer.cpp:223-567). Formats:

collisions.bin (importCollisionData, map_importer.cpp:223-256):
    AABB world_bounds (6 f32)
    u64 num_materials; u64 name_bytes; char names[name_bytes];
    u32 flags[num_materials]
    u64 num_meshes; u64 total_verts; u64 total_tris;
    f32 verts[total_verts][3]; u32 indices[total_tris][3];
    u32 tri_material[total_tris]; u32 mesh_info[num_meshes][4]
       (vertexOffset, numVertices, triOffset, numTris)

navmesh.bin (importNavmesh, map_importer.cpp:421-506):
    u32 num_verts; f32 verts[num_verts][3];
    u32 num_faces; u32 face_counts[num_faces];
    u32 num_indices; u32 indices[num_indices]

spawns.bin (loadMapSpawnData, map_importer.cpp:508-543):
    u32 nA; Spawn a[nA]; u32 nB; Spawn b[nB]; u32 nC; Spawn common[nC]
    where Spawn = {AABB (6 f32), yawMin f32, yawMax f32}

zones.bin (loadMapZones, map_importer.cpp:545-567):
    u32 num_zones; AABB aabbs[num_zones]; f32 rotations[num_zones]
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

BULLETS_ONLY_FLAG = 1  # CollisionMaterialFlags::BulletsOnly


@dataclass
class CollisionData:
    world_bounds_min: np.ndarray  # [3] f32
    world_bounds_max: np.ndarray  # [3] f32
    tri_verts: np.ndarray  # [T, 3, 3] f32 — dereferenced triangle soup
    tri_materials: np.ndarray  # [T] u32


@dataclass
class NavmeshData:
    verts: np.ndarray  # [V, 3] f32
    tri_indices: np.ndarray  # [T, 3] u32 (faces triangulated)


@dataclass
class SpawnData:
    a_spawns: np.ndarray  # [Na, 8] f32: aabb_min(3), aabb_max(3), yaw_min, yaw_max
    b_spawns: np.ndarray  # [Nb, 8]
    common_respawns: np.ndarray  # [Nc, 8]


@dataclass
class ZoneData:
    aabb_min: np.ndarray  # [Z, 3] f32
    aabb_max: np.ndarray  # [Z, 3] f32
    rotations: np.ndarray  # [Z] f32


def load_collision_data(path: str) -> CollisionData:
    with open(path, "rb") as f:
        data = f.read()
    off = 0
    bounds = np.frombuffer(data, np.float32, 6, off)
    off += 24

    num_mats, = struct.unpack_from("<Q", data, off)
    off += 8
    name_bytes, = struct.unpack_from("<Q", data, off)
    off += 8
    off += name_bytes
    flags = np.frombuffer(data, np.uint32, num_mats, off)
    off += 4 * num_mats

    num_meshes, = struct.unpack_from("<Q", data, off)
    off += 8
    nverts, = struct.unpack_from("<Q", data, off)
    off += 8
    ntris, = struct.unpack_from("<Q", data, off)
    off += 8

    verts = np.frombuffer(data, np.float32, nverts * 3, off).reshape(-1, 3)
    off += nverts * 12
    indices = np.frombuffer(data, np.uint32, ntris * 3, off).reshape(-1, 3)
    off += ntris * 12
    tri_mats = np.frombuffer(data, np.uint32, ntris, off)
    off += ntris * 4
    mesh_info = np.frombuffer(data, np.uint32, num_meshes * 4, off).reshape(-1, 4)
    off += num_meshes * 16

    # Dereference per-mesh local indices into a flat triangle soup and drop
    # bullets-only materials, matching filterMeshes (map_importer.cpp:126-221).
    tris = []
    mats = []
    for vo, _nv, to, nt in mesh_info:
        local_idx = indices[to : to + nt] + vo
        local_mats = tri_mats[to : to + nt]
        keep = flags[local_mats] != BULLETS_ONLY_FLAG
        tris.append(verts[local_idx[keep]])
        mats.append(local_mats[keep])

    tri_verts = (
        np.concatenate(tris, axis=0)
        if tris
        else np.zeros((0, 3, 3), np.float32)
    )
    tri_materials = (
        np.concatenate(mats, axis=0) if mats else np.zeros((0,), np.uint32)
    )

    return CollisionData(
        world_bounds_min=bounds[:3].copy(),
        world_bounds_max=bounds[3:].copy(),
        tri_verts=np.ascontiguousarray(tri_verts, np.float32),
        tri_materials=tri_materials,
    )


def load_navmesh(path: str) -> NavmeshData:
    with open(path, "rb") as f:
        data = f.read()
    off = 0
    nv, = struct.unpack_from("<I", data, off)
    off += 4
    verts = np.frombuffer(data, np.float32, nv * 3, off).reshape(-1, 3)
    off += nv * 12
    nf, = struct.unpack_from("<I", data, off)
    off += 4
    face_counts = np.frombuffer(data, np.uint32, nf, off)
    off += nf * 4
    ni, = struct.unpack_from("<I", data, off)
    off += 4
    indices = np.frombuffer(data, np.uint32, ni, off)
    off += ni * 4

    # Fan-triangulate polygons (the reference's runtime navmesh is already
    # triangles on simple_map; Recast can emit up to 6-vert polys).
    tris = []
    cursor = 0
    for count in face_counts:
        poly = indices[cursor : cursor + count]
        cursor += count
        for k in range(1, count - 1):
            tris.append((poly[0], poly[k], poly[k + 1]))
    tri_indices = np.asarray(tris, np.uint32).reshape(-1, 3)

    return NavmeshData(
        verts=np.ascontiguousarray(verts, np.float32), tri_indices=tri_indices
    )


def _read_spawn_block(data: bytes, off: int):
    n, = struct.unpack_from("<I", data, off)
    off += 4
    spawns = np.frombuffer(data, np.float32, n * 8, off).reshape(-1, 8).copy()
    off += n * 32
    return spawns, off


def load_spawns(path: str) -> SpawnData:
    with open(path, "rb") as f:
        data = f.read()
    a, off = _read_spawn_block(data, 0)
    b, off = _read_spawn_block(data, off)
    c, off = _read_spawn_block(data, off)
    return SpawnData(a_spawns=a, b_spawns=b, common_respawns=c)


def load_zones(path: str) -> ZoneData:
    with open(path, "rb") as f:
        data = f.read()
    nz, = struct.unpack_from("<I", data, 0)
    aabbs = np.frombuffer(data, np.float32, nz * 6, 4).reshape(-1, 6)
    rotations = np.frombuffer(data, np.float32, nz, 4 + nz * 24)
    return ZoneData(
        aabb_min=aabbs[:, :3].copy(),
        aabb_max=aabbs[:, 3:].copy(),
        rotations=rotations.copy(),
    )
