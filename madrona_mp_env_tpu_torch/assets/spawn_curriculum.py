"""The 5-tier navmesh spawn curriculum, precomputed on the host with numpy.

buildSpawnCurriculum / buildSpawnCurriculumTier (reference
src/mgr.cpp:884-911, 685-882): for each of 5 team separations (10, 20,
40, 80 and 160 agent radii), pairs of navmesh spawn regions. Region A
grows by BFS around a seed triangle within the tier's spawn radius;
region B's seed lies at a graph distance within +-25% of the target
separation; each region has room for a team. At reset an episode draws a
tier from the curriculum CDF and a pair of it (sim/reset.py), and the two
teams spawn in their regions facing each other (curriculumSpawnPoint,
src/utils.cpp:653-717; sim/spawn.py).

Separation is measured between triangle centroids over the adjacency
graph (the JAX package's deviation from the reference's edge-entry-point
Dijkstra, within one triangle's radius). The tables equal the JAX
package's array for array: the same loops, the same float32 geometry and
the same heap order, whose ties break on (distance, triangle).

``build_spawn_curriculum`` keeps its tables in a cache directory inside
the checkout (``build/spawn_curriculum/``, ignored by git), keyed by the
navmesh's bytes.
"""

from __future__ import annotations

import hashlib
import heapq
import os
from collections import deque
from dataclasses import dataclass

import numpy as np

from .. import consts
from .navmesh import NavmeshTables, tri_adjacency

NUM_TIERS = 5
MAX_SPAWNS_PER_TIER = 256
MAX_REGION_TRIS = 24

TIER_SEPARATIONS = np.asarray(
    [10.0, 20.0, 40.0, 80.0, 160.0]) * consts.agent_radius  # mgr.cpp:886-891
_BASE_RADIUS = 3.0 * consts.agent_radius * 2.0
TIER_SPAWN_RADII = np.asarray(
    [1.0, 1.5, 1.5, 1.5, 1.5]) * _BASE_RADIUS  # mgr.cpp:893-899

MIN_REGION_AREA = 4.0 * np.pi * consts.agent_radius ** 2  # mgr.cpp:770

CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "build", "spawn_curriculum")
_TABLES = ("a_tris", "b_tris", "a_yaw", "b_yaw", "num_spawns")


@dataclass
class SpawnCurriculumTables:
    a_tris: np.ndarray  # [5, S, K] i32 (-1 pad)
    b_tris: np.ndarray  # [5, S, K] i32
    a_yaw: np.ndarray  # [5, S] f32, facing B
    b_yaw: np.ndarray  # [5, S] f32, facing A
    num_spawns: np.ndarray  # [5] i32


def _tri_geometry(nav: NavmeshTables):
    pts = nav.verts[nav.tri_indices]  # [T, 3, 3]
    centroids = pts.mean(axis=1)
    e1 = pts[:, 1] - pts[:, 0]
    e2 = pts[:, 2] - pts[:, 0]
    areas = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)
    return pts, centroids, areas


def _grow_region(start, pts, centroids, areas, adjacency, radius):
    """BFS from ``start`` over the triangles whose 3 vertices all lie
    within ``radius`` of its centroid, up to MAX_REGION_TRIS
    (mgr.cpp:728-775). Returns (triangles, area)."""
    r2 = radius * radius
    center = centroids[start]
    region = []
    area = 0.0
    seen = {start}
    queue = deque([start])
    while queue and len(region) < MAX_REGION_TRIS:
        t = queue.popleft()
        if t != start and np.any(
                np.sum((pts[t] - center) ** 2, axis=-1) > r2):
            continue
        region.append(t)
        area += areas[t]
        for nb in adjacency[t]:
            if nb >= 0 and nb not in seen:
                seen.add(nb)
                queue.append(int(nb))
    return region, area


def _dijkstra(start, edges):
    """Graph distances from ``start`` [T] (inf where unreachable)."""
    dist = np.full((len(edges),), np.inf)
    dist[start] = 0.0
    heap = [(0.0, start)]
    while heap:
        d, t = heapq.heappop(heap)
        if d > dist[t]:
            continue
        for nb, w in edges[t]:
            nd = d + w
            if nd < dist[nb]:
                dist[nb] = nd
                heapq.heappush(heap, (nd, nb))
    return dist


def _build(nav: NavmeshTables) -> SpawnCurriculumTables:
    pts, centroids, areas = _tri_geometry(nav)
    T = len(centroids)
    adjacency = tri_adjacency(nav.tri_indices)

    # edge lengths of the adjacency graph, centroid to centroid
    edges = [[] for _ in range(T)]
    for t in range(T):
        for nb in adjacency[t]:
            if nb >= 0:
                w = float(np.linalg.norm(centroids[t] - centroids[nb]))
                edges[t].append((int(nb), w))

    a_tris = np.full((NUM_TIERS, MAX_SPAWNS_PER_TIER, MAX_REGION_TRIS), -1,
                     np.int32)
    b_tris = np.full_like(a_tris, -1)
    a_yaw = np.zeros((NUM_TIERS, MAX_SPAWNS_PER_TIER), np.float32)
    b_yaw = np.zeros_like(a_yaw)
    num_spawns = np.zeros((NUM_TIERS,), np.int32)

    for tier in range(NUM_TIERS):
        sep = TIER_SEPARATIONS[tier]
        radius = TIER_SPAWN_RADII[tier]
        thresh = sep / 4.0
        base = sep + 2.0 * radius
        lo, hi = base - thresh, base + thresh

        count = 0
        for a_start in range(T):
            if count >= MAX_SPAWNS_PER_TIER:
                break
            a_region, a_area = _grow_region(a_start, pts, centroids, areas,
                                            adjacency, radius)
            if a_area < MIN_REGION_AREA:
                continue
            dist = _dijkstra(a_start, edges)
            for b_start in np.nonzero((dist >= lo) & (dist <= hi))[0]:
                if count >= MAX_SPAWNS_PER_TIER:
                    break
                b_region, b_area = _grow_region(
                    int(b_start), pts, centroids, areas, adjacency, radius)
                if b_area < MIN_REGION_AREA:
                    continue
                to_b = centroids[int(b_start)] - centroids[a_start]
                to_b = to_b / max(np.linalg.norm(to_b), 1e-9)
                yaw = -np.arctan2(to_b[0], to_b[1])
                a_tris[tier, count, :len(a_region)] = a_region
                b_tris[tier, count, :len(b_region)] = b_region
                a_yaw[tier, count] = yaw
                b_yaw[tier, count] = yaw - np.pi
                count += 1
        num_spawns[tier] = count

    return SpawnCurriculumTables(a_tris=a_tris, b_tris=b_tris, a_yaw=a_yaw,
                                 b_yaw=b_yaw, num_spawns=num_spawns)


def cache_path(nav: NavmeshTables, cache_dir: str = CACHE_DIR) -> str:
    digest = hashlib.sha256(nav.tri_indices.tobytes() + nav.verts.tobytes()
                            + b"spawncurr_v1").hexdigest()[:16]
    return os.path.join(cache_dir, f"spawncurr_{digest}.npz")


def build_spawn_curriculum(nav: NavmeshTables, cache_dir: str | None =
                           CACHE_DIR) -> SpawnCurriculumTables:
    """The tables of ``nav``: read from ``cache_dir`` when an earlier call
    wrote them there, else built and written (``cache_dir=None``: built,
    never cached)."""
    path = None if cache_dir is None else cache_path(nav, cache_dir)
    if path is not None and os.path.exists(path):
        with np.load(path) as z:
            return SpawnCurriculumTables(**{k: z[k] for k in _TABLES})
    tables = _build(nav)
    if path is not None:
        os.makedirs(cache_dir, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp.npz"
        np.savez(tmp, **{k: getattr(tables, k) for k in _TABLES})
        os.replace(tmp, path)
    return tables
