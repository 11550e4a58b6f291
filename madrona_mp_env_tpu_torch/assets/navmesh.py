"""Navmesh tables, precomputed on host with NumPy.

What uniform-by-area spawn sampling needs (madrona::Navmesh samplePoint):
vertices, triangle indices, centroids and the area CDF (a CDF +
searchsorted, identical in distribution to the reference's alias table).
The scripted bot's tables, triangle adjacency over shared edges and the
all-pairs next-hop table (reference buildAStarLookup,
src/mgr.cpp:1155-1211), are built on the bot's first use
(``MapData.nav_next_hop``), so maps that no bot walks never pay for them.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .formats import NavmeshData


@dataclass
class NavmeshTables:
    verts: np.ndarray  # [V, 3] f32
    tri_indices: np.ndarray  # [T, 3] i32
    centroids: np.ndarray  # [T, 3] f32
    area_cdf: np.ndarray  # [T] f32 cumulative normalized areas


def build_navmesh_tables(nav: NavmeshData) -> NavmeshTables:
    tri_indices = nav.tri_indices.astype(np.int32)
    verts = nav.verts.astype(np.float32)
    tri_pts = verts[tri_indices]  # [T, 3, 3]
    centroids = tri_pts.mean(axis=1)
    e1 = tri_pts[:, 1] - tri_pts[:, 0]
    e2 = tri_pts[:, 2] - tri_pts[:, 0]
    areas = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)
    total = areas.sum()
    area_cdf = np.cumsum(areas / max(total, 1e-12)).astype(np.float32)
    return NavmeshTables(
        verts=verts,
        tri_indices=tri_indices,
        centroids=centroids.astype(np.float32),
        area_cdf=area_cdf,
    )


def tri_adjacency(tri_indices: np.ndarray) -> np.ndarray:
    """[T, 3] int32: the triangle across edge k (vertices k, k + 1) of
    each triangle, -1 where there is none."""
    num_tris = tri_indices.shape[0]
    edge_map: dict = {}
    adjacency = np.full((num_tris, 3), -1, np.int32)
    for t in range(num_tris):
        for k in range(3):
            a = int(tri_indices[t, k])
            b = int(tri_indices[t, (k + 1) % 3])
            key = (min(a, b), max(a, b))
            if key in edge_map:
                ot, ok = edge_map[key]
                adjacency[t, k] = ot
                adjacency[ot, ok] = t
            else:
                edge_map[key] = (t, k)
    return adjacency


def all_pairs_next_hop(centroids: np.ndarray,
                       adjacency: np.ndarray) -> np.ndarray:
    """next_hop[start, goal] [T, T] int32: the first triangle to move to on
    a shortest path over the adjacency graph, edges weighted by centroid
    distance (the reference's A* g-cost over triangle centres); -1 where
    the goal is unreachable. Floyd-Warshall over float64 ``centroids``
    with successor tracking, k in index order and a strict ``<``, so ties
    keep the earlier path."""
    num_tris = centroids.shape[0]
    inf = np.float64(np.inf)
    dist = np.full((num_tris, num_tris), inf)
    np.fill_diagonal(dist, 0.0)
    w = np.full((num_tris, 3), inf)
    for k in range(3):
        nbr = adjacency[:, k]
        valid = nbr >= 0
        w[valid, k] = np.linalg.norm(
            centroids[valid] - centroids[nbr[valid]], axis=-1
        )
        dist[np.arange(num_tris)[valid], nbr[valid]] = np.minimum(
            dist[np.arange(num_tris)[valid], nbr[valid]], w[valid, k]
        )

    # succ[i, j]: the node after i on the shortest i -> j path
    succ = np.full((num_tris, num_tris), -1, np.int64)
    finite = np.isfinite(dist)
    idx = np.arange(num_tris)
    succ[finite] = np.broadcast_to(idx[None, :], dist.shape)[finite]
    np.fill_diagonal(succ, idx)

    for k in range(num_tris):
        alt = dist[:, k : k + 1] + dist[k : k + 1, :]
        better = alt < dist
        if better.any():
            dist = np.where(better, alt, dist)
            succ = np.where(better, succ[:, k : k + 1], succ)

    return succ.astype(np.int32)
