"""Navmesh tables the spawn path reads, precomputed on host with NumPy.

Only what uniform-by-area spawn sampling needs (madrona::Navmesh
samplePoint): vertices, triangle indices, centroids and the area CDF
(a CDF + searchsorted, identical in distribution to the reference's alias
table). The A* next-hop table comes with the scripted bot.
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
