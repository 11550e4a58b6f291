"""Short-range candidate tables for the movement sphere casts.

Movement casts are xy-bounded: the unstick probes are range-clamped at
UNSTICK_RANGE (64) and start <= 2r from the agent, forward and slide
travel is <= max_run_velocity * dt + buf (~20), and every straight-down
cast stays within r of its origin column. So the per-cell candidate set
"triangles whose xy-AABB meets the margin-expanded cell" is exact for
these casts by construction. The tables are committed per map
(``<map>/culling_short.npz``) and keyed by ``_tri_hash`` of the Morton-
ordered soup; a missing or stale cache is rebuilt here (pure AABB tests,
milliseconds) without writing anything.
"""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

SHORT_TABLE_VERSION = 1
SHORT_MARGIN = 130.0


@dataclass
class ShortTables:
    """C = nx * ny xy cells, K candidates per cell."""

    cand: torch.Tensor  # [C * K] i32 global triangle rows, -1 padding
    grid_min: np.ndarray  # [2] f64
    cell_size: float
    nx: int
    ny: int
    K: int


def _tri_hash(tri_verts: np.ndarray) -> str:
    return hashlib.sha256(
        np.ascontiguousarray(tri_verts, np.float32).tobytes()
    ).hexdigest()[:16]


def short_cell_index(st: ShortTables, pos: torch.Tensor) -> torch.Tensor:
    """pos [..., 3] -> clamped xy cell index [...] i32 (float32 math)."""
    x0, y0 = (float(np.float32(g)) for g in st.grid_min)
    cs = float(np.float32(st.cell_size))
    gx = torch.clamp(((pos[..., 0] - x0) / cs).to(torch.int32), 0, st.nx - 1)
    gy = torch.clamp(((pos[..., 1] - y0) / cs).to(torch.int32), 0, st.ny - 1)
    return gy * st.nx + gx


def build_short_tables(tri_verts: np.ndarray, cells_per_side: int = 12,
                       margin: float = SHORT_MARGIN) -> dict:
    """Exact-by-construction short-range tables (host AABB tests);
    tri_verts must be in the soup's Morton order."""
    tv = np.asarray(tri_verts, np.float32)
    lo = tv.reshape(-1, 3).min(axis=0)
    hi = tv.reshape(-1, 3).max(axis=0)
    nx = ny = int(cells_per_side)
    cell_size = float(
        max(hi[0] - lo[0], hi[1] - lo[1]) / cells_per_side + 1e-3
    )
    tmin = tv.min(axis=1)
    tmax = tv.max(axis=1)
    cand_rows = []
    k_needed = 1
    for iy in range(ny):
        for ix in range(nx):
            x0 = lo[0] + ix * cell_size - margin
            x1 = lo[0] + (ix + 1) * cell_size + margin
            y0 = lo[1] + iy * cell_size - margin
            y1 = lo[1] + (iy + 1) * cell_size + margin
            hit = (
                (tmin[:, 0] <= x1) & (tmax[:, 0] >= x0)
                & (tmin[:, 1] <= y1) & (tmax[:, 1] >= y0)
            )
            idx = np.nonzero(hit)[0].astype(np.int32)
            cand_rows.append(idx)
            k_needed = max(k_needed, len(idx))
    K = -(-k_needed // 8) * 8
    cand = np.full((nx * ny, K), -1, np.int32)
    for c, idx in enumerate(cand_rows):
        cand[c, : len(idx)] = idx
    return {
        "version": np.int32(SHORT_TABLE_VERSION),
        "cand_idx": cand,
        "grid_min": np.asarray([lo[0], lo[1]], np.float64),
        "cell_size": np.float64(cell_size),
        "nx": np.int32(nx),
        "ny": np.int32(ny),
        "K": np.int32(K),
        "margin": np.float64(margin),
    }


def _short_tables(raw: dict, device=None) -> ShortTables:
    """ShortTables from the raw arrays; the culled sphere-cast kernel reads
    each candidate's row of the soup's [T, 16] table through ``cand``."""
    cand = np.asarray(raw["cand_idx"], np.int32)  # [C, K]
    return ShortTables(
        cand=torch.as_tensor(cand.reshape(-1), device=device),
        grid_min=np.asarray(raw["grid_min"], np.float64),
        cell_size=float(raw["cell_size"]),
        nx=int(raw["nx"]),
        ny=int(raw["ny"]),
        K=int(cand.shape[1]),
    )


def load_short_tables(tri_verts: np.ndarray, cache_dir: Optional[str],
                      margin: float = SHORT_MARGIN, device=None
                      ) -> ShortTables:
    """``<cache_dir>/culling_short.npz`` when it matches these triangles and
    margin, else tables built in memory."""
    key = _tri_hash(tri_verts)
    path = None if cache_dir is None else os.path.join(
        cache_dir, "culling_short.npz"
    )
    if path is not None and os.path.exists(path):
        raw = dict(np.load(path))
        if (
            int(raw.get("version", -1)) == SHORT_TABLE_VERSION
            and str(raw.get("tri_hash", "")) == key
            and float(raw.get("margin", -1.0)) == float(margin)
        ):
            return _short_tables(raw, device)
    return _short_tables(build_short_tables(tri_verts, margin=margin), device)
