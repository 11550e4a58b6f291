"""Per-cell candidate tables: the full PVS tables of the sensor fans and
the short-range tables of the movement sphere casts.

PVS tables (``<map>/culling.npz``, big maps only): the map's xy extent is
cut into nx x ny columns plus one dead cell (the dead-agent teleport box
at z > 5000); each cell lists the triangles that can be the nearest hit
of a ray starting in it. The JAX package builds them (sampled batteries,
its ops/culling.py ``build_cell_tables``); the port only loads them, keyed
by TABLE_VERSION and ``_tri_hash``, and a map without a matching file has
none (the sensor fans then sweep the whole soup).

Short tables: movement casts are xy-bounded: the unstick probes are range-clamped at
UNSTICK_RANGE (64) and start <= 2r from the agent, forward and slide
travel is <= max_run_velocity * dt + buf (~20), and every straight-down
cast stays within r of its origin column. So the per-cell candidate set
"triangles whose xy-AABB meets the margin-expanded cell" is exact for
these casts by construction. The tables are committed per map
(``<map>/culling_short.npz``) and keyed by ``_tri_hash`` of the Morton-
ordered soup; a missing or stale cache is rebuilt here (pure AABB tests,
milliseconds) without writing anything. A second set with the smaller
MOVE_MARGIN (``culling_short_mv.npz``) serves the 1-2-cast movement
batches (L2, L3, fall): forward casts there are consumed only within
move_dist + buf (~20) of the agent and down casts stay within 2r + r of
its column, so 64 covers both.

Sensor-ray tables (``<map>/culling_ray.npz``, simple_map): the same
per-cell layout as the PVS tables, but sampled for sensor rays only,
whose origins are exactly the cell-of-record position, so a cell holds
far fewer candidates (K = 80 on simple_map against its 256 triangles).
The JAX package's opt-in v9 fan reads them (``MPENV_FAN_V9=1``); the
port loads them keyed by RAY_TABLE_VERSION and ``_tri_hash``, and builds
none.

Cell indices divide by a tensor, never by a Python float: ATen's CUDA
division by a Python scalar multiplies by its reciprocal, which would
put a position on a cell boundary in another cell on the card than on
the CPU.
"""

from __future__ import annotations

import functools
import hashlib
import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

TABLE_VERSION = 4  # the JAX package's PVS table format
RAY_TABLE_VERSION = 1  # its sensor-ray table format
SHORT_TABLE_VERSION = 1
SHORT_MARGIN = 130.0
MOVE_MARGIN = 64.0
DEAD_Z = 5000.0  # above this an agent is in the dead-agent teleport box


@dataclass
class CellTables:
    """PVS candidate tables: C = nx * ny grid cells + 1 dead cell, K
    candidates per cell (global soup rows, -1 padding)."""

    cand_idx: torch.Tensor  # [C, K] i32
    grid_min_x: float
    grid_min_y: float
    cell_size: float
    nx: int
    ny: int
    K: int

    @property
    def num_cells(self) -> int:
        return self.nx * self.ny + 1

    @property
    def dead_cell(self) -> int:
        return self.nx * self.ny

    @functools.cached_property
    def heavy_rank(self) -> torch.Tensor:
        """[C] i32: each cell's place when the cells go by decreasing
        count of valid candidates (ties by cell index), made once per
        table. K6 takes its fans in this order, so that its longest blocks
        start first (ops/raycast.py fan_cell_order)."""
        count = (self.cand_idx >= 0).sum(-1)
        order = torch.sort(-count, stable=True).indices
        rank = torch.empty_like(order)
        rank[order] = torch.arange(order.numel(), device=order.device)
        return rank.to(torch.int32)

    @functools.cached_property
    def valid_span(self) -> torch.Tensor:
        """[C] i32: 1 + the last slot of each cell that holds a candidate
        (0 for a cell of none), made once per table: K6 walks a cell's
        slots up to it, past which there is only -1 padding."""
        slot = torch.arange(1, self.K + 1, device=self.cand_idx.device)
        return torch.where(self.cand_idx >= 0, slot, 0).amax(-1).to(
            torch.int32)


class RayTables(CellTables):
    """Sensor-ray candidate tables, in the CellTables layout (x-major grid
    + one dead cell, global soup rows, -1 padding). The JAX package's TPU
    layout of the same tables (``dir9`` / ``org9``, bf16 direction
    coefficients for its matrix unit) is not kept: the port's kernel reads
    the soup's rows."""


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


def _grid_xy(pos, x0, y0, cell_size, nx, ny):
    """Clamped integer column (ix, iy) of pos [..., 3], float32 math; the
    cell size is a tensor so that every device divides."""
    cs = torch.full((), float(np.float32(cell_size)), device=pos.device)
    ix = ((pos[..., 0] - float(np.float32(x0))) / cs).to(torch.int32)
    iy = ((pos[..., 1] - float(np.float32(y0))) / cs).to(torch.int32)
    return torch.clamp(ix, 0, nx - 1), torch.clamp(iy, 0, ny - 1)


def short_cell_index(st: ShortTables, pos: torch.Tensor) -> torch.Tensor:
    """pos [..., 3] -> clamped xy cell index [...] i32, y-major."""
    gx, gy = _grid_xy(pos, st.grid_min[0], st.grid_min[1], st.cell_size,
                      st.nx, st.ny)
    return gy * st.nx + gx


def cell_index(tables: CellTables, pos: torch.Tensor) -> torch.Tensor:
    """pos [..., 3] -> PVS cell [...] i32: x-major (ix * ny + iy, the
    opposite of short_cell_index), xy clamped into the grid, z > 5000
    (the dead-agent box) the dead cell."""
    ix, iy = _grid_xy(pos, tables.grid_min_x, tables.grid_min_y,
                      tables.cell_size, tables.nx, tables.ny)
    cid = ix * tables.ny + iy
    return torch.where(pos[..., 2] > DEAD_Z,
                       torch.full_like(cid, tables.dead_cell), cid)


def ray_cell_index(tables: RayTables, pos: torch.Tensor) -> torch.Tensor:
    """pos [..., 3] -> sensor-ray table cell [...] i32, by cell_index's
    rule (the JAX package's ray_cell_index)."""
    return cell_index(tables, pos)


def _load_cached(tri_verts, cache_dir, name, version):
    """The raw arrays of ``<cache_dir>/<name>`` when its version and
    triangle hash match, else None."""
    if cache_dir is None:
        return None
    path = os.path.join(cache_dir, name)
    if not os.path.exists(path):
        return None
    raw = dict(np.load(path))
    if (int(raw.get("version", -1)) != version
            or str(raw.get("tri_hash", "")) != _tri_hash(tri_verts)):
        return None
    return raw


def _grid_tables(cls, raw, device):
    cand = np.asarray(raw["cand_idx"], np.int32)
    gmin = np.asarray(raw["grid_min"], np.float64)
    return cls(
        cand_idx=torch.as_tensor(cand, device=device),
        grid_min_x=float(gmin[0]),
        grid_min_y=float(gmin[1]),
        cell_size=float(raw["cell_size"]),
        nx=int(raw["nx"]),
        ny=int(raw["ny"]),
        K=int(cand.shape[1]),
    )


def load_cell_tables(tri_verts: np.ndarray, cache_dir: Optional[str],
                     device=None) -> Optional[CellTables]:
    """``<cache_dir>/culling.npz`` when its version and triangle hash match,
    else None (the port does not build PVS tables)."""
    raw = _load_cached(tri_verts, cache_dir, "culling.npz", TABLE_VERSION)
    return None if raw is None else _grid_tables(CellTables, raw, device)


def load_ray_tables(tri_verts: np.ndarray, cache_dir: Optional[str],
                    device=None) -> Optional[RayTables]:
    """``<cache_dir>/culling_ray.npz`` when its version and triangle hash
    match, else None (the port does not build sensor-ray tables)."""
    raw = _load_cached(tri_verts, cache_dir, "culling_ray.npz",
                       RAY_TABLE_VERSION)
    return None if raw is None else _grid_tables(RayTables, raw, device)


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
                      margin: float = SHORT_MARGIN, tag: str = "",
                      device=None) -> ShortTables:
    """``<cache_dir>/culling_short<tag>.npz`` when it matches these
    triangles and margin, else tables built in memory."""
    key = _tri_hash(tri_verts)
    path = None if cache_dir is None else os.path.join(
        cache_dir, f"culling_short{tag}.npz"
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
