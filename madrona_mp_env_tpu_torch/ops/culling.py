"""Per-cell candidate tables: the full PVS tables of the sensor fans, the
sensor-ray tables and the short-range tables of the movement sphere
casts, with the builders and verifiers of the first two.

PVS tables (``<map>/culling.npz``, big maps): the map's xy extent is cut
into nx x ny columns plus one dead cell (the dead-agent teleport box at z
> 5000); each cell lists the triangles that can be the nearest hit of a
ray or a sphere cast starting within QUERY_MARGIN of it. ``build_cell_tables``
samples them: per cell the triangles near its column (exact for short
casts), the first hits of a ray battery (``_dense_ray_idx``, a plain
PyTorch sweep on the build's device) and of a sphere-cast battery (K4
dense, ``raycast.sphere_cast``) from origins an agent can reach, each hit
credited to every cell within the margin of its origin, then fresh
batteries until three in a row add nothing. The battery is Monte Carlo,
so ``verify_tables`` measures the residual misses on a fresh one (K1 and
K4 dense against the culled plain sweeps). The builds run on the card
unless asked for the CPU; they draw the numpy random stream in the JAX
package's order, so the CPU build gives the JAX builder's tables (run
eagerly) bit for bit. Keyed by TABLE_VERSION and ``_tri_hash``; a map
without a matching file has none unless the caller builds them
(``load_or_build_cell_tables``), and the sensor fans then sweep the
whole soup.

Sensor-ray tables (``<map>/culling_ray.npz``, simple_map): the same
per-cell layout, sampled for sensor rays only (``build_ray_tables``,
binned within SENSOR_MARGIN), whose origins are exactly the
cell-of-record position, so a cell holds far fewer candidates (K = 80 on
simple_map against its 252 triangles). The opt-in K9 fan reads them
(``MPENV_FAN_V9=1``); ``verify_ray_tables`` checks them.

Short tables: movement casts are xy-bounded: the unstick probes are
range-clamped at UNSTICK_RANGE (64) and start <= 2r from the agent,
forward and slide travel is <= max_run_velocity * dt + buf (~20), and
every straight-down cast stays within r of its origin column. So the
per-cell candidate set "triangles whose xy-AABB meets the
margin-expanded cell" is exact for these casts by construction. The
tables are committed per map (``<map>/culling_short.npz``) and keyed by
``_tri_hash`` of the Morton-ordered soup; a missing or stale cache is
rebuilt here (pure AABB tests, milliseconds) without writing anything. A
second set with the smaller MOVE_MARGIN (``culling_short_mv.npz``) serves
the 1-2-cast movement batches (L2, L3, fall): forward casts there are
consumed only within move_dist + buf (~20) of the agent and down casts
stay within 2r + r of its column, so 64 covers both.

Cell indices divide by a tensor, never by a Python float: ATen's CUDA
division by a Python scalar multiplies by its reciprocal, which would
put a position on a cell boundary in another cell on the card than on
the CPU.
"""

from __future__ import annotations

import functools
import hashlib
import os
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from . import raycast

TABLE_VERSION = 4  # the JAX package's PVS table format
RAY_TABLE_VERSION = 1  # its sensor-ray table format
# PVS queries may start this far outside their cell of record (a step's
# movement drift 20, slide, unstick 2r = 30, spawn drift)
QUERY_MARGIN = 80.0
# sensor fans start at the cell-of-record position: only the cell-boundary
# epsilon and the eye rays' z parallax
SENSOR_MARGIN = 12.0
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

    @functools.cached_property
    def valid_span(self) -> torch.Tensor:
        """[C] i32: 1 + the last slot of each cell that holds a candidate
        (0 for a cell of none), made once per table: the culled sphere
        casts (K4 culled, K4') walk a cell's slots up to it, past which
        there is only -1 padding."""
        cand = self.cand.reshape(-1, self.K)
        slot = torch.arange(1, self.K + 1, device=cand.device)
        return torch.where(cand >= 0, slot, 0).amax(-1).to(torch.int32)


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


def _load_or_build(tri_verts, cache_dir, name, version, cls, build,
                   build_if_missing, device, kwargs):
    """``<cache_dir>/<name>`` when its version and triangle hash match;
    else, with ``build_if_missing``, ``build(tri_verts, device=...,
    **kwargs)`` on builder_device(device), written to that file
    (np.savez_compressed, best effort) beside the hash; else None. The
    tables land on ``device`` (None: the CPU, as every loader's). Battery
    parameters do not key the cache: a bigger battery only tightens the
    same tables."""
    raw = _load_cached(tri_verts, cache_dir, name, version)
    if raw is None:
        if not build_if_missing:
            return None
        raw = build(tri_verts, device=builder_device(device), **kwargs)
        raw["tri_hash"] = _tri_hash(tri_verts)
        if cache_dir is not None:
            try:
                np.savez_compressed(os.path.join(cache_dir, name), **raw)
            except OSError:
                pass
    return _grid_tables(cls, raw, device)


def load_or_build_cell_tables(tri_verts: np.ndarray,
                              cache_dir: Optional[str] = None,
                              build_if_missing: bool = True, device=None,
                              **kwargs) -> Optional[CellTables]:
    """PVS tables of ``<cache_dir>/culling.npz``, built by
    build_cell_tables (``kwargs``) when missing or stale and
    ``build_if_missing``, else None. The tables land on ``device`` and a
    build runs there; None: tables on the CPU, built on the first CUDA
    device."""
    return _load_or_build(tri_verts, cache_dir, "culling.npz",
                          TABLE_VERSION, CellTables, build_cell_tables,
                          build_if_missing, device, kwargs)


def load_or_build_ray_tables(tri_verts: np.ndarray,
                             cache_dir: Optional[str] = None,
                             build_if_missing: bool = True, device=None,
                             **kwargs) -> Optional[RayTables]:
    """Sensor-ray tables of ``<cache_dir>/culling_ray.npz``, as
    load_or_build_cell_tables (build_ray_tables)."""
    return _load_or_build(tri_verts, cache_dir, "culling_ray.npz",
                          RAY_TABLE_VERSION, RayTables, build_ray_tables,
                          build_if_missing, device, kwargs)


def load_ray_tables(tri_verts: np.ndarray, cache_dir: Optional[str],
                    device=None) -> Optional[RayTables]:
    """``<cache_dir>/culling_ray.npz`` when its version and triangle hash
    match, else None (nothing is built)."""
    return load_or_build_ray_tables(tri_verts, cache_dir, False, device)


# ---------------------------------------------------------------------------
# Builders of the PVS and sensor-ray tables
# ---------------------------------------------------------------------------

def builder_device(device=None) -> torch.device:
    """The device a table build or check runs on: None -> the first CUDA
    device, raising without one."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to build the tables with the "
            "plain PyTorch sweeps on the CPU")
    return device


def spawn_box_points(spawn_tables, step: float = 60.0) -> np.ndarray:
    """Grid-sample spawn AABBs ([N, 8] rows: aabb_min(3), aabb_max(3), yaw
    range) into battery origin points [M, 3]. Spawn boxes sit at the map
    edges, where the navmesh-driven battery under-samples, and every
    episode starts its sensor fans inside them."""
    pts = []
    for table in spawn_tables:
        for row in np.asarray(table, np.float32).reshape(-1, 8):
            lo, hi = row[0:3], row[3:6]
            nx = max(int(np.ceil((hi[0] - lo[0]) / step)) + 1, 2)
            ny = max(int(np.ceil((hi[1] - lo[1]) / step)) + 1, 2)
            xs = np.linspace(lo[0], hi[0], nx)
            ys = np.linspace(lo[1], hi[1], ny)
            gx, gy = np.meshgrid(xs, ys)
            z = np.full(gx.size, lo[2], np.float32)
            pts.append(np.stack([gx.ravel(), gy.ravel(), z], axis=1))
    if not pts:
        return np.zeros((0, 3), np.float32)
    return np.concatenate(pts, axis=0).astype(np.float32)


def _subdivide_tris(tri_verts: np.ndarray, max_extent: float):
    """Midpoint-split triangles [T, 3, 3] in four until every piece's AABB
    extent <= max_extent; returns (sub_verts [S, 3, 3], orig_idx [S]).
    Only for the near sets' conservative distance test, which reads the
    pieces as a set: they are the JAX package's recursive split's, made a
    generation at a time."""
    v = np.asarray(tri_verts)
    idx = np.arange(len(v), dtype=np.int32)
    out_v, out_i = [], []
    while len(v):
        ext = (v.max(axis=1) - v.min(axis=1)).max(axis=1)
        ok = ext <= max_extent
        out_v.append(v[ok])
        out_i.append(idx[ok])
        v, idx = v[~ok], idx[~ok]
        a, b, c = v[:, 0], v[:, 1], v[:, 2]
        m01, m12, m20 = 0.5 * (a + b), 0.5 * (b + c), 0.5 * (c + a)
        v = np.concatenate([np.stack(x, axis=1) for x in (
            (a, m01, m20), (m01, b, m12), (m12, c, m20), (m01, m12, m20))])
        idx = np.tile(idx, 4)
    return np.concatenate(out_v), np.concatenate(out_i)


def _near_sets(tri_verts, grid_min, cell_size, nx, ny, near_dist):
    """[nx * ny, T] bool: triangle within near_dist (xy) of each cell's
    column."""
    sub_v, sub_i = _subdivide_tris(tri_verts.astype(np.float64),
                                   0.75 * near_dist)
    sub_min = sub_v.min(axis=1)[:, :2]  # [S, 2]
    sub_max = sub_v.max(axis=1)[:, :2]
    T = len(tri_verts)
    out = np.zeros((nx * ny, T), bool)
    xs = grid_min[0] + cell_size * np.arange(nx)
    ys = grid_min[1] + cell_size * np.arange(ny)
    for ix in range(nx):
        cx0, cx1 = xs[ix] - near_dist, xs[ix] + cell_size + near_dist
        col = np.flatnonzero((sub_min[:, 0] <= cx1) & (sub_max[:, 0] >= cx0))
        y_min, y_max, col_i = sub_min[col, 1], sub_max[col, 1], sub_i[col]
        for iy in range(ny):
            cy0, cy1 = ys[iy] - near_dist, ys[iy] + cell_size + near_dist
            hit = (y_min <= cy1) & (y_max >= cy0)
            if hit.any():
                out[ix * ny + iy, np.unique(col_i[hit])] = True
    return out


# (query, triangle) pairs per pass of the builders' plain sweeps: on the
# CPU the temporaries stay in cache, on the card one float32 temporary of
# a pass is 256 MB
_PASS_PAIRS = {"cpu": 2 ** 18, "cuda": 2 ** 26}


def _in_passes(sweep, pairs_per_row: int, *rows):
    """sweep(*rows) in passes over the rows' leading axis, each pass of at
    most _PASS_PAIRS // pairs_per_row rows (a row's result depends on that
    row alone, so the bits do not change). Returns sweep's tensor or tuple
    of tensors over all rows."""
    n = rows[0].shape[0]
    per = max(1, _PASS_PAIRS[rows[0].device.type] // max(pairs_per_row, 1))
    if n <= per:
        return sweep(*rows)
    outs = [sweep(*(r[i:i + per] for r in rows)) for i in range(0, n, per)]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(x) for x in zip(*outs))
    return torch.cat(outs)


def _dense_ray_idx(o, d, v0, e1, e2, valid):
    """Nearest hit (t > 1e-6) of rays o, d [n, 3] over the triangles v0,
    e1, e2 [T, 3] with its winner: (t [n], row [n] int64), the lowest row
    among equal t and row 0 on a miss (jnp.argmin's rule, which torch.min
    keeps on every device). The builders' plain sweep on the tensors'
    device (the JAX package computes it in jnp outside any kernel)."""
    def sweep(o, d):
        t = raycast._ray_tri_t(o[:, None, :], d[:, None, :], v0, e1, e2,
                               valid, t_min=1e-6)
        return tuple(t.min(dim=-1))

    return _in_passes(sweep, v0.shape[0], o, d)


def _tri_arrays(tv: np.ndarray, device):
    """(v0, e1, e2, valid) of the unpadded triangles on ``device``, the
    edges subtracted in numpy as the JAX builders do."""
    return (torch.as_tensor(tv[:, 0], device=device),
            torch.as_tensor(tv[:, 1] - tv[:, 0], device=device),
            torch.as_tensor(tv[:, 2] - tv[:, 0], device=device),
            torch.ones((len(tv),), dtype=torch.bool, device=device))


def _ground_heights(xy, tris, z_top: float, z_bot: float):
    """Per xy sample [n, 2]: the first and second surface z straight down
    from z_top (the second peeled 8 below the first), which place the
    battery's origins at heights an agent can have."""
    v0, e1, e2, valid = tris
    n = xy.shape[0]
    o = torch.cat([xy, torch.full((n, 1), z_top, dtype=torch.float32,
                                  device=xy.device)], dim=1)
    down = torch.tensor([0.0, 0.0, -1.0], device=xy.device).expand(n, 3)
    t1, _ = _dense_ray_idx(o, down, v0, e1, e2, valid)
    z1 = z_top - t1
    o2 = o.clone()
    o2[:, 2] = torch.where(torch.isfinite(z1), z1 - 8.0, z_bot - 1.0)
    t2, _ = _dense_ray_idx(o2, down, v0, e1, e2, valid)
    z2 = o2[:, 2] - t2
    z1 = torch.where(torch.isfinite(z1), z1, z_bot)
    z2 = torch.where(torch.isfinite(z2), z2, z1)
    return z1, z2


def _make_origin_sampler(rng, walkable_points, ground_fn, grid_min, nx, ny,
                         cell_size, z_bot, z_top, z_reach_top=None):
    """sample_origins(n) -> [n, 3] float32 origins over the space agents
    can reach: walkable points (navmesh) jittered in xy out to the query
    margin, z = local ground (``ground_fn``: numpy xy -> numpy (z1, z2))
    plus eye and fall offsets. Restricting the battery to reachable space
    is what makes it converge. The builders and the verifiers draw from
    the same distribution (the tables' coverage contract), and from
    ``rng`` in the JAX package's order, draw for draw."""
    if z_reach_top is None:
        if walkable_points is not None and len(walkable_points) > 0:
            # agents only ever fall down from walkable surfaces
            z_reach_top = float(walkable_points[:, 2].max() + 150.0)
        else:
            z_reach_top = z_top
    z_cap = min(z_top, z_reach_top)

    def sample_origins(n):
        if walkable_points is not None and len(walkable_points) > 0:
            wp = walkable_points[rng.integers(0, len(walkable_points), n)]
            xy = (
                wp[:, :2]
                + rng.uniform(
                    -(QUERY_MARGIN + 20.0), QUERY_MARGIN + 20.0, (n, 2)
                )
            ).astype(np.float32)
            z1, z2 = ground_fn(xy)
            # a jitter that lands on or inside a wall (local ground far
            # from the walkable point's level) is unreachable: snap back
            bad = np.abs(z1 - wp[:, 2]) > 120.0
            xy = np.where(bad[:, None], wp[:, :2].astype(np.float32), xy)
            z1 = np.where(bad, wp[:, 2], z1)
            z2 = np.where(bad, wp[:, 2], z2)
        else:
            xy = rng.uniform(
                [grid_min[0] - QUERY_MARGIN, grid_min[1] - QUERY_MARGIN],
                [grid_min[0] + nx * cell_size + QUERY_MARGIN,
                 grid_min[1] + ny * cell_size + QUERY_MARGIN],
                (n, 2),
            ).astype(np.float32)
            z1, z2 = ground_fn(xy)
        # the peeled second layer is a floor only if an agent fits in the
        # air gap under the first; otherwise it is wall interior
        use_z2 = (z1 - z2) > 80.0
        ground = np.where((rng.random(n) < 0.25) & use_z2, z2, z1)
        u = rng.random(n)
        off = np.where(
            u < 0.8,
            rng.uniform(1.0, 130.0, n),
            rng.uniform(130.0, 420.0, n),
        )
        z = np.clip(ground + off, z_bot, z_cap).astype(np.float32)
        return np.concatenate([xy, z[:, None]], axis=1)

    return sample_origins


def _unit_dirs(rng, n):
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return d / np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-9)


class _Battery:
    """The builders' sampled batteries (the JAX package's build_cell_tables
    and build_ray_tables, whose machinery they share): the near sets, the
    origin sampler, the ray battery (_dense_ray_idx) and the sphere-cast
    battery (K4 dense, raycast.sphere_cast: the card's kernel, the plain
    sweep on the CPU) on ``device``, and the binning of each hit into the
    cells within ``margin`` of its origin, on the host in numpy (the
    convergence rounds read its bit counts). ``stats`` collects the
    per-round bit counts, chunks and the seconds spent on the device
    (each sweep up to its result on the host) against the whole."""

    def __init__(self, tri_verts, cells_per_side, near_dist, margin, seed,
                 walkable_points, device, stats):
        tv = np.asarray(tri_verts, np.float32)
        self.tv, self.T = tv, len(tv)
        lo = tv.reshape(-1, 3).min(axis=0)
        hi = tv.reshape(-1, 3).max(axis=0)
        self.nx = self.ny = nx = int(cells_per_side)
        self.cell_size = float(
            max(hi[0] - lo[0], hi[1] - lo[1]) / cells_per_side + 1e-3)
        self.grid_min = np.array([lo[0], lo[1]], np.float64)
        self.C_grid = nx * nx
        self.masks = np.concatenate(
            [_near_sets(tv, self.grid_min, self.cell_size, nx, nx,
                        near_dist), np.zeros((1, self.T), bool)], axis=0)
        self.margin = margin
        self.device = device
        self.tris = _tri_arrays(tv, device)
        self.z_top = float(hi[2] + 50.0)
        self.z_bot = float(lo[2] - 10.0)
        self.rng = np.random.default_rng(seed)
        self.sample_origins = _make_origin_sampler(
            self.rng, walkable_points, self._ground, self.grid_min, nx, nx,
            self.cell_size, self.z_bot, self.z_top)
        self.soup = None
        self.stats = {} if stats is None else stats
        self.stats.update(round_bits=[], chunks=0, device_s=0.0)
        self.bits = 0
        self.t0 = time.perf_counter()

    def _device_call(self, fn):
        """fn()'s tensors as numpy arrays, its seconds counted as device
        time (the copy waits for the device)."""
        t0 = time.perf_counter()
        out = tuple(x.cpu().numpy() for x in fn())
        self.stats["device_s"] += time.perf_counter() - t0
        return out

    def _ground(self, xy):
        return self._device_call(
            lambda: _ground_heights(torch.as_tensor(xy, device=self.device),
                                    self.tris, self.z_top, self.z_bot))

    def ray_idx(self, o, d):
        dev = self.device
        return self._device_call(lambda: _dense_ray_idx(
            torch.as_tensor(o, device=dev), torch.as_tensor(d, device=dev),
            *self.tris))

    def cast_idx(self, o, d, r):
        if self.soup is None:
            # the cast battery's soup: Morton order, padded to 128
            self.soup = raycast.make_tri_soup(self.tv, pad_to=128,
                                              device=self.device)
        dev = self.device
        return self._device_call(lambda: raycast.sphere_cast(
            torch.as_tensor(o, device=dev), torch.as_tensor(d, device=dev),
            r, self.soup))

    def bin_hits(self, o, idx, t):
        """Credit each hit triangle to every cell whose margin-expanded
        region holds the origin; counts the new (cell, tri) bits."""
        finite = np.isfinite(t)
        o = o[finite]
        tris = idx[finite]
        tris = np.where(tris < self.T, tris, 0)
        m, g, cs, nx = self.margin, self.grid_min, self.cell_size, self.nx
        ix_lo = np.clip(((o[:, 0] - m - g[0]) / cs).astype(np.int64), 0, nx - 1)
        ix_hi = np.clip(((o[:, 0] + m - g[0]) / cs).astype(np.int64), 0, nx - 1)
        iy_lo = np.clip(((o[:, 1] - m - g[1]) / cs).astype(np.int64), 0, nx - 1)
        iy_hi = np.clip(((o[:, 1] + m - g[1]) / cs).astype(np.int64), 0, nx - 1)
        before = int(self.masks.sum())
        for ix in (ix_lo, ix_hi):
            for iy in (iy_lo, iy_hi):
                np.logical_or.at(self.masks, (ix * nx + iy, tris), True)
        self.bits += int(self.masks.sum()) - before
        self.stats["chunks"] += 1

    def ray_round(self, total, chunk=1 << 15):
        done = 0
        while done < total:
            n = min(chunk, total - done)
            o = self.sample_origins(n)
            d = _unit_dirs(self.rng, n)
            t, idx = self.ray_idx(o, d)
            self.bin_hits(o, idx, t)
            done += n

    def cast_round(self, total, r, chunk=1 << 13):
        done = 0
        while done < total:
            n = min(chunk, total - done)
            o = self.sample_origins(n)
            d = _unit_dirs(self.rng, n)
            t, idx = self.cast_idx(o, d, r)
            self.bin_hits(o, idx, t)
            done += n

    def converge(self, max_rounds, one_round, progress, label):
        """Fresh batteries until 3 in a row add no bit or max_rounds ran."""
        clean = rounds = 0
        while clean < 3 and rounds < max_rounds:
            self.bits = 0
            one_round()
            rounds += 1
            clean = clean + 1 if self.bits == 0 else 0
            self.stats["round_bits"].append(self.bits)
            if progress:
                print(f"  {label} {rounds}: +{self.bits} bits "
                      f"(clean streak {clean})", flush=True)

    def dead_origins(self, n_dead=1 << 16):
        """Origins and directions from the dead-agent teleport box."""
        o = np.concatenate(
            [
                self.rng.uniform(-5.0, 5.0, (n_dead, 2)).astype(np.float32),
                self.rng.uniform(9995.0, 10130.0, (n_dead, 1)).astype(
                    np.float32),
            ],
            axis=1,
        )
        return o, _unit_dirs(self.rng, n_dead)

    def mark_dead(self, t, idx):
        idx = idx[np.isfinite(t)]
        self.masks[self.C_grid, np.where(idx < self.T, idx, 0)] = True

    def finish(self, version, K, k_raw, counts):
        C = self.C_grid + 1
        cand_idx = np.full((C, K), -1, np.int32)
        for c in range(C):
            ids = np.flatnonzero(self.masks[c])
            cand_idx[c, : len(ids)] = ids
        self.stats["total_s"] = time.perf_counter() - self.t0
        return {
            "version": np.int32(version),
            "cand_idx": cand_idx,
            "grid_min": self.grid_min.astype(np.float64),
            "cell_size": np.float64(self.cell_size),
            "nx": np.int32(self.nx),
            "ny": np.int32(self.ny),
            "K": np.int32(K),
            "k_raw": np.int32(k_raw),
            "mean_count": np.float64(counts[:self.C_grid].mean()),
        }


def build_cell_tables(
    tri_verts: np.ndarray,
    *,
    walkable_points: Optional[np.ndarray] = None,
    cells_per_side: int = 24,
    near_dist: float = 190.0,
    rays_per_cell: int = 20000,
    casts_per_cell: int = 4000,
    sphere_radius: float = 15.0,
    seed: int = 0,
    k_max: int = 256,
    round_rays: int = 1 << 18,
    round_casts: int = 1 << 16,
    max_rounds: int = 60,
    progress: bool = False,
    device=None,
    stats: Optional[dict] = None,
) -> dict:
    """PVS tables (host arrays; cached by load_or_build_cell_tables): per
    cell, the union of the near set, the first-hit triangles of a ray and
    a sphere-cast battery from origins within QUERY_MARGIN, then
    convergence rounds (3 clean in a row or max_rounds), and the dead
    cell. tri_verts must be in the soup's Morton order (candidate rows
    address the soup). Runs on ``device`` (None: the first CUDA device);
    raises when a cell needs more than k_max candidates."""
    b = _Battery(tri_verts, cells_per_side, near_dist, QUERY_MARGIN, seed,
                 walkable_points, builder_device(device), stats)
    b.ray_round(rays_per_cell * b.C_grid)
    b.cast_round(casts_per_cell * b.C_grid, sphere_radius)

    def one_round():
        b.ray_round(round_rays)
        b.cast_round(round_casts, sphere_radius)

    b.converge(max_rounds, one_round, progress, "round")
    n_dead = 1 << 16
    o, d = b.dead_origins(n_dead)
    b.mark_dead(*b.ray_idx(o, d))
    b.mark_dead(*b.cast_idx(o[: n_dead // 4], d[: n_dead // 4],
                            sphere_radius))

    counts = b.masks.sum(axis=1)
    k_raw = int(counts.max())
    K = max(128, -(-k_raw // 128) * 128)
    if K > k_max:
        raise ValueError(
            f"candidate sets too large for culling (K={k_raw} > {k_max}); "
            "increase k_max or use the dense path for this map"
        )
    return b.finish(TABLE_VERSION, K, k_raw, counts)


def build_ray_tables(
    tri_verts: np.ndarray,
    *,
    walkable_points: Optional[np.ndarray] = None,
    cells_per_side: int = 16,
    near_dist: float = 80.0,
    rays_per_cell: int = 30000,
    seed: int = 7,
    k_max: int = 192,
    round_rays: int = 1 << 19,
    max_rounds: int = 80,
    progress: bool = False,
    device=None,
    stats: Optional[dict] = None,
) -> dict:
    """Sensor-ray tables (host arrays; cached by load_or_build_ray_tables):
    build_cell_tables' battery with rays only, binned within
    SENSOR_MARGIN, a small near set, K rounded to 8."""
    b = _Battery(tri_verts, cells_per_side, near_dist, SENSOR_MARGIN, seed,
                 walkable_points, builder_device(device), stats)
    b.ray_round(rays_per_cell * b.C_grid)
    b.converge(max_rounds, lambda: b.ray_round(round_rays), progress,
               "ray round")
    b.mark_dead(*b.ray_idx(*b.dead_origins()))

    counts = b.masks.sum(axis=1)
    k_raw = int(counts.max())
    K = -(-max(k_raw, 8) // 8) * 8
    if K > k_max:
        raise ValueError(
            f"sensor candidate sets too large (K={k_raw} > {k_max}); "
            "use the dense fan path for this map"
        )
    return b.finish(RAY_TABLE_VERSION, K, k_raw, counts)


# ---------------------------------------------------------------------------
# Verifiers: culled against dense on fresh batteries
# ---------------------------------------------------------------------------

def _verify_sampler(tv, rng, walkable_points, tables, device):
    """The builders' origin sampler over the tables' grid, its ground
    heights on ``device``."""
    lo = tv.reshape(-1, 3).min(axis=0)
    hi = tv.reshape(-1, 3).max(axis=0)
    tris = _tri_arrays(tv, device)
    z_top, z_bot = float(hi[2] + 50), float(lo[2] - 10)

    def ground(xy):
        z = _ground_heights(torch.as_tensor(xy, device=device), tris, z_top,
                            z_bot)
        return tuple(x.cpu().numpy() for x in z)

    return _make_origin_sampler(
        rng, walkable_points, ground,
        np.array([tables.grid_min_x, tables.grid_min_y]), tables.nx,
        tables.ny, tables.cell_size, z_bot, z_top)


def _culled_casts_plain(o, d, r, cells, cand_idx, soup):
    """Casts o, d [n, 3] against the soup rows cand_idx[cells[n]] (-1
    skipped), gathered from the soup's arrays bit for bit. -> t [n]."""
    cand = cand_idx[cells.long()]
    ok = cand >= 0
    rows = torch.where(ok, cand, torch.zeros_like(cand)).long()
    p = raycast._sc_pairs(o[:, None, :], d[:, None, :], r, soup.v0[rows],
                          soup.e1[rows], soup.e2[rows], soup.normal[rows],
                          soup.valid[rows] & ok)
    return p["t_tri"].amin(dim=-1)


def _culled_rays(o, d, cells, cand_idx, soup):
    """Rays o, d [n, 3] against their cells' candidate rows (t > 0). ->
    t [n]."""
    return raycast._culled_rays_plain(o[:, None], d[:, None], cells,
                                      cand_idx, soup)[:, 0]


def verify_tables(
    tri_verts: np.ndarray,
    tables: CellTables,
    n_rays: int = 200000,
    n_casts: int = 50000,
    sphere_radius: float = 15.0,
    seed: int = 123,
    walkable_points: Optional[np.ndarray] = None,
) -> dict:
    """Culled against dense on fresh batteries from the builders' origin
    distribution, on the tables' device: the dense side is K1
    (raycast.ray_vs_tris) and K4 dense (raycast.sphere_cast), the culled
    side the plain sweeps over each query's candidate rows. Returns the
    mismatch counts (0 everywhere: exact on this battery)."""
    tv = np.asarray(tri_verts, np.float32)
    dev = tables.cand_idx.device
    soup = raycast.make_tri_soup(tv, pad_to=128, device=dev)
    rng = np.random.default_rng(seed)
    sample_origins = _verify_sampler(tv, rng, walkable_points, tables, dev)
    cand, K = tables.cand_idx, tables.K

    def sample(n):
        o = sample_origins(n)
        d = _unit_dirs(rng, n)
        o, d = torch.as_tensor(o, device=dev), torch.as_tensor(d, device=dev)
        return o, d, cell_index(tables, o)

    def mismatches(td, tc):
        """A mismatch: hit against miss, or a t beyond float noise (1e-3 +
        1e-4 relative)."""
        td, tc = td.cpu().numpy(), tc.cpu().numpy()
        both = np.isfinite(td) & np.isfinite(tc)
        diff = np.where(both, np.abs(np.where(both, td, 0)
                                     - np.where(both, tc, 0)), 0.0)
        tol = 1e-3 + 1e-4 * np.abs(np.where(both, td, 0))
        return int(np.sum((np.isfinite(td) != np.isfinite(tc))
                          | (both & (diff > tol))))

    ray_mismatch, done, chunk = 0, 0, 1 << 14
    while done < n_rays:
        n = min(chunk, n_rays - done)
        o, d, cells = sample(n)
        td = raycast.ray_vs_tris(o, d, soup)
        tc = _in_passes(lambda o, d, c: _culled_rays(o, d, c, cand, soup),
                        K, o, d, cells)
        ray_mismatch += mismatches(td, tc)
        done += n

    sc_mismatch, done = 0, 0
    while done < n_casts:
        n = min(chunk // 4, n_casts - done)
        o, d, cells = sample(n)
        td, _ = raycast.sphere_cast(o, d, sphere_radius, soup)
        tc = _in_passes(lambda o, d, c: _culled_casts_plain(
            o, d, sphere_radius, c, cand, soup), K, o, d, cells)
        sc_mismatch += mismatches(td, tc)
        done += n
    return {"ray_mismatch": ray_mismatch, "sc_mismatch": sc_mismatch,
            "n_rays": n_rays, "n_casts": n_casts}


def verify_ray_tables(
    tri_verts: np.ndarray,
    tables: RayTables,
    n_rays: int = 200000,
    seed: int = 321,
    walkable_points: Optional[np.ndarray] = None,
) -> dict:
    """Culled against dense first hits on a fresh battery of the builders'
    origins, each ray in its exact cell (the sensor fans' contract), on
    the tables' device: K1 against the plain sweep over the cell's
    candidates, both with t > 0 (the JAX package's check takes t > 1e-6 on
    both sides; the two differ only for a ray that starts within 1e-6 of
    a surface). Returns the mismatch count (0: exact on this battery)."""
    tv = np.asarray(tri_verts, np.float32)
    dev = tables.cand_idx.device
    soup = raycast.make_tri_soup(tv, pad_to=128, device=dev)
    rng = np.random.default_rng(seed)
    sample_origins = _verify_sampler(tv, rng, walkable_points, tables, dev)
    cand = tables.cand_idx
    mism, done = 0, 0
    while done < n_rays:
        n = min(1 << 15, n_rays - done)
        o = torch.as_tensor(sample_origins(n), device=dev)
        d = torch.as_tensor(_unit_dirs(rng, n), device=dev)
        td = raycast.ray_vs_tris(o, d, soup)
        tc = _in_passes(lambda o, d, c: _culled_rays(o, d, c, cand, soup),
                        tables.K, o, d, ray_cell_index(tables, o))
        td, tc = td.cpu().numpy(), tc.cpu().numpy()
        bad = ~(np.isclose(td, tc, rtol=1e-6, atol=1e-4)
                | (np.isinf(td) & np.isinf(tc)))
        mism += int(bad.sum())
        done += n
    return {"ray_mismatch": mism, "n_rays": n_rays}


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
