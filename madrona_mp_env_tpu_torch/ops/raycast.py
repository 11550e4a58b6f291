"""Batched ray / sphere-cast queries against the static triangle soup.

Every (ray, triangle) pair is evaluated densely, over the whole soup or
over a cell's candidate rows (ops/culling.py tables). Each query has two
implementations side by side:

  * a plain PyTorch version (``_..._dense``), the arithmetic of the JAX
    package's dense CPU path written out op for op, and
  * a hand-written CUDA kernel (``csrc/*.cu``) that repeats the same
    arithmetic per (ray, triangle) pair in registers.

The public entry (``ray_vs_tris``, ``ray_fans_vs_tris``,
``ray_fans_vs_tris_flat``, ``ray_fans_culled``, ``ray_fans_culled_v9``,
``sphere_cast``, ``sphere_cast_vs_tris``, ``sphere_cast_culled``,
``sphere_cast_packed``) dispatches on the device of its input: a CPU
tensor goes to the plain version, a CUDA tensor to the kernel, anything
else raises. Each entry counts its kernel launches in
``<entry>.launches``. Which fan entry the step calls is decided by
``fan_route`` (with the gates ``use_fan_v9`` and ``use_fan_cull``) and
which cast entry by ``sim/movement.py use_sc_pack``, as the JAX package
decides it.

Conventions: miss => t = +inf; sphere casts return (t, winner row) where
the winner is the lowest triangle row among equal t (the dense path's
argmin), row 0 on a miss; ``sc_normals_from_idx`` rebuilds the dense
path's contact normal for a winner row, and ``sphere_cast_vs_tris``
returns that normal (0 on a miss) in place of the row.
"""

from __future__ import annotations

import ctypes
import functools
import os
from dataclasses import dataclass

import numpy as np
import torch

from . import cuda_build
from .geom import dot, sqrt

INF = float("inf")

# rows of the [T, 16] per-triangle table the kernels read (tri_rows)
ROW_V0, ROW_E1, ROW_E2, ROW_N, ROW_VALID = 0, 3, 6, 9, 12
TRI_ROW_COLS = 16


@dataclass
class TriSoup:
    """Per-triangle data in Morton order, padded to a multiple of pad_to.
    Padding triangles are all-zero and flagged invalid."""

    v0: torch.Tensor  # [T, 3]
    e1: torch.Tensor  # [T, 3] (v1 - v0)
    e2: torch.Tensor  # [T, 3] (v2 - v0)
    normal: torch.Tensor  # [T, 3] unit geometric normal
    valid: torch.Tensor  # [T] bool
    tri_rows: torch.Tensor  # [T, 16] v0 e1 e2 normal valid (kernel input)

    @property
    def num_tris(self) -> int:
        return self.v0.shape[0]


def morton_sort_tris(tri_verts: np.ndarray) -> np.ndarray:
    """Sort triangles by the Morton code of their centroid (host, once);
    the canonical triangle order of the soup and the culling tables."""
    if len(tri_verts) == 0:
        return tri_verts
    c = tri_verts.mean(axis=1)
    lo, hi = c.min(axis=0), c.max(axis=0)
    q = ((c - lo) / np.maximum(hi - lo, 1e-9) * 1023).astype(np.uint32)

    def spread(x):
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x

    code = (spread(q[:, 0]) << 2) | (spread(q[:, 1]) << 1) | spread(q[:, 2])
    return tri_verts[np.argsort(code, kind="stable")]


def pack_tri_consts(tri_verts: np.ndarray, pad_to: int = 256) -> np.ndarray:
    """[T, 3, 3] vertices -> [16, T_pad] plane + barycentric constants, the
    table of the JAX package's ray kernels (raycast_pallas.pack_tri_consts);
    padding and degenerate triangles get all-zero constants. Not on the
    load path: the port's kernels read the soup's ``tri_rows``."""
    t = tri_verts.shape[0]
    T = -(-max(t, 1) // pad_to) * pad_to
    v = np.zeros((T, 3, 3), np.float64)
    v[:t] = tri_verts
    v0 = v[:, 0]
    e1 = v[:, 1] - v[:, 0]
    e2 = v[:, 2] - v[:, 0]
    n = np.cross(e1, e2)
    d00 = np.sum(e1 * e1, axis=-1)
    d01 = np.sum(e1 * e2, axis=-1)
    d11 = np.sum(e2 * e2, axis=-1)
    denom = d00 * d11 - d01 * d01
    safe = np.where(np.abs(denom) > 1e-20, denom, 1.0)
    w1 = (d11[:, None] * e1 - d01[:, None] * e2) / safe[:, None]
    w2 = (d00[:, None] * e2 - d01[:, None] * e1) / safe[:, None]
    out = np.zeros((16, T), np.float32)
    valid = (np.arange(T) < t) & (np.abs(denom) > 1e-20)
    vm = valid.astype(np.float64)
    out[0:3] = (n * vm[:, None]).T
    out[3] = np.sum(n * v0, axis=-1) * vm
    out[4:7] = (w1 * vm[:, None]).T
    out[7] = -np.sum(w1 * v0, axis=-1) * vm
    out[8:11] = (w2 * vm[:, None]).T
    out[11] = -np.sum(w2 * v0, axis=-1) * vm
    out[12] = valid.astype(np.float32)
    return out


def make_tri_soup(tri_verts: np.ndarray, pad_to: int = 128,
                  device=None) -> TriSoup:
    """TriSoup from [T, 3, 3] vertices (host-side, once per map)."""
    tri_verts = morton_sort_tris(tri_verts)
    t = tri_verts.shape[0]
    padded = -(-max(t, 1) // pad_to) * pad_to
    v = np.zeros((padded, 3, 3), np.float32)
    v[:t] = tri_verts
    valid = np.zeros((padded,), bool)
    valid[:t] = True
    v0 = v[:, 0]
    e1 = v[:, 1] - v[:, 0]
    e2 = v[:, 2] - v[:, 0]
    n = np.cross(e1, e2)
    norm = np.linalg.norm(n, axis=-1, keepdims=True)
    n = np.where(norm > 1e-20, n / np.maximum(norm, 1e-30), 0.0).astype(
        np.float32
    )
    rows = np.zeros((padded, TRI_ROW_COLS), np.float32)
    rows[:, ROW_V0:ROW_V0 + 3] = v0
    rows[:, ROW_E1:ROW_E1 + 3] = e1
    rows[:, ROW_E2:ROW_E2 + 3] = e2
    rows[:, ROW_N:ROW_N + 3] = n
    rows[:, ROW_VALID] = valid

    def dev(x):
        return torch.as_tensor(x, device=device)

    return TriSoup(
        v0=dev(v0), e1=dev(e1), e2=dev(e2), normal=dev(n), valid=dev(valid),
        tri_rows=dev(rows),
    )


def _where_inf(ok, t):
    return torch.where(ok, t, torch.full_like(t, INF))


def _route(x: torch.Tensor) -> bool:
    """True -> launch the CUDA kernel, False -> plain version on the CPU."""
    if x.device.type == "cpu":
        return False
    if x.device.type == "cuda":
        return True
    raise ValueError(f"unsupported device {x.device}")


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32).contiguous()


def _ptr(x: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(x.data_ptr())


def _stream(x: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)


def _rows16(soup: TriSoup) -> torch.Tensor:
    """The soup's [T, 16] rows, which K1, K2, K4 dense, K4 culled, K4', K6,
    K7 and K8 read as 16-byte vectors."""
    rows = soup.tri_rows
    if rows.data_ptr() % 16 or not rows.is_contiguous():
        raise ValueError("tri_rows must be contiguous and 16-byte aligned")
    return rows


# ---------------------------------------------------------------------------
# K1: nearest-hit rays (hitscan)
# ---------------------------------------------------------------------------

def _ray_tri_t(o, d, v0, e1, e2, valid, t_min=0.0):
    """Two-sided Moller-Trumbore per (ray, triangle) pair: every argument
    broadcasts to [..., T(, 3)] -> t [..., T] (inf on miss; a hit needs t
    > t_min: 0 on the sim's queries, 1e-6 in the table builders' battery,
    ops/culling.py _dense_ray_idx). geom.cross and geom.dot written out on
    the x, y, z planes (the same operations in the same order, without
    materializing [..., T, 3] products)."""
    ox, oy, oz = o.unbind(-1)
    dx, dy, dz = d.unbind(-1)
    ax, ay, az = e1.unbind(-1)
    bx, by, bz = e2.unbind(-1)
    px, py, pz = dy * bz - dz * by, dz * bx - dx * bz, dx * by - dy * bx
    det = ax * px + ay * py + az * pz
    det_ok = torch.abs(det) > 1e-12
    inv_det = torch.where(det_ok, 1.0 / det, torch.zeros_like(det))
    vx, vy, vz = v0.unbind(-1)
    tx, ty, tz = ox - vx, oy - vy, oz - vz
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx, qy, qz = ty * az - tz * ay, tz * ax - tx * az, tx * ay - ty * ax
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (bx * qx + by * qy + bz * qz) * inv_det
    hit = (
        det_ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > t_min)
        & valid
    )
    return _where_inf(hit, t)


# (ray, triangle) pairs per pass of the plain sweeps on the CPU: the
# [rays, T] temporaries stay in cache
_CPU_PAIRS = 2 ** 18


def _cpu_passes(sweep, o, d, T: int):
    """sweep(o, d) of rays o, d [..., 3] against T triangles, on the CPU
    in passes of _CPU_PAIRS // T rays (each ray's result depends on that
    ray alone, so the bits do not change). Returns sweep's tensor, or
    tuple of tensors, over the rays' batch shape."""
    o, d = torch.broadcast_tensors(o, d)
    n = max(1, _CPU_PAIRS // T)
    if o.device.type != "cpu" or o[..., 0].numel() <= n:
        return sweep(o, d)
    o2, d2 = o.reshape(-1, 3), d.reshape(-1, 3)
    outs = [sweep(o2[i:i + n], d2[i:i + n])
            for i in range(0, o2.shape[0], n)]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(x).reshape(o.shape[:-1]) for x in zip(*outs))
    return torch.cat(outs).reshape(o.shape[:-1])


def _ray_vs_tris_dense(o, d, soup: TriSoup):
    """Nearest hit over all triangles: o, d [..., 3] -> t [...] (inf on
    miss)."""
    return _cpu_passes(lambda o, d: _ray_tri_t(
        o[..., None, :], d[..., None, :], soup.v0, soup.e1, soup.e2,
        soup.valid).amin(dim=-1), o, d, soup.num_tris)


# K1's launch (csrc/ray_tris.cu): rays per thread, threads per block
# (kRayThreads), the most blocks of a cluster (kRayMaxSplit); the split
# aims at RAY_FILL_BLOCKS blocks per SM over the card and gives each
# block at least RAY_MIN_ROWS rows
RAY_RAYS = 2
RAY_THREADS = 128
RAY_MAX_SPLIT = 8
RAY_FILL_BLOCKS = 3
RAY_MIN_ROWS = 64


def ray_split(T: int, R: int, sms: int, rays: int = RAY_RAYS) -> int:
    """The blocks of a cluster over which K1 splits T rows for R rays on
    a card of ``sms`` SMs: enough clusters' blocks for RAY_FILL_BLOCKS per
    SM, at most RAY_MAX_SPLIT, at least RAY_MIN_ROWS rows each (1 for a
    soup under that)."""
    tiles = -(-R // (rays * RAY_THREADS))
    want = -(-RAY_FILL_BLOCKS * sms // tiles)
    return max(1, min(RAY_MAX_SPLIT, want, T // RAY_MIN_ROWS))


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _rays_flat(o, d):
    shape = o.shape[:-1]
    R = int(np.prod(shape)) if shape else 1
    return shape, R, _f32(o.reshape(R, 3)), _f32(d.reshape(R, 3))


def _ray_tris_launch(o, d, soup: TriSoup, split=None, rays=RAY_RAYS):
    """K1's CUDA launch: ``split`` blocks per cluster (ray_split unless
    given), ``rays`` rays per thread. -> t [...]"""
    shape, R, o2, d2 = _rays_flat(o, d)
    T = soup.num_tris
    if split is None:
        split = ray_split(T, R, _sm_count(o.device), rays)
    rows = _rows16(soup)
    out = torch.empty(R, device=o.device, dtype=torch.float32)
    cuda_build.check(cuda_build.launcher("ray_tris")(
        _ptr(o2), _ptr(d2), _ptr(rows), T, R, split, rays, _ptr(out),
        _stream(o),
    ), "ray_tris")
    return out.reshape(shape)


def ray_vs_tris(o, d, soup: TriSoup):
    """Nearest-hit ray vs the soup (MeshBVH::traceRay semantics). o, d
    [..., 3] -> t [...]. CUDA: csrc/ray_tris.cu, the rows split over the
    blocks of a cluster (ray_split), RAY_RAYS rays per thread, the
    partial minima combined in the cluster: one launch."""
    if not _route(o):
        return _ray_vs_tris_dense(o, d, soup)
    out = _ray_tris_launch(o, d, soup)
    ray_vs_tris.launches += 1
    return out


ray_vs_tris.launches = 0


def ray_vs_tris_v1(o, d, soup: TriSoup):
    """K1's earlier kernel (csrc/ray_tris.cu ray_tris_v1: one thread per
    ray, every block over every row), on CUDA tensors only: the
    predecessor that chip_smoke.py times beside ray_vs_tris."""
    if not _route(o):
        raise ValueError("ray_vs_tris_v1 takes CUDA tensors")
    shape, R, o2, d2 = _rays_flat(o, d)
    out = torch.empty(R, device=o.device, dtype=torch.float32)
    cuda_build.check(cuda_build.launcher("ray_tris_v1")(
        _ptr(o2), _ptr(d2), _ptr(soup.tri_rows), soup.num_tris, R,
        _ptr(out), _stream(o),
    ), "ray_tris_v1")
    ray_vs_tris_v1.launches += 1
    return out.reshape(shape)


ray_vs_tris_v1.launches = 0


# ---------------------------------------------------------------------------
# K2: shared-origin sensor fans
# ---------------------------------------------------------------------------

def _fan_rays(origins, zg, dirs, zgroups):
    """Per-ray origins o [N, F, 3] (ray f of group g starts at origins +
    (0, 0, zg[:, g])) and directions d [N, F, 3]."""
    reps = torch.as_tensor(zgroups, device=zg.device)
    zoff = torch.repeat_interleave(zg, reps, dim=-1)  # [N, F]
    zero = torch.zeros_like(zoff)
    o = origins[:, None, :] + torch.stack([zero, zero, zoff], dim=-1)
    return o, torch.stack(dirs, dim=-1)


def _ray_fans_dense(origins, zg, dirs, zgroups, soup: TriSoup):
    """origins [N, 3]; zg [N, G] per-group z offsets; dirs = (dx, dy, dz)
    each [N, F] with F = sum(zgroups) -> t [N, F]."""
    return _ray_vs_tris_dense(*_fan_rays(origins, zg, dirs, zgroups), soup)


@functools.lru_cache(maxsize=None)
def _group_of_ray(zgroups: tuple, device: torch.device) -> torch.Tensor:
    """[F] i32 z-group of each fan ray, made once per run lengths."""
    return torch.repeat_interleave(
        torch.arange(len(zgroups), dtype=torch.int32),
        torch.as_tensor(zgroups),
    ).to(device)


def _fan_args(origins, zg, dirs, zgroups):
    N, G = zg.shape
    F = int(sum(zgroups))
    if len(zgroups) != G or dirs[0].shape != (N, F):
        raise ValueError("fan shapes do not match zgroups")
    return (N, F, G, _group_of_ray(tuple(zgroups), origins.device),
            _f32(origins), _f32(zg), *(_f32(c) for c in dirs))


# rays per thread of K2's and K6's register-blocked sweep
# (csrc/fan_sweep_rb.cuh kRbRays)
RB_RAYS = 8


def fan_rb_check(zgroups) -> None:
    """Raise ValueError unless every z-group run is a multiple of RB_RAYS,
    as K2's and K6's kernels need (fan_route sends other runs to K7)."""
    if any(int(g) % RB_RAYS for g in zgroups):
        raise ValueError(f"z-group runs {tuple(zgroups)} are not multiples "
                         f"of {RB_RAYS}: K2 and K6 take whole octets")


def ray_fans_vs_tris(origins, zg, dirs, zgroups, soup: TriSoup):
    """Nearest hit of every sensor ray of N fans over the whole soup.
    CUDA: csrc/fan_tris.cu, one thread per 8 rays of one z-group, the
    soup staged in tiles, the origin terms per (octet, triangle) in
    registers; every run must be a multiple of 8 (ValueError otherwise:
    fan_route sends such runs to K7). Any soup size works."""
    if not _route(origins):
        return _ray_fans_dense(origins, zg, dirs, zgroups, soup)
    fan_rb_check(zgroups)
    N, F, G, group_of_ray, org, zgc, dx, dy, dz = _fan_args(
        origins, zg, dirs, zgroups)
    rows = _rows16(soup)
    out = torch.empty((N, F), device=origins.device, dtype=torch.float32)
    cuda_build.check(cuda_build.launcher("fan_tris")(
        _ptr(org), _ptr(zgc), _ptr(dx), _ptr(dy), _ptr(dz),
        _ptr(group_of_ray), _ptr(rows), N, F, G, soup.num_tris,
        _ptr(out), _stream(origins),
    ), "fan_tris")
    ray_fans_vs_tris.launches += 1
    return out


ray_fans_vs_tris.launches = 0


# ---------------------------------------------------------------------------
# K7: sensor fans in the stacked layout, z offsets per ray
# ---------------------------------------------------------------------------

def _ray_zoffs(zoffs, zgroups):
    """Per-ray z offsets [N, F]: zoffs itself, or the per-group offsets
    [N, G] spread over the run lengths zgroups."""
    if zgroups is None:
        return zoffs
    return zoffs.index_select(1, _group_of_ray(tuple(zgroups),
                                               zoffs.device))


def _ray_fans_flat_plain(origins, zoffs, dirs, soup: TriSoup, t_max=INF,
                         zgroups=None):
    """_ray_vs_tris_dense on origins + (0, 0, z) per ray: origins [N, 3],
    zoffs [N, F] (or [N, G] with zgroups), dirs [N, F, 3] -> t [N, F]."""
    zoff = _ray_zoffs(zoffs, zgroups)
    zero = torch.zeros_like(zoff)
    o = origins[:, None, :] + torch.stack([zero, zero, zoff], dim=-1)
    t = _ray_vs_tris_dense(o, dirs, soup)
    return t if t_max == INF else _where_inf(t <= t_max, t)


# K7's launch (csrc/fan_flat.cu): rays per thread (4, a quad; 8 an
# octet), threads per block, and the rows split over the blocks of a
# cluster: at most FLAT_MAX_SPLIT blocks of at least FLAT_MIN_ROWS rows
FLAT_RAYS = 4
FLAT_THREADS = 128
FLAT_MAX_SPLIT = 2
FLAT_MIN_ROWS = 128


def flat_split(T: int) -> int:
    """The blocks of a cluster over which K7 splits T rows."""
    return max(1, min(FLAT_MAX_SPLIT, T // FLAT_MIN_ROWS))


def _flat_args(origins, zoffs, dirs, zgroups):
    N, F = dirs.shape[:2]
    org, zoff, dr = _f32(origins), _f32(_ray_zoffs(zoffs, zgroups)), _f32(
        dirs)
    if org.shape != (N, 3) or zoff.shape != (N, F) or dr.shape != (N, F, 3):
        raise ValueError("fan shapes disagree")
    return N, F, org, zoff, dr


def _fan_flat_launch(origins, zoffs, dirs, soup: TriSoup, zgroups=None,
                     rays=FLAT_RAYS, threads=FLAT_THREADS, split=None):
    """K7's CUDA launch with ``rays`` rays per thread, ``threads`` per
    block and ``split`` blocks per cluster (flat_split unless given). ->
    t [N, F]"""
    # held in locals until the launch: a freed temporary's memory could
    # be handed to the next argument's copy
    N, F, org, zoff, dr = _flat_args(origins, zoffs, dirs, zgroups)
    rows = _rows16(soup)
    T = soup.num_tris
    split = flat_split(T) if split is None else split
    out = torch.empty((N, F), device=origins.device, dtype=torch.float32)
    cuda_build.check(cuda_build.launcher("fan_flat")(
        _ptr(org), _ptr(zoff), _ptr(dr), _ptr(rows), N, F, T, rays, threads,
        split, _ptr(out), _stream(origins),
    ), "fan_flat")
    return out


def ray_fans_vs_tris_flat(origins, zoffs, dirs, soup: TriSoup, t_max=INF,
                          zgroups=None):
    """Nearest hit of every ray of N fans over the whole soup, in the JAX
    package's stacked layout (its ray_fans_vs_tris_pallas): origins [N,
    3]; zoffs [N, F] per ray, or [N, G] per group when zgroups (run
    lengths summing to F) is given; dirs [N, F, 3] of any scale (t is in
    units of |d|). -> t [N, F], inf on a miss or beyond t_max. CUDA:
    csrc/fan_flat.cu, K2's register-blocked sweep on quads of rays (a
    quad whose origins differ in z takes its origin terms per ray), so
    runs of any length work."""
    if not _route(origins):
        return _ray_fans_flat_plain(origins, zoffs, dirs, soup, t_max,
                                    zgroups)
    out = _fan_flat_launch(origins, zoffs, dirs, soup, zgroups)
    ray_fans_vs_tris_flat.launches += 1
    return out if t_max == INF else _where_inf(out <= t_max, out)


ray_fans_vs_tris_flat.launches = 0


def ray_fans_vs_tris_flat_v1(origins, zoffs, dirs, soup: TriSoup,
                             zgroups=None):
    """K7's earlier kernel (csrc/fan_flat.cu fan_flat_v1: one block per
    fan, its runs of equal offsets found and their origin terms hoisted in
    shared memory), on CUDA tensors only: the predecessor that
    chip_smoke.py times beside ray_fans_vs_tris_flat."""
    if not _route(origins):
        raise ValueError("ray_fans_vs_tris_flat_v1 takes CUDA tensors")
    N, F, org, zoff, dr = _flat_args(origins, zoffs, dirs, zgroups)
    out = torch.empty((N, F), device=origins.device, dtype=torch.float32)
    cuda_build.check(cuda_build.launcher("fan_flat_v1")(
        _ptr(org), _ptr(zoff), _ptr(dr), _ptr(soup.tri_rows), N, F,
        soup.num_tris, _ptr(out), _stream(origins),
    ), "fan_flat_v1")
    ray_fans_vs_tris_flat_v1.launches += 1
    return out


ray_fans_vs_tris_flat_v1.launches = 0


# ---------------------------------------------------------------------------
# K6: sensor fans against their PVS cell's candidates (big maps)
# ---------------------------------------------------------------------------

def use_fan_cull(soup: TriSoup, tables) -> bool:
    """Whether the sensor fans sweep their PVS cells (K6) rather than the
    soup (K2). MPENV_FAN_CULL: "1" whenever the map has PVS tables, "0"
    never, "auto" (default) when the candidate sets are much smaller than
    the soup, T >= 4 K (the JAX package's ops/raycast.py fan_cull_wins):
    town_map 6144 >= 4 x 1152."""
    if tables is None:
        return False
    mode = os.environ.get("MPENV_FAN_CULL", "auto")
    if mode in ("0", "1"):
        return mode == "1"
    return soup.num_tris >= 4 * tables.K


def _culled_rays_plain(o, d, cells, cand_idx, soup: TriSoup, t_max=INF):
    """Rays o, d [N, F, 3] against the candidate rows cand_idx[cells[n]]
    of their fan (-1 padding skipped); hits beyond t_max count as
    misses. -> t [N, F]."""
    cand = cand_idx[cells.long()]  # [N, K]
    ok = cand >= 0
    rows = torch.where(ok, cand, torch.zeros_like(cand)).long()
    t = _ray_tri_t(o[:, :, None, :], d[:, :, None, :],
                   soup.v0[rows][:, None], soup.e1[rows][:, None],
                   soup.e2[rows][:, None],
                   (soup.valid[rows] & ok)[:, None]).amin(dim=-1)
    return t if t_max == INF else _where_inf(t <= t_max, t)


def _ray_fans_culled_plain(origins, zg, dirs, zgroups, cells, tables,
                           soup: TriSoup, t_max=INF):
    """_ray_fans_dense restricted to each fan's candidate rows
    tables.cand_idx[cells[n]]. -> t [N, F]."""
    o, d = _fan_rays(origins, zg, dirs, zgroups)
    return _culled_rays_plain(o, d, cells, tables.cand_idx, soup, t_max)


def _fan_cell_order_plain(cells, rank):
    return torch.sort(rank[cells.long()], stable=True).indices.to(
        torch.int32)


def fan_cell_order(cells, num_cells: int, rank) -> torch.Tensor:
    """[N] i32 fan indices grouped by their cell (cells [N] in [0,
    num_cells)), the cells in increasing rank[cell] (rank [num_cells], a
    permutation): the order in which K6's kernel takes the fans. The
    results are written to each fan's own row, so no inverse is applied.
    CPU: a stable sort. CUDA: csrc/fan_culled.cu fan_cell_order, a
    counting sort in one launch of one block, whose order within a cell is
    the order its atomics land in (the results do not depend on it)."""
    if not _route(cells):
        return _fan_cell_order_plain(cells, rank)
    cl = cells.to(torch.int32).contiguous()
    rk = rank.to(torch.int32).contiguous()
    order = torch.empty_like(cl)
    cuda_build.check(cuda_build.launcher("fan_cell_order")(
        _ptr(cl), _ptr(rk), cl.numel(), int(num_cells), _ptr(order),
        _stream(cl),
    ), "fan_cell_order")
    fan_cell_order.launches += 1
    return order


fan_cell_order.launches = 0


def _fan_culled_args(origins, zg, dirs, zgroups, cells, tables, soup):
    args = _fan_args(origins, zg, dirs, zgroups)
    N = args[0]
    if cells.shape != (N,):
        raise ValueError("one cell per fan expected")
    return (*args, _rows16(soup), cells.to(torch.int32).contiguous(),
            tables.cand_idx.to(torch.int32).contiguous())


def ray_fans_culled(origins, zg, dirs, zgroups, cells, tables,
                    soup: TriSoup, t_max=INF):
    """Nearest hit of every sensor ray of N fans among its fan's PVS cell
    candidates (cells [N], ops/culling.py CellTables): the big-map fan.
    CUDA: csrc/fan_culled.cu, one thread per 8 rays of one z-group, each
    walking its cell's slots up to the last candidate (tables.valid_span),
    the fans grouped by cell, the cells of most candidates first
    (fan_cell_order, tables.heavy_rank: one more launch); every run must
    be a multiple of 8 (ValueError otherwise)."""
    if not _route(origins):
        return _ray_fans_culled_plain(origins, zg, dirs, zgroups, cells,
                                      tables, soup, t_max)
    fan_rb_check(zgroups)
    (N, F, G, group_of_ray, org, zgc, dx, dy, dz, rows, cl,
     cand) = _fan_culled_args(origins, zg, dirs, zgroups, cells, tables,
                              soup)
    order = fan_cell_order(cl, cand.shape[0], tables.heavy_rank)
    out = torch.empty((N, F), device=origins.device, dtype=torch.float32)
    cuda_build.check(cuda_build.launcher("fan_culled")(
        _ptr(org), _ptr(zgc), _ptr(dx), _ptr(dy), _ptr(dz),
        _ptr(group_of_ray), _ptr(rows), _ptr(cl), _ptr(cand),
        _ptr(tables.valid_span), _ptr(order), N, F, G, tables.K, _ptr(out),
        _stream(origins),
    ), "fan_culled")
    ray_fans_culled.launches += 1
    return out if t_max == INF else _where_inf(out <= t_max, out)


ray_fans_culled.launches = 0


def ray_fans_culled_v1(origins, zg, dirs, zgroups, cells, tables,
                       soup: TriSoup):
    """K6's earlier kernel (csrc/fan_culled.cu fan_culled_v1: one block
    per fan, the cell's rows staged in tiles, the origin terms hoisted in
    shared memory), on CUDA tensors only: the predecessor that
    chip_smoke.py times beside ray_fans_culled. Same function, any run
    lengths."""
    if not _route(origins):
        raise ValueError("ray_fans_culled_v1 takes CUDA tensors")
    (N, F, G, group_of_ray, org, zgc, dx, dy, dz, rows, cl,
     cand) = _fan_culled_args(origins, zg, dirs, zgroups, cells, tables,
                              soup)
    out = torch.empty((N, F), device=origins.device, dtype=torch.float32)
    cuda_build.check(cuda_build.launcher("fan_culled_v1")(
        _ptr(org), _ptr(zgc), _ptr(dx), _ptr(dy), _ptr(dz),
        _ptr(group_of_ray), _ptr(rows), _ptr(cl), _ptr(cand), N, F, G,
        tables.K, _ptr(out), _stream(origins),
    ), "fan_culled_v1")
    ray_fans_culled_v1.launches += 1
    return out


ray_fans_culled_v1.launches = 0


# ---------------------------------------------------------------------------
# K4: sphere casts (dense soup entry + short-table culled entry)
# ---------------------------------------------------------------------------

def _closest_point_on_tri(p, v0, e1, e2):
    """Closest point on triangle (v0, v0+e1, v0+e2) to p (Ericson RTCD
    5.1.5); all inputs broadcast on leading dims."""
    a, ab, ac = v0, e1, e2
    ap = p - a
    d1 = dot(ab, ap)
    d2 = dot(ac, ap)
    b = a + ab
    bp = p - b
    d3 = dot(ab, bp)
    d4 = dot(ac, bp)
    c = a + ac
    cp = p - c
    d5 = dot(ab, cp)
    d6 = dot(ac, cp)

    vc = d1 * d4 - d3 * d2
    vb = d5 * d2 - d1 * d6
    va = d3 * d6 - d5 * d4
    denom_vb = d1 - d3
    denom_vc = d2 - d6
    denom_va = (d4 - d3) + (d5 - d6)

    in_a = (d1 <= 0.0) & (d2 <= 0.0)
    in_b = (d3 >= 0.0) & (d4 <= d3)
    in_c = (d6 >= 0.0) & (d5 <= d6)
    on_ab = (vc <= 0.0) & (d1 >= 0.0) & (d3 <= 0.0)
    on_ac = (vb <= 0.0) & (d2 >= 0.0) & (d6 <= 0.0)
    on_bc = (va <= 0.0) & (d4 - d3 >= 0.0) & (d5 - d6 >= 0.0)

    def safe(x):
        return torch.where(torch.abs(x) > 1e-20, x, torch.ones_like(x))

    v_ab = d1 / safe(denom_vb)
    w_ac = d2 / safe(denom_vc)
    w_bc = (d4 - d3) / safe(denom_va)
    inv_face = 1.0 / safe(va + vb + vc)
    v_f = vb * inv_face
    w_f = vc * inv_face

    result = a + v_f[..., None] * ab + w_f[..., None] * ac
    result = torch.where(on_bc[..., None], b + w_bc[..., None] * (c - b),
                         result)
    result = torch.where(on_ac[..., None], a + w_ac[..., None] * ac, result)
    result = torch.where(on_ab[..., None], a + v_ab[..., None] * ab, result)
    result = torch.where(in_c[..., None], c, result)
    result = torch.where(in_b[..., None], b, result)
    result = torch.where(in_a[..., None], a, result)
    return result


def _ray_vs_segment_capsule(o, d, p0, seg, seg_len2, r):
    """Nearest t of ray o + t d against the radius-r capsule around segment
    p0..p0+seg (inf on miss); all args broadcast."""
    m = o - p0
    dd = dot(d, d)
    md = dot(m, d)
    ms = dot(m, seg)
    ds = dot(d, seg)
    mm = dot(m, m)
    inv_l2 = 1.0 / torch.clamp(seg_len2, min=1e-20)
    a = dd - ds * ds * inv_l2
    b = md - ms * ds * inv_l2
    c = mm - ms * ms * inv_l2 - r * r
    disc = b * b - a * c
    sqrt_disc = sqrt(torch.clamp(disc, min=0.0))
    a_ok = torch.abs(a) > 1e-12
    t_cyl = (-b - sqrt_disc) / torch.where(a_ok, a, torch.ones_like(a))
    s_hit = ms + t_cyl * ds
    cyl_ok = (
        a_ok & (disc >= 0.0) & (t_cyl >= 0.0) & (s_hit >= 0.0)
        & (s_hit <= seg_len2)
    )
    t_cyl = _where_inf(cyl_ok, t_cyl)

    def ray_sphere(center):
        mo = o - center
        bb = dot(mo, d)
        cc = dot(mo, mo) - r * r
        dsc = bb * bb - dd * cc
        sq = sqrt(torch.clamp(dsc, min=0.0))
        t = (-bb - sq) / torch.clamp(dd, min=1e-20)
        return _where_inf((dsc >= 0.0) & (t >= 0.0), t)

    t0 = ray_sphere(p0)
    t1 = ray_sphere(p0 + seg)
    return torch.minimum(t_cyl, torch.minimum(t0, t1))


def _sc_pairs(o, d, r, v0, e1, e2, n, valid):
    """Per-(cast, triangle) sphere-cast terms (MeshBVH::sphereCastTriangle,
    mesh_bvh.inl:885+): start overlap -> t = 0; face hit via the plane
    offset by r; edge capsules with vertex spheres. o, d [..., 1, 3]
    against triangle arrays [..., T, 3]. Returns a dict with t_tri and the
    terms the contact normal needs."""
    closest = _closest_point_on_tri(o, v0, e1, e2)
    to_center = o - closest
    dist2 = dot(to_center, to_center)
    overlap = (dist2 <= r * r) & valid

    ndotd = dot(n, d)
    h = dot(o - v0, n)
    sign = torch.sign(h)
    sign = torch.where(sign == 0.0, torch.ones_like(sign), sign)
    nd_ok = torch.abs(ndotd) > 1e-9
    t_face = (sign * r - h) / torch.where(nd_ok, ndotd,
                                          torch.ones_like(ndotd))
    contact = o + t_face[..., None] * d - (sign * r)[..., None] * n
    cp = contact - v0
    d00 = dot(e1, e1)
    d01 = dot(e1, e2)
    d11 = dot(e2, e2)
    d20 = dot(cp, e1)
    d21 = dot(cp, e2)
    denom = d00 * d11 - d01 * d01
    inv_denom = torch.where(torch.abs(denom) > 1e-20, 1.0 / denom,
                            torch.zeros_like(denom))
    bv = (d11 * d20 - d01 * d21) * inv_denom
    bw = (d00 * d21 - d01 * d20) * inv_denom
    face_ok = (
        nd_ok & (t_face >= 0.0) & (bv >= 0.0) & (bw >= 0.0)
        & (bv + bw <= 1.0) & valid
    )
    t_face = _where_inf(face_ok, t_face)

    v1 = v0 + e1
    t_e0 = _ray_vs_segment_capsule(o, d, v0, e1, dot(e1, e1), r)
    t_e1 = _ray_vs_segment_capsule(o, d, v0, e2, dot(e2, e2), r)
    e12 = e2 - e1
    t_e2 = _ray_vs_segment_capsule(o, d, v1, e12, dot(e12, e12), r)
    t_edge = _where_inf(valid, torch.minimum(t_e0, torch.minimum(t_e1, t_e2)))

    t_sweep = torch.minimum(t_face, t_edge)
    t_tri = torch.where(overlap, torch.zeros_like(t_sweep), t_sweep)
    return dict(t_tri=t_tri, t_face=t_face, t_edge=t_edge, t_sweep=t_sweep,
                overlap=overlap, to_center=to_center, dist2=dist2, sign=sign)


def _sphere_cast_dense(o, d, r, soup: TriSoup):
    """o, d [..., 3] -> (t [...], winner row [...] i32) over all
    triangles; argmin picks the lowest row among equal t (row 0 on a
    miss)."""
    def sweep(o, d):
        p = _sc_pairs(o[..., None, :], d[..., None, :], r, soup.v0, soup.e1,
                      soup.e2, soup.normal, soup.valid)
        t, idx = p["t_tri"].min(dim=-1)
        return t, idx.to(torch.int32)

    return _cpu_passes(sweep, o, d, soup.num_tris)


# K4 dense's and K8's launch (csrc/sphere_cast.cu sc_dense_kernel): threads
# per cast (kScParts), threads per block (kScDenseThreads), the most blocks
# of a cluster (kScMaxSplit); the split aims at SC_FILL_WARPS warps per SM
# over the card, two waves of the 32 warps an SM holds at once (8 blocks
# at the kernel's 64-67 registers a thread, 7 at 32 KB of staged rows),
# and gives each block at least SC_MIN_ROWS rows
SC_PARTS = 2
SC_DENSE_THREADS = 128
SC_MAX_SPLIT = 8
SC_FILL_WARPS = 64
SC_MIN_ROWS = 32


def sc_split(T: int, R: int, sms: int) -> int:
    """The blocks of a cluster over which K4 dense and K8 split T rows for
    R casts (SC_PARTS threads each) on a card of ``sms`` SMs: enough
    clusters' warps for SC_FILL_WARPS per SM, at most SC_MAX_SPLIT, at
    least SC_MIN_ROWS rows each (1 for a soup under that)."""
    tiles = max(1, -(-R * SC_PARTS // SC_DENSE_THREADS))
    want = -(-SC_FILL_WARPS * sms // (tiles * SC_DENSE_THREADS // 32))
    return max(1, min(SC_MAX_SPLIT, want, T // SC_MIN_ROWS))


def _sc_dense_launch(o, d, r, soup: TriSoup, t_max=None, with_normal=True,
                     split=None):
    """The dense entries' CUDA launch: K4 dense ((t, winner row)) when
    ``t_max`` is None, else K8 ((t, normal)); ``split`` blocks per cluster
    (sc_split unless given)."""
    shape, R, o2, d2 = _rays_flat(o, d)
    T = soup.num_tris
    if split is None:
        split = sc_split(T, R, _sm_count(o.device))
    t = torch.empty(R, device=o.device, dtype=torch.float32)
    head = (_ptr(o2), _ptr(d2), _ptr(_rows16(soup)), float(r), T, R, split)
    if t_max is None:
        idx = torch.empty(R, device=o.device, dtype=torch.int32)
        cuda_build.check(cuda_build.launcher("sphere_cast")(
            *head, _ptr(t), _ptr(idx), _stream(o)), "sphere_cast")
        return t.reshape(shape), idx.reshape(shape)
    n = torch.empty((R, 3), device=o.device, dtype=torch.float32)
    cuda_build.check(cuda_build.launcher("sphere_cast_normal")(
        *head, float(t_max), int(with_normal), _ptr(t), _ptr(n), _stream(o)),
        "sphere_cast_normal")
    return t.reshape(shape), n.reshape(shape + (3,))


def sphere_cast(o, d, r: float, soup: TriSoup):
    """Sphere sweep of radius r from o along unit d against the soup.
    Returns (t [...], winner row [...] i32). CUDA: the dense entry of
    csrc/sphere_cast.cu, the rows split over the blocks of a cluster
    (sc_split), the partial (t, row) minima combined in the cluster: one
    launch."""
    if not _route(o):
        return _sphere_cast_dense(o, d, r, soup)
    out = _sc_dense_launch(o, d, r, soup)
    sphere_cast.launches += 1
    return out


sphere_cast.launches = 0


def sphere_cast_v1(o, d, r: float, soup: TriSoup):
    """K4 dense's earlier kernel (csrc/sphere_cast.cu sphere_cast_dense_v1:
    one thread per cast, every block over every row), on CUDA tensors
    only: the predecessor that chip_smoke.py times beside sphere_cast."""
    if not _route(o):
        raise ValueError("sphere_cast_v1 takes CUDA tensors")
    shape, R, o2, d2 = _rays_flat(o, d)
    t = torch.empty(R, device=o.device, dtype=torch.float32)
    idx = torch.empty(R, device=o.device, dtype=torch.int32)
    cuda_build.check(cuda_build.launcher("sphere_cast_dense_v1")(
        _ptr(o2), _ptr(d2), _ptr(soup.tri_rows), float(r), soup.num_tris, R,
        _ptr(t), _ptr(idx), _stream(o),
    ), "sphere_cast_dense_v1")
    sphere_cast_v1.launches += 1
    return t.reshape(shape), idx.reshape(shape)


sphere_cast_v1.launches = 0


def _sphere_cast_culled_plain(o, d, r, cells, short, soup: TriSoup):
    """o, d [N, CPA, 3]; cells [N] short-table cell per group -> (t, global
    winner row) [N, CPA], sweeping only the cell's candidate rows."""
    cand = short.cand.reshape(-1, short.K)[cells.long()]  # [N, K], -1 pad
    ok = cand >= 0
    rows = torch.where(ok, cand, torch.zeros_like(cand)).long()
    p = _sc_pairs(
        o[:, :, None, :], d[:, :, None, :], r,
        soup.v0[rows][:, None], soup.e1[rows][:, None],
        soup.e2[rows][:, None], soup.normal[rows][:, None],
        soup.valid[rows][:, None],
    )
    t_k = _where_inf(ok[:, None, :], p["t_tri"])  # [N, CPA, K]
    t = t_k.amin(dim=-1)
    big = torch.iinfo(torch.int32).max
    key = torch.where(ok, cand, torch.full_like(cand, big))[:, None, :]
    idx = torch.where(t_k == t[..., None], key, torch.full_like(key, big))
    idx = idx.amin(dim=-1)
    idx = torch.where(torch.isinf(t), torch.zeros_like(idx), idx)
    return t, idx.to(torch.int32)


# K4 culled / K4' (csrc/sphere_cast.cu sc_culled_kernel): threads per
# block (kScThreads), lanes per group (a warp), the most casts of one
# group (kScMaxCasts)
SC_THREADS = 128
SC_LANES = 32
SC_MAX_CASTS = 8


def _sc_culled_args(o, d, cells):
    N, CPA = o.shape[0], o.shape[1]
    if o.shape != (N, CPA, 3) or d.shape != o.shape or cells.shape != (N,):
        raise ValueError("casts [N, CPA, 3] and one cell per group expected")
    return (N, CPA, _f32(o.reshape(N * CPA, 3)), _f32(d.reshape(N * CPA, 3)),
            cells.to(torch.int32).contiguous())


def _sc_culled_launch(o, d, r, cells, short, soup: TriSoup, span=None):
    """The culled entry's CUDA launch, each cell's slots up to ``span``
    (short.valid_span unless given). A shape the kernel does not take (CPA
    above SC_MAX_CASTS) raises through cuda_build.check. -> (t, row) [N,
    CPA]"""
    N, CPA, o2, d2, cl = _sc_culled_args(o, d, cells)
    span = short.valid_span if span is None else span
    t = torch.empty(N * CPA, device=o.device, dtype=torch.float32)
    idx = torch.empty(N * CPA, device=o.device, dtype=torch.int32)
    cuda_build.check(cuda_build.launcher("sphere_cast_culled")(
        _ptr(o2), _ptr(d2), _ptr(_rows16(soup)), float(r), N, CPA, _ptr(cl),
        _ptr(short.cand), _ptr(span), short.K, _ptr(t), _ptr(idx),
        _stream(o),
    ), "sphere_cast_culled")
    return t.reshape(N, CPA), idx.reshape(N, CPA)


def sphere_cast_culled(o, d, r: float, cells, short, soup: TriSoup):
    """Grouped sphere casts o, d [N, CPA, 3], one short-table cell per group
    (cells [N]). Exact against ``sphere_cast`` for the xy-bounded movement
    casts (ops/culling.py notes); same winner rule, global rows. CUDA:
    the culled entry of csrc/sphere_cast.cu, a warp per group splitting
    its (candidate, cast) pairs; CPA at most SC_MAX_CASTS."""
    if not _route(o):
        return _sphere_cast_culled_plain(o, d, r, cells, short, soup)
    out = _sc_culled_launch(o, d, r, cells, short, soup)
    sphere_cast_culled.launches += 1
    return out


sphere_cast_culled.launches = 0


def sphere_cast_packed(o, d, r: float, cells, short, soup: TriSoup):
    """K4': the 1-2-cast movement batches (L2, L3, fall; o, d [N, CPA, 3],
    CPA in {1, 2, 4}) against the MOVE_MARGIN short tables, one cell per
    group (cells [N]). The same culled sweep as ``sphere_cast_culled``
    (same plain version, same kernel entry), counted apart: the JAX
    package's sphere_cast_packed is a kernel of its own, whose 8-lane
    same-cell packing the culled entry's lanes per group take the place
    of. Exact where the step reads it: down casts at any depth, forward
    casts within move_dist + buf (ops/culling.py notes)."""
    if not _route(o):
        return _sphere_cast_culled_plain(o, d, r, cells, short, soup)
    out = _sc_culled_launch(o, d, r, cells, short, soup)
    sphere_cast_packed.launches += 1
    return out


sphere_cast_packed.launches = 0


def sphere_cast_culled_v1(o, d, r: float, cells, short, soup: TriSoup):
    """The culled entry's earlier kernel (csrc/sphere_cast.cu
    sphere_cast_culled_v1: one thread per cast over every one of its
    cell's K slots), on CUDA tensors only: the predecessor that
    chip_smoke.py times beside sphere_cast_culled and sphere_cast_packed."""
    if not _route(o):
        raise ValueError("sphere_cast_culled_v1 takes CUDA tensors")
    N, CPA, o2, d2, cl = _sc_culled_args(o, d, cells)
    t = torch.empty(N * CPA, device=o.device, dtype=torch.float32)
    idx = torch.empty(N * CPA, device=o.device, dtype=torch.int32)
    cuda_build.check(cuda_build.launcher("sphere_cast_culled_v1")(
        _ptr(o2), _ptr(d2), _ptr(soup.tri_rows), float(r), N * CPA, _ptr(cl),
        _ptr(short.cand), short.K, CPA, _ptr(t), _ptr(idx), _stream(o),
    ), "sphere_cast_culled_v1")
    sphere_cast_culled_v1.launches += 1
    return t.reshape(N, CPA), idx.reshape(N, CPA)


sphere_cast_culled_v1.launches = 0


def sc_normals_from_idx(o, d, r: float, idx, soup: TriSoup):
    """Contact normal of each sphere cast's winner row: o, d [..., 3], idx
    [...] -> [..., 3]. Recomputes the winner's per-triangle terms and picks
    the normal as the dense sweep does: depenetration direction on start
    overlap, else the face normal (signed toward the cast) when the face
    hit is no later than the edge hit, else the direction from the closest
    point at the hit centre."""
    i = idx.long()
    p = _sc_pairs(o, d, r, soup.v0[i], soup.e1[i], soup.e2[i],
                  soup.normal[i], soup.valid[i])
    up = torch.tensor([0.0, 0.0, 1.0], device=o.device)
    dist = sqrt(torch.clamp(p["dist2"], min=0.0))[..., None]
    depen_n = torch.where(
        dist > 0.0, p["to_center"] / torch.clamp(dist, min=1e-30), up
    )
    face_n = p["sign"][..., None] * soup.normal[i]
    hit_center = o + p["t_sweep"][..., None] * d
    edge_raw = hit_center - _closest_point_on_tri(
        hit_center, soup.v0[i], soup.e1[i], soup.e2[i]
    )
    edge_len = sqrt(dot(edge_raw, edge_raw))[..., None]
    edge_n = torch.where(
        edge_len > 1e-12, edge_raw / torch.clamp(edge_len, min=1e-30), up
    )
    tri_n = torch.where((p["t_face"] <= p["t_edge"])[..., None], face_n,
                        edge_n)
    return torch.where(p["overlap"][..., None], depen_n, tri_n)


def _sphere_cast_normal_plain(o, d, r: float, soup: TriSoup, t_max=INF,
                              with_normal=True):
    """_sphere_cast_dense + sc_normals_from_idx: (t [...], normal [...,
    3]); a miss or t > t_max gives t = inf and normal 0, and so does
    every normal when not with_normal."""
    t, idx = _sphere_cast_dense(o, d, r, soup)
    missed = torch.isinf(t) | (t > t_max)
    t = _where_inf(~missed, t)
    if not with_normal:
        return t, torch.zeros(o.shape, device=o.device, dtype=torch.float32)
    n = sc_normals_from_idx(o, d, r, idx, soup)
    return t, torch.where(missed[..., None], torch.zeros_like(n), n)


def sphere_cast_vs_tris(o, d, r: float, soup: TriSoup, t_max=INF,
                        with_normal=True):
    """K8: sphere sweep of radius r from o along unit d against the soup,
    with the winner's contact normal (the JAX package's
    sphere_cast_vs_tris, its dense path's normal rule). o, d [..., 3] ->
    (t [...], normal [..., 3]); a miss or t > t_max gives t = inf and
    normal 0; with_normal=False returns zero normals. CUDA: the normal
    entry of csrc/sphere_cast.cu, K4 dense's sweep (sc_split), whose
    block 0 of each cluster computes the normal of each cast's winner row
    in the same launch."""
    if not _route(o):
        return _sphere_cast_normal_plain(o, d, r, soup, t_max, with_normal)
    out = _sc_dense_launch(o, d, r, soup, t_max, with_normal)
    sphere_cast_vs_tris.launches += 1
    return out


sphere_cast_vs_tris.launches = 0


def sphere_cast_vs_tris_v1(o, d, r: float, soup: TriSoup, t_max=INF,
                           with_normal=True):
    """K8's earlier kernel (csrc/sphere_cast.cu sphere_cast_normal_v1: one
    thread per cast, every block over every row), on CUDA tensors only:
    the predecessor that chip_smoke.py times beside sphere_cast_vs_tris."""
    if not _route(o):
        raise ValueError("sphere_cast_vs_tris_v1 takes CUDA tensors")
    shape, R, o2, d2 = _rays_flat(o, d)
    t = torch.empty(R, device=o.device, dtype=torch.float32)
    n = torch.empty((R, 3), device=o.device, dtype=torch.float32)
    cuda_build.check(cuda_build.launcher("sphere_cast_normal_v1")(
        _ptr(o2), _ptr(d2), _ptr(soup.tri_rows), float(r), soup.num_tris,
        R, float(t_max), int(with_normal), _ptr(t), _ptr(n), _stream(o),
    ), "sphere_cast_normal_v1")
    sphere_cast_vs_tris_v1.launches += 1
    return t.reshape(shape), n.reshape(shape + (3,))


sphere_cast_vs_tris_v1.launches = 0


def sphere_cast_grouped(o, d, r: float, soup: TriSoup, t_max=INF,
                        with_normal=True):
    """Grouped casts o, d [..., CPA, 3] (CPA per casting agent): the JAX
    package's sphere_cast_grouped, which is sphere_cast_vs_tris (its
    culling arguments are unused there and not taken here)."""
    return sphere_cast_vs_tris(o, d, r, soup, t_max, with_normal)


# ---------------------------------------------------------------------------
# K9: sensor fans against their cell's sensor-ray table candidates
# ---------------------------------------------------------------------------

def use_fan_v9(ray_tables) -> bool:
    """Whether the sensor fans sweep the sensor-ray tables (K9). Opt-in,
    as in the JAX package (its ops/raycast.py): MPENV_FAN_V9=1 and the map
    has culling_ray.npz; it takes precedence over the PVS fan (K6) and the
    whole-soup fan (K2)."""
    return ray_tables is not None and os.environ.get("MPENV_FAN_V9",
                                                     "0") == "1"


def fan_route(zgroups, m) -> str:
    """Which kernel sweeps the sensor fans of map ``m`` (assets MapData)
    with z-group run lengths ``zgroups``, the JAX package's dispatch
    (its ops/raycast.py ray_fans_vs_tris): "v9" (K9) when use_fan_v9,
    whatever the runs; else, when every run is a multiple of 8, "culled"
    (K6) when use_fan_cull and "dense" (K2) otherwise; else "flat" (K7)
    over the whole soup, on any map (an odd team size's LOS run)."""
    if use_fan_v9(m.ray_cells):
        return "v9"
    if any(g % 8 for g in zgroups):
        return "flat"
    return "culled" if use_fan_cull(m.tris, m.cells) else "dense"


def _ray_fans_v9_plain(origins, zoff, dirs, cells, ray_tables,
                       soup: TriSoup, t_max=INF):
    """origins [N, 3]; zoff [N, F] per-ray origin z offsets; dirs = (dx,
    dy, dz) each [N, F]; cells [N] ray-table cells -> t [N, F]: the dense
    two-sided Moller-Trumbore sweep over each fan's candidate rows."""
    zero = torch.zeros_like(zoff)
    o = origins[:, None, :] + torch.stack([zero, zero, zoff], dim=-1)
    return _culled_rays_plain(o, torch.stack(dirs, dim=-1), cells,
                              ray_tables.cand_idx, soup, t_max)


def ray_fans_culled_v9(origins, zoff, dirs, cells, ray_tables,
                       soup: TriSoup, t_max=INF):
    """Nearest hit of every sensor ray of N fans among its fan's
    sensor-ray table candidates (cells [N], ops/culling.py RayTables),
    each ray starting at origins + (0, 0, zoff[n, f]). CUDA:
    csrc/fan_v9.cu, which finds the runs of equal z offsets of each fan
    and sweeps them with K2's hoisted sweep."""
    if not _route(origins):
        return _ray_fans_v9_plain(origins, zoff, dirs, cells, ray_tables,
                                  soup, t_max)
    N, F = zoff.shape
    if origins.shape != (N, 3) or cells.shape != (N,) or any(
            c.shape != (N, F) for c in dirs):
        raise ValueError("fan shapes disagree")
    # held in locals until the launch: a freed temporary's memory could
    # be handed to the next argument's copy
    org, zo = _f32(origins), _f32(zoff)
    dx, dy, dz = (_f32(c) for c in dirs)
    cl = cells.to(torch.int32).contiguous()
    cand = ray_tables.cand_idx.to(torch.int32).contiguous()
    out = torch.empty((N, F), device=origins.device, dtype=torch.float32)
    cuda_build.check(cuda_build.launcher("fan_v9")(
        _ptr(org), _ptr(zo), _ptr(dx), _ptr(dy), _ptr(dz),
        _ptr(soup.tri_rows), _ptr(cl), _ptr(cand), N, F, ray_tables.K,
        _ptr(out), _stream(origins),
    ), "fan_v9")
    ray_fans_culled_v9.launches += 1
    return out if t_max == INF else _where_inf(out <= t_max, out)


ray_fans_culled_v9.launches = 0
