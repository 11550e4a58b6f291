"""Batched ray / sphere-cast queries against the static triangle soup.

Every (ray, triangle) pair is evaluated densely, over the whole soup or
over a cell's candidate rows (ops/culling.py tables). Each query has two
implementations side by side:

  * a plain PyTorch version (``_..._dense``), the arithmetic of the JAX
    package's dense CPU path written out op for op, and
  * a hand-written CUDA kernel (``csrc/*.cu``) that repeats the same
    arithmetic per (ray, triangle) pair in registers.

The public entry (``ray_vs_tris``, ``ray_fans_vs_tris``,
``ray_fans_culled``, ``ray_fans_culled_v9``, ``sphere_cast``,
``sphere_cast_culled``, ``sphere_cast_packed``) dispatches on the device
of its input: a CPU tensor goes to the plain version, a CUDA tensor to
the kernel, anything else raises. Each entry counts its kernel launches
in ``<entry>.launches``. Which entry the step calls is decided by the
gates ``use_fan_v9`` and ``use_fan_cull`` here and ``sim/movement.py
use_sc_pack``, as the JAX package decides it.

Conventions: miss => t = +inf; sphere casts return (t, winner row) where
the winner is the lowest triangle row among equal t (the dense path's
argmin), row 0 on a miss; ``sc_normals_from_idx`` rebuilds the dense
path's contact normal for a winner row.
"""

from __future__ import annotations

import ctypes
import functools
import os
from dataclasses import dataclass

import numpy as np
import torch

from . import cuda_build
from .geom import cross, dot, sqrt

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


# ---------------------------------------------------------------------------
# K1: nearest-hit rays (hitscan)
# ---------------------------------------------------------------------------

def _ray_tri_t(o, d, v0, e1, e2, valid):
    """Two-sided Moller-Trumbore per (ray, triangle) pair: every argument
    broadcasts to [..., T(, 3)] -> t [..., T] (inf on miss)."""
    pvec = cross(d, e2)
    det = dot(e1, pvec)
    det_ok = torch.abs(det) > 1e-12
    inv_det = torch.where(det_ok, 1.0 / det, torch.zeros_like(det))
    tvec = o - v0
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, e1)
    v = dot(d, qvec) * inv_det
    t = dot(e2, qvec) * inv_det
    hit = (
        det_ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 0.0)
        & valid
    )
    return _where_inf(hit, t)


def _ray_vs_tris_dense(o, d, soup: TriSoup):
    """Nearest hit over all triangles: o, d [..., 3] -> t [...] (inf on
    miss)."""
    return _ray_tri_t(o[..., None, :], d[..., None, :], soup.v0, soup.e1,
                      soup.e2, soup.valid).amin(dim=-1)


def ray_vs_tris(o, d, soup: TriSoup):
    """Nearest-hit ray vs the soup (MeshBVH::traceRay semantics). o, d
    [..., 3] -> t [...]. CUDA: one thread per ray (csrc/ray_tris.cu)."""
    if not _route(o):
        return _ray_vs_tris_dense(o, d, soup)
    shape = o.shape[:-1]
    R = int(np.prod(shape)) if shape else 1
    o2 = _f32(o.reshape(R, 3))
    d2 = _f32(d.reshape(R, 3))
    out = torch.empty(R, device=o.device, dtype=torch.float32)
    cuda_build.check(cuda_build.launcher("ray_tris")(
        _ptr(o2), _ptr(d2), _ptr(soup.tri_rows), soup.num_tris, R,
        _ptr(out), _stream(o),
    ), "ray_tris")
    ray_vs_tris.launches += 1
    return out.reshape(shape)


ray_vs_tris.launches = 0


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


def ray_fans_vs_tris(origins, zg, dirs, zgroups, soup: TriSoup):
    """Nearest hit of every sensor ray of N fans over the whole soup. Rays
    within a z-group run share their origin, so the kernel hoists the
    origin terms per (fan, group, triangle) (csrc/fan_tris.cu). Any run
    lengths and any soup size work."""
    if not _route(origins):
        return _ray_fans_dense(origins, zg, dirs, zgroups, soup)
    N, F, G, group_of_ray, org, zgc, dx, dy, dz = _fan_args(
        origins, zg, dirs, zgroups)
    out = torch.empty((N, F), device=origins.device, dtype=torch.float32)
    cuda_build.check(cuda_build.launcher("fan_tris")(
        _ptr(org), _ptr(zgc), _ptr(dx), _ptr(dy), _ptr(dz),
        _ptr(group_of_ray), _ptr(soup.tri_rows), N, F, G, soup.num_tris,
        _ptr(out), _stream(origins),
    ), "fan_tris")
    ray_fans_vs_tris.launches += 1
    return out


ray_fans_vs_tris.launches = 0


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


def ray_fans_culled(origins, zg, dirs, zgroups, cells, tables,
                    soup: TriSoup, t_max=INF):
    """Nearest hit of every sensor ray of N fans among its fan's PVS cell
    candidates (cells [N], ops/culling.py CellTables): the big-map fan.
    CUDA: csrc/fan_culled.cu, K2's hoisted sweep over the cell's rows."""
    if not _route(origins):
        return _ray_fans_culled_plain(origins, zg, dirs, zgroups, cells,
                                      tables, soup, t_max)
    N, F, G, group_of_ray, org, zgc, dx, dy, dz = _fan_args(
        origins, zg, dirs, zgroups)
    if cells.shape != (N,):
        raise ValueError("one cell per fan expected")
    cand = tables.cand_idx.to(torch.int32).contiguous()
    out = torch.empty((N, F), device=origins.device, dtype=torch.float32)
    cuda_build.check(cuda_build.launcher("fan_culled")(
        _ptr(org), _ptr(zgc), _ptr(dx), _ptr(dy), _ptr(dz),
        _ptr(group_of_ray), _ptr(soup.tri_rows),
        _ptr(cells.to(torch.int32).contiguous()), _ptr(cand), N, F, G,
        tables.K, _ptr(out), _stream(origins),
    ), "fan_culled")
    ray_fans_culled.launches += 1
    return out if t_max == INF else _where_inf(out <= t_max, out)


ray_fans_culled.launches = 0


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
    p = _sc_pairs(o[..., None, :], d[..., None, :], r, soup.v0, soup.e1,
                  soup.e2, soup.normal, soup.valid)
    t, idx = p["t_tri"].min(dim=-1)
    return t, idx.to(torch.int32)


def sphere_cast(o, d, r: float, soup: TriSoup):
    """Sphere sweep of radius r from o along unit d against the soup.
    Returns (t [...], winner row [...] i32). CUDA: one thread per cast
    (csrc/sphere_cast.cu, dense entry)."""
    if not _route(o):
        return _sphere_cast_dense(o, d, r, soup)
    shape = o.shape[:-1]
    R = int(np.prod(shape)) if shape else 1
    t, idx = _sc_launch(
        _f32(o.reshape(R, 3)), _f32(d.reshape(R, 3)), r, soup, None, None, 1
    )
    sphere_cast.launches += 1
    return t.reshape(shape), idx.reshape(shape)


sphere_cast.launches = 0


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


def sphere_cast_culled(o, d, r: float, cells, short, soup: TriSoup):
    """Grouped sphere casts o, d [N, CPA, 3], one short-table cell per group
    (cells [N]). Exact against ``sphere_cast`` for the xy-bounded movement
    casts (ops/culling.py notes); same winner rule, global rows. CUDA:
    the culled entry of csrc/sphere_cast.cu."""
    if not _route(o):
        return _sphere_cast_culled_plain(o, d, r, cells, short, soup)
    N, CPA = o.shape[0], o.shape[1]
    t, idx = _sc_launch(
        _f32(o.reshape(N * CPA, 3)), _f32(d.reshape(N * CPA, 3)), r, soup,
        cells.to(torch.int32).contiguous(), short, CPA,
    )
    sphere_cast_culled.launches += 1
    return t.reshape(N, CPA), idx.reshape(N, CPA)


sphere_cast_culled.launches = 0


def sphere_cast_packed(o, d, r: float, cells, short, soup: TriSoup):
    """K4': the 1-2-cast movement batches (L2, L3, fall; o, d [N, CPA, 3],
    CPA in {1, 2, 4}) against the MOVE_MARGIN short tables, one cell per
    group (cells [N]). The same culled sweep as ``sphere_cast_culled``
    (same plain version, same kernel entry), counted apart: the JAX
    package's sphere_cast_packed is a kernel of its own whose 8-lane
    same-cell packing has no counterpart at one thread per cast. Exact
    where the step reads it: down casts at any depth, forward casts within
    move_dist + buf (ops/culling.py notes)."""
    if not _route(o):
        return _sphere_cast_culled_plain(o, d, r, cells, short, soup)
    N, CPA = o.shape[0], o.shape[1]
    t, idx = _sc_launch(
        _f32(o.reshape(N * CPA, 3)), _f32(d.reshape(N * CPA, 3)), r, soup,
        cells.to(torch.int32).contiguous(), short, CPA,
    )
    sphere_cast_packed.launches += 1
    return t.reshape(N, CPA), idx.reshape(N, CPA)


sphere_cast_packed.launches = 0


def _sc_launch(o, d, r, soup, cells, short, cpa):
    R = o.shape[0]
    dev = o.device
    t = torch.empty(R, device=dev, dtype=torch.float32)
    idx = torch.empty(R, device=dev, dtype=torch.int32)
    if cells is None:
        cells_p, cand_p, K = ctypes.c_void_p(0), ctypes.c_void_p(0), 0
    else:
        cells_p, cand_p, K = _ptr(cells), _ptr(short.cand), short.K
    cuda_build.check(cuda_build.launcher("sphere_cast")(
        _ptr(o), _ptr(d), _ptr(soup.tri_rows), float(r), soup.num_tris, R,
        cells_p, cand_p, K, cpa, _ptr(t), _ptr(idx), _stream(o),
    ), "sphere_cast")
    return t, idx


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
    dx, dy, dz = (_f32(c) for c in dirs)
    cand = ray_tables.cand_idx.to(torch.int32).contiguous()
    out = torch.empty((N, F), device=origins.device, dtype=torch.float32)
    cuda_build.check(cuda_build.launcher("fan_v9")(
        _ptr(_f32(origins)), _ptr(_f32(zoff)), _ptr(dx), _ptr(dy), _ptr(dz),
        _ptr(soup.tri_rows), _ptr(cells.to(torch.int32).contiguous()),
        _ptr(cand), N, F, ray_tables.K, _ptr(out), _stream(origins),
    ), "fan_v9")
    ray_fans_culled_v9.launches += 1
    return out if t_max == INF else _where_inf(out <= t_max, out)


ray_fans_culled_v9.launches = 0
