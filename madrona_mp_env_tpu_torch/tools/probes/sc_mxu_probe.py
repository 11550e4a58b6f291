"""P4: the sphere cast with its dot products on the tensor cores.

    python -m madrona_mp_env_tpu_torch.tools.probes.sc_mxu_probe \
        [--casts 24576] [--iters 50] [--seed 0] [--device cuda|cpu]

The port of the JAX package's tools/probes/sc_mxu_probe.py. That probe
asks whether the sphere cast's affine and quadratic dot products can
move off the vector units: per (triangle row, cast) pair it takes 9
direction dots (``dirm``: the normal, the two barycentric gradients, the
three edges, the three vertices, each against d) and 9 origin terms
(``orgm``: the same vectors against o plus a constant column, e.g. -2
v0 . o + |v0|^2) as two [9T, 8] x [8, N] products, and finishes the face,
the three edge cylinders and the three vertex spheres from those terms
(the epilogue, ``_sc_mxu_plain``). Its matrices are uncentered: an origin
term carries |v0|^2-sized constants (~1e6 on simple_map) against r^2 =
225.

Here: ``make_casts`` draws the JAX probe's 24,576 casts (origins in
+-1500 with z in [0, 80), unit normal directions, r = 15);
``mxu_tables`` builds its ``dirm`` / ``orgm`` [8, 9T] and ``cons`` [T,
16] from the [T, 40] sc2 constants of the map's Morton-ordered
triangles (``raycast_cull.pack_sc2_consts``, simple_map: T = 256);
``sphere_cast_mxu`` is the kernel (csrc/sc_mxu.cu: ``mma.sync`` m16n8k8
TF32 with each operand split in a big and a small TF32 part, the
epilogue in registers, the minimum over rows by warp shuffles), held to
``_sc_mxu_plain`` by ``mxu_error``'s two numbers, since the tensor cores'
summation order is not the plain version's. ``main`` times it against
the production planar sweep (``raycast.sphere_cast``, the dense entry
of csrc/sphere_cast.cu: K4 dense, which the JAX probe's
``sphere_cast_planar_pallas(..., with_normal=False)`` reaches under its
default layout) and prints ms and Gpairs/s of both and the share of
casts within the JAX probe's parity bar (rtol 1e-3, atol 2e-2, both
misses equal). ``--device cpu`` runs the plain versions.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from madrona_mp_env_tpu_torch.assets import formats
from madrona_mp_env_tpu_torch.ops import cuda_build, raycast, raycast_cull
from madrona_mp_env_tpu_torch.ops.geom import sqrt
from madrona_mp_env_tpu_torch.ops.raycast import _f32, _ptr, _stream
from madrona_mp_env_tpu_torch.sim.env import resolve_device
from madrona_mp_env_tpu_torch.tools.kernel_bench import device_line, time_ms
from madrona_mp_env_tpu_torch.tools.probes.v9_kernel_probe import (
    REPO, probe_map,
)

R = 15.0
CASTS = 24576  # the L2-like workload: 2 casts x 12,288 agents
G = 9  # row groups of dirm / orgm
NSCAN = 50  # the TPU probe's scan length
RTOL, ATOL = 1e-3, 2e-2  # the TPU probe's parity bar against K4
# the kernel's bars against _sc_mxu_plain (3xTF32 products in the tensor
# cores' order; an emulation of 3xTF32 on the CPU gave 0.175 and 0 at the
# probe's 24,576 casts): largest |t difference| where both hit, share of
# casts whose hit or miss differs
MAX_DT, MAX_FLIP = 1.0, 1e-3
INF = float("inf")


def make_casts(n: int, seed: int, device):
    """``n`` casts drawn with numpy as the JAX probe draws them: origins
    uniform in +-1500 with z uniform in [0, 80), normal directions
    normalized in float32 -> (o [n, 3], d [n, 3])."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-1500, 1500, (n, 3)).astype(np.float32)
    o[:, 2] = rng.uniform(0, 80, n)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (torch.as_tensor(o, device=device),
            torch.as_tensor(d, device=device))


def planes_of(o, d) -> torch.Tensor:
    """The kernel's [8, N] input: ox oy oz dx dy dz 0 0."""
    z = torch.zeros_like(o[:, 0])
    return torch.stack([o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1],
                        d[:, 2], z, z]).contiguous()


def sc_packed_t(scene_dir: str, num_tris: int) -> np.ndarray:
    """[T, 40]: the sc2 constants of the map's Morton-ordered triangles,
    padded to the soup's ``num_tris`` rows (the JAX soup's sc_packedT)."""
    col = formats.load_collision_data(
        os.path.join(scene_dir, "collisions.bin"))
    tv = raycast.morton_sort_tris(col.tri_verts)
    return np.ascontiguousarray(
        raycast_cull.pack_sc2_consts(tv, pad_to=num_tris).T)


def mxu_tables(tbl: np.ndarray):
    """The JAX probe's matrices from the [T, 40] constants, in its
    float32 arithmetic: dirm, orgm [8, 9T] (rows 0-2 the vector, row 3
    of orgm the constant, one group of T columns each) and cons [T, 16]
    (valid, d00, d11, |e12|^2, their inverses, w1.n, w2.n)."""
    T = tbl.shape[0]
    v0, e1, e2, nrm = (tbl[:, i:i + 3] for i in (0, 3, 6, 9))
    v1, v2, e12, inv, w1 = (tbl[:, i:i + 3] for i in (16, 19, 22, 25, 28))
    w2 = tbl[:, 32:35]
    valid, d00, d11, l12 = (tbl[:, i] for i in (12, 13, 14, 15))
    c1, c2, w1n, w2n, nv0 = (tbl[:, i] for i in (31, 35, 36, 37, 38))

    dirm = np.zeros((8, G * T), np.float32)
    orgm = np.zeros((8, G * T), np.float32)
    for g, M in enumerate([nrm, w1, w2, e1, e2, e12, v0, v1, v2]):
        dirm[0:3, g * T:(g + 1) * T] = M.T
    ogroups = [
        (nrm, -nv0), (w1, c1), (w2, c2),
        (e1, -(v0 * e1).sum(1)), (e2, -(v0 * e2).sum(1)),
        (e12, -(v1 * e12).sum(1)),
        (-2 * v0, (v0 * v0).sum(1)), (-2 * v1, (v1 * v1).sum(1)),
        (-2 * v2, (v2 * v2).sum(1)),
    ]
    for g, (M, c) in enumerate(ogroups):
        orgm[0:3, g * T:(g + 1) * T] = M.T
        orgm[3, g * T:(g + 1) * T] = c
    cons = np.zeros((T, 16), np.float32)
    for k, x in enumerate((valid, d00, d11, l12)):
        cons[:, k] = x
    cons[:, 4:7] = inv
    cons[:, 7] = w1n
    cons[:, 8] = w2n
    return dirm, orgm, cons


def probe_tables(m, device):
    """(dirm, orgm, cons) on ``device`` of probe_map's simple_map ``m``."""
    tables = mxu_tables(sc_packed_t(os.path.join(REPO, "data", "simple_map"),
                                    m.tris.num_tris))
    return tuple(torch.as_tensor(x, device=device) for x in tables)


def operands(planes):
    """The products' right-hand sides, [8, N] each: o4 = (ox oy oz 1 0 0
    0 0) and d4 = (dx dy dz 0 0 0 0 0)."""
    p = planes
    one, zero = torch.ones_like(p[0:1]), torch.zeros_like(p[0:1])
    return (torch.cat([p[0:3], one, zero.expand(4, -1)]),
            torch.cat([p[3:6], zero.expand(5, -1)]))


def library_products(planes, dirm, orgm):
    """The two products as one library call each (torch.matmul; TF32 as
    the caller sets it): DD = dirm^T d4, AO = orgm^T o4, [9T, N]."""
    o4, d4 = operands(planes)
    return torch.matmul(dirm.T, d4), torch.matmul(orgm.T, o4)


def _dots(mat, x):
    """mat [8, M] and x [8, N] -> [M, N]: sum_k mat[k] x[k], k = 0..7 in
    that order (the products the kernel takes on the tensor cores)."""
    acc = mat[0][:, None] * x[0][None, :]
    for k in range(1, 8):
        acc = acc + mat[k][:, None] * x[k][None, :]
    return acc


def _sc_mxu_plain(planes, dirm, orgm, cons, r=R):
    """The JAX probe's ``mxu_kernel`` in torch, in float32: planes [8, N]
    -> t [N], the nearest sphere-cast hit over the T rows (inf on a
    miss, 0 on a start overlap)."""
    p = planes
    o4, d4 = operands(p)
    DD, AO = _dots(dirm, d4), _dots(orgm, o4)
    od = p[0:1] * p[3:4] + p[1:2] * p[4:5] + p[2:3] * p[5:6]
    oo = p[0:1] * p[0:1] + p[1:2] * p[1:2] + p[2:3] * p[2:3]
    T = cons.shape[0]

    def cc(k):
        return cons[:, k:k + 1]

    def g(M, i):
        return M[i * T:(i + 1) * T]

    def inf_unless(ok, t):
        return torch.where(ok, t, torch.full_like(t, INF))

    valid = cc(0) > 0.0
    len2s, invs = [cc(1), cc(2), cc(3)], [cc(4), cc(5), cc(6)]
    w1n, w2n = cc(7), cc(8)
    nd, w1d, w2d = g(DD, 0), g(DD, 1), g(DD, 2)
    h, u0, v0b = g(AO, 0), g(AO, 1), g(AO, 2)
    sign = torch.where(h >= 0.0, torch.ones_like(h), -torch.ones_like(h))
    nd_ok = torch.abs(nd) > 1e-9
    t_face = (sign * r - h) / torch.where(nd_ok, nd, torch.ones_like(nd))
    bv = u0 + t_face * w1d - sign * (r * w1n)
    bw = v0b + t_face * w2d - sign * (r * w2n)
    face_ok = (nd_ok & (t_face >= 0.0) & (bv >= 0.0) & (bw >= 0.0)
               & (bv + bw <= 1.0))
    t_face = inf_unless(face_ok, t_face)
    pv = u0 - h * w1n
    pw = v0b - h * w2n
    overlap = ((torch.abs(h) <= r) & (pv >= 0.0) & (pw >= 0.0)
               & (pv + pw <= 1.0))

    t_edge = torch.full_like(nd, INF)
    for i, p0g in zip(range(3), (6, 6, 7)):
        p0d, sd = g(DD, p0g), g(DD, 3 + i)
        ms, qq = g(AO, 3 + i), g(AO, p0g)
        md = od - p0d
        mm = oo + qq
        inv_l2, len2 = invs[i], len2s[i]
        aa = 1.0 - sd * sd * inv_l2
        bb = md - ms * sd * inv_l2
        cc2 = mm - ms * ms * inv_l2 - r * r
        start_in = (cc2 <= 0.0) & (ms >= 0.0) & (ms <= len2)
        disc = bb * bb - aa * cc2
        sq = sqrt(torch.clamp(disc, min=0.0))
        a_ok = torch.abs(aa) > 1e-12
        t_cyl = (-bb - sq) / torch.where(a_ok, aa, torch.ones_like(aa))
        s_hit = ms + t_cyl * sd
        ok = (a_ok & (disc >= 0.0) & (t_cyl >= 0.0) & (s_hit >= 0.0)
              & (s_hit <= len2))
        t_edge = torch.minimum(t_edge, inf_unless(ok, t_cyl))
        overlap = overlap | start_in
    for cgi in (6, 7, 8):
        bb = od - g(DD, cgi)
        cc2 = oo + g(AO, cgi) - r * r
        disc = bb * bb - cc2
        ts = -bb - sqrt(torch.clamp(disc, min=0.0))
        ok = (disc >= 0.0) & (ts >= 0.0)
        t_edge = torch.minimum(t_edge, inf_unless(ok, ts))
        overlap = overlap | (cc2 <= 0.0)

    t = torch.minimum(t_face, t_edge)
    t = torch.where(overlap, torch.zeros_like(t), t)
    return inf_unless(valid, t).amin(dim=0)


def sphere_cast_mxu(planes, dirm, orgm, cons, r: float = R):
    """The JAX probe's sweep: planes [8, N] (ox oy oz dx dy dz 0 0)
    against the T rows of dirm / orgm [8, 9T] and cons [T, 16] -> t [N].
    CUDA: csrc/sc_mxu.cu (3xTF32 mma.sync products, the epilogue in
    registers)."""
    if not raycast._route(planes):
        return _sc_mxu_plain(planes, dirm, orgm, cons, r)
    N, T = planes.shape[1], cons.shape[0]
    if planes.shape[0] != 8 or dirm.shape != (8, G * T) \
            or orgm.shape != (8, G * T) or cons.shape[1] != 16 \
            or T % 32:
        raise ValueError(f"sphere_cast_mxu: planes {tuple(planes.shape)}, "
                         f"dirm {tuple(dirm.shape)}, cons "
                         f"{tuple(cons.shape)} (T a multiple of 32)")
    p, dm, om, cn = (_f32(x) for x in (planes, dirm, orgm, cons))
    out = torch.empty(N, device=planes.device, dtype=torch.float32)
    cuda_build.check(cuda_build.launcher("sc_mxu")(
        _ptr(p), _ptr(dm), _ptr(om), _ptr(cn), float(r), N, T, _ptr(out),
        _stream(planes),
    ), "sc_mxu")
    sphere_cast_mxu.launches += 1
    return out


sphere_cast_mxu.launches = 0


def mxu_error(t, want):
    """(largest |t - want| where both hit, share of casts whose hit or
    miss differs): the kernel against its plain version."""
    hk, hp = torch.isfinite(t), torch.isfinite(want)
    both = hk & hp
    err = float((t - want).abs()[both].max()) if bool(both.any()) else 0.0
    return err, float((hk != hp).float().mean())


def parity(t, want):
    """The JAX probe's spot parity of t against K4's: (share of casts
    within rtol 1e-3 / atol 2e-2 or missing in both, largest |t - want|
    where both hit)."""
    both_inf = torch.isinf(t) & torch.isinf(want)
    close = both_inf | torch.isclose(t, want, rtol=RTOL, atol=ATOL)
    return float(close.float().mean()), mxu_error(t, want)[0]


def run(m, o, d, iters, device):
    """{mxu_ms, prod_ms, their Gpairs/s, parity_frac, max_diff} on casts
    o, d: the kernel (or its plain version) against K4 dense."""
    dirm, orgm, cons = probe_tables(m, device)
    planes = planes_of(o, d)
    soup = m.tris

    def mxu():
        return sphere_cast_mxu(planes, dirm, orgm, cons)

    def prod():
        return raycast.sphere_cast(o, d, R, soup)[0]

    res = {}
    pairs = o.shape[0] * soup.num_tris
    for name, fn in (("mxu", mxu), ("prod", prod)):
        ms = time_ms(fn, iters, device)
        res[f"{name}_ms"], res[f"{name}_gpairs_s"] = ms, pairs / ms / 1e6
    res["parity_frac"], res["max_diff"] = parity(mxu(), prod())
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--casts", type=int, default=CASTS)
    ap.add_argument("--iters", type=int, default=NSCAN)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    m = probe_map(device)
    o, d = make_casts(args.casts, args.seed, device)
    print(device_line(device))
    print(f"casts={o.shape[0]} T={m.tris.num_tris} r={R}", flush=True)
    res = run(m, o, d, args.iters, device)
    for name in ("mxu", "prod"):
        print(f"{name:12s}: {res[f'{name}_ms']:7.3f} ms  "
              f"{res[f'{name}_gpairs_s']:6.1f} Gpairs/s", flush=True)
    print(f"parity frac: {res['parity_frac']} max diff (finite both): "
          f"{res['max_diff']}", flush=True)
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
