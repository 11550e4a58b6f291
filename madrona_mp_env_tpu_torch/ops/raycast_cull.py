"""Agent-capsule queries + the packed sphere-cast constants table.

  * ray_vs_capsules / fan_capsules / fan_capsules_explicit — rays vs the
    z-aligned agent capsules (checkCapsuleEntity, reference
    src/utils.cpp:34-54). ``fan_capsules`` is the sensor sweep: every
    sensor ray of every agent against its world's capsules, caster
    excluded, from per-group z offsets; ``fan_capsules_explicit`` takes
    each ray's origin and the capsule it excludes; CUDA kernels
    csrc/fan_capsules.cu (and ``fan_capsules_v1``, K3's predecessor).
  * pack_sc2_consts — the [40, T] per-triangle table of the JAX package's
    sphere-cast kernels (the JAX short tables carry it per candidate). The
    port's kernels read the soup's [T, 16] ``tri_rows`` instead; the table
    is kept for a kernel that wants the precomputed terms.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import consts
from . import cuda_build
from .raycast import (INF, _f32, _group_of_ray, _ptr, _ray_zoffs, _route,
                      _stream, _where_inf)
from .raycast import _ray_vs_segment_capsule

SC2_ROWS = 40
CAPSULE_SEG_H = consts.stand_height - 2.0 * consts.agent_radius


def pack_sc2_consts(tri_verts: np.ndarray, pad_to: int = 128) -> np.ndarray:
    """[T, 3, 3] vertices -> [40, T_pad] sphere-cast constants:
    0-2 v0, 3-5 e1, 6-8 e2, 9-11 unit normal, 12 valid, 13 d00, 14 d11,
    15 |e12|^2, 16-18 v1, 19-21 v2, 22-24 e12, 25-27 inverses of 13-15,
    28-30 w1, 31 c1, 32-34 w2, 35 c2, 36 w1.n, 37 w2.n, 38 n.v0."""
    t = tri_verts.shape[0]
    T = -(-max(t, 1) // pad_to) * pad_to
    v = np.zeros((T, 3, 3), np.float64)
    v[:t] = tri_verts
    v0 = v[:, 0]
    e1 = v[:, 1] - v[:, 0]
    e2 = v[:, 2] - v[:, 0]
    n = np.cross(e1, e2)
    ln = np.linalg.norm(n, axis=-1, keepdims=True)
    n = np.where(ln > 1e-20, n / np.maximum(ln, 1e-30), 0.0)
    d00 = np.sum(e1 * e1, axis=-1)
    d01 = np.sum(e1 * e2, axis=-1)
    d11 = np.sum(e2 * e2, axis=-1)
    den = d00 * d11 - d01 * d01
    inv_den = np.where(
        np.abs(den) > 1e-20, 1.0 / np.where(den == 0, 1, den), 0.0
    )
    e12 = e2 - e1
    l12 = np.sum(e12 * e12, axis=-1)
    w1 = (d11[:, None] * e1 - d01[:, None] * e2) * inv_den[:, None]
    w2 = (d00[:, None] * e2 - d01[:, None] * e1) * inv_den[:, None]

    def safe_inv(x):
        return np.where(np.abs(x) > 1e-20, 1.0 / np.where(x == 0, 1, x), 0.0)

    out = np.zeros((SC2_ROWS, T), np.float32)
    out[0:3] = v0.T
    out[3:6] = e1.T
    out[6:9] = e2.T
    out[9:12] = n.T
    out[12] = ((np.arange(T) < t) & (ln[:, 0] > 1e-20)).astype(np.float32)
    out[13] = d00
    out[14] = d11
    out[15] = l12
    out[16:19] = (v0 + e1).T
    out[19:22] = (v0 + e2).T
    out[22:25] = e12.T
    out[25] = safe_inv(d00)
    out[26] = safe_inv(d11)
    out[27] = safe_inv(l12)
    out[28:31] = w1.T
    out[31] = -np.sum(w1 * v0, axis=-1)
    out[32:35] = w2.T
    out[35] = -np.sum(w2 * v0, axis=-1)
    out[36] = np.sum(w1 * n, axis=-1)
    out[37] = np.sum(w2 * n, axis=-1)
    out[38] = np.sum(n * v0, axis=-1)
    return out


def ray_vs_capsules(o, d, base_pos, mask):
    """Rays vs z-aligned agent capsules: the segment runs from base_pos +
    (0, 0, r) up by stand_height - 2r whatever the pose. o, d [..., 3];
    base_pos [..., A, 3] (broadcast against the rays' batch dims); mask
    [..., A] bool. Returns t [..., A] (inf on miss or masked)."""
    r = consts.agent_radius
    up = torch.tensor([0.0, 0.0, 1.0], device=o.device)
    p0 = base_pos + up * r
    seg = torch.broadcast_to(up * CAPSULE_SEG_H, p0.shape)
    seg_len2 = torch.full(p0.shape[:-1], CAPSULE_SEG_H * CAPSULE_SEG_H,
                          device=o.device)
    t = _ray_vs_segment_capsule(o[..., None, :], d[..., None, :], p0, seg,
                                seg_len2, r)
    return _where_inf(mask, t)


def _fan_capsules_ray_plain(pos, zoff, dirs, alive):
    """pos [W, A, 3]; zoff, dx, dy, dz [W, A, F]; alive [W, A] bool ->
    (t [W, A, F], capsule index [W, A, F] i32, -1 on miss): the explicit
    sweep from pos + (0, 0, zoff), each ray skipping its caster."""
    W, A, F = zoff.shape
    zero = torch.zeros_like(zoff)
    o = pos[:, :, None, :] + torch.stack([zero, zero, zoff], dim=-1)
    own = torch.arange(A, device=pos.device)[None, :, None].expand(W, A, F)
    return _fan_capsules_explicit_plain(o, torch.stack(dirs, dim=-1), own,
                                        pos, alive)


def _fan_capsules_plain(pos, zg, dirs, zgroups, alive):
    """fan_capsules' plain version: each ray's z offset taken from its
    group's (zg [W, A, G] over the runs ``zgroups``), the live agents those
    with alive [W, A] > 0, then _fan_capsules_ray_plain."""
    W, A, G = zg.shape
    zoff = _ray_zoffs(zg.reshape(W * A, G), zgroups).reshape(W, A, -1)
    return _fan_capsules_ray_plain(pos, zoff, dirs, alive > 0.0)


def fan_capsules(pos, zg, dirs, zgroups, alive):
    """Every sensor ray vs its world's agent capsules, caster excluded.
    pos [W, A, 3]; zg [W, A, G] the origin's z offset above pos of each
    z-group, whose run lengths are ``zgroups`` (F = sum(zgroups) rays a
    fan); dirs = (dx, dy, dz) each [W, A, F]; alive [W, A] float, > 0 for
    a live agent. Returns (t, idx) [W, A, F] with idx the lowest capsule
    index among equal t, -1 on a miss. CUDA: csrc/fan_capsules.cu
    fan_capsules_kernel, a block per fan with the (z-group, capsule)
    terms in shared memory; A <= 32."""
    if not _route(pos):
        return _fan_capsules_plain(pos, zg, dirs, zgroups, alive)
    W, A, G = zg.shape
    F = int(sum(zgroups))
    if len(zgroups) != G or dirs[0].shape != (W, A, F) or A > 32 or \
            pos.shape != (W, A, 3) or alive.shape != (W, A):
        raise ValueError("capsule fan shapes disagree (or A > 32)")
    dev = pos.device
    # held in locals until the launch (see ops/raycast.py)
    p, z, al = _f32(pos), _f32(zg), _f32(alive)
    dx, dy, dz = (_f32(c) for c in dirs)
    group_of_ray = _group_of_ray(tuple(zgroups), dev)
    t = torch.empty((W, A, F), device=dev, dtype=torch.float32)
    idx = torch.empty((W, A, F), device=dev, dtype=torch.int32)
    cuda_build.check(cuda_build.launcher("fan_capsules")(
        _ptr(p), _ptr(z), _ptr(dx), _ptr(dy), _ptr(dz), _ptr(group_of_ray),
        _ptr(al), W, A, F, G, float(consts.agent_radius),
        float(CAPSULE_SEG_H), _ptr(t), _ptr(idx), _stream(pos),
    ), "fan_capsules")
    fan_capsules.launches += 1
    return t, idx


fan_capsules.launches = 0


def fan_capsules_v1(pos, zoff, dirs, alive):
    """K3's earlier kernel (csrc/fan_capsules.cu fan_capsules_v1_kernel:
    a thread per ray, the whole ray_capsule per capsule) on CUDA tensors
    only, with its own arguments: zoff [W, A, F] per ray, alive [W, A]
    bool. The predecessor that chip_smoke.py times beside fan_capsules;
    plain version _fan_capsules_ray_plain."""
    if not _route(pos):
        raise ValueError("fan_capsules_v1 takes CUDA tensors")
    W, A, F = zoff.shape
    dev = pos.device
    p = _f32(pos)
    z = _f32(zoff)
    dx, dy, dz = (_f32(c) for c in dirs)
    al = alive.to(torch.uint8).contiguous()
    t = torch.empty((W, A, F), device=dev, dtype=torch.float32)
    idx = torch.empty((W, A, F), device=dev, dtype=torch.int32)
    cuda_build.check(cuda_build.launcher("fan_capsules_v1")(
        _ptr(p), _ptr(z), _ptr(dx), _ptr(dy), _ptr(dz), _ptr(al), W, A, F,
        float(consts.agent_radius), float(CAPSULE_SEG_H), _ptr(t), _ptr(idx),
        _stream(pos),
    ), "fan_capsules_v1")
    fan_capsules_v1.launches += 1
    return t, idx


fan_capsules_v1.launches = 0


def _fan_capsules_explicit_plain(o, dirs, self_idx, cap_pos, alive):
    """ray_vs_capsules with each ray's self_idx column masked, then the
    argmin: (t [W, A, F], capsule index [W, A, F] i32, -1 on miss)."""
    A = cap_pos.shape[1]
    other = torch.arange(A, device=o.device) != self_idx[..., None].long()
    t_caps = ray_vs_capsules(o, dirs, cap_pos[:, None, None],
                             alive[:, None, None, :] & other)
    t, idx = t_caps.min(dim=-1)
    idx = torch.where(torch.isinf(t), torch.full_like(idx, -1), idx)
    return t, idx.to(torch.int32)


def fan_capsules_explicit(o, dirs, self_idx, cap_pos, alive):
    """Rays with explicit origins vs their world's agent capsules: the JAX
    package's ``fan_capsules`` (ops/raycast_cull.py:418, its
    _make_cap_kernel with derive_origins=False), batched over worlds. o,
    dirs [W, A, F, 3]; self_idx [W, A, F] i32, the capsule each ray
    skips; cap_pos [W, A, 3]; alive [W, A] bool. Returns (t [W, A, F],
    hit_idx [W, A, F] i32), the lowest capsule index among equal t, -1 on
    a miss. CUDA: one thread per ray (csrc/fan_capsules.cu, explicit
    entry)."""
    if not _route(o):
        return _fan_capsules_explicit_plain(o, dirs, self_idx, cap_pos,
                                            alive)
    W, A, F = self_idx.shape
    if o.shape != (W, A, F, 3) or dirs.shape != o.shape or \
            cap_pos.shape != (W, A, 3) or alive.shape != (W, A):
        raise ValueError("capsule fan shapes disagree")
    # held in locals until the launch (see ops/raycast.py)
    oc, dc, pc = _f32(o), _f32(dirs), _f32(cap_pos)
    si = self_idx.to(torch.int32).contiguous()
    al = alive.to(torch.uint8).contiguous()
    t = torch.empty((W, A, F), device=o.device, dtype=torch.float32)
    idx = torch.empty((W, A, F), device=o.device, dtype=torch.int32)
    cuda_build.check(cuda_build.launcher("fan_capsules_explicit")(
        _ptr(oc), _ptr(dc), _ptr(si), _ptr(pc), _ptr(al), W, A, F,
        float(consts.agent_radius), float(CAPSULE_SEG_H), _ptr(t), _ptr(idx),
        _stream(o),
    ), "fan_capsules_explicit")
    fan_capsules_explicit.launches += 1
    return t, idx


fan_capsules_explicit.launches = 0
