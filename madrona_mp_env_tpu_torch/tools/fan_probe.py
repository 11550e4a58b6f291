"""P2: the sensor-fan sweep (K2) split into its parts at the sim's shape.

    python -m madrona_mp_env_tpu_torch.tools.fan_probe \
        [--fans 12288] [--iters 20] [--seed 0] [--device cuda|cpu]

The port of the JAX package's tools/fan_probe.py (12,288 fans x 104 rays
x 256 triangles: matmul only, epilogue only, fused with an approximate
reciprocal against an exact divide and an exact reciprocal, chunked
candidates). Each variant is K2's kernel with one template switched
(csrc/fan_probe.cu): ``exact`` (K2's own arithmetic), ``rcp_ieee`` (the
correctly rounded reciprocal, then products), ``rcp_approx``
(rcp.approx), ``dots_only`` (the pair's direction dots and their
minimum), ``epilogue`` (the divide, scales and hit test on dots read per
row from a [T, 4] buffer) and ``chunked`` (the rows staged 8 at a time).
The fans are v9_kernel_probe.make_fans', swept over the whole simple_map
soup. Each variant has a plain version: ``exact``, ``rcp_ieee`` and
``chunked`` compute K2's function (``raycast._ray_fans_dense``'s bits),
``dots_only`` and ``epilogue`` their own; ``rcp_approx`` has none bit
for bit, and is held to the exact one by its largest absolute error and
the share of rays beyond 1e-4 relative. Besides, ``dots_only`` is timed
against one ``torch.matmul`` of the same directions with a [3, 3T]
matrix of the triangles' edge and normal vectors (the TPU probe's matrix
product). ``--device cpu`` runs the plain versions.
"""

from __future__ import annotations

import argparse
import ctypes
import json

import numpy as np
import torch

from madrona_mp_env_tpu_torch.ops import cuda_build, raycast
from madrona_mp_env_tpu_torch.ops.geom import cross, dot
from madrona_mp_env_tpu_torch.ops.raycast import _f32, _ptr, _stream
from madrona_mp_env_tpu_torch.sim.env import resolve_device
from madrona_mp_env_tpu_torch.tools.kernel_bench import device_line, time_ms
from madrona_mp_env_tpu_torch.tools.probes.v9_kernel_probe import (
    FANS, by_fans, make_fans, probe_map,
)

VARIANTS = ("exact", "rcp_ieee", "rcp_approx", "dots_only", "epilogue",
            "chunked")
REL = 1e-4  # rcp_approx: rays beyond this relative error are counted


def make_aux(T: int, seed: int, device) -> torch.Tensor:
    """[T, 4] stand-in dots for the epilogue variant: det of either sign
    with |det| in [0.5, 2], u and v numerators in [0, 1), 0."""
    g = np.random.default_rng(seed + 1)
    aux = np.zeros((T, 4), np.float32)
    aux[:, 0] = g.uniform(0.5, 2.0, T) * g.choice([-1.0, 1.0], T)
    aux[:, 1:3] = g.uniform(0.0, 1.0, (T, 2))
    return torch.as_tensor(aux, device=device)


def _pair_terms(origins, zg, dirs, zgroups, soup):
    """Per (fan, ray, row): (d, pvec, det, tvec, qvec) of K2's sweep."""
    o, d = raycast._fan_rays(origins, zg, dirs, zgroups)
    d = d[:, :, None, :]
    pvec = cross(d, soup.e2)
    tvec = o[:, :, None, :] - soup.v0
    qvec = cross(tvec, soup.e1)
    return d, pvec, dot(soup.e1, pvec), tvec, qvec


def _fan_probe_plain(variant, origins, zg, dirs, zgroups, soup, aux=None):
    """The plain version of ``variant`` -> [N, F]."""
    if variant in ("exact", "chunked", "rcp_approx"):
        return raycast._ray_fans_dense(origins, zg, dirs, zgroups, soup)
    d, pvec, det, tvec, qvec = _pair_terms(origins, zg, dirs, zgroups, soup)
    if variant == "dots_only":
        a = dot(tvec, pvec)
        b = dot(d, qvec)
        return torch.minimum(det, torch.minimum(a, b)).amin(dim=-1)
    if variant == "epilogue":
        det, un, vn = aux[:, 0], aux[:, 1], aux[:, 2]
    elif variant == "rcp_ieee":
        un, vn = dot(tvec, pvec), dot(d, qvec)
    else:
        raise ValueError(f"unknown fan probe variant {variant}")
    det_ok = torch.abs(det) > 1e-12
    inv = torch.where(det_ok, torch.reciprocal(det), torch.zeros_like(det))
    u, v = un * inv, vn * inv
    t = dot(soup.e2, qvec) * inv
    hit = (det_ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 0.0)
           & soup.valid)
    return raycast._where_inf(hit, t).amin(dim=-1)


def _entry(variant):
    code = VARIANTS.index(variant)

    def fan_probe(origins, zg, dirs, zgroups, soup, aux=None):
        """K2's sweep as the ``variant`` probe: origins [N, 3], zg [N, G]
        with runs ``zgroups``, dirs = (dx, dy, dz) [N, F] each, the whole
        soup -> [N, F]. CUDA: csrc/fan_probe.cu."""
        if not raycast._route(origins):
            return _fan_probe_plain(variant, origins, zg, dirs, zgroups,
                                    soup, aux)
        N, F, G, group_of_ray, org, zgc, dx, dy, dz = raycast._fan_args(
            origins, zg, dirs, zgroups)
        ax = _f32(aux) if aux is not None else None
        out = torch.empty((N, F), device=origins.device, dtype=torch.float32)
        cuda_build.check(cuda_build.launcher("fan_probe")(
            code, _ptr(org), _ptr(zgc), _ptr(dx), _ptr(dy), _ptr(dz),
            _ptr(group_of_ray), _ptr(soup.tri_rows),
            _ptr(ax) if ax is not None else ctypes.c_void_p(0), N, F, G,
            soup.num_tris, _ptr(out), _stream(origins),
        ), f"fan_probe {variant}")
        fan_probe.launches += 1
        return out

    fan_probe.__name__ = f"fan_probe_{variant}"
    fan_probe.launches = 0
    return fan_probe


# one entry (and launch count) per variant
ENTRIES = {v: _entry(v) for v in VARIANTS}


def direction_matmul(x, soup):
    """The direction dots as one library call: directions [N F, 3] times
    the soup's [3, 3T] edge and normal vectors (TF32 as the caller sets
    it)."""
    d = torch.stack(x["dirs"], dim=-1).reshape(-1, 3)
    mat = torch.cat([soup.e1, soup.e2, soup.normal], dim=0).T.contiguous()
    return torch.matmul(d, mat)


def approx_error(t, want):
    """(max abs error where both hit, share of rays beyond REL relative
    or with another hit/miss) of rcp_approx against the exact t."""
    both = torch.isfinite(t) & torch.isfinite(want)
    err = torch.where(both, (t - want).abs(), torch.zeros_like(t))
    bad = (torch.isfinite(t) != torch.isfinite(want)) | (
        err > REL * want.abs().clamp(min=1.0))
    return float(err.max()), float(bad.float().mean())


def run(m, x, iters, device, seed=0):
    """{variant: ms} plus the rcp_approx error, each exact variant checked
    bit-equal to its plain version (on the card: the kernel against it)."""
    soup = m.tris
    aux = make_aux(soup.num_tris, seed, device)
    args = (x["origins"], x["zg"], x["dirs"], x["zgroups"], soup)

    def plain(v):
        return by_fans(lambda f: _fan_probe_plain(
            v, f["origins"], f["zg"], f["dirs"], f["zgroups"], soup, aux), x)

    res = {}
    exact = plain("exact")
    for v in VARIANTS:
        fn = ENTRIES[v]
        got = fn(*args, aux=aux)
        if v == "rcp_approx":
            res["rcp_approx_max_abs_err"], res["rcp_approx_share_beyond"] = (
                approx_error(got, exact))
        elif not torch.equal(got, exact if v in ("exact", "chunked")
                             else plain(v)):
            raise AssertionError(f"P2 {v} differs from its plain version")
        res[v] = time_ms(lambda: fn(*args, aux=aux), iters, device)
    if device.type == "cuda":
        res["dots_matmul"] = time_ms(lambda: direction_matmul(x, soup), iters,
                                     device)
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fans", type=int, default=FANS)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    m = probe_map(device)
    x = make_fans(m, args.fans, args.seed, device)
    print(device_line(device))
    N, F = x["zoff"].shape
    print(f"fans={N} rays/fan={F} T={m.tris.num_tris}", flush=True)
    res = run(m, x, args.iters, device, args.seed)
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
