"""P6: K9's sweep order, chained launches, against the dense fan.

    python -m madrona_mp_env_tpu_torch.tools.probes.v9_scan_timing \
        [--fans 12288] [--chain 50] [--seed 0] [--device cuda|cpu]

The port of the JAX package's tools/probes/v9_scan_timing.py, which
times its K9 sweep two ways, "full" (all K candidates at once) and
"chunked" (8 at a time), each chained --chain times, then the dense fan
and the v9 end-to-end path on the same 12,288 fans. Here: K9 as shipped
(csrc/fan_v9.cu stages all K = 80 candidates of a cell in one pass) and
``ray_fans_v9_chunked`` (the same kernel staging 8 at a time: fan_v9_chunked),
each bit-equal to ``raycast._ray_fans_v9_plain``; the dense fan K2
(``raycast.ray_fans_vs_tris`` over the whole soup); and the v9 end-to-end
path (``ray_cell_index`` + K9). Each row is timed over --chain
back-to-back calls between two CUDA events. The fans are
v9_kernel_probe.make_fans'. ``--device cpu`` runs the plain versions.
"""

from __future__ import annotations

import argparse
import json

import torch

from madrona_mp_env_tpu_torch.ops import cuda_build, raycast
from madrona_mp_env_tpu_torch.ops.culling import ray_cell_index
from madrona_mp_env_tpu_torch.ops.raycast import _f32, _ptr, _stream
from madrona_mp_env_tpu_torch.sim.env import resolve_device
from madrona_mp_env_tpu_torch.tools.kernel_bench import device_line, time_ms
from madrona_mp_env_tpu_torch.tools.probes.v9_kernel_probe import (
    FANS, by_fans, make_fans, probe_map,
)

CHAIN = 50
CHUNK = 8  # candidates per staging pass of the chunked order


def _ray_fans_v9_chunked_plain(origins, zoff, dirs, cells, ray_tables,
                               soup):
    """_ray_fans_v9_plain with the candidates taken CHUNK at a time: the
    minimum of the chunks' minima -> t [N, F]."""
    zero = torch.zeros_like(zoff)
    o = origins[:, None, :] + torch.stack([zero, zero, zoff], dim=-1)
    d = torch.stack(dirs, dim=-1)
    cand = ray_tables.cand_idx[cells.long()]  # [N, K]
    t = None
    for k in range(0, cand.shape[1], CHUNK):
        c = cand[:, k:k + CHUNK]
        ok = c >= 0
        rows = torch.where(ok, c, torch.zeros_like(c)).long()
        tc = raycast._ray_tri_t(
            o[:, :, None, :], d[:, :, None, :], soup.v0[rows][:, None],
            soup.e1[rows][:, None], soup.e2[rows][:, None],
            (soup.valid[rows] & ok)[:, None]).amin(dim=-1)
        t = tc if t is None else torch.minimum(t, tc)
    return t


def ray_fans_v9_chunked(origins, zoff, dirs, cells, ray_tables, soup):
    """K9 (``raycast.ray_fans_culled_v9``'s interface and result) with
    each cell's candidates staged CHUNK at a time. CUDA: csrc/fan_v9.cu
    fan_v9_chunked."""
    if not raycast._route(origins):
        return _ray_fans_v9_chunked_plain(origins, zoff, dirs, cells,
                                          ray_tables, soup)
    N, F = zoff.shape
    org, zo = _f32(origins), _f32(zoff)
    dx, dy, dz = (_f32(c) for c in dirs)
    cl = cells.to(torch.int32).contiguous()
    cand = ray_tables.cand_idx.to(torch.int32).contiguous()
    out = torch.empty((N, F), device=origins.device, dtype=torch.float32)
    cuda_build.check(cuda_build.launcher("fan_v9_chunked")(
        _ptr(org), _ptr(zo), _ptr(dx), _ptr(dy), _ptr(dz),
        _ptr(soup.tri_rows), _ptr(cl), _ptr(cand), N, F, ray_tables.K,
        _ptr(out), _stream(origins),
    ), "fan_v9_chunked")
    ray_fans_v9_chunked.launches += 1
    return out


ray_fans_v9_chunked.launches = 0


def run(m, x, chain, device):
    """{row: ms per call over ``chain`` back-to-back calls} on fans ``x``;
    the two sweep orders checked bit-equal to K9's plain version."""
    rt, soup = m.ray_cells, m.tris
    args = (x["origins"], x["zoff"], x["dirs"], x["cells"], rt, soup)
    want = by_fans(lambda f: raycast._ray_fans_v9_plain(
        f["origins"], f["zoff"], f["dirs"], f["cells"], rt, soup), x)
    rows = {
        "full": lambda: raycast.ray_fans_culled_v9(*args),
        "chunked": lambda: ray_fans_v9_chunked(*args),
    }
    for name, fn in rows.items():
        if not torch.equal(fn(), want):
            raise AssertionError(f"P6 {name} differs from _ray_fans_v9_plain")
    rows["dense_fan"] = lambda: raycast.ray_fans_vs_tris(
        x["origins"], x["zg"], x["dirs"], x["zgroups"], soup)
    rows["v9_end_to_end"] = lambda: raycast.ray_fans_culled_v9(
        x["origins"], x["zoff"], x["dirs"],
        ray_cell_index(rt, x["origins"]), rt, soup)
    return {name: time_ms(fn, chain, device) for name, fn in rows.items()}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fans", type=int, default=FANS)
    ap.add_argument("--chain", type=int, default=CHAIN)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    m = probe_map(device)
    x = make_fans(m, args.fans, args.seed, device)
    print(device_line(device))
    N, F = x["zoff"].shape
    print(f"fans={N} rays/fan={F} K={m.ray_cells.K} T={m.tris.num_tris} "
          f"chain={args.chain}", flush=True)
    res = run(m, x, args.chain, device)
    print(json.dumps({k: round(v, 4) for k, v in res.items()}), flush=True)
    return res


if __name__ == "__main__":
    main()
