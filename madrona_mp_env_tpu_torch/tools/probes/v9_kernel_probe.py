"""P5: the sensor-ray-table fan (K9) with and without its table gather.

    python -m madrona_mp_env_tpu_torch.tools.probes.v9_kernel_probe \
        [--fans 12288] [--iters 30] [--seed 0] [--device cuda|cpu]

The port of the JAX package's tools/probes/v9_kernel_probe.py, which
times its K9 kernel at 12,288 fans x 104 rays on simple_map (K = 80
candidates per cell) once with the per-block table gather inside the call
(``call``) and once on tables gathered beforehand (``call_nogather``).
Here the three rows are: K9 as the step runs it
(``raycast.ray_fans_culled_v9``, each candidate read through the cell's
``cand_idx``), the pre-gathered entry with its gather (``gather_tables``:
a torch gather of each cell's candidate rows of the soup into [C, K, 16],
-1 padding an all-zero invalid row) and the pre-gathered entry alone
(``ray_fans_v9_gathered``, csrc/fan_v9.cu fan_v9_gathered). All three
are bit-equal to ``raycast._ray_fans_v9_plain``.

The fans (``make_fans``, shared with v9_scan_timing.py and
tools/fan_probe.py) are the JAX probes' shapes on real geometry, from
``--seed`` through numpy: origins uniform in +-1500 at z = 10, one z
offset in [20, 60] per z-group of the sensor fan (24 LOS rays, two rows
of 32 and two of 8 lidar rays), unit normal directions, each fan's cell
from ``ray_cell_index``, the fans ordered by cell. Times are CUDA events
(kernel_bench.time_ms); ``--device cpu`` runs the plain versions.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

import madrona_mp_env_tpu_torch as mt
from madrona_mp_env_tpu_torch.assets.map_data import load_map
from madrona_mp_env_tpu_torch.ops import cuda_build, raycast
from madrona_mp_env_tpu_torch.ops.culling import ray_cell_index
from madrona_mp_env_tpu_torch.ops.raycast import _f32, _ptr, _stream
from madrona_mp_env_tpu_torch.sim.env import resolve_device
from madrona_mp_env_tpu_torch.tools.kernel_bench import (
    device_line, sensor_zgroups, time_ms,
)

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
FANS = 12288  # 1024 worlds x 12 agents
TEAM_SIZE = 6


def probe_map(device, scene="simple_map"):
    """The map the fan probes sweep (simple_map: 256 rows, its sensor-ray
    tables K = 80)."""
    cfg = mt.EnvConfig(task=mt.Task.Zone, team_size=TEAM_SIZE)
    return load_map(os.path.join(REPO, "data", scene), cfg, device=device)


def make_fans(m, n: int, seed: int, device):
    """``n`` sensor fans on map ``m`` drawn with numpy from ``seed``,
    ordered by their sensor-ray table cell: origins [n, 3], per-group
    offsets zg [n, G] with their runs ``zgroups``, per-ray offsets zoff
    [n, F], direction planes dirs = (dx, dy, dz) [n, F] each, cells [n]."""
    g = np.random.default_rng(seed)
    zgroups = sensor_zgroups(TEAM_SIZE)
    F, G = sum(zgroups), len(zgroups)
    origins = g.uniform(-1500.0, 1500.0, (n, 3)).astype(np.float32)
    origins[:, 2] = 10.0
    zg = g.uniform(20.0, 60.0, (n, G)).astype(np.float32)
    d = g.normal(size=(n, F, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    cells = ray_cell_index(m.ray_cells, torch.as_tensor(origins)).numpy()
    order = np.argsort(cells, kind="stable")

    def dev(x, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(x[order]), dtype=dtype,
                               device=device)

    return {
        "zgroups": zgroups, "origins": dev(origins), "zg": dev(zg),
        "zoff": dev(np.repeat(zg, zgroups, axis=1)),
        "dirs": tuple(dev(d[..., k]) for k in range(3)),
        "cells": dev(cells, torch.int32),
    }


def fan_slice(x, s):
    """The fans ``s`` (a slice) of make_fans' dict."""
    return {k: (v if k == "zgroups" else tuple(c[s] for c in v)
                if isinstance(v, tuple) else v[s]) for k, v in x.items()}


def by_fans(fn, x, size=1024):
    """fn(fans) over slices of ``size`` fans of ``x``, concatenated: the
    plain versions at 12,288 fans, whose [fans, rays, rows] temporaries
    would not fit at once (each ray's t depends on its own fan alone)."""
    n = x["origins"].shape[0]
    return torch.cat([fn(fan_slice(x, slice(i, i + size)))
                      for i in range(0, n, size)])


def gather_tables(ray_tables, soup) -> torch.Tensor:
    """[C, K, 16]: the soup's row of each candidate of each cell, an
    all-zero row (valid = 0) for -1 padding."""
    cand = ray_tables.cand_idx.long()
    rows = soup.tri_rows[cand.clamp(min=0)]
    return torch.where((cand >= 0)[..., None], rows, torch.zeros_like(rows))


def _ray_fans_v9_gathered_plain(origins, zoff, dirs, cells, table):
    """The two-sided Moller-Trumbore sweep of each fan's rays over its
    cell's gathered rows table[cells[n]] -> t [N, F]."""
    rows = table[cells.long()]  # [N, K, 16]
    zero = torch.zeros_like(zoff)
    o = origins[:, None, :] + torch.stack([zero, zero, zoff], dim=-1)
    d = torch.stack(dirs, dim=-1)

    def col(c):
        return rows[:, None, :, c:c + 3]

    return raycast._ray_tri_t(
        o[:, :, None, :], d[:, :, None, :], col(raycast.ROW_V0),
        col(raycast.ROW_E1), col(raycast.ROW_E2),
        (rows[..., raycast.ROW_VALID] > 0.0)[:, None]).amin(dim=-1)


def ray_fans_v9_gathered(origins, zoff, dirs, cells, table):
    """K9 on tables gathered beforehand (``gather_tables``): the nearest
    hit of every ray of N fans over its cell's K rows, padding included
    as misses. CUDA: csrc/fan_v9.cu fan_v9_gathered."""
    if not raycast._route(origins):
        return _ray_fans_v9_gathered_plain(origins, zoff, dirs, cells, table)
    N, F = zoff.shape
    C, K = table.shape[:2]
    org, zo, tb = _f32(origins), _f32(zoff), _f32(table)
    dx, dy, dz = (_f32(c) for c in dirs)
    cl = cells.to(torch.int32).contiguous()
    out = torch.empty((N, F), device=origins.device, dtype=torch.float32)
    cuda_build.check(cuda_build.launcher("fan_v9_gathered")(
        _ptr(org), _ptr(zo), _ptr(dx), _ptr(dy), _ptr(dz), _ptr(tb),
        _ptr(cl), N, F, K, _ptr(out), _stream(origins),
    ), "fan_v9_gathered")
    ray_fans_v9_gathered.launches += 1
    return out


ray_fans_v9_gathered.launches = 0


def run(m, x, iters, device):
    """{row: ms} of the three rows on fans ``x`` (make_fans), each
    checked bit-equal to K9's plain version."""
    rt, soup = m.ray_cells, m.tris
    args = (x["origins"], x["zoff"], x["dirs"], x["cells"])
    want = by_fans(lambda f: raycast._ray_fans_v9_plain(
        f["origins"], f["zoff"], f["dirs"], f["cells"], rt, soup), x)
    table = gather_tables(rt, soup)
    rows = {
        "k9_indirect": lambda: raycast.ray_fans_culled_v9(*args, rt, soup),
        "gathered_with_gather": lambda: ray_fans_v9_gathered(
            *args, gather_tables(rt, soup)),
        "gathered": lambda: ray_fans_v9_gathered(*args, table),
    }
    res = {}
    for name, fn in rows.items():
        got = fn()
        if not torch.equal(got, want):
            raise AssertionError(f"P5 {name} differs from _ray_fans_v9_plain")
        res[name] = time_ms(fn, iters, device)
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fans", type=int, default=FANS)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    m = probe_map(device)
    x = make_fans(m, args.fans, args.seed, device)
    print(device_line(device))
    N, F = x["zoff"].shape
    print(f"fans={N} rays/fan={F} K={m.ray_cells.K} "
          f"cells={m.ray_cells.num_cells}", flush=True)
    res = run(m, x, args.iters, device)
    print(json.dumps({k: round(v, 4) for k, v in res.items()}), flush=True)
    return res


if __name__ == "__main__":
    main()
