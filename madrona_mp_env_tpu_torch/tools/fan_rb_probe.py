"""The register-blocked kernels (csrc/fan_sweep_rb.cuh: the sensor fans
K2, K6 and K7, the hitscan K1) against their predecessors and against
launches with one of their arguments changed, on the arguments of real
steps.

    python -m madrona_mp_env_tpu_torch.tools.fan_rb_probe \
        [--worlds 1024] [--steps 0,40] [--iters 10] [--kernels k2,k6,k7,k1]

  full_span      K6 walks every cell's K slots, not up to its last
                 candidate (CellTables.valid_span)
  index_order    K6's cells in index order, not by decreasing candidate
                 count (CellTables.heavy_rank)
  fan_order      K6's fans in their own order (an identity order), not
                 grouped by cell
  threads T      K7 with T threads per block (raycast.FLAT_THREADS is
                 shipped)
  split S        K7's or K1's rows over S blocks of a cluster
                 (raycast.flat_split's or ray_split's choice is shipped)
  octet          K7 with 8 rays per thread, not a quad (FLAT_RAYS)
  rays k         K1 with k rays per thread, at the shipped split
  predecessor    the earlier kernel: P2's exact entry for K2
                 (csrc/fan_probe.cu), fan_culled_v1 for K6, fan_flat_v1
                 for K7, ray_tris_v1 for K1

The arguments are those the step hands each entry at each step of
--steps (Env.reset at --worlds worlds, then bench.py's run-and-shoot
actions): on Zone 6v6, K2 on simple_map, K2 over town_map's soup
(MPENV_FAN_CULL=0, the first step only), K6 on town_map and K1 on each
map; on Zone 3v3, K7 and K1 on each map. Every variant's output equals
the shipped kernel's bit for bit. Times are CUDA events
(kernel_bench.time_ms), in turns: each variant once, then again in the
reverse order, the two averaged. Also prints the shipped kernels'
registers and spill bytes (ptxas -v). Prints one JSON object; needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
from unittest import mock

import torch

import madrona_mp_env_tpu_torch as mt
from madrona_mp_env_tpu_torch.ops import cuda_build, raycast
from madrona_mp_env_tpu_torch.ops.raycast import _ptr, _stream
from madrona_mp_env_tpu_torch.sim import combat, observations
from madrona_mp_env_tpu_torch.sim.env import resolve_device
from madrona_mp_env_tpu_torch.tools import fan_probe
from madrona_mp_env_tpu_torch.tools.kernel_bench import device_line, time_ms
from madrona_mp_env_tpu_torch.tools.probes.movement_fused_probe import (
    bench_actions,
)

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def k6_launch(org, zg, dirs, zgroups, cells, tables, soup, span=None,
              rank=None, grouped=True):
    """ray_fans_culled's CUDA launch with the table's span and rank unless
    given, the fans in an identity order unless ``grouped``."""
    (N, F, G, gor, o, z, dx, dy, dz, rows, cl,
     cand) = raycast._fan_culled_args(org, zg, dirs, zgroups, cells, tables,
                                      soup)
    span = tables.valid_span if span is None else span
    rank = tables.heavy_rank if rank is None else rank
    order = (raycast.fan_cell_order(cl, cand.shape[0], rank) if grouped
             else torch.arange(N, dtype=torch.int32, device=o.device))
    out = torch.empty((N, F), device=org.device)
    cuda_build.check(cuda_build.launcher("fan_culled")(
        _ptr(o), _ptr(z), _ptr(dx), _ptr(dy), _ptr(dz), _ptr(gor),
        _ptr(rows), _ptr(cl), _ptr(cand), _ptr(span), _ptr(order), N, F, G,
        tables.K, _ptr(out), _stream(o)), "fan_culled variant")
    return out


def capture_fans(env, state, actions, entry, module=observations):
    """The arguments the step hands ``entry`` (a kernel entry of ``module``:
    a sensor-fan entry of sim/observations.py unless given), tensors
    cloned."""
    seen = []
    fn = getattr(module, entry)

    def rec(*args):
        seen.append(tuple(a.clone() if isinstance(a, torch.Tensor) else a
                          for a in args))
        return fn(*args)

    with mock.patch.object(module, entry, rec):
        env.step(state, actions)
    (args,) = seen
    return args


def in_turns(fns: dict, iters: int, device) -> dict:
    """{name: ms} by CUDA events: each function once in order, then once
    in the reverse order, the two means averaged."""
    names = list(fns)
    ms = {n: 0.0 for n in names}
    for n in names + names[::-1]:
        ms[n] += time_ms(fns[n], iters, device) / 2
    return {n: round(v, 4) for n, v in ms.items()}


def _check_equal(label, outs):
    want = outs["shipped"]
    torch.cuda.synchronize()
    bad = [n for n, t in outs.items() if not torch.equal(t, want)]
    if bad:
        raise AssertionError(f"{label}: {bad} differ from the shipped "
                             "kernel")


def k2_variants(args, iters, device):
    org, zg, dirs, zgroups, soup = args[:5]
    fns = {
        "shipped": lambda: raycast.ray_fans_vs_tris(org, zg, dirs, zgroups,
                                                    soup),
        "predecessor": lambda: fan_probe.ENTRIES["exact"](org, zg, dirs,
                                                          zgroups, soup),
    }
    _check_equal("K2", {n: f() for n, f in fns.items()})
    return in_turns(fns, iters, device)


def k6_variants(args, iters, device):
    org, zg, dirs, zgroups, cells, tables, soup = args[:7]
    C = tables.cand_idx.shape[0]
    full = torch.full_like(tables.valid_span, tables.K)
    index = torch.arange(C, dtype=torch.int32, device=device)
    fns = {
        "shipped": lambda: raycast.ray_fans_culled(
            org, zg, dirs, zgroups, cells, tables, soup),
        "full_span": lambda: k6_launch(org, zg, dirs, zgroups, cells,
                                       tables, soup, span=full),
        "index_order": lambda: k6_launch(org, zg, dirs, zgroups, cells,
                                         tables, soup, rank=index),
        "fan_order": lambda: k6_launch(org, zg, dirs, zgroups, cells,
                                       tables, soup, grouped=False),
        "predecessor": lambda: raycast.ray_fans_culled_v1(
            org, zg, dirs, zgroups, cells, tables, soup),
    }
    _check_equal("K6", {n: f() for n, f in fns.items()})
    res = in_turns(fns, iters, device)
    count = (tables.cand_idx >= 0).sum(-1)
    cl = cells.long()
    res["mean_valid_candidates"] = round(float(count[cl].float().mean()), 1)
    res["occupied_cells"] = int((torch.bincount(cl, minlength=C) > 0).sum())
    return res


K7_THREADS = (64, 128, 256)
K7_SPLITS = (1, 2, 4, 8)
K1_SPLITS = (1, 2, 4, 8)
K1_RAYS = (1, 2, 4)


def k7_variants(args, iters, device):
    org, zoff, dirs, soup = args[:4]
    split = raycast.flat_split(soup.num_tris)

    def launch(rays=raycast.FLAT_RAYS, threads=raycast.FLAT_THREADS,
               split=split):
        return lambda: raycast._fan_flat_launch(
            org, zoff, dirs, soup, rays=rays, threads=threads, split=split)

    fns = {"shipped": lambda: raycast.ray_fans_vs_tris_flat(org, zoff, dirs,
                                                            soup)}
    for t in K7_THREADS:
        if t != raycast.FLAT_THREADS:
            fns[f"threads {t}"] = launch(threads=t)
    for s in K7_SPLITS:
        if s != split:
            fns[f"split {s}"] = launch(split=s)
    fns["octet"] = launch(rays=8)
    fns["predecessor"] = lambda: raycast.ray_fans_vs_tris_flat_v1(
        org, zoff, dirs, soup)
    _check_equal("K7", {n: f() for n, f in fns.items()})
    res = in_turns(fns, iters, device)
    res["shipped launch"] = (f"{raycast.FLAT_RAYS} rays x "
                             f"{raycast.FLAT_THREADS} threads, split {split}")
    return res


def k1_variants(args, iters, device):
    o, d, soup = args[:3]
    R = o[..., 0].numel()
    split = raycast.ray_split(soup.num_tris, R, raycast._sm_count(o.device))
    fns = {"shipped": lambda: raycast.ray_vs_tris(o, d, soup)}
    for s in K1_SPLITS:
        if s != split:
            fns[f"split {s}"] = (lambda s=s: raycast._ray_tris_launch(
                o, d, soup, split=s))
    for k in K1_RAYS:
        if k != raycast.RAY_RAYS:
            fns[f"rays {k}"] = (lambda k=k: raycast._ray_tris_launch(
                o, d, soup, split=split, rays=k))
    fns["predecessor"] = lambda: raycast.ray_vs_tris_v1(o, d, soup)
    _check_equal("K1", {n: f() for n, f in fns.items()})
    res = in_turns(fns, iters, device)
    res["shipped launch"] = (f"split {split}, {raycast.RAY_RAYS} rays, "
                             f"R {R}, T {soup.num_tris}")
    return res


def sweep_step(row, env, state, actions, scene, ts, first, kernels, iters,
               device):
    """This step's variants of each kernel in ``kernels`` that a Zone
    ``ts``v``ts`` step on ``scene`` launches, into ``row``."""
    tag = scene if ts == 6 else f"{scene} Zone 3v3"
    if "k1" in kernels:
        row[f"k1 {tag}"] = k1_variants(capture_fans(
            env, state, actions, "ray_vs_tris", combat), iters, device)
    if ts == 3:
        if "k7" in kernels:
            row[f"k7 {tag}"] = k7_variants(capture_fans(
                env, state, actions, "ray_fans_vs_tris_flat"),
                max(1, iters // 3) if scene == "town_map" else iters,
                device)
        return
    if scene == "simple_map":
        if "k2" in kernels:
            row["k2 simple_map"] = k2_variants(capture_fans(
                env, state, actions, "ray_fans_vs_tris"), iters, device)
        return
    if first and "k2" in kernels:
        with mock.patch.dict(os.environ, MPENV_FAN_CULL="0"):
            fans = capture_fans(env, state, actions, "ray_fans_vs_tris")
        row["k2 town_map"] = k2_variants(fans, max(1, iters // 3), device)
    if "k6" in kernels:
        row["k6 town_map"] = k6_variants(capture_fans(
            env, state, actions, "ray_fans_culled"), iters, device)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--worlds", type=int, default=1024)
    ap.add_argument("--steps", default="0,40",
                    help="steps after Env.reset whose fans are swept")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--kernels", default="k2,k6,k7,k1",
                    help="which kernels' variants to run")
    args = ap.parse_args(argv)
    device = resolve_device(None)
    steps = sorted(int(s) for s in args.steps.split(","))
    kernels = set(args.kernels.split(","))
    cuda_build.build_all(["fan_tris", "fan_culled", "fan_probe", "fan_flat",
                          "ray_tris"])
    res = {"device": device_line(device), "worlds": args.worlds,
           "registers, spill bytes": {
               kern: cuda_build.ptxas_usage(src, kern) for src, kern in (
                   ("fan_tris", "fan_tris_rb_kernel"),
                   ("fan_culled", "fan_culled_rb_kernel"),
                   ("fan_flat", "fan_flat_rb_kernelILi4E"),
                   ("fan_flat", "fan_flat_rb_kernelILi8E"),
                   ("ray_tris", "ray_tris_rb_kernelILi1E"),
                   ("ray_tris", "ray_tris_rb_kernelILi2E"),
                   ("ray_tris", "ray_tris_rb_kernelILi4E"))}}
    flags = mt.SimFlags.StaggerStarts | mt.SimFlags.RandomFlipTeams
    for scene in ("simple_map", "town_map"):
        for ts in (6, 3):
            if not kernels & ({"k7", "k1"} if ts == 3 else
                              {"k2", "k6", "k1"}):
                continue
            cfg = mt.EnvConfig(task=mt.Task.Zone, team_size=ts,
                               sim_flags=flags)
            env = mt.Env(cfg, os.path.join(REPO, "data", scene),
                         num_worlds=args.worlds, seed=5, device=device)
            acts = bench_actions(args.worlds, cfg.num_agents, steps[-1] + 1)

            def at(s):
                return env.zero_actions().replace(**{
                    k: torch.as_tensor(v[s], dtype=torch.int32,
                                       device=device)
                    for k, v in acts.items()})

            state, _ = env.reset()
            for s in range(steps[-1] + 1):
                if s in steps:
                    row = res.setdefault(f"step {s}", {})
                    sweep_step(row, env, state, at(s), scene, ts,
                               s == steps[0], kernels, args.iters, device)
                state, _ = env.step(state, at(s))
            del env, state
            torch.cuda.empty_cache()
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
