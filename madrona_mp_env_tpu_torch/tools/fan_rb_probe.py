"""The redesigned kernels (csrc/fan_sweep_rb.cuh: the sensor fans K2, K6
and K7, the hitscan K1; csrc/sc_sweep.cuh: the culled sphere casts K4
culled and K4'; csrc/sphere_cast.cu sc_dense_kernel: the dense sphere
casts K4 dense) against their predecessors and against launches with one
of their arguments changed, on the arguments of real steps.

    python -m madrona_mp_env_tpu_torch.tools.fan_rb_probe \
        [--worlds 1024] [--steps 0,40] [--iters 10] \
        [--kernels k2,k6,k7,k1,k4,k4p,k4d] [--sass-ref DIR]

  full_span      K6 walks every cell's K slots, not up to its last
                 candidate (CellTables.valid_span)
  index_order    K6's cells in index order, not by decreasing candidate
                 count (CellTables.heavy_rank)
  fan_order      K6's fans in their own order (an identity order), not
                 grouped by cell
  threads T      K7 with T threads per block (raycast.FLAT_THREADS is
                 shipped)
  split S        K7's, K1's or K4 dense's rows over S blocks of a
                 cluster (raycast.flat_split's, ray_split's or sc_split's
                 choice is shipped)
  octet          K7 with 8 rays per thread, not a quad (FLAT_RAYS)
  rays k         K1 with k rays per thread, at the shipped split
  full_k         K4 culled / K4' walking every cell's K slots, not up to
                 its last candidate (ShortTables.valid_span)
  predecessor    the earlier kernel: P2's exact entry for K2
                 (csrc/fan_probe.cu), fan_culled_v1 for K6, fan_flat_v1
                 for K7, ray_tris_v1 for K1, sphere_cast_culled_v1 for K4
                 culled and K4', sphere_cast_v1 for K4 dense

The arguments are those the step hands each entry at each step of
--steps (Env.reset at --worlds worlds, then bench.py's run-and-shoot
actions): on Zone 6v6, K2 on simple_map, K2 over town_map's soup
(MPENV_FAN_CULL=0, the first step only), K6 on town_map and K1 on each
map, K4 culled (the L1 batch, 7 casts a group) and K4' (the L2 pair,
the L3 snap, the fall cast: one row per launch) on each map, K4 dense on
the same three launches of a step with MPENV_SC_PACK=0 on each map; on
Zone
3v3, K7 and K1 on each map. Every variant's output equals the shipped
kernel's bit for bit (t and winner row for K4). Times are CUDA events
(kernel_bench.time_ms), in turns: each variant once, then again in the
reverse order, the two averaged (K4, K4 dense: also each variant's device
time, torch.profiler). Also prints the shipped kernels' registers and spill
bytes (ptxas -v), and with --sass-ref, a build directory of another
checkout, whether the predecessors of K4 dense and K8, P3 (and its
warp_cast) and K3x compile to the same SASS there and here (cuobjdump
-sass).
Prints one JSON object; needs a CUDA device.
"""

from __future__ import annotations

import argparse
import difflib
import json
import os
import re
import shutil
import subprocess
from unittest import mock

import torch

import madrona_mp_env_tpu_torch as mt
from madrona_mp_env_tpu_torch.ops import cuda_build, raycast
from madrona_mp_env_tpu_torch.ops.raycast import _ptr, _stream
from madrona_mp_env_tpu_torch.sim import combat, movement, observations
from madrona_mp_env_tpu_torch.sim.env import resolve_device
from madrona_mp_env_tpu_torch.tools import fan_probe
from madrona_mp_env_tpu_torch.tools import kernel_bench
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


def capture_calls(env, state, actions, entry, module=observations):
    """The arguments of every call the step makes to ``entry`` (a kernel
    entry of ``module``: a sensor-fan entry of sim/observations.py unless
    given), in order, tensors cloned."""
    seen = []
    fn = getattr(module, entry)

    def rec(*args):
        seen.append(tuple(a.clone() if isinstance(a, torch.Tensor) else a
                          for a in args))
        return fn(*args)

    with mock.patch.object(module, entry, rec):
        env.step(state, actions)
    return seen


def capture_fans(env, state, actions, entry, module=observations):
    """The arguments of the step's one call to ``entry``."""
    (args,) = capture_calls(env, state, actions, entry, module)
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
K4D_SPLITS = tuple(range(1, raycast.SC_MAX_SPLIT + 1))


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


def k4_variants(args, iters, device):
    """K4 culled or one launch of K4' (args: o, d, r, cells, short, soup):
    CUDA-event times in turns, then each variant's device time."""
    o, d, r, cells, short, soup = args[:6]
    full = torch.full_like(short.valid_span, short.K)
    fns = {
        "shipped": lambda: raycast.sphere_cast_culled(o, d, r, cells, short,
                                                      soup),
        "full_k": lambda: raycast._sc_culled_launch(o, d, r, cells, short,
                                                    soup, span=full),
        "predecessor": lambda: raycast.sphere_cast_culled_v1(
            o, d, r, cells, short, soup),
    }
    outs = {n: f() for n, f in fns.items()}
    shape = f"[{o.shape[0]}, {o.shape[1]}]"
    _check_equal(f"K4 {shape} t", {n: t for n, (t, _) in outs.items()})
    _check_equal(f"K4 {shape} row", {n: i for n, (_, i) in outs.items()})
    res = in_turns(fns, iters, device)
    for n, f in fns.items():
        kern = ("sphere_cast_culled_v1_kernel" if n == "predecessor"
                else "sc_culled_kernel")
        res[f"{n} dev"] = round(kernel_bench.device_ms(f, kern, iters)[0], 4)
    count = (short.cand.reshape(-1, short.K) >= 0).sum(-1)
    res["shipped launch"] = shape
    res["mean_valid_candidates"] = round(
        float(count[cells.long()].float().mean()), 1)
    return res


def k4d_variants(args, iters, device):
    """One launch of K4 dense (args: o, d, r, soup): every split against
    the shipped one and the predecessor, CUDA-event times in turns, then
    each variant's device time."""
    o, d, r, soup = args[:4]
    R = o[..., 0].numel()
    split = raycast.sc_split(soup.num_tris, R, raycast._sm_count(o.device))
    fns = {"shipped": lambda: raycast.sphere_cast(o, d, r, soup)}
    for s in K4D_SPLITS:
        if s != split:
            fns[f"split {s}"] = (lambda s=s: raycast._sc_dense_launch(
                o, d, r, soup, split=s))
    fns["predecessor"] = lambda: raycast.sphere_cast_v1(o, d, r, soup)
    outs = {n: f() for n, f in fns.items()}
    shape = list(o.shape[:-1])
    _check_equal(f"K4 dense {shape} t", {n: t for n, (t, _) in outs.items()})
    _check_equal(f"K4 dense {shape} row",
                 {n: i for n, (_, i) in outs.items()})
    res = in_turns(fns, iters, device)
    for n, f in fns.items():
        kern = ("sphere_cast_dense_kernel" if n == "predecessor"
                else "sc_dense_kernel")
        res[f"{n} dev"] = round(kernel_bench.device_ms(f, kern, iters)[0], 4)
    res["shipped launch"] = f"split {split}, R {R}, T {soup.num_tris}"
    return res


# the kernels whose SASS a redesign of another kernel must leave as it
# was (--sass-ref): (source, part of the mangled name). K4 dense's and
# K8's predecessors (sphere_cast_dense_kernel, which the two entries ran
# until their redesign, sc_dense_kernel) keep the kernel's name and code
SASS_SAME = (("sphere_cast", "sphere_cast_dense_kernelILb0E"),
             ("sphere_cast", "sphere_cast_dense_kernelILb1E"),
             ("move_fused", "move_fused_kernel"),
             ("move_fused", "warp_cast"),
             ("fan_capsules", "fan_capsules_explicit"))


def sass(lib: str) -> dict:
    """{mangled function name: its instructions} of ``cuobjdump -sass`` on
    the shared library ``lib``, each instruction's text without its
    address and encoding: two builds compile a function to the same SASS
    when the lists are equal."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    funcs, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function\s*:\s*(\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;", line)
        if m and name is not None:
            funcs[name].append(m.group(1))
    return funcs


def sass_against(ref_dir):
    """{kernel: whether its SASS in ``ref_dir``'s library equals this
    build's}, over SASS_SAME."""
    out = {}
    for src, part in SASS_SAME:
        mine = sass(cuda_build.lib_path(src))
        ref = sass(os.path.join(ref_dir, f"lib{src}.so"))
        for name in sorted(n for n in mine if part in n):
            there = ref.get(name, [])
            if there == mine[name]:
                out[name] = f"same ({len(mine[name])} instructions)"
                continue
            diff = list(difflib.unified_diff(there, mine[name], lineterm="",
                                             n=1))
            out[name] = [f"differs ({len(there)} there, {len(mine[name])} "
                         f"here)"] + diff[:80]
    return out


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
    if "k4" in kernels:
        (args,) = capture_calls(env, state, actions, "sphere_cast_culled",
                                movement)
        row[f"k4 {tag}"] = k4_variants(args, iters, device)
    if "k4p" in kernels:
        for i, args in enumerate(capture_calls(
                env, state, actions, "sphere_cast_packed", movement)):
            row[f"k4p {tag} launch {i}"] = k4_variants(args, iters, device)
    if "k4d" in kernels:
        with mock.patch.dict(os.environ, MPENV_SC_PACK="0"):
            calls = capture_calls(env, state, actions, "sphere_cast",
                                  movement)
        for i, args in enumerate(calls):
            row[f"k4d {tag} launch {i}"] = k4d_variants(args, iters, device)
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
    ap.add_argument("--kernels", default="k2,k6,k7,k1,k4,k4p,k4d",
                    help="which kernels' variants to run")
    ap.add_argument("--sass-ref", default=None,
                    help="a build directory (lib<name>.so) to compare the "
                         "SASS of SASS_SAME's kernels with")
    args = ap.parse_args(argv)
    device = resolve_device(None)
    steps = sorted(int(s) for s in args.steps.split(","))
    kernels = set(args.kernels.split(","))
    cuda_build.build_all(["fan_tris", "fan_culled", "fan_probe", "fan_flat",
                          "ray_tris", "sphere_cast", "move_fused",
                          "fan_capsules"])
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
    usage = res["registers, spill bytes"]
    for kern in ("sc_culled_kernel", "sphere_cast_culled_v1_kernel",
                 "sc_dense_kernelILb0E", "sc_dense_kernelILb1E",
                 "move_fused_kernel"):
        src = "move_fused" if kern.startswith("move") else "sphere_cast"
        usage[kern] = cuda_build.ptxas_usage(src, kern)
    if args.sass_ref:
        res["sass against " + args.sass_ref] = sass_against(args.sass_ref)
    flags = mt.SimFlags.StaggerStarts | mt.SimFlags.RandomFlipTeams
    for scene in ("simple_map", "town_map"):
        for ts in (6, 3):
            if not kernels & ({"k7", "k1"} if ts == 3 else
                              {"k2", "k6", "k1", "k4", "k4p", "k4d"}):
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
