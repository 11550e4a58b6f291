"""Raycast-kernel microbenchmarks of the port, apart from the env step.

    python -m madrona_mp_env_tpu_torch.tools.kernel_bench [--worlds 1024] \
        [--team-size 6] [--scene simple_map|town_map|<map dir>] \
        [--iters 20] [--device cuda|cpu]

The port of the JAX package's tools/kernel_bench.py, with its four
phases at the sim's shapes (W worlds, A = 2 ts agents, N = W A fans):

* the sensor fan: N fans of F = 4 ts + 64 + 16 rays (LOS, then the
  lidar rows) in the stacked layout, z offsets per ray and uniform within
  each run, over the whole soup -> ``ray_fans_vs_tris_flat`` (K7);
  Grays/s and Gpairs/s;
* 7 sphere casts per agent (the L1 batch's shape), with and without the
  contact normal -> ``sphere_cast_grouped`` (K8); Gcasts/s, Gpairs/s;
* the same rays against the agent capsules with explicit origins ->
  ``fan_capsules_explicit`` (K3x); Grays/s;
* ``Env.step`` with zero actions at the same world count; env-steps/s.

Inputs come from numpy with a fixed seed (``make_inputs``). The JAX tool
hands its fan per-group offsets [N, G] where its stacked dispatch reads
per-ray offsets [N, F] (on the TPU the static index past G is clamped,
so runs 1-4 take the last group's offset; on the CPU the shapes do not
broadcast); this one passes per-ray offsets.

``--device`` is the card unless ``cpu`` is given, which runs the plain
PyTorch versions. Times are CUDA events around ``--iters`` calls after
three warm-up calls on the card, the host clock after one on the CPU. The first
line names the device (on the card, ``nvidia-smi``'s name and power
limit).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import time

import numpy as np
import torch

import madrona_mp_env_tpu_torch as mt
from madrona_mp_env_tpu_torch import consts
from madrona_mp_env_tpu_torch.assets.map_data import load_map
from madrona_mp_env_tpu_torch.ops import raycast, raycast_cull
from madrona_mp_env_tpu_torch.sim.env import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CASTS_PER_AGENT = 7


def sensor_zgroups(team_size: int):
    """The sensor fan's runs: 4 LOS rays per opponent, then each lidar
    row."""
    return ((4 * team_size,)
            + (consts.fwd_lidar_width,) * consts.fwd_lidar_height
            + (consts.rear_lidar_width,) * consts.rear_lidar_height)


def make_inputs(worlds: int, team_size: int, device, seed: int = 0):
    """The bench's operands on ``device``, drawn with numpy: fan origins
    uniform in [-1500, 1500]^2 at z = 10, one offset in [20, 60] per run,
    unit directions; the casts start at the fan origins."""
    g = np.random.default_rng(seed)
    W, A = worlds, 2 * team_size
    N = W * A
    zgroups = sensor_zgroups(team_size)
    F = sum(zgroups)

    def unit(shape):
        d = g.normal(size=shape + (3,))
        return d / np.linalg.norm(d, axis=-1, keepdims=True)

    origins = g.uniform(-1500.0, 1500.0, (N, 3))
    origins[:, 2] = 10.0
    zg = g.uniform(20.0, 60.0, (N, len(zgroups)))
    zoff = np.repeat(zg, zgroups, axis=1)
    dirs = unit((N, F))
    d_sc = unit((N, CASTS_PER_AGENT))

    def dev(x, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                               device=device)

    o_w = origins.reshape(W, A, 3)
    o_caps = o_w[:, :, None, :] + np.zeros((W, A, F, 3))
    return {
        "zgroups": zgroups,
        "origins": dev(origins), "zoff": dev(zoff), "dirs": dev(dirs),
        "o_sc": dev(np.broadcast_to(origins[:, None, :],
                                    (N, CASTS_PER_AGENT, 3))),
        "d_sc": dev(d_sc),
        "o_caps": dev(o_caps), "d_caps": dev(dirs.reshape(W, A, F, 3)),
        "self_idx": dev(np.broadcast_to(np.arange(A)[None, :, None],
                                        (W, A, F)), torch.int32),
        "cap_pos": dev(o_w), "alive": dev(np.ones((W, A)), torch.bool),
    }


def device_line(device) -> str:
    if device.type != "cuda":
        return "device cpu (plain PyTorch versions)"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return f"device {out.stdout.strip().splitlines()[0]}"


def time_ms(fn, iters: int, device) -> float:
    """Mean ms per call of ``fn`` after warm-up calls (three on the card,
    where the first builds the kernel; one on the CPU)."""
    for _ in range(3 if device.type == "cuda" else 1):
        fn()
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def profiled(fn, reps: int, kernel: str, tries: int = 3):
    """torch.profiler's CUDA events over ``reps`` calls of ``fn`` after one
    outside the window, or None. A window that holds no event of the
    kernel whose name holds ``kernel`` (the profiler has come back
    without a short kernel's events) is profiled again, up to ``tries``
    times. A window may also hold fewer or more of its events than
    launches (a long cluster kernel's dropped, the warm-up call's kept):
    callers average over the events they find."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(tries):
        fn()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        if any(kernel in e.name and e.device_time_total > 0
               for e in events):
            return events
    return None


def device_ms(fn, kernel: str, reps: int = 10, tries: int = 3):
    """(ms per call, how): the device time of the CUDA kernel of ``fn``
    whose name holds ``kernel`` (``fn`` launches it once per call),
    without the host's gaps between back-to-back launches. how =
    "profiler": the mean of torch.profiler's times of its launches
    (``profiled``); "events", when no window held its events: CUDA events
    around each call alone, one call in flight at a time (the whole call,
    its launch latency included)."""
    events = profiled(fn, reps, kernel, tries)
    if events is not None:
        mine = [e.device_time_total for e in events if kernel in e.name]
        return sum(mine) / 1e3 / len(mine), "profiler"
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    total = 0.0
    for _ in range(reps):
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps, "events"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--worlds", type=int, default=1024)
    ap.add_argument("--team-size", type=int, default=6)
    ap.add_argument("--scene", default="simple_map")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    scene = args.scene if os.sep in args.scene else os.path.join(
        REPO, "data", args.scene)
    ts = args.team_size
    cfg = mt.EnvConfig(
        task=mt.Task.Zone, team_size=ts,
        sim_flags=mt.SimFlags.StaggerStarts | mt.SimFlags.RandomFlipTeams,
    )
    m = load_map(scene, cfg, device=device)
    soup = m.tris
    T = soup.num_tris
    W, A = args.worlds, 2 * ts
    x = make_inputs(W, ts, device)
    N, F = x["zoff"].shape
    it = args.iters
    print(device_line(device))
    print(f"scene={os.path.basename(os.path.normpath(scene))} "
          f"padded_tris={T} worlds={W} team_size={ts} fans={N} rays/fan={F}",
          flush=True)
    res = {}

    # --- sensor fan (K7) ---
    dt = time_ms(lambda: raycast.ray_fans_vs_tris_flat(
        x["origins"], x["zoff"], x["dirs"], soup), it, device)
    rays = N * F
    res["fan_ms"] = dt
    print(f"fan_kernel: {dt:.3f} ms for {rays / 1e6:.2f} Mrays -> "
          f"{rays / dt / 1e6:.3f} Grays/s ({rays * T / dt / 1e6:.1f} "
          f"Gpairs/s)", flush=True)

    # --- grouped movement sphere casts (K8), the L1 shape ---
    casts = N * CASTS_PER_AGENT
    for with_normal, label in ((True, "normals"), (False, "no-normal")):
        dt = time_ms(lambda: raycast.sphere_cast_grouped(
            x["o_sc"], x["d_sc"], consts.agent_radius, soup,
            with_normal=with_normal), it, device)
        res[f"sc_{label}_ms"] = dt
        print(f"sc_kernel({label}): {dt:.3f} ms for {casts / 1e6:.2f} Mcasts"
              f" -> {casts / dt / 1e6:.3f} Gcasts/s "
              f"({casts * T / dt / 1e6:.1f} Gpairs/s)", flush=True)

    # --- explicit-origin capsule fan (K3x) ---
    dt = time_ms(lambda: raycast_cull.fan_capsules_explicit(
        x["o_caps"], x["d_caps"], x["self_idx"], x["cap_pos"], x["alive"]),
        it, device)
    res["caps_ms"] = dt
    print(f"fan_capsules: {dt:.3f} ms for {rays / 1e6:.2f} Mrays -> "
          f"{rays / dt / 1e6:.3f} Grays/s", flush=True)

    # --- full env step ---
    env = mt.Env(cfg, scene, num_worlds=W, seed=5, device=device)
    state, _ = env.reset()
    acts = env.zero_actions()

    def step():
        nonlocal state
        state, _ = env.step(state, acts)

    dt = time_ms(step, max(it, 10), device)
    res["step_ms"] = dt
    print(f"env.step: {dt:.3f} ms -> {W / dt * 1e3:,.0f} env-steps/s",
          flush=True)
    return res


if __name__ == "__main__":
    main()
