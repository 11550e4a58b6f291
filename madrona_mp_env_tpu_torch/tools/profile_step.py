"""Where one env step's time goes on the GPU (torch.profiler).

    python -m madrona_mp_env_tpu_torch.tools.profile_step \
        [--num-worlds 1024] [--scene simple_map|town_map|<map dir>]

Runs the Zone 6v6 step on a map (data/simple_map unless --scene names
another; a bare name is a directory under data/) with bench.py's
run-and-shoot action mix, then times --steps steps without and then with the profiler, and prints one
JSON line: wall ms per step (host clock around synchronized steps, both
ways), device-busy ms per step (sum of CUDA kernel times in the profiled
window), the idle share of that window, CUDA kernel launches per step,
and the kernels with the most device time. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

import madrona_mp_env_tpu_torch as mt

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--num-worlds", type=int, default=1024)
    ap.add_argument("--scene", default="simple_map")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=5)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_step needs a CUDA device")

    cfg = mt.EnvConfig(
        task=mt.Task.Zone, team_size=6,
        sim_flags=mt.SimFlags.StaggerStarts | mt.SimFlags.RandomFlipTeams,
    )
    W = args.num_worlds
    scene = args.scene if os.sep in args.scene else os.path.join(
        REPO, "data", args.scene)
    env = mt.Env(cfg, scene, num_worlds=W, seed=5)
    g = np.random.default_rng(0)
    shape = (W, cfg.num_agents)
    a = env.zero_actions().replace(**{
        k: torch.as_tensor(g.integers(0, hi, shape), dtype=torch.int32,
                           device=env.device)
        for k, hi in (("move_amount", 3), ("move_angle", 8), ("fire", 2),
                      ("aim_yaw", 13), ("aim_pitch", 7))
    })
    state, _ = env.reset()
    for _ in range(args.warmup):
        state, _ = env.step(state, a)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        state, _ = env.step(state, a)
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            state, _ = env.step(state, a)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.device_time_total for e in kernels)
    by_name = {}
    for e in kernels:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.device_time_total)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[: args.top]
    S = args.steps
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "scene": os.path.basename(os.path.normpath(scene)),
        "num_worlds": W,
        "steps": S,
        "wall_ms_per_step": plain_wall * 1e3 / S,
        "wall_ms_per_step_profiled": wall * 1e3 / S,
        "device_busy_ms_per_step": busy_us / 1e3 / S,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall,
        "kernel_launches_per_step": len(kernels) / S,
        "env_steps_per_s": W * S / plain_wall,
        "top_kernels": [
            {"name": n[:80], "launches_per_step": c / S,
             "ms_per_step": t / 1e3 / S}
            for n, (c, t) in top
        ],
    }))


if __name__ == "__main__":
    main()
