"""Host microseconds per call of K5's entry, ``ops/tail_fused.py
tail_fused``, at W worlds of Zone 6v6 on simple_map (a zeroed state: the
host's work does not depend on the values), with the device idle before
each call: the time the step's host thread spends in the call, its
launch included.

    python madrona_mp_env_tpu_torch/tools/tail_host_time.py \
        [--root DIR] [--worlds 1024] [--calls 200]

``--root`` imports the package from another checkout (default: this
one's), so that two commits can be timed in one run; run the file by
its path for that, not with ``-m``. Prints the device line and one JSON
line {"root", "host_us", "calls", "worlds"}.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def host_us(fn, calls: int) -> float:
    """Median host microseconds of one call of ``fn`` (CUDA), each call
    after a synchronize that is not timed."""
    import torch

    fn()
    times = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return statistics.median(times) * 1e6


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--worlds", type=int, default=1024)
    ap.add_argument("--calls", type=int, default=200)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    import madrona_mp_env_tpu_torch as mt
    from madrona_mp_env_tpu_torch.assets.map_data import load_map
    from madrona_mp_env_tpu_torch.ops import tail_fused
    from madrona_mp_env_tpu_torch.sim.types import init_world_state

    if not torch.cuda.is_available():
        raise SystemExit("tail_host_time: no CUDA device")
    if not os.path.dirname(mt.__file__).startswith(root):
        raise SystemExit(f"tail_host_time: imported {mt.__file__}, not "
                         f"from {root} (run the file by its path)")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    cfg = mt.EnvConfig(task=mt.Task.Zone, team_size=6)
    m = load_map(os.path.join(root, "data", "simple_map"), cfg,
                 device="cuda")
    state = init_world_state(cfg, m.num_goal_regions, args.worlds,
                             device="cuda")
    fr = torch.zeros(args.worlds, dtype=torch.int32, device="cuda")
    us = host_us(lambda: tail_fused.tail_fused(cfg, m, state, fr),
                 args.calls)
    res = {"root": root, "host_us": round(us, 1), "calls": args.calls,
           "worlds": args.worlds}
    print(f"device {card}")
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
