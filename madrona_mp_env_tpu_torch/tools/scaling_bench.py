"""Device-count scaling benchmark (the JAX package's tools/scaling_bench.py):
env-step and train throughput as the world axis shards over 1, 2, 4, ...
ranks, weak scaling (``--worlds-per-device`` worlds a rank), one JSON
line per point:

    {"metric": "scaling", "devices": n, "num_worlds": W,
     "env_steps_per_sec": ..., "train_env_steps_per_sec": ...,
     "efficiency_vs_1dev": ..., "device": ..., "card": ...}

On the card (the default) the sweep goes up to the visible CUDA devices,
one process each (``--max-devices`` caps it), and every line carries the
card's name and power limit from nvidia-smi; ``--cpu`` runs the plain
versions on CPU ranks over gloo, up to ``--max-devices`` of them (one when
it is 0):

    python -m madrona_mp_env_tpu_torch.tools.scaling_bench --train
    python -m madrona_mp_env_tpu_torch.tools.scaling_bench --cpu \\
        --max-devices 2 --worlds-per-device 2 --team-size 2 --num-steps 4

Multi-host: one process per rank with ``--distributed``
(``--coordinator-address host:port``, ``--process-id``,
``--num-processes``), as the train CLI joins a group. Inside a process
group (such as a launched rank) ``main`` sweeps that group's ranks. Each
point's rate is the global worlds x steps over rank 0's wall time between
two barriers that every rank of the point passes.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def bench_point(n: int, mesh, device, args) -> dict:
    """One point of the sweep on this rank of an n-rank ``mesh``."""
    from ..config import EnvConfig, SimFlags, Task
    from ..parallel import barrier, global_init
    from ..sim.env import Env
    from ..train import PPOConfig, TrainConfig, TrainingManager

    W = mesh.num_worlds
    scene = args.scene or os.path.join(REPO, "data", "simple_map")
    cfg = EnvConfig(task=Task.Zone, team_size=args.team_size,
                    sim_flags=SimFlags.StaggerStarts | SimFlags.RandomFlipTeams)
    env = Env(cfg, scene, num_worlds=mesh.local_worlds, seed=5,
              device=device, world_offset=mesh.world_lo)
    out = {"metric": "scaling", "devices": n, "num_worlds": W}

    # sim-only throughput: zero actions, the default sim control
    state, _ = env.reset()
    acts = env.zero_actions()
    state, _ = env.step(state, acts)  # warm-up: kernels loaded
    _sync(env.device)
    barrier(mesh)
    t0 = time.perf_counter()
    for _ in range(args.num_steps):
        state, _ = env.step(state, acts)
    _sync(env.device)
    barrier(mesh)
    out["env_steps_per_sec"] = W * args.num_steps / (time.perf_counter() - t0)
    del state

    if args.train:
        tcfg = TrainConfig(
            num_worlds=W, steps_per_update=args.steps_per_update,
            num_bptt_chunks=4, num_train_policies=args.pbt,
            ppo=PPOConfig(num_epochs=2, num_minibatches=4),
            compute_dtype=torch.bfloat16 if args.bf16 else torch.float32,
            seed=5)
        mgr = TrainingManager(cfg, tcfg, env, device=env.device, mesh=mesh)
        ts = global_init(mgr)
        ts, metrics = mgr.update_iter(ts)  # warm-up
        _sync(env.device)
        barrier(mesh)
        t0 = time.perf_counter()
        for _ in range(args.num_updates):
            ts, metrics = mgr.update_iter(ts)
        _sync(env.device)
        barrier(mesh)
        if not bool(torch.isfinite(metrics["loss"]).all()):
            raise RuntimeError(f"non-finite loss at {n} devices")
        out["train_env_steps_per_sec"] = (
            W * args.steps_per_update * args.num_updates
            / (time.perf_counter() - t0))
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--worlds-per-device", type=int, default=512)
    ap.add_argument("--num-steps", type=int, default=50)
    ap.add_argument("--team-size", type=int, default=6)
    ap.add_argument("--scene", type=str, default=None)
    ap.add_argument("--train", action="store_true")
    ap.add_argument("--steps-per-update", type=int, default=40)
    ap.add_argument("--num-updates", type=int, default=3)
    ap.add_argument("--pbt", type=int, default=1)
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--max-devices", type=int, default=0,
                    help="cap the sweep (0 = all available)")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--distributed", action="store_true")
    ap.add_argument("--coordinator-address", type=str, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--num-processes", type=int, default=None)
    return ap.parse_args(argv)


def sweep(args) -> list:
    """Every point up to the ranks of the default process group (one
    process alone: one point). Returns rank 0's lines (printed as they
    come) and [] elsewhere."""
    import torch.distributed as dist

    from ..parallel import DataMesh, make_data_mesh

    size = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if args.max_devices:
        size = min(size, args.max_devices)
    if args.cpu:
        device = torch.device("cpu")
        where = {"device": {"platform": "cpu"}}
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass --cpu to run the plain "
                               "PyTorch path on the CPU")
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
        where = {"device": {"platform": "gpu",
                            "kind": torch.cuda.get_device_name(device)},
                 "card": card_line()}
    lines, base, n = [], None, 1
    while n <= size:
        W = args.worlds_per_device * n  # weak scaling
        if dist.is_initialized():
            # every rank takes part in making each group
            group = dist.new_group(list(range(n)))
            mesh = make_data_mesh(W, group) if rank < n else None
        else:
            mesh = DataMesh(W)
        if mesh is not None:
            out = bench_point(n, mesh, device, args)
            key = ("train_env_steps_per_sec" if args.train
                   else "env_steps_per_sec")
            base = out[key] if base is None else base
            out["efficiency_vs_1dev"] = out[key] / (base * n)
            out.update(where)
            if rank == 0:
                print(json.dumps(out), flush=True)
                lines.append(out)
        if dist.is_initialized():
            dist.barrier()
        n *= 2
    return lines


def main(argv=None) -> list:
    import torch.distributed as dist

    from ..parallel import distributed as pdist

    args = parse_args(argv)
    backend = "gloo" if args.cpu else "nccl"
    if dist.is_initialized():
        return sweep(args)
    if args.distributed:
        pdist.init_distributed(backend, f"tcp://{args.coordinator_address}",
                               args.num_processes, args.process_id)
        try:
            return sweep(args)
        finally:
            dist.destroy_process_group()
    if args.cpu:
        n = max(1, args.max_devices)
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass --cpu to run the plain "
                               "PyTorch path on the CPU")
        n = torch.cuda.device_count()
        if args.max_devices:
            n = min(n, args.max_devices)
    if n == 1:
        return sweep(args)
    if not args.cpu:
        from ..ops import cuda_build

        cuda_build.build_all()  # once, before the ranks load them
    threads = max(1, torch.get_num_threads() // n) if args.cpu else None
    pdist.launch(main, n, (argv,), backend, threads=threads)
    return []


if __name__ == "__main__":
    main()
