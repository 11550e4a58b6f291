"""Training CLI (the JAX package's train/train.py): builds the env and the
trainer from flags, runs updates in groups of ``--metrics-buffer-size``
with every update's metrics logged, and saves a checkpoint every
``--ckpt-frequency`` updates and at the end.

    python -m madrona_mp_env_tpu_torch.train.train --scene data/simple_map \
        --num-worlds 1024 --num-updates 1000 --steps-per-update 40 --bf16

It runs on the first CUDA device; ``--cpu`` runs the plain PyTorch
versions on the CPU (tiny shapes only). ``--game-mode`` takes every Task
(ZoneCaptureDefend adds HardcodedSpawns, as the JAX CLI does);
``--use-middle-spawns`` raises on the bundled maps, whose mid-map spawn
boxes overflow the spawn-usage tables, as the JAX package's spawn fails
there. ``MPENV_FAN_V9=1`` in the
environment sends the sensor fans through the sensor-ray tables (K9).
``--bf16`` / ``--fp16`` set the policy's compute dtype. The PBT
population: ``--pbt-ensemble-size`` train policies, ``--pbt-past-policies``
frozen ones and the play portions; every ``--pbt-update-frequency``
updates (checked after each group of updates) the deterministic eval ELO
(``--eval-elo-steps``) when there are two slots or more, then
store_past_policy, update_population and resample_matchmaking.

Data parallelism (parallel/): ``--num-devices N`` runs N local ranks, one
process each on its own CUDA device (raising when fewer are visible), the
worlds sharded over them; with ``--cpu`` N CPU ranks over gloo. N = 1
runs in this process. ``--distributed`` joins a multi-process group as
rank ``--process-id`` of ``--num-processes`` at ``--coordinator-address``
(host:port), on CUDA device process-id mod the visible devices. Rank 0
alone prints, writes metrics and writes checkpoints; every rank restores
(across hosts, ``--ckpt-dir`` must be a file system every host reads).
``--profile-port`` raises: the JAX CLI starts ``jax.profiler.start_server``
there, which has no PyTorch counterpart.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Optional

import torch

from ..config import EnvConfig, SimFlags, Task
from ..parallel import distributed as pdist
from ..parallel.sharding import DataMesh
from ..sim.env import Env
from .elo import print_elos
from .metrics import MetricsWriter
from .pbt import ParamExplore, PBTConfig
from .ppo import PPOConfig
from .trainer import TrainConfig, TrainingManager

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt-dir", type=str, default="ckpts")
    ap.add_argument("--tb-dir", type=str, default="tb")
    ap.add_argument("--run-name", type=str, default="run")
    ap.add_argument("--restore", type=int)
    ap.add_argument("--game-mode", type=str, default="Zone")
    ap.add_argument("--scene", type=str, default=None)
    ap.add_argument("--team-size", type=int, default=6)

    ap.add_argument("--randomize-hp-mag", action="store_true")
    ap.add_argument("--use-middle-spawns", action="store_true")

    ap.add_argument("--num-worlds", type=int, default=512)
    ap.add_argument("--num-updates", type=int, default=1000)
    ap.add_argument("--steps-per-update", type=int, default=40)
    ap.add_argument("--num-bptt-chunks", type=int, default=4)
    ap.add_argument("--num-minibatches", type=int, default=4)

    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--gamma", type=float, default=0.998)
    ap.add_argument("--entropy-loss-coef", type=float, default=0.3)
    ap.add_argument("--pbt-ensemble-size", type=int, default=1)

    ap.add_argument("--fp16", action="store_true")
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--metrics-buffer-size", type=int, default=5)
    ap.add_argument("--ckpt-frequency", type=int, default=500)
    ap.add_argument("--profile-port", type=int, default=None)

    ap.add_argument("--pbt-past-policies", type=int, default=0)
    ap.add_argument("--pbt-explore-lr", action="store_true")
    ap.add_argument("--pbt-update-frequency", type=int, default=0,
                    help="population update every N updates (0 = off)")
    ap.add_argument("--eval-elo-steps", type=int, default=1000)
    ap.add_argument("--self-play-portion", type=float, default=0.0)
    ap.add_argument("--cross-play-portion", type=float, default=1.0)
    ap.add_argument("--past-play-portion", type=float, default=0.0)

    ap.add_argument("--num-devices", type=int, default=0)
    ap.add_argument("--distributed", action="store_true")
    ap.add_argument("--coordinator-address", type=str, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--num-processes", type=int, default=None)
    return ap.parse_args(argv)


def check_supported(args) -> None:
    """Raise on a flag of the JAX CLI that the port cannot honour."""
    if args.profile_port is not None:
        raise NotImplementedError(
            "--profile-port is not supported by the PyTorch port: the JAX "
            "CLI starts jax.profiler.start_server, which has no PyTorch "
            "counterpart")


def build(args, mesh: Optional[DataMesh] = None, device=None):
    """(cfg, tcfg, env, mgr) from parsed flags; ``mesh``: this process's
    rank of a data mesh, on ``device`` (default: the first CUDA device, or
    the CPU with --cpu)."""
    check_supported(args)
    game_mode = getattr(Task, args.game_mode)
    sim_flags = SimFlags.Default
    if args.randomize_hp_mag:
        sim_flags |= SimFlags.RandomizeHPMagazine
    if args.use_middle_spawns:
        sim_flags |= SimFlags.SpawnInMiddle
    sim_flags |= SimFlags.StaggerStarts
    if game_mode == Task.ZoneCaptureDefend:
        sim_flags |= SimFlags.HardcodedSpawns
    sim_flags |= SimFlags.RandomFlipTeams
    cfg = EnvConfig(task=game_mode, sim_flags=sim_flags,
                    team_size=args.team_size)

    if args.fp16:
        dtype = torch.float16
    elif args.bf16:
        dtype = torch.bfloat16
    else:
        dtype = torch.float32

    pbt = lr_explore = None
    if args.pbt_ensemble_size > 1 or args.pbt_past_policies > 0:
        pbt = PBTConfig(
            num_train_policies=args.pbt_ensemble_size,
            num_past_policies=args.pbt_past_policies,
            self_play_portion=args.self_play_portion,
            cross_play_portion=args.cross_play_portion,
            past_play_portion=args.past_play_portion,
        )
        if args.pbt_explore_lr:
            # lr explored log-uniform x/÷10
            lr_explore = ParamExplore(base=args.lr, min_scale=0.1,
                                      max_scale=10.0, log10_scale=True)
    tcfg = TrainConfig(
        num_worlds=args.num_worlds,
        steps_per_update=args.steps_per_update,
        num_bptt_chunks=args.num_bptt_chunks,
        lr=args.lr,
        gamma=args.gamma,
        ppo=PPOConfig(
            num_minibatches=args.num_minibatches,
            entropy_coef_discrete=args.entropy_loss_coef,
            entropy_coef_aim=args.entropy_loss_coef,
        ),
        num_train_policies=args.pbt_ensemble_size,
        pbt=pbt,
        lr_explore=lr_explore,
        compute_dtype=dtype,
        seed=args.seed,
    )
    if device is None:
        device = "cpu" if args.cpu else None
    mesh = mesh or DataMesh(args.num_worlds)
    scene = args.scene or os.path.join(REPO, "data", "simple_map")
    env = Env(cfg, scene, num_worlds=mesh.local_worlds, seed=args.seed,
              device=device, world_offset=mesh.world_lo)
    return cfg, tcfg, env, TrainingManager(cfg, tcfg, env, device=device,
                                           mesh=mesh)


def main(argv=None):
    """Train; returns the final TrainState of this process (None where it
    only launched the ranks of --num-devices)."""
    import torch.distributed as dist

    args = parse_args(argv)
    check_supported(args)
    parallel = args.distributed or args.num_devices > 0
    if not parallel or dist.is_initialized():
        return run(args, parallel)
    backend = "gloo" if args.cpu else "nccl"
    n = args.num_devices
    if not args.distributed and not args.cpu and torch.cuda.device_count() < n:
        raise RuntimeError(f"--num-devices {n}: {torch.cuda.device_count()} "
                           "CUDA device(s) visible")
    if not args.distributed and n > 1:
        if not args.cpu:
            from ..ops import cuda_build

            cuda_build.build_all()  # once, before the ranks load them
        threads = max(1, torch.get_num_threads() // n) if args.cpu else None
        pdist.launch(main, n, (argv,), backend, threads=threads)
        return None
    with tempfile.TemporaryDirectory() as tmp:
        if args.distributed:
            pdist.init_distributed(backend,
                                   f"tcp://{args.coordinator_address}",
                                   args.num_processes, args.process_id)
        else:  # one rank, in this process
            pdist.init_distributed(backend, "file://" + os.path.join(
                tmp, "rendezvous"), 1, 0)
        try:
            return run(args, parallel)
        finally:
            dist.destroy_process_group()


def run(args, parallel: bool):
    """The training loop on this process: one rank of the default
    process group's data mesh (``parallel``), or alone."""
    mesh, device = None, None
    if parallel:
        mesh = pdist.global_mesh(args.num_worlds, args.num_devices or None)
        if not args.cpu:
            device = torch.device(
                "cuda", mesh.rank % torch.cuda.device_count())
            torch.cuda.set_device(device)
    cfg, tcfg, env, mgr = build(args, mesh, device)
    lead = mgr.mesh.rank == 0
    writer = MetricsWriter(os.path.join(args.tb_dir, args.run_name)) \
        if lead else None
    ckpt_dir = os.path.join(args.ckpt_dir, args.run_name)

    ts = pdist.global_init(mgr)
    if args.restore:
        ts = mgr.restore_ckpt(ts, os.path.join(ckpt_dir,
                                               f"{args.restore}.pt"))
    last_time, last_update = time.time(), ts.update_idx
    while ts.update_idx < args.num_updates:
        n = min(args.metrics_buffer_size, args.num_updates - ts.update_idx)
        ts, metrics = mgr.update_loop(ts, n)
        metrics = {k: v.cpu() for k, v in metrics.items()}  # waits
        if (args.pbt_update_frequency
                and ts.update_idx % args.pbt_update_frequency == 0):
            # deterministic eval matches -> ELO, then the best policy into
            # the past ring, truncation selection and re-paired teams
            if mgr.E + mgr.P > 1:
                ts, eval_elos = mgr.eval_elo(ts, args.eval_elo_steps)
                if lead:
                    print_elos(eval_elos.cpu())
            ts = mgr.store_past_policy(ts)
            ts = mgr.update_population(ts)
            ts = mgr.resample_matchmaking(ts)
        update_id = ts.update_idx
        now = time.time()
        fps = (args.num_worlds * args.steps_per_update
               * (update_id - last_update) / (now - last_time))
        last_time, last_update = now, update_id
        if update_id % args.ckpt_frequency == 0:
            mgr.save_ckpt(ts, ckpt_dir)
        if not lead:
            continue
        print(f"Update: {update_id}  FPS: {fps:.0f}", flush=True)
        for row in range(n):
            scalars = {}
            for k, v in metrics.items():
                vr = v[row]
                if vr.ndim == 0:
                    scalars[k] = float(vr)
                else:
                    for i, vi in enumerate(vr.reshape(-1).tolist()):
                        scalars[f"p{i}/{k}"] = vi
            if row == n - 1:
                scalars["fps"] = fps
            writer.scalars(scalars, update_id - n + 1 + row)
        writer.flush()
    mgr.save_ckpt(ts, ckpt_dir)
    if lead:
        writer.close()
    return ts


if __name__ == "__main__":
    main()
