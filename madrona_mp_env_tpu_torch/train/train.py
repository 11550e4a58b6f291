"""Training CLI (the JAX package's train/train.py): builds the env and the
trainer from flags, runs updates in groups of ``--metrics-buffer-size``
with every update's metrics logged, and saves a checkpoint every
``--ckpt-frequency`` updates and at the end.

    python -m madrona_mp_env_tpu_torch.train.train --scene data/simple_map \
        --num-worlds 1024 --num-updates 1000 --steps-per-update 40

It runs on the first CUDA device; ``--cpu`` runs the plain PyTorch
versions on the CPU (tiny shapes only). ``MPENV_FAN_V9=1`` in the
environment sends the sensor fans through the sensor-ray tables (K9).
Flags of the JAX CLI that this port does not support yet raise: the
population update (``--pbt-update-frequency`` > 0), past policies,
``--num-devices``, ``--distributed``, ``--fp16`` / ``--bf16`` and the
profiler server.
"""

from __future__ import annotations

import argparse
import os
import time

from ..config import EnvConfig, SimFlags, Task
from ..sim.env import Env
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
    """Raise on a flag whose feature is not ported yet."""
    unsupported = {
        "--pbt-update-frequency > 0 (population update, eval ELO)":
            args.pbt_update_frequency > 0,
        "--pbt-past-policies > 0 (past-policy history)":
            args.pbt_past_policies > 0,
        "--num-devices (data mesh)": args.num_devices > 0,
        "--distributed (multi-host)": args.distributed,
        "--fp16 / --bf16 (mixed precision)": args.fp16 or args.bf16,
        "--profile-port": args.profile_port is not None,
    }
    bad = [name for name, on in unsupported.items() if on]
    if bad:
        raise NotImplementedError("not supported by the PyTorch port yet: "
                                  + ", ".join(bad))


def build(args):
    """(cfg, tcfg, env, mgr) from parsed flags."""
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

    pbt = lr_explore = None
    if args.pbt_ensemble_size > 1:
        pbt = PBTConfig(
            num_train_policies=args.pbt_ensemble_size,
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
        seed=args.seed,
    )
    device = "cpu" if args.cpu else None
    scene = args.scene or os.path.join(REPO, "data", "simple_map")
    env = Env(cfg, scene, num_worlds=args.num_worlds, seed=args.seed,
              device=device)
    return cfg, tcfg, env, TrainingManager(cfg, tcfg, env, device=device)


def main(argv=None):
    args = parse_args(argv)
    cfg, tcfg, env, mgr = build(args)
    writer = MetricsWriter(os.path.join(args.tb_dir, args.run_name))
    ckpt_dir = os.path.join(args.ckpt_dir, args.run_name)

    ts = mgr.init()
    if args.restore:
        ts = mgr.restore_ckpt(ts, os.path.join(ckpt_dir,
                                               f"{args.restore}.pt"))
    last_time, last_update = time.time(), ts.update_idx
    while ts.update_idx < args.num_updates:
        n = min(args.metrics_buffer_size, args.num_updates - ts.update_idx)
        ts, metrics = mgr.update_loop(ts, n)
        metrics = {k: v.cpu() for k, v in metrics.items()}  # waits
        update_id = ts.update_idx
        now = time.time()
        fps = (args.num_worlds * args.steps_per_update
               * (update_id - last_update) / (now - last_time))
        last_time, last_update = now, update_id
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
        if update_id % args.ckpt_frequency == 0:
            mgr.save_ckpt(ts, ckpt_dir)
    mgr.save_ckpt(ts, ckpt_dir)
    writer.close()
    return ts


if __name__ == "__main__":
    main()
