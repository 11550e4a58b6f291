"""One rank of tests/test_torch_parallel.py's 2-rank gloo group on the CPU.

``run_rank(out_dir)`` runs every scenario of the test on this rank and
writes what the test checks to ``<out_dir>/rank<r>.pt``:

- ``train``: zone_train.npz's configuration (make_train_fixture.py, 2
  worlds, 1 a rank): the env state after global_init, the rollout (each
  step's actions and Gumbel margins in world layout, the outputs on the
  rank's rows), the env state and normalizer after it, then one PPO
  update (the params' change on make_train_fixture's sample, its loss
  terms);
- ``pbt``: zone_pbt.npz's configuration (make_pbt_fixture.py, 8 worlds, 4 a
  rank): the initial tables and env state, update_iter from it
  (``update``), resample_matchmaking then update_iter (``rotupd``), and
  eval_elo (``eval``), each step's actions, margins and match results in
  world layout;
- ``cli``: the train CLI with --num-devices 2 inside the group (two
  updates, a checkpoint after each, then a restore to a third);
- ``bench``: tools/scaling_bench.py's sweep over the group (rank 0's
  lines).

It imports no JAX: the test compares the results with the JAX fixtures
and a one-process run.
"""

from __future__ import annotations

import os
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
SCENE = os.path.join(REPO, "data", "simple_map")
for p in (REPO, HERE):
    if p not in sys.path:
        sys.path.insert(0, p)

import make_pbt_fixture as pfx  # noqa: E402
import make_train_fixture as tfx  # noqa: E402
from policy_weights import random_flax_params  # noqa: E402

PBT_LR = dict(base=1e-4, min_scale=0.1, max_scale=10.0, log10_scale=True)
BENCH_ARGS = ["--cpu", "--worlds-per-device", "2", "--team-size", "2",
              "--num-steps", "2"]


def train_setup(mesh=None, device="cpu"):
    """(mgr, ts0) at zone_train.npz's configuration, its weights."""
    import madrona_mp_env_tpu_torch as mt
    from madrona_mp_env_tpu_torch.parallel import DataMesh, global_init
    from madrona_mp_env_tpu_torch.train import (PPOConfig, TrainConfig,
                                                TrainingManager,
                                                params_from_jax)

    mesh = mesh or DataMesh(tfx.NUM_WORLDS)
    cfg = mt.EnvConfig(
        task=mt.Task.Zone, team_size=tfx.TEAM_SIZE,
        sim_flags=mt.SimFlags.StaggerStarts | mt.SimFlags.RandomFlipTeams)
    tcfg = TrainConfig(
        num_worlds=tfx.NUM_WORLDS, steps_per_update=tfx.STEPS,
        num_bptt_chunks=tfx.CHUNKS,
        ppo=PPOConfig(num_epochs=tfx.EPOCHS,
                      num_minibatches=tfx.MINIBATCHES),
        seed=tfx.TRAIN_SEED)
    env = mt.Env(cfg, SCENE, num_worlds=mesh.local_worlds,
                 seed=tfx.ENV_SEED, device=device,
                 world_offset=mesh.world_lo)
    mgr = TrainingManager(cfg, tcfg, env, device=device, mesh=mesh)
    return mgr, global_init(mgr, params=params_from_jax(
        random_flax_params(tfx.WEIGHT_SEED, 1)))


def pbt_setup(mesh=None, device="cpu"):
    """(mgr, ts0) at zone_pbt.npz's configuration, its weights."""
    import madrona_mp_env_tpu_torch as mt
    from madrona_mp_env_tpu_torch.parallel import DataMesh, global_init
    from madrona_mp_env_tpu_torch.train import (PPOConfig, TrainConfig,
                                                TrainingManager,
                                                params_from_jax)
    from madrona_mp_env_tpu_torch.train import pbt as tpbt

    mesh = mesh or DataMesh(pfx.NUM_WORLDS)
    cfg = mt.EnvConfig(task=mt.Task.Zone, team_size=pfx.TEAM_SIZE,
                       episode_len=pfx.EPISODE_LEN)
    tcfg = TrainConfig(
        num_worlds=pfx.NUM_WORLDS, steps_per_update=pfx.STEPS,
        num_bptt_chunks=pfx.CHUNKS, num_train_policies=pfx.E,
        pbt=tpbt.PBTConfig(
            num_train_policies=pfx.E, num_past_policies=pfx.P,
            self_play_portion=pfx.PORTIONS[0],
            cross_play_portion=pfx.PORTIONS[1],
            past_play_portion=pfx.PORTIONS[2]),
        lr_explore=tpbt.ParamExplore(**PBT_LR),
        ppo=PPOConfig(num_epochs=pfx.EPOCHS,
                      num_minibatches=pfx.MINIBATCHES),
        seed=pfx.SEED)
    env = mt.Env(cfg, SCENE, num_worlds=mesh.local_worlds, seed=pfx.SEED,
                 device=device, world_offset=mesh.world_lo)
    mgr = TrainingManager(cfg, tcfg, env, device=device, mesh=mesh)
    return mgr, global_init(mgr, params=params_from_jax(
        random_flax_params(pfx.WEIGHT_SEED, pfx.E)))


def leaves(state):
    return {k: v.clone() for k, v in state.leaves().items()}


class Recorder:
    """Each env step's actions [W, A, 6] (this rank's worlds) and match
    results, and each policy apply's distributions and blocks."""

    def __init__(self, mgr):
        self.mgr = mgr
        self.steps, self.dists = [], []
        step, apply = mgr.env.step, mgr.apply_blocks

        def rec_step(state, a, *args):
            state, out = step(state, a, *args)
            res = out["episode_result"]
            self.steps.append((torch.stack(
                [a.move_amount, a.move_angle, a.fire, a.stand, a.aim_yaw,
                 a.aim_pitch], -1), res["win_result"],
                res["match_finished"]))
            return state, out

        def rec_apply(*args):
            out = apply(*args)
            self.dists.append(out[0])
            return out

        mgr.env.step, mgr.apply_blocks = rec_step, rec_apply

    def take(self, ts, n, sampled):
        """(actions [n, W, A, 6], win [n, W], finished [n, W], margins [n,
        W, A]) of the last n steps, run from ts; margins of the sampled
        actions (the Gumbel top-two gap over the heads) or of the best."""
        from madrona_mp_env_tpu_torch.utils import rng

        mgr = self.mgr
        tb, pb = mgr.blocks(ts)
        per = 2 if mgr.has_past else 1
        keys = rng.split(rng.split(ts.key, 2)[1], n) if sampled else None
        margins = []
        for t in range(n):
            k = rng.split(keys[t], 2) if sampled else (None, None)
            tm = margin(self.dists[per * t], k[0], tb)
            pm = margin(self.dists[per * t + 1], k[1], pb) if per == 2 \
                else None
            margins.append(mgr.from_blocks(tm, pm, tb, pb))
        steps = self.steps[-n:]
        self.steps, self.dists = [], []
        return {"actions": torch.stack([s[0] for s in steps]),
                "win_result": torch.stack([s[1] for s in steps]),
                "match_finished": torch.stack([s[2] for s in steps]),
                "margins": torch.stack(margins)}


def margin(d, key, blocks):
    """The smallest top-two gap over the heads of the distributions ``d``:
    of their log probs plus their Gumbel noise from ``key`` (the rows of
    ``blocks``' share of the global draw), or with key None of the
    logits."""
    from madrona_mp_env_tpu_torch.train.distributions import gumbel
    from madrona_mp_env_tpu_torch.utils import rng

    gaps = []
    keys = rng.split(key, 2) if key is not None else (None, None)
    for k, g in zip(keys, (d.discrete, d.aim)):
        if k is None:
            z = g.logits
        else:
            S = g.logits.shape[-1]
            rows = blocks.rows if blocks.ragged else None
            noise = gumbel(k, g.logits.shape) if rows is None else gumbel(
                k, None, rows[:, None] * S + torch.arange(S))
            z = g.packed_log_probs() + noise
        o = 0
        for b in g.buckets:
            two = torch.topk(z[..., o:o + b], 2, dim=-1).values
            gaps.append(two[..., 0] - two[..., 1])
            o += b
    return torch.stack(gaps).amin(0)


def deltas(ts0, ts1):
    """Each train policy's params change on make_train_fixture's sample."""
    out = {}
    for e, (p0, p1) in enumerate(zip(ts0.params, ts1.params)):
        for k, v in p0.items():
            i = torch.as_tensor(tfx.sample_index(k, v.numel()))
            out[f"{e}/{k}"] = (p1[k] - v).reshape(-1)[i]
    return out


def run_train(mesh):
    mgr, ts0 = train_setup(mesh)
    rec = Recorder(mgr)
    out = {"init_env": leaves(ts0.env_state), "key0": ts0.key}
    ts1, rnn_starts, outs, boot = mgr.rollout(ts0)
    out["rollout"] = rec.take(ts0, tfx.STEPS, sampled=True)
    tb, _ = mgr.blocks(ts0)
    out.update(rows=tb.rows, outs=outs, rnn_starts=rnn_starts,
               bootstrap=boot, key1=ts1.key, env=leaves(ts1.env_state),
               normalizer=(ts1.normalizer.mu, ts1.normalizer.var))
    ts2, metrics = mgr.ppo_update(ts1, rnn_starts, outs, boot)
    out.update(delta=deltas(ts0, ts2), metrics=metrics,
               count=ts2.opt_state[0].count)
    return out


def run_pbt(mesh):
    mgr, ts0 = pbt_setup(mesh)
    rec = Recorder(mgr)
    out = {"init": {k: getattr(ts0, k) for k in (
        "assignment", "train_perm", "past_perm", "key", "elo")},
        "init_lr": ts0.hyper_params["lr"], "init_env": leaves(ts0.env_state)}
    for name, start in (("update", ts0),
                        ("rotupd", mgr.resample_matchmaking(ts0))):
        ts1, m = mgr.update_iter(start)
        out[name] = rec.take(start, pfx.STEPS, sampled=True)
        out[name].update(
            delta=deltas(start, ts1), metrics=m, key=ts1.key,
            lr=start.hyper_params["lr"], env=leaves(ts1.env_state),
            normalizer=(ts1.normalizer.mu, ts1.normalizer.var),
            assignment=start.assignment,
            past_same=all(torch.equal(a[k], b[k]) for a, b in zip(
                start.past_params, ts1.past_params) for k in a),
            params=[{k: v[:64].clone() for k, v in p.items()}
                    for p in ts1.params])
    ts, elo = mgr.eval_elo(ts0, num_steps=pfx.EVAL_STEPS)
    out["eval"] = rec.take(ts0, pfx.EVAL_STEPS, sampled=False)
    out["eval"].update(elo=elo, finished=mgr.eval_matches,
                       pending=ts.pending_reset)
    return out


def run_cli(tmp):
    """The train CLI inside the group: two updates, then a restore."""
    from madrona_mp_env_tpu_torch.train import train as train_cli

    argv = cli_args(tmp) + ["--num-devices", "2"]
    ts2 = train_cli.main(argv + ["--num-updates", "2"])
    ts3 = train_cli.main(argv + ["--num-updates", "3", "--restore", "2"])
    return {"update_idx": (ts2.update_idx, ts3.update_idx),
            "params": ts2.params[0], "local_worlds": ts2.env_state.pos.shape[0],
            "count": int(ts3.opt_state[0].count),
            "norm_count": int(ts3.normalizer.count)}


def cli_args(tmp):
    """The train CLI at 4 worlds of Zone 2v2, 2 steps an update in one
    BPTT chunk and one minibatch, a checkpoint after every update, under
    ``tmp``."""
    return ["--cpu", "--scene", SCENE, "--num-worlds", "4", "--team-size",
            "2", "--steps-per-update", "2", "--num-bptt-chunks", "1",
            "--num-minibatches", "1", "--metrics-buffer-size", "1",
            "--ckpt-frequency", "1", "--ckpt-dir", os.path.join(tmp, "ck"),
            "--tb-dir", os.path.join(tmp, "tb"), "--run-name", "r"]


def run_rank(out_dir):
    import torch.distributed as dist

    from madrona_mp_env_tpu_torch.parallel import global_mesh
    from madrona_mp_env_tpu_torch.tools import scaling_bench

    sys.modules["torch.utils.tensorboard"] = None  # its import takes ~13 s
    rank = dist.get_rank()
    res = {"train": run_train(global_mesh(tfx.NUM_WORLDS)),
           "pbt": run_pbt(global_mesh(pfx.NUM_WORLDS)),
           "cli": run_cli(out_dir),
           "bench": scaling_bench.main(BENCH_ARGS)}
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))


def reference():
    """The one-process runs the test holds the ranks to: the initial
    states, each rollout's actions and margins, the env states and
    normalizers after it."""
    mgr, ts0 = train_setup()
    rec = Recorder(mgr)
    ts1, *_ = mgr.rollout(ts0)
    res = {"train": {"init_ts": ts0, "rollout": rec.take(
        ts0, tfx.STEPS, sampled=True), "env": leaves(ts1.env_state),
        "normalizer": (ts1.normalizer.mu, ts1.normalizer.var)}}
    mgr, ts0 = pbt_setup()
    rec = Recorder(mgr)
    res["pbt"] = {"init_ts": ts0}
    for name, start in (("update", ts0),
                        ("rotupd", mgr.resample_matchmaking(ts0))):
        ts1, _ = mgr.update_iter(start)
        res["pbt"][name] = rec.take(start, pfx.STEPS, sampled=True)
        res["pbt"][name].update(
            env=leaves(ts1.env_state),
            normalizer=(ts1.normalizer.mu, ts1.normalizer.var))
    return res
