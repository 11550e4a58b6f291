"""The evaluation rollout: the forward-only eval of the JAX package's
train/infer.py (EvalManager and its CLI).

Crossplay: P policies share the worlds by the trainer's static block
routing ((world w, team t) -> policy (2w + t) % P, pbt.make_matchmaking's
cross-play); every step normalizes the observations, runs each policy on
its block, samples (or takes the best) actions, steps the env, folds
finished matches into the crossplay ELO and clears the recurrent state of
agents whose episode ended. ``vs_bot=True``: world w fields policy w % P
on both teams, team 1 is then handed to the scripted A* bot (policy idx
-1), the ELO is left alone and each policy's wins, draws and losses
against the bot are counted (``vs_bot_wdl``): the win rate against the
bot is the reference's de-facto end-to-end learning metric.

    env = Env(cfg, scene, num_worlds=1024)                # on the GPU
    mgr = EvalManager(cfg, EvalConfig(num_worlds=1024), env, num_policies=2)
    elo = mgr.run(policies, normalizer, elo)

    python -m madrona_mp_env_tpu_torch.train.infer --num-worlds 1024 \
        --ckpt-path policy.npz --vs-bot        # export_policy.py's layout

Everything runs on the env's device (the first CUDA device unless
``device="cpu"`` or ``--cpu``). The step keys follow the JAX stream:
PRNGKey(seed), split once per chunk, the chunk's half split into one key
per step. ``EvalConfig.policy_dtype`` (``--bf16`` / ``--fp16``) is the
policies' compute dtype: each ActorCriticNet must be built with it
(build_actor_critic / load_policy_npz ``dtype``). ``--game-mode`` takes
every Task (ZoneCaptureDefend with its hardcoded spawns, as the JAX CLI).

Dumps, as the JAX package's run writes them: ``record_path`` the step
logs (data/recorder.py RecordLogWriter) and ``event_log_dir`` the packed
snapshots and game events (EventLogWriter), both of an
Env(collect_log=True) (the CLI's ``--record`` / ``--event-log`` build
one); ``bc_dump_dir`` the behaviour-cloning data: one raw file per
normalized observation key, ``actions``, ``action_logits``, ``rewards``
and ``rnn_states`` (the recurrent state the step's forward started
from), each appended per step in policy-block order, and the ``shapes``
JSON. Each chunk crosses to the host once per output group.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from .. import consts
from ..config import EnvConfig, SimFlags, Task
from ..data.recorder import EventLogWriter, RecordLogWriter, host_arrays
from ..sim.env import Env, resolve_device
from ..sim.types import Actions
from ..utils import rng
from .convert import load_policy_npz
from .distributions import (AIM_BUCKETS, DISCRETE_BUCKETS, ActorDistributions,
                            DiscreteActionDistributions)
from .elo import elo_update_masked, print_elos
from .normalizer import EMANormalizerState, normalize_obs
from .policy import (ActorCriticNet, clear_rnn_states, get_episode_scores,
                     init_rnn_states)
from .pbt import PBTConfig, make_matchmaking
from .trainer import EVAL_SIM_CTRL, POLICY_OBS_KEYS, slot_permutations

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# vs_bot_wdl's columns [wins, draws, losses] by win_result (0: team 0 won,
# 1: team 1, 2: a draw)
WDL_COLUMNS = ((0, 0), (2, 1), (1, 2))


@dataclass(frozen=True)
class EvalConfig:
    """The fields of the JAX package's EvalConfig that its rollout reads;
    ``policy_dtype`` is a torch dtype."""

    num_worlds: int
    num_eval_steps: int = 200
    policy_dtype: torch.dtype = torch.float32
    use_deterministic_policy: bool = False
    seed: int = 10
    chunk_steps: int = 10  # host flush granularity


def chunk_keys(seed: int, num_chunks: int, chunk_steps: int, device=None):
    """The per-step keys of the rollout, [num_chunks, chunk_steps, 2]."""
    key = rng.prng_key(seed, device=device)
    out = []
    for _ in range(num_chunks):
        ks = rng.split(key, 2)
        key = ks[0]
        out.append(rng.split(ks[1], chunk_steps))
    return torch.stack(out)


def tally_vs_bot(wdl: np.ndarray, win, finished, world_policy) -> None:
    """Add the matches that ended into ``wdl`` [P, 3] (wins, draws,
    losses of the policy that fields team 0): win and finished [T, W],
    world_policy [W]."""
    win, finished = np.asarray(win), np.asarray(finished)
    done = finished & (win >= 0)
    for outcome, col in WDL_COLUMNS:
        m = done & (win == outcome)
        np.add.at(wdl[:, col], world_policy[m.nonzero()[1]], 1)


def block_assignment(num_worlds: int, num_agents: int, team_size: int,
                     num_policies: int, vs_bot: bool = False):
    """The eval's routing: (the policy of each actor [W, A] int32, the flat
    actor index of each block slot [B], B = W * A): policy p's block is
    perm[p * B / P:(p + 1) * B / P]. Crossplay takes the trainer's static
    block routing; with ``vs_bot`` world w fields policy w % P on every
    agent, each policy whole teams against the bot."""
    W, A, P = num_worlds, num_agents, num_policies
    if vs_bot:
        if W % P:
            raise ValueError("num_worlds must divide by the policies")
        assign = np.repeat((np.arange(W) % P)[:, None], A,
                           axis=1).astype(np.int32)
        return assign, np.argsort(assign.reshape(-1), kind="stable")
    assign, _ = make_matchmaking(W, A, team_size,
                                 PBTConfig(num_train_policies=P))
    return assign, slot_permutations(assign, P, 0)[0].reshape(-1)


class EvalManager:
    """Forward-only rollout over a P-policy ensemble, with crossplay
    matchmaking (the trainer's static block routing) or, with
    ``vs_bot``, every policy against the scripted bot."""

    def __init__(self, cfg: EnvConfig, ecfg: EvalConfig, env: Env,
                 num_policies: int, vs_bot: bool = False, device=None):
        self.device = resolve_device(device)
        if env.device != self.device:
            raise ValueError(f"env is on {env.device}, the eval on "
                             f"{self.device}")
        if env.num_worlds != ecfg.num_worlds:
            raise ValueError("env and EvalConfig disagree on num_worlds")
        self.cfg = cfg
        self.ecfg = ecfg
        self.env = env
        self.P = num_policies
        self.vs_bot = vs_bot
        self.W = ecfg.num_worlds
        self.A = cfg.num_agents
        self.B = self.W * self.A
        self.BP = self.B // self.P

        assign, perm = block_assignment(self.W, self.A, cfg.team_size,
                                        self.P, vs_bot)
        dev = self.device
        self.assignment = torch.as_tensor(assign, device=dev)
        self.perm = torch.as_tensor(perm, device=dev)
        self.inv_perm = torch.as_tensor(np.argsort(perm), device=dev)
        # [W, 2]: the policy of each team's first agent; Explore's one
        # agent fields both columns (the JAX package's gather clamps the
        # second to the last agent), a match of a policy with itself
        first = torch.clamp(torch.arange(2, device=dev) * cfg.team_size,
                            max=self.A - 1)
        self.team_policies = self.assignment[:, first]
        self._no_reset = torch.zeros(self.W, dtype=torch.int32, device=dev)

    def to_blocks(self, x):
        """[W, A, ...] -> [P, B / P, ...] in policy order."""
        flat = x.reshape((self.B,) + x.shape[2:])
        return flat[self.perm].reshape((self.P, self.BP) + x.shape[2:])

    def from_blocks(self, x):
        """[P, B / P, ...] -> [W, A, ...]."""
        flat = x.reshape((self.B,) + x.shape[2:])
        return flat[self.inv_perm].reshape((self.W, self.A) + x.shape[2:])

    def init_state(self):
        env_state, obs = self.env.reset(sim_ctrl=EVAL_SIM_CTRL)
        policy_idx = self.assignment.clone()
        if self.vs_bot:  # team 1: agents team_size .. 2 team_size - 1
            ts = self.cfg.team_size
            policy_idx[:, ts:2 * ts] = consts.a_star_policy_id
        env_state = env_state.replace(policy_idx=policy_idx)
        rnn = init_rnn_states((self.P, self.BP), device=self.device)
        return env_state, obs, rnn

    def _policy_obs(self, obs):
        out = {k: obs[k] for k in POLICY_OBS_KEYS}
        # flat lidar planes, as the trainer's rollout buffers store them:
        # the normalizer stats are keyed to the flat [h * w * c] axis
        for k in ("fwd_lidar", "rear_lidar"):
            v = out[k]
            out[k] = v.reshape(v.shape[:-3] + (-1,))
        return out

    def normalized(self, normalizer: EMANormalizerState, obs):
        """The policies' inputs: the observations in blocks [P, B / P,
        ...], normalized, in the policy dtype."""
        blocks = {k: self.to_blocks(v)
                  for k, v in self._policy_obs(obs).items()}
        return normalize_obs(normalizer, blocks, self.ecfg.policy_dtype)

    def forward(self, policies: Sequence[ActorCriticNet],
                normalizer: EMANormalizerState, obs, rnn, norm_obs=None):
        """Normalize (unless ``norm_obs`` is given), then each policy on
        its block: (dists with [P, B / P, S] logits, values [P, B / P],
        new rnn [2, 2, P, B / P, H])."""
        if norm_obs is None:
            norm_obs = self.normalized(normalizer, obs)
        outs = [net(rnn[:, :, p], {k: v[p] for k, v in norm_obs.items()})
                for p, net in enumerate(policies)]
        dists = ActorDistributions(
            discrete=DiscreteActionDistributions(
                torch.stack([o[0].discrete.logits for o in outs]),
                DISCRETE_BUCKETS),
            aim=DiscreteActionDistributions(
                torch.stack([o[0].aim.logits for o in outs]), AIM_BUCKETS),
        )
        values = torch.stack([o[1] for o in outs])
        return dists, values, torch.stack([o[2] for o in outs], dim=2)

    def step(self, policies, normalizer, env_state, obs, rnn, elo,
             step_key, bc: bool = False):
        """One eval step: (env_state, obs, rnn, elo, step outputs). The
        outputs carry the env's step log, snapshot and game events when
        it logs, and with ``bc`` the normalized observations and the
        recurrent state the forward started from."""
        norm_obs = self.normalized(normalizer, obs)
        dists, values, rnn2 = self.forward(policies, normalizer, obs, rnn,
                                           norm_obs)
        if self.ecfg.use_deterministic_policy:
            actions = dists.best()
        else:
            actions, _ = dists.sample(step_key)
        da = self.from_blocks(actions["discrete"])
        aa = self.from_blocks(actions["aim"])
        zf = torch.zeros((self.W, self.A), dtype=torch.float32,
                         device=self.device)
        env_actions = Actions(
            move_amount=da[..., 0], move_angle=da[..., 1], fire=da[..., 2],
            stand=da[..., 3], aim_yaw=aa[..., 0], aim_pitch=aa[..., 1],
            aim_yaw_rate=zf, aim_pitch_rate=zf,
        )
        env_state, out = self.env.step(env_state, env_actions,
                                       EVAL_SIM_CTRL, self._no_reset)

        res = out["episode_result"]
        win = res["win_result"]
        if not self.vs_bot:
            # crossplay: team 1 is another ensemble policy
            elo = elo_update_masked(elo, self.team_policies,
                                    get_episode_scores(win)[0],
                                    res["match_finished"] & (win >= 0))

        done_b = self.to_blocks(out["done"])
        rnn2 = clear_rnn_states(rnn2, done_b != 0)
        logits = torch.cat([dists.discrete.packed_log_probs(),
                            dists.aim.packed_log_probs()], dim=-1)
        step_out = {
            "actions": actions, "values": values,
            "rewards": self.to_blocks(out["reward"]), "dones": done_b,
            "logits": logits, "episode_result": res,
        }
        for k in ("step_log", "snapshot", "game_events"):
            if k in out:
                step_out[k] = out[k]
        if bc:
            step_out["obs"] = norm_obs
            step_out["rnn_states_pre"] = rnn
        return env_state, out["obs"], rnn2, elo, step_out

    def rollout_chunk(self, policies, normalizer, env_state, obs, rnn, elo,
                      keys, bc: bool = False):
        """len(keys) steps; the outputs stacked on a leading step axis."""
        outs = []
        for t in range(keys.shape[0]):
            env_state, obs, rnn, elo, o = self.step(
                policies, normalizer, env_state, obs, rnn, elo, keys[t], bc)
            outs.append(o)
        return (env_state, obs, rnn, elo), _stack(outs)

    @torch.no_grad()
    def run(self, policies: Sequence[ActorCriticNet],
            normalizer: EMANormalizerState, elo: torch.Tensor,
            record_path: Optional[str] = None,
            event_log_dir: Optional[str] = None,
            bc_dump_dir: Optional[str] = None,
            iter_cb: Optional[Callable[[Dict], None]] = None,
            verbose: bool = True) -> torch.Tensor:
        """The eval rollout; returns the final per-policy ELO [P] (with
        ``vs_bot`` the given one, and the counts in ``self.vs_bot_wdl``).
        ``iter_cb`` gets each chunk's stacked outputs (tensors on the
        eval's device). ``record_path``, ``event_log_dir`` and
        ``bc_dump_dir`` write the dumps (the module's docstring); the
        writers' host seconds, bytes and steps are kept in
        ``self.dump_stats``."""
        if (record_path or event_log_dir) and not self.env.collect_log:
            raise ValueError("record_path and event_log_dir need an "
                             "Env(collect_log=True)")
        if len(policies) != self.P:
            raise ValueError(f"{len(policies)} policies for P = {self.P}")
        ecfg = self.ecfg
        if any(p.dtype != ecfg.policy_dtype for p in policies):
            raise ValueError(f"the policies must compute in "
                             f"{ecfg.policy_dtype}")
        env_state, obs, rnn = self.init_state()
        elo = elo.to(self.device, torch.float32)
        num_chunks = -(-ecfg.num_eval_steps // ecfg.chunk_steps)
        keys = chunk_keys(ecfg.seed, num_chunks, ecfg.chunk_steps,
                          device=self.device)
        total_swaps = np.zeros((consts.max_zones,), np.int64)
        wdl = np.zeros((self.P, 3), np.int64)
        world_policy = self.assignment[:, 0].cpu().numpy()
        recorder = RecordLogWriter(record_path) if record_path else None
        events = EventLogWriter(event_log_dir) if event_log_dir else None
        bc = BCDumpWriter(bc_dump_dir) if bc_dump_dir else None
        writers = {"record": recorder, "event_log": events, "bc": bc}
        for ci in range(num_chunks):
            (env_state, obs, rnn, elo), outs = self.rollout_chunk(
                policies, normalizer, env_state, obs, rnn, elo, keys[ci],
                bc=bc is not None)
            if recorder is not None:
                recorder.append_chunk(outs["step_log"])
            if events is not None:
                events.append_chunk(outs["snapshot"], outs["game_events"])
            if bc is not None:
                bc.append_chunk(outs)
            # zone-swap accounting at episode ends
            res = outs["episode_result"]
            swaps = torch.where(res["match_finished"][..., None, None],
                                res["zone_stats"], 0)[..., 0].sum((0, 1))
            total_swaps += swaps.cpu().numpy()
            if verbose and swaps.sum() > 0:
                print("zone swaps:", total_swaps)
            if self.vs_bot:
                tally_vs_bot(wdl, res["win_result"].cpu(),
                             res["match_finished"].cpu(), world_policy)
            if iter_cb is not None:
                iter_cb(outs)
        self.dump_stats = {}
        for name, w in writers.items():
            if w is not None:
                w.close()
                self.dump_stats[name] = {"seconds": w.seconds,
                                         "bytes": w.bytes_written,
                                         "steps": w.steps}
                if verbose:
                    n = max(w.steps, 1)
                    print(f"{name} dump: {w.seconds * 1e3 / n:.3f} host ms "
                          f"and {w.bytes_written / n:.0f} bytes per step")
        if self.vs_bot:
            self.vs_bot_wdl = wdl
            if verbose:
                for p in range(self.P):
                    w, d, l = wdl[p]
                    n = max(w + d + l, 1)
                    print(f"policy {p} vs bot: {w}W/{d}D/{l}L win-rate "
                          f"{w / n:.1%} over {w + d + l} matches")
        return elo


class BCDumpWriter:
    """The behaviour-cloning dump (dump_for_bc_cb, jax_infer.py:175-191;
    the JAX package's EvalManager._dump_bc): one raw file per observation
    key of the policies' normalized inputs, ``actions`` (discrete then aim
    heads, int32), ``action_logits``, ``rewards`` and ``rnn_states``, each
    step appended in policy-block order, and the ``shapes`` JSON that
    filter_bc_train reads (filter_bc_train.py:92-96) with one step's
    shape of each. A chunk's outputs ([T, ...]) cross to the host in one
    copy; bfloat16 is written as its raw bits."""

    def __init__(self, dump_dir: str):
        os.makedirs(dump_dir, exist_ok=True)
        self.dir = dump_dir
        self.files = {}
        self.seconds = 0.0
        self.bytes_written = 0
        self.steps = 0

    def append_chunk(self, outs) -> None:
        t0 = time.perf_counter()
        acts = torch.cat([outs["actions"]["discrete"],
                          outs["actions"]["aim"]], dim=-1).to(torch.int32)
        group = {**{k: outs["obs"][k] for k in sorted(outs["obs"])},
                 "actions": acts, "action_logits": outs["logits"],
                 "rewards": outs["rewards"],
                 "rnn_states": outs["rnn_states_pre"]}
        host = host_arrays(group)
        if not self.files:
            meta = {"obs": {k: list(host[k].shape[1:])
                            for k in sorted(outs["obs"])}}
            meta.update({k: list(host[k].shape[1:]) for k in
                         ("actions", "action_logits", "rewards",
                          "rnn_states")})
            with open(os.path.join(self.dir, "shapes"), "w") as f:
                json.dump(meta, f)
            self.files = {k: open(os.path.join(self.dir, k), "wb")
                          for k in host}
        for k, v in host.items():
            v.tofile(self.files[k])
            self.bytes_written += v.nbytes
        self.steps += acts.shape[0]
        self.seconds += time.perf_counter() - t0

    def close(self) -> None:
        for f in self.files.values():
            f.close()


def _stack(steps):
    """List of (nested dicts of) tensors -> the same with a leading axis."""
    first = steps[0]
    if isinstance(first, dict):
        return {k: _stack([s[k] for s in steps]) for k in first}
    return torch.stack(steps)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Evaluate exported policies "
                                 "(crossplay ELO or win rate vs the bot)")
    ap.add_argument("--num-worlds", type=int, required=True)
    ap.add_argument("--num-steps", type=int, default=200)
    ap.add_argument("--single-policy", type=int, default=None)
    ap.add_argument("--crossplay", action="store_true")
    ap.add_argument("--vs-bot", action="store_true",
                    help="team 1 = scripted A* bot; report per-policy "
                         "win-rate (the de-facto e2e learning metric)")
    ap.add_argument("--game-mode", type=str, default="Zone")
    ap.add_argument("--scene", type=str, default=None)
    ap.add_argument("--ckpt-path", type=str, required=True,
                    help="an .npz of tests/fixtures_torch/export_policy.py")
    ap.add_argument("--record", type=str, default=None)
    ap.add_argument("--event-log", type=str, default=None)
    ap.add_argument("--bc-dump-dir", type=str, default=None)
    ap.add_argument("--team-size", type=int, default=6)
    ap.add_argument("--fp16", action="store_true")
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain PyTorch path on the CPU")
    return ap.parse_args(argv)


def main(argv=None):
    """The JAX package's eval CLI: load the policies, run the eval, print
    the ELO before and after (and the win rates vs the bot). Returns
    (the EvalManager, the final ELO)."""
    args = parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)
    dtype = (torch.float16 if args.fp16 else
             torch.bfloat16 if args.bf16 else torch.float32)
    policies, normalizer, elo = load_policy_npz(args.ckpt_path, device,
                                                dtype)
    if args.single_policy is not None:
        i = args.single_policy
        policies, elo = policies[i:i + 1], elo[i:i + 1]
    print(len(policies))

    game_mode = getattr(Task, args.game_mode)
    sim_flags = SimFlags.SimEvalMode
    if game_mode == Task.ZoneCaptureDefend:
        sim_flags |= SimFlags.HardcodedSpawns
    cfg = EnvConfig(task=game_mode, sim_flags=sim_flags,
                    team_size=args.team_size)
    scene = args.scene or os.path.join(REPO, "data", "simple_map")
    collect = args.record is not None or args.event_log is not None
    env = Env(cfg, scene, num_worlds=args.num_worlds, seed=10, device=device,
              collect_log=collect)
    ecfg = EvalConfig(num_worlds=args.num_worlds,
                      num_eval_steps=args.num_steps, policy_dtype=dtype)
    mgr = EvalManager(cfg, ecfg, env, len(policies), vs_bot=args.vs_bot,
                      device=device)
    print_elos(elo.cpu())
    elo = mgr.run(policies, normalizer, elo, record_path=args.record,
                  event_log_dir=args.event_log, bc_dump_dir=args.bc_dump_dir)
    print_elos(elo.cpu())
    return mgr, elo


if __name__ == "__main__":
    main()
