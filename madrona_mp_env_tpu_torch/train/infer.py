"""The evaluation rollout: the forward-only crossplay eval (the JAX
package's train/infer.py EvalManager).

P policies share the worlds by the trainer's static block routing
((world w, team t) -> policy (2w + t) % P, pbt.make_matchmaking's
cross-play); every step normalizes the
observations, runs each policy on its block, samples (or takes the best)
actions, steps the env, folds finished matches into the crossplay ELO and
clears the recurrent state of agents whose episode ended.

    env = Env(cfg, scene, num_worlds=1024)                # on the GPU
    mgr = EvalManager(cfg, EvalConfig(num_worlds=1024), env, num_policies=2)
    elo = mgr.run(policies, normalizer, elo)

Everything runs on the env's device (the first CUDA device unless
``device="cpu"``). The step keys follow the JAX stream: PRNGKey(seed),
split once per chunk, the chunk's half split into one key per step. Not
ported yet: the vs-bot eval (needs the scripted A* bot) and the record,
event-log and behaviour-cloning dumps (ROADMAP M14).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from .. import consts
from ..config import EnvConfig
from ..sim.env import Env, resolve_device
from ..sim.types import Actions
from ..utils import rng
from .distributions import (AIM_BUCKETS, DISCRETE_BUCKETS, ActorDistributions,
                            DiscreteActionDistributions)
from .elo import elo_update_masked
from .normalizer import EMANormalizerState, normalize_obs
from .policy import (ActorCriticNet, clear_rnn_states, get_episode_scores,
                     init_rnn_states)
from .pbt import PBTConfig, make_matchmaking
from .trainer import POLICY_OBS_KEYS, _train_permutation

EVAL_SIM_CTRL = (1, 0, 0)  # [evalMode, randomizeEpisodeLength, flipTeams]


@dataclass(frozen=True)
class EvalConfig:
    """The fields of the JAX package's EvalConfig that its rollout reads;
    the policy runs in float32."""

    num_worlds: int
    num_eval_steps: int = 200
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


class EvalManager:
    """Forward-only rollout over a P-policy ensemble with crossplay
    matchmaking (the trainer's static block routing)."""

    def __init__(self, cfg: EnvConfig, ecfg: EvalConfig, env: Env,
                 num_policies: int, vs_bot: bool = False, device=None):
        if vs_bot:
            raise NotImplementedError(
                "the vs-bot eval needs the scripted A* bot, not ported yet")
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
        self.W = ecfg.num_worlds
        self.A = cfg.num_agents
        self.B = self.W * self.A
        self.BP = self.B // self.P

        assign, _ = make_matchmaking(self.W, self.A, cfg.team_size,
                                     PBTConfig(num_train_policies=self.P))
        perm = _train_permutation(assign, self.P).reshape(-1)
        dev = self.device
        self.assignment = torch.as_tensor(assign, device=dev)
        self.perm = torch.as_tensor(perm, device=dev)
        self.inv_perm = torch.as_tensor(np.argsort(perm), device=dev)
        self.team_policies = self.assignment[:, ::cfg.team_size]  # [W, 2]
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
        env_state = env_state.replace(policy_idx=self.assignment.clone())
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

    def forward(self, policies: Sequence[ActorCriticNet],
                normalizer: EMANormalizerState, obs, rnn):
        """Normalize, then each policy on its block: (dists with [P, B / P,
        S] logits, values [P, B / P], new rnn [2, 2, P, B / P, H])."""
        blocks = {k: self.to_blocks(v)
                  for k, v in self._policy_obs(obs).items()}
        norm_obs = normalize_obs(normalizer, blocks)
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
             step_key):
        """One eval step: (env_state, obs, rnn, elo, step outputs)."""
        dists, values, rnn2 = self.forward(policies, normalizer, obs, rnn)
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
        return env_state, out["obs"], rnn2, elo, step_out

    def rollout_chunk(self, policies, normalizer, env_state, obs, rnn, elo,
                      keys):
        """len(keys) steps; the outputs stacked on a leading step axis."""
        outs = []
        for t in range(keys.shape[0]):
            env_state, obs, rnn, elo, o = self.step(
                policies, normalizer, env_state, obs, rnn, elo, keys[t])
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
        """The eval rollout; returns the final per-policy ELO [P].
        ``iter_cb`` gets each chunk's stacked outputs (tensors on the
        eval's device)."""
        if record_path or event_log_dir or bc_dump_dir:
            raise NotImplementedError(
                "record, event-log and BC dumps are not ported yet")
        if len(policies) != self.P:
            raise ValueError(f"{len(policies)} policies for P = {self.P}")
        ecfg = self.ecfg
        env_state, obs, rnn = self.init_state()
        elo = elo.to(self.device, torch.float32)
        num_chunks = -(-ecfg.num_eval_steps // ecfg.chunk_steps)
        keys = chunk_keys(ecfg.seed, num_chunks, ecfg.chunk_steps,
                          device=self.device)
        total_swaps = np.zeros((consts.max_zones,), np.int64)
        for ci in range(num_chunks):
            (env_state, obs, rnn, elo), outs = self.rollout_chunk(
                policies, normalizer, env_state, obs, rnn, elo, keys[ci])
            # zone-swap accounting at episode ends
            res = outs["episode_result"]
            swaps = torch.where(res["match_finished"][..., None, None],
                                res["zone_stats"], 0)[..., 0].sum((0, 1))
            total_swaps += swaps.cpu().numpy()
            if verbose and swaps.sum() > 0:
                print("zone swaps:", total_swaps)
            if iter_cb is not None:
                iter_cb(outs)
        return elo


def _stack(steps):
    """List of (nested dicts of) tensors -> the same with a leading axis."""
    first = steps[0]
    if isinstance(first, dict):
        return {k: _stack([s[k] for s in steps]) for k in first}
    return torch.stack(steps)
