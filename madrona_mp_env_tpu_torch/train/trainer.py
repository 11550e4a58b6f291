"""The actor-learner (the JAX package's train/trainer.py): rollout, GAE
and recurrent PPO over an ensemble of E train policies.

    env = Env(cfg, scene, num_worlds=1024)                 # on the GPU
    mgr = TrainingManager(cfg, TrainConfig(num_worlds=1024), env)
    ts = mgr.init()
    ts, metrics = mgr.update_iter(ts)

One update is ``rollout`` (policy forward + Gumbel-max sampling + env
step for ``steps_per_update`` steps, split into ``num_bptt_chunks``
chunks whose start states are kept) and ``ppo_update`` (GAE over the
whole rollout, then epochs x minibatches of (chunk, actor) sequences
re-run through the LSTM, each minibatch one step of the optax chain
clip_by_global_norm -> scale_by_adam -> scale(-1), times the policy's
learning rate). Every random draw follows the JAX key stream: the same
TrainState gives the same actions (up to ulp-level ties of the Gumbel
scores) and the same minibatch order.

Actors are routed to policies by a static block permutation ((world w,
team t) -> policy (2w + t) % E, cross-play). The JAX code vmaps the
policy over E; here a loop over the E policies applies each one's
parameters to the shared module with ``torch.func.functional_call``.
The state is a TrainState of tensors: parameter and Adam moment dicts
per policy (names as ActorCriticNet's state_dict), so that a JAX
TrainState converts to it (convert.py) and a checkpoint is a
``torch.save`` of dicts. Float32 throughout. Not ported yet: the
past-policy history, the population update, the deterministic-eval ELO
and dynamic matchmaking (the PBT slice), mixed precision, and the
multi-device data mesh.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field, replace
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from ..config import EnvConfig
from ..sim.env import Env, resolve_device
from ..sim.types import Actions, WorldState
from ..utils import rng
from .distributions import (AIM_BUCKETS, DISCRETE_BUCKETS, ActorDistributions,
                            DiscreteActionDistributions)
from .elo import elo_update_masked
from .normalizer import (EMANormalizerState, init_normalizer, normalize_obs,
                         update_normalizer)
from .pbt import ParamExplore, PBTConfig, make_matchmaking
from .policy import (ActorCriticNet, _seeded_init, clear_rnn_states,
                     init_rnn_states)
from .ppo import PPOConfig, compute_gae, ppo_loss

# observation keys fed to the policy (the rest of the env obs dict is
# train-time metadata)
POLICY_OBS_KEYS = (
    "self",
    "self_pos",
    "teammates",
    "teammate_positions",
    "opponents",
    "opponent_positions",
    "opponents_last_known",
    "opponent_last_known_positions",
    "opponent_masks",
    "fwd_lidar",
    "rear_lidar",
    "filters_state",
    "reward_coefs",
)

TRAIN_SIM_CTRL = (0, 1, 1)  # [evalMode, randomizeEpisodeLength, flipTeams]
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8  # optax.scale_by_adam


@dataclass(frozen=True)
class TrainConfig:
    """The JAX package's TrainConfig, float32 only."""

    num_worlds: int = 512
    steps_per_update: int = 40
    num_bptt_chunks: int = 4
    lr: float = 1e-4
    gamma: float = 0.998
    gae_lambda: float = 0.95
    ppo: PPOConfig = field(default_factory=PPOConfig)
    num_train_policies: int = 1  # PBT ensemble size
    pbt: Optional[PBTConfig] = None  # play portions (past policies: later)
    lr_explore: Optional[ParamExplore] = None  # per-policy lr spread
    seed: int = 5

    @property
    def chunk_len(self) -> int:
        if self.steps_per_update % self.num_bptt_chunks:
            raise ValueError("num_bptt_chunks must divide steps_per_update")
        return self.steps_per_update // self.num_bptt_chunks


Params = Dict[str, torch.Tensor]


@dataclass
class AdamState:
    """optax.scale_by_adam's state for one policy."""

    count: torch.Tensor  # int32 []
    mu: Params
    nu: Params


@dataclass
class TrainState:
    params: List[Params]  # E policies' parameters
    opt_state: List[AdamState]
    normalizer: EMANormalizerState
    env_state: WorldState  # [W, ...]
    cur_obs: Dict[str, torch.Tensor]  # policy obs [W, A, ...]
    rnn_states: torch.Tensor  # [2, 2, E, BE, H]
    key: torch.Tensor  # [2]
    update_idx: int
    elo: torch.Tensor  # [E] per-policy rating
    hyper_params: Dict[str, torch.Tensor]  # per policy, {"lr": [E]}


def _train_permutation(assign: np.ndarray, E: int) -> np.ndarray:
    """The flat actor indices of each train slot, [E, BE] (equal counts)."""
    flat = assign.reshape(-1)
    idx = [np.nonzero(flat == e)[0] for e in range(E)]
    if len({len(i) for i in idx}) != 1:
        raise ValueError("unequal train-slot actor counts")
    return np.stack(idx).astype(np.int64)


class _Sequence(nn.Module):
    """ActorCriticNet.sequence as a module's forward, for functional_call
    (parameter names prefixed with "net.")."""

    def __init__(self, net: ActorCriticNet):
        super().__init__()
        self.net = net

    def forward(self, *args):
        return self.net.sequence(*args)


def global_norm(tensors) -> torch.Tensor:
    """optax.global_norm: sqrt of the sum over leaves of sum(x ** 2)."""
    return torch.sqrt(sum((g * g).sum() for g in tensors))


def adam_step(params: Params, grads: Params, opt: AdamState, lr, max_norm
              ) -> tuple:
    """optax.chain(clip_by_global_norm(max_norm), scale_by_adam(),
    scale(-1)), then x lr and apply_updates, written out: the gradients
    are scaled by max_norm / norm only when their global norm reaches
    max_norm (no epsilon), and Adam's bias corrections divide the
    moments. Returns (params, opt_state)."""
    g_norm = global_norm(grads.values())
    keep = g_norm < max_norm
    count = opt.count + 1
    cf = count.to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.full_like(cf, ADAM_B1), cf)
    bc2 = 1.0 - torch.pow(torch.full_like(cf, ADAM_B2), cf)
    new_p, mu, nu = {}, {}, {}
    for k, p in params.items():
        g = torch.where(keep, grads[k], grads[k] / g_norm * max_norm)
        mu[k] = (1.0 - ADAM_B1) * g + ADAM_B1 * opt.mu[k]
        nu[k] = (1.0 - ADAM_B2) * g ** 2 + ADAM_B2 * opt.nu[k]
        u = (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + ADAM_EPS)
        new_p[k] = p + (u * -1.0) * lr
    return new_p, AdamState(count=count, mu=mu, nu=nu)


class TrainingManager:
    """The env, the policy module, the routing tables and the update
    functions over a TrainState, all on one device (the env's: the first
    CUDA device unless ``device="cpu"``)."""

    def __init__(self, cfg: EnvConfig, tcfg: TrainConfig, env: Env,
                 device=None):
        self.device = resolve_device(device)
        if env.device != self.device:
            raise ValueError(f"env is on {env.device}, the trainer on "
                             f"{self.device}")
        if env.num_worlds != tcfg.num_worlds:
            raise ValueError("env and TrainConfig disagree on num_worlds")
        self.cfg, self.tcfg, self.env = cfg, tcfg, env
        self.W, self.A = tcfg.num_worlds, cfg.num_agents
        self.B = self.W * self.A
        self.E = tcfg.num_train_policies
        self.pbt = tcfg.pbt or PBTConfig(num_train_policies=self.E)
        if self.pbt.num_train_policies != self.E:
            raise ValueError("PBTConfig and TrainConfig disagree on E")
        if self.pbt.num_past_policies:
            raise NotImplementedError(
                "past policies come with the PBT slice (ROADMAP M10 rest)")
        assign, _ = make_matchmaking(self.W, self.A, cfg.team_size, self.pbt)
        dev = self.device
        self.assignment = torch.as_tensor(assign, device=dev)  # [W, A] slot
        # [E, BE] flat-actor indices of each train block
        self.train_perm = torch.as_tensor(_train_permutation(assign, self.E),
                                          device=dev)
        self.BE = self.train_perm.shape[1]
        self.model = ActorCriticNet().to(dev).requires_grad_(False)
        self._seq = _Sequence(self.model)
        self._obs_slots = None

    # -------------------------------------------------- block routing
    def to_blocks(self, x):
        """[W, A, ...] -> train blocks [E, BE, ...]. One policy: a
        reshape (every actor is in block 0, in index order)."""
        if self.E == 1:
            return x.reshape((1, self.B) + x.shape[2:])
        return x.reshape((self.B,) + x.shape[2:])[self.train_perm]

    def from_blocks(self, train_b):
        """Train blocks [E, BE, ...] back to [W, A, ...]."""
        tail = train_b.shape[2:]
        if self.E == 1:
            return train_b.reshape((self.W, self.A) + tail)
        flat = torch.zeros((self.B,) + tail, dtype=train_b.dtype,
                           device=train_b.device)
        flat[self.train_perm.reshape(-1)] = train_b.reshape((-1,) + tail)
        return flat.reshape((self.W, self.A) + tail)

    def _policy_obs(self, obs):
        out = {k: obs[k] for k in POLICY_OBS_KEYS}
        # lidar stored flat, as the normalizer stats are keyed
        for k in ("fwd_lidar", "rear_lidar"):
            out[k] = out[k].reshape(out[k].shape[:-3] + (-1,))
        return out

    @staticmethod
    def _slots(obs):
        """(key, start, end, tail) of each key in the packed obs row."""
        slots, start = [], 0
        for k in POLICY_OBS_KEYS:
            tail = tuple(obs[k].shape[2:])
            f = int(np.prod(tail)) if tail else 1
            slots.append((k, start, start + f, tail))
            start += f
        return slots

    def _pack_obs(self, obs):
        """Dict of [E, BE, *tail] -> one [E, BE, F] tensor, the keys in
        POLICY_OBS_KEYS order."""
        return torch.cat([obs[k].reshape(obs[k].shape[:2] + (e - s,))
                          for k, s, e, _ in self._obs_slots], dim=-1)

    def _unpack_obs(self, packed):
        return {k: packed[..., s:e].reshape(packed.shape[:-1] + tail)
                for k, s, e, tail in self._obs_slots}

    # -------------------------------------------------- init
    def init(self, seed: Optional[int] = None,
             params: Optional[List[Params]] = None) -> TrainState:
        """Reset every world and start E policies: ``params`` (e.g. from
        convert.params_from_jax) or weights made from ``seed`` (the
        port's seeded scheme, not flax's initializers), zero Adam
        moments, a fresh normalizer, ELO 1000."""
        seed = self.tcfg.seed if seed is None else seed
        dev = self.device
        k_param, k_state, k_hp = rng.split(rng.prng_key(seed, device=dev), 3)
        env_state, obs = self.env.reset(sim_ctrl=TRAIN_SIM_CTRL)
        pobs = self._policy_obs(obs)
        if params is None:
            params = []
            for e in range(self.E):
                net = ActorCriticNet()
                _seeded_init(net, seed * self.E + e)
                params.append(dict(net.state_dict()))
        params = [{k: v.detach().to(dev, torch.float32).clone()
                   for k, v in p.items()} for p in params]
        if len(params) != self.E:
            raise ValueError(f"{len(params)} param sets for E = {self.E}")
        opt_state = [AdamState(
            count=torch.zeros((), dtype=torch.int32, device=dev),
            mu={k: torch.zeros_like(v) for k, v in p.items()},
            nu={k: torch.zeros_like(v) for k, v in p.items()})
            for p in params]
        blocks = {k: self.to_blocks(v) for k, v in pobs.items()}
        self._obs_slots = self._slots(blocks)
        normalizer = init_normalizer({k: v[0] for k, v in blocks.items()})
        if self.tcfg.lr_explore is not None:
            lr0 = self.tcfg.lr_explore.init_values(k_hp, self.E)
        else:
            lr0 = torch.full((self.E,), self.tcfg.lr, dtype=torch.float32)
        return TrainState(
            params=params, opt_state=opt_state, normalizer=normalizer,
            env_state=env_state.replace(policy_idx=self.assignment.clone()),
            cur_obs=pobs,
            rnn_states=init_rnn_states((self.E, self.BE), device=dev),
            key=k_state, update_idx=0,
            elo=torch.full((self.E,), 1000.0, device=dev),
            hyper_params={"lr": lr0.to(dev)},
        )

    # -------------------------------------------------- policy apply
    def apply_blocks(self, params: List[Params], rnn_states, obs_blocks):
        """Each policy on its block. rnn_states [2, 2, E, BE, H]; obs
        leaves [E, BE, ...] -> (dists with [E, BE, S] logits, values [E,
        BE], new rnn_states)."""
        outs = [functional_call(self.model, params[e],
                                (rnn_states[:, :, e],
                                 {k: v[e] for k, v in obs_blocks.items()}))
                for e in range(self.E)]
        dists = ActorDistributions(
            discrete=DiscreteActionDistributions(
                torch.stack([o[0].discrete.logits for o in outs]),
                DISCRETE_BUCKETS),
            aim=DiscreteActionDistributions(
                torch.stack([o[0].aim.logits for o in outs]), AIM_BUCKETS))
        return (dists, torch.stack([o[1] for o in outs]),
                torch.stack([o[2] for o in outs], dim=2))

    # -------------------------------------------------- rollout
    @torch.no_grad()
    def rollout(self, ts: TrainState):
        """``steps_per_update`` steps of every policy and the env. Returns
        (ts, rnn_starts [K, 2, 2, E, BE, H], outs with [K, L, ...] leaves,
        bootstrap values [E, BE])."""
        tcfg = self.tcfg
        K, L = tcfg.num_bptt_chunks, tcfg.chunk_len
        key, sub = rng.split(ts.key, 2)
        step_keys = rng.split(sub, K * L)
        env_state, obs, rnn, norm = (ts.env_state, ts.cur_obs, ts.rnn_states,
                                     ts.normalizer)
        zf = torch.zeros((self.W, self.A), dtype=torch.float32,
                         device=self.device)
        rnn_starts, steps = [], []
        for t in range(K * L):
            if t % L == 0:
                rnn_starts.append(rnn)
            k_train = rng.split(step_keys[t], 2)[0]
            obs_blocks = {k: self.to_blocks(v) for k, v in obs.items()}
            norm_obs = normalize_obs(norm, obs_blocks)
            dists, values, rnn = self.apply_blocks(ts.params, rnn, norm_obs)
            actions, log_probs = dists.sample(k_train)
            da = self.from_blocks(actions["discrete"])
            aa = self.from_blocks(actions["aim"])
            env_state, out = self.env.step(env_state, Actions(
                move_amount=da[..., 0], move_angle=da[..., 1],
                fire=da[..., 2], stand=da[..., 3], aim_yaw=aa[..., 0],
                aim_pitch=aa[..., 1], aim_yaw_rate=zf, aim_pitch_rate=zf,
            ), TRAIN_SIM_CTRL)
            done_b = self.to_blocks(out["done"])
            rnn = clear_rnn_states(rnn, done_b != 0)
            obs = self._policy_obs(out["obs"])
            norm = update_normalizer(norm, obs_blocks)
            res = out["episode_result"]
            steps.append({
                "obs_pack": self._pack_obs(norm_obs),
                "act_pack": torch.cat([actions["discrete"], actions["aim"]],
                                      dim=-1),
                "log_probs": log_probs, "values": values,
                "rewards": self.to_blocks(out["reward"]),
                "dones": done_b, "win_result": res["win_result"],
                "match_finished": res["match_finished"],
            })
        outs = _stack(steps, (K, L))
        final = {k: self.to_blocks(v) for k, v in obs.items()}
        _, bootstrap, _ = self.apply_blocks(ts.params, rnn,
                                            normalize_obs(norm, final))
        ts = replace(ts, env_state=env_state, cur_obs=obs, rnn_states=rnn,
                     normalizer=norm, key=key)
        return ts, torch.stack(rnn_starts), outs, bootstrap

    # -------------------------------------------------- ppo update
    def advantages(self, outs, bootstrap_value):
        """GAE over the whole rollout: (adv, ret) [K, L, E, BE]."""
        tcfg = self.tcfg
        shape = outs["values"].shape
        T = shape[0] * shape[1]
        adv, ret = compute_gae(
            outs["rewards"].reshape(T, -1), outs["values"].reshape(T, -1),
            outs["dones"].reshape(T, -1), bootstrap_value.reshape(-1),
            tcfg.gamma, tcfg.gae_lambda)
        return adv.reshape(shape), ret.reshape(shape)

    def minibatch_order(self, key, num_units: int) -> torch.Tensor:
        """One epoch's unit order per policy, [E, num_units]: the JAX
        vmap of jax.random.permutation over split(key, E)."""
        return torch.stack([rng.permutation(k, num_units)
                            for k in rng.split(key, self.E)])

    def gather_batch(self, bufs, e: int, idx):
        """Units idx [mb] (k * BE + b) of policy e -> a minibatch of
        TIME-MAJOR [L, mb, ...] leaves (and rnn [mb, 2, 2, H])."""
        k, b = idx // self.BE, idx % self.BE
        ll = torch.arange(self.tcfg.chunk_len, device=idx.device)[:, None]
        return {
            "obs_pack": bufs["obs_pack"][k[None], ll, e, b[None]],
            "act": bufs["act"][k[None], ll, e, b[None]],
            "scal": bufs["scal"][k[None], ll, e, b[None]],
            "rnn": bufs["rnn"][k, :, :, e, b],
        }

    def loss_and_grads(self, params: Params, batch):
        """The PPO loss of one minibatch for one policy: (grads, metrics)."""
        p = {f"net.{k}": v.detach().requires_grad_(True)
             for k, v in params.items()}
        scal = batch["scal"]
        new_lp, ent, new_v = functional_call(self._seq, p, (
            batch["rnn"].movedim(0, 2), scal[..., 1],
            self._unpack_obs(batch["obs_pack"]),
            {"discrete": batch["act"][..., :4], "aim": batch["act"][..., 4:6]},
        ))
        loss, metrics = ppo_loss(
            new_lp, ent, new_v, {"discrete": scal[..., 4],
                                 "aim": scal[..., 5]},
            scal[..., 0], scal[..., 2], scal[..., 3], self.tcfg.ppo)
        grads = torch.autograd.grad(loss, list(p.values()))
        return ({k: g for k, g in zip(params, grads)},
                {k: v.detach() for k, v in metrics.items()})

    def ppo_buffers(self, rnn_starts, outs, bootstrap_value):
        """The rollout buffers the minibatches gather from."""
        adv, ret = self.advantages(outs, bootstrap_value)
        lp = outs["log_probs"]
        return {
            "obs_pack": outs["obs_pack"],  # [K, L, E, BE, F]
            "act": outs["act_pack"],  # [K, L, E, BE, 6]
            # values, dones, adv, ret, log_probs (discrete, aim)
            "scal": torch.stack([outs["values"],
                                 outs["dones"].to(torch.float32), adv, ret,
                                 lp["discrete"], lp["aim"]], dim=-1),
            "rnn": rnn_starts,  # [K, 2, 2, E, BE, H]
        }

    def ppo_update(self, ts: TrainState, rnn_starts, outs, bootstrap_value):
        """Epochs x minibatches of PPO; returns (ts, metrics [E] each,
        averaged over epochs and minibatches)."""
        pcfg = self.tcfg.ppo
        bufs = self.ppo_buffers(rnn_starts, outs, bootstrap_value)
        num_units = self.tcfg.num_bptt_chunks * self.BE
        if num_units % pcfg.num_minibatches:
            raise ValueError("num_minibatches must divide chunks x actors")
        mb = num_units // pcfg.num_minibatches
        key, sub = rng.split(ts.key, 2)
        params, opt_state = list(ts.params), list(ts.opt_state)
        lr = ts.hyper_params["lr"]
        rows = []
        for epoch_key in rng.split(sub, pcfg.num_epochs):
            order = self.minibatch_order(epoch_key, num_units)
            for i in range(pcfg.num_minibatches):
                idx = order[:, i * mb:(i + 1) * mb]
                per_e = []
                for e in range(self.E):
                    grads, m = self.loss_and_grads(
                        params[e], self.gather_batch(bufs, e, idx[e]))
                    with torch.no_grad():
                        params[e], opt_state[e] = adam_step(
                            params[e], grads, opt_state[e], lr[e],
                            pcfg.max_grad_norm)
                    per_e.append(m)
                rows.append({k: torch.stack([m[k] for m in per_e])
                             for k in per_e[0]})
        metrics = {k: torch.stack([r[k] for r in rows]).mean(0)
                   for k in rows[0]}
        return replace(ts, params=params, opt_state=opt_state, key=key), \
            metrics

    # -------------------------------------------------- full update
    def update_iter(self, ts: TrainState):
        """One rollout + PPO update; (ts, metrics)."""
        ts, rnn_starts, outs, bootstrap = self.rollout(ts)
        ts, metrics = self.ppo_update(ts, rnn_starts, outs, bootstrap)
        with torch.no_grad():
            metrics["reward_mean"] = outs["rewards"].mean()
            metrics["value_mean"] = outs["values"].mean()
            finished = outs["match_finished"]
            metrics["episodes_finished"] = finished.to(torch.int32).sum()
            # ELO between ensemble members from every finished match
            team_policies = self.assignment[:, ::self.cfg.team_size]  # [W, 2]
            n = finished.numel()
            pairs = team_policies.expand(finished.shape + (2,)).reshape(n, 2)
            win = outs["win_result"].reshape(n)
            score_a = torch.where(win == 0, 1.0,
                                  torch.where(win == 1, 0.0, 0.5))
            elo = elo_update_masked(ts.elo, pairs, score_a,
                                    finished.reshape(n) & (win >= 0))
        metrics["elo"] = elo
        return replace(ts, update_idx=ts.update_idx + 1, elo=elo), metrics

    def update_loop(self, ts: TrainState, num_updates: int):
        """``num_updates`` updates; every update's metrics stacked on a
        leading axis."""
        rows = []
        for _ in range(num_updates):
            ts, m = self.update_iter(ts)
            rows.append(m)
        return ts, {k: torch.stack([r[k] for r in rows]) for k in rows[0]}

    # -------------------------------------------------- checkpointing
    def save_ckpt(self, ts: TrainState, path: str) -> str:
        """``<path>/<update_idx>.pt``: params, Adam state, normalizer,
        update index, ELO and hyperparameters (torch.save of dicts)."""
        os.makedirs(path, exist_ok=True)
        out = os.path.join(os.path.abspath(path), f"{ts.update_idx}.pt")
        torch.save({
            "params": ts.params,
            "opt_state": [vars(o) for o in ts.opt_state],
            "normalizer": vars(ts.normalizer),
            "update_idx": ts.update_idx,
            "elo": ts.elo,
            "hyper_params": ts.hyper_params,
        }, out)
        return out

    def restore_ckpt(self, ts: TrainState, path: str) -> TrainState:
        """The saved pieces of ``path`` (a save_ckpt file) into ts."""
        ck = torch.load(path, map_location=self.device, weights_only=True)
        return replace(
            ts, params=ck["params"],
            opt_state=[AdamState(**o) for o in ck["opt_state"]],
            normalizer=EMANormalizerState(**ck["normalizer"]),
            update_idx=int(ck["update_idx"]), elo=ck["elo"],
            hyper_params=ck["hyper_params"])


def _stack(steps: List[Dict[str, Any]], lead):
    """Per-step (nested) dicts of tensors -> leaves [*lead, ...]."""
    first = steps[0]
    if isinstance(first, dict):
        return {k: _stack([s[k] for s in steps], lead) for k in first}
    x = torch.stack(steps)
    return x.reshape(tuple(lead) + x.shape[1:])
