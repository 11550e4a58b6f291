"""The actor-learner (the JAX package's train/trainer.py): rollout, GAE
and recurrent PPO over an ensemble of E train policies, with the PBT
population around it.

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

Actors are routed to policy slots by the matchmaking tables in the
TrainState: slots [0, E) are the train policies, [E, E + P) the frozen
past policies (self / cross / past play portions, pbt.make_matchmaking),
each slot's actors one block of a static size. The JAX code vmaps the
policy over a block axis; here a loop over the blocks applies each
policy's parameters to the shared module with
``torch.func.functional_call``. The PBT operations between updates are
``eval_elo`` (deterministic matches from the current state, ELO from
1000), ``store_past_policy`` (the best train policy into the past
ring), ``update_population`` (ELO-ranked truncation selection) and
``resample_matchmaking`` (re-paired teams, a forced reset on the next
rollout's first step).

The state is a TrainState of tensors: parameter and Adam moment dicts
per policy (names as ActorCriticNet's state_dict), so that a JAX
TrainState converts to it (convert.py) and a checkpoint is a
``torch.save`` of dicts. ``TrainConfig.compute_dtype`` (float32,
bfloat16 or float16) is the policy's compute dtype in the rollout, the
stored observations and BPTT start states and the loss; parameters,
Adam state, values, log probs and the loss terms stay float32.

Data parallelism (``mesh``, a parallel.DataMesh of N ranks, one process
and one device each): the env steps this rank's W / N worlds, and each
policy block keeps only the members this rank owns, on one ragged axis
(parallel.Blocks). Each rank draws its own actors' share of the global
Gumbel noise, folds every rank's batch into the normalizer, takes the
loss of its units of each global minibatch as a sum over the global
minibatch size and sums the gradients over the ranks before Adam, so the
update is the one-process update at W worlds (up to the order of the
sums). The ELO folds gather every world's match results first, and
rank 0 alone writes checkpoints. With one rank nothing of this runs.
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
from ..parallel import collectives
from ..parallel.sharding import Blocks, DataMesh
from ..sim.env import Env, resolve_device
from ..sim.types import Actions, WorldState
from ..utils import rng
from .distributions import (AIM_BUCKETS, DISCRETE_BUCKETS, ActorDistributions,
                            DiscreteActionDistributions)
from .elo import accumulate_match_scores, elo_update_masked
from .normalizer import (EMANormalizerState, init_normalizer, normalize_obs,
                         update_normalizer)
from .pbt import (ParamExplore, PBTConfig, make_matchmaking,
                  update_population)
from .policy import (ActorCriticNet, _seeded_init, clear_rnn_states,
                     init_rnn_states)
from .ppo import PPO_METRICS, PPOConfig, compute_gae, ppo_loss

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
EVAL_SIM_CTRL = (1, 0, 0)
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8  # optax.scale_by_adam


@dataclass(frozen=True)
class TrainConfig:
    """The JAX package's TrainConfig: ``compute_dtype`` is a torch dtype,
    float32 (the default), bfloat16 or float16 (no loss scaling, as in
    the JAX package)."""

    num_worlds: int = 512
    steps_per_update: int = 40
    num_bptt_chunks: int = 4
    lr: float = 1e-4
    gamma: float = 0.998
    gae_lambda: float = 0.95
    ppo: PPOConfig = field(default_factory=PPOConfig)
    num_train_policies: int = 1  # PBT ensemble size
    pbt: Optional[PBTConfig] = None  # play portions, past policies
    lr_explore: Optional[ParamExplore] = None  # per-policy lr spread
    compute_dtype: torch.dtype = torch.float32
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
    past_rnn_states: torch.Tensor  # [2, 2, P, BPp, H] (P may be 0)
    key: torch.Tensor  # [2]
    update_idx: int
    elo: torch.Tensor  # [E + P] per-slot rating
    hyper_params: Dict[str, torch.Tensor]  # per policy, {"lr": [E]}
    past_params: List[Params]  # P frozen past policies
    past_ptr: int  # the next past slot to overwrite (mod P)
    # the matchmaking tables (resample_matchmaking re-draws them)
    assignment: torch.Tensor  # [W, A] int32 policy slot per actor
    train_perm: torch.Tensor  # [E, BE] flat-actor indices per train block
    past_perm: torch.Tensor  # [P, BPp]
    pending_reset: bool  # force-reset every world on the next rollout


def slot_permutations(assign: np.ndarray, E: int, P: int):
    """The flat actor indices of each train slot [E, BE] and each past
    slot [P, BPp] (slots [E, E + P)), each set of blocks of equal size."""
    flat = assign.reshape(-1)

    def blocks(slots, what):
        idx = [np.nonzero(flat == s)[0] for s in slots]
        if len({len(i) for i in idx}) > 1:
            raise ValueError(f"unequal {what}-slot actor counts")
        return np.stack(idx).astype(np.int64) if idx else np.zeros(
            (0, 0), np.int64)

    return blocks(range(E), "train"), blocks(range(E, E + P), "past")


def _clone(params: Params) -> Params:
    return {k: v.clone() for k, v in params.items()}


class _Sequence(nn.Module):
    """ActorCriticNet.sequence as a module's forward, for functional_call
    (parameter names prefixed with "net.")."""

    def __init__(self, net: ActorCriticNet):
        super().__init__()
        self.net = net

    def forward(self, *args):
        return self.net.sequence(*args)


def init_adam(params: Params) -> AdamState:
    """optax.scale_by_adam's initial state: count 0, zero moments."""
    dev = next(iter(params.values())).device
    return AdamState(count=torch.zeros((), dtype=torch.int32, device=dev),
                     mu={k: torch.zeros_like(v) for k, v in params.items()},
                     nu={k: torch.zeros_like(v) for k, v in params.items()})


def global_norm(tensors) -> torch.Tensor:
    """optax.global_norm: sqrt of the sum over leaves of sum(x ** 2)."""
    return torch.sqrt(sum((g * g).sum() for g in tensors))


def adam_step(params: Params, grads: Params, opt: AdamState, lr,
              max_norm: Optional[float]) -> tuple:
    """optax.chain(clip_by_global_norm(max_norm), scale_by_adam(),
    scale(-1)), then x lr and apply_updates, written out: the gradients
    are scaled by max_norm / norm only when their global norm reaches
    max_norm (no epsilon), and Adam's bias corrections divide the
    moments. ``max_norm`` None is optax.adam(lr), without the clip.
    Returns (params, opt_state)."""
    if max_norm is not None:
        g_norm = global_norm(grads.values())
        keep = g_norm < max_norm
    count = opt.count + 1
    cf = count.to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.full_like(cf, ADAM_B1), cf)
    bc2 = 1.0 - torch.pow(torch.full_like(cf, ADAM_B2), cf)
    new_p, mu, nu = {}, {}, {}
    for k, p in params.items():
        g = grads[k]
        if max_norm is not None:
            g = torch.where(keep, g, g / g_norm * max_norm)
        mu[k] = (1.0 - ADAM_B1) * g + ADAM_B1 * opt.mu[k]
        nu[k] = (1.0 - ADAM_B2) * g ** 2 + ADAM_B2 * opt.nu[k]
        u = (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + ADAM_EPS)
        new_p[k] = p + (u * -1.0) * lr
    return new_p, AdamState(count=count, mu=mu, nu=nu)


class TrainingManager:
    """The env, the policy module, the routing tables and the update
    functions over a TrainState, all on one device (the env's: the first
    CUDA device unless ``device="cpu"``). ``mesh``: this process is one
    rank of a data mesh, and ``env`` steps its worlds of the
    ``tcfg.num_worlds``."""

    def __init__(self, cfg: EnvConfig, tcfg: TrainConfig, env: Env,
                 device=None, mesh: Optional[DataMesh] = None):
        self.device = resolve_device(device)
        if env.device != self.device:
            raise ValueError(f"env is on {env.device}, the trainer on "
                             f"{self.device}")
        self.mesh = mesh or DataMesh(tcfg.num_worlds)
        if self.mesh.num_worlds != tcfg.num_worlds:
            raise ValueError("mesh and TrainConfig disagree on num_worlds")
        if (env.num_worlds, env.world_offset) != (self.mesh.local_worlds,
                                                  self.mesh.world_lo):
            raise ValueError(
                f"env steps worlds [{env.world_offset}, "
                f"{env.world_offset + env.num_worlds}), rank "
                f"{self.mesh.rank} owns [{self.mesh.world_lo}, "
                f"{self.mesh.world_hi}) of TrainConfig's num_worlds")
        self.sharded = self.mesh.size > 1
        self.cfg, self.tcfg, self.env = cfg, tcfg, env
        self.W, self.A = tcfg.num_worlds, cfg.num_agents
        self.B = self.W * self.A
        self.Wl = self.mesh.local_worlds  # this rank's worlds
        self.E = tcfg.num_train_policies
        self.pbt = tcfg.pbt or PBTConfig(num_train_policies=self.E)
        if self.pbt.num_train_policies != self.E:
            raise ValueError("PBTConfig and TrainConfig disagree on E")
        self.P = self.pbt.num_past_policies
        assign, _ = make_matchmaking(self.W, self.A, cfg.team_size, self.pbt)
        train_perm, past_perm = slot_permutations(assign, self.E, self.P)
        dev = self.device
        # init's tables (assignment [W, A], train_perm [E, BE], past_perm
        # [P, BPp]); routing reads a TrainState's own, which matchmaking
        # rotates
        self._tables0 = (assign, train_perm, past_perm)
        self.BE = train_perm.shape[1]
        self.BPp = past_perm.shape[1]
        # past slots with no actors (past_play_portion 0) never act
        self.has_past = self.P > 0 and self.BPp > 0
        # the multiset of per-team slots, which matchmaking re-pairs
        self.team_slots_base = torch.as_tensor(
            assign[:, ::cfg.team_size].reshape(-1), device=dev)  # [2W]
        self.model = ActorCriticNet(tcfg.compute_dtype).to(
            dev).requires_grad_(False)
        self._seq = _Sequence(self.model)
        self._obs_slots = None
        self._zf = torch.zeros((self.Wl, self.A), dtype=torch.float32,
                               device=dev)  # the aim rates
        self.eval_matches = None  # finished matches of the last eval_elo
        self._sharded_blocks = None  # (train_perm, past_perm, Blocks x 2)

    # -------------------------------------------------- block routing
    def identity_blocks(self) -> bool:
        """One train policy and no acting past policy: every actor is in
        train block 0 in index order, whatever matchmaking does."""
        return self.E == 1 and not self.has_past

    def blocks(self, ts: TrainState):
        """(train, past) Blocks of ts's tables on this process: the dense
        [E, BE] / [P, BPp] layout with one rank; with several, this rank's
        members, rebuilt only when the tables change."""
        if not self.sharded:
            return (Blocks(ts.train_perm, self.identity_blocks()),
                    Blocks(ts.past_perm))
        c = self._sharded_blocks
        if c is not None and not (c[0] is ts.train_perm
                                  and c[1] is ts.past_perm):
            if torch.equal(c[0], ts.train_perm) and torch.equal(
                    c[1], ts.past_perm):
                c = (ts.train_perm, ts.past_perm) + c[2:]
            else:
                c = None
        if c is None:
            lo, hi = self.mesh.world_lo * self.A, self.mesh.world_hi * self.A
            c = (ts.train_perm, ts.past_perm,
                 Blocks(ts.train_perm, self.identity_blocks(), lo, hi),
                 Blocks(ts.past_perm, False, lo, hi))
        self._sharded_blocks = c
        return c[2], c[3]

    def from_blocks(self, train_b, past_b, tb: Blocks, pb: Blocks):
        """Train blocks (and past blocks, or None) back to [W, A, ...] of
        this process's worlds."""
        tail = train_b.shape[len(tb.shape):]
        if tb.identity:
            return train_b.reshape((self.Wl, self.A) + tail)
        flat = torch.zeros((self.Wl * self.A,) + tail, dtype=train_b.dtype,
                           device=train_b.device)
        tb.scatter(flat, train_b)
        if past_b is not None and self.has_past:
            pb.scatter(flat, past_b)
        return flat.reshape((self.Wl, self.A) + tail)

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
        """Dict of [*blocks, *tail] -> one [*blocks, F] tensor, the keys
        in POLICY_OBS_KEYS order."""
        return torch.cat([
            obs[k].reshape(obs[k].shape[:obs[k].dim() - len(tail)]
                           + (e - s,))
            for k, s, e, tail in self._obs_slots], dim=-1)

    def _unpack_obs(self, packed):
        return {k: packed[..., s:e].reshape(packed.shape[:-1] + tail)
                for k, s, e, tail in self._obs_slots}

    # -------------------------------------------------- init
    def init(self, seed: Optional[int] = None,
             params: Optional[List[Params]] = None) -> TrainState:
        """Reset every world and start E policies: ``params`` (e.g. from
        convert.params_from_jax) or weights made from ``seed`` (the
        port's seeded scheme, not flax's initializers), zero Adam
        moments, a fresh normalizer, ELO 1000; the P past policies start
        as copies of train policies p % E."""
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
        opt_state = [init_adam(p) for p in params]
        assignment, train_perm, past_perm = (
            torch.as_tensor(t, device=dev) for t in self._tables0)
        assignment = assignment[self.mesh.world_lo:self.mesh.world_hi]
        self._obs_slots = self._slots(pobs)
        normalizer = init_normalizer({k: v[0] for k, v in pobs.items()})
        if self.tcfg.lr_explore is not None:
            lr0 = self.tcfg.lr_explore.init_values(k_hp, self.E)
        else:
            lr0 = torch.full((self.E,), self.tcfg.lr, dtype=torch.float32)
        ts = TrainState(
            params=params, opt_state=opt_state, normalizer=normalizer,
            env_state=env_state.replace(policy_idx=assignment.clone()),
            cur_obs=pobs, rnn_states=None, past_rnn_states=None,
            key=k_state, update_idx=0,
            elo=torch.full((self.E + self.P,), 1000.0, device=dev),
            hyper_params={"lr": lr0.to(dev)},
            past_params=[_clone(params[p % self.E]) for p in range(self.P)],
            past_ptr=0, assignment=assignment, train_perm=train_perm,
            past_perm=past_perm, pending_reset=False,
        )
        return self._clear_rnn(ts)

    def _clear_rnn(self, ts: TrainState) -> TrainState:
        """ts with both recurrent states zeroed, in its tables' layout."""
        tb, pb = self.blocks(ts)
        dev = self.device
        return replace(ts, rnn_states=init_rnn_states(tb.shape, device=dev),
                       past_rnn_states=init_rnn_states(pb.shape, device=dev))

    # -------------------------------------------------- policy apply
    def apply_blocks(self, params: List[Params], rnn_states, obs_blocks,
                     blocks: Optional[Blocks] = None):
        """Each policy on its block. rnn_states [2, 2, N, BN, H]; obs
        leaves [N, BN, ...] for N = len(params) -> (dists with [N, BN, S]
        logits, values [N, BN], new rnn_states); ``blocks`` (ragged, a
        rank's share): rnn_states [2, 2, M, H], obs leaves [M, ...] ->
        [M, S] logits, [M] values, [2, 2, M, H]."""
        split = blocks.split if blocks is not None else torch.unbind
        join = blocks.join if blocks is not None else torch.stack
        obs_parts = {k: split(v, 0) for k, v in obs_blocks.items()}
        outs = [functional_call(self.model, params[e], (
            rnn, {k: v[e] for k, v in obs_parts.items()}))
            for e, rnn in enumerate(split(rnn_states, 2))]
        dists = ActorDistributions(
            discrete=DiscreteActionDistributions(
                join([o[0].discrete.logits for o in outs], 0),
                DISCRETE_BUCKETS),
            aim=DiscreteActionDistributions(
                join([o[0].aim.logits for o in outs], 0), AIM_BUCKETS))
        return (dists, join([o[1] for o in outs], 0),
                join([o[2] for o in outs], 2))

    def _apply(self, params, rnn_states, obs_blocks, blocks: Blocks):
        """apply_blocks on ``blocks``' layout (one process: its
        three-argument form, which callers may wrap)."""
        if blocks.ragged:
            return self.apply_blocks(params, rnn_states, obs_blocks, blocks)
        return self.apply_blocks(params, rnn_states, obs_blocks)

    def _policy_step(self, ts: TrainState, obs, rnn, past_rnn, norm,
                     keys=None):
        """One step's policy half: the train blocks (and the acting past
        blocks) normalized in the compute dtype and run through their
        policies, then Gumbel-max samples from ``keys`` (train, past) or,
        with None, the best actions. Returns (env Actions, train obs
        blocks, normalized train obs, train actions, their log probs (None
        for the best), values, rnn, past_rnn)."""
        dt = self.tcfg.compute_dtype
        tb, pb = self.blocks(ts)
        obs_blocks = {k: tb.gather(v) for k, v in obs.items()}
        norm_obs = normalize_obs(norm, obs_blocks, dt)
        dists, values, rnn = self._apply(ts.params, rnn, norm_obs, tb)
        if keys is None:
            actions, log_probs = dists.best(), None
        else:
            actions, log_probs = dists.sample(
                keys[0], tb.rows if tb.ragged else None)
        past = None
        if self.has_past:
            past_obs = {k: pb.gather(v) for k, v in obs.items()}
            pdists, _, past_rnn = self._apply(
                ts.past_params, past_rnn, normalize_obs(norm, past_obs, dt),
                pb)
            past = pdists.best() if keys is None else pdists.sample(
                keys[1], pb.rows if pb.ragged else None)[0]
        da = self.from_blocks(actions["discrete"],
                              past and past["discrete"], tb, pb)
        aa = self.from_blocks(actions["aim"], past and past["aim"], tb, pb)
        env_actions = Actions(
            move_amount=da[..., 0], move_angle=da[..., 1], fire=da[..., 2],
            stand=da[..., 3], aim_yaw=aa[..., 0], aim_pitch=aa[..., 1],
            aim_yaw_rate=self._zf, aim_pitch_rate=self._zf)
        return (env_actions, obs_blocks, norm_obs, actions, log_probs,
                values, rnn, past_rnn)

    def _clear_done(self, ts: TrainState, done, rnn, past_rnn):
        """Zero the recurrent state of actors whose episode ended."""
        tb, pb = self.blocks(ts)
        done_b = tb.gather(done)
        rnn = clear_rnn_states(rnn, done_b != 0)
        if self.has_past:
            past_rnn = clear_rnn_states(past_rnn, pb.gather(done) != 0)
        return done_b, rnn, past_rnn

    def _all_worlds(self) -> torch.Tensor:
        return torch.ones(self.Wl, dtype=torch.int32, device=self.device)

    # -------------------------------------------------- rollout
    @torch.no_grad()
    def rollout(self, ts: TrainState):
        """``steps_per_update`` steps of every policy and the env. Returns
        (ts, rnn_starts [K, 2, 2, E, BE, H] in the compute dtype, outs
        with [K, L, ...] leaves, bootstrap values [E, BE]; a rank's share
        [M] in place of [E, BE]). A pending matchmaking rotation resets
        every world on the first step."""
        tcfg = self.tcfg
        K, L = tcfg.num_bptt_chunks, tcfg.chunk_len
        key, sub = rng.split(ts.key, 2)
        step_keys = rng.split(sub, K * L)
        env_state, obs, rnn, past_rnn, norm = (
            ts.env_state, ts.cur_obs, ts.rnn_states, ts.past_rnn_states,
            ts.normalizer)
        rnn_starts, steps = [], []
        tb, _ = self.blocks(ts)
        for t in range(K * L):
            if t % L == 0:
                rnn_starts.append(rnn.to(tcfg.compute_dtype))
            (env_actions, obs_blocks, norm_obs, actions, log_probs, values,
             rnn, past_rnn) = self._policy_step(
                ts, obs, rnn, past_rnn, norm, rng.split(step_keys[t], 2))
            force = self._all_worlds() if t == 0 and ts.pending_reset \
                else None
            env_state, out = self.env.step(env_state, env_actions,
                                           TRAIN_SIM_CTRL, force)
            done_b, rnn, past_rnn = self._clear_done(ts, out["done"], rnn,
                                                     past_rnn)
            obs = self._policy_obs(out["obs"])
            norm = update_normalizer(norm, obs_blocks, mesh=self.mesh,
                                     num_actors=self.E * self.BE)
            res = out["episode_result"]
            steps.append({
                "obs_pack": self._pack_obs(norm_obs),
                "act_pack": torch.cat([actions["discrete"], actions["aim"]],
                                      dim=-1),
                "log_probs": log_probs, "values": values,
                "rewards": tb.gather(out["reward"]),
                "dones": done_b, "win_result": res["win_result"],
                "match_finished": res["match_finished"],
            })
        outs = _stack(steps, (K, L))
        final = {k: tb.gather(v) for k, v in obs.items()}
        _, bootstrap, _ = self._apply(
            ts.params, rnn, normalize_obs(norm, final, tcfg.compute_dtype),
            tb)
        ts = replace(ts, env_state=env_state, cur_obs=obs, rnn_states=rnn,
                     past_rnn_states=past_rnn, normalizer=norm, key=key,
                     pending_reset=False)
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

    def _own_batch(self, bufs, tb: Blocks, e: int, idx):
        """A rank's units of policy e's global minibatch idx [mb] from its
        ragged buffers ([K, L, M, ...], rnn [K, 2, 2, M, H]), in the
        minibatch's order, or None when it owns none of them."""
        k, b = idx // self.BE, idx % self.BE
        m = tb.inv[e * self.BE + b]
        own = m >= 0
        k, m = k[own], m[own]
        if m.numel() == 0:
            return None
        ll = torch.arange(self.tcfg.chunk_len, device=idx.device)[:, None]
        return {
            "obs_pack": bufs["obs_pack"][k[None], ll, m[None]],
            "act": bufs["act"][k[None], ll, m[None]],
            "scal": bufs["scal"][k[None], ll, m[None]],
            "rnn": bufs["rnn"][k, :, :, m],
        }

    def loss_and_grads(self, params: Params, batch,
                       count: Optional[int] = None):
        """The PPO loss of one minibatch for one policy: (grads, metrics);
        ``count``: ppo_loss's (a rank's share of a global minibatch)."""
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
            scal[..., 0], scal[..., 2], scal[..., 3], self.tcfg.ppo, count)
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
                if self.sharded:
                    rows.append(self._sharded_minibatch(
                        ts, bufs, params, opt_state, lr, idx))
                    continue
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

    def _sharded_minibatch(self, ts, bufs, params, opt_state, lr, idx):
        """One global minibatch idx [E, mb] on a rank: the loss of its own
        units of each policy over the global count, every policy's
        gradients and loss terms summed over the ranks in one all-reduce,
        then Adam (so that clip_by_global_norm sees the global norm).
        Updates ``params`` and ``opt_state`` in place; returns the loss
        terms [E] each."""
        tb, _ = self.blocks(ts)
        count = self.tcfg.chunk_len * idx.shape[1]
        names = list(params[0])
        parts = []
        for e in range(self.E):
            batch = self._own_batch(bufs, tb, e, idx[e])
            if batch is None:
                grads = {k: torch.zeros_like(v) for k, v in params[e].items()}
                m = torch.zeros(len(PPO_METRICS), device=self.device)
            else:
                grads, m = self.loss_and_grads(params[e], batch, count)
                m = torch.stack([m[k] for k in PPO_METRICS])
            parts += [grads[k].reshape(-1) for k in names] + [m]
        flat = collectives.all_sum(self.mesh, torch.cat(parts)).split(
            [x.numel() for x in parts])
        n = len(names) + 1
        for e in range(self.E):
            grads = {k: g.reshape(params[e][k].shape) for k, g in zip(
                names, flat[e * n:(e + 1) * n - 1])}
            with torch.no_grad():
                params[e], opt_state[e] = adam_step(
                    params[e], grads, opt_state[e], lr[e],
                    self.tcfg.ppo.max_grad_norm)
        return {k: torch.stack([flat[e * n + n - 1][j]
                                for e in range(self.E)])
                for j, k in enumerate(PPO_METRICS)}

    # -------------------------------------------------- full update
    def _match_elo(self, ratings, assignment, win, finished):
        """``ratings`` updated by every finished match of win and finished
        [..., W]: the two teams' policy slots from ``assignment``."""
        team_policies = assignment[:, ::self.cfg.team_size]  # [W, 2]
        n = finished.numel()
        pairs, score_a, valid = accumulate_match_scores(
            win.reshape(n),
            team_policies.expand(finished.shape + (2,)).reshape(n, 2))
        return elo_update_masked(ratings, pairs, score_a,
                                 finished.reshape(n) & valid)

    def _global_elo(self, ratings, assignment, win, finished):
        """_match_elo over every rank's worlds: the match results [..., W /
        N] and the assignment gathered in global world order, the ratings
        rank 0's (index_add_'s atomics on CUDA add in no fixed order)."""
        if not self.sharded:
            return self._match_elo(ratings, assignment, win, finished)
        m = self.mesh
        elo = self._match_elo(
            ratings, collectives.gather_worlds(m, assignment),
            collectives.gather_worlds(m, win, -1),
            collectives.gather_worlds(m, finished, -1))
        return collectives.broadcast(m, elo)

    def update_iter(self, ts: TrainState):
        """One rollout + PPO update; (ts, metrics)."""
        ts, rnn_starts, outs, bootstrap = self.rollout(ts)
        ts, metrics = self.ppo_update(ts, rnn_starts, outs, bootstrap)
        with torch.no_grad():
            finished = outs["match_finished"]
            if self.sharded:
                n = self.tcfg.steps_per_update * self.E * self.BE
                for k, v in (("reward_mean", outs["rewards"]),
                             ("value_mean", outs["values"])):
                    metrics[k] = collectives.all_mean(self.mesh, v.sum(), n)
                metrics["episodes_finished"] = collectives.all_sum(
                    self.mesh, finished.to(torch.int32).sum())
            else:
                metrics["reward_mean"] = outs["rewards"].mean()
                metrics["value_mean"] = outs["values"].mean()
                metrics["episodes_finished"] = finished.to(torch.int32).sum()
            # ELO between the slots from every finished match
            elo = self._global_elo(ts.elo, ts.assignment,
                                   outs["win_result"], finished)
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

    # ------------------------------------------- dynamic matchmaking
    def resample_matchmaking(self, ts: TrainState) -> TrainState:
        """Re-pair the teams: permute the per-team slot multiset (so every
        slot keeps its actor count and every block its size), rebuild the
        tables with a stable sort, clear both recurrent states, route the
        env's agents and reset every world on the next rollout's first
        step."""
        key, sub = rng.split(ts.key, 2)
        team_slots = self.team_slots_base[rng.permutation(sub, 2 * self.W)]
        assignment = team_slots.reshape(self.W, 2).repeat_interleave(
            self.cfg.team_size, dim=1)  # [W, A]
        order = torch.argsort(assignment.reshape(-1), stable=True)
        n_train = self.E * self.BE
        past_perm = order[n_train:].reshape(self.P, self.BPp) \
            if self.has_past else ts.past_perm
        assignment = assignment[self.mesh.world_lo:self.mesh.world_hi]
        return self._clear_rnn(replace(
            ts, env_state=ts.env_state.replace(policy_idx=assignment.clone()),
            assignment=assignment,
            train_perm=order[:n_train].reshape(self.E, self.BE),
            past_perm=past_perm, pending_reset=True, key=key))

    # ------------------------------------------- deterministic eval ELO
    @torch.no_grad()
    def eval_elo(self, ts: TrainState, num_steps: int = 1000):
        """ELO from deterministic matches: every policy's best actions,
        the eval-mode sim control, every world reset on the first step,
        from a scratch run of ts.env_state with cleared recurrent states.
        The ratings restart at 1000 and take every finished match at
        once. Returns (ts with that elo and a pending reset, elo); the
        count of finished matches is left in ``self.eval_matches``."""
        env_state, obs = ts.env_state, ts.cur_obs
        cleared = self._clear_rnn(ts)
        rnn, past_rnn = cleared.rnn_states, cleared.past_rnn_states
        wins, finished = [], []
        for t in range(num_steps):
            env_actions, *_, rnn, past_rnn = self._policy_step(
                ts, obs, rnn, past_rnn, ts.normalizer)
            env_state, out = self.env.step(
                env_state, env_actions, EVAL_SIM_CTRL,
                self._all_worlds() if t == 0 else None)
            _, rnn, past_rnn = self._clear_done(ts, out["done"], rnn,
                                                past_rnn)
            obs = self._policy_obs(out["obs"])
            wins.append(out["episode_result"]["win_result"])
            finished.append(out["episode_result"]["match_finished"])
        win, finished = torch.stack(wins), torch.stack(finished)
        self.eval_matches = collectives.all_sum(
            self.mesh, (finished & (win >= 0)).sum())
        elo = self._global_elo(torch.full_like(ts.elo, 1000.0),
                               ts.assignment, win, finished)
        # the eval's episodes restart on the next training rollout
        return replace(ts, elo=elo, pending_reset=True), elo

    # -------------------------------------------------- PBT population
    def store_past_policy(self, ts: TrainState) -> TrainState:
        """Snapshot the best train policy (by ELO, the first on ties) into
        the past ring slot past_ptr % P, with its rating."""
        if self.P == 0:
            return ts
        best = int(torch.argmax(ts.elo[:self.E]))
        slot = ts.past_ptr % self.P
        past_params = list(ts.past_params)
        past_params[slot] = _clone(ts.params[best])
        elo = ts.elo.clone()
        elo[self.E + slot] = ts.elo[best]
        return replace(ts, past_params=past_params,
                       past_ptr=ts.past_ptr + 1, elo=elo)

    def update_population(self, ts: TrainState) -> TrainState:
        """ELO-ranked truncation selection over the train policies
        (pbt.update_population): the lr explored as tcfg.lr_explore, or
        log-uniform x/÷10 around tcfg.lr."""
        key, sub = rng.split(ts.key, 2)
        explore = {"lr": self.tcfg.lr_explore or ParamExplore(
            base=self.tcfg.lr, min_scale=0.1, max_scale=10.0,
            log10_scale=True)}
        params, opt_state, hyper_params, train_elo = update_population(
            sub, ts.params, ts.opt_state, ts.hyper_params, ts.elo[:self.E],
            explore)
        elo = torch.cat([train_elo, ts.elo[self.E:]])
        return replace(ts, params=params, opt_state=opt_state,
                       hyper_params=hyper_params, elo=elo, key=key)

    # -------------------------------------------------- checkpointing
    def save_ckpt(self, ts: TrainState, path: str) -> str:
        """``<path>/<update_idx>.pt``: params, Adam state, normalizer,
        update index, ELO, hyperparameters, the past ring's pointer and,
        when P > 0, its params (torch.save of dicts). Every piece is
        replicated: rank 0 alone writes, and every rank returns once the
        file is there."""
        out = os.path.join(os.path.abspath(path), f"{ts.update_idx}.pt")
        if self.mesh.rank != 0:
            collectives.barrier(self.mesh)
            return out
        os.makedirs(path, exist_ok=True)
        ckpt = {
            "params": ts.params,
            "opt_state": [vars(o) for o in ts.opt_state],
            "normalizer": vars(ts.normalizer),
            "update_idx": ts.update_idx,
            "elo": ts.elo,
            "hyper_params": ts.hyper_params,
            "past_ptr": ts.past_ptr,
        }
        if self.P > 0:
            ckpt["past_params"] = ts.past_params
        torch.save(ckpt, out)
        collectives.barrier(self.mesh)
        return out

    def restore_ckpt(self, ts: TrainState, path: str) -> TrainState:
        """The saved pieces of ``path`` (a save_ckpt file) into ts."""
        ck = torch.load(path, map_location=self.device, weights_only=True)
        return replace(
            ts, params=ck["params"],
            opt_state=[AdamState(**o) for o in ck["opt_state"]],
            normalizer=EMANormalizerState(**ck["normalizer"]),
            update_idx=int(ck["update_idx"]), elo=ck["elo"],
            hyper_params=ck["hyper_params"],
            past_ptr=int(ck["past_ptr"]),
            past_params=ck.get("past_params", ts.past_params))


def _stack(steps: List[Dict[str, Any]], lead):
    """Per-step (nested) dicts of tensors -> leaves [*lead, ...]."""
    first = steps[0]
    if isinstance(first, dict):
        return {k: _stack([s[k] for s in steps], lead) for k in first}
    x = torch.stack(steps)
    return x.reshape(tuple(lead) + x.shape[1:])
