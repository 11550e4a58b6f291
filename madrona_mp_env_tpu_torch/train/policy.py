"""The per-agent actor-critic policy (the JAX package's train/policy.py).

Per-group observation embeddings with a 16-frequency sinusoidal position
encoding, opponent masking on the actor side, MaxPoolNet (self + lidars +
max-pool over entities -> MLP 512 x 3) feeding an LSTM(512) + LayerNorm,
separate actor and critic encoders, dense discrete heads {move: [3, 8, 3,
3], aim: [13, 7]} and a dense critic. Float32 throughout. Only the single
step the eval rollout runs is here; the BPTT ``sequence`` comes with the
trainer (ROADMAP M10).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

from .. import config as cfgmod
from .. import consts
from ..sim.env import resolve_device
from ..sim.types import OTHER_OB_DIM, SELF_OB_DIM
from .distributions import AIM_BUCKETS, DISCRETE_BUCKETS, ActorDistributions
from .models import (DenseLayerCritic, DenseLayerDiscreteActor, EmbedBlock,
                     MLP, PolicyLSTM)

RNN_HIDDEN = 512
EMBED_CHANNELS = 64
NUM_FREQS = 16
FWD_LIDAR_DIM = consts.fwd_lidar_height * consts.fwd_lidar_width * 4
REAR_LIDAR_DIM = consts.rear_lidar_height * consts.rear_lidar_width * 4


def sinusoidal_embedding(pos, num_freqs: int = NUM_FREQS):
    """[sin(p * 2^i * pi), cos(p * 2^i * pi)] for i < num_freqs / 2, each
    [..., D], concatenated in that order: [..., num_freqs * D]."""
    outs = []
    for i in range(num_freqs // 2):
        v = pos * (2.0 ** i) * math.pi
        outs.append(torch.sin(v))
        outs.append(torch.cos(v))
    return torch.cat(outs, dim=-1)


def _flat_lidar(x):
    """Structured [..., h, w, 4] lidar (env obs) or already flat
    [..., h * w * 4] (rollout buffers) -> flat."""
    if x.shape[-1] == 4:
        return x.reshape(*x.shape[:-3], -1)
    return x


class PrefixCommon(nn.Module):
    """Shared observation embedding."""

    def __init__(self, self_dim=SELF_OB_DIM, other_dim=OTHER_OB_DIM,
                 fwd_dim=FWD_LIDAR_DIM, rear_dim=REAR_LIDAR_DIM,
                 num_coefs=cfgmod.NUM_REWARD_COEFS, channels=EMBED_CHANNELS):
        super().__init__()
        self.fwd_lidar_embed = EmbedBlock(fwd_dim, channels)
        self.rear_lidar_embed = EmbedBlock(rear_dim, channels)
        self.self_embed = EmbedBlock(self_dim + num_coefs + 3 * NUM_FREQS,
                                     channels)
        self.teammates_embed = EmbedBlock(other_dim, channels)
        self.opponents_embed = EmbedBlock(other_dim, channels)
        self.opponents_last_known_embed = EmbedBlock(other_dim, channels)

    def forward(self, obs: Dict[str, torch.Tensor]):
        self_features = torch.cat(
            [obs["self"], obs["reward_coefs"],
             sinusoidal_embedding(obs["self_pos"])], dim=-1)
        return {
            "self": self.self_embed(self_features),
            "fwd_lidar": self.fwd_lidar_embed(_flat_lidar(obs["fwd_lidar"])),
            "rear_lidar": self.rear_lidar_embed(
                _flat_lidar(obs["rear_lidar"])),
            "teammates": self.teammates_embed(obs["teammates"]),
            "opponents": self.opponents_embed(obs["opponents"]),
            "opponents_last_known": self.opponents_last_known_embed(
                obs["opponents_last_known"]),
            "opponent_masks": obs["opponent_masks"],
        }


class MaxPoolNet(nn.Module):
    """concat(self, lidars, max-pool of each entity group) -> MLP 512 x 3."""

    def __init__(self, channels=EMBED_CHANNELS, width=RNN_HIDDEN):
        super().__init__()
        self.mlp = MLP(6 * channels, width, 3)

    def forward(self, feats):
        x = torch.cat([
            feats["self"], feats["fwd_lidar"], feats["rear_lidar"],
            feats["teammates"].amax(-2), feats["opponents"].amax(-2),
            feats["opponents_last_known"].amax(-2),
        ], dim=-1)
        return self.mlp(x)


class ActorCriticNet(nn.Module):
    """Prefix + (masked actor net + LSTM) and (critic net + LSTM), then the
    actor heads and the critic head."""

    def __init__(self):
        super().__init__()
        self.prefix = PrefixCommon()
        self.actor_net = MaxPoolNet()
        self.critic_net = MaxPoolNet()
        self.actor_rnn = PolicyLSTM(RNN_HIDDEN, RNN_HIDDEN)
        self.critic_rnn = PolicyLSTM(RNN_HIDDEN, RNN_HIDDEN)
        self.actor_head_discrete = DenseLayerDiscreteActor(RNN_HIDDEN,
                                                           DISCRETE_BUCKETS)
        self.actor_head_aim = DenseLayerDiscreteActor(RNN_HIDDEN, AIM_BUCKETS)
        self.critic_head = DenseLayerCritic(RNN_HIDDEN)

    def forward(self, rnn_states, obs: Dict[str, torch.Tensor]):
        """One step. rnn_states [2 (actor/critic), 2 (c/h), B, H] ->
        (ActorDistributions, value [B], new rnn_states)."""
        feats = self.prefix(obs)
        # the actor sees only the opponents its team knows about
        actor_feats = dict(feats)
        actor_feats["opponents"] = torch.where(
            feats["opponent_masks"][..., None] == 1.0, feats["opponents"],
            0.0)
        a_out, a_state = self.actor_rnn(rnn_states[0],
                                        self.actor_net(actor_feats))
        c_out, c_state = self.critic_rnn(rnn_states[1],
                                         self.critic_net(feats))
        dists = ActorDistributions(discrete=self.actor_head_discrete(a_out),
                                   aim=self.actor_head_aim(a_out))
        return dists, self.critic_head(c_out), torch.stack([a_state,
                                                            c_state])


def _seeded_init(net: ActorCriticNet, seed: int) -> None:
    """Weights from a seed (CPU generator, so every device gets the same
    values): each dense kernel N(0, gain^2 / fan_in) with flax's gains
    (sqrt(2) for the trunk, 1 for the LSTM and the heads), biases zero,
    LayerNorm scale one."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, mod in net.named_modules():
            if isinstance(mod, nn.Linear):
                gain = 1.0 if ("rnn" in name or "head" in name) else 2 ** 0.5
                w = torch.randn(mod.weight.shape, generator=g)
                mod.weight.copy_(w * (gain / mod.in_features ** 0.5))
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()


def build_actor_critic(state_dict: Optional[Dict[str, torch.Tensor]] = None,
                       seed: int = 0, device=None) -> ActorCriticNet:
    """The policy on ``device`` (None: the first CUDA device, raising
    without one) in eval mode, with ``state_dict`` (e.g. from
    convert.params_from_jax) or else weights made from ``seed``."""
    dev = resolve_device(device)
    net = ActorCriticNet()
    if state_dict is None:
        _seeded_init(net, seed)
    else:
        net.load_state_dict(state_dict)
    return net.to(dev).eval().requires_grad_(False)


def init_rnn_states(batch_shape, device=None) -> torch.Tensor:
    """[2 (actor/critic), 2 (c/h), *batch, H] float32 zeros."""
    return torch.zeros((2, 2, *batch_shape, RNN_HIDDEN), dtype=torch.float32,
                       device=device)


def clear_rnn_states(rnn_states, should_clear):
    return torch.where(should_clear[None, None, ..., None], 0.0, rnn_states)


def get_episode_scores(win_result):
    """ELO episode scores from the match winner: 1 / 0 / 0.5 per team,
    [2, ...]."""
    a = torch.where(win_result == 0, 1.0,
                    torch.where(win_result == 1, 0.0, 0.5))
    return torch.stack([a, 1.0 - a])
