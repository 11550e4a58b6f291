"""The full-team policy: one policy controls a whole team (the JAX
package's train/full_team_policy.py, a re-build of the reference's
scripts/jax_full_team_policy.py over the full-team observations of
sim/full_team.py).

- a conv stack over each member's lidar (:109-140): 3 x Conv1d (kernel 3,
  stride 2, flax's "SAME" padding) across the lidar's width, its rows and
  channels flattened into the input channels;
- entity embeddings scattered into a 16 x 16 minimap by normalized
  position, a mean per cell over a background of the global features
  (build_map, :208-285), as one scatter-add of features and one of counts;
- a 3-layer strided conv backbone over the minimap (:287-316) gives the
  team's features, an LSTM(256) carries them;
- per-agent action heads over concat(team, agent) with a residual team
  connection (TeamDiscreteActor, :445-478); the critic on the team's
  features. The actor's minimap holds only the enemies the team knows
  about, the critic's every enemy.

Mixed precision as models.py runs it (a compute ``dtype``: float32,
bfloat16 or float16); the minimap's scatter and mean in float32. Layouts
follow PyTorch: Conv1d / Conv2d weights [out, in, k...], the flax kernels
transposed (convert.full_team_params_from_jax). Flax's "SAME" padding of
a stride-2 convolution pads 0 before and 1 after an even width, so every
convolution pads explicitly (F.pad), never with torch's symmetric
``padding``. The convolutions and the minimap's scatter-add replace no TPU
kernel: the JAX package computes them outside any Pallas kernel.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn
from torch.nn import functional as F

from ..sim.env import resolve_device
from .distributions import AIM_BUCKETS, DISCRETE_BUCKETS, ActorDistributions
from .models import (_SLOPE, DenseLayerCritic, DenseLayerDiscreteActor,
                     PolicyLSTM, check_dtype, dense, layer_norm, norm)
from .policy import _seeded_init

MINIMAP_RES = 16
TEAM_RNN_HIDDEN = 256
EMBED_CH = 64
LIDAR_CH = 16
GLOBAL_DIM = 16

FULL_TEAM_OBS_KEYS = (
    "full_team_global",
    "full_team_players",
    "full_team_enemies",
    "full_team_last_known_enemies",
    "full_team_fwd_lidar",
    "full_team_rear_lidar",
)


def _same_pad(n: int, k: int, s: int):
    """flax's "SAME" padding of a width n: (before, after)."""
    out = -(-n // s)
    pad = max((out - 1) * s + k - n, 0)
    return pad // 2, pad - pad // 2


def conv(layer, x, dtype: torch.dtype, stride: int = 2):
    """``layer`` (nn.Conv1d / nn.Conv2d, channels first) on x in the
    compute dtype, "SAME"-padded as flax pads; below float32 the bias is
    added after the convolution's result has been rounded, as flax adds
    it."""
    k = layer.weight.shape[2:]
    pads = []
    for n, kk in reversed(list(zip(x.shape[2:], k))):
        pads += _same_pad(n, kk, stride)
    fn = F.conv1d if x.dim() == 3 else F.conv2d
    x = F.pad(x.to(dtype), pads)
    w, b = layer.weight.to(dtype), layer.bias.to(dtype)
    if dtype == torch.float32:
        return fn(x, w, b, stride=stride)
    return fn(x, w, stride=stride) + b.reshape(-1, *([1] * len(k)))


def _leaky(x, dtype):
    return F.leaky_relu(x, _SLOPE[dtype])


class LidarConv(nn.Module):
    """3 x (Conv1d k3 s2 + leaky_relu but the last) over the lidar's width,
    then LayerNorm + leaky_relu (jax_full_team_policy.py:104-140)."""

    def __init__(self, height: int, width: int, channels: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = check_dtype(dtype)
        self.convs = nn.ModuleList(
            nn.Conv1d(height * channels if i == 0 else LIDAR_CH, LIDAR_CH, 3)
            for i in range(3))
        for _ in range(3):
            width = -(-width // 2)
        self.out_dim = width * LIDAR_CH
        self.ln = layer_norm(self.out_dim)

    def forward(self, lidar):
        """[..., H, W, C] -> [..., W' * 16]: the rows and channels of a
        column are its input channels (h-major), the output flattened
        column-major (w-major) as flax reshapes [W', 16]."""
        batch = lidar.shape[:-3]
        H, W, C = lidar.shape[-3:]
        x = lidar.transpose(-2, -3).reshape(-1, W, H * C).transpose(1, 2)
        for i, c in enumerate(self.convs):
            x = conv(c, x, self.dtype)
            if i < 2:
                x = _leaky(x, self.dtype)
        x = x.transpose(1, 2).reshape(*batch, -1)
        return _leaky(norm(self.ln, x, self.dtype), self.dtype)


class EmbedEntities(nn.Module):
    """Dense (with bias) + LayerNorm + leaky_relu."""

    def __init__(self, in_features: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = check_dtype(dtype)
        self.dense = nn.Linear(in_features, EMBED_CH)
        self.ln = layer_norm(EMBED_CH)

    def forward(self, x):
        return _leaky(norm(self.ln, dense(self.dense, x, self.dtype),
                           self.dtype), self.dtype)


def obs_dims(team_size: int):
    """Feature widths of (players, enemies, last-known enemies)."""
    common = 14 + team_size
    return common + 4, common + 3 + team_size, common


class TeamPrefixCommon(nn.Module):
    """The shared embedding of the full-team observation groups
    (jax_full_team_policy.py:92-204)."""

    def __init__(self, team_size: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = check_dtype(dtype)
        self.team_size = team_size
        my, enemy, lk = obs_dims(team_size)
        self.global_embed = nn.Linear(GLOBAL_DIM, EMBED_CH)
        self.my_embed = EmbedEntities(my, dtype)
        self.enemy_embed = EmbedEntities(enemy, dtype)
        self.last_known_enemy_embed = EmbedEntities(lk, dtype)
        self.fwd_lidar_conv = LidarConv(2, 32, dtype=dtype)
        self.rear_lidar_conv = LidarConv(2, 8, dtype=dtype)
        # a member's features: its embedding and its two lidars'
        self.agent_dim = (EMBED_CH + self.fwd_lidar_conv.out_dim
                          + self.rear_lidar_conv.out_dim)

    def forward(self, obs: Dict[str, torch.Tensor]):
        my = obs["full_team_players"]
        enemy = obs["full_team_enemies"]
        lk = obs["full_team_last_known_enemies"]
        # positions at the common observation's offset isValid + id[ts] +
        # isAlive (static_assert types.hpp:1084-1085)
        off = 2 + self.team_size
        return {
            "global_features": dense(self.global_embed,
                                     obs["full_team_global"], self.dtype),
            "my_features": self.my_embed(my),
            "my_lidar": torch.cat([
                self.fwd_lidar_conv(obs["full_team_fwd_lidar"]),
                self.rear_lidar_conv(obs["full_team_rear_lidar"])], -1),
            "enemy_features": self.enemy_embed(enemy),
            "last_known_enemy_features": self.last_known_enemy_embed(lk),
            "my_positions": my[..., off:off + 3],
            "enemy_positions": enemy[..., off:off + 3],
            "last_known_enemy_positions": lk[..., off:off + 3],
            # teamKnowsLocation, the enemy observation's last field
            "enemy_mask": enemy[..., -1:],
        }


def build_minimap(global_features, entity_features, entity_positions,
                  entity_valid):
    """The mean of the entity embeddings of each of 16 x 16 cells over a
    background of the global features, which counts as one entity
    (build_map, jax_full_team_policy.py:208-285): global_features [B, C],
    entity_features [B, N, C], entity_positions [B, N, 3] normalized,
    entity_valid [B, N] (1.0 where the entity lands on the map) -> [B, 16,
    16, C] in the entities' dtype. Sums in float32 by index_add: in index
    order on the CPU, by atomics (in any order) on CUDA."""
    B, N, C = entity_features.shape
    res = MINIMAP_RES
    dev = entity_features.device
    ix = torch.clamp((entity_positions[..., 0] * res).to(torch.int32), 0,
                     res - 1)
    iy = torch.clamp((entity_positions[..., 1] * res).to(torch.int32), 0,
                     res - 1)
    cell = (torch.arange(B, device=dev)[:, None] * (res * res)
            + (iy * res + ix)).reshape(-1)
    valid = entity_valid.to(torch.float32)
    feats = entity_features.to(torch.float32) * valid[..., None]
    base = global_features.to(torch.float32)[:, None, :].expand(
        B, res * res, C).reshape(B * res * res, C)
    summed = base.index_add(0, cell, feats.reshape(B * N, C))
    counts = torch.ones(B * res * res, device=dev).index_add(
        0, cell, valid.reshape(-1))
    return (summed / counts[:, None]).reshape(B, res, res, C).to(
        entity_features.dtype)


class ConvBackbone(nn.Module):
    """3 strided 3 x 3 convolutions over the minimap, LayerNorm and
    leaky_relu (jax_full_team_policy.py:287-316): [B, 16, 16, C] ->
    [B, 256], flattened (h, w, c) as flax reshapes."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = check_dtype(dtype)
        self.convs = nn.ModuleList([nn.Conv2d(EMBED_CH, 32, 3),
                                    nn.Conv2d(32, 64, 3),
                                    nn.Conv2d(64, 64, 3)])
        side = MINIMAP_RES // 8
        self.ln = layer_norm(64 * side * side)

    def forward(self, minimap):
        x = minimap.permute(0, 3, 1, 2)
        for i, c in enumerate(self.convs):
            x = conv(c, x, self.dtype)
            if i < 2:
                x = _leaky(x, self.dtype)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return _leaky(norm(self.ln, x, self.dtype), self.dtype)


class TeamNet(nn.Module):
    """Minimap + conv backbone -> (team features [..., 256], agent
    features [..., ts, 64 + lidar]) (TeamActorNet / TeamCriticNet,
    jax_full_team_policy.py:319-443). The critic's minimap holds every
    enemy (mask_enemies=False)."""

    def __init__(self, mask_enemies: bool, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.mask_enemies = mask_enemies
        self.backbone = ConvBackbone(dtype)

    def forward(self, feats):
        my = feats["my_features"]
        batch = my.shape[:-2]
        ts, C = my.shape[-2:]

        def flat(x):
            return x.reshape(-1, *x.shape[len(batch):])

        ones = torch.ones(flat(my).shape[:-1], device=my.device)
        mask = flat(feats["enemy_mask"])[..., 0]
        enemy_valid = mask if self.mask_enemies else torch.ones_like(mask)
        # my players, the enemies and the last-known enemies on one axis;
        # my players and the last-known ones always land on the map
        ent_feats = torch.cat([flat(my), flat(feats["enemy_features"]),
                               flat(feats["last_known_enemy_features"])],
                              dim=-2)
        ent_pos = torch.cat([flat(feats["my_positions"]),
                             flat(feats["enemy_positions"]),
                             flat(feats["last_known_enemy_positions"])],
                            dim=-2)
        ent_valid = torch.cat([ones, enemy_valid.to(torch.float32), ones],
                              dim=-1)
        minimap = build_minimap(flat(feats["global_features"]), ent_feats,
                                ent_pos, ent_valid)
        team = self.backbone(minimap)
        team = team.reshape(*batch, team.shape[-1])
        return team, torch.cat([my, feats["my_lidar"]], dim=-1)


class TeamActorHead(nn.Module):
    """Per-agent heads over concat(team, agent) with a residual team
    connection (TeamDiscreteActor, jax_full_team_policy.py:445-478)."""

    def __init__(self, agent_dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = check_dtype(dtype)
        self.actor_merge = nn.Linear(TEAM_RNN_HIDDEN + agent_dim,
                                     TEAM_RNN_HIDDEN)
        self.ln = layer_norm(TEAM_RNN_HIDDEN)
        self.discrete = DenseLayerDiscreteActor(TEAM_RNN_HIDDEN,
                                                DISCRETE_BUCKETS, dtype)
        self.aim = DenseLayerDiscreteActor(TEAM_RNN_HIDDEN, AIM_BUCKETS,
                                           dtype)

    def forward(self, team, agent):
        team_b = team[..., None, :].expand(*agent.shape[:-1],
                                           team.shape[-1])
        x = dense(self.actor_merge, torch.cat([team_b, agent], dim=-1),
                  self.dtype)
        x = _leaky(norm(self.ln, x, self.dtype), self.dtype)
        x = team[..., None, :] + x
        return ActorDistributions(discrete=self.discrete(x),
                                  aim=self.aim(x))


class FullTeamActorCriticNet(nn.Module):
    """Separate actor and critic team encoders over the minimap with an
    LSTM(256) each on the team features (make_policy,
    jax_full_team_policy.py:489-560), in the compute ``dtype``. A batch
    row is a team: observations [B, ...] as Env's [W, 2, ...] flattened
    to B = 2 W."""

    def __init__(self, team_size: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = check_dtype(dtype)
        self.team_size = team_size
        self.prefix = TeamPrefixCommon(team_size, dtype)
        self.actor_net = TeamNet(True, dtype)
        self.critic_net = TeamNet(False, dtype)
        self.actor_rnn = PolicyLSTM(TEAM_RNN_HIDDEN, TEAM_RNN_HIDDEN, dtype)
        self.critic_rnn = PolicyLSTM(TEAM_RNN_HIDDEN, TEAM_RNN_HIDDEN, dtype)
        self.actor_head = TeamActorHead(self.prefix.agent_dim, dtype)
        self.critic_head = DenseLayerCritic(TEAM_RNN_HIDDEN, dtype)

    def _encode(self, obs):
        feats = self.prefix(obs)
        a_team, a_agent = self.actor_net(feats)
        c_team, _ = self.critic_net(feats)
        return a_team, a_agent, c_team

    def forward(self, rnn_states, obs: Dict[str, torch.Tensor]):
        """One step over [B, ...] observations; rnn_states [2 (actor /
        critic), 2 (c / h), B, 256] -> (per-agent ActorDistributions
        [B, ts, ...], team value [B], new rnn_states)."""
        a_team, a_agent, c_team = self._encode(obs)
        a_out, a_state = self.actor_rnn(rnn_states[0], a_team)
        c_out, c_state = self.critic_rnn(rnn_states[1], c_team)
        return (self.actor_head(a_out, a_agent), self.critic_head(c_out),
                torch.stack([a_state, c_state]))

    def sequence(self, rnn_start_states, dones, obs_seq, actions):
        """BPTT over [T, B, ...]: dones [T, B], actions {"discrete": [T, B,
        ts, 4], "aim": [T, B, ts, 2]} -> (log_probs, entropies [T, B, ts]
        per group, values [T, B])."""
        a_team, a_agent, c_team = self._encode(obs_seq)
        a_outs = self.actor_rnn.sequence(rnn_start_states[0], dones, a_team)
        c_outs = self.critic_rnn.sequence(rnn_start_states[1], dones,
                                          c_team)
        log_probs, entropies = self.actor_head(a_outs, a_agent).action_stats(
            actions)
        return log_probs, entropies, self.critic_head(c_outs)


def init_team_rnn_states(batch_shape, device=None) -> torch.Tensor:
    """[2 (actor / critic), 2 (c / h), *batch, 256] float32 zeros."""
    return torch.zeros((2, 2, *batch_shape, TEAM_RNN_HIDDEN),
                       dtype=torch.float32, device=device)


def team_obs(obs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Env's full-team observations [W, 2, ...] -> the policy's batch of
    teams [2 W, ...]."""
    return {k: obs[k].reshape(-1, *obs[k].shape[2:])
            for k in FULL_TEAM_OBS_KEYS}


def env_actions(actions: Dict[str, torch.Tensor], template):
    """The policy's per-agent actions {"discrete": [2 W, ts, 4], "aim":
    [2 W, ts, 2]} -> Env.step's Actions [W, 2 ts] (member i of team t is
    agent t * ts + i), the aim rates those of ``template``
    (Env.zero_actions())."""
    W = template.move_amount.shape[0]
    da = actions["discrete"].reshape(W, -1, 4).to(torch.int32)
    aa = actions["aim"].reshape(W, -1, 2).to(torch.int32)
    return template.replace(
        move_amount=da[..., 0], move_angle=da[..., 1], fire=da[..., 2],
        stand=da[..., 3], aim_yaw=aa[..., 0], aim_pitch=aa[..., 1])


def build_full_team_policy(team_size: int,
                           state_dict: Optional[Dict[str, torch.Tensor]]
                           = None, seed: int = 0, device=None,
                           dtype: torch.dtype = torch.float32
                           ) -> FullTeamActorCriticNet:
    """The policy on ``device`` (None: the first CUDA device, raising
    without one) computing in ``dtype``, with ``state_dict`` (e.g. from
    convert.full_team_params_from_jax) or else weights made from
    ``seed``."""
    dev = resolve_device(device)
    net = FullTeamActorCriticNet(team_size, dtype)
    if state_dict is None:
        _seeded_init(net, seed)
    else:
        net.load_state_dict(state_dict)
    return net.to(dev)
