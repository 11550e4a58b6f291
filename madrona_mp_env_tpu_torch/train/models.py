"""Network building blocks of the policy (the JAX package's
train/models.py): dense + LayerNorm + LeakyReLU stacks, the LSTM policy
RNN and the dense actor and critic heads, all in float32.

Layouts follow PyTorch: a Linear's weight is [out, in] (the flax kernel
transposed, see convert.py). The DreamerV3 / HLGauss critics and
EntitySelfAttentionNet come later (ROADMAP M15).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F

from .distributions import DiscreteActionDistributions

LN_EPS = 1e-6  # flax.linen.LayerNorm's epsilon
LEAKY_SLOPE = 0.01  # flax.linen.leaky_relu's negative slope


def layer_norm(num_features: int) -> nn.LayerNorm:
    return nn.LayerNorm(num_features, eps=LN_EPS)


class EmbedBlock(nn.Module):
    """Dense (no bias) + LayerNorm + LeakyReLU."""

    def __init__(self, in_features: int, num_channels: int):
        super().__init__()
        self.dense = nn.Linear(in_features, num_channels, bias=False)
        self.ln = layer_norm(num_channels)

    def forward(self, x):
        return F.leaky_relu(self.ln(self.dense(x)), LEAKY_SLOPE)


class MLP(nn.Module):
    """num_layers x (Dense + LayerNorm + LeakyReLU)."""

    def __init__(self, in_features: int, num_channels: int, num_layers: int):
        super().__init__()
        self.layers = nn.ModuleList(
            EmbedBlock(in_features if i == 0 else num_channels, num_channels)
            for i in range(num_layers))

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return x


class PolicyLSTM(nn.Module):
    """Single-layer LSTM + LayerNorm on the output. The hidden state is
    (c, h) stacked on a leading axis, [2, B, H]. Gates in flax's
    OptimizedLSTMCell order (i, f, g, o) and its operation order:
    y = (h @ Wh + b) + x @ Wi."""

    def __init__(self, in_features: int, hidden_dim: int):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.x_proj = nn.Linear(in_features, 4 * hidden_dim, bias=False)
        self.h_proj = nn.Linear(hidden_dim, 4 * hidden_dim, bias=True)
        self.out_ln = layer_norm(hidden_dim)

    @staticmethod
    def clear_state(rnn_state, should_clear):
        """Zero the state where episodes ended; should_clear [B]."""
        return torch.where(should_clear[None, ..., None], 0.0, rnn_state)

    def _gates(self, y, c):
        """y: pre-activation [B, 4H] in (i, f, g, o) order -> (c, h)."""
        i, f, g, o = torch.split(y, self.hidden_dim, dim=-1)
        new_c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return new_c, torch.sigmoid(o) * torch.tanh(new_c)

    def forward(self, rnn_state, x):
        c, h = rnn_state[0], rnn_state[1]
        new_c, new_h = self._gates(self.h_proj(h) + self.x_proj(x), c)
        return self.out_ln(new_h), torch.stack([new_c, new_h])

    def sequence(self, rnn_start_state, dones, xs):
        """BPTT over xs [T, B, C] from rnn_start_state [2, B, H], zeroing
        the state after steps where dones [T, B] != 0 -> outputs [T, B,
        H]. The x-projection of all T steps is one matmul; each step adds
        only the h-recurrence, and the LayerNorm runs over [T, B, H] at
        once."""
        xp = self.x_proj(xs)
        c, h = rnn_start_state[0], rnn_start_state[1]
        outs = []
        for t in range(xs.shape[0]):
            c, h = self._gates(self.h_proj(h) + xp[t], c)
            outs.append(h)
            ended = (dones[t] != 0)[..., None]
            c = torch.where(ended, 0.0, c)
            h = torch.where(ended, 0.0, h)
        return self.out_ln(torch.stack(outs))


class DenseLayerDiscreteActor(nn.Module):
    """Packed per-head logits from one dense layer."""

    def __init__(self, in_features: int, buckets: Sequence[int]):
        super().__init__()
        self.buckets = tuple(buckets)
        self.dense = nn.Linear(in_features, sum(self.buckets))

    def forward(self, features):
        return DiscreteActionDistributions(logits=self.dense(features),
                                           buckets=self.buckets)


class DenseLayerCritic(nn.Module):
    """Scalar value from one dense layer."""

    def __init__(self, in_features: int):
        super().__init__()
        self.dense = nn.Linear(in_features, 1)

    def forward(self, features):
        return self.dense(features)[..., 0]
