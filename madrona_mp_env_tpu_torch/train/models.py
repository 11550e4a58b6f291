"""Network building blocks of the policy (the JAX package's
train/models.py): dense + LayerNorm + LeakyReLU stacks, the LSTM policy
RNN and the dense actor and critic heads.

Mixed precision as flax runs it: every block takes a compute ``dtype``
(float32, bfloat16 or float16). Parameters stay float32; a dense layer
casts its input, kernel and bias to the compute dtype and multiplies in
it (flax Dense's promote_dtype); a LayerNorm takes its statistics in
float32 with float32 scale and bias and returns the compute dtype; the
LSTM carries its state in float32 and steps in the compute dtype; the
heads return float32. At float32 every cast is a no-op.

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
DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def rounded(x: float, dtype: torch.dtype) -> float:
    """A Python constant rounded to dtype, as jnp rounds a weakly typed
    scalar to the array's dtype (bf16 0.01 is 0.010009765625)."""
    return torch.tensor(x, dtype=dtype).item()


_SLOPE = {dt: rounded(LEAKY_SLOPE, dt) for dt in DTYPES}


def check_dtype(dtype: torch.dtype) -> torch.dtype:
    if dtype not in DTYPES:
        raise ValueError(f"compute dtype {dtype} is not one of {DTYPES}")
    return dtype


def layer_norm(num_features: int) -> nn.LayerNorm:
    return nn.LayerNorm(num_features, eps=LN_EPS)


def linear(x, weight, bias=None):
    """x @ weight.T + bias. Below float32 the bias is added after the
    product has been rounded to x's dtype, as XLA adds it (ATen's fused
    addmm rounds once)."""
    if x.dtype == torch.float32 or bias is None:
        return F.linear(x, weight, bias)
    return F.linear(x, weight) + bias


def dense(layer: nn.Linear, x, dtype: torch.dtype):
    """``layer`` on x in the compute dtype: input, weight and bias cast to
    it, the product taken in it."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return linear(x.to(dtype), layer.weight.to(dtype), bias)


def norm(ln: nn.LayerNorm, x, dtype: torch.dtype):
    """``ln`` in float32 (statistics, scale and bias), cast to dtype."""
    return ln(x.to(torch.float32)).to(dtype)


class EmbedBlock(nn.Module):
    """Dense (no bias) + LayerNorm + LeakyReLU."""

    def __init__(self, in_features: int, num_channels: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = check_dtype(dtype)
        self.dense = nn.Linear(in_features, num_channels, bias=False)
        self.ln = layer_norm(num_channels)

    def forward(self, x):
        x = norm(self.ln, dense(self.dense, x, self.dtype), self.dtype)
        return F.leaky_relu(x, _SLOPE[self.dtype])


class MLP(nn.Module):
    """num_layers x (Dense + LayerNorm + LeakyReLU)."""

    def __init__(self, in_features: int, num_channels: int, num_layers: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.layers = nn.ModuleList(
            EmbedBlock(in_features if i == 0 else num_channels, num_channels,
                       dtype)
            for i in range(num_layers))

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return x


class PolicyLSTM(nn.Module):
    """Single-layer LSTM + LayerNorm on the output. The hidden state is
    (c, h) stacked on a leading axis, [2, B, H], float32 between steps and
    cast to the compute dtype for each step. Gates in flax's
    OptimizedLSTMCell order (i, f, g, o) and its operation order:
    y = (h @ Wh + b) + x @ Wi."""

    def __init__(self, in_features: int, hidden_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = check_dtype(dtype)
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
        dt = self.dtype
        c, h = rnn_state[0].to(dt), rnn_state[1].to(dt)
        y = dense(self.h_proj, h, dt) + dense(self.x_proj, x, dt)
        new_c, new_h = self._gates(y, c)
        return (norm(self.out_ln, new_h, dt),
                torch.stack([new_c, new_h]).to(torch.float32))

    def sequence(self, rnn_start_state, dones, xs):
        """BPTT over xs [T, B, C] from rnn_start_state [2, B, H], zeroing
        the state after steps where dones [T, B] != 0 -> outputs [T, B,
        H]. The x-projection of all T steps is one matmul; each step adds
        only the h-recurrence, and the LayerNorm runs over [T, B, H] at
        once."""
        dt = self.dtype
        xp = dense(self.x_proj, xs, dt)
        wh, bh = self.h_proj.weight.to(dt), self.h_proj.bias.to(dt)
        c, h = rnn_start_state[0].to(dt), rnn_start_state[1].to(dt)
        outs = []
        for t in range(xs.shape[0]):
            c, h = self._gates(linear(h, wh, bh) + xp[t], c)
            outs.append(h)
            ended = (dones[t] != 0)[..., None]
            c = torch.where(ended, 0.0, c)
            h = torch.where(ended, 0.0, h)
        return norm(self.out_ln, torch.stack(outs), dt)


class DenseLayerDiscreteActor(nn.Module):
    """Packed per-head logits from one dense layer, float32."""

    def __init__(self, in_features: int, buckets: Sequence[int],
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = check_dtype(dtype)
        self.buckets = tuple(buckets)
        self.dense = nn.Linear(in_features, sum(self.buckets))

    def forward(self, features):
        logits = dense(self.dense, features, self.dtype).to(torch.float32)
        return DiscreteActionDistributions(logits=logits,
                                           buckets=self.buckets)


class DenseLayerCritic(nn.Module):
    """Scalar float32 value from one dense layer."""

    def __init__(self, in_features: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = check_dtype(dtype)
        self.dense = nn.Linear(in_features, 1)

    def forward(self, features):
        return dense(self.dense, features, self.dtype)[..., 0].to(
            torch.float32)
