"""Network building blocks of the policy (the JAX package's
train/models.py): dense + LayerNorm + LeakyReLU stacks, the LSTM policy
RNN, the dense actor and critic heads, the DreamerV3 and HL-Gauss
critics (with symlog / symexp) and the EntitySelfAttentionNet backbone.

Mixed precision as flax runs it: every block takes a compute ``dtype``
(float32, bfloat16 or float16). Parameters stay float32; a dense layer
casts its input, kernel and bias to the compute dtype and multiplies in
it (flax Dense's promote_dtype); a LayerNorm takes its statistics in
float32 with float32 scale and bias and returns the compute dtype; the
LSTM carries its state in float32 and steps in the compute dtype; the
heads return float32. At float32 every cast is a no-op.

Layouts follow PyTorch: a Linear's weight is [out, in] (the flax kernel
transposed, see convert.py; a DenseGeneral kernel [in, heads, head_dim]
flattened to [in, heads * head_dim] first).
"""

from __future__ import annotations

from typing import Sequence

import math

import torch
from torch import nn
from torch.nn import functional as F

from ..utils import xla_math
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


def _sign(x):
    """jnp.sign: the sign of -0.0 is -0.0 (ATen's is +0.0)."""
    return torch.where(x == 0, x, torch.sign(x))


def symlog(x):
    """sign(x) * log1p(|x|) in float32, with XLA's CPU log1p."""
    return _sign(x) * xla_math.log1p(torch.abs(x))


def symexp(x):
    """sign(x) * (exp(|x|) - 1) in float32, with XLA's CPU exp."""
    return _sign(x) * (xla_math.exp(torch.abs(x)) - 1.0)


def softmax(logits):
    """jax.nn.softmax over the last axis of float32 logits: exp(x - max)
    (XLA's CPU exp) over its sum."""
    u = xla_math.exp(logits - logits.amax(-1, keepdim=True))
    return u / u.sum(-1, keepdim=True)


class DreamerV3Critic(nn.Module):
    """Two-hot categorical value over symlog-spaced bins (the JAX package's
    DreamerV3Critic): a dense layer with a zero-initialised kernel to
    ``num_bins`` float32 logits, softmax, then symexp(E[bin center])."""

    def __init__(self, in_features: int, dtype: torch.dtype = torch.float32,
                 num_bins: int = 255, low: float = -20.0, high: float = 20.0):
        super().__init__()
        self.dtype = check_dtype(dtype)
        self.num_bins, self.low, self.high = num_bins, low, high
        self.dense = nn.Linear(in_features, num_bins)
        nn.init.zeros_(self.dense.weight)
        nn.init.zeros_(self.dense.bias)

    def bin_centers(self, device=None) -> torch.Tensor:
        return torch.linspace(self.low, self.high, self.num_bins,
                              dtype=torch.float32, device=device)

    def forward(self, features):
        logits = dense(self.dense, features, self.dtype).to(torch.float32)
        centers = self.bin_centers(logits.device)
        return symexp((softmax(logits) * centers).sum(-1))

    def two_hot_target(self, value):
        """Two-hot encoding of symlog(value) over the bins [..., num_bins]
        (the target of a cross-entropy value loss)."""
        x = torch.clamp(symlog(value), self.low, self.high)
        span = torch.full((), self.high - self.low, dtype=torch.float32,
                          device=x.device)
        idx = (x - self.low) / span * (self.num_bins - 1)
        lo = torch.floor(idx).to(torch.int64)
        hi = torch.clamp(lo + 1, 0, self.num_bins - 1)
        w_hi = (idx - lo)[..., None]
        return (F.one_hot(lo, self.num_bins) * (1.0 - w_hi)
                + F.one_hot(hi, self.num_bins) * w_hi)


class HLGaussCritic(nn.Module):
    """Histogram-loss Gaussian critic (the JAX package's HLGaussCritic):
    ``num_bins`` float32 logits over [min_bound, max_bound], the value the
    softmax's expectation of the bin centers (the edges' midpoints)."""

    def __init__(self, in_features: int, dtype: torch.dtype = torch.float32,
                 min_bound: float = -200.0, max_bound: float = 200.0,
                 num_bins: int = 128):
        super().__init__()
        self.dtype = check_dtype(dtype)
        self.num_bins = num_bins
        self.min_bound, self.max_bound = min_bound, max_bound
        self.dense = nn.Linear(in_features, num_bins)
        nn.init.orthogonal_(self.dense.weight, gain=0.01)
        nn.init.zeros_(self.dense.bias)

    def bin_centers(self, device=None) -> torch.Tensor:
        edges = torch.linspace(self.min_bound, self.max_bound,
                               self.num_bins + 1, dtype=torch.float32,
                               device=device)
        return 0.5 * (edges[:-1] + edges[1:])

    def forward(self, features):
        logits = dense(self.dense, features, self.dtype).to(torch.float32)
        return (softmax(logits) * self.bin_centers(logits.device)).sum(-1)


class MultiHeadDotProductAttention(nn.Module):
    """flax's MultiHeadDotProductAttention as EntitySelfAttentionNet calls
    it: self-attention without a mask or dropout, query / key / value and
    out projections with biases, everything in the compute dtype (the
    query divided by sqrt(head_dim), the logits, the softmax and the
    weighted sum; flax does not force float32 for the softmax)."""

    def __init__(self, features: int, num_heads: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = check_dtype(dtype)
        self.num_heads = num_heads
        self.head_dim = features // num_heads
        self.query = nn.Linear(features, features)
        self.key = nn.Linear(features, features)
        self.value = nn.Linear(features, features)
        self.out = nn.Linear(features, features)

    def forward(self, x):
        dt = self.dtype
        heads = (self.num_heads, self.head_dim)
        q = dense(self.query, x, dt).unflatten(-1, heads)
        k = dense(self.key, x, dt).unflatten(-1, heads)
        v = dense(self.value, x, dt).unflatten(-1, heads)
        q = q / q.new_full((), math.sqrt(self.head_dim))
        w = torch.softmax(torch.einsum("...qhd,...khd->...hqk", q, k), -1)
        o = torch.einsum("...hqk,...khd->...qhd", w, v)
        return dense(self.out, o.flatten(-2), dt)


class EntitySelfAttentionNet(nn.Module):
    """Attention over entity tokens (the JAX package's
    EntitySelfAttentionNet, the alternative to MaxPoolNet): one token of
    [self, fwd lidar, rear lidar] and one per teammate, opponent and
    last-known opponent, each through its EmbedBlock; self-attention,
    LayerNorm(tokens + attention), the mean over the tokens, then an MLP
    of 2 layers. ``embeds`` are flax's EmbedBlock_0..3 in that order."""

    def __init__(self, channels: int, out_channels: int, num_heads: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = check_dtype(dtype)
        self.embeds = nn.ModuleList(
            EmbedBlock(3 * channels if i == 0 else channels, channels, dtype)
            for i in range(4))
        self.attn = MultiHeadDotProductAttention(channels, num_heads, dtype)
        self.ln = layer_norm(channels)
        self.mlp = MLP(channels, out_channels, 2, dtype)

    def forward(self, feats):
        dt = self.dtype
        self_tok = self.embeds[0](torch.cat(
            [feats["self"], feats["fwd_lidar"], feats["rear_lidar"]], -1))
        tokens = torch.cat([
            self_tok[..., None, :], self.embeds[1](feats["teammates"]),
            self.embeds[2](feats["opponents"]),
            self.embeds[3](feats["opponents_last_known"])], dim=-2)
        tokens = norm(self.ln, tokens + self.attn(tokens), dt)
        # jnp.mean upcasts a narrow float to float32 for the sum
        return self.mlp(tokens.to(torch.float32).mean(-2).to(dt))
