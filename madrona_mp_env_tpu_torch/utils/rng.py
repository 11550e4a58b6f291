"""Counter-based RNG: a bit-exact threefry2x32 in PyTorch.

Reproduces ``jax.random`` with ``jax_threefry_partitionable=True`` (the
default from jax 0.5 on): ``fold_in``, ``split``, ``uniform`` and
``randint`` and ``permutation`` give the same bits as the JAX package, so the port's spawns,
resets and recoil draw the same numbers from the same keys.

A key is an int64 tensor ``[..., 2]`` holding the two uint32 words of the
raw key data; all uint32 arithmetic runs in int64 and is masked back to 32
bits. Every function is batched over the key's leading dims (one key per
world in the sim), which replaces ``vmap`` over per-world keys.

The keying discipline mirrors the reference's auditable rand::split_i
chains (reference src/sim.cpp:743-749): every draw is keyed by
(seed, episode, world, step, system).
"""

from __future__ import annotations

import math

import torch

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


class Salt:
    """System salts for per-step keys (ordering-independent streams)."""

    INIT_WORLD = 0
    SPAWN = 1
    FIRE = 2
    BOT = 3
    CURRICULUM = 4
    RESET = 5


def _u32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int64) & _M32


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds (Salmon et al. 2011), as jax.random's
    threefry2x32_p. All args are int64 tensors of uint32 values that
    broadcast together; returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + k0) & _M32
    x1 = (x1 + k1) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def prng_key(seed: int, device=None) -> torch.Tensor:
    """jax.random.PRNGKey(seed) raw key data, as int64 [2]."""
    return torch.tensor(
        [(seed >> 32) & _M32, seed & _M32], dtype=torch.int64, device=device
    )


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """jax.random.fold_in: key [..., 2], data int (or tensor broadcasting
    against the key's batch dims) -> key [..., 2]."""
    data = _u32(data).to(key.device)
    y0, y1 = threefry2x32(
        key[..., 0], key[..., 1], torch.zeros_like(data), data
    )
    return torch.stack([y0, y1], dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """jax.random.split (partitionable): key [..., 2] -> [..., num, 2];
    subkey i is threefry(key, (0, i)), the same as fold_in(key, i)."""
    i = torch.arange(num, dtype=torch.int64, device=key.device)
    k0 = key[..., 0:1]
    k1 = key[..., 1:2]
    y0, y1 = threefry2x32(k0, k1, torch.zeros_like(i), i)
    return torch.stack([y0, y1], dim=-1)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """32 random bits per element: key [..., 2] -> [..., *shape] (uint32
    values in int64). The counter of element j is its row-major index."""
    shape = tuple(shape)
    n = 1
    for s in shape:
        n *= s
    idx = torch.arange(n, dtype=torch.int64, device=key.device).reshape(shape)
    batch = key.shape[:-1]
    k0 = key[..., 0].reshape(batch + (1,) * len(shape))
    k1 = key[..., 1].reshape(batch + (1,) * len(shape))
    y0, y1 = threefry2x32(k0, k1, torch.zeros_like(idx), idx)
    return y0 ^ y1


def uniform(key: torch.Tensor, shape=(), minval=0.0, maxval=1.0
            ) -> torch.Tensor:
    """jax.random.uniform, float32: key [..., 2] -> [..., *shape]. XLA
    evaluates floats * (hi - lo) + lo as one fused multiply-add; the
    float64 product and sum rounded once to float32 reproduce it."""
    bits = random_bits(key, shape)
    fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = fbits.view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=key.device)
    scaled = floats.double() * (hi - lo).double() + lo.double()
    return torch.maximum(lo, scaled.float())


def randint(key: torch.Tensor, shape, minval: int, maxval: int
            ) -> torch.Tensor:
    """jax.random.randint, int32, for int32-range bounds: key [..., 2] ->
    [..., *shape]. Two 32-bit draws per value, reduced mod the span."""
    ks = split(key, 2)
    hi_bits = random_bits(ks[..., 0, :], shape)
    lo_bits = random_bits(ks[..., 1, :], shape)
    span = (maxval - minval) & _M32 if maxval > minval else 1
    mult = (2 ** 16) % span
    mult = ((mult * mult) & _M32) % span
    off = (((hi_bits % span) * mult) & _M32) + (lo_bits % span)
    off = (off & _M32) % span
    return (minval + off).to(torch.int32)


def episode_key(init_key: torch.Tensor, episode_idx, world_idx
                ) -> torch.Tensor:
    """Raw key data of an episode's base key, batched over worlds."""
    return fold_in(fold_in(init_key, episode_idx), world_idx)


def step_key(episode_key_data: torch.Tensor, cur_step) -> torch.Tensor:
    """Key for one sim step of one world."""
    return fold_in(episode_key_data, cur_step)


def system_key(stepk: torch.Tensor, salt: int) -> torch.Tensor:
    return fold_in(stepk, salt)


def permutation(key: torch.Tensor, n: int) -> torch.Tensor:
    """jax.random.permutation(key, n): a permutation of arange(n), int64
    [n], for one key [2]. JAX's _shuffle: ceil(3 ln n / ln(2^32 - 1))
    rounds of (key, sub = split(key); a stable sort of the values by
    32-bit random_bits(sub))."""
    rounds = int(math.ceil(3 * math.log(max(1, n)) / math.log(_M32)))
    x = torch.arange(n, dtype=torch.int64, device=key.device)
    for _ in range(rounds):
        key, sub = split(key, 2)
        order = torch.sort(random_bits(sub, (n,)), stable=True).indices
        x = x[order]
    return x
