"""Multiresolution hash-grid positional encoder (instant-NGP style): the
JAX package's train/hash_encoder.py.

L levels of grid resolution from N_min to N_max (geometric), each with a
table of T entries of F features. A position in [0, 1]^dim takes the 2^dim
corners of its cell at every level, hashes each corner (coordinates times
the primes [1, 2654435761, 805459861], XORed, masked to T - 1), gathers
the corners' features and interpolates them dim-linearly. The hash's
uint32 products wrap: here they run in int64 and are masked to 32 bits
before the XOR, so every device gives the same indices.

Reference: Müller et al., "Instant Neural Graphics Primitives with a
Multiresolution Hash Encoding" (SIGGRAPH 2022).
"""

from __future__ import annotations

import math
from typing import List

import torch
from torch import nn

PRIMES = (1, 2654435761, 805459861)  # one per input dimension
_M32 = 0xFFFFFFFF


class HashGridEncoder(nn.Module):
    """Encode positions [..., dim] in [0, 1] to [..., L * F] float32
    features. ``hash_table`` [L, T, F] starts uniform in [0, 1e-4), as
    flax's initializer draws it (from ``seed`` here)."""

    def __init__(self, dim: int = 3, num_levels: int = 8,
                 table_size: int = 2 ** 14, num_features: int = 2,
                 min_resolution: int = 4, max_resolution: int = 256,
                 seed: int = 0):
        super().__init__()
        if dim > len(PRIMES):
            raise ValueError(f"dim {dim} > {len(PRIMES)} primes")
        if table_size & (table_size - 1):
            raise ValueError("table_size must be a power of two")
        self.dim, self.num_levels = dim, num_levels
        self.table_size, self.num_features = table_size, num_features
        self.min_resolution, self.max_resolution = (min_resolution,
                                                    max_resolution)
        g = torch.Generator().manual_seed(seed)
        self.hash_table = nn.Parameter(
            torch.rand((num_levels, table_size, num_features), generator=g)
            * 1e-4)

    @property
    def growth_factor(self) -> float:
        if self.num_levels == 1:
            return 1.0
        return math.exp((math.log(self.max_resolution)
                         - math.log(self.min_resolution))
                        / (self.num_levels - 1))

    def resolutions(self) -> List[int]:
        b = self.growth_factor
        return [int(math.floor(self.min_resolution * (b ** l)))
                for l in range(self.num_levels)]

    def forward(self, pos: torch.Tensor) -> torch.Tensor:
        L, T, F, D = (self.num_levels, self.table_size, self.num_features,
                      self.dim)
        dev = self.hash_table.device
        batch_shape = pos.shape[:-1]
        p = pos.reshape(-1, D).to(torch.float32)  # [B, D]
        res = torch.tensor(self.resolutions(), dtype=torch.float32,
                           device=dev)
        scaled = p[:, None, :] * res[None, :, None]  # [B, L, D]
        lo = torch.floor(scaled)
        frac = scaled - lo
        # the 2^D corner offsets [C, D], the last dimension fastest
        corners = torch.cartesian_prod(
            *([torch.arange(2, device=dev)] * D)).reshape(-1, D)
        coords = (lo.to(torch.int64)[:, :, None, :]
                  + corners[None, None]) & _M32  # [B, L, C, D]
        primes = torch.tensor(PRIMES[:D], dtype=torch.int64, device=dev)
        h = (coords * primes) & _M32
        idx = h[..., 0]
        for d in range(1, D):
            idx = idx ^ h[..., d]
        idx = idx & (T - 1)  # [B, L, C]
        levels = torch.arange(L, device=dev)[None, :, None]
        vals = self.hash_table[levels, idx]  # [B, L, C, F]
        # dim-linear weights [B, L, C]
        w = torch.ones(idx.shape, dtype=torch.float32, device=dev)
        for d in range(D):
            fd = frac[:, :, None, d]
            cd = corners[None, None, :, d].to(torch.float32)
            w = w * (cd * fd + (1.0 - cd) * (1.0 - fd))
        # the corners summed in order, as XLA's CPU reduction of a short
        # axis runs
        terms = vals * w[..., None]
        out = terms[:, :, 0]
        for c in range(1, terms.shape[2]):
            out = out + terms[:, :, c]  # [B, L, F]
        return out.reshape(*batch_shape, L * F)
