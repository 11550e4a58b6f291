"""Population-based training: the parts the trainer's set-up reads (the
JAX package's train/pbt.py).

- ``ParamExplore``: per-policy hyperparameter ranges; initial values
  spread across the population (lr log-uniform x/÷10).
- ``PBTConfig`` and ``make_matchmaking``: the static world/team ->
  policy-slot routing by the self/cross/past play portions.

The population update (ELO-ranked truncation selection with perturbed
hyperparameters) and the past-policy history come with the PBT slice
(ROADMAP M10 rest).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from ..utils import rng


@dataclass(frozen=True)
class ParamExplore:
    base: float
    min_scale: float
    max_scale: float
    log10_scale: bool = False

    @property
    def lo(self) -> float:
        return self.base * self.min_scale

    @property
    def hi(self) -> float:
        return self.base * self.max_scale

    def init_values(self, key: torch.Tensor, num_policies: int
                    ) -> torch.Tensor:
        """Initial values [num_policies] f32 from one key: uniform between
        lo and hi, or log-uniform when log10_scale (the JAX draw)."""
        u = rng.uniform(key, (num_policies,))
        if self.log10_scale:
            lo, hi = math.log10(self.lo), math.log10(self.hi)
            return (10.0 ** (lo + u * (hi - lo))).to(torch.float32)
        return (self.lo + u * (self.hi - self.lo)).to(torch.float32)


@dataclass(frozen=True)
class PBTConfig:
    num_train_policies: int = 1
    num_past_policies: int = 0
    self_play_portion: float = 0.0
    cross_play_portion: float = 1.0
    past_play_portion: float = 0.0


def make_matchmaking(num_worlds: int, num_agents: int, team_size: int,
                     pbt: PBTConfig) -> Tuple[np.ndarray, np.ndarray]:
    """Static world/team -> policy-slot routing. Slots [0, E) are train
    policies, [E, E + P) frozen past policies. Worlds are split by the
    play portions (self, cross, past), round-robin within each. Returns
    (assignment [W, A] int32, worlds per kind [3])."""
    E = pbt.num_train_policies
    P = pbt.num_past_policies
    total = (pbt.self_play_portion + pbt.cross_play_portion
             + pbt.past_play_portion)
    if abs(total - 1.0) >= 1e-6:
        raise ValueError("play portions must sum to 1")
    if P == 0 and pbt.past_play_portion != 0.0:
        raise ValueError("past play needs past policies")

    w_self = int(round(num_worlds * pbt.self_play_portion))
    w_past = int(round(num_worlds * pbt.past_play_portion))
    w_cross = num_worlds - w_self - w_past

    w = np.arange(num_worlds)[:, None]
    team = np.arange(num_agents)[None, :] // team_size
    assign = np.zeros((num_worlds, num_agents), np.int64)
    # self-play worlds: both teams the same train policy
    sl = slice(0, w_self)
    assign[sl] = w[sl] % E
    # cross-play worlds: (2w + t) % E, every ensemble pair meets
    cr = slice(w_self, w_self + w_cross)
    assign[cr] = (2 * w[cr] + team) % E
    # past-play worlds: team 0 trains, team 1 is a frozen past policy
    pa = slice(w_self + w_cross, num_worlds)
    if w_past > 0:
        assign[pa] = np.where(team == 0, w[pa] % E, E + (w[pa] % P))
    return assign.astype(np.int32), np.array([w_self, w_cross, w_past])
