"""Population-based training (the JAX package's train/pbt.py).

- ``ParamExplore``: per-policy hyperparameter ranges; initial values
  spread across the population (lr log-uniform x/÷10), and the
  multiplicative perturbation a replaced policy's values take.
- ``PBTConfig`` and ``make_matchmaking``: the world/team -> policy-slot
  routing by the self/cross/past play portions; slots [E, E + P) are the
  frozen past policies (policy_history_size), which act but never learn.
- ``update_population``: ELO-ranked truncation selection, the bottom
  quarter of the train policies copying parameters, Adam state and
  rating from the top, with perturbed hyperparameters.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..utils import rng

# multiplicative perturbation range of a replaced policy's hyperparameters
PERTURB_LO = 0.8
PERTURB_HI = 1.25


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

    def perturb(self, key: torch.Tensor, values: torch.Tensor
                ) -> torch.Tensor:
        """values times a factor uniform in [PERTURB_LO, PERTURB_HI),
        clipped to [lo, hi] (the JAX draw)."""
        factor = rng.uniform(key, tuple(values.shape), minval=PERTURB_LO,
                             maxval=PERTURB_HI).to(values.device)
        return torch.clamp(values * factor, self.lo, self.hi)


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


def update_population(key: torch.Tensor, params: List[Dict], opt_state: List,
                      hyper_params: Dict[str, torch.Tensor],
                      elo: torch.Tensor, explore: Dict[str, ParamExplore],
                      selection_fraction: float = 0.25):
    """ELO-ranked truncation selection over E policies: rank by ELO
    (stable, so ties keep index order), the bottom k = max(int(E x
    fraction), 1) copy parameters, Adam state and ELO from the top k, and
    only their hyperparameters take ``explore``'s perturbation (one key
    per hyperparameter, split from ``key``). Returns (params, opt_state,
    hyper_params, elo); the copies are new tensors."""
    E = elo.shape[0]
    k = max(int(E * selection_fraction), 1) if E > 1 else 0
    if k == 0:
        return params, opt_state, hyper_params, elo
    order = torch.argsort(-elo, stable=True)  # best first
    top, bottom = order[:k], order[-k:]
    src = torch.arange(E, device=elo.device)
    src[bottom] = top
    replaced = torch.zeros(E, dtype=torch.bool, device=elo.device)
    replaced[bottom] = True
    donors = src.tolist()
    params = [p if s == i else {n: v.clone() for n, v in params[s].items()}
              for i, (s, p) in enumerate(zip(donors, params))]
    opt_state = [o if s == i else replace(
        opt_state[s], count=opt_state[s].count.clone(),
        mu={n: v.clone() for n, v in opt_state[s].mu.items()},
        nu={n: v.clone() for n, v in opt_state[s].nu.items()})
        for i, (s, o) in enumerate(zip(donors, opt_state))]
    new_hp = {}
    keys = rng.split(key, max(len(hyper_params), 1))
    for (name, values), sub in zip(hyper_params.items(), keys):
        perturbed = explore[name].perturb(sub, values[src])
        new_hp[name] = torch.where(replaced, perturbed, values)
    return params, opt_state, new_hp, elo[src]
