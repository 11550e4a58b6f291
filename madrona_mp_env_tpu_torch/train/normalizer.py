"""EMA observation normalizer (the JAX package's train/normalizer.py).

Per-feature running mean and variance, with a skip-list of observations
that are already bounded (positions, masks, filter bits), folded in from
each rollout step's batch by ``update_normalizer``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch

SKIP_KEYS = frozenset({
    "filters_state",
    "opponent_masks",
    "self_pos",
    "teammate_positions",
    "opponent_positions",
    "opponent_last_known_positions",
    "agent_map",
    "unmasked_agent_map",
})

EMA_DECAY = 0.99999


@dataclass
class EMANormalizerState:
    mu: Dict[str, torch.Tensor]  # per key [F]
    var: Dict[str, torch.Tensor]
    count: torch.Tensor  # update counter, int32 []

    def to(self, device) -> "EMANormalizerState":
        return EMANormalizerState(
            mu={k: v.to(device) for k, v in self.mu.items()},
            var={k: v.to(device) for k, v in self.var.items()},
            count=self.count.to(device))


def init_normalizer(obs_example: Dict[str, torch.Tensor]
                    ) -> EMANormalizerState:
    """Zero mean and unit variance for every key outside SKIP_KEYS, sized
    by its last axis, on the example's device."""
    mu, var = {}, {}
    for k, v in obs_example.items():
        if k in SKIP_KEYS:
            continue
        mu[k] = torch.zeros(v.shape[-1], dtype=torch.float32, device=v.device)
        var[k] = torch.ones(v.shape[-1], dtype=torch.float32, device=v.device)
    dev = next(iter(obs_example.values())).device
    return EMANormalizerState(mu=mu, var=var,
                              count=torch.zeros((), dtype=torch.int32,
                                                device=dev))


def normalize_obs(state: EMANormalizerState, obs: Dict[str, torch.Tensor],
                  dtype: torch.dtype = torch.float32
                  ) -> Dict[str, torch.Tensor]:
    """(v - mu) * rsqrt(var + 1e-5) per key with stats, in float32, then
    cast to the policy's compute dtype; the other keys cast as they are."""
    out = {}
    for k, v in obs.items():
        if k in SKIP_KEYS or k not in state.mu:
            out[k] = v.to(dtype)
        else:
            out[k] = ((v - state.mu[k])
                      * torch.rsqrt(state.var[k] + 1e-5)).to(dtype)
    return out


def update_normalizer(state: EMANormalizerState,
                      obs: Dict[str, torch.Tensor],
                      decay: float = EMA_DECAY) -> EMANormalizerState:
    """Fold a batch of raw observations into the EMA stats (every leading
    axis is batch). One update with decay^B equals B sequential
    per-sample EMA updates against the batch statistics."""
    mu, var = dict(state.mu), dict(state.var)
    for k in state.mu:
        v = obs[k].to(torch.float32)
        v = v.reshape(-1, v.shape[-1])
        batch_mu = v.mean(0)
        batch_var = v.var(0, correction=0)
        eff = decay ** v.shape[0]
        mu[k] = eff * state.mu[k] + (1.0 - eff) * batch_mu
        var[k] = eff * state.var[k] + (1.0 - eff) * (
            batch_var + (batch_mu - state.mu[k]) ** 2)
    return EMANormalizerState(mu=mu, var=var, count=state.count + 1)
