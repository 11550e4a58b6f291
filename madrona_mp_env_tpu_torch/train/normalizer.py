"""EMA observation normalizer (the JAX package's train/normalizer.py).

Per-feature running mean and variance, with a skip-list of observations
that are already bounded (positions, masks, filter bits). Only what the
eval path reads is here; ``update_normalizer`` comes with the trainer.
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


def normalize_obs(state: EMANormalizerState, obs: Dict[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
    """(v - mu) * rsqrt(var + 1e-5) per key with stats; others as float32."""
    out = {}
    for k, v in obs.items():
        if k in SKIP_KEYS or k not in state.mu:
            out[k] = v.to(torch.float32)
        else:
            out[k] = (v - state.mu[k]) * torch.rsqrt(state.var[k] + 1e-5)
    return out
