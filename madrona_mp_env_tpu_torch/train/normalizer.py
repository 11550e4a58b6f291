"""EMA observation normalizer (the JAX package's train/normalizer.py).

Per-feature running mean and variance, with a skip-list of observations
that are already bounded (positions, masks, filter bits), folded in from
each rollout step's batch by ``update_normalizer``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

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
                      decay: float = EMA_DECAY, mesh=None,
                      num_actors: Optional[int] = None
                      ) -> EMANormalizerState:
    """Fold a batch of raw observations into the EMA stats (every leading
    axis is batch). One update with decay^B equals B sequential
    per-sample EMA updates against the batch statistics.

    ``mesh`` (a parallel.DataMesh of more than one rank): ``obs`` leaves
    [N, ..., F] are this rank's share of ``num_actors`` actors, and the
    batch is every rank's: its mean is the all-reduced sum over the
    global count, its variance the all-reduced squared deviations from
    that mean (two all-reduces for every key at once)."""
    if mesh is not None and mesh.size > 1:
        return _update_sharded(state, obs, decay, mesh, num_actors)
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


def _update_sharded(state, obs, decay, mesh, num_actors):
    from ..parallel.collectives import all_sum

    keys = list(state.mu)
    vs, counts = {}, {}
    for k in keys:
        v = obs[k].to(torch.float32)
        rows_per_actor = 1
        for d in v.shape[1:-1]:
            rows_per_actor *= d
        counts[k] = num_actors * rows_per_actor
        vs[k] = v.reshape(-1, v.shape[-1])
    sums = all_sum(mesh, torch.cat([vs[k].sum(0) for k in keys]))
    batch_mu = dict(zip(keys, sums.split([vs[k].shape[1] for k in keys])))
    batch_mu = {k: batch_mu[k] / counts[k] for k in keys}
    dev = all_sum(mesh, torch.cat([((vs[k] - batch_mu[k]) ** 2).sum(0)
                                   for k in keys]))
    batch_var = dict(zip(keys, dev.split([vs[k].shape[1] for k in keys])))
    mu, var = dict(state.mu), dict(state.var)
    for k in keys:
        eff = decay ** counts[k]
        mu[k] = eff * state.mu[k] + (1.0 - eff) * batch_mu[k]
        var[k] = eff * state.var[k] + (1.0 - eff) * (
            batch_var[k] / counts[k] + (batch_mu[k] - state.mu[k]) ** 2)
    return EMANormalizerState(mu=mu, var=var, count=state.count + 1)
