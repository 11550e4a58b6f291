"""PPO losses and GAE (the JAX package's train/ppo.py).

gamma 0.998, GAE lambda 0.95, 2 epochs, clip 0.2, value coefficient 0.5,
per-action-group entropy coefficients, max grad norm 0.5, advantages not
normalized; recurrent minibatches are re-run through the LSTM over BPTT
chunks (trainer.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch


@dataclass(frozen=True)
class PPOConfig:
    num_epochs: int = 2
    num_minibatches: int = 4
    clip_coef: float = 0.2
    value_loss_coef: float = 0.5
    entropy_coef_discrete: float = 0.3
    entropy_coef_aim: float = 0.3
    max_grad_norm: float = 0.5
    clip_value_loss: bool = False
    huber_value_loss: bool = False


def compute_gae(rewards, values, dones, bootstrap_value, gamma: float,
                gae_lambda: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """rewards, values, dones [T, B]; bootstrap_value [B]. dones[t] marks
    that the episode ended AT step t (no bootstrap across it). A reverse
    loop over t. Returns (advantages, returns) [T, B]."""
    nonterminal = 1.0 - dones.to(torch.float32)
    next_value = bootstrap_value
    next_adv = torch.zeros_like(bootstrap_value)
    advs = []
    for t in range(rewards.shape[0] - 1, -1, -1):
        delta = rewards[t] + gamma * next_value * nonterminal[t] - values[t]
        next_adv = delta + gamma * gae_lambda * nonterminal[t] * next_adv
        next_value = values[t]
        advs.append(next_adv)
    advantages = torch.stack(advs[::-1])
    return advantages, advantages + values


def ppo_loss(new_log_probs: Dict[str, torch.Tensor],
             entropies: Dict[str, torch.Tensor], new_values, old_log_probs,
             old_values, advantages, returns, cfg: PPOConfig):
    """All tensors [T, MB]. Returns (loss, metrics dict of scalars)."""
    old_lp = old_log_probs["discrete"] + old_log_probs["aim"]
    new_lp = new_log_probs["discrete"] + new_log_probs["aim"]
    log_ratio = new_lp - old_lp
    ratio = torch.exp(log_ratio)

    pg1 = -advantages * ratio
    pg2 = -advantages * torch.clamp(ratio, 1.0 - cfg.clip_coef,
                                    1.0 + cfg.clip_coef)
    pg_loss = torch.maximum(pg1, pg2).mean()

    err = new_values - returns
    if cfg.clip_value_loss:
        v_clipped = old_values + torch.clamp(new_values - old_values,
                                             -cfg.clip_coef, cfg.clip_coef)
        v_loss = 0.5 * torch.maximum(err ** 2,
                                     (v_clipped - returns) ** 2).mean()
    elif cfg.huber_value_loss:
        v_loss = (torch.square(torch.clamp(err.abs(), max=1.0)) * 0.5
                  + torch.clamp(err.abs() - 1.0, min=0.0)).mean()
    else:
        v_loss = 0.5 * (err ** 2).mean()

    ent_discrete = entropies["discrete"].mean()
    ent_aim = entropies["aim"].mean()
    loss = (pg_loss + cfg.value_loss_coef * v_loss
            - cfg.entropy_coef_discrete * ent_discrete
            - cfg.entropy_coef_aim * ent_aim)

    approx_kl = ((ratio - 1.0) - log_ratio).mean()
    clip_frac = ((ratio - 1.0).abs() > cfg.clip_coef).to(
        torch.float32).mean()
    metrics = {
        "loss": loss,
        "pg_loss": pg_loss,
        "v_loss": v_loss,
        "entropy_discrete": ent_discrete,
        "entropy_aim": ent_aim,
        "approx_kl": approx_kl,
        "clip_frac": clip_frac,
    }
    return loss, metrics
