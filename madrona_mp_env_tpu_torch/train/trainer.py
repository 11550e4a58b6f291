"""First pieces of the actor-learner (the JAX package's train/trainer.py):
the observation keys fed to the policy, the training configuration as far
as the static matchmaking needs it, and that matchmaking, which the
crossplay eval shares. The rollout, GAE, recurrent PPO and the PBT
population come with the trainer's port (ROADMAP M10).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..config import EnvConfig

# observation keys fed to the policy (the rest of the env obs dict is
# train-time metadata)
POLICY_OBS_KEYS = (
    "self",
    "self_pos",
    "teammates",
    "teammate_positions",
    "opponents",
    "opponent_positions",
    "opponents_last_known",
    "opponent_last_known_positions",
    "opponent_masks",
    "fwd_lidar",
    "rear_lidar",
    "filters_state",
    "reward_coefs",
)


@dataclass(frozen=True)
class TrainConfig:
    """The fields of the JAX package's TrainConfig that the static
    assignment reads."""

    num_worlds: int = 512
    num_train_policies: int = 1  # PBT ensemble size


def _static_assignment(cfg: EnvConfig, tcfg: TrainConfig):
    """Actor -> policy assignment and block permutation (static numpy).

    (world w, team t) -> policy (2w + t) % E: every pair of ensemble
    members meets (cross-play), counts exactly equal when E | 2W. Returns
    (assign [W, A], perm [W * A], inv_perm [W * A]) int32.
    """
    W, A, ts = tcfg.num_worlds, cfg.num_agents, cfg.team_size
    E = tcfg.num_train_policies
    if (2 * W) % max(E, 1) != 0:
        raise ValueError("num_train_policies must divide 2 * num_worlds")
    w = np.arange(W)[:, None]
    team = np.arange(A)[None, :] // ts
    assign = ((2 * w + team) % E).astype(np.int32)
    flat = assign.reshape(-1)
    perm = np.argsort(flat, kind="stable").astype(np.int32)
    inv_perm = np.argsort(perm, kind="stable").astype(np.int32)
    return assign, perm, inv_perm
