"""The policy, the trainer and the crossplay eval of the port (the JAX
package's train/): ActorCriticNet and its distributions, the observation
normalizer, PPO and the TrainingManager (rollout, GAE, recurrent PPO, the
PBT population, mixed precision), the JAX weight conversion, ELO and
EvalManager; the full-team policy (FullTeamActorCriticNet, one policy
for a whole team over the full-team observations); behaviour cloning
(``train.bc``), the DreamerV3 / HL-Gauss critics (``train.models``) and
the hash-grid encoder (``train.hash_encoder``)."""

from .convert import (full_team_params_from_jax, full_team_params_to_jax,
                      load_policy_npz, normalizer_from_jax,
                      opt_state_from_jax, params_from_jax, params_to_jax,
                      pbt_fields_from_jax)
from .full_team_policy import (FullTeamActorCriticNet,
                               build_full_team_policy, init_team_rnn_states)
from .infer import EvalConfig, EvalManager
from .normalizer import (EMANormalizerState, init_normalizer, normalize_obs,
                         update_normalizer)
from .policy import ActorCriticNet, build_actor_critic, init_rnn_states
from .ppo import PPOConfig, compute_gae, ppo_loss
from .trainer import TrainConfig, TrainingManager, TrainState

__all__ = [
    "ActorCriticNet",
    "EMANormalizerState",
    "EvalConfig",
    "EvalManager",
    "FullTeamActorCriticNet",
    "PPOConfig",
    "TrainConfig",
    "TrainState",
    "TrainingManager",
    "build_actor_critic",
    "build_full_team_policy",
    "compute_gae",
    "full_team_params_from_jax",
    "full_team_params_to_jax",
    "init_normalizer",
    "init_rnn_states",
    "init_team_rnn_states",
    "load_policy_npz",
    "normalize_obs",
    "normalizer_from_jax",
    "opt_state_from_jax",
    "params_from_jax",
    "params_to_jax",
    "pbt_fields_from_jax",
    "ppo_loss",
    "update_normalizer",
]
