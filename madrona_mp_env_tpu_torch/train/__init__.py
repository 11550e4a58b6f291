"""The policy, the trainer and the crossplay eval of the port (the JAX
package's train/): ActorCriticNet and its distributions, the observation
normalizer, PPO and the TrainingManager (rollout, GAE, recurrent PPO),
the JAX weight conversion, ELO and EvalManager. The PBT population
update comes later."""

from .convert import (load_policy_npz, normalizer_from_jax,
                      opt_state_from_jax, params_from_jax)
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
    "PPOConfig",
    "TrainConfig",
    "TrainState",
    "TrainingManager",
    "build_actor_critic",
    "compute_gae",
    "init_normalizer",
    "init_rnn_states",
    "load_policy_npz",
    "normalize_obs",
    "normalizer_from_jax",
    "opt_state_from_jax",
    "params_from_jax",
    "ppo_loss",
    "update_normalizer",
]
