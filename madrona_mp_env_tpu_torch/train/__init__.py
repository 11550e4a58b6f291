"""The policy and the crossplay eval of the port (the JAX package's
train/): ActorCriticNet and its distributions, the observation
normalizer, the JAX weight conversion, ELO and EvalManager. The trainer
(rollout, GAE, recurrent PPO, PBT) is still to come."""

from .convert import load_policy_npz, normalizer_from_jax, params_from_jax
from .infer import EvalConfig, EvalManager
from .normalizer import EMANormalizerState, init_normalizer, normalize_obs
from .policy import ActorCriticNet, build_actor_critic, init_rnn_states

__all__ = [
    "ActorCriticNet",
    "EMANormalizerState",
    "EvalConfig",
    "EvalManager",
    "build_actor_critic",
    "init_normalizer",
    "init_rnn_states",
    "load_policy_npz",
    "normalize_obs",
    "normalizer_from_jax",
    "params_from_jax",
]
