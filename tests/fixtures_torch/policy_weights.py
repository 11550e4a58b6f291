"""Seeded full-width weights for the policy, in the flax param tree's names
and shapes (the JAX package's train/policy.py ActorCriticNet), made with
numpy alone so that the port's tests and the JAX-side fixture generators
share them. Every leaf has a leading policy axis P, as the trainer's
checkpoints store it.

    tree = random_flax_params(seed=0, num_policies=2)
    # flax:  model.apply({"params": jax.tree.map(lambda x: x[p], tree)}, ...)
    # port:  build_actor_critic(params_from_jax(tree)[p], device="cpu")
"""

from __future__ import annotations

import numpy as np

SELF_DIM, OTHER_DIM, COEFS = 43, 32, 9
FWD_DIM, REAR_DIM = 2 * 32 * 4, 2 * 8 * 4
EMBED, HIDDEN = 64, 512
HEADS = {"actor_head_discrete": 17, "actor_head_aim": 20, "critic_head": 1}


def random_flax_params(seed: int = 0, num_policies: int = 1) -> dict:
    """Nested dicts of float32 arrays, each [P, ...]. Dense kernels are
    N(0, 1 / fan_in); LayerNorm scales 1 + N(0, 0.1), biases N(0, 0.1),
    so every parameter takes part in the comparison."""
    g = np.random.default_rng(seed)
    P = num_policies

    def dense(n_in, n_out, bias=False):
        d = {"kernel": (g.standard_normal((P, n_in, n_out))
                        / np.sqrt(n_in)).astype(np.float32)}
        if bias:
            d["bias"] = (0.1 * g.standard_normal((P, n_out))).astype(
                np.float32)
        return d

    def ln(n):
        return {"LayerNorm_0": {
            "scale": (1.0 + 0.1 * g.standard_normal((P, n))).astype(
                np.float32),
            "bias": (0.1 * g.standard_normal((P, n))).astype(np.float32),
        }}

    def embed(n_in):
        return {"Dense_0": dense(n_in, EMBED), "LayerNorm_0": ln(EMBED)}

    def mlp():
        d = {}
        for i in range(3):
            d[f"dense_{i}"] = dense(6 * EMBED if i == 0 else HIDDEN, HIDDEN)
            d[f"LayerNorm_{i}"] = ln(HIDDEN)
        return {"MLP_0": d}

    def lstm():
        cell = {}
        for gate in "ifgo":
            cell[f"i{gate}"] = dense(HIDDEN, HIDDEN)
            cell[f"h{gate}"] = dense(HIDDEN, HIDDEN, bias=True)
        return {"OptimizedLSTMCell_0": cell, "LayerNorm_0": ln(HIDDEN)}

    tree = {
        "prefix": {
            "fwd_lidar_embed": embed(FWD_DIM),
            "rear_lidar_embed": embed(REAR_DIM),
            "self_embed": embed(SELF_DIM + COEFS + 48),
            "teammates_embed": embed(OTHER_DIM),
            "opponents_embed": embed(OTHER_DIM),
            "opponents_last_known_embed": embed(OTHER_DIM),
        },
        "actor_net": mlp(),
        "critic_net": mlp(),
        "actor_rnn": lstm(),
        "critic_rnn": lstm(),
    }
    for name, n in HEADS.items():
        tree[name] = {"Dense_0": dense(HIDDEN, n, bias=True)}
    return tree


def random_obs(seed: int, batch: int, team_size: int = 6) -> dict:
    """Policy observations of ``batch`` agents (lidar structured [h, w, 4],
    as the env gives it), float32 numpy."""
    g = np.random.default_rng(seed)

    def n(*shape):
        return g.standard_normal((batch,) + shape).astype(np.float32)

    ts = team_size
    return {
        "self": n(SELF_DIM), "self_pos": g.uniform(
            -1, 1, (batch, 3)).astype(np.float32),
        "teammates": n(ts - 1, OTHER_DIM),
        "teammate_positions": n(ts - 1, 3),
        "opponents": n(ts, OTHER_DIM), "opponent_positions": n(ts, 3),
        "opponents_last_known": n(ts, OTHER_DIM),
        "opponent_last_known_positions": n(ts, 3),
        "opponent_masks": (g.random((batch, ts)) < 0.5).astype(np.float32),
        "fwd_lidar": n(2, 32, 4), "rear_lidar": n(2, 8, 4),
        "filters_state": (g.random((batch, 1)) < 0.5).astype(np.float32),
        "reward_coefs": g.uniform(0, 1, (batch, COEFS)).astype(np.float32),
    }
