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
ATTENTION_HEADS = 4
HEADS = {"actor_head_discrete": 17, "actor_head_aim": 20, "critic_head": 1}


def random_flax_params(seed: int = 0, num_policies: int = 1,
                       attention: bool = False, embed_dim: int = EMBED,
                       hidden: int = HIDDEN) -> dict:
    """Nested dicts of float32 arrays, each [P, ...]. Dense kernels are
    N(0, 1 / fan_in); LayerNorm scales 1 + N(0, 0.1), biases N(0, 0.1),
    so every parameter takes part in the comparison. ``attention``: the
    tree of ActorCriticNet(use_attention=True), EntitySelfAttentionNets
    (4 heads) for the MaxPoolNets' MLPs. ``embed_dim`` and ``hidden``
    narrow the tree (the policy's widths by default)."""
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
        return {"Dense_0": dense(n_in, embed_dim),
                "LayerNorm_0": ln(embed_dim)}

    def mlp():
        d = {}
        for i in range(3):
            d[f"dense_{i}"] = dense(6 * embed_dim if i == 0 else hidden,
                                    hidden)
            d[f"LayerNorm_{i}"] = ln(hidden)
        return {"MLP_0": d}

    def attention_net():
        d = {f"EmbedBlock_{i}": embed(
            3 * embed_dim if i == 0 else embed_dim) for i in range(4)}
        heads, head_dim = ATTENTION_HEADS, embed_dim // ATTENTION_HEADS
        mha = {}
        for proj in ("query", "key", "value"):
            mha[proj] = {
                "kernel": (g.standard_normal((P, embed_dim, heads, head_dim))
                           / np.sqrt(embed_dim)).astype(np.float32),
                "bias": (0.1 * g.standard_normal((P, heads, head_dim))
                         ).astype(np.float32)}
        mha["out"] = {
            "kernel": (g.standard_normal((P, heads, head_dim, embed_dim))
                       / np.sqrt(embed_dim)).astype(np.float32),
            "bias": (0.1 * g.standard_normal((P, embed_dim))).astype(
                np.float32)}
        d["MultiHeadDotProductAttention_0"] = mha
        d["LayerNorm_0"] = ln(embed_dim)
        mlp = {}
        for i in range(2):
            mlp[f"dense_{i}"] = dense(embed_dim if i == 0 else hidden,
                                      hidden)
            mlp[f"LayerNorm_{i}"] = ln(hidden)
        d["MLP_0"] = mlp
        return d

    def lstm():
        cell = {}
        for gate in "ifgo":
            cell[f"i{gate}"] = dense(hidden, hidden)
            cell[f"h{gate}"] = dense(hidden, hidden, bias=True)
        return {"OptimizedLSTMCell_0": cell, "LayerNorm_0": ln(hidden)}

    tree = {
        "prefix": {
            "fwd_lidar_embed": embed(FWD_DIM),
            "rear_lidar_embed": embed(REAR_DIM),
            "self_embed": embed(SELF_DIM + COEFS + 48),
            "teammates_embed": embed(OTHER_DIM),
            "opponents_embed": embed(OTHER_DIM),
            "opponents_last_known_embed": embed(OTHER_DIM),
        },
        "actor_net": attention_net() if attention else mlp(),
        "critic_net": attention_net() if attention else mlp(),
        "actor_rnn": lstm(),
        "critic_rnn": lstm(),
    }
    for name, n in HEADS.items():
        tree[name] = {"Dense_0": dense(hidden, n, bias=True)}
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
