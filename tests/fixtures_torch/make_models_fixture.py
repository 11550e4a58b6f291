"""Write the models fixture of the PyTorch port's tests (models_jax.npz
beside this file), from the JAX package on the CPU, every input made
from a seed by this module's numpy helpers:

- ``hash<dim>``: HashGridEncoder (4 levels, T = 2^10, F = 2, resolutions
  4-64) applied eagerly at dim 2 and 3 on hash_inputs(dim);
- ``two_hot``: DreamerV3Critic.two_hot_target applied eagerly on
  critic_values();
- ``<critic>/value`` and ``<critic>/centers``: DreamerV3Critic and
  HLGaussCritic under jax.jit on critic_inputs(), and their bin centres;

and, from flax ActorCriticNet(use_attention=True) under jax.jit in
float32 and bfloat16 with the weights of
policy_weights.random_flax_params(WEIGHT_SEED, 1, attention=True) on
policy_weights.random_obs inputs of B agents (2 worlds of Zone 6v6), per
dtype ``f32`` / ``bf16``:

- ``<dt>/net``: EntitySelfAttentionNet alone (the actor net's weights) on
  seeded 64-wide prefix features, [B, 512] (stored as float32);
- ``<dt>/step<t>/{discrete,aim,value}``: STEPS forward steps from zero
  recurrent states, the states of the even agents cleared before the
  second, and ``<dt>/rnn`` the recurrent states after the last;
- ``<dt>/seq/{log_probs_discrete,log_probs_aim,entropy_discrete,
  entropy_aim,values}``: ``sequence`` over [T, B] with dones and actions
  drawn from DATA_SEED.

tests/test_torch_models.py builds the port's modules from the same
inputs and weights (convert.params_from_jax) and holds them to these.

Regenerate (only after a deliberate change of the JAX reference):

    JAX_PLATFORMS=cpu python tests/fixtures_torch/make_models_fixture.py

About 25 seconds; it refuses any JAX backend other than the CPU.
"""

from __future__ import annotations

import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
PATH = os.path.join(HERE, "models_jax.npz")

B = 24  # 2 worlds x 12 agents
STEPS = 3
T = 4
WEIGHT_SEED = 8
DATA_SEED = 12
BUCKETS = (3, 8, 3, 3, 13, 7)
HASH = dict(num_levels=4, table_size=2 ** 10, num_features=2,
            min_resolution=4, max_resolution=64)
CRITICS = ("DreamerV3Critic", "HLGaussCritic")


def hash_inputs(dim: int):
    """(positions [257, dim] in [0, 1), the table [4, 2^10, 2])."""
    g = np.random.default_rng(dim)
    pos = g.random((257, dim)).astype(np.float32)
    return pos, g.standard_normal((4, 2 ** 10, 2)).astype(np.float32)


def critic_values() -> np.ndarray:
    """Values for two_hot_target: small, large, huge and signed zeros."""
    g = np.random.default_rng(0)
    return np.concatenate([
        g.normal(0, 3, 2000), g.uniform(-300, 300, 2000),
        g.uniform(-1e9, 1e9, 200),
        [0.0, -0.0, 1e-6, -1e-6, 20.0, -20.0, 4.85e8]]).astype(np.float32)


def critic_inputs(num_bins: int, seed: int = 2):
    """(features [64, 32], dense kernel [32, num_bins], bias): non-zero
    (the DreamerV3 kernel starts at zero, its softmax uniform)."""
    g = np.random.default_rng(seed)
    feats = g.standard_normal((64, 32)).astype(np.float32)
    k = (0.3 * g.standard_normal((32, num_bins))).astype(np.float32)
    return feats, k, (0.1 * g.standard_normal(num_bins)).astype(np.float32)


def prefix_features(seed: int, batch: int) -> dict:
    """Seeded 64-wide prefix outputs for EntitySelfAttentionNet alone."""
    g = np.random.default_rng(seed)

    def n(*shape):
        return g.standard_normal((batch,) + shape).astype(np.float32)

    return {"self": n(64), "fwd_lidar": n(64), "rear_lidar": n(64),
            "teammates": n(5, 64), "opponents": n(6, 64),
            "opponents_last_known": n(6, 64)}


def sequence_inputs(seed: int):
    """(obs [T, B, ...], dones [T, B], actions [T, B, 6]) for sequence."""
    from policy_weights import random_obs

    g = np.random.default_rng(seed)
    obs = random_obs(seed, T * B)
    obs = {k: v.reshape((T, B) + v.shape[1:]) for k, v in obs.items()}
    dones = (g.random((T, B)) < 0.3).astype(np.float32)
    actions = np.stack([g.integers(0, b, (T, B)) for b in BUCKETS],
                       -1).astype(np.int32)
    return obs, dones, actions


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    if jax.default_backend() != "cpu":
        raise SystemExit("run with JAX_PLATFORMS=cpu")
    import jax.numpy as jnp

    sys.path.insert(0, REPO)
    sys.path.insert(0, HERE)
    from policy_weights import random_flax_params, random_obs
    from madrona_mp_env_tpu.train import hash_encoder as jhash
    from madrona_mp_env_tpu.train import models as jmodels
    from madrona_mp_env_tpu.train import policy as jpolicy

    out = {}
    for dim in (2, 3):
        pos, table = hash_inputs(dim)
        enc = jhash.HashGridEncoder(dim=dim, **HASH)
        out[f"hash{dim}"] = np.asarray(enc.apply(
            {"params": {"hash_table": jnp.asarray(table)}}, jnp.asarray(pos)))
    dreamer = jmodels.DreamerV3Critic(dtype=jnp.float32)
    out["two_hot"] = np.asarray(dreamer.apply(
        {"params": {}}, jnp.asarray(critic_values()),
        method=dreamer.two_hot_target))
    for name in CRITICS:
        critic = getattr(jmodels, name)(dtype=jnp.float32)
        feats, k, b = critic_inputs(critic.num_bins)
        out[f"{name}/value"] = np.asarray(jax.jit(
            lambda p, x: critic.apply({"params": p}, x))(
                {"Dense_0": {"kernel": k, "bias": b}}, feats))
        out[f"{name}/centers"] = np.asarray(critic.bin_centers())

    tree = jax.tree_util.tree_map(
        lambda x: jnp.asarray(x[0]),
        random_flax_params(WEIGHT_SEED, 1, attention=True))
    for name, jdt in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
        def f32(x):
            return np.asarray(jnp.asarray(x).astype(jnp.float32))

        net = jmodels.EntitySelfAttentionNet(
            num_embed_channels=64, num_out_channels=512, num_heads=4,
            dtype=jdt)
        feats = {k: jnp.asarray(v).astype(jdt)
                 for k, v in prefix_features(DATA_SEED, B).items()}
        out[f"{name}/net"] = f32(jax.jit(
            lambda p, x: net.apply({"params": p}, x))(tree["actor_net"],
                                                     feats))

        model = jpolicy.ActorCriticNet(dtype=jdt, use_attention=True)
        step = jax.jit(lambda p, r, o: model.apply({"params": p}, r, o,
                                                   False))
        rnn = jpolicy.init_rnn_states((B,))
        clear = jnp.asarray(np.arange(B) % 2 == 0)
        for t in range(STEPS):
            if t == 1:
                rnn = jpolicy.clear_rnn_states(rnn, clear)
            obs = {k: jnp.asarray(v).astype(jdt)
                   for k, v in random_obs(DATA_SEED + 1 + t, B).items()}
            d, v, rnn = step(tree, rnn, obs)
            out[f"{name}/step{t}/discrete"] = f32(d.discrete.logits)
            out[f"{name}/step{t}/aim"] = f32(d.aim.logits)
            out[f"{name}/step{t}/value"] = f32(v)
        out[f"{name}/rnn"] = f32(rnn)

        obs, dones, actions = sequence_inputs(DATA_SEED + 10)
        start = (0.5 * np.random.default_rng(DATA_SEED + 20).standard_normal(
            (2, 2, B, 512))).astype(np.float32)
        seq = jax.jit(lambda p, r, dn, o, a: model.apply(
            {"params": p}, r, dn, o, a, True, method=model.sequence))
        lp, ent, values = seq(
            tree, jnp.asarray(start), jnp.asarray(dones),
            {k: jnp.asarray(v).astype(jdt) for k, v in obs.items()},
            {"discrete": jnp.asarray(actions[..., :4]),
             "aim": jnp.asarray(actions[..., 4:])})
        for head in ("discrete", "aim"):
            out[f"{name}/seq/log_probs_{head}"] = f32(lp[head])
            out[f"{name}/seq/entropy_{head}"] = f32(ent[head])
        out[f"{name}/seq/values"] = f32(values)
    np.savez_compressed(PATH, **out)
    print(f"wrote {PATH} ({os.path.getsize(PATH)} bytes)")


if __name__ == "__main__":
    main()
