"""Write the trainer fixture of the PyTorch port's tests.

Runs the JAX package's TrainingManager on the CPU: Zone 2v2 on
data/simple_map (StaggerStarts | RandomFlipTeams, the train CLI's flags),
2 worlds, steps_per_update 8 in 2 BPTT chunks, 1 epoch of 2 minibatches,
one train policy at the policy's own widths, whose weights come from a
seed (policy_weights.random_flax_params) in place of flax's initializers.
Records into zone_train.npz beside this file:

- the initial TrainState's key and the train seed;
- the first rollout: per step the actions, log probs, values, rewards and
  dones of every actor (policy-block order), the packed normalized obs,
  the BPTT chunk start states, the bootstrap values and the key after it;
- the GAE advantages and returns over that rollout;
- the first minibatch of the PPO epoch: its unit order, its loss terms
  and the global norm of its gradient (the JAX loss on the rollout
  buffers, as TrainingManager._ppo_update gathers them);
- the parameters after one update_iter from the initial state, as the
  change from the initial value at a fixed sample of up to SAMPLE
  elements of every tensor, in the port's names and layouts
  (convert.params_from_jax), and the Adam state's count.

tests/test_torch_train.py starts the port's TrainingManager from the same
point (the same weights, zero Adam moments, the same env seed and key)
and holds it to these.

Regenerate (only after a deliberate change of the JAX reference):

    JAX_PLATFORMS=cpu python tests/fixtures_torch/make_train_fixture.py

It refuses any JAX backend other than the CPU (about two minutes).
"""

from __future__ import annotations

import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
PATH = os.path.join(HERE, "zone_train.npz")

NUM_WORLDS = 2
TEAM_SIZE = 2
STEPS = 8
CHUNKS = 2
MINIBATCHES = 2
EPOCHS = 1
ENV_SEED = 5
TRAIN_SEED = 11
WEIGHT_SEED = 3
SAMPLE = 512  # sampled elements per parameter leaf


def sample_index(flat_key: str, size: int) -> np.ndarray:
    """The fixed sample of a leaf's flat indices (same in the test)."""
    seed = sum(ord(c) for c in flat_key)
    g = np.random.default_rng(seed)
    n = min(SAMPLE, size)
    return np.sort(g.choice(size, n, replace=False)).astype(np.int64)


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    if jax.default_backend() != "cpu":
        raise RuntimeError("the train fixture needs the CPU backend; run "
                           "with JAX_PLATFORMS=cpu")
    import jax.numpy as jnp
    import optax

    sys.path.insert(0, REPO)
    sys.path.insert(0, HERE)
    import madrona_mp_env_tpu as mp
    from madrona_mp_env_tpu.train.policy import ActorCriticNet
    from madrona_mp_env_tpu.train.ppo import PPOConfig, compute_gae, ppo_loss
    from madrona_mp_env_tpu.train.trainer import TrainConfig, TrainingManager
    from madrona_mp_env_tpu_torch.train.convert import params_from_jax
    from policy_weights import random_flax_params

    cfg = mp.EnvConfig(
        task=mp.Task.Zone, team_size=TEAM_SIZE,
        sim_flags=mp.SimFlags.StaggerStarts | mp.SimFlags.RandomFlipTeams)
    tcfg = TrainConfig(
        num_worlds=NUM_WORLDS, steps_per_update=STEPS,
        num_bptt_chunks=CHUNKS,
        ppo=PPOConfig(num_epochs=EPOCHS, num_minibatches=MINIBATCHES),
        seed=TRAIN_SEED)
    env = mp.Env(cfg, os.path.join(REPO, "data", "simple_map"),
                 num_worlds=NUM_WORLDS, seed=ENV_SEED)
    mgr = TrainingManager(cfg, tcfg, env)
    params0 = jax.tree_util.tree_map(jnp.asarray,
                                     random_flax_params(WEIGHT_SEED, 1))
    ts0 = mgr.init()
    ts0 = ts0.replace(params=params0, opt_state=jax.vmap(mgr.tx.init)(params0))
    out = {"key0": np.asarray(ts0.key), "train_seed": np.int64(TRAIN_SEED)}

    ts1, rnn_starts, outs, boot = jax.jit(mgr._rollout)(ts0)
    K, L, E, BE = CHUNKS, STEPS // CHUNKS, 1, mgr.BE
    out.update({
        "act_pack": np.asarray(outs["act_pack"]),  # [K, L, E, BE, 6]
        "log_probs_discrete": np.asarray(outs["log_probs"]["discrete"]),
        "log_probs_aim": np.asarray(outs["log_probs"]["aim"]),
        "values": np.asarray(outs["values"]),
        "rewards": np.asarray(outs["rewards"]),
        "dones": np.asarray(outs["dones"]),
        "obs_pack": np.asarray(outs["obs_pack"]),
        "rnn_starts": np.asarray(rnn_starts),  # [K, 2, 2, E, BE, H]
        "bootstrap": np.asarray(boot),
        "key1": np.asarray(ts1.key),
    })

    T = K * L
    adv, ret = compute_gae(
        outs["rewards"].reshape(T, -1), outs["values"].reshape(T, -1),
        outs["dones"].reshape(T, -1), boot.reshape(-1), tcfg.gamma,
        tcfg.gae_lambda)
    out["adv"] = np.asarray(adv).reshape(K, L, E, BE)
    out["ret"] = np.asarray(ret).reshape(K, L, E, BE)

    # the first minibatch, gathered and lost as _ppo_update does
    num_units = K * BE
    mb = num_units // MINIBATCHES
    _, sub = jax.random.split(ts1.key)
    epoch_key = jax.random.split(sub, EPOCHS)[0]
    order = jax.vmap(lambda k: jax.random.permutation(k, num_units))(
        jax.random.split(epoch_key, E))
    out["order"] = np.asarray(order)
    idx = order[0, :mb]
    k, b = idx // BE, idx % BE
    ll = jnp.arange(L)[:, None]
    obs_mb = outs["obs_pack"][k[None], ll, 0, b[None]]
    act_mb = outs["act_pack"][k[None], ll, 0, b[None]]
    scal = jnp.stack([outs["values"], outs["dones"].astype(jnp.float32),
                      adv.reshape(K, L, E, BE), ret.reshape(K, L, E, BE),
                      outs["log_probs"]["discrete"],
                      outs["log_probs"]["aim"]], axis=-1)
    scal_mb = scal[k[None], ll, 0, b[None]]
    rnn_mb = jnp.moveaxis(rnn_starts[k, :, :, 0, b], 0, 2)
    slots = mgr._obs_slots

    def loss_fn(p):
        obs = mgr._unpack_obs(obs_mb, slots)
        new_lp, ent, new_v = mgr.model.apply(
            {"params": p}, rnn_mb, scal_mb[..., 1], obs,
            {"discrete": act_mb[..., :4], "aim": act_mb[..., 4:6]},
            method=ActorCriticNet.sequence)
        return ppo_loss(new_lp, ent, new_v,
                        {"discrete": scal_mb[..., 4], "aim": scal_mb[..., 5]},
                        scal_mb[..., 0], scal_mb[..., 2], scal_mb[..., 3],
                        tcfg.ppo)

    p0 = jax.tree_util.tree_map(lambda x: x[0], params0)
    grads, metrics = jax.jit(jax.grad(loss_fn, has_aux=True))(p0)
    for name, v in metrics.items():
        out[f"mb0/{name}"] = np.asarray(v)
    out["mb0/grad_norm"] = np.asarray(optax.global_norm(grads))

    ts2, upd_metrics = mgr.update_iter(ts0)
    for name in ("loss", "pg_loss", "v_loss"):
        out[f"update/{name}"] = np.asarray(upd_metrics[name])
    out["update/count"] = np.asarray(ts2.opt_state[1].count)
    # in the port's names and layouts (convert.params_from_jax)
    before = params_from_jax(random_flax_params(WEIGHT_SEED, 1))[0]
    after = params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                   ts2.params))[0]
    for key, v0 in before.items():
        i = sample_index(key, v0.numel())
        out[f"delta/{key}"] = (after[key].reshape(-1)[i]
                               - v0.reshape(-1)[i]).numpy()
    np.savez_compressed(PATH, **out)
    print(f"wrote {PATH}: {len(out)} arrays, "
          f"{os.path.getsize(PATH) / 1024:.0f} KB")


if __name__ == "__main__":
    main()
