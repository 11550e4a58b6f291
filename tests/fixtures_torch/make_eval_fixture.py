"""Write the crossplay-eval fixture of the PyTorch port's tests.

Runs the JAX package's EvalManager.run on the CPU: Zone 6v6 on
data/simple_map (SimFlags.SimEvalMode, episode_len 6, so both matches end
and update the ELO inside the run), 2 worlds, P = 2 policies whose
full-width weights come from a seed (policy_weights.random_flax_params),
the normalizer stats of the trained checkpoint
artifacts/zone6v6_r5_policy0, sampled actions, 10 steps in chunks of 5.
Records, per step, the actions, values, rewards, dones and packed log
probs of every agent in policy-block order, the match results, the final
ELO, the normalizer stats and the smallest top-two margin over the heads
of each agent's Gumbel-max scores (log prob + the step key's noise), into
zone_eval_crossplay.npz beside this file. tests/test_torch_infer.py replays
the run through madrona_mp_env_tpu_torch's EvalManager on the CPU.

Regenerate (only after a deliberate change of the JAX reference):

    JAX_PLATFORMS=cpu python tests/fixtures_torch/make_eval_fixture.py

It refuses any JAX backend other than the CPU.
"""

from __future__ import annotations

import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
PATH = os.path.join(HERE, "zone_eval_crossplay.npz")
CKPT = os.path.join(REPO, "artifacts", "zone6v6_r5_policy0")

NUM_WORLDS = 2
TEAM_SIZE = 6
NUM_POLICIES = 2
EPISODE_LEN = 6
NUM_STEPS = 10
CHUNK_STEPS = 5
ENV_SEED = 9
EVAL_SEED = 10
WEIGHT_SEED = 0
ELO0 = (1500.0, 1550.0)


def margins(logits, key, buckets_by_group):
    """Smallest top-two gap over the heads of log probs + the Gumbel
    noise of ``key`` (ActorDistributions.sample's stream): [...]."""
    import jax

    k = jax.random.split(key)
    out, off = [], 0
    for ki, buckets in zip(k, buckets_by_group):
        width = sum(buckets)
        lp = logits[..., off:off + width]
        z = np.asarray(lp + jax.random.gumbel(ki, lp.shape, np.float32))
        o = 0
        for b in buckets:
            two = np.sort(z[..., o:o + b], axis=-1)[..., -2:]
            out.append(two[..., 1] - two[..., 0])
            o += b
        off += width
    return np.min(out, axis=0)


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    if jax.default_backend() != "cpu":
        raise RuntimeError("the eval fixture needs the CPU backend; run with "
                           "JAX_PLATFORMS=cpu")
    import jax.numpy as jnp

    sys.path.insert(0, REPO)
    sys.path.insert(0, HERE)
    import madrona_mp_env_tpu as mp
    from madrona_mp_env_tpu.train.distributions import (AIM_BUCKETS,
                                                        DISCRETE_BUCKETS)
    from madrona_mp_env_tpu.train.infer import (EvalConfig, EvalManager,
                                                eval_load_ckpt)
    from policy_weights import random_flax_params

    cfg = mp.EnvConfig(task=mp.Task.Zone, team_size=TEAM_SIZE,
                       sim_flags=mp.SimFlags.SimEvalMode,
                       episode_len=EPISODE_LEN)
    env = mp.Env(cfg, os.path.join(REPO, "data", "simple_map"),
                 num_worlds=NUM_WORLDS, seed=ENV_SEED)
    ecfg = EvalConfig(num_worlds=NUM_WORLDS, num_eval_steps=NUM_STEPS,
                      chunk_steps=CHUNK_STEPS, seed=EVAL_SEED)
    mgr = EvalManager(cfg, ecfg, env, NUM_POLICIES)
    params = jax.tree_util.tree_map(
        jnp.asarray, random_flax_params(WEIGHT_SEED, NUM_POLICIES))
    _, normalizer, _, _ = eval_load_ckpt(CKPT)

    chunks = []
    elo = mgr.run(params, normalizer, jnp.asarray(ELO0, jnp.float32),
                  iter_cb=chunks.append, verbose=False)

    def cat(get):
        return np.concatenate([np.asarray(get(c)) for c in chunks])

    rec = {
        "actions_discrete": cat(lambda c: c["actions"]["discrete"]),
        "actions_aim": cat(lambda c: c["actions"]["aim"]),
        "values": cat(lambda c: c["values"]),
        "rewards": cat(lambda c: c["rewards"]),
        "dones": cat(lambda c: c["dones"]),
        "logits": cat(lambda c: c["logits"]),
    }
    for k in ("win_result", "team_points", "match_finished"):
        rec[k] = cat(lambda c: c["episode_result"][k])
    key = jax.random.PRNGKey(EVAL_SEED)
    step_keys = []
    for _ in range(len(chunks)):
        key, sub = jax.random.split(key)
        step_keys.extend(jax.random.split(sub, CHUNK_STEPS))
    rec["margins"] = np.stack([
        margins(rec["logits"][t], step_keys[t],
                (DISCRETE_BUCKETS, AIM_BUCKETS))
        for t in range(len(step_keys))])
    rec["elo0"] = np.asarray(ELO0, np.float32)
    rec["elo"] = np.asarray(elo)
    for k in normalizer.mu:
        rec[f"norm_mu/{k}"] = np.asarray(normalizer.mu[k])
        rec[f"norm_var/{k}"] = np.asarray(normalizer.var[k])
    rec["norm_count"] = np.asarray(normalizer.count)
    np.savez_compressed(PATH, **rec)
    print(f"wrote {PATH} ({os.path.getsize(PATH)} bytes); final ELO "
          f"{rec['elo']}; matches finished at steps "
          f"{np.nonzero(rec['match_finished'].any(-1))[0].tolist()}; "
          f"smallest margin {float(rec['margins'].min()):.3g}")


if __name__ == "__main__":
    main()
