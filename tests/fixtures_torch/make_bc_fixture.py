"""Write the behaviour-cloning fixture of the PyTorch port's tests.

Runs the JAX package's train/bc.py on the CPU: one epoch of run_bc's loop
(PRNGKey(SEED), split, permutation(sub, N).reshape(E, N / E), minibatches
of MB rows a policy) through bc_update_fn, optax.adam(LR), float32, E = 2
policies from policy_weights.random_flax_params(WEIGHT_SEED, 2), on the
seeded dump of bc_data.write_bc_dump (STEPS x 2 x BLOCK samples, the
eval's step-block layout, read by the JAX load_bc_data). For kl_coef 0
and 0.1 it records into bc_jax.npz beside this file:

- ``kl<c>/order``: the epoch's sample order [E, N / E];
- ``kl<c>/bc_loss``: each minibatch's bc_loss [minibatches, E];
- the parameters after the epoch as a digest (the whole tree is 2 x 22.8
  MB): per policy e and leaf (the port's names and layouts,
  convert.params_from_jax) ``kl<c>/sum<e>/<name>``, the float64 sum of
  the change, and ``kl<c>/delta<e>/<name>``, the change at
  make_train_fixture.sample_index's elements (float32).

tests/test_torch_bc.py runs the port's run_bc from a checkpoint of the
same weights on the same dump and holds it to these.

Regenerate (only after a deliberate change of the JAX reference):

    JAX_PLATFORMS=cpu python tests/fixtures_torch/make_bc_fixture.py

About half a minute; it refuses any JAX backend other than the CPU.
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
PATH = os.path.join(HERE, "bc_jax.npz")

E = 2
STEPS = 2
BLOCK = 40  # samples per policy block and step: N = STEPS * 2 * BLOCK
MB = 40  # minibatch rows per policy: 2 minibatches
LR = 0.01
SEED = 7  # run_bc's default
DATA_SEED = 4
WEIGHT_SEED = 6
KL_COEFS = (0.0, 0.1)


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    if jax.default_backend() != "cpu":
        raise SystemExit("run with JAX_PLATFORMS=cpu")
    import jax.numpy as jnp
    import optax

    sys.path.insert(0, REPO)
    sys.path.insert(0, HERE)
    from bc_data import write_bc_dump
    from make_train_fixture import sample_index
    from policy_weights import random_flax_params
    from madrona_mp_env_tpu.train.bc import bc_update_fn, load_bc_data
    from madrona_mp_env_tpu.train.policy import ActorCriticNet
    from madrona_mp_env_tpu_torch.train.convert import params_from_jax

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        write_bc_dump(tmp, DATA_SEED, STEPS, 2, BLOCK)
        data = load_bc_data(tmp)
    N = data["actions"].shape[0]
    per_e = N // E
    tree = random_flax_params(WEIGHT_SEED, E)
    model = ActorCriticNet(dtype=jnp.float32)
    tx = optax.adam(LR)
    for kl in KL_COEFS:
        params = jax.tree_util.tree_map(jnp.asarray, tree)
        opt_state = jax.vmap(tx.init)(params)
        update = bc_update_fn(model, tx, kl)
        key = jax.random.PRNGKey(SEED)
        key, sub = jax.random.split(key)
        order = jax.random.permutation(sub, N).reshape(E, per_e)
        losses = []
        for mi in range(per_e // MB):
            idx = order[:, mi * MB:(mi + 1) * MB]
            batch = {
                "obs": {k: jnp.asarray(v)[idx]
                        for k, v in data["obs"].items()},
                "actions": jnp.asarray(data["actions"])[idx],
                "action_logits": jnp.asarray(data["action_logits"])[idx],
                "rnn_states": jnp.asarray(data["rnn_states"])[idx],
            }
            params, opt_state, bc_loss = update(params, opt_state, batch)
            losses.append(np.asarray(bc_loss))
        prefix = f"kl{kl}/"
        out[prefix + "order"] = np.asarray(order)
        out[prefix + "bc_loss"] = np.stack(losses)
        delta = jax.tree_util.tree_map(
            lambda a, b: np.asarray(a, np.float64) - np.asarray(b, np.float64),
            params, tree)
        for e, sd in enumerate(params_from_jax(delta)):
            for k, v in sd.items():
                d = v.numpy().reshape(-1)
                out[f"{prefix}sum{e}/{k}"] = d.sum(dtype=np.float64)
                out[f"{prefix}delta{e}/{k}"] = d[sample_index(k, d.size)]
        print(f"kl {kl}: bc_loss {out[prefix + 'bc_loss'].tolist()}")
    np.savez_compressed(PATH, **out)
    print(f"wrote {PATH} ({os.path.getsize(PATH)} bytes)")


if __name__ == "__main__":
    main()
