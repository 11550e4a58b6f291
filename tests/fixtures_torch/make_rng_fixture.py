"""Write rng_jax.npz: jax.random's outputs that tests/test_torch_rng.py
holds the port's threefry to, for each of its SEEDS:

- ``<seed>/key``: ``key_data(PRNGKey(seed))``; ``<seed>/fold_in/<i>``:
  ``fold_in`` of it with FOLD_DATA[i] (an int32);
- ``<seed>/keys``: 6 raw keys split from it, the inputs of the rest;
- ``<seed>/split/<n>``: ``split`` of each key in n (SPLIT_NS);
- ``<seed>/uniform/<i>``, ``<seed>/randint/<i>``: ``uniform`` and
  ``randint`` of each key at UNIFORM_CASES[i] / RANDINT_CASES[i].

Regenerate (only after a deliberate change of jax.random or the cases):

    JAX_PLATFORMS=cpu python tests/fixtures_torch/make_rng_fixture.py

About 15 seconds (each shape compiles once); it refuses any JAX backend
other than the CPU.
"""

from __future__ import annotations

import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
PATH = os.path.join(HERE, "rng_jax.npz")


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    if jax.default_backend() != "cpu":
        raise SystemExit("run with JAX_PLATFORMS=cpu")
    import jax.numpy as jnp

    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import test_torch_rng as tr

    def wrap(k):
        return jax.random.wrap_key_data(jnp.asarray(k))

    out = {}
    for seed in tr.SEEDS:
        k = jax.random.PRNGKey(seed)
        out[f"{seed}/key"] = np.asarray(jax.random.key_data(k))
        for i, data in enumerate(tr.FOLD_DATA):
            out[f"{seed}/fold_in/{i}"] = np.asarray(jax.random.key_data(
                jax.random.fold_in(k, jnp.int32(data))))
        ks = np.asarray(jax.random.key_data(jax.random.split(k, 6)))
        out[f"{seed}/keys"] = ks
        for n in tr.SPLIT_NS:
            out[f"{seed}/split/{n}"] = np.stack([np.asarray(
                jax.random.key_data(jax.random.split(wrap(x), n)))
                for x in ks])
        for i, (shape, lo, hi) in enumerate(tr.UNIFORM_CASES):
            out[f"{seed}/uniform/{i}"] = np.stack([np.asarray(
                jax.random.uniform(wrap(x), shape, minval=lo, maxval=hi))
                for x in ks])
        for i, (shape, lo, hi) in enumerate(tr.RANDINT_CASES):
            out[f"{seed}/randint/{i}"] = np.stack([np.asarray(
                jax.random.randint(wrap(x), shape, lo, hi)) for x in ks])
    np.savez_compressed(PATH, **out)
    print(f"wrote {PATH}: {len(out)} arrays")


if __name__ == "__main__":
    main()
