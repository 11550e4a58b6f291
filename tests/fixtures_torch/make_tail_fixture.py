"""Write the fused-tail fixture of the PyTorch port's tests.

tests/test_torch_tail.py and tests/test_torch_curriculum.py hold the
port's plain fused tail (``ops/tail_fused.tail_fused_plain``) to the JAX
package's own fused-tail kernel function (``ops/tail_pallas.
_tail_batched``, Pallas in interpret mode, run eagerly), whose first call
costs seconds of tracing. This script runs it once on the inputs those
tests make (their own helpers, from seeds) and stores, for each case,
the input state's leaves, force_reset and the kernel's output leaves and
captures in tail_jax.npz:

- ``k5/<ts>/...``: test_torch_tail's scenario at team size 2 and 6;
- ``ls/<ts>/...``: test_torch_curriculum's LearnShooting scenario
  (SimFlags.EnableCurriculum, planted world curricula) at 2 and 6.

Each key holds ``in/<leaf>``, ``fr``, ``out/<leaf>`` and ``cap``; the
tests check that their inputs equal the stored ones first.

Regenerate (only after a deliberate change of the JAX reference or of
the inputs):

    JAX_PLATFORMS=cpu python tests/fixtures_torch/make_tail_fixture.py

About 30 seconds; it refuses any JAX backend other than the CPU.
"""

from __future__ import annotations

import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
PATH = os.path.join(HERE, "tail_jax.npz")


def main():
    os.environ["MPENV_PALLAS"] = "interpret"
    import jax

    jax.config.update("jax_platforms", "cpu")
    if jax.default_backend() != "cpu":
        raise SystemExit("run with JAX_PLATFORMS=cpu")
    import jax.numpy as jnp

    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "tests"))
    sys.path.insert(0, HERE)
    import test_torch_curriculum as tc
    import test_torch_tail as tt
    import madrona_mp_env_tpu as mp
    import madrona_mp_env_tpu_torch as mt
    from madrona_mp_env_tpu.ops import tail_pallas
    from madrona_mp_env_tpu.sim.types import WorldState as JaxWorldState
    from madrona_mp_env_tpu_torch.assets.map_data import load_map

    scene = os.path.join(REPO, "data", "simple_map")
    out = {}

    def run(case, jcfg, m, leaves, fr):
        js = JaxWorldState(**{k: jnp.asarray(v) for k, v in leaves.items()})
        js, cap = tail_pallas._tail_batched(jcfg, tc._jax_map(m), js,
                                            jnp.asarray(fr))
        out[f"{case}/fr"] = fr
        out[f"{case}/cap"] = np.asarray(cap)
        for k, v in leaves.items():
            out[f"{case}/in/{k}"] = v
            out[f"{case}/out/{k}"] = np.asarray(getattr(js, k))

    for ts in (2, 6):
        m = load_map(scene, tt._cfg(ts), device="cpu")
        leaves, fr, _ = tt._states(ts, m)
        run(f"k5/{ts}", tt.jax_cfg(ts), m, leaves, fr)
        cfg = tc._ls_cfg(mt, ts)
        m = load_map(scene, cfg, device="cpu")
        leaves, fr = tc._tail_states(ts, m, cfg)
        run(f"ls/{ts}", tc._ls_cfg(mp, ts), m, leaves, fr)
    np.savez_compressed(PATH, **out)
    print(f"wrote {PATH} ({os.path.getsize(PATH)} bytes)")


if __name__ == "__main__":
    main()
