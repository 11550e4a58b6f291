"""Write kernel_refs_jax.npz: the JAX package's outputs that
tests/test_torch_flat.py and tests/test_torch_cap_fan.py hold the port's
plain versions to.

The inputs are made by those test modules' own helpers (numpy and the
port's simple_map; no JAX) and stored beside the outputs; each test
checks its inputs against the stored ones first. The JAX calls run
eagerly, pinned as the tests pinned them before:

- ``fan/{org,zoff,d,t}``: ``ray_fans_vs_tris`` (MPENV_PALLAS=dense) on
  test_torch_flat's K7 cases, one call with a ray per fan;
- ``sc_<kind>/{o,d}``, ``sc_<kind>/t_<t_max>``, ``sc_<kind>/n_<t_max>``:
  ``sphere_cast_vs_tris`` (dense) on its random and movement casts at
  t_max inf and 20;
- ``cap/{o,d,self_idx,pos,alive,t,idx}``: ``ray_vs_capsules`` with each
  ray's self column masked, then min / argmin (-1 on a miss), per world;
- ``capfan/{pos,zg,dirs,alive,t,idx}``: ``fan_capsules_planar``
  (MPENV_PALLAS=interpret, its Pallas kernel in interpret mode) on
  test_torch_cap_fan's clustered fans (2 worlds of 12, seed 5), vmapped
  over worlds.

Regenerate (only after a deliberate change of the JAX reference or of the
inputs):

    JAX_PLATFORMS=cpu python tests/fixtures_torch/make_kernel_refs_fixture.py

About 30 seconds; it refuses any JAX backend other than the CPU.
"""

from __future__ import annotations

import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
PATH = os.path.join(HERE, "kernel_refs_jax.npz")


def main():
    os.environ["MPENV_PALLAS"] = "dense"
    import jax

    jax.config.update("jax_platforms", "cpu")
    if jax.default_backend() != "cpu":
        raise SystemExit("run with JAX_PLATFORMS=cpu")
    import jax.numpy as jnp

    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import madrona_mp_env_tpu as mp
    import madrona_mp_env_tpu_torch as mt
    import test_torch_cap_fan as tcf
    import test_torch_flat as tf
    from madrona_mp_env_tpu import consts
    from madrona_mp_env_tpu.assets.map_data import load_map as jload_map
    from madrona_mp_env_tpu.ops import raycast as jrc
    from madrona_mp_env_tpu.ops.raycast_cull import fan_capsules_planar
    from madrona_mp_env_tpu_torch.assets.map_data import load_map

    scene = os.path.join(REPO, "data", "simple_map")
    jm = jload_map(scene, mp.EnvConfig(**tf.MAP_CFG))
    tm = load_map(scene, mt.EnvConfig(**tf.MAP_CFG), device="cpu")
    out = {}

    org, zoff, d = tf.fan_rays(tf.fan_inputs(tm))
    out.update({"fan/org": org, "fan/zoff": zoff, "fan/d": d})
    out["fan/t"] = np.asarray(jrc.ray_fans_vs_tris(org, zoff, d,
                                                   jm.tris))[:, 0]

    for kind in ("random", "movement"):
        o, d = tf._casts(tm, kind, np.random.default_rng(41))
        out[f"sc_{kind}/o"], out[f"sc_{kind}/d"] = o, d
        for t_max in tf.SC_T_MAX:
            t, n = jrc.sphere_cast_vs_tris(o, d, tf.R, jm.tris, t_max)
            out[f"sc_{kind}/t_{t_max}"] = np.asarray(t)
            out[f"sc_{kind}/n_{t_max}"] = np.asarray(n)

    o, d, self_idx, pos, alive = tf.capsule_inputs(tm)
    A = pos.shape[1]

    def one_world(oo, dd, si, p, al):
        t = jrc.ray_vs_capsules(oo, dd, p, tf.R, tf.SEG_H, al)  # [A, F, A]
        t = jnp.where(si[..., None] == jnp.arange(A), jnp.inf, t)
        tm_, ix = jnp.min(t, -1), jnp.argmin(t, -1)
        return tm_, jnp.where(jnp.isinf(tm_), -1, ix)

    t, idx = jax.vmap(one_world)(o, d, self_idx, pos, alive)
    out.update({"cap/o": o, "cap/d": d, "cap/self_idx": self_idx,
                "cap/pos": pos, "cap/alive": alive, "cap/t": np.asarray(t),
                "cap/idx": np.asarray(idx)})

    os.environ["MPENV_PALLAS"] = "interpret"
    pos, zg, dirs, zgroups, alive = tcf._clustered_fans(*tcf.PLANAR_FANS)
    zoff = np.repeat(zg.numpy(), zgroups, axis=-1)
    tj, ij = jax.vmap(lambda p, z, dx, dy, dz, al: fan_capsules_planar(
        p, z, (dx, dy, dz), al, consts.agent_radius,
        tcf.raycast_cull.CAPSULE_SEG_H))(
        jnp.asarray(pos.numpy()), jnp.asarray(zoff),
        *(jnp.asarray(c.numpy()) for c in dirs),
        jnp.asarray(alive.numpy() > 0.0))
    out.update({"capfan/pos": pos.numpy(), "capfan/zg": zg.numpy(),
                "capfan/dirs": np.stack([c.numpy() for c in dirs]),
                "capfan/alive": alive.numpy(), "capfan/t": np.asarray(tj),
                "capfan/idx": np.asarray(ij)})

    np.savez_compressed(PATH, **out)
    print(f"wrote {PATH}: {len(out)} arrays")


if __name__ == "__main__":
    main()
