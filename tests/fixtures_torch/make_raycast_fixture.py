"""Write the ray-sweep fixture of the PyTorch port's ray tests.

tests/test_torch_raycast.py holds the port's plain sweeps to the JAX
package's dense CPU functions on rays made from seeds on simple_map. The
JAX side runs eagerly, op by op (see that module's docstring), and the
eager ops' first calls compile one by one: seconds a case. This script
runs them once and stores each case's inputs (made by the test module's
own helpers) beside the JAX outputs in raycast_jax.npz:

- ``ray_vs_tris/{o,d,t}``: ``_ray_vs_tris_dense``;
- ``ray_fans<i>/{org,zg,d,t}``: ``ray_fans_vs_tris`` (MPENV_PALLAS=dense)
  for each z-group case ``ZGROUPS[i]``;
- ``capsules/{pos,alive,d,t,idx}``: ``ray_vs_capsules`` with the own
  capsule masked, nearest t and its index (-1 on a miss);
- ``sphere<seed>/{o,d,t,idx,normal}``: ``_sphere_cast_vs_tris_dense`` and
  ``_sphere_cast_winner_idx_dense``;
- ``v9/{org,zoff,dx,dy,dz,cells}`` the sensor fans of a Zone 6v6 reset at
  2 worlds, ``v9/interpret`` the TPU kernel ``ray_fans_culled_v9`` in
  Pallas interpret mode and ``v9/sweep`` the jnp sweep over each ray's
  candidate rows (``culling._dense_ray_idx`` under jit).

The test checks that its inputs equal the stored ones before comparing.

Regenerate (only after a deliberate change of the JAX reference or of
the inputs):

    JAX_PLATFORMS=cpu python tests/fixtures_torch/make_raycast_fixture.py

About 40 seconds; it refuses any JAX backend other than the CPU.
"""

from __future__ import annotations

import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
PATH = os.path.join(HERE, "raycast_jax.npz")


def main():
    os.environ["MPENV_PALLAS"] = "dense"
    import jax

    jax.config.update("jax_platforms", "cpu")
    if jax.default_backend() != "cpu":
        raise SystemExit("run with JAX_PLATFORMS=cpu")
    import jax.numpy as jnp

    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "tests"))
    sys.path.insert(0, HERE)
    import test_torch_raycast as tr
    from madrona_mp_env_tpu.ops import culling as jcull
    from madrona_mp_env_tpu.ops import raycast as jrc

    jm, tm = tr.load_maps(os.path.join(REPO, "data", "simple_map"))
    out = {}

    o, d = tr.ray_inputs(tm)
    out.update({"ray_vs_tris/o": o, "ray_vs_tris/d": d,
                "ray_vs_tris/t": jrc._ray_vs_tris_dense(o, d, jm.tris)})

    for i, zgroups in enumerate(tr.ZGROUPS):
        org, zg, dd = tr.fan_inputs(tm, zgroups)
        zoff = np.repeat(zg, zgroups, axis=1)
        out.update({f"ray_fans{i}/org": org, f"ray_fans{i}/zg": zg,
                    f"ray_fans{i}/d": dd,
                    f"ray_fans{i}/t": jrc.ray_fans_vs_tris(org, zoff, dd,
                                                           jm.tris)})

    pos, alive, dd = tr.capsule_inputs(tm)
    A = pos.shape[1]

    def one_world(p, al, dw):
        oo = p[:, None, :] + jnp.array([0.0, 0.0, 50.0])
        t = jrc.ray_vs_capsules(oo, dw, p, tr.R, tr.SEG_H, al)  # [A, F, A]
        t = jnp.where(jnp.arange(A)[:, None, None] == jnp.arange(A),
                      jnp.inf, t)
        tmin, ix = jnp.min(t, -1), jnp.argmin(t, -1)
        return tmin, jnp.where(jnp.isinf(tmin), -1, ix)

    t, ix = jax.vmap(one_world)(pos, alive, dd)
    out.update({"capsules/pos": pos, "capsules/alive": alive,
                "capsules/d": dd, "capsules/t": t, "capsules/idx": ix})

    for seed in tr.CAST_SEEDS:
        o, d = tr.cast_inputs(tm, seed)
        t, n = jrc._sphere_cast_vs_tris_dense(o, d, tr.R, jm.tris)
        out.update({f"sphere{seed}/o": o, f"sphere{seed}/d": d,
                    f"sphere{seed}/t": t, f"sphere{seed}/normal": n,
                    f"sphere{seed}/idx": jrc._sphere_cast_winner_idx_dense(
                        o, d, tr.R, jm.tris)})

    org, zoff, dirs, cells = tr.v9_inputs(tm)
    org, zoff, cells = org.numpy(), zoff.numpy(), cells.numpy()
    dirs = tuple(c.numpy() for c in dirs)
    out.update({"v9/org": org, "v9/zoff": zoff, "v9/dx": dirs[0],
                "v9/dy": dirs[1], "v9/dz": dirs[2], "v9/cells": cells})
    os.environ["MPENV_PALLAS"] = "interpret"
    from madrona_mp_env_tpu.ops.raycast_pallas import ray_fans_culled_v9

    out["v9/interpret"] = ray_fans_culled_v9(
        jnp.asarray(org), jnp.asarray(zoff),
        tuple(jnp.asarray(c) for c in dirs), jnp.asarray(cells),
        jm.ray_cells)
    F = zoff.shape[1]
    zero = np.zeros_like(zoff)
    o = org[:, None, :] + np.stack([zero, zero, zoff], -1)
    d = np.stack(dirs, -1)
    ids = np.asarray(jm.ray_cells.cand_idx)[np.repeat(cells, F)]
    safe = np.maximum(ids, 0)
    s = jm.tris
    out["v9/sweep"] = jax.jit(jax.vmap(
        lambda oo, dw, a, b, c, vv: jcull._dense_ray_idx(
            oo, dw, a, b, c, vv)[0]))(
        o.reshape(-1, 3), d.reshape(-1, 3), s.v0[safe], s.e1[safe],
        s.e2[safe], s.valid[safe] & jnp.asarray(ids >= 0)).reshape(
            zoff.shape)
    np.savez_compressed(PATH, **{k: np.asarray(v) for k, v in out.items()})
    print(f"wrote {PATH} ({os.path.getsize(PATH)} bytes)")


if __name__ == "__main__":
    main()
