"""Write the town_map fixture of the PyTorch port's tests.

Runs the JAX package's Env on the CPU with make_slice_fixture.py's
configuration and actions (Zone 2v2, 2 worlds, seed 5, StaggerStarts |
RandomFlipTeams, Default reward, policy agents, the unfused scalar tail,
16 steps) on data/town_map, the big map: 6,108 triangles padded to 6,144,
with PVS cell tables (culling.npz). The JAX CPU path sweeps the whole
soup everywhere (its culled fan and packed casts are TPU kernels), so
this rollout is the canon the port's culled path is held to. Records the
actions and the per-step leaves as make_slice_fixture.py does, the
full state leaves after the steps in FAN_STEPS (``state<s>/<leaf>``),
whose sensor fans tests/test_torch_town.py sweeps, and the JAX dense
sphere cast of ``packed_casts``' L2/L3/fall-shaped casts (``casts/x``,
``casts/o``, ``casts/d``, ``casts/t``), which it holds the packed casts
to.

Regenerate (only after a deliberate change of the JAX reference):

    JAX_PLATFORMS=cpu python tests/fixtures_torch/make_town_fixture.py
"""

from __future__ import annotations

import os

import numpy as np

import make_slice_fixture as fx

HERE = os.path.dirname(os.path.abspath(__file__))
PATH = os.path.join(HERE, "zone_town_map_slice.npz")
SCENE = "town_map"
FAN_STEPS = (0, 8, 15)  # the reset and two later steps
CAST_RADIUS = 15.0  # the agent radius


def packed_casts(nav_verts, n=128, seed=3):
    """L2/L3/fall-shaped casts from walkable points x [n, 3] of the map
    (navmesh vertices nav_verts [V, 3]): a ground check from up to 2r off
    the agent's column and a flat forward cast from up to 20 along.
    Returns (x, o [n, 2, 3], d [n, 2, 3]) float32."""
    g = np.random.default_rng(seed)
    v = np.asarray(nav_verts)
    x = (v[g.integers(0, len(v), n)] + [0.0, 0.0, 1.0]).astype(np.float32)
    ang = g.uniform(0, 2 * np.pi, n)
    flat = np.stack([np.cos(ang), np.sin(ang), np.zeros(n)], -1)
    down_o = x + flat * g.uniform(0, 30.0, (n, 1)) + [0.0, 0.0, 50.0]
    fwd_o = x + flat * g.uniform(0, 20.0, (n, 1)) + [0.0, 0.0, 30.0]
    turn = g.uniform(-1.5, 1.5, n) + ang
    fwd_d = np.stack([np.cos(turn), np.sin(turn), np.zeros(n)], -1)
    down_d = np.broadcast_to([0.0, 0.0, -1.0], (n, 3))
    o = np.stack([down_o, fwd_o], 1).astype(np.float32)
    d = np.stack([down_d, fwd_d], 1).astype(np.float32)
    return x, o, d


def cast_leaves():
    """The JAX dense sphere cast of packed_casts on the map, run eagerly
    (under jit XLA contracts a + b * c into fused multiply-adds)."""
    from madrona_mp_env_tpu import EnvConfig
    from madrona_mp_env_tpu.assets.map_data import load_map
    from madrona_mp_env_tpu.ops import raycast as jrc

    m = load_map(os.path.join(fx.REPO, "data", SCENE),
                 EnvConfig(team_size=fx.TEAM_SIZE))
    x, o, d = packed_casts(m.nav_verts)
    t, _ = jrc._sphere_cast_vs_tris_dense(o, d, CAST_RADIUS, m.tris)
    return {"casts/x": x, "casts/o": o, "casts/d": d,
            "casts/t": np.asarray(t)}


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    states = {}

    def keep(s, state):
        if s + 1 in FAN_STEPS:
            states.update({
                f"state{s + 1}/{k}": np.asarray(getattr(state, k))
                for k in state.__dataclass_fields__
            })

    hist = fx.jax_rollout(scene=SCENE, on_step=keep)
    hist.update(states)
    hist.update(cast_leaves())
    np.savez_compressed(PATH, **hist)
    print(f"wrote {PATH} ({os.path.getsize(PATH)} bytes)")


if __name__ == "__main__":
    main()
