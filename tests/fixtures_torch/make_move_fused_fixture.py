"""Write the fused-movement fixture of the PyTorch port's tests.

Runs the JAX package's fused collide-and-slide + fall probe
(tools/probes/movement_fused_probe.py apply_velocity_fall_fused, loaded by
path) through the Pallas interpreter on the CPU (MPENV_PALLAS=interpret),
world by world under jax.vmap as tests/test_pallas_parity.py
TestMovementFused runs it, on three cases:

- ``dense``: TestMovementFused._mk_world's random world (seed 11, 12
  worlds x 12 agents, a ground plane and 40 random obstacle triangles
  padded to 128), no culling tables: the probe's dense kernel;
- ``culled``: data/simple_map with its short tables: the probe's culled
  kernel. Agent positions are the committed slice fixture's
  (zone_simple_map_slice.npz, 17 states x 2 worlds x 4 agents, taken as
  17 worlds of 8 agents); velocities, poses and alive flags are drawn
  from seed 23 as _mk_world draws them;
- ``still``: _mk_world(17, 4 worlds) with zero velocity, standing, at
  z = 20 (test_fused_noop_when_still's state): inputs only.

For each case it records the triangle vertices (dense and still), the
input pos, vel, stand_cur and alive, and the probe's output pos and vel,
into zone_move_fused.npz beside this file. tests/test_torch_move_fused.py
holds the port's plain fused movement to it.

Regenerate (only after a deliberate change of the JAX probe):

    JAX_PLATFORMS=cpu python tests/fixtures_torch/make_move_fused_fixture.py
"""

from __future__ import annotations

import importlib.util
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
PATH = os.path.join(HERE, "zone_move_fused.npz")
SLICE = os.path.join(HERE, "zone_simple_map_slice.npz")
CULLED_SEED = 23


def _probe():
    """The probe, loaded by path as a module of madrona_mp_env_tpu.ops
    (where it was written: its culled entry imports ``.culling``)."""
    import madrona_mp_env_tpu.ops  # noqa: F401

    path = os.path.join(REPO, "tools", "probes", "movement_fused_probe.py")
    spec = importlib.util.spec_from_file_location(
        "madrona_mp_env_tpu.ops.movement_fused_probe", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _random_soup(key, n_tris, extent):
    """tests/test_pallas_parity.py random_soup's triangles."""
    import jax

    k1, k2 = jax.random.split(key)
    centers = jax.random.uniform(k1, (n_tris, 1, 3), minval=-extent,
                                 maxval=extent)
    offsets = jax.random.uniform(k2, (n_tris, 3, 3), minval=-40.0,
                                 maxval=40.0)
    return np.asarray(centers + offsets, np.float32)


def _draws(ks, W, A):
    """_mk_world's velocity, pose and alive draws from keys ks[3:6]."""
    import jax
    import jax.numpy as jnp

    vel = jax.random.uniform(ks[3], (W, A, 3), minval=-220.0, maxval=220.0)
    cur = jax.random.randint(ks[4], (W, A), 0, 3)
    alive = (jax.random.uniform(ks[5], (W, A)) > 0.1).astype(jnp.float32)
    return vel, cur, alive


def _state(cfg, W, pos, vel, cur, alive):
    import jax
    import jax.numpy as jnp
    from madrona_mp_env_tpu.sim.types import init_world_state

    st = init_world_state(cfg, 1)
    st = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x[None], (W,) + x.shape), st)
    # the probe reads only pos, vel, stand_cur and alive
    return st.replace(pos=jnp.asarray(pos), vel=jnp.asarray(vel),
                      stand_cur=jnp.asarray(cur, jnp.int32),
                      alive=jnp.asarray(alive, jnp.float32))


def _mk_world(seed, W):
    """TestMovementFused._mk_world: (triangles, pos, vel, cur, alive)."""
    import jax

    import madrona_mp_env_tpu as mp

    A = mp.EnvConfig(task=mp.Task.Zone, team_size=6).num_agents
    ks = jax.random.split(jax.random.PRNGKey(seed), 6)
    ground = np.array(
        [[[-500, -500, 0], [500, -500, 0], [500, 500, 0]],
         [[-500, -500, 0], [500, 500, 0], [-500, 500, 0]]], np.float32)
    tris = np.concatenate([ground, _random_soup(ks[0], 40, 220.0)], axis=0)
    pos = jax.random.uniform(ks[1], (W, A, 3), minval=-250.0, maxval=250.0)
    pos = pos.at[..., 2].set(
        jax.random.uniform(ks[2], (W, A), minval=1.0, maxval=40.0))
    vel, cur, alive = _draws(ks, W, A)
    return tris, np.array(pos), np.array(vel), np.array(cur), \
        np.array(alive)


class _M:
    def __init__(self, soup, short=None):
        self.tris = soup
        self.cells = None
        self.short = short


def main():
    os.environ["MPENV_PALLAS"] = "interpret"
    sys.path.insert(0, REPO)
    import jax

    jax.config.update("jax_platforms", "cpu")
    import madrona_mp_env_tpu as mp
    from madrona_mp_env_tpu.assets.map_data import load_map
    from madrona_mp_env_tpu.ops.raycast import make_tri_soup

    probe = _probe()
    cfg = mp.EnvConfig(task=mp.Task.Zone, team_size=6)
    out = {}

    def run(tag, m, W, pos, vel, cur, alive):
        st = _state(cfg, W, pos, vel, cur, alive)
        res = jax.vmap(lambda s: probe.apply_velocity_fall_fused(
            cfg, m, s))(st)
        out.update({f"{tag}/pos": pos, f"{tag}/vel": vel,
                    f"{tag}/stand_cur": np.asarray(cur, np.int32),
                    f"{tag}/alive": np.asarray(alive, np.float32),
                    f"{tag}/out_pos": np.asarray(res.pos),
                    f"{tag}/out_vel": np.asarray(res.vel)})

    tris, pos, vel, cur, alive = _mk_world(11, 12)
    out["dense/tris"] = tris
    run("dense", _M(make_tri_soup(tris, pad_to=128)), 12, pos, vel, cur,
        alive)

    m = load_map(os.path.join(REPO, "data", "simple_map"), cfg)
    pos = np.load(SLICE)["pos"].reshape(17, 8, 3).astype(np.float32)
    ks = jax.random.split(jax.random.PRNGKey(CULLED_SEED), 6)
    vel, cur, alive = (np.asarray(x) for x in _draws(ks, 17, 8))
    run("culled", m, 17, pos, vel, cur, alive)

    tris, pos, vel, cur, alive = _mk_world(17, 4)
    pos[..., 2] = 20.0
    out.update({"still/tris": tris, "still/pos": pos,
                "still/vel": np.zeros_like(vel),
                "still/stand_cur": np.zeros_like(cur, np.int32),
                "still/alive": alive})
    np.savez_compressed(PATH, **out)
    print(f"wrote {PATH} ({os.path.getsize(PATH)} bytes)")


if __name__ == "__main__":
    main()
