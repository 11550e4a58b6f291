"""Write the scripted-bot fixture of the PyTorch port's tests.

Runs the JAX package on the CPU and writes zone_simple_map_bots.npz beside
this file, for tests/test_torch_bot.py:

- ``roll/*``: the whole-slice rollout of make_slice_fixture.py (Zone 2v2
  on data/simple_map, 2 worlds, seed 5, StaggerStarts | RandomFlipTeams,
  the unfused scalar tail, 16 steps of the same numpy-drawn actions) with
  team 1 of every world set to the scripted bot (policy idx -1) after the
  reset. Recorded as make_slice_fixture.record does.
- ``plan/<leaf>``: the planner's inputs in the state before each of those
  steps ([steps, W, ...]) and ``plan/out/<action>``, what the JAX planner
  (sim/bot.plan_bot_actions, jitted and vmapped over the worlds with each
  world's BOT key, as the JAX step's overlay runs it) plans there.
- ``syn/<map>/*``: planner inputs drawn with numpy on data/simple_map and
  data/town_map (8 worlds x 12 agents: points anywhere in the navmesh's
  bounds, at nav vertices and near centroids; any yaw, zone, magazine and
  visibility; a wall in a window of lidar columns), the raw BOT keys, the JAX planner's outputs
  on them and JAX's _nearest_nav_tri of each point and each zone centre.
- ``*/margin_facing`` and ``*/margin_cross``: |facing - 0.6| and |cross_z|
  of every agent, in float64 from the JAX planner's own triangles, so a
  test can tell a tie from a fault.

Regenerate (only after a deliberate change of the JAX reference):

    JAX_PLATFORMS=cpu python tests/fixtures_torch/make_bot_fixture.py

It refuses any JAX backend other than the CPU.
"""

from __future__ import annotations

import os
import sys
from types import SimpleNamespace

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
PATH = os.path.join(HERE, "zone_simple_map_bots.npz")
sys.path.insert(0, HERE)
import make_slice_fixture as slice_fx  # noqa: E402

NUM_WORLDS = slice_fx.NUM_WORLDS
TEAM_SIZE = slice_fx.TEAM_SIZE
NUM_STEPS = slice_fx.NUM_STEPS
SEED = slice_fx.SEED
SYN_WORLDS = 8
SYN_TEAM_SIZE = 6
SYN_SEED = 77
PLAN_LEAVES = ("pos", "yaw", "mag_bullets", "prev_can_see", "zone_cur",
               "prev_fwd_depth", "policy_idx", "episode_key", "cur_step")
ACTION_LEAVES = ("move_amount", "move_angle", "fire", "stand", "aim_yaw",
                 "aim_pitch", "aim_yaw_rate", "aim_pitch_rate")
MAPS = ("simple_map", "town_map")


def bot_mask(num_agents, team_size):
    """[A] bool: the agents of team 1."""
    return np.arange(num_agents) // team_size == 1


def synthetic_inputs(nav_verts, nav_tris, centroids, num_zones,
                     W=SYN_WORLDS, A=2 * SYN_TEAM_SIZE, seed=SYN_SEED):
    """Planner inputs drawn with numpy: {leaf: [W, ...]} and key [W, 2]."""
    g = np.random.default_rng(seed)
    lo, hi = nav_verts[:, :2].min(0), nav_verts[:, :2].max(0)
    n = W * A
    pts = g.uniform(lo, hi, size=(n, 2))
    third = n // 3
    vi = g.integers(0, nav_verts.shape[0], third)
    pts[:third] = nav_verts[vi, :2]  # on triangle corners: edge ties
    ci = g.integers(0, centroids.shape[0], third)
    pts[third:2 * third] = centroids[ci, :2] + g.normal(0, 5.0, (third, 2))
    pos = np.concatenate([pts, g.uniform(-60, 60, (n, 1))], -1)
    # a wall in a window of lidar columns around a random one, so every
    # avoidance segment 0..7 is reached; 30% of agents see nothing close
    # (the waypoint steers)
    col = np.arange(32)
    centre = g.integers(0, 32, (W, A, 1, 1))
    half = g.integers(0, 6, (W, A, 1, 1))
    near = (np.abs(col - centre) <= half) & (g.random((W, A, 2, 32)) < 0.8)
    depth = np.where(near, g.uniform(0.0, 16.0, (W, A, 2, 32)),
                     g.uniform(16.0, 100.0, (W, A, 2, 32)))
    depth[g.random((W, A)) < 0.3] = 100.0
    depth = depth.astype(np.float32)
    return {
        "pos": pos.reshape(W, A, 3).astype(np.float32),
        "yaw": g.uniform(-np.pi, np.pi, (W, A)).astype(np.float32),
        "mag_bullets": g.integers(0, 3, (W, A)).astype(np.int32),
        "prev_can_see": g.random((W, A, A // 2)) < 0.15,
        "zone_cur": g.integers(0, num_zones, (W,)).astype(np.int32),
        "prev_fwd_depth": depth,
    }, g.integers(0, 2 ** 32, (W, 2), dtype=np.uint64).astype(np.uint32)


def margins(m, leaves):
    """(|facing - 0.6|, |cross_z|) [W, A] in float64, on the triangles the
    JAX planner picks (its _nearest_nav_tri and next-hop table)."""
    import jax.numpy as jnp

    from madrona_mp_env_tpu.sim.bot import _nearest_nav_tri

    zmin, zmax = np.asarray(m.zone_min), np.asarray(m.zone_max)
    zc = 0.5 * (zmin[leaves["zone_cur"]] + zmax[leaves["zone_cur"]])
    start = np.asarray(_nearest_nav_tri(m, jnp.asarray(leaves["pos"])))
    goal = np.asarray(_nearest_nav_tri(m, jnp.asarray(zc)))
    nxt = np.asarray(m.nav_next_hop)[start, goal[:, None]]
    cent = np.asarray(m.nav_centroids).astype(np.float64)
    wp = cent[np.clip(nxt, 0, cent.shape[0] - 1), :2]
    wp = np.where((nxt == goal[:, None])[..., None], zc[:, None, :2], wp)
    wp = np.where((nxt == -1)[..., None], 0.0, wp)
    to = wp - leaves["pos"][..., :2].astype(np.float64)
    d = to / np.maximum(np.linalg.norm(to, axis=-1, keepdims=True), 1e-30)
    yaw = leaves["yaw"].astype(np.float64)
    fx, fy = -np.sin(yaw), np.cos(yaw)
    return (np.abs(fx * d[..., 0] + fy * d[..., 1] - 0.6),
            np.abs(fx * d[..., 1] - fy * d[..., 0]))


def jax_planner(cfg, m):
    """(leaves, keys [W, 2]) -> {action: [W, A]}: the JAX planner, jitted
    and vmapped over the worlds."""
    import jax

    from madrona_mp_env_tpu.sim.bot import plan_bot_actions

    def one(pos, yaw, mag, see, zone, depth, key):
        s = SimpleNamespace(pos=pos, yaw=yaw, mag_bullets=mag,
                            prev_can_see=see, zone_cur=zone,
                            prev_fwd_depth=depth)
        return plan_bot_actions(cfg, m, s, key)

    f = jax.jit(jax.vmap(one))

    def run(leaves, keys):
        a = f(*(leaves[k] for k in ("pos", "yaw", "mag_bullets",
                                    "prev_can_see", "zone_cur",
                                    "prev_fwd_depth")), keys)
        return {k: np.asarray(getattr(a, k)) for k in ACTION_LEAVES}

    return run


def bot_keys(leaves):
    """Each world's BOT system key of the step: [W, 2] uint32."""
    import jax
    import jax.numpy as jnp

    from madrona_mp_env_tpu.utils import rng

    def one(ek, step):
        return jax.random.key_data(
            rng.system_key(rng.step_key(ek, step), rng.Salt.BOT))

    return np.asarray(jax.vmap(one)(jnp.asarray(leaves["episode_key"]),
                                    jnp.asarray(leaves["cur_step"])))


def rollout():
    """The slice rollout with team 1 as bots: (roll hist, plan inputs per
    step, planner outputs per step)."""
    os.environ["MPENV_TAIL_FUSED"] = "0"
    import jax.numpy as jnp

    import madrona_mp_env_tpu as mp
    from madrona_mp_env_tpu.sim.types import Actions

    cfg = mp.EnvConfig(
        task=mp.Task.Zone, team_size=TEAM_SIZE,
        sim_flags=mp.SimFlags.StaggerStarts | mp.SimFlags.RandomFlipTeams,
    )
    env = mp.Env(cfg, os.path.join(REPO, "data", "simple_map"),
                 num_worlds=NUM_WORLDS, seed=SEED)
    plan = jax_planner(cfg, env.map_data)
    acts = slice_fx.draw_actions()
    state, obs = env.reset()
    bots = bot_mask(cfg.num_agents, TEAM_SIZE)
    state = state.replace(policy_idx=jnp.where(
        jnp.asarray(bots)[None, :], -1, state.policy_idx))
    rec, ins, outs = {}, {}, {}
    slice_fx.record(rec, state, obs)
    zf = jnp.zeros((NUM_WORLDS, cfg.num_agents), jnp.float32)
    for s in range(NUM_STEPS):
        leaves = {k: np.asarray(getattr(state, k)) for k in PLAN_LEAVES}
        out = plan(leaves, bot_keys(leaves))
        mf, mc = margins(env.map_data, leaves)
        for k, v in leaves.items():
            ins.setdefault(k, []).append(v)
        for k, v in out.items():
            outs.setdefault(k, []).append(v)
        ins.setdefault("margin_facing", []).append(mf)
        ins.setdefault("margin_cross", []).append(mc)
        a = Actions(**{k: jnp.asarray(v[s]) for k, v in acts.items()},
                    aim_yaw_rate=zf, aim_pitch_rate=zf)
        state, o = env.step(state, a)
        slice_fx.record(rec, state, o["obs"], o["reward"], o["done"])
    out = {f"roll/{k}": v for k, v in acts.items()}
    out.update({f"roll/{k}": np.stack(v) for k, v in rec.items()})
    out.update({f"plan/{k}": np.stack(v) for k, v in ins.items()})
    out.update({f"plan/out/{k}": np.stack(v) for k, v in outs.items()})
    return out


def synthetic(scene):
    import jax.numpy as jnp

    import madrona_mp_env_tpu as mp
    from madrona_mp_env_tpu.assets.map_data import load_map
    from madrona_mp_env_tpu.sim.bot import _nearest_nav_tri

    cfg = mp.EnvConfig(task=mp.Task.Zone, team_size=SYN_TEAM_SIZE)
    m = load_map(os.path.join(REPO, "data", scene), cfg)
    leaves, keys = synthetic_inputs(
        np.asarray(m.nav_verts), np.asarray(m.nav_tri_indices),
        np.asarray(m.nav_centroids), m.num_zones)
    out = {f"syn/{scene}/{k}": v for k, v in leaves.items()}
    out[f"syn/{scene}/key"] = keys
    for k, v in jax_planner(cfg, m)(leaves, keys).items():
        out[f"syn/{scene}/out/{k}"] = v
    mf, mc = margins(m, leaves)
    out[f"syn/{scene}/margin_facing"] = mf
    out[f"syn/{scene}/margin_cross"] = mc
    zc = 0.5 * (np.asarray(m.zone_min) + np.asarray(m.zone_max))
    out[f"syn/{scene}/tri_of_pos"] = np.asarray(
        _nearest_nav_tri(m, jnp.asarray(leaves["pos"])))
    out[f"syn/{scene}/tri_of_zone"] = np.asarray(
        _nearest_nav_tri(m, jnp.asarray(zc)))
    return out


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    if jax.default_backend() != "cpu":
        raise RuntimeError("the bot fixture needs the CPU backend; run with "
                           "JAX_PLATFORMS=cpu")
    sys.path.insert(0, REPO)
    out = rollout()
    for scene in MAPS:
        out.update(synthetic(scene))
    np.savez_compressed(PATH, **out)
    tight = min(float(np.min(out[k])) for k in out if "margin" in k)
    print(f"wrote {PATH} ({os.path.getsize(PATH)} bytes); smallest "
          f"facing / cross margin {tight:.3g}")


if __name__ == "__main__":
    main()
