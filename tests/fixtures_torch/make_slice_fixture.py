"""Write the whole-slice fixture of the PyTorch port's tests.

Runs the JAX package's Env on the CPU: Zone 2v2 on data/simple_map, 2
worlds, seed 5, StaggerStarts | RandomFlipTeams, Default reward, policy
agents, the unfused scalar tail (MPENV_TAIL_FUSED=0), for 16 steps of
actions drawn with numpy from a fixed seed. Records the actions and, for
the reset and each step, pos, vel, yaw, pitch, hp, alive, reward, done,
team_points and the observation leaves, into zone_simple_map_slice.npz
beside this file. tests/test_torch_slice.py replays the same actions
through madrona_mp_env_tpu_torch.Env(device="cpu") and compares.

It also writes zone_simple_map_systems.npz for tests/test_torch_sim.py:
the JAX state after step CHAIN_STEP of that rollout, run eagerly (no jit,
so XLA fuses nothing) through each system of the step in taskgraph order,
one world at a time; entry ``<i>/<leaf>`` is the state after system i
(entry 0 is the input), ``names`` lists the systems. Two agents are
killed before the respawn and world 0 is forced to reset, so those paths
run.

Regenerate (only after a deliberate change of the JAX reference):

    JAX_PLATFORMS=cpu MPENV_TAIL_FUSED=0 \
        python tests/fixtures_torch/make_slice_fixture.py

It refuses any JAX backend other than the CPU: the fixture is the CPU
reference path's trajectory.
"""

from __future__ import annotations

import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
PATH = os.path.join(HERE, "zone_simple_map_slice.npz")
SYSTEMS_PATH = os.path.join(HERE, "zone_simple_map_systems.npz")

NUM_WORLDS = 2
TEAM_SIZE = 2
NUM_STEPS = 16
SEED = 5
ACTION_SEED = 1234
CHAIN_STEP = 6
KILLED = ((0, 1), (1, 2))  # (world, agent) killed before the respawn

STATE_KEYS = ("pos", "vel", "yaw", "pitch", "hp", "alive", "team_points")
OBS_KEYS = (
    "self", "self_pos", "teammates", "teammate_positions", "opponents",
    "opponent_positions", "opponents_last_known",
    "opponent_last_known_positions", "opponent_masks", "filters_state",
    "hp", "magazine", "alive", "reward_coefs", "fwd_lidar", "rear_lidar",
)


def draw_actions(num_steps=NUM_STEPS, num_worlds=NUM_WORLDS,
                 num_agents=2 * TEAM_SIZE, seed=ACTION_SEED):
    """bench.py's run-and-shoot action mix, [steps, W, A] int32 each."""
    g = np.random.default_rng(seed)
    shape = (num_steps, num_worlds, num_agents)

    def ri(hi):
        return g.integers(0, hi, size=shape).astype(np.int32)

    return {
        "move_amount": ri(3), "move_angle": ri(8), "fire": ri(2),
        "stand": np.zeros(shape, np.int32), "aim_yaw": ri(13),
        "aim_pitch": ri(7),
    }


def record(hist, state, obs, reward=None, done=None):
    for k in STATE_KEYS:
        hist.setdefault(k, []).append(np.asarray(getattr(state, k)))
    for k in OBS_KEYS:
        hist.setdefault("obs_" + k, []).append(np.asarray(obs[k]))
    if reward is not None:
        hist.setdefault("reward", []).append(np.asarray(reward))
        hist.setdefault("done", []).append(np.asarray(done))


def jax_rollout(chain_state=None, scene="simple_map", on_step=None,
                team_size=TEAM_SIZE):
    """The reference rollout on ``data/<scene>``: {name: [steps(+1), ...]}
    numpy arrays (state and obs leaves have the reset as entry 0).
    ``chain_state``, a list, receives the state after step CHAIN_STEP;
    ``on_step(s, state)`` is called with the state after each step s + 1
    (s = -1: the reset)."""
    os.environ["MPENV_TAIL_FUSED"] = "0"
    import jax
    import jax.numpy as jnp

    backend = jax.default_backend()
    if backend != "cpu":
        raise RuntimeError(
            f"the slice fixture needs the CPU backend, got {backend!r}; "
            "run with JAX_PLATFORMS=cpu"
        )
    sys.path.insert(0, REPO)
    import madrona_mp_env_tpu as mp
    from madrona_mp_env_tpu.sim.types import Actions

    cfg = mp.EnvConfig(
        task=mp.Task.Zone, team_size=team_size,
        sim_flags=mp.SimFlags.StaggerStarts | mp.SimFlags.RandomFlipTeams,
    )
    env = mp.Env(cfg, os.path.join(REPO, "data", scene),
                 num_worlds=NUM_WORLDS, seed=SEED)
    acts = draw_actions(num_agents=2 * team_size)
    hist = {k: v for k, v in acts.items()}
    state, obs = env.reset()
    rec = {}
    record(rec, state, obs)
    if on_step is not None:
        on_step(-1, state)
    zf = jnp.zeros((NUM_WORLDS, cfg.num_agents), jnp.float32)
    for s in range(NUM_STEPS):
        a = Actions(**{k: jnp.asarray(v[s]) for k, v in acts.items()},
                    aim_yaw_rate=zf, aim_pitch_rate=zf)
        state, out = env.step(state, a)
        record(rec, state, out["obs"], out["reward"], out["done"])
        if on_step is not None:
            on_step(s, state)
        if chain_state is not None and s + 1 == CHAIN_STEP:
            chain_state.append((env, state))
    hist.update({k: np.stack(v) for k, v in rec.items()})
    return hist


def jax_system_chain(env, state, acts):
    """Run one step's systems eagerly, world by world, from ``state``.
    Returns (names, [state leaves after each system], extras)."""
    import jax
    import jax.numpy as jnp

    from madrona_mp_env_tpu.sim import (
        breadcrumbs, combat, explore, movement, rewards, zones,
    )
    from madrona_mp_env_tpu.sim import reset as reset_mod
    from madrona_mp_env_tpu.sim.spawn import spawn_agents
    from madrona_mp_env_tpu.sim.types import Actions
    from madrona_mp_env_tpu.utils import rng

    cfg, m = env.cfg, env.map_data
    W, A = NUM_WORLDS, cfg.num_agents
    zf = jnp.zeros((A,), jnp.float32)
    ctrl = env.default_sim_ctrl()
    events = {}

    def key(s, salt):
        return rng.system_key(rng.step_key(s.episode_key, s.cur_step), salt)

    def acts_of(w):
        return Actions(**{k: jnp.asarray(v[CHAIN_STEP][w])
                          for k, v in acts.items()},
                       aim_yaw_rate=zf, aim_pitch_rate=zf)

    def fire(s, w):
        s, ev = combat.fire_system(cfg, m, s, acts_of(w),
                                   key(s, rng.Salt.FIRE))
        events.setdefault("shot_victim", []).append(ev["shot_victim"])
        return s

    def kill(s, w):
        for kw, ka in KILLED:
            if kw == w:
                s = s.replace(
                    alive=s.alive.at[ka].set(0.0), hp=s.hp.at[ka].set(0.0),
                    pos=s.pos.at[ka].set(jnp.array([0.0, 0.0, 10000.0])),
                )
        return s

    def observe(s, w):
        from madrona_mp_env_tpu.sim.step import observe_tail

        s, obs = observe_tail(cfg, m, s)
        for k in ("self", "opponents", "fwd_lidar", "rear_lidar",
                  "opponent_masks"):
            events.setdefault("obs_" + k, []).append(obs[k])
        return s

    systems = [
        ("movement", lambda s, w: movement.movement_system(cfg, s,
                                                           acts_of(w))),
        ("aim", lambda s, w: movement.aim_systems(cfg, s, acts_of(w))),
        ("apply_velocity",
         lambda s, w: movement.apply_velocity_system(cfg, m, s)),
        ("fall", lambda s, w: movement.fall_system(cfg, m, s)),
        ("fire", fire),
        ("damage", lambda s, w: combat.apply_damage_system(cfg, s)),
        ("kill", kill),
        ("respawn", lambda s, w: spawn_agents(
            cfg, m, s, key(s, rng.Salt.SPAWN), is_respawn=True)),
        ("autoheal", lambda s, w: combat.autoheal_system(cfg, s)),
        ("zone", lambda s, w: zones.zone_system(cfg, m, s)),
        ("breadcrumbs", lambda s, w: breadcrumbs.breadcrumb_system(cfg, s)),
        ("match_info", lambda s, w: zones.zone_match_info_system(
            cfg, m, s, jnp.asarray(False))[0]),
        ("filters", lambda s, w: explore.filters_system(
            cfg, s, events["shot_victim"][w])),
        ("goal_regions", lambda s, w: explore.goal_regions_system(cfg, m,
                                                                  s)),
        ("explore", lambda s, w: explore.explore_visited_system(cfg, s)),
        ("rewards", lambda s, w: rewards.reward_system(cfg, m, s)),
        ("reset", lambda s, w: reset_mod.reset_system(
            cfg, m, s, env.init_key_data, jnp.asarray(ctrl),
            jnp.int32(1 if w == 0 else 0))),
        ("observe", observe),
    ]
    worlds = [jax.tree_util.tree_map(lambda x, w=w: x[w], state)
              for w in range(W)]
    chain = [state]
    with jax.disable_jit():
        for name, fn in systems:
            worlds = [fn(s, w) for w, s in enumerate(worlds)]
            chain.append(jax.tree_util.tree_map(
                lambda *xs: jnp.stack(xs), *worlds))
    leaves = [{k: np.asarray(getattr(c, k))
               for k in c.__dataclass_fields__} for c in chain]
    extras = {k: np.stack([np.asarray(x) for x in v])
              for k, v in events.items()}
    return [n for n, _ in systems], leaves, extras


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    chain_state = []
    hist = jax_rollout(chain_state)
    np.savez_compressed(PATH, **hist)
    print(f"wrote {PATH} ({NUM_STEPS} steps, {os.path.getsize(PATH)} bytes)")
    env, state = chain_state[0]
    names, leaves, extras = jax_system_chain(env, state, draw_actions())
    out = {"names": np.asarray(names)}
    for i, lv in enumerate(leaves):
        out.update({f"{i}/{k}": v for k, v in lv.items()})
    out.update({f"extra/{k}": v for k, v in extras.items()})
    np.savez_compressed(SYSTEMS_PATH, **out)
    print(f"wrote {SYSTEMS_PATH} ({os.path.getsize(SYSTEMS_PATH)} bytes)")


if __name__ == "__main__":
    main()
