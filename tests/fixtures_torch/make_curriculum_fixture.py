"""Write the full-team and curriculum fixture of the PyTorch port's tests.

Runs the JAX package's Env on the CPU, eagerly (jax.disable_jit;
make_modes_fixture.jax_rollout says why), on data/simple_map, seed 5,
team size 2, StaggerStarts | RandomFlipTeams, with numpy-drawn actions
(make_slice_fixture.draw_actions):

- ``ft/``: Zone + SimFlags.FullTeamPolicy, 2 worlds, 16 steps: the reset
  and every step's pos, vel, yaw, pitch, hp, alive, team points, reward,
  done, every full_team_* observation and state.ft_last_known;
- ``curr/``: Zone + SimFlags.EnableCurriculum, 4 worlds, episode_len 8,
  24 steps, so that resets redraw the world curriculum; after the first
  reset the worlds' episode counters are set to CURR_EPISODES (a world in
  its first episode, two late in the schedule, one past it), so that
  both curricula occur; the same leaves plus world_curriculum;
- ``sc<tier>/``: enable_spawn_curriculum with a one-hot
  curriculum_tier_probs for each of the 5 tiers (simple_map fills all
  five), use_curriculum_spawn_prob SC_PROB, 8 worlds: the reset and 4
  steps, with curr_spawn_active, curr_spawn_tier and curr_spawn_idx.

tests/test_torch_curriculum.py and tests/test_torch_full_team.py replay
them through the port on the CPU.

Regenerate (only after a deliberate change of the JAX reference; ~14
minutes on one CPU, the eager rollouts):

    JAX_PLATFORMS=cpu python tests/fixtures_torch/make_curriculum_fixture.py
"""

from __future__ import annotations

import os
import sys

import numpy as np

import make_slice_fixture as fx

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
PATH = os.path.join(HERE, "zone_curriculum.npz")

SEED = 5
TEAM_SIZE = 2
BASE_FLAGS = ("StaggerStarts", "RandomFlipTeams")
FT_WORLDS, FT_STEPS = 2, 16
CURR_WORLDS, CURR_STEPS, CURR_EPISODE_LEN = 4, 24, 8
CURR_EPISODES = (0, 30, 45, 60)
SC_WORLDS, SC_STEPS, SC_PROB = 8, 4, 0.75
NUM_TIERS = 5

STATE_KEYS = ("pos", "vel", "yaw", "pitch", "hp", "alive", "team_points")
FT_OBS_KEYS = (
    "full_team_global", "full_team_players", "full_team_enemies",
    "full_team_last_known_enemies", "full_team_fwd_lidar",
    "full_team_rear_lidar", "full_team_reward", "full_team_done",
)
# per case: (worlds, steps, the state leaves recorded beside STATE_KEYS,
# the observation keys recorded)
CASES = {
    "ft": (FT_WORLDS, FT_STEPS, ("ft_last_known",), FT_OBS_KEYS),
    "curr": (CURR_WORLDS, CURR_STEPS, ("world_curriculum", "cur_step"), ()),
}
for _t in range(NUM_TIERS):
    CASES[f"sc{_t}"] = (SC_WORLDS, SC_STEPS, (
        "curr_spawn_active", "curr_spawn_tier", "curr_spawn_idx"), ())


def make_cfg(mod, case):
    """The EnvConfig of ``case`` in package ``mod`` (either package: the
    names are shared)."""
    fl = mod.SimFlags.Default
    for f in BASE_FLAGS:
        fl |= getattr(mod.SimFlags, f)
    kw = {}
    if case == "ft":
        fl |= mod.SimFlags.FullTeamPolicy
    elif case == "curr":
        fl |= mod.SimFlags.EnableCurriculum
        kw["episode_len"] = CURR_EPISODE_LEN
    else:
        tier = int(case[2:])
        kw.update(enable_spawn_curriculum=True,
                  use_curriculum_spawn_prob=SC_PROB,
                  curriculum_tier_probs=tuple(
                      float(t == tier) for t in range(NUM_TIERS)))
    return mod.EnvConfig(task=mod.Task.Zone, team_size=TEAM_SIZE,
                         sim_flags=fl, **kw)


def record(hist, case, state, obs, reward=None, done=None):
    _, _, extra, obs_keys = CASES[case]
    for k in STATE_KEYS + extra:
        hist.setdefault(k, []).append(np.asarray(getattr(state, k)))
    for k in obs_keys:
        hist.setdefault("obs_" + k, []).append(np.asarray(obs[k]))
    if reward is not None:
        hist.setdefault("reward", []).append(np.asarray(reward))
        hist.setdefault("done", []).append(np.asarray(done))


def jax_rollout(mp, case):
    import jax
    import jax.numpy as jnp
    from madrona_mp_env_tpu.sim.types import Actions

    worlds, steps, _, _ = CASES[case]
    cfg = make_cfg(mp, case)
    env = mp.Env(cfg, os.path.join(REPO, "data", "simple_map"),
                 num_worlds=worlds, seed=SEED)
    acts = fx.draw_actions(steps, worlds, cfg.num_agents)
    rec = {}
    with jax.disable_jit():
        state, obs = env.reset()
        if case == "curr":
            state = state.replace(episode_counter=jnp.asarray(
                CURR_EPISODES, jnp.uint32))
        record(rec, case, state, obs)
        zf = jnp.zeros((worlds, cfg.num_agents), jnp.float32)
        for s in range(steps):
            a = Actions(**{k: jnp.asarray(v[s]) for k, v in acts.items()},
                        aim_yaw_rate=zf, aim_pitch_rate=zf)
            state, out = env.step(state, a)
            record(rec, case, state, out["obs"], out["reward"], out["done"])
    hist = {k: np.stack(v) for k, v in rec.items()}
    hist.update(acts)
    return hist


def main():
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")
    if jax.default_backend() != "cpu":
        raise RuntimeError("the curriculum fixture needs JAX's CPU backend")
    sys.path.insert(0, REPO)
    import madrona_mp_env_tpu as mp

    out = {}
    for case in CASES:
        hist = jax_rollout(mp, case)
        out.update({f"{case}/{k}": v for k, v in hist.items()})
        print(f"{case}: {CASES[case][1]} steps", flush=True)
    wc = out["curr/world_curriculum"]
    assert (wc == 0).any() and (wc == 1).any(), wc
    for t in range(NUM_TIERS):
        active = out[f"sc{t}/curr_spawn_active"][0]
        assert active.any() and (out[f"sc{t}/curr_spawn_tier"][0] == t).all()
    np.savez_compressed(PATH, **out)
    print(f"wrote {PATH} ({os.path.getsize(PATH)} bytes)")


if __name__ == "__main__":
    main()
