"""Each sim system of the port against the JAX package's system on the same
state (Zone 2v2, 2 worlds, simple_map).

The JAX side is the committed fixture tests/fixtures_torch/
zone_simple_map_systems.npz (make_slice_fixture.py): a mid-episode state
run eagerly through every system of one step, world by world. Each case
carries the JAX state before a system into the port with
world_state_from_numpy, runs the port's batched system on the CPU and
compares every state leaf with the JAX state after it.

Tolerances: integer and boolean leaves exact; float leaves within
1e-4 * max(1, |x|). The port repeats the reference's arithmetic op for
op, but XLA and ATen evaluate sin/cos/log/atan2 with different
polynomials (an ulp apart on some inputs), and a position near 2000 has
an ulp of 1.2e-4, so an absolute 1e-4 would demand bit equality there.
"""

import os
import sys

import numpy as np
import pytest
import torch

import madrona_mp_env_tpu_torch as mt
from madrona_mp_env_tpu_torch.sim import (
    breadcrumbs, combat, explore, movement, rewards, zones,
)
from madrona_mp_env_tpu_torch.sim import reset as reset_mod
from madrona_mp_env_tpu_torch.sim.observations import observe_tail
from madrona_mp_env_tpu_torch.sim.spawn import spawn_agents
from madrona_mp_env_tpu_torch.sim.types import (
    WorldState, world_state_from_numpy, world_state_to_numpy,
)
from madrona_mp_env_tpu_torch.utils import rng

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "fixtures_torch"))
from torch_threads import one_thread_under_xdist  # noqa: E402,F401
FIXTURE = os.path.join(HERE, "fixtures_torch", "zone_simple_map_systems.npz")
SLICE = os.path.join(HERE, "fixtures_torch", "zone_simple_map_slice.npz")
CHAIN_STEP = 6  # make_slice_fixture.CHAIN_STEP
RTOL = 1e-4


@pytest.fixture(scope="module")
def chain():
    data = dict(np.load(FIXTURE))
    names = [str(n) for n in data["names"]]
    states = [
        {k.split("/", 1)[1]: v for k, v in data.items()
         if k.startswith(f"{i}/")}
        for i in range(len(names) + 1)
    ]
    extras = {k.split("/", 1)[1]: v for k, v in data.items()
              if k.startswith("extra/")}
    return names, states, extras


@pytest.fixture(scope="module")
def env(simple_map_dir):
    cfg = mt.EnvConfig(
        task=mt.Task.Zone, team_size=2,
        sim_flags=mt.SimFlags.StaggerStarts | mt.SimFlags.RandomFlipTeams,
    )
    return mt.Env(cfg, simple_map_dir, num_worlds=2, seed=5, device="cpu")


def _actions(env):
    acts = dict(np.load(SLICE))
    a = env.zero_actions()
    return a.replace(**{
        k: torch.as_tensor(acts[k][CHAIN_STEP])
        for k in ("move_amount", "move_angle", "fire", "stand", "aim_yaw",
                  "aim_pitch")
    })


def _key(s, salt):
    return rng.system_key(rng.step_key(s.episode_key, s.cur_step), salt)


def _run(name, env, s, extras):
    cfg, m = env.cfg, env.map_data
    if name == "movement":
        return movement.movement_system(cfg, s, _actions(env))
    if name == "aim":
        return movement.aim_systems(cfg, s, _actions(env))
    if name == "apply_velocity":
        return movement.apply_velocity_system(cfg, m, s)
    if name == "fall":
        return movement.fall_system(cfg, m, s)
    if name == "fire":
        s, ev = combat.fire_system(cfg, m, s, _actions(env),
                                   _key(s, rng.Salt.FIRE))
        assert np.array_equal(ev["shot_victim"].numpy(),
                              extras["shot_victim"])
        return s
    if name == "damage":
        return combat.apply_damage_system(cfg, s)
    if name == "respawn":
        return spawn_agents(cfg, m, s, _key(s, rng.Salt.SPAWN),
                            is_respawn=True)
    if name == "autoheal":
        return combat.autoheal_system(cfg, s)
    if name == "zone":
        return zones.zone_system(cfg, m, s)
    if name == "breadcrumbs":
        return breadcrumbs.breadcrumb_system(cfg, s)
    if name == "match_info":
        return zones.zone_match_info_system(
            cfg, m, s, torch.zeros(2, dtype=torch.bool))[0]
    if name == "filters":
        return explore.filters_system(
            cfg, s, torch.as_tensor(extras["shot_victim"]))
    if name == "goal_regions":
        return explore.goal_regions_system(cfg, m, s)
    if name == "explore":
        return explore.explore_visited_system(cfg, s)
    if name == "rewards":
        return rewards.reward_system(cfg, m, s)
    if name == "reset":
        return reset_mod.reset_system(
            cfg, m, s, env.init_key, env.default_sim_ctrl(),
            torch.tensor([1, 0], dtype=torch.int32))
    if name == "observe":
        s, obs = observe_tail(cfg, m, s)
        for k in ("self", "opponents", "fwd_lidar", "rear_lidar",
                  "opponent_masks"):
            _assert_close(f"obs {k}", obs[k].numpy(), extras["obs_" + k])
        return s
    raise KeyError(name)


def _assert_close(what, got, want):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if not np.issubdtype(want.dtype, np.floating):
        assert np.array_equal(got, want), what
        return
    same = (got == want) | (np.isnan(got) & np.isnan(want))
    with np.errstate(invalid="ignore"):
        err = np.where(same, 0.0, np.abs(got.astype(np.float64) - want))
    tol = RTOL * np.maximum(1.0, np.abs(want.astype(np.float64)))
    assert np.all(err <= tol), (what, float(np.nanmax(err)))


SYSTEMS = (
    "movement", "aim", "apply_velocity", "fall", "fire", "damage",
    "respawn", "autoheal", "zone", "breadcrumbs", "match_info", "filters",
    "goal_regions", "explore", "rewards", "reset", "observe",
)


@pytest.mark.parametrize("name", SYSTEMS)
def test_system_matches_jax(name, chain, env):
    names, states, extras = chain
    i = names.index(name)
    s = world_state_from_numpy(states[i])
    out = world_state_to_numpy(_run(name, env, s, extras))
    for leaf, want in states[i + 1].items():
        _assert_close(f"{name}: {leaf}", out[leaf], want)


def test_state_round_trip(chain):
    """world_state_from_numpy / world_state_to_numpy carry every leaf of
    the JAX state across unchanged, dtypes included."""
    _, states, _ = chain
    back = world_state_to_numpy(world_state_from_numpy(states[0]))
    assert set(back) == set(states[0]) == set(WorldState.__dataclass_fields__)
    for k, v in states[0].items():
        assert back[k].dtype == v.dtype and np.array_equal(back[k], v), k
