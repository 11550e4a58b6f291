"""The LearnShooting world curriculum, its K5 override and the navmesh
spawn curriculum of the port against the JAX package, on the CPU.

(b) SimFlags.EnableCurriculum (Zone 2v2, 4 worlds, episode_len 8, 24
    steps, the episode counters planted after the reset so that both
    curricula occur) and (c) enable_spawn_curriculum with a one-hot tier
    for each of the 5 tiers (8 worlds, use_curriculum_spawn_prob 0.75,
    reset + 4 steps) replay the committed eager JAX rollouts of
    fixtures_torch/zone_curriculum.npz (make_curriculum_fixture.py):
    world_curriculum, the spawn draws, pos, vel and reward bit-exact at
    every step (the port matches eager JAX op for op), yaw at the reset
    (a step's recoil goes through ATen's and XLA's float32 log, sin and
    cos, which differ in the last bit now and then), the rest of the
    leaves to tests/test_torch_slice.py's bars.
(d) K5's LearnShooting override on planted states
    (fixtures_torch/tail_states.py) with LearnShooting and FullMatch
    worlds mixed: ``tail_fused_plain`` against the JAX package's fused
    tail function (Pallas in interpret mode, run eagerly, as
    tests/test_torch_tail.py runs it) within 1e-5 * max(1, |x|) on
    reward, min_dist_to_zone and team_rewards (the TPU kernel adds the
    zone terms in another order), the rest exact; and against the port's
    unfused chain bit for bit. The override on the unfused reward of TDM
    and ZoneCaptureDefend against the JAX package's reward system (jitted,
    vmapped) within 1e-5 * max(1, |x|).
(e) The spawn-curriculum tables against the JAX package's
    build_spawn_curriculum, live on simple_map, array for array, and the
    port's cache read back equal.
(g) SimFlags.StaticFlipTeams, which no system reads: the same seed with
    and without it gives bit-equal rollouts.
"""

import dataclasses
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import madrona_mp_env_tpu as mp
from madrona_mp_env_tpu.sim import rewards as jrewards
from madrona_mp_env_tpu.sim.types import WorldState as JaxWorldState

import madrona_mp_env_tpu_torch as mt
from madrona_mp_env_tpu_torch.assets import formats, navmesh
from madrona_mp_env_tpu_torch.assets import spawn_curriculum as psc
from madrona_mp_env_tpu_torch.assets.map_data import load_map
from madrona_mp_env_tpu_torch.ops import tail_fused as tf
from madrona_mp_env_tpu_torch.sim import rewards
from madrona_mp_env_tpu_torch.sim.types import (init_world_state,
                                                world_state_from_numpy,
                                                world_state_to_numpy)

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "fixtures_torch"))
sys.path.insert(0, HERE)
import make_curriculum_fixture as cx  # noqa: E402
import make_slice_fixture as fx  # noqa: E402
from tail_states import NUM_WORLDS, tail_scenario  # noqa: E402
from test_torch_slice import compare  # noqa: E402
from test_torch_tail import (_assert_leaves, _fused_order,  # noqa: E402
                             _unfused_chain, jax_tail)
from torch_threads import one_thread_under_xdist  # noqa: E402,F401

BIT_EXACT = ("pos", "vel", "reward", "world_curriculum",
             "curr_spawn_active", "curr_spawn_tier", "curr_spawn_idx")
# world curricula of the planted tail states: LearnShooting in worlds 0
# and 2, FullMatch in 1 and 3
PLANTED_CURRICULA = np.array([0, 1, 0, 1], np.int32)


@pytest.fixture(scope="module")
def data():
    return dict(np.load(cx.PATH))


def group(data, case):
    n = len(case) + 1
    return {k[n:]: v for k, v in data.items() if k.startswith(case + "/")}


def port_rollout(case, scene, cfg=None, seed=cx.SEED):
    """Case ``case`` of the fixture through the port's Env on the CPU,
    recorded with the fixture's own recorder (``cfg``: another
    configuration of the same shapes)."""
    worlds, steps, _, _ = cx.CASES[case]
    cfg = cfg or cx.make_cfg(mt, case)
    env = mt.Env(cfg, scene, num_worlds=worlds, seed=seed, device="cpu")
    acts = fx.draw_actions(steps, worlds, cfg.num_agents)
    rec = {}
    state, obs = env.reset()
    if case == "curr":
        state = state.replace(episode_counter=torch.tensor(
            cx.CURR_EPISODES, dtype=torch.int64))
    cx.record(rec, case, state, obs)
    for s in range(steps):
        a = env.zero_actions().replace(
            **{k: torch.as_tensor(v[s]) for k, v in acts.items()})
        state, out = env.step(state, a)
        cx.record(rec, case, state, out["obs"], out["reward"], out["done"])
    return {k: np.stack([np.asarray(x) for x in v]) for k, v in rec.items()}


def compare_case(data, case, scene):
    want = group(data, case)
    got = port_rollout(case, scene)
    worlds, steps, _, _ = cx.CASES[case]
    for k, v in fx.draw_actions(steps, worlds, 2 * cx.TEAM_SIZE).items():
        assert np.array_equal(want[k], v), k
    assert set(got) <= set(want)
    for k in BIT_EXACT:
        if k in got:
            assert got[k].shape == want[k].shape, k
            assert np.array_equal(got[k], want[k]), k
    # yaw at the reset; a step's recoil draws through ATen's and XLA's
    # float32 log, sin and cos, an ulp apart now and then
    assert np.array_equal(got["yaw"][0], want["yaw"][0])
    compare(got, {k: v for k, v in want.items() if k in got})
    return got


def test_world_curriculum_matches_jax(data, simple_map_dir):
    got = compare_case(data, "curr", simple_map_dir)
    wc = got["world_curriculum"]
    # both curricula, a schedule redrawn at resets only: a world keeps its
    # curriculum between its resets, and the world past 50 episodes plays
    # FullMatch from its first reset on
    assert (wc == 0).any() and (wc == 1).any()
    step = got["cur_step"]
    reset = np.concatenate([np.ones((1, wc.shape[1]), bool),
                            step[1:] == 0], 0)
    assert (reset[1:] | (wc[1:] == wc[:-1])).all()
    first = np.argmax(reset[1:, 3]) + 1
    assert (wc[first:, 3] == 1).all()


@pytest.mark.parametrize("tier", range(cx.NUM_TIERS))
def test_spawn_curriculum_matches_jax(tier, data, simple_map_dir):
    got = compare_case(data, f"sc{tier}", simple_map_dir)
    assert (got["curr_spawn_tier"] == tier).all()
    active = got["curr_spawn_active"][0]
    assert active.any() and not active.all()


def _tail_states(ts, m, cfg):
    leaves = world_state_to_numpy(init_world_state(cfg, m.num_goal_regions,
                                                   NUM_WORLDS))
    fr = tail_scenario(leaves, ts, m.zone_frames.numpy(), m.num_zones,
                       m.world_min.numpy(), m.world_max.numpy(),
                       cfg.episode_len, seed=5)
    leaves["world_curriculum"] = PLANTED_CURRICULA.copy()
    # a landed shot, a shot fired and a full-magazine reload in the
    # LearnShooting worlds, so every term of the shooting reward occurs
    leaves["landed_shot_on"][0, 0] = 1
    leaves["fired_shot_t"][0, 1] = 0.25
    leaves["landed_shot_on"][0, 1] = -1
    leaves["reloaded_full_mag"][2, 0] = True
    return leaves, fr


def _jax_map(m):
    """The zone and world boxes of the port's map, as JAX arrays."""
    return SimpleNamespace(num_zones=m.num_zones, **{
        k: jnp.asarray(getattr(m, k).numpy()) for k in (
            "zone_min", "zone_max", "zone_rot", "world_min", "world_max")})


def _ls_cfg(mod, ts, task="Zone"):
    return mod.EnvConfig(
        task=getattr(mod.Task, task), team_size=ts,
        sim_flags=(mod.SimFlags.StaggerStarts | mod.SimFlags.RandomFlipTeams
                   | mod.SimFlags.EnableCurriculum))


@pytest.mark.parametrize("ts", [2, 6])
def test_tail_learn_shooting_matches_jax_kernel(ts, simple_map_dir):
    """The JAX kernel function's outputs: fixtures_torch/tail_jax.npz
    (make_tail_fixture.py, Pallas in interpret mode on these inputs)."""
    cfg = _ls_cfg(mt, ts)
    m = load_map(simple_map_dir, cfg, device="cpu")
    leaves, fr = _tail_states(ts, m, cfg)
    want, jcap = jax_tail(f"ls/{ts}", leaves, fr)
    st, cap = tf.tail_fused_plain(cfg, m, world_state_from_numpy(leaves),
                                  torch.as_tensor(fr))
    got = world_state_to_numpy(st)
    _assert_leaves(got, want, ("reward", "min_dist_to_zone",
                               "team_rewards"), 1e-5)
    assert np.array_equal(cap.numpy(), np.asarray(jcap))
    # the override took: the LearnShooting worlds' rewards are the
    # shooting terms blended, the FullMatch worlds' are not
    plain = world_state_to_numpy(tf.tail_fused_plain(
        dataclasses.replace(cfg, sim_flags=cfg.sim_flags
                            & ~mt.SimFlags.EnableCurriculum), m,
        world_state_from_numpy(leaves), torch.as_tensor(fr))[0])
    ls = PLANTED_CURRICULA == 0
    assert not np.array_equal(got["reward"][ls], plain["reward"][ls])
    assert np.array_equal(got["reward"][~ls], plain["reward"][~ls])
    assert np.array_equal(got["min_dist_to_zone"][~ls],
                          plain["min_dist_to_zone"][~ls])


@pytest.mark.parametrize("ts", [2, 6])
def test_tail_learn_shooting_matches_unfused_chain(ts, simple_map_dir):
    """The fused order through the plain version equals the unfused chain
    (its LearnShooting override in rewards.reward_system) bit for bit."""
    cfg = _ls_cfg(mt, ts)
    m = load_map(simple_map_dir, cfg, device="cpu")
    leaves, fr = _tail_states(ts, m, cfg)
    victims = torch.as_tensor(np.random.default_rng(6).integers(
        -1, cfg.num_agents, (NUM_WORLDS, cfg.num_agents)))
    args = (torch.as_tensor(fr), victims)
    fused, cap_f = _fused_order(cfg, m, world_state_from_numpy(leaves),
                                *args)
    chain, cap_c = _unfused_chain(cfg, m, world_state_from_numpy(leaves),
                                  *args)
    _assert_leaves(world_state_to_numpy(fused), world_state_to_numpy(chain))
    assert torch.equal(cap_f, cap_c)


@pytest.mark.parametrize("task", ["TDM", "ZoneCaptureDefend"])
def test_learn_shooting_reward_other_tasks(task, simple_map_dir):
    """The override on the unfused reward of the other PvP tasks against
    the JAX package's reward system."""
    cfg = _ls_cfg(mt, 2, task)
    m = load_map(simple_map_dir, cfg, device="cpu")
    leaves, _ = _tail_states(2, m, cfg)
    got = world_state_to_numpy(rewards.reward_system(
        cfg, m, world_state_from_numpy(leaves)))
    jcfg, jm = _ls_cfg(mp, 2, task), _jax_map(m)
    js = JaxWorldState(**{k: jnp.asarray(v) for k, v in leaves.items()})
    js = jax.jit(jax.vmap(lambda s: jrewards.reward_system(jcfg, jm, s)))(
        js)
    for k in ("reward", "team_rewards", "min_dist_to_zone"):
        w = np.asarray(getattr(js, k))
        err = np.abs(got[k].astype(np.float64) - w)
        assert np.all(err <= 1e-5 * np.maximum(1.0, np.abs(w))), k
    ls = PLANTED_CURRICULA == 0
    assert np.array_equal(got["min_dist_to_zone"][ls],
                          leaves["min_dist_to_zone"][ls])


def test_spawn_curriculum_tables_match_jax(simple_map_dir, tmp_path):
    from madrona_mp_env_tpu.assets import formats as jformats
    from madrona_mp_env_tpu.assets.navmesh import build_navmesh_tables
    from madrona_mp_env_tpu.assets.spawn_curriculum import (
        build_spawn_curriculum)

    path = os.path.join(simple_map_dir, "navmesh.bin")
    want = build_spawn_curriculum(build_navmesh_tables(
        jformats.load_navmesh(path)))
    nav = navmesh.build_navmesh_tables(formats.load_navmesh(path))
    got = psc.build_spawn_curriculum(nav, cache_dir=str(tmp_path))
    cached = psc.build_spawn_curriculum(nav, cache_dir=str(tmp_path))
    assert os.path.exists(psc.cache_path(nav, str(tmp_path)))
    for k in ("a_tris", "b_tris", "a_yaw", "b_yaw", "num_spawns"):
        w = getattr(want, k)
        for t in (got, cached):
            assert getattr(t, k).dtype == w.dtype, k
            assert np.array_equal(getattr(t, k), w), k
    assert (want.num_spawns > 0).all()


def test_static_flip_teams_is_inert(simple_map_dir):
    """StaticFlipTeams is read by no system (the JAX package defines it in
    config.py and reads it nowhere): a rollout with it equals one
    without it bit for bit."""
    base = cx.make_cfg(mt, "sc2")
    runs = [port_rollout("sc2", simple_map_dir, cfg=dataclasses.replace(
        base, sim_flags=base.sim_flags | extra))
        for extra in (mt.SimFlags.Default, mt.SimFlags.StaticFlipTeams)]
    assert runs[0].keys() == runs[1].keys()
    for k, v in runs[0].items():
        assert np.array_equal(v, runs[1][k], equal_nan=v.dtype.kind == "f"), k
