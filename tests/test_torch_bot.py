"""The port's scripted A* bot against the JAX package's.

- The navmesh tables: triangle adjacency and the all-pairs next-hop table
  equal element for element to the JAX package's numpy functions on both
  maps (their tables stored in asset_tools_jax.npz; the port's town_map
  table built once per module), and built by a map only when a bot first
  plans.
- The planner: the port's ``_nearest_nav_tri`` and ``plan_bot_actions`` on
  the inputs of tests/fixtures_torch/zone_simple_map_bots.npz
  (make_bot_fixture.py: numpy-drawn inputs on both maps, and the states
  before each step of a 16-step Zone 2v2 rollout with team 1 as bots),
  against what the jitted JAX planner gave there. Bar: triangle indices
  and integer actions exact, rates bit-equal. A facing (> 0.6) or turn
  (cross_z < 0) decision may flip only at a tie: the fixture's float64
  margins of every agent are at least 7.18e-4, far above the ulps by
  which XLA's and ATen's sin, cos and FMA-fused products differ, so no
  flip is allowed.
- ``apply_bot_actions`` against the JAX one on the same states.
- The rollout: the port's Env on the CPU replays the fixture's 16 steps
  (team 1 bots, team 0 the numpy-drawn actions) to the bars of
  tests/test_torch_slice.py.
"""

import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import madrona_mp_env_tpu_torch as mt
from madrona_mp_env_tpu_torch.assets import navmesh
from madrona_mp_env_tpu_torch.assets.map_data import load_map
from madrona_mp_env_tpu_torch.sim import bot
from madrona_mp_env_tpu_torch.sim.types import Actions

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures_torch")
sys.path.insert(0, FIXTURES)
import make_asset_tools_fixture as asset_fx  # noqa: E402
import make_bot_fixture as fx  # noqa: E402
import make_slice_fixture as slice_fx  # noqa: E402
from test_torch_slice import compare  # noqa: E402
from torch_threads import one_thread_under_xdist  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MARGIN = 1e-5  # a tie: a decision this close to its threshold may flip
INT_ACTIONS = ("move_amount", "move_angle", "fire", "stand", "aim_yaw",
               "aim_pitch")
RATES = ("aim_yaw_rate", "aim_pitch_rate")


@pytest.fixture(scope="module")
def want():
    return dict(np.load(fx.PATH))


@pytest.fixture(scope="module")
def maps():
    cfg = mt.EnvConfig(task=mt.Task.Zone, team_size=fx.SYN_TEAM_SIZE)
    return {s: load_map(os.path.join(REPO, "data", s), cfg, device="cpu")
            for s in fx.MAPS}


@pytest.fixture(scope="module")
def graphs(maps):
    """{map: (port adjacency, port next hop, JAX's, JAX's)}; the port's
    built once per module (town_map's Floyd-Warshall takes seconds), the
    JAX package's numpy tables from asset_tools_jax.npz
    (make_asset_tools_fixture.py), whose navmesh inputs equal the map's."""
    out = {}
    with np.load(asset_fx.PATH) as z:
        for s, m in maps.items():
            tri = m.nav_tri_indices.numpy().astype(np.int32)
            want_tri, cent = asset_fx.nav_inputs(os.path.join(REPO, "data",
                                                             s))
            assert np.array_equal(tri, want_tri) and np.array_equal(
                tri, z[f"nav/{s}/tri"])
            assert np.array_equal(m.nav_centroids.numpy().astype(np.float64),
                                  cent)
            out[s] = (navmesh.tri_adjacency(tri), m.nav_next_hop().numpy(),
                      z[f"nav/{s}/adj"], z[f"nav/{s}/next_hop"])
    return out


@pytest.mark.parametrize("scene", fx.MAPS)
def test_next_hop_equals_jax(graphs, scene):
    adj, hop, jadj, jhop = graphs[scene]
    assert np.array_equal(adj, jadj)
    assert hop.dtype == np.int64 and np.array_equal(hop, jhop)
    T = hop.shape[0]
    # simple_map's nav mesh has islands: 74% of its pairs are unreachable
    unreachable = float((hop == -1).mean())
    assert (unreachable > 0.5) if scene == "simple_map" else unreachable == 0
    assert np.array_equal(np.diag(hop), np.arange(T))


def test_load_map_builds_no_next_hop(simple_map_dir):
    """load_map leaves the table unbuilt; a step without bots does not
    build it, the first step with one does."""
    cfg = mt.EnvConfig(task=mt.Task.Zone, team_size=2)
    env = mt.Env(cfg, simple_map_dir, num_worlds=1, device="cpu")
    assert env.map_data._next_hop is None
    state, _ = env.reset()
    state, _ = env.step(state, env.zero_actions())
    assert env.map_data._next_hop is None
    state.policy_idx[0, -1] = -1
    env.step(state, env.zero_actions())
    assert env.map_data._next_hop is not None


def _syn(want, scene):
    p = f"syn/{scene}/"
    leaves = {k[len(p):]: v for k, v in want.items()
              if k.startswith(p) and "/" not in k[len(p):]}
    return leaves, {k[len(p + "out/"):]: v for k, v in want.items()
                    if k.startswith(p + "out/")}


def _namespace(leaves):
    return SimpleNamespace(**{
        k: torch.as_tensor(v.astype(np.int64) if v.dtype == np.uint32
                           else v)
        for k, v in leaves.items() if not k.startswith("margin")})


def _check_plan(got: Actions, want, leaves, where):
    tie = ((leaves["margin_facing"] <= MARGIN)
           | (leaves["margin_cross"] <= MARGIN))
    assert not tie.any(), f"{where}: {int(tie.sum())} agents at a tie"
    for k in INT_ACTIONS:
        assert np.array_equal(getattr(got, k).numpy(), want[k]), (where, k)
    for k in RATES:
        g = getattr(got, k).numpy()
        assert g.dtype == want[k].dtype
        assert np.array_equal(g.view(np.int32), want[k].view(np.int32)), \
            (where, k)


@pytest.mark.parametrize("scene", fx.MAPS)
def test_nearest_nav_tri_matches_jax(want, maps, scene):
    m = maps[scene]
    leaves, _ = _syn(want, scene)
    got = bot._nearest_nav_tri(m, torch.as_tensor(leaves["pos"]))
    assert np.array_equal(got.numpy(), want[f"syn/{scene}/tri_of_pos"])
    zc = 0.5 * (m.zone_min + m.zone_max)
    got = bot._nearest_nav_tri(m, zc)
    assert np.array_equal(got.numpy(), want[f"syn/{scene}/tri_of_zone"])


@pytest.mark.parametrize("scene", fx.MAPS)
def test_planner_matches_jax_on_drawn_inputs(want, maps, scene):
    leaves, out = _syn(want, scene)
    s = _namespace(leaves)
    got = bot.plan_bot_actions(None, maps[scene], s, s.key)
    _check_plan(got, out, leaves, scene)
    # the draw reaches every branch: waypoint steering, each avoidance
    # angle, firing, and both turn directions
    assert set(np.unique(out["move_amount"])) == {0, 1, 2}
    assert set(np.unique(out["move_angle"])) == {0, 2, 3, 4, 5, 6}
    assert set(np.unique(out["aim_yaw_rate"])) == {-10.0, -5.0, 0.0, 5.0,
                                                   10.0}
    assert out["fire"].any() and not out["fire"].all()


def test_planner_matches_jax_on_rollout_states(want, maps):
    p = "plan/"
    leaves = {k[len(p):]: v for k, v in want.items()
              if k.startswith(p) and not k.startswith(p + "out/")}
    out = {k[len(p + "out/"):]: v for k, v in want.items()
           if k.startswith(p + "out/")}
    m = maps["simple_map"]
    for t in range(fx.NUM_STEPS):
        lt = {k: v[t] for k, v in leaves.items()}
        s = _namespace(lt)
        got = bot.bot_overlay(None, m, s, Actions.zeros(*s.yaw.shape))
        mine = bot.plan_bot_actions(
            None, m, s, bot.rng.system_key(
                bot.rng.step_key(s.episode_key, s.cur_step),
                bot.rng.Salt.BOT))
        _check_plan(mine, {k: v[t] for k, v in out.items()}, lt, f"step {t}")
        is_bot = lt["policy_idx"] == -1
        for k in INT_ACTIONS + RATES:
            g = getattr(got, k).numpy()
            assert np.array_equal(g[is_bot], out[k][t][is_bot]), (t, k)


def test_apply_bot_actions_matches_jax(want):
    """The overlay on the fixture's first state, against the JAX one run
    eagerly: bots take the plan, policy agents keep their actions."""
    import jax.numpy as jnp

    from madrona_mp_env_tpu.sim import bot as jbot
    from madrona_mp_env_tpu.sim.types import Actions as JActions

    pidx = want["plan/policy_idx"][0]
    W, A = pidx.shape
    g = np.random.default_rng(3)
    theirs = {k: g.integers(0, 5, (W, A)).astype(np.int32)
              for k in INT_ACTIONS}
    theirs.update({k: g.normal(size=(W, A)).astype(np.float32)
                   for k in RATES})
    plan = {k: want[f"plan/out/{k}"][0] for k in INT_ACTIONS + RATES}
    got = bot.apply_bot_actions(
        None, SimpleNamespace(policy_idx=torch.as_tensor(pidx)),
        Actions(**{k: torch.as_tensor(v) for k, v in theirs.items()}),
        Actions(**{k: torch.as_tensor(v) for k, v in plan.items()}))
    ref = jbot.apply_bot_actions(
        None, SimpleNamespace(policy_idx=jnp.asarray(pidx)),
        JActions(**{k: jnp.asarray(v) for k, v in theirs.items()}),
        JActions(**{k: jnp.asarray(v) for k, v in plan.items()}))
    assert (pidx == -1).any() and (pidx != -1).any()
    for k in INT_ACTIONS + RATES:
        g_ = getattr(got, k).numpy()
        assert g_.dtype == theirs[k].dtype
        assert np.array_equal(g_, np.asarray(getattr(ref, k))), k


def test_rollout_with_bots_matches_jax_fixture(want, simple_map_dir):
    cfg = mt.EnvConfig(
        task=mt.Task.Zone, team_size=fx.TEAM_SIZE,
        sim_flags=mt.SimFlags.StaggerStarts | mt.SimFlags.RandomFlipTeams,
    )
    env = mt.Env(cfg, simple_map_dir, num_worlds=fx.NUM_WORLDS,
                 seed=fx.SEED, device="cpu")
    acts = slice_fx.draw_actions()
    for k, v in acts.items():
        assert np.array_equal(want[f"roll/{k}"], v), k
    bots = torch.as_tensor(fx.bot_mask(cfg.num_agents, fx.TEAM_SIZE))
    rec = {}
    state, obs = env.reset()
    state = state.replace(policy_idx=torch.where(
        bots[None, :], -1, state.policy_idx))
    slice_fx.record(rec, state, obs)
    for s in range(fx.NUM_STEPS):
        a = env.zero_actions().replace(
            **{k: torch.as_tensor(v[s]) for k, v in acts.items()})
        state, out = env.step(state, a)
        slice_fx.record(rec, state, out["obs"], out["reward"], out["done"])
    got = {k: np.stack([np.asarray(x) for x in v]) for k, v in rec.items()}
    roll = {k[len("roll/"):]: v for k, v in want.items()
            if k.startswith("roll/")}
    assert set(got) <= set(roll)
    compare(got, roll)
    # the bots moved: team 1's positions changed over the run
    moved = np.abs(got["pos"][-1] - got["pos"][0])[:, bots.numpy()]
    assert moved.max() > 1.0
