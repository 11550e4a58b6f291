"""The whole slice: the port's Env on the CPU (Zone 2v2 on simple_map, 2
worlds, seed 5, StaggerStarts | RandomFlipTeams) replays the committed JAX
rollout tests/fixtures_torch/zone_simple_map_slice.npz, 16 steps of the
same numpy-drawn actions (make_slice_fixture.py).

Bar: hp, alive, team_points, done, the observation masks and flags exact
at every step; pos within 1e-4 * max(1, |pos|); reward within 1e-4 and
the float observations within 1e-3, each times max(1, |x|).

Why relative: the fixture is the jitted JAX env, and XLA's CPU backend
fuses a + b * c into FMAs, turns x / const into x * (1 / const) and
evaluates sin/cos/log/atan2/asin with its own polynomials, so float
leaves differ from the first step by an ulp or so (a position near 2000
has an ulp of 1.2e-4). Velocities, and the observations built from them,
divide a position difference by dt = 0.05, which scales those ulps by 20.
Measured: pos 3.3e-7, reward 1.2e-6, obs 3.3e-4 relative at most.
"""

import os
import sys

import numpy as np
import pytest
import torch

import madrona_mp_env_tpu_torch as mt

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures_torch")
sys.path.insert(0, FIXTURES)
import make_slice_fixture as fx  # noqa: E402
from torch_threads import one_thread_under_xdist  # noqa: E402,F401

EXACT = ("hp", "alive", "team_points", "done", "obs_opponent_masks",
         "obs_filters_state", "obs_hp", "obs_magazine", "obs_alive",
         "obs_reward_coefs")
REL = {"pos": 1e-4, "reward": 1e-4}
OBS_REL = 1e-3


def port_rollout(scene, team_size=fx.TEAM_SIZE):
    """The fixture's rollout through the port on the CPU, recorded with
    the fixture's own recorder."""
    cfg = mt.EnvConfig(
        task=mt.Task.Zone, team_size=team_size,
        sim_flags=mt.SimFlags.StaggerStarts | mt.SimFlags.RandomFlipTeams,
    )
    env = mt.Env(cfg, scene, num_worlds=fx.NUM_WORLDS, seed=fx.SEED,
                 device="cpu")
    acts = fx.draw_actions(num_agents=2 * team_size)
    rec = {}
    state, obs = env.reset()
    fx.record(rec, state, obs)
    for s in range(fx.NUM_STEPS):
        a = env.zero_actions().replace(
            **{k: torch.as_tensor(v[s]) for k, v in acts.items()})
        state, out = env.step(state, a)
        fx.record(rec, state, out["obs"], out["reward"], out["done"])
    return {k: np.stack([np.asarray(x) for x in v]) for k, v in rec.items()}


def compare(got, want):
    """Assert the bar above; returns {leaf: max relative error}."""
    worst = {}
    for k, w in want.items():
        if k not in got:
            continue
        g = got[k]
        assert g.shape == w.shape, (k, g.shape, w.shape)
        if k in EXACT or not np.issubdtype(w.dtype, np.floating):
            assert np.array_equal(g, w), k
            continue
        if k in ("obs_fwd_lidar", "obs_rear_lidar"):
            assert np.array_equal(g[..., 1:], w[..., 1:]), k  # hit flags
        same = g == w
        with np.errstate(invalid="ignore"):
            rel = np.where(same, 0.0, np.abs(g.astype(np.float64) - w)
                           / np.maximum(1.0, np.abs(w.astype(np.float64))))
        worst[k] = float(rel.max())
        assert worst[k] <= REL.get(k, OBS_REL), (k, worst[k])
    return worst


@pytest.fixture(scope="module")
def fixture_data():
    return dict(np.load(fx.PATH))


def test_actions_match_fixture(fixture_data):
    for k, v in fx.draw_actions().items():
        assert np.array_equal(fixture_data[k], v), k


def test_slice_matches_jax_fixture(fixture_data, simple_map_dir):
    got = port_rollout(simple_map_dir)
    assert set(got) <= set(fixture_data)
    compare(got, fixture_data)


@pytest.mark.slow
def test_slice_matches_live_jax(simple_map_dir):
    """The same rollout regenerated with the live JAX Env (jit compile of
    the env step, minutes on the CPU)."""
    compare(port_rollout(simple_map_dir), fx.jax_rollout())
