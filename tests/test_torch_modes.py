"""Every game mode and flag of the port against the JAX package.

The committed fixture tests/fixtures_torch/zone_modes.npz
(make_modes_fixture.py) holds the JAX Env's rollouts of eight
configurations on data/simple_map (2 worlds, team size 2, 12 steps of
numpy-drawn actions): TDM, ZoneCaptureDefend + HardcodedSpawns, Turret,
Explore + NavmeshSpawn (one agent: the opponent and LOS tables point past
it), Zone + Flank, Zone + SubZones, TDM + highlevel_move and Zone +
RandomizeHPMagazine; planted states run through one system where 12 steps
reach no end (the ZoneCaptureDefend, TDM and Turret match ends, the
turret's and hl_battle's targets in sight and behind a wall, the sub-zone
state machine); and the SpawnInMiddle reset on a spawn table cut to the
usage tables' 128 boxes.

The rollouts are the JAX Env run eagerly (make_modes_fixture.jax_rollout
says why); the bars are tests/test_torch_slice.py's: hp, alive, team
points, done and the observation masks and flags exact; pos within 1e-4
* max(1, |pos|); reward within 1e-4 and the float observations within
1e-3, each times max(1, |x|); NaN where JAX has NaN. The planted cases:
discrete outputs exact, floats within 1e-4 * max(1, |x|).
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

import madrona_mp_env_tpu_torch as mt
from madrona_mp_env_tpu_torch.sim import (hl_battle, rewards, subzones,
                                          turret, zones)
from madrona_mp_env_tpu_torch.assets.map_data import load_map
from madrona_mp_env_tpu_torch.sim import reset as reset_mod
from madrona_mp_env_tpu_torch.sim.types import (init_world_state,
                                                world_state_from_numpy)
from madrona_mp_env_tpu_torch.utils import rng

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "fixtures_torch"))
sys.path.insert(0, HERE)
import make_modes_fixture as mx  # noqa: E402
import make_slice_fixture as fx  # noqa: E402
from test_torch_slice import compare  # noqa: E402
from torch_threads import one_thread_under_xdist  # noqa: E402,F401

REL = 1e-4
MODES = ("TDM", "ZoneCaptureDefend", "Turret", "Explore")


@pytest.fixture(scope="module")
def data():
    return dict(np.load(mx.PATH))


def _group(data, prefix):
    n = len(prefix) + 1
    return {k[n:]: v for k, v in data.items() if k.startswith(prefix + "/")}


def _env(name, scene):
    return mt.Env(mx.make_cfg(mt, name), scene, num_worlds=mx.NUM_WORLDS,
                  seed=mx.SEED, device="cpu")


def _close(name, got, want):
    got = np.asarray(got)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    if not np.issubdtype(want.dtype, np.floating):
        assert np.array_equal(got, want), (name, got, want)
        return
    same = (got == want) | (np.isnan(got) & np.isnan(want))
    with np.errstate(invalid="ignore"):
        rel = np.abs(got.astype(np.float64) - want) / np.maximum(
            1.0, np.abs(want.astype(np.float64)))
    assert np.where(same, 0.0, rel).max() <= REL, (name, got, want)


@pytest.mark.parametrize("name", list(mx.CONFIGS))
def test_mode_rollout_matches_jax(name, data, simple_map_dir):
    want = _group(data, name)
    env = _env(name, simple_map_dir)
    A = env.cfg.num_agents
    acts = fx.draw_actions(mx.NUM_STEPS, mx.NUM_WORLDS, A)
    for k, v in acts.items():
        assert np.array_equal(want[k], v), k
    state, obs = env.reset()
    pid = mx.policy_ids(name, A)
    if pid is not None:
        state = state.replace(policy_idx=torch.as_tensor(pid))
    rec = {}
    fx.record(rec, state, obs)
    for s in range(mx.NUM_STEPS):
        a = env.zero_actions().replace(
            **{k: torch.as_tensor(v[s]) for k, v in acts.items()})
        state, out = env.step(state, a)
        fx.record(rec, state, out["obs"], out["reward"], out["done"])
    got = {k: np.stack([np.asarray(x) for x in v]) for k, v in rec.items()}
    assert set(got) <= set(want)
    want = {k: v for k, v in want.items() if k in got}
    for k, w in want.items():
        # NaN exactly where JAX has it: SubZones' first reward after a
        # reset (an infinite approach distance times the team blend's 0)
        if np.issubdtype(w.dtype, np.floating) and np.isnan(w).any():
            assert np.array_equal(np.isnan(got[k]), np.isnan(w)), k
            got[k], want[k] = np.nan_to_num(got[k]), np.nan_to_num(w)
    compare(got, want)


def _planted(data, case):
    name, _ = mx.PLANTS[case]
    leaves = _group(data, f"base/{name}")
    leaves.update(_group(data, f"plant/{case}"))
    return world_state_from_numpy(leaves)


def _run_plant(env, system, state):
    cfg, m = env.cfg, env.map_data
    if system == "match_reward":
        fr = torch.zeros(state.hp.shape[0], dtype=torch.bool)
        if cfg.task == mt.Task.Turret:
            state, _ = turret.turret_match_info_system(cfg, state, fr)
        elif cfg.task == mt.Task.TDM:
            state, _ = zones.tdm_match_info_system(cfg, state, fr)
        else:
            state, _ = zones.zone_match_info_system(cfg, m, state, fr)
        s = rewards.reward_system(cfg, m, state)
        return {k: getattr(s, k) for k in mx.MATCH_KEYS}
    if system == "turret_ai":
        a = turret.turret_ai_system(cfg, m, state, env.zero_actions())
        return {k: getattr(a, k) for k in mx.TURRET_KEYS}
    if system == "hl_battle":
        s, ev = hl_battle.hl_battle_system(cfg, m, state)
        out = {k: getattr(s, k) for k in mx.HL_KEYS}
        out["shot_victim"] = ev["shot_victim"]
        return out
    s = subzones.subzone_system(cfg, m, state)
    return {k: getattr(s, k) for k in mx.SUBZONE_KEYS}


@pytest.mark.parametrize("case", list(mx.PLANTS))
def test_planted_case_matches_jax(case, data, simple_map_dir):
    name, system = mx.PLANTS[case]
    env = _env(name, simple_map_dir)
    state = _planted(data, case)
    want = _group(data, f"out/{case}")
    got = _run_plant(env, system, state)
    assert set(got) == set(want)
    for k, v in got.items():
        _close(f"{case}/{k}", v, want[k])
    if case == "zcd_points":  # an attacker win and a defender win
        assert want["is_finished"].all() and set(want["win_result"]) == {
            0, 1}
    if f"meta/{case}/visible" in data:  # one target in sight, one walled off
        vis = data[f"meta/{case}/visible"]
        assert vis[0, 2, 0] and not vis[0, 3, 1]


def test_spawn_in_middle_reset_matches_jax(data, simple_map_dir):
    """SpawnInMiddle | RandomizeHPMagazine: the reset of 8 worlds on the
    spawn table cut to 128 boxes a side, both draws of the middle coin."""
    cfg = mx.make_cfg(mt, "hp_mag", mx.MIDDLE_FLAGS)
    m = load_map(simple_map_dir, cfg, device="cpu")
    assert m.side_spawns.shape[1] > mx.MIDDLE_BOXES  # Env refuses the map
    m = dataclasses.replace(
        m, **mx.middle_spawn_map(m, m.num_default_side_spawns))
    W = mx.MIDDLE_WORLDS
    s = reset_mod.reset_system(
        cfg, m, init_world_state(cfg, m.num_goal_regions, W, device="cpu"),
        rng.prng_key(mx.SEED), (0, 1, 1), torch.ones(W, dtype=torch.int32))
    want = _group(data, "middle")
    for k in mx.MIDDLE_KEYS:
        got = getattr(s, k)
        if k.startswith("spawn_"):
            got = got.numpy().astype(np.uint32)
        _close(k, got, want[k])


def test_spawn_in_middle_overflows_like_jax(simple_map_dir):
    """The bundled maps' mid-map boxes (200 a side on simple_map) overflow
    the 128-box spawn-usage tables; the JAX package's spawn fails there, so
    the port refuses the configuration at construction."""
    cfg = mt.EnvConfig(team_size=2, sim_flags=mt.SimFlags.SpawnInMiddle)
    with pytest.raises(ValueError, match="spawn boxes"):
        mt.Env(cfg, simple_map_dir, num_worlds=1, device="cpu")


@pytest.mark.parametrize("name", list(mx.CONFIGS))
def test_mode_env_defaults_to_cuda(name, monkeypatch, simple_map_dir):
    """device=None means CUDA for every configuration: without a card it
    raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        mt.Env(mx.make_cfg(mt, name), simple_map_dir, num_worlds=1)


def test_flank_los_run_keeps_the_register_blocked_fans(simple_map_dir):
    """Flank doubles the LOS run to 8 rays per teammate-opponent slot pair
    (8 ts: 16 at 2v2, 24 at 3v3, 48 at 6v6), always a multiple of 8, so
    its fans take K2 (K6 on maps with PVS tables) at every team size,
    where the Default reward's 4 ts run takes K7 at odd ones."""
    from madrona_mp_env_tpu_torch.ops.raycast import fan_route
    from madrona_mp_env_tpu_torch.sim.observations import sensor_fan

    for ts, mode, route in ((2, "Flank", "dense"), (3, "Flank", "dense"),
                            (6, "Flank", "dense"), (3, "Default", "flat")):
        cfg = mt.EnvConfig(team_size=ts,
                           reward_mode=getattr(mt.RewardMode, mode))
        env = mt.Env(cfg, simple_map_dir, num_worlds=1, device="cpu")
        state, _ = env.reset()
        _, dirs, _, zgroups = sensor_fan(cfg, state)
        n_los = (8 if mode == "Flank" else 4) * ts
        assert zgroups[0] == n_los and dirs[0].shape[-1] == sum(zgroups)
        assert fan_route(zgroups, env.map_data) == route


@pytest.mark.parametrize("mode", MODES)
def test_train_cli_builds_every_mode(mode, simple_map_dir):
    from madrona_mp_env_tpu_torch.train import train as train_cli

    cfg, _, env, mgr = train_cli.build(train_cli.parse_args([
        "--cpu", "--game-mode", mode, "--num-worlds", "2", "--team-size",
        "2", "--steps-per-update", "4", "--scene", simple_map_dir]))
    assert cfg.task == getattr(mt.Task, mode) and env.cfg is cfg
    assert mgr.A == cfg.num_agents == (1 if mode == "Explore" else 4)
    assert cfg.has_flag(mt.SimFlags.HardcodedSpawns) == (
        mode == "ZoneCaptureDefend")


@pytest.mark.parametrize("mode", MODES)
def test_eval_cli_runs_every_mode(mode, simple_map_dir, tmp_path):
    """The eval CLI on --cpu with each --game-mode: two policies of seeded
    weights (one in Explore: its one agent a world is always slot 0 of
    the crossplay routing, so a second policy would field no actor, and
    the port's block split refuses that), 2 worlds x 2 steps at team size
    6, finite ratings."""
    import make_eval_fixture as ex
    from madrona_mp_env_tpu_torch.train import infer
    from madrona_mp_env_tpu_torch.train.convert import flatten
    from policy_weights import random_flax_params

    want = dict(np.load(ex.PATH))
    tree = {"params": random_flax_params(ex.WEIGHT_SEED, ex.NUM_POLICIES),
            "normalizer": {
                "mu": {k.split("/")[1]: v for k, v in want.items()
                       if k.startswith("norm_mu/")},
                "var": {k.split("/")[1]: v for k, v in want.items()
                        if k.startswith("norm_var/")},
                "count": want["norm_count"]},
            "elo": want["elo0"]}
    path = str(tmp_path / "policy.npz")
    np.savez(path, **flatten(tree))
    mgr, elo = infer.main([
        "--cpu", "--game-mode", mode, "--num-worlds", "2", "--num-steps",
        "2", "--team-size", str(ex.TEAM_SIZE), "--scene", simple_map_dir,
        "--ckpt-path", path]
        + (["--single-policy", "0"] if mode == "Explore" else []))
    assert mgr.cfg.task == getattr(mt.Task, mode)
    assert mgr.cfg.has_flag(mt.SimFlags.HardcodedSpawns) == (
        mode == "ZoneCaptureDefend")
    assert np.isfinite(elo.numpy()).all()
