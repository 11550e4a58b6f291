"""The fused scalar tail (K5) of the port on the CPU.

(a) ``tail_fused_plain`` against the JAX package's own fused-tail kernel
    function (ops/tail_pallas._tail_batched, Pallas in interpret mode, run
    eagerly) on 4-world states made with numpy from a seed
    (fixtures_torch/tail_states.py: rotation, contest, take, capture,
    finish by points, by length and by a forced reset, first step), for
    team_size 2 (the states of zone_simple_map_systems.npz) and 6 (the
    spread bonus over 4 teammate pairs). Integral and boolean leaves
    exact; reward, min_dist_to_zone and team_rewards within
    1e-5 * max(1, |x|): the TPU kernel adds the zone-approach term before
    the in-zone term, the port in the reference's unfused order, and its
    zone constants come from XLA's trig.
(b) ``tail_fused_plain`` after breadcrumbs, filters, goal regions and
    explore (the fused step's order) against the port's unfused chain
    autoheal -> zone -> breadcrumbs -> match info -> filters -> goal
    regions -> explore -> rewards -> done: every leaf bit-equal, since
    both run the same float operations in the same order on the CPU.
"""

import ctypes
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import madrona_mp_env_tpu as mp
from madrona_mp_env_tpu.ops import tail_pallas
from madrona_mp_env_tpu.sim.types import WorldState as JaxWorldState

import madrona_mp_env_tpu_torch as mt
from madrona_mp_env_tpu_torch.assets.map_data import load_map
from madrona_mp_env_tpu_torch.ops import tail_fused as tf
from madrona_mp_env_tpu_torch.sim import (breadcrumbs, combat, explore,
                                          rewards, zones)
from madrona_mp_env_tpu_torch.sim.types import (init_world_state,
                                                world_state_from_numpy,
                                                world_state_to_numpy)

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "fixtures_torch"))
from tail_states import NUM_WORLDS, tail_scenario  # noqa: E402

SYSTEMS = os.path.join(HERE, "fixtures_torch", "zone_simple_map_systems.npz")
REL = 1e-5
CLOSE = ("reward", "min_dist_to_zone", "team_rewards")


def _cfg(ts):
    return mt.EnvConfig(
        task=mt.Task.Zone, team_size=ts,
        sim_flags=mt.SimFlags.StaggerStarts | mt.SimFlags.RandomFlipTeams)


@pytest.fixture(scope="module")
def maps(simple_map_dir):
    return {ts: load_map(simple_map_dir, _cfg(ts), device="cpu")
            for ts in (2, 6)}


def _states(ts, m, seed=3):
    """(port state leaves, force_reset, shot_victim) of 4 worlds."""
    cfg = _cfg(ts)
    if ts == 2:
        data = np.load(SYSTEMS)
        i = [str(n) for n in data["names"]].index("autoheal")
        leaves = {k.split("/", 1)[1]: np.concatenate([v, v])
                  for k, v in data.items() if k.startswith(f"{i}/")}
    else:
        leaves = world_state_to_numpy(init_world_state(
            cfg, m.num_goal_regions, NUM_WORLDS))
    fr = tail_scenario(leaves, ts, m.zone_frames.numpy(), m.num_zones,
                       m.world_min.numpy(), m.world_max.numpy(),
                       cfg.episode_len, seed=seed)
    g = np.random.default_rng(seed + 1)
    victims = g.integers(-1, cfg.num_agents, (NUM_WORLDS, cfg.num_agents))
    return leaves, fr, victims


def _assert_leaves(got, want, close=(), rel=0.0):
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape and g.dtype == w.dtype, (k, g.dtype,
                                                           w.dtype)
        if k in close:
            err = np.abs(g.astype(np.float64) - w)
            assert np.all(err <= rel * np.maximum(1.0, np.abs(w))), (
                k, float(err.max()))
        else:
            assert np.array_equal(g, w), k


@pytest.mark.parametrize("ts", [2, 6])
def test_tail_matches_jax_kernel(ts, maps, monkeypatch):
    monkeypatch.setenv("MPENV_PALLAS", "interpret")
    m = maps[ts]
    leaves, fr, _ = _states(ts, m)
    jm = SimpleNamespace(
        num_zones=m.num_zones,
        **{k: jnp.asarray(getattr(m, k).numpy()) for k in (
            "zone_min", "zone_max", "zone_rot", "world_min", "world_max")})
    jcfg = mp.EnvConfig(
        task=mp.Task.Zone, team_size=ts,
        sim_flags=mp.SimFlags.StaggerStarts | mp.SimFlags.RandomFlipTeams)
    js = JaxWorldState(**{k: jnp.asarray(v) for k, v in leaves.items()})
    js, jcap = tail_pallas._tail_batched(jcfg, jm, js, jnp.asarray(fr))
    want = {k: np.asarray(getattr(js, k)) for k in leaves}

    st, cap = tf.tail_fused_plain(_cfg(ts), m, world_state_from_numpy(leaves),
                                  torch.as_tensor(fr))
    got = world_state_to_numpy(st)
    _assert_leaves(got, want, CLOSE, REL)
    assert np.array_equal(cap.numpy(), np.asarray(jcap))
    # the scenario reached every branch it is meant to
    assert got["zone_cur"][0] != leaves["zone_cur"][0]  # rotation
    assert got["zone_contested"][0] and not got["zone_contested"][1]
    assert got["zone_controlling"].tolist()[1:3] == [0, 1]  # held, taken
    assert cap.tolist() == [False, True, False, False]  # capture
    assert got["is_finished"].tolist() == [False, True, True, True]
    assert got["team_points"][1, 0] == 125


def _fused_order(cfg, m, s, fr, victims):
    s = breadcrumbs.breadcrumb_system(cfg, s)
    s = explore.filters_system(cfg, s, victims, step_override=s.cur_step + 1)
    s = explore.goal_regions_system(cfg, m, s)
    s = explore.explore_visited_system(cfg, s)
    return tf.tail_fused(cfg, m, s, fr)


def _unfused_chain(cfg, m, s, fr, victims):
    s = combat.autoheal_system(cfg, s)
    s = zones.zone_system(cfg, m, s)
    s = breadcrumbs.breadcrumb_system(cfg, s)
    s, cap = zones.zone_match_info_system(cfg, m, s, fr != 0)
    s = explore.filters_system(cfg, s, victims)
    s = explore.goal_regions_system(cfg, m, s)
    s = explore.explore_visited_system(cfg, s)
    s = rewards.reward_system(cfg, m, s)
    done = s.is_finished.to(torch.int32)[:, None].expand(-1, cfg.num_agents)
    return s.replace(done=done.contiguous()), cap


@pytest.mark.parametrize("ts", [2, 6])
def test_tail_matches_unfused_chain(ts, maps):
    cfg, m = _cfg(ts), maps[ts]
    leaves, fr, victims = _states(ts, m)
    args = (torch.as_tensor(fr), torch.as_tensor(victims))
    fused, cap_f = _fused_order(cfg, m, world_state_from_numpy(leaves), *args)
    chain, cap_c = _unfused_chain(cfg, m, world_state_from_numpy(leaves),
                                  *args)
    _assert_leaves(world_state_to_numpy(fused), world_state_to_numpy(chain))
    assert torch.equal(cap_f, cap_c)


def test_kernel_operands_match_plain_outputs(maps):
    """The kernel's argument packing (run here on CPU tensors) takes the
    step's dtypes and allocates every output the plain version makes,
    with the plain version's dtype and shape."""
    cfg, m = _cfg(6), maps[6]
    leaves, fr, _ = _states(6, m)
    st = world_state_from_numpy(leaves)
    ins, outs = tf.kernel_operands(cfg, m, st, torch.as_tensor(fr))
    plain, cap = tf.tail_fused_plain(cfg, m, st, torch.as_tensor(fr))
    pointers = [n for n, t in tf._TailArgs._fields_ if t is ctypes.c_void_p]
    assert pointers == list(ins) + [
        k if k == "new_captured" else f"out_{k}" for k in outs]
    for k, v in outs.items():
        ref = cap if k == "new_captured" else getattr(plain, k)
        assert (v.dtype, v.shape) == (ref.dtype, ref.shape), k
    bad = st.replace(hp=st.hp.double())
    with pytest.raises(ValueError, match="hp"):
        tf.kernel_operands(cfg, m, bad, torch.as_tensor(fr))


def test_tail_scope(maps):
    m = maps[6]
    leaves, fr, _ = _states(6, m)
    cfg = mt.EnvConfig(task=mt.Task.Zone, team_size=6,
                       sim_flags=mt.SimFlags.EnableCurriculum)
    with pytest.raises(NotImplementedError, match="EnableCurriculum"):
        tf.tail_fused(cfg, m, world_state_from_numpy(leaves),
                      torch.as_tensor(fr))
    assert tf.use_tail_fused(_cfg(6))
    assert not tf.use_tail_fused(mt.EnvConfig(task=mt.Task.TDM))
