"""The port's fused movement (P3, tools/probes/movement_fused_probe.py)
and the movement pair's cast routes, on the CPU.

The JAX side is the committed fixture tests/fixtures_torch/
zone_move_fused.npz (make_move_fused_fixture.py): the JAX probe's
apply_velocity_fall_fused run through the Pallas interpreter on a random
world over the whole soup (its dense entry) and on simple_map with the
short tables (its culled entry). The port's plain fused movement is held
to it at the JAX parity test's own bar (tests/test_pallas_parity.py
TestMovementFused): per agent, position within 1e-3 and velocity within
0.1, at most 1% of agents outside. The two differ by design on near-ties
(the probe's reassociated forms, its normal rule |edge_n . n| > 0.999)
and on underflow (its velocity commit on any(to_new != 0), the port's on
norm(to_new) > 0). The still-agent case is the JAX test's
test_fused_noop_when_still. The MPENV_SC_CULL=0 route (L1 over the whole
soup), alone and with MPENV_SC_PACK=0, is held to the eager JAX systems
fixture zone_simple_map_systems.npz at tests/test_torch_sim.py's bars.
"""

import os
import sys

import numpy as np
import pytest
import torch

import madrona_mp_env_tpu_torch as mt
from madrona_mp_env_tpu_torch.assets.map_data import load_map
from madrona_mp_env_tpu_torch.ops.raycast import make_tri_soup
from madrona_mp_env_tpu_torch.sim import movement
from madrona_mp_env_tpu_torch.sim.types import (
    init_world_state, world_state_from_numpy, world_state_to_numpy,
)
from madrona_mp_env_tpu_torch.tools.probes import movement_fused_probe as mf

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "fixtures_torch"))
from torch_threads import one_thread_under_xdist  # noqa: E402,F401

FIXTURE = os.path.join(HERE, "fixtures_torch", "zone_move_fused.npz")
SYSTEMS = os.path.join(HERE, "fixtures_torch", "zone_simple_map_systems.npz")
DP, DV, FRAC = 1e-3, 0.1, 0.01  # TestMovementFused's bar
RTOL = 1e-4  # tests/test_torch_sim.py's bar
CFG = mt.EnvConfig(task=mt.Task.Zone, team_size=6)


class _Soup:
    """A map with a soup and no culling tables (the JAX test's _M)."""

    def __init__(self, tris):
        self.tris = make_tri_soup(tris, pad_to=128)


@pytest.fixture(scope="module")
def fx():
    return dict(np.load(FIXTURE))


@pytest.fixture(scope="module")
def simple_map(simple_map_dir):
    return load_map(simple_map_dir, CFG, device="cpu")


def _state(fx, tag):
    W = fx[f"{tag}/pos"].shape[0]
    st = init_world_state(CFG, 1, W, device="cpu")
    return st.replace(**{k: torch.as_tensor(fx[f"{tag}/{k}"]) for k in (
        "pos", "vel", "stand_cur", "alive")})


@pytest.mark.parametrize("route", ["dense", "culled"])
def test_plain_fused_matches_jax_probe(route, fx, simple_map):
    """dense: the random world over its whole soup; culled: simple_map,
    L1 on the short tables and L2, L3, fall on the MOVE_MARGIN tables
    (the probe sweeps the short tables throughout: both are exact for
    what the movement reads)."""
    m = _Soup(fx["dense/tris"]) if route == "dense" else simple_map
    st = _state(fx, route)
    out = mf.apply_velocity_fall_fused(CFG, m, st, route)
    dp = np.abs(out.pos.numpy() - fx[f"{route}/out_pos"]).max(-1)
    dv = np.abs(out.vel.numpy() - fx[f"{route}/out_vel"]).max(-1)
    ok = (dp <= DP) & (dv <= DV)
    assert 1.0 - ok.mean() <= FRAC, (
        f"{(~ok).sum()} of {ok.size} agents diverge (max dp {dp.max()}, "
        f"max dv {dv.max()})")
    # the case moves agents: most positions change
    moved = np.abs(fx[f"{route}/out_pos"] - fx[f"{route}/pos"]).max(-1) > 0
    assert moved.mean() > 0.5


def test_plain_fused_noop_when_still(fx):
    """Standing agents with no velocity at z = 20 over the random world:
    xy kept, z only falls, velocity zero."""
    st = _state(fx, "still")
    out = mf.apply_velocity_fall_fused(CFG, _Soup(fx["still/tris"]), st,
                                       "dense")
    np.testing.assert_allclose(out.pos[..., :2].numpy(),
                               st.pos[..., :2].numpy(), atol=1e-5)
    assert bool((out.pos[..., 2] <= 20.0 + 1e-5).all())
    np.testing.assert_allclose(out.vel.numpy(), 0.0, atol=1e-5)


@pytest.mark.parametrize("route", ["dense", "culled"])
def test_plain_fused_is_the_split_pair(route, fx, simple_map):
    """On the CPU the fused entry is its plain version: the split pair
    under the route, with the plain sweeps, bit for bit."""
    st = _state(fx, "culled")
    got = mf.apply_velocity_fall_fused(CFG, simple_map, st, route)
    want = mf.split_pair(CFG, simple_map, st, route)
    assert torch.equal(got.pos, want.pos) and torch.equal(got.vel, want.vel)


def test_cast_route_follows_the_switches(monkeypatch, simple_map):
    monkeypatch.delenv("MPENV_SC_CULL", raising=False)
    monkeypatch.delenv("MPENV_SC_PACK", raising=False)
    assert movement.cast_route(simple_map) == movement.ROUTES["culled"]
    monkeypatch.setenv("MPENV_SC_CULL", "0")
    assert movement.cast_route(simple_map) == movement.CastRoute(False, True)
    monkeypatch.setenv("MPENV_SC_PACK", "0")
    assert movement.cast_route(simple_map) == movement.ROUTES["dense"]


def _close(what, got, want):
    if not np.issubdtype(want.dtype, np.floating):
        assert np.array_equal(got, want), what
        return
    same = (got == want) | (np.isnan(got) & np.isnan(want))
    with np.errstate(invalid="ignore"):
        err = np.where(same, 0.0, np.abs(got.astype(np.float64) - want))
    assert np.all(err <= RTOL * np.maximum(1.0, np.abs(want))), (
        what, float(err.max()))


@pytest.mark.parametrize("pack", ["auto", "0"])
@pytest.mark.parametrize("system", ["apply_velocity", "fall"])
def test_sc_cull_off_matches_jax_systems(system, pack, monkeypatch,
                                         simple_map_dir):
    """MPENV_SC_CULL=0 (and MPENV_SC_PACK=0 with it: every cast over the
    whole soup) against the eager JAX system on the same state."""
    monkeypatch.setenv("MPENV_SC_CULL", "0")
    monkeypatch.setenv("MPENV_SC_PACK", pack)
    data = dict(np.load(SYSTEMS))
    i = [str(n) for n in data["names"]].index(system)
    before = {k.split("/", 1)[1]: v for k, v in data.items()
              if k.startswith(f"{i}/")}
    after = {k.split("/", 1)[1]: v for k, v in data.items()
             if k.startswith(f"{i + 1}/")}
    cfg = mt.EnvConfig(
        task=mt.Task.Zone, team_size=2,
        sim_flags=mt.SimFlags.StaggerStarts | mt.SimFlags.RandomFlipTeams)
    m = load_map(simple_map_dir, cfg, device="cpu")
    route = movement.cast_route(m)
    assert not route.culled and route.packed == (pack == "auto")
    fn = (movement.apply_velocity_system if system == "apply_velocity"
          else movement.fall_system)
    out = world_state_to_numpy(fn(cfg, m, world_state_from_numpy(before)))
    for leaf, want in after.items():
        _close(f"{system}: {leaf}", out[leaf], want)
