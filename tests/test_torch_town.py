"""The big-map path: Zone on data/town_map (6,108 triangles padded to
6,144, PVS cell tables) through the port on the CPU, against the JAX
package.

- Cell indices: the port's ``cell_index`` / ``short_cell_index`` equal
  JAX's, run eagerly, on random positions, positions exactly on (and an
  ulp either side of) cell boundaries, and dead positions (z > 5000).
- Gates: ``use_fan_cull`` / ``use_sc_pack`` give the JAX package's
  choices on both maps (simple_map: dense fan, packed casts; town_map:
  culled fan, packed casts).
- The culled fan's plain version equals JAX's ``_ray_vs_tris_dense`` over
  each fan's candidate rows (1e-6 relative), on the sensor fans of three
  states of the committed JAX town rollout
  (fixtures_torch/zone_town_map_slice.npz, make_town_fixture.py); on the
  same fans its hits and misses agree with JAX's full-soup sweep on at
  least 99.5% of the rays (the PVS is sampled: tests/test_town_map.py's
  bar).
- The packed casts' plain version equals JAX's dense sphere cast within
  1e-6 relative where the step reads it: down casts within t <= 64,
  forward casts within t <= 20 (move_dist + buf).
- The whole slice (Zone 2v2, 2 worlds, 16 steps) against the fixture:
  with the gates forced dense at the simple_map slice's tolerances
  (tests/test_torch_slice.py); with the default gates, hp, alive, team
  points and done exact, pos within 1e-4 relative, and a lidar depth off
  by more than 2e-2 relative on at most 1% of the beams (the PVS bar of
  tests/test_culling.py).

The JAX functions run eagerly, on numpy copies of the port's soup (the
same Morton order and bits, tests/test_torch_assets.py).
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import madrona_mp_env_tpu_torch as mt
from madrona_mp_env_tpu.ops import culling as jcull
from madrona_mp_env_tpu.ops import raycast as jrc
from madrona_mp_env_tpu_torch.assets.map_data import load_map
from madrona_mp_env_tpu_torch.ops import culling, raycast
from madrona_mp_env_tpu_torch.sim import movement
from madrona_mp_env_tpu_torch.sim.observations import sensor_fan
from madrona_mp_env_tpu_torch.sim.types import world_state_from_numpy

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
TOWN = os.path.join(REPO, "data", "town_map")
FIXTURE = os.path.join(HERE, "fixtures_torch", "zone_town_map_slice.npz")
FAN_STEPS = (0, 8, 15)  # make_town_fixture.FAN_STEPS
R = 15.0
sys.path.insert(0, HERE)
from test_torch_slice import compare, port_rollout  # noqa: E402
from torch_threads import one_thread_under_xdist  # noqa: E402,F401



def _cfg(team_size=2):
    return mt.EnvConfig(
        task=mt.Task.Zone, team_size=team_size,
        sim_flags=mt.SimFlags.StaggerStarts | mt.SimFlags.RandomFlipTeams,
    )


@pytest.fixture(scope="module")
def town():
    return load_map(TOWN, _cfg(), device="cpu")


@pytest.fixture(scope="module")
def fixture_data():
    return dict(np.load(FIXTURE))


def _jsoup(soup, rows=None, ok=None):
    """The port's soup (or its rows [N, K] as [N, 1, K] per-fan soups) as
    a JAX TriSoup for the dense functions."""
    def take(x):
        x = x.numpy()
        return jnp.asarray(x if rows is None else x[rows][:, None])

    valid = take(soup.valid)
    if ok is not None:
        valid = valid & jnp.asarray(ok[:, None])
    return jrc.TriSoup(v0=take(soup.v0), e1=take(soup.e1), e2=take(soup.e2),
                       normal=take(soup.normal), valid=valid, packed=None,
                       sc_packed=None, dir_packed=None)


# ---------------------------------------------------------------------------
# cell indices and gates
# ---------------------------------------------------------------------------

def _positions(kind, gx0, gy0, cs, n, z=50.0):
    g = np.random.default_rng(0)
    if kind == "random":
        p = np.stack([g.uniform(gx0 - 300, gx0 + cs * (n + 1), 512),
                      g.uniform(gy0 - 300, gy0 + cs * (n + 1), 512),
                      g.uniform(-100.0, 400.0, 512)], -1)
        return p.astype(np.float32)
    if kind == "boundary":
        # every grid line in float32, and the neighbouring floats
        e = np.float32(gx0) + np.arange(n + 1, dtype=np.float32) * np.float32(cs)
        ey = np.float32(gy0) + np.arange(n + 1, dtype=np.float32) * np.float32(cs)
        xs = np.concatenate([e, np.nextafter(e, -np.inf), np.nextafter(e, np.inf)])
        ys = np.concatenate([ey, np.nextafter(ey, -np.inf), np.nextafter(ey, np.inf)])
        X, Y = np.meshgrid(xs, ys)
        return np.stack([X.ravel(), Y.ravel(), np.full(X.size, z, np.float32)],
                        -1).astype(np.float32)
    # dead: the teleport box, and z around the 5000 threshold
    p = _positions("random", gx0, gy0, cs, n)[:64]
    p[:, 2] = np.array([5000.0, np.nextafter(np.float32(5000.0), np.inf),
                        10000.0, 4999.0], np.float32)[np.arange(64) % 4]
    return p


@pytest.mark.parametrize("kind", ["random", "boundary", "dead"])
def test_cell_index_matches_jax(town, kind):
    c = town.cells
    raw = dict(np.load(os.path.join(TOWN, "culling.npz")))
    jt = jcull.CellTables(
        cand_idx=None, ray_packed=None, ray_dir_packed=None, sc_packed=None,
        grid_min_x=float(raw["grid_min"][0]),
        grid_min_y=float(raw["grid_min"][1]),
        cell_size=float(raw["cell_size"]), nx=int(raw["nx"]),
        ny=int(raw["ny"]), K=int(raw["K"]))
    pos = _positions(kind, c.grid_min_x, c.grid_min_y, c.cell_size, c.nx)
    want = np.asarray(jcull.cell_index(jt, jnp.asarray(pos)))
    got = culling.cell_index(c, torch.as_tensor(pos)).numpy()
    assert np.array_equal(want, got)
    if kind == "dead":
        assert (got == c.dead_cell).sum() == 32
    # the x-major order: the next column in x is ny cells further on
    assert culling.cell_index(c, torch.tensor([[
        c.grid_min_x + 1.5 * c.cell_size, c.grid_min_y + 0.5, 0.0]]))[0] \
        == c.ny


@pytest.mark.parametrize("kind", ["random", "boundary"])
@pytest.mark.parametrize("which", ["short", "short_mv"])
def test_short_cell_index_matches_jax(town, kind, which):
    st = getattr(town, which)
    jst = jcull.ShortTables(cand=None, table=None, grid_min=st.grid_min,
                            cell_size=st.cell_size, nx=st.nx, ny=st.ny,
                            K=st.K)
    pos = _positions(kind, st.grid_min[0], st.grid_min[1], st.cell_size,
                     st.nx)
    want = np.asarray(jcull.short_cell_index(jst, jnp.asarray(pos)))
    got = culling.short_cell_index(st, torch.as_tensor(pos)).numpy()
    assert np.array_equal(want, got)


@pytest.mark.parametrize("scene, ks, fan_cull, sc_pack", [
    ("simple_map", (256, 56, 48), False, True),
    ("town_map", (6144, 280, 256), True, True),
])
def test_gates(scene, ks, fan_cull, sc_pack, monkeypatch):
    """The JAX package's gates on both maps (T >= 4 K), and the modes.
    simple_map ships no culling.npz (a built one would have K = 128, still
    dense at T = 256); town_map's has K = 1152."""
    monkeypatch.delenv("MPENV_FAN_CULL", raising=False)
    monkeypatch.delenv("MPENV_SC_PACK", raising=False)
    m = load_map(os.path.join(REPO, "data", scene), _cfg(), device="cpu")
    assert (m.tris.num_tris, m.short.K, m.short_mv.K) == ks
    if scene == "town_map":
        assert m.cells.K == 1152 and m.cells.num_cells == 257
    assert raycast.use_fan_cull(m.tris, m.cells) == fan_cull
    assert movement.use_sc_pack(m) == sc_pack
    for mode in ("0", "1"):
        monkeypatch.setenv("MPENV_FAN_CULL", mode)
        monkeypatch.setenv("MPENV_SC_PACK", mode)
        assert raycast.use_fan_cull(m.tris, m.cells) == (
            mode == "1" and m.cells is not None)
        assert movement.use_sc_pack(m) == (mode == "1")


# ---------------------------------------------------------------------------
# the culled fan (K6's plain version)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fans(town, fixture_data):
    """Sensor fans of the fixture's states at FAN_STEPS: (origins, zg,
    dirs, zgroups, cells)."""
    parts = []
    for s in FAN_STEPS:
        leaves = {k.split("/", 1)[1]: v for k, v in fixture_data.items()
                  if k.startswith(f"state{s}/")}
        st = world_state_from_numpy(leaves)
        _, dirs, zg, zgroups = sensor_fan(_cfg(), st)
        W, A = st.hp.shape
        parts.append((st.pos.reshape(W * A, 3), zg.reshape(W * A, -1),
                      tuple(c.reshape(W * A, -1) for c in dirs)))
    org = torch.cat([p[0] for p in parts])
    zg = torch.cat([p[1] for p in parts])
    dirs = tuple(torch.cat([p[2][k] for p in parts]) for k in range(3))
    return org, zg, dirs, zgroups, culling.cell_index(town.cells, org)


def _fan_od(org, zg, dirs, zgroups):
    o, d = raycast._fan_rays(org, zg, dirs, zgroups)
    return o.numpy(), d.numpy()


def test_culled_fan_plain_matches_jax(town, fans):
    org, zg, dirs, zgroups, cells = fans
    got = raycast._ray_fans_culled_plain(org, zg, dirs, zgroups, cells,
                                         town.cells, town.tris).numpy()
    cand = town.cells.cand_idx[cells.long()].numpy()
    ok = cand >= 0
    o, d = _fan_od(org, zg, dirs, zgroups)
    want = np.asarray(jrc._ray_vs_tris_dense(
        o, d, _jsoup(town.tris, np.where(ok, cand, 0), ok)))
    assert np.array_equal(np.isfinite(want), np.isfinite(got))
    hit = np.isfinite(want)
    assert hit.mean() > 0.3
    assert np.all(np.abs(got[hit] - want[hit])
                  <= 1e-6 * np.maximum(1.0, np.abs(want[hit])))
    # the wrapper takes the plain version on the CPU, and t_max cuts hits
    assert np.array_equal(got, raycast.ray_fans_culled(
        org, zg, dirs, zgroups, cells, town.cells, town.tris).numpy())
    cut = raycast.ray_fans_culled(org, zg, dirs, zgroups, cells, town.cells,
                                  town.tris, t_max=500.0).numpy()
    assert np.array_equal(cut, np.where(got <= 500.0, got, np.inf))


def test_culled_fan_agrees_with_full_soup(town, fans):
    """The PVS bar: hit/miss agreement with JAX's full-soup dense sweep on
    >= 99.5% of the rays."""
    org, zg, dirs, zgroups, cells = fans
    got = raycast._ray_fans_culled_plain(org, zg, dirs, zgroups, cells,
                                         town.cells, town.tris).numpy()
    o, d = _fan_od(org, zg, dirs, zgroups)
    want = np.asarray(jrc._ray_vs_tris_dense(o, d, _jsoup(town.tris)))
    agree = (np.isfinite(want) == np.isfinite(got)).mean()
    assert agree >= 0.995, agree
    assert np.array_equal(raycast._ray_fans_dense(
        org, zg, dirs, zgroups, town.tris).numpy(), want)


# ---------------------------------------------------------------------------
# the packed casts (K4''s plain version)
# ---------------------------------------------------------------------------

def test_packed_cast_plain_matches_jax(town):
    """L2/L3/fall-shaped casts from walkable points of town_map against
    each agent's MOVE_MARGIN cell: ground checks from up to 2r off the
    agent's column, and flat forward casts from up to 20 along."""
    g = np.random.default_rng(3)
    n = 128
    v = town.nav_verts.numpy()
    x = (v[g.integers(0, len(v), n)] + [0.0, 0.0, 1.0]).astype(np.float32)
    ang = g.uniform(0, 2 * np.pi, n)
    flat = np.stack([np.cos(ang), np.sin(ang), np.zeros(n)], -1)
    down_o = x + flat * g.uniform(0, 30.0, (n, 1)) + [0.0, 0.0, 50.0]
    fwd_o = x + flat * g.uniform(0, 20.0, (n, 1)) + [0.0, 0.0, 30.0]
    turn = g.uniform(-1.5, 1.5, n) + ang
    fwd_d = np.stack([np.cos(turn), np.sin(turn), np.zeros(n)], -1)
    down_d = np.broadcast_to([0.0, 0.0, -1.0], (n, 3))
    o = np.stack([down_o, fwd_o], 1).astype(np.float32)  # [n, 2, 3]
    d = np.stack([down_d, fwd_d], 1).astype(np.float32)
    xt = torch.as_tensor(x)
    cells = culling.short_cell_index(town.short_mv, xt)
    got, _ = raycast.sphere_cast_packed(torch.as_tensor(o),
                                        torch.as_tensor(d), R, cells,
                                        town.short_mv, town.tris)
    got = got.numpy()
    want, _ = jrc._sphere_cast_vs_tris_dense(o, d, R, _jsoup(town.tris))
    want = np.asarray(want)
    for k, reach in ((0, 64.0), (1, 20.0)):
        near = want[:, k] <= reach
        assert near.mean() > 0.15, (k, near.mean())
        assert np.all(np.abs(got[near, k] - want[near, k])
                      <= 1e-6 * np.maximum(1.0, want[near, k]))
        assert np.all(got[~near, k] > reach)
    # the port's own dense cast: the same bits where consumed
    td, _ = raycast.sphere_cast(torch.as_tensor(o), torch.as_tensor(d), R,
                                town.tris)
    assert np.array_equal(td.numpy()[:, 0][want[:, 0] <= 64.0],
                          got[:, 0][want[:, 0] <= 64.0])


# ---------------------------------------------------------------------------
# the slice
# ---------------------------------------------------------------------------

def test_town_slice_dense_matches_fixture(fixture_data, monkeypatch):
    monkeypatch.setenv("MPENV_FAN_CULL", "0")
    monkeypatch.setenv("MPENV_SC_PACK", "0")
    got = port_rollout(TOWN)
    assert set(got) <= set(fixture_data)
    compare(got, fixture_data)


def test_town_slice_culled_matches_fixture(fixture_data, monkeypatch):
    monkeypatch.delenv("MPENV_FAN_CULL", raising=False)
    monkeypatch.delenv("MPENV_SC_PACK", raising=False)
    got = port_rollout(TOWN)
    for k in ("hp", "alive", "team_points", "done"):
        assert np.array_equal(got[k], fixture_data[k]), k
    w = fixture_data["pos"]
    assert np.all(np.abs(got["pos"] - w) <= 1e-4 * np.maximum(1.0, np.abs(w)))
    for k in ("obs_fwd_lidar", "obs_rear_lidar"):
        g, w = got[k][..., 0], fixture_data[k][..., 0]
        flips = np.abs(g - w) > 2e-2 * np.maximum(1.0, np.abs(w))
        assert flips.mean() <= 0.01, (k, flips.mean())


@pytest.mark.slow
def test_culled_fan_vs_jax_interpret_kernel(town, fans, monkeypatch):
    """The TPU kernel itself (Pallas interpret mode) against the port's
    culled fan on the same candidate rows. Its direction dots are bf16, so
    a ray grazing an edge can take a neighbouring triangle: hits and
    misses agree on >= 99.5% of the rays, and t within 2e-2 relative on
    >= 99% of the rays both hit (measured: all hits and misses agree, 7 of
    2,000 common hits beyond 2e-2)."""
    monkeypatch.setenv("MPENV_PALLAS", "interpret")
    from madrona_mp_env_tpu.assets import formats as jformats
    from madrona_mp_env_tpu.ops.raycast_pallas import (
        morton_sort_tris, ray_fans_culled_planar)

    org, zg, dirs, zgroups, cells = fans
    raw = dict(np.load(os.path.join(TOWN, "culling.npz")))
    tri = morton_sort_tris(jformats.load_collision_data(
        os.path.join(TOWN, "collisions.bin")).tri_verts)
    want = np.asarray(ray_fans_culled_planar(
        jnp.asarray(org.numpy()), jnp.asarray(zg.numpy()),
        tuple(jnp.asarray(c.numpy()) for c in dirs),
        jnp.asarray(cells.numpy()), jcull.pack_tables(raw, tri),
        zgroups=tuple(zgroups)))
    got = raycast._ray_fans_culled_plain(org, zg, dirs, zgroups, cells,
                                         town.cells, town.tris).numpy()
    assert (np.isfinite(want) == np.isfinite(got)).mean() >= 0.995
    both = np.isfinite(want) & np.isfinite(got)
    rel = np.abs(got[both] - want[both]) / np.maximum(1.0, np.abs(want[both]))
    assert (rel <= 2e-2).mean() >= 0.99
