"""Each plain PyTorch version of the port's ray kernels against the JAX
package's dense CPU function, on rays from walkable points of simple_map
made with numpy.

The JAX functions run eagerly, op by op: under jit, XLA's CPU backend
contracts a + b * c into fused multiply-adds, which moves near-tangent
sphere casts by up to 1e-3 relative and can change their winner.
Tolerances: t within 1e-5 * max(1, |t|) where both hit, the same rays hit,
winner rows and capsule indices exact, normals within 1e-5. The culled
cast is checked against the port's own dense cast: bit-equal within the
range the step consumes, and so is the packed cast (K4') of the L2, L3
and fall batches.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import madrona_mp_env_tpu as mp
import madrona_mp_env_tpu_torch as mt
from madrona_mp_env_tpu.assets.map_data import load_map as jload_map
from madrona_mp_env_tpu.ops import raycast as jrc
from madrona_mp_env_tpu_torch.assets.map_data import load_map
from madrona_mp_env_tpu_torch.ops import raycast, raycast_cull
from madrona_mp_env_tpu_torch.ops.culling import short_cell_index
from madrona_mp_env_tpu_torch.sim import movement

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "fixtures_torch"))
from torch_threads import one_thread_under_xdist  # noqa: E402,F401

R = 15.0  # agent radius
SEG_H = 35.0  # capsule segment height


@pytest.fixture(scope="module")
def maps(simple_map_dir):
    cfg = dict(task=2, team_size=2)
    return (jload_map(simple_map_dir, mp.EnvConfig(**cfg)),
            load_map(simple_map_dir, mt.EnvConfig(**cfg), device="cpu"))


def _walkable(m, n, seed, lift=(10.0, 60.0)):
    g = np.random.default_rng(seed)
    v = m.nav_verts.numpy()
    p = v[g.integers(0, len(v), n)] + g.normal(0, 40.0, (n, 3))
    p[:, 2] = v[g.integers(0, len(v), n), 2] + g.uniform(*lift, n)
    return p.astype(np.float32)


def _dirs(n, seed, flat=False):
    g = np.random.default_rng(seed)
    d = g.normal(size=(n, 3))
    if flat:
        d[:, 2] = 0.0
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def _check_t(want, got, rel=1e-5):
    want, got = np.asarray(want), np.asarray(got)
    assert np.array_equal(np.isfinite(want), np.isfinite(got))
    hit = np.isfinite(want)
    assert np.all(np.abs(want[hit] - got[hit])
                  <= rel * np.maximum(1.0, np.abs(want[hit])))


def test_ray_vs_tris(maps):
    jm, tm = maps
    o, d = _walkable(tm, 512, 0), _dirs(512, 1)
    want = jrc._ray_vs_tris_dense(o, d, jm.tris)
    got = raycast.ray_vs_tris(torch.as_tensor(o), torch.as_tensor(d), tm.tris)
    assert np.isfinite(np.asarray(want)).mean() > 0.5
    _check_t(want, got)


@pytest.mark.parametrize("zgroups", [(24, 32, 32, 8, 8), (5, 13, 3, 83)])
def test_ray_fans(maps, zgroups, monkeypatch):
    """Sensor fans: the 6v6 runs, and runs that are not multiples of 8
    (the JAX package's fallback kernel family K7); same F, so the eager JAX
    ops compile once. The JAX entry is pinned to its dense path: other test
    modules set MPENV_PALLAS=interpret when they are imported, and the
    interpret-mode kernel takes bf16 direction dots."""
    monkeypatch.setenv("MPENV_PALLAS", "dense")
    jm, tm = maps
    N, G, F = 24, len(zgroups), sum(zgroups)
    g = np.random.default_rng(2)
    org = _walkable(tm, N, 3, lift=(0.0, 5.0))
    zg = g.uniform(10.0, 60.0, (N, G)).astype(np.float32)
    d = _dirs(N * F, 4).reshape(N, F, 3)
    zoff = np.repeat(zg, zgroups, axis=1)
    want = jrc.ray_fans_vs_tris(org, zoff, d, jm.tris)
    got = raycast.ray_fans_vs_tris(
        torch.as_tensor(org), torch.as_tensor(zg),
        tuple(torch.as_tensor(d[..., k].copy()) for k in range(3)),
        zgroups, tm.tris)
    assert got.shape == (N, F)
    _check_t(want, got)


def test_fan_capsules(maps):
    """Sensor rays vs the world's capsules: nearest t, lowest index among
    ties, -1 on a miss, own capsule and dead agents excluded."""
    _, tm = maps
    W, A, F = 3, 8, 40
    g = np.random.default_rng(5)
    pos = (_walkable(tm, W * A, 6, lift=(0.0, 1.0)) * 0.05).reshape(W, A, 3)
    alive = g.random((W, A)) > 0.2
    zoff = np.full((W, A, F), 50.0, np.float32)
    d = _dirs(W * A * F, 7, flat=True).reshape(W, A, F, 3)

    def one_world(p, al, dd):
        o = p[:, None, :] + jnp.array([0.0, 0.0, 50.0])
        t = jrc.ray_vs_capsules(o, dd, p, R, SEG_H, al)  # [A, F, A]
        t = jnp.where(jnp.arange(A)[:, None, None] == jnp.arange(A), jnp.inf,
                      t)
        tm_, ix = jnp.min(t, -1), jnp.argmin(t, -1)
        return tm_, jnp.where(jnp.isinf(tm_), -1, ix)

    want_t, want_i = jax.vmap(one_world)(pos, alive, d)
    got_t, got_i = raycast_cull.fan_capsules(
        torch.as_tensor(pos), torch.as_tensor(zoff),
        tuple(torch.as_tensor(d[..., k].copy()) for k in range(3)),
        torch.as_tensor(alive))

    assert np.isfinite(np.asarray(want_t)).mean() > 0.05
    _check_t(want_t, got_t)
    assert np.array_equal(np.asarray(want_i), got_i.numpy())


def _casts(tm, n, seed):
    o = _walkable(tm, n, seed, lift=(15.0, 50.0))
    d = _dirs(n, seed + 1)
    d[::3] = [0.0, 0.0, -1.0]  # ground checks, as the step issues them
    return o, d


def test_sphere_cast_t_and_winner(maps):
    jm, tm = maps
    o, d = _casts(tm, 384, 8)
    want_t, _ = jrc._sphere_cast_vs_tris_dense(o, d, R, jm.tris)
    want_i = jrc._sphere_cast_winner_idx_dense(o, d, R, jm.tris)
    got_t, got_i = raycast.sphere_cast(torch.as_tensor(o),
                                       torch.as_tensor(d), R, tm.tris)
    _check_t(want_t, got_t)
    assert np.array_equal(np.asarray(want_i)[np.isfinite(want_t)],
                          got_i.numpy()[np.isfinite(want_t)])


def test_sc_normals_from_idx(maps):
    """The winner's normal equals the JAX dense sweep's contact normal."""
    jm, tm = maps
    o, d = _casts(tm, 384, 9)
    want_t, want_n = jrc._sphere_cast_vs_tris_dense(o, d, R, jm.tris)
    ot, dt = torch.as_tensor(o), torch.as_tensor(d)
    _, idx = raycast.sphere_cast(ot, dt, R, tm.tris)
    got = raycast.sc_normals_from_idx(ot, dt, R, idx, tm.tris).numpy()
    hit = np.isfinite(np.asarray(want_t))
    assert hit.mean() > 0.3
    assert np.allclose(np.asarray(want_n)[hit], got[hit], rtol=0, atol=1e-5)


def test_culled_cast_equals_dense(maps):
    """The L1 7-cast batch through the short tables gives the dense cast's
    t and winner row wherever the step reads them (t <= UNSTICK_RANGE)."""
    _, tm = maps
    N = 256
    x = torch.as_tensor(_walkable(tm, N, 10, lift=(0.0, 2.0)))
    v = torch.as_tensor(_dirs(N, 11, flat=True))
    top = torch.full((N,), 50.0)
    low = torch.full((N,), 30.0)
    o1, d1, _ = movement.l1_casts(x, v, top, low)
    cells = short_cell_index(tm.short, x)
    tc, ic = raycast.sphere_cast_culled(o1, d1, R, cells, tm.short, tm.tris)
    td, idd = raycast.sphere_cast(o1, d1, R, tm.tris)
    near = td <= movement.UNSTICK_RANGE
    assert near.float().mean() > 0.2
    assert torch.equal(tc[near], td[near]) and torch.equal(ic[near],
                                                           idd[near])
    assert bool((tc[~near] > movement.UNSTICK_RANGE).all())


def test_packed_cast_equals_dense(maps):
    """The L2 pair (slide + unstick ground check) and the L3 / fall ground
    snaps through the MOVE_MARGIN short tables, as simple_map's step runs
    them (movement.use_sc_pack): the dense cast's t, bit for bit, for
    every down cast and every forward cast within move_dist + buf."""
    _, tm = maps
    assert movement.use_sc_pack(tm)
    N = 256
    x = torch.as_tensor(_walkable(tm, N, 12, lift=(0.0, 2.0)))
    v = torch.as_tensor(_dirs(N, 13, flat=True))
    up = torch.tensor([0.0, 0.0, 1.0])
    off = torch.as_tensor(np.random.default_rng(14).uniform(0, 20, (N, 1)),
                          dtype=torch.float32)
    o = torch.stack([x + v * off + up * 30.0, x - v * 30.0 + up * 50.0,
                     x + up * 30.0], dim=1)
    d = torch.stack([v, -up.expand(N, 3), -up.expand(N, 3)], dim=1)
    cells = movement.move_cells(tm, x)
    tp, _ = raycast.sphere_cast_packed(o, d, R, cells, tm.short_mv, tm.tris)
    td, _ = raycast.sphere_cast(o, d, R, tm.tris)
    assert torch.equal(tp[:, 1:], td[:, 1:])
    near = td[:, 0] <= 20.0
    assert near.float().mean() > 0.1
    assert torch.equal(tp[near, 0], td[near, 0])
    assert bool((tp[~near, 0] > 20.0).all())


# ---------------------------------------------------------------------------
# K9: the sensor fans over the sensor-ray tables (MPENV_FAN_V9=1)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def v9_fans(maps):
    """The sensor fans of a Zone 6v6 reset at 2 worlds on simple_map, as
    the step hands them to K9: (origins [N, 3], per-ray zoff [N, F], dirs
    (dx, dy, dz) [N, F], ray-table cells [N])."""
    from madrona_mp_env_tpu_torch.ops.culling import ray_cell_index
    from madrona_mp_env_tpu_torch.sim.observations import sensor_fan

    tm = maps[1]
    cfg = mt.EnvConfig(task=mt.Task.Zone, team_size=6)
    env = mt.Env(cfg, os.path.join(os.path.dirname(__file__), "..", "data",
                                   "simple_map"), num_worlds=2, seed=3,
                 device="cpu")
    state, _ = env.reset()
    _, dirs, zg, zgroups = sensor_fan(cfg, state)
    W, A = state.hp.shape
    zoff = torch.repeat_interleave(zg, torch.as_tensor(zgroups), dim=-1)
    org = state.pos.reshape(W * A, 3)
    return (org, zoff.reshape(W * A, -1),
            tuple(c.reshape(W * A, -1) for c in dirs),
            ray_cell_index(tm.ray_cells, org))


def _v9_rays(org, zoff, dirs):
    zero = torch.zeros_like(zoff)
    o = org[:, None, :] + torch.stack([zero, zero, zoff], dim=-1)
    return o.numpy(), torch.stack(dirs, dim=-1).numpy()


def test_ray_tables_match_jax(maps):
    """The port loads simple_map's culling_ray.npz as JAX does (candidate
    rows and grid), and its ray-table cells equal JAX's ray_cell_index on
    random, boundary and dead positions; a stale hash loads nothing."""
    from madrona_mp_env_tpu.ops import culling as jcull
    from madrona_mp_env_tpu_torch.ops import culling

    jm, tm = maps
    jt, tt = jm.ray_cells, tm.ray_cells
    assert tt.K == jt.K == 80 and tt.num_cells == 257
    assert np.array_equal(tt.cand_idx.numpy(), np.asarray(jt.cand_idx))
    assert (tt.grid_min_x, tt.grid_min_y, tt.cell_size, tt.nx, tt.ny) == (
        jt.grid_min_x, jt.grid_min_y, jt.cell_size, jt.nx, jt.ny)
    g = np.random.default_rng(11)
    edge = np.float32(tt.grid_min_x + 3 * np.float32(tt.cell_size))
    pos = np.concatenate([
        g.uniform(-2500, 2500, (512, 3)),
        np.stack([np.full(64, edge), g.uniform(-2000, 2000, 64),
                  g.uniform(0, 100, 64)], -1),
        np.stack([np.nextafter(np.full(64, edge, np.float32), -np.inf),
                  g.uniform(-2000, 2000, 64), g.uniform(0, 100, 64)], -1),
        [[0.0, 0.0, 10000.0], [5.0, -3.0, 5000.5]],
    ]).astype(np.float32)
    want = np.asarray(jcull.ray_cell_index(jt, jnp.asarray(pos)))
    got = culling.ray_cell_index(tt, torch.as_tensor(pos)).numpy()
    assert np.array_equal(got, want) and (want == 256).sum() == 2
    tri = tm.tris.v0.numpy()[:4, None].repeat(3, 1)
    assert culling.load_ray_tables(
        tri, os.path.dirname(__file__) + "/../data/simple_map") is None


def test_fan_v9_plain_matches_jax_sweep(maps, v9_fans):
    """K9's plain version against the JAX package's jnp sweep over each
    ray's candidate rows (ops/culling.py verify_ray_tables's pair), within
    1e-6 relative; the wrapper takes it on the CPU and t_max cuts hits."""
    from madrona_mp_env_tpu.ops import culling as jcull

    jm, tm = maps
    org, zoff, dirs, cells = v9_fans
    got = raycast._ray_fans_v9_plain(org, zoff, dirs, cells, tm.ray_cells,
                                     tm.tris).numpy()
    o, d = _v9_rays(org, zoff, dirs)
    F = zoff.shape[1]
    ids = np.asarray(jm.ray_cells.cand_idx)[np.repeat(cells.numpy(), F)]
    safe = np.maximum(ids, 0)
    s = jm.tris
    want = np.asarray(jax.jit(jax.vmap(
        lambda oo, dd, a, b, c, vv: jcull._dense_ray_idx(
            oo, dd, a, b, c, vv)[0]))(
        o.reshape(-1, 3), d.reshape(-1, 3), s.v0[safe], s.e1[safe],
        s.e2[safe], s.valid[safe] & jnp.asarray(ids >= 0))).reshape(got.shape)
    assert np.array_equal(np.isfinite(want), np.isfinite(got))
    hit = np.isfinite(want)
    assert hit.mean() > 0.3
    assert np.all(np.abs(got[hit] - want[hit])
                  <= 1e-6 * np.maximum(1.0, np.abs(want[hit])))
    assert np.array_equal(got, raycast.ray_fans_culled_v9(
        org, zoff, dirs, cells, tm.ray_cells, tm.tris).numpy())
    cut = raycast.ray_fans_culled_v9(org, zoff, dirs, cells, tm.ray_cells,
                                     tm.tris, t_max=500.0).numpy()
    assert np.array_equal(cut, np.where(got <= 500.0, got, np.inf))


def test_fan_v9_plain_vs_jax_interpret_kernel(maps, v9_fans, monkeypatch):
    """The TPU kernel itself (Pallas interpret mode) on the same fans and
    tables, held to its own test's bar (tests/test_pallas_parity.py
    TestFanKernelV9): its direction dots are bf16, so t within 2e-2
    relative where both hit and hits and misses disagree on <= 2% of the
    rays."""
    monkeypatch.setenv("MPENV_PALLAS", "interpret")
    from madrona_mp_env_tpu.ops.raycast_pallas import ray_fans_culled_v9

    jm, tm = maps
    org, zoff, dirs, cells = v9_fans
    want = np.asarray(ray_fans_culled_v9(
        jnp.asarray(org.numpy()), jnp.asarray(zoff.numpy()),
        tuple(jnp.asarray(c.numpy()) for c in dirs),
        jnp.asarray(cells.numpy()), jm.ray_cells))
    got = raycast._ray_fans_v9_plain(org, zoff, dirs, cells, tm.ray_cells,
                                     tm.tris).numpy()
    assert (np.isfinite(want) != np.isfinite(got)).mean() <= 0.02
    both = np.isfinite(want) & np.isfinite(got)
    assert both.mean() > 0.3
    rel = np.abs(got[both] - want[both]) / np.maximum(1.0, want[both])
    assert rel.max() <= 2e-2


def test_fan_v9_agrees_with_whole_soup(maps, v9_fans):
    """The sensor-ray tables are sampled, not exact: hits and misses agree
    with the whole-soup sweep on >= 99.5% of the rays (the PVS bar)."""
    _, tm = maps
    org, zoff, dirs, cells = v9_fans
    got = raycast._ray_fans_v9_plain(org, zoff, dirs, cells, tm.ray_cells,
                                     tm.tris)
    o, d = (torch.as_tensor(x) for x in _v9_rays(org, zoff, dirs))
    dense = raycast._ray_vs_tris_dense(o, d, tm.tris)
    agree = float((torch.isfinite(got) == torch.isfinite(dense))
                  .float().mean())
    assert agree >= 0.995, agree


def test_fan_v9_gate_routes_the_step(maps, monkeypatch):
    """MPENV_FAN_V9=1 on a map with sensor-ray tables sends the step's
    fans to K9's entry, ahead of the PVS and whole-soup fans; without the
    variable, or on a map without the tables, it does not."""
    from madrona_mp_env_tpu_torch.sim import observations

    _, tm = maps
    assert not raycast.use_fan_v9(tm.ray_cells)
    monkeypatch.setenv("MPENV_FAN_V9", "1")
    assert raycast.use_fan_v9(tm.ray_cells) and not raycast.use_fan_v9(None)
    called = []
    for name in ("ray_fans_culled_v9", "ray_fans_culled",
                 "ray_fans_vs_tris"):
        fn = getattr(observations, name)

        def rec(*a, _fn=fn, _name=name, **k):
            called.append(_name)
            return _fn(*a, **k)

        monkeypatch.setattr(observations, name, rec)
    cfg = mt.EnvConfig(task=mt.Task.Zone, team_size=2)
    env = mt.Env(cfg, os.path.join(os.path.dirname(__file__), "..", "data",
                                   "simple_map"), num_worlds=1, device="cpu")
    state, _ = env.reset()
    env.step(state, env.zero_actions())
    assert called == ["ray_fans_culled_v9"] * 2  # reset and step
