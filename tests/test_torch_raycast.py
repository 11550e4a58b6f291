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

R = 15.0  # agent radius
SEG_H = 35.0  # capsule segment height


@pytest.fixture(scope="module", autouse=True)
def one_thread_under_xdist():
    """One intra-op thread per pytest-xdist worker: several workers share
    the machine's cores, and ATen's OpenMP threads of every worker spinning
    on the plain versions' big elementwise ops slowed this file's
    sphere-cast cases four- to tenfold there."""
    if not os.environ.get("PYTEST_XDIST_WORKER"):
        yield
        return
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
