"""The plain versions of the kernel bench's kernels against the JAX
package's dense CPU functions, on simple_map:

- K7 ``ray_fans_vs_tris_flat`` (stacked directions): JAX's
  ``ray_fans_vs_tris`` on the same rays, for per-ray offsets and for the
  sensor fan's runs at team sizes 1, 2 and 3 (runs of 4, 8 and 12 LOS
  rays: unaligned, aligned, unaligned), the offsets given per run and per
  ray. t within 1e-5 * max(1, |t|), the same rays hit.
- K8 ``sphere_cast_vs_tris`` / ``sphere_cast_grouped``: JAX's
  ``sphere_cast_vs_tris`` on random casts and on the L1 batch's casts:
  t within 1e-5 * max(1, |t|), the same casts hit, normals within 1e-5
  where JAX reports one (a hit, or any cast under a finite t_max); 0 on
  the port's misses and without normals.
- K3x ``fan_capsules_explicit``: JAX's ``ray_vs_capsules`` with each
  ray's self column masked, then argmin: t as above, indices exact.

Every JAX call is pinned to its dense path and runs eagerly (the
tolerances of tests/test_torch_raycast.py); the K7 cases go through one
JAX call with a ray per fan, so its primitives compile once.
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
from madrona_mp_env_tpu_torch.sim import movement
from madrona_mp_env_tpu_torch.tools.kernel_bench import sensor_zgroups

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "fixtures_torch"))
from torch_threads import one_thread_under_xdist  # noqa: E402,F401

R = 15.0  # agent radius
SEG_H = 35.0  # capsule segment height
NUM_FANS = 24
FAN_CASES = {"per_ray": None, "ts1": sensor_zgroups(1),
             "ts2": sensor_zgroups(2), "ts3": sensor_zgroups(3)}


@pytest.fixture(scope="module")
def maps(simple_map_dir):
    cfg = dict(task=2, team_size=3)
    with pytest.MonkeyPatch.context() as mp_:
        mp_.setenv("MPENV_PALLAS", "dense")
        jm = jload_map(simple_map_dir, mp.EnvConfig(**cfg))
    return jm, load_map(simple_map_dir, mt.EnvConfig(**cfg), device="cpu")


def _walkable(m, n, g, lift):
    v = m.nav_verts.numpy()
    p = v[g.integers(0, len(v), n)] + g.normal(0, 40.0, (n, 3))
    p[:, 2] = v[g.integers(0, len(v), n), 2] + g.uniform(*lift, n)
    return p.astype(np.float32)


def _unit(g, shape, flat=False):
    d = g.normal(size=shape + (3,))
    if flat:
        d[..., 2] = 0.0
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def _check_t(want, got, rel=1e-5):
    want, got = np.asarray(want), np.asarray(got)
    assert np.array_equal(np.isfinite(want), np.isfinite(got))
    hit = np.isfinite(want)
    assert np.all(np.abs(want[hit] - got[hit])
                  <= rel * np.maximum(1.0, np.abs(want[hit])))


# ---------------------------------------------------------------------------
# K7: the stacked-direction fan
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fan_cases(maps):
    """{case: (origins [N, 3], zg [N, G] or None, zoff [N, F], dirs [N, F,
    3], JAX t [N, F])}; dirs are not unit (t is in units of |d|)."""
    jm, tm = maps
    g = np.random.default_rng(40)
    cases = {}
    for name, zgroups in FAN_CASES.items():
        F = sum(zgroups) if zgroups else 90
        org = _walkable(tm, NUM_FANS, g, (0.0, 5.0))
        if zgroups:
            zg = g.uniform(10.0, 60.0, (NUM_FANS, len(zgroups)))
            zoff = np.repeat(zg, zgroups, axis=1).astype(np.float32)
            zg = zg.astype(np.float32)
        else:
            zg, zoff = None, g.uniform(10.0, 60.0, (NUM_FANS, F)).astype(
                np.float32)
        d = (_unit(g, (NUM_FANS, F)) * g.uniform(0.5, 2.0, (NUM_FANS, F, 1))
             ).astype(np.float32)
        cases[name] = (org, zg, zoff, d)
    # one JAX call, a ray per fan: origins [R, 3], zoffs [R, 1], dirs [R,
    # 1, 3] (the dense path builds each ray's origin as for a fan)
    org = np.concatenate([np.repeat(c[0], c[2].shape[1], axis=0)
                          for c in cases.values()])
    zoff = np.concatenate([c[2].reshape(-1, 1) for c in cases.values()])
    d = np.concatenate([c[3].reshape(-1, 1, 3) for c in cases.values()])
    with pytest.MonkeyPatch.context() as mp_:
        mp_.setenv("MPENV_PALLAS", "dense")
        t = np.asarray(jrc.ray_fans_vs_tris(org, zoff, d, jm.tris))[:, 0]
    out, i = {}, 0
    for name, c in cases.items():
        n = c[2].size
        out[name] = c + (t[i:i + n].reshape(c[2].shape),)
        i += n
    return out


@pytest.mark.parametrize("case", list(FAN_CASES))
def test_flat_fan_plain_matches_jax(maps, fan_cases, case):
    _, tm = maps
    org, zg, zoff, d, want = fan_cases[case]
    zgroups = FAN_CASES[case]
    ot, dt = torch.as_tensor(org), torch.as_tensor(d)
    got = raycast.ray_fans_vs_tris_flat(ot, torch.as_tensor(zoff), dt,
                                        tm.tris)
    assert got.shape == zoff.shape
    assert 0.3 < np.isfinite(want).mean() < 1.0
    _check_t(want, got)
    if zgroups:  # per-group offsets: the same rays, the same bits
        assert torch.equal(got, raycast.ray_fans_vs_tris_flat(
            ot, torch.as_tensor(zg), dt, tm.tris, zgroups=zgroups))
    cut = raycast.ray_fans_vs_tris_flat(ot, torch.as_tensor(zoff), dt,
                                        tm.tris, t_max=300.0)
    assert torch.equal(cut, torch.where(got <= 300.0, got, np.inf))


# ---------------------------------------------------------------------------
# K8: the sphere cast with its winner normal
# ---------------------------------------------------------------------------

def _casts(tm, kind, g):
    """224 casts: random (a third of them ground checks), or the L1
    batch of 32 moving agents (7 casts each, movement.l1_casts)."""
    if kind == "random":
        o = _walkable(tm, 224, g, (15.0, 50.0))
        d = _unit(g, (224,))
        d[::3] = [0.0, 0.0, -1.0]
        return o, d
    x = torch.as_tensor(_walkable(tm, 32, g, (0.0, 2.0)))
    v = torch.as_tensor(_unit(g, (32,), flat=True))
    o, d, _ = movement.l1_casts(x, v, torch.full((32,), 50.0),
                                torch.full((32,), 30.0))
    return o.reshape(-1, 3).numpy(), d.reshape(-1, 3).numpy()


@pytest.mark.parametrize("kind", ["random", "movement"])
def test_sphere_cast_normal_plain_matches_jax(maps, kind, monkeypatch):
    monkeypatch.setenv("MPENV_PALLAS", "dense")
    jm, tm = maps
    o, d = _casts(tm, kind, np.random.default_rng(41))
    ot, dt = torch.as_tensor(o), torch.as_tensor(d)
    for t_max in (np.inf, 20.0):
        want_t, want_n = (np.asarray(x) for x in jrc.sphere_cast_vs_tris(
            o, d, R, jm.tris, t_max))
        got_t, got_n = raycast.sphere_cast_vs_tris(ot, dt, R, tm.tris,
                                                   t_max=t_max)
        _check_t(want_t, got_t)
        hit = np.isfinite(want_t)
        assert hit.mean() > 0.2 and (np.isinf(t_max) or not hit.all())
        # JAX's dense path leaves a normal on a miss under t_max = inf
        # (the row-0 triangle's); under a finite t_max it zeroes it
        has_n = hit if np.isinf(t_max) else np.ones_like(hit)
        assert np.allclose(want_n[has_n], got_n.numpy()[has_n], rtol=0,
                           atol=1e-5)
        assert not got_n[~hit].any()
        t0, n0 = raycast.sphere_cast_grouped(
            ot.reshape(-1, 7, 3), dt.reshape(-1, 7, 3), R, tm.tris, t_max,
            with_normal=False)
        assert torch.equal(t0.reshape(-1), got_t) and not n0.any()


# ---------------------------------------------------------------------------
# K3x: the explicit-origin capsule fan
# ---------------------------------------------------------------------------

def test_fan_capsules_explicit_plain_matches_jax(maps):
    """Zone 3v3's A = 6 capsules per world; origins beside the agents,
    each ray skipping a capsule of its own (not always its caster's)."""
    _, tm = maps
    W, A, F = 4, 6, 24
    g = np.random.default_rng(42)
    pos = (_walkable(tm, W * A, g, (0.0, 1.0)) * 0.05).reshape(W, A, 3)
    alive = g.random((W, A)) > 0.2
    o = (pos[:, :, None, :] + g.normal(0.0, 30.0, (W, A, F, 3))
         + [0.0, 0.0, 40.0]).astype(np.float32)
    d = _unit(g, (W, A, F))
    self_idx = np.where(g.random((W, A, F)) < 0.7, np.arange(A)[:, None],
                        g.integers(0, A, (W, A, F))).astype(np.int32)

    def one_world(oo, dd, si, p, al):
        t = jrc.ray_vs_capsules(oo, dd, p, R, SEG_H, al)  # [A, F, A]
        t = jnp.where(si[..., None] == jnp.arange(A), jnp.inf, t)
        tm_, ix = jnp.min(t, -1), jnp.argmin(t, -1)
        return tm_, jnp.where(jnp.isinf(tm_), -1, ix)

    want_t, want_i = jax.vmap(one_world)(o, d, self_idx, pos, alive)
    got_t, got_i = raycast_cull.fan_capsules_explicit(
        torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(self_idx),
        torch.as_tensor(pos), torch.as_tensor(alive))
    assert 0.05 < np.isfinite(np.asarray(want_t)).mean() < 1.0
    _check_t(want_t, got_t)
    assert got_i.dtype == torch.int32
    assert np.array_equal(np.asarray(want_i), got_i.numpy())
