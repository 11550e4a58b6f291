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
JAX call with a ray per fan. The JAX outputs come from
tests/fixtures_torch/kernel_refs_jax.npz (make_kernel_refs_fixture.py,
which makes the inputs with this module's helpers); each case checks its
inputs against the stored ones first.
"""

import os
import sys

import numpy as np
import pytest
import torch

import madrona_mp_env_tpu_torch as mt
from madrona_mp_env_tpu_torch.assets.map_data import load_map
from madrona_mp_env_tpu_torch.ops import raycast, raycast_cull
from madrona_mp_env_tpu_torch.sim import movement
from madrona_mp_env_tpu_torch.tools.kernel_bench import sensor_zgroups

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "fixtures_torch"))
import make_kernel_refs_fixture as refs  # noqa: E402
from torch_threads import one_thread_under_xdist  # noqa: E402,F401

R = 15.0  # agent radius
SEG_H = 35.0  # capsule segment height
NUM_FANS = 24
FAN_CASES = {"per_ray": None, "ts1": sensor_zgroups(1),
             "ts2": sensor_zgroups(2), "ts3": sensor_zgroups(3)}
MAP_CFG = dict(task=2, team_size=3)


@pytest.fixture(scope="module")
def tmap(simple_map_dir):
    return load_map(simple_map_dir, mt.EnvConfig(**MAP_CFG), device="cpu")


@pytest.fixture(scope="module")
def want():
    return dict(np.load(refs.PATH))


def _same_inputs(want, prefix, **inputs):
    for k, v in inputs.items():
        assert np.array_equal(np.asarray(v), want[f"{prefix}/{k}"]), k


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

def fan_inputs(tm):
    """{case: (origins [N, 3], zg [N, G] or None, zoff [N, F], dirs [N, F,
    3])}; dirs are not unit (t is in units of |d|)."""
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
    return cases


def fan_rays(cases):
    """The cases as one JAX call's input, a ray per fan: origins [R, 3],
    zoffs [R, 1], dirs [R, 1, 3] (the dense path builds each ray's
    origin as for a fan)."""
    org = np.concatenate([np.repeat(c[0], c[2].shape[1], axis=0)
                          for c in cases.values()])
    zoff = np.concatenate([c[2].reshape(-1, 1) for c in cases.values()])
    d = np.concatenate([c[3].reshape(-1, 1, 3) for c in cases.values()])
    return org, zoff, d


@pytest.fixture(scope="module")
def fan_cases(tmap, want):
    """{case: fan_inputs' tuple + (JAX t [N, F],)}, JAX's t from the
    fixture."""
    cases = fan_inputs(tmap)
    org, zoff, d = fan_rays(cases)
    _same_inputs(want, "fan", org=org, zoff=zoff, d=d)
    t = want["fan/t"]
    out, i = {}, 0
    for name, c in cases.items():
        n = c[2].size
        out[name] = c + (t[i:i + n].reshape(c[2].shape),)
        i += n
    return out


@pytest.mark.parametrize("case", list(FAN_CASES))
def test_flat_fan_plain_matches_jax(tmap, fan_cases, case):
    tm = tmap
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

SC_T_MAX = (np.inf, 20.0)


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
def test_sphere_cast_normal_plain_matches_jax(tmap, want, kind):
    tm = tmap
    o, d = _casts(tm, kind, np.random.default_rng(41))
    _same_inputs(want, f"sc_{kind}", o=o, d=d)
    ot, dt = torch.as_tensor(o), torch.as_tensor(d)
    for t_max in SC_T_MAX:
        want_t = want[f"sc_{kind}/t_{t_max}"]
        want_n = want[f"sc_{kind}/n_{t_max}"]
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

def capsule_inputs(tm):
    """Zone 3v3's A = 6 capsules per world; origins beside the agents,
    each ray skipping a capsule of its own (not always its caster's):
    (o, d [W, A, F, 3], self_idx [W, A, F], pos [W, A, 3], alive [W, A])."""
    W, A, F = 4, 6, 24
    g = np.random.default_rng(42)
    pos = (_walkable(tm, W * A, g, (0.0, 1.0)) * 0.05).reshape(W, A, 3)
    alive = g.random((W, A)) > 0.2
    o = (pos[:, :, None, :] + g.normal(0.0, 30.0, (W, A, F, 3))
         + [0.0, 0.0, 40.0]).astype(np.float32)
    d = _unit(g, (W, A, F))
    self_idx = np.where(g.random((W, A, F)) < 0.7, np.arange(A)[:, None],
                        g.integers(0, A, (W, A, F))).astype(np.int32)
    return o, d, self_idx, pos, alive


def test_fan_capsules_explicit_plain_matches_jax(tmap, want):
    """capsule_inputs against JAX's ray_vs_capsules with each ray's self
    column masked, then min / argmin (-1 on a miss)."""
    o, d, self_idx, pos, alive = capsule_inputs(tmap)
    _same_inputs(want, "cap", o=o, d=d, self_idx=self_idx, pos=pos,
                 alive=alive)
    want_t, want_i = want["cap/t"], want["cap/idx"]
    got_t, got_i = raycast_cull.fan_capsules_explicit(
        torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(self_idx),
        torch.as_tensor(pos), torch.as_tensor(alive))
    assert 0.05 < np.isfinite(np.asarray(want_t)).mean() < 1.0
    _check_t(want_t, got_t)
    assert got_i.dtype == torch.int32
    assert np.array_equal(np.asarray(want_i), got_i.numpy())
