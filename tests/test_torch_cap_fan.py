"""K3, the capsule sensor fan (ops/raycast_cull.py fan_capsules,
csrc/fan_capsules.cu fan_capsules_kernel), on the CPU.

- The kernel's schedule modelled in torch: the terms of ray_capsule that
  depend on the origin and the capsule alone, once per (fan, z-group,
  capsule); those of the ray alone once per ray; per pair two dots and
  three discriminants, with the square root and divide of the cylinder
  and of each cap sphere taken only where the discriminant lets it hit;
  the world's live capsules but the caster walked from the lowest index
  with a strict <. Its t and capsule index must equal the plain version's
  bit for bit (int32 views), on the sensor fans of the committed
  fixtures' states of both maps (Zone 2v2, 2 worlds) and on clustered
  fans with dead agents at A = 2, 6, 12 and 32.
- The plain version on per-group offsets equals the per-ray one (K3's
  predecessor's arguments) bit for bit, and matches the JAX package's
  ``fan_capsules_planar`` (its Pallas kernel in interpret mode, as the
  JAX tests run it on the CPU; stored in kernel_refs_jax.npz) at 2
  worlds: t within 1e-5 * max(1, |t|), the same rays hit, capsule
  indices equal.
"""

import os
import sys

import numpy as np
import pytest
import torch

import madrona_mp_env_tpu_torch as mt
from madrona_mp_env_tpu_torch import consts
from madrona_mp_env_tpu_torch.ops import raycast_cull
from madrona_mp_env_tpu_torch.ops.geom import dot, sqrt
from madrona_mp_env_tpu_torch.ops.raycast import _group_of_ray
from madrona_mp_env_tpu_torch.sim.observations import sensor_fan
from madrona_mp_env_tpu_torch.sim.types import world_state_from_numpy

HERE = os.path.dirname(os.path.abspath(__file__))
FIX = os.path.join(HERE, "fixtures_torch")
sys.path.insert(0, FIX)
import make_kernel_refs_fixture as refs  # noqa: E402
from torch_threads import one_thread_under_xdist  # noqa: E402,F401

F32 = torch.float32
INF = float("inf")
SENSOR_RUNS = (24, 32, 32, 8, 8)
PLANAR_FANS = (2, 12, 5)  # the JAX comparison's clustered fans: W, A, seed


def _f(x):
    return torch.tensor(x, dtype=F32)


def _v3(*c):
    return torch.stack(torch.broadcast_tensors(*c), -1)


def _hoisted_model(pos, zg, dirs, zgroups, alive):
    """fan_capsules_kernel in torch: -> (t, idx) [W, A, F] and the count
    of (ray, live capsule) pairs and of their square roots."""
    W, A, G = zg.shape
    r, sh = _f(consts.agent_radius), _f(raycast_cull.CAPSULE_SEG_H)
    zero, one = _f(0.0), _f(1.0)
    lift = _v3(zero * r, zero * r, one * r)
    seg = _v3(zero * sh, zero * sh, one * sh)
    seg_len2, rr = sh * sh, r * r
    inv_l2 = one / torch.clamp(seg_len2, min=1e-20)
    # per (fan, z-group, capsule): [W, A, G, A]
    o = _v3(pos[..., 0, None] + 0.0, pos[..., 1, None] + 0.0,
            pos[..., 2, None] + zg)[:, :, :, None, :]
    p0 = (pos + lift)[:, None, None]
    m = o - p0
    ms = dot(m, seg)
    mm = dot(m, m)
    c = mm - ms * ms * inv_l2 - rr
    cc0 = mm - rr
    m1 = o - (p0 + seg)
    cc1 = dot(m1, m1) - rr
    # the ray's group's terms: [W, A, F, A]
    g = _group_of_ray(tuple(zgroups), pos.device).long()
    m, ms, c, cc0, m1, cc1 = (x[:, :, g] for x in (m, ms, c, cc0, m1, cc1))
    # per ray: [W, A, F, 1]
    d = torch.stack(dirs, -1)[..., None, :]
    dd = dot(d, d)
    ds = dot(d, seg)
    a = dd - ds * ds * inv_l2
    a_ok = torch.abs(a) > 1e-12
    den = torch.clamp(dd, min=1e-20)
    # per pair, the roots and divides only where they can hit
    md = dot(m, d)
    b = md - ms * ds * inv_l2
    disc = b * b - a * c
    cyl = a_ok & (disc >= 0.0)
    sq = sqrt(torch.clamp(torch.where(cyl, disc, 0.0), min=0.0))
    tc = (-b - sq) / torch.where(cyl, a, one)
    s_hit = ms + tc * ds
    t_cyl = torch.where(cyl & (tc >= 0.0) & (s_hit >= 0.0)
                        & (s_hit <= seg_len2), tc, INF)

    def sphere(bb, cc):
        dsc = bb * bb - dd * cc
        ok = dsc >= 0.0
        s = sqrt(torch.clamp(torch.where(ok, dsc, 0.0), min=0.0))
        t = (-bb - s) / den
        return torch.where(ok & (t >= 0.0), t, INF), ok

    t0, ok0 = sphere(md, cc0)
    t1, ok1 = sphere(dot(m1, d), cc1)

    def min2(x, y):
        return torch.where(y < x, y, x)

    t = min2(t_cyl, min2(t0, t1))
    me = torch.arange(A)
    live = (alive > 0.0)[:, None, :] & (me[:, None] != me[None, :])
    best = torch.full(t.shape[:-1], INF)
    best_j = torch.zeros(t.shape[:-1], dtype=torch.int32)
    for j in range(A):
        take = live[..., j, None] & (t[..., j] < best)
        best = torch.where(take, t[..., j], best)
        best_j = torch.where(take, j, best_j)
    idx = torch.where(torch.isinf(best), -1, best_j).to(torch.int32)
    pairs = live[:, :, None, :].expand(t.shape)
    roots = sum(int((x & pairs).sum()) for x in (cyl, ok0, ok1))
    return best, idx, int(pairs.sum()), roots


def _bits_equal(got, want):
    (t, i), (tp, ip) = got, want
    return torch.equal(t.view(torch.int32), tp.view(torch.int32)) and \
        torch.equal(i, ip)


def _fixture_fans(scene):
    """[(pos, zg, dirs, zgroups, alive)] of the sensor fans of the
    committed fixtures' Zone 2v2 states of ``scene``."""
    if scene == "simple_map":
        data = np.load(os.path.join(FIX, "zone_simple_map_systems.npz"))
        i = [str(n) for n in data["names"]].index("observe")
        tags = [f"{i}"]
    else:
        data = np.load(os.path.join(FIX, "zone_town_map_slice.npz"))
        tags = ["state0", "state8", "state15"]
    cfg = mt.EnvConfig(task=mt.Task.Zone, team_size=2)
    out = []
    for tag in tags:
        state = world_state_from_numpy({k.split("/", 1)[1]: v for k, v in
                                        data.items()
                                        if k.startswith(f"{tag}/")})
        _, dirs, zg, zgroups = sensor_fan(cfg, state)
        out.append((state.pos, zg, dirs, zgroups, state.alive))
    return out


def _clustered_fans(W, A, seed):
    """W worlds of A agents within ~60 units of each other (capsules
    overlap the fans), every fifth dead, sensor runs over 104 rays."""
    g = np.random.default_rng(seed)
    G = len(SENSOR_RUNS)
    pos = g.normal(0.0, 40.0, (W, A, 3)).astype(np.float32)
    pos[..., 2] = g.uniform(0.0, 5.0, (W, A))
    zg = g.uniform(10.0, 60.0, (W, A, G)).astype(np.float32)
    d = g.normal(size=(W, A, sum(SENSOR_RUNS), 3))
    d[..., 2] *= 0.2
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    alive = (g.random((W, A)) > 0.2).astype(np.float32)
    return (torch.as_tensor(pos), torch.as_tensor(zg),
            tuple(torch.as_tensor(d[..., k].copy()) for k in range(3)),
            SENSOR_RUNS, torch.as_tensor(alive))


@pytest.mark.parametrize("scene", ["simple_map", "town_map"])
def test_hoisted_model_on_fixture_fans(scene):
    for pos, zg, dirs, zgroups, alive in _fixture_fans(scene):
        want = raycast_cull._fan_capsules_plain(pos, zg, dirs, zgroups, alive)
        t, idx, pairs, roots = _hoisted_model(pos, zg, dirs, zgroups, alive)
        assert _bits_equal((t, idx), want)
        assert pairs > 0 and roots < 3 * pairs


@pytest.mark.parametrize("A", [2, 6, 12, 32])
def test_hoisted_model_on_clustered_fans(A):
    fans = _clustered_fans(3, A, A)
    want = raycast_cull._fan_capsules_plain(*fans)
    t, idx, pairs, roots = _hoisted_model(*fans)
    assert _bits_equal((t, idx), want)
    # hits, misses and skipped roots all occur
    assert 0.02 < float(torch.isfinite(t).float().mean()) < 0.98
    assert 0 < roots < 3 * pairs


def test_group_plain_equals_ray_plain():
    pos, zg, dirs, zgroups, alive = _clustered_fans(2, 12, 3)
    zoff = torch.repeat_interleave(zg, torch.as_tensor(zgroups), dim=-1)
    assert _bits_equal(
        raycast_cull._fan_capsules_plain(pos, zg, dirs, zgroups, alive),
        raycast_cull._fan_capsules_ray_plain(pos, zoff, dirs, alive > 0.0))
    with pytest.raises(ValueError):
        raycast_cull.fan_capsules_v1(pos, zoff, dirs, alive > 0.0)


def test_plain_matches_jax_planar():
    """JAX's outputs from tests/fixtures_torch/kernel_refs_jax.npz
    (make_kernel_refs_fixture.py), on the same clustered fans."""
    pos, zg, dirs, zgroups, alive = _clustered_fans(*PLANAR_FANS)
    with np.load(refs.PATH) as want:
        for k, v in (("pos", pos), ("zg", zg), ("dirs", torch.stack(dirs)),
                     ("alive", alive)):
            assert np.array_equal(v.numpy(), want[f"capfan/{k}"]), k
        tj, ij = want["capfan/t"], want["capfan/idx"]
    t, idx = raycast_cull.fan_capsules(pos, zg, dirs, zgroups, alive)
    t, idx = t.numpy(), idx.numpy()
    hit = np.isfinite(t)
    assert np.array_equal(np.isfinite(tj), hit) and 0.05 < hit.mean() < 0.95
    assert np.all(np.abs(tj[hit] - t[hit])
                  <= 1e-5 * np.maximum(1.0, np.abs(t[hit])))
    assert np.array_equal(ij, idx)
