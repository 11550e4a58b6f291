"""The port's CUDA kernels against their plain PyTorch versions, on the
card. These need a CUDA device and nvcc; elsewhere they skip. On a GPU
machine run them with

    python -m pytest tests/test_torch_kernels.py -m cuda -q

Each kernel repeats its plain version's arithmetic op for op and is built
with --fmad=false, so results must be bit-equal: t, winner rows and
capsule indices exact. The big-map kernels (K6, K4' packed, and K2 and K4
dense over town_map's 6,144-triangle soup) run on data/town_map; K9 on
simple_map's sensor-ray tables.
"""

import numpy as np
import pytest
import torch

import madrona_mp_env_tpu_torch as mt
from madrona_mp_env_tpu_torch.ops import raycast, raycast_cull
from madrona_mp_env_tpu_torch.ops.culling import (cell_index, ray_cell_index,
                                                   short_cell_index)
from madrona_mp_env_tpu_torch.sim import movement

pytestmark = pytest.mark.cuda
R = 15.0


@pytest.fixture(scope="module")
def gpu_map(simple_map_dir):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from madrona_mp_env_tpu_torch.assets.map_data import load_map

    return load_map(simple_map_dir, mt.EnvConfig(team_size=6), device="cuda")


@pytest.fixture(scope="module")
def town_map(simple_map_dir):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import os

    from madrona_mp_env_tpu_torch.assets.map_data import load_map

    return load_map(os.path.join(os.path.dirname(simple_map_dir), "town_map"),
                    mt.EnvConfig(team_size=6), device="cuda")


def _points(m, n, seed, lift):
    g = np.random.default_rng(seed)
    v = m.nav_verts.cpu().numpy()
    p = v[g.integers(0, len(v), n)] + g.normal(0, 40.0, (n, 3))
    p[:, 2] += g.uniform(*lift, n)
    return torch.as_tensor(p.astype(np.float32), device="cuda")


def _dirs(n, seed, flat=False):
    g = np.random.default_rng(seed)
    d = g.normal(size=(n, 3))
    if flat:
        d[:, 2] = 0.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return torch.as_tensor(d.astype(np.float32), device="cuda")


def _eq(a, b):
    torch.cuda.synchronize()
    return torch.equal(a, b)


def test_ray_vs_tris_kernel(gpu_map):
    o, d = _points(gpu_map, 4096, 0, (10, 60)), _dirs(4096, 1)
    n0 = raycast.ray_vs_tris.launches
    t = raycast.ray_vs_tris(o, d, gpu_map.tris)
    assert raycast.ray_vs_tris.launches == n0 + 1
    assert _eq(t, raycast._ray_vs_tris_dense(o, d, gpu_map.tris))


@pytest.mark.parametrize("zgroups", [(24, 32, 32, 8, 8), (5, 13, 3, 83)])
def test_fan_kernel(gpu_map, zgroups):
    N, G, F = 256, len(zgroups), sum(zgroups)
    org = _points(gpu_map, N, 2, (0, 5))
    g = torch.Generator(device="cuda").manual_seed(3)
    zg = 10.0 + 50.0 * torch.rand((N, G), generator=g, device="cuda")
    d = _dirs(N * F, 4).reshape(N, F, 3)
    dirs = tuple(d[..., k].contiguous() for k in range(3))
    t = raycast.ray_fans_vs_tris(org, zg, dirs, zgroups, gpu_map.tris)
    assert _eq(t, raycast._ray_fans_dense(org, zg, dirs, zgroups,
                                          gpu_map.tris))


def _town_fans(m, N, seed):
    zgroups = (24, 32, 32, 8, 8)
    org = _points(m, N, seed, (0, 5))
    org[::16, 2] = 10000.0  # dead agents: the PVS's dead cell
    g = torch.Generator(device="cuda").manual_seed(seed)
    zg = 10.0 + 50.0 * torch.rand((N, len(zgroups)), generator=g,
                                  device="cuda")
    d = _dirs(N * sum(zgroups), seed + 1).reshape(N, -1, 3)
    return org, zg, tuple(d[..., k].contiguous() for k in range(3)), zgroups


def test_fan_culled_kernel(town_map):
    """K6 over each fan's PVS cell on town_map."""
    org, zg, dirs, zgroups = _town_fans(town_map, 384, 20)
    cells = cell_index(town_map.cells, org)
    assert bool((cells == town_map.cells.dead_cell).any())
    n0 = raycast.ray_fans_culled.launches
    t = raycast.ray_fans_culled(org, zg, dirs, zgroups, cells,
                                town_map.cells, town_map.tris)
    assert raycast.ray_fans_culled.launches == n0 + 1
    assert _eq(t, raycast._ray_fans_culled_plain(
        org, zg, dirs, zgroups, cells, town_map.cells, town_map.tris))
    assert bool(torch.isfinite(t).float().mean() > 0.3)


@pytest.mark.parametrize("runs", ["sensor", "every_ray", "long_fan"])
def test_fan_v9_kernel(gpu_map, runs):
    """K9 over each fan's sensor-ray table cell, per-ray z offsets: the
    sensor fan's 5 runs; a run per ray (104 groups, hoisted 8 at a time);
    and 300-ray fans of 30 runs (run detection over several blocks of
    threads). Dead agents take the dead cell."""
    N = 384
    F = 300 if runs == "long_fan" else 104
    org = _points(gpu_map, N, 30, (0, 5))
    org[::16, 2] = 10000.0
    g = torch.Generator(device="cuda").manual_seed(31)
    if runs == "sensor":
        reps = torch.tensor([24, 32, 32, 8, 8], device="cuda")
        zg = 10.0 + 50.0 * torch.rand((N, 5), generator=g, device="cuda")
        zoff = torch.repeat_interleave(zg, reps, dim=-1)
    elif runs == "every_ray":
        zoff = 10.0 + 50.0 * torch.rand((N, F), generator=g, device="cuda")
    else:
        zg = 10.0 + 50.0 * torch.rand((N, 30), generator=g, device="cuda")
        zoff = torch.repeat_interleave(zg, 10, dim=-1)
    d = _dirs(N * F, 32).reshape(N, F, 3)
    dirs = tuple(d[..., k].contiguous() for k in range(3))
    rt = gpu_map.ray_cells
    cells = ray_cell_index(rt, org)
    assert bool((cells == rt.dead_cell).any())
    n0 = raycast.ray_fans_culled_v9.launches
    t = raycast.ray_fans_culled_v9(org, zoff, dirs, cells, rt, gpu_map.tris)
    assert raycast.ray_fans_culled_v9.launches == n0 + 1
    assert _eq(t, raycast._ray_fans_v9_plain(org, zoff, dirs, cells, rt,
                                             gpu_map.tris))
    assert bool(torch.isfinite(t).float().mean() > 0.3)


def test_fan_kernel_big_soup(town_map):
    """K2 over the 6,144-triangle soup (tiled shared memory)."""
    org, zg, dirs, zgroups = _town_fans(town_map, 128, 22)
    t = raycast.ray_fans_vs_tris(org, zg, dirs, zgroups, town_map.tris)
    assert _eq(t, raycast._ray_fans_dense(org, zg, dirs, zgroups,
                                          town_map.tris))


@pytest.mark.parametrize("scene", ["simple_map", "town_map"])
def test_sphere_cast_packed_kernel(gpu_map, town_map, scene):
    """K4' on the L2 pair and a ground snap against the MOVE_MARGIN
    tables, and K4's dense entry on the same casts (on town_map: tiled
    over 6,144 triangles)."""
    m = gpu_map if scene == "simple_map" else town_map
    N = 1024
    x = _points(m, N, 24, (0, 2))
    v = _dirs(N, 25, flat=True)
    up = torch.tensor([0.0, 0.0, 1.0], device="cuda")
    cells = short_cell_index(m.short_mv, x)
    for o, d in ((torch.stack([x + v * 5.0 + up * 30.0, x + up * 50.0], 1),
                  torch.stack([v, -up.expand(N, 3)], 1)),
                 ((x + up * 30.0)[:, None], -up.expand(N, 1, 3))):
        n0 = raycast.sphere_cast_packed.launches
        tk, ik = raycast.sphere_cast_packed(o, d, R, cells, m.short_mv,
                                            m.tris)
        assert raycast.sphere_cast_packed.launches == n0 + 1
        tp, ip = raycast._sphere_cast_culled_plain(o, d, R, cells,
                                                   m.short_mv, m.tris)
        assert _eq(tk, tp) and _eq(ik, ip)
        tk, ik = raycast.sphere_cast(o, d, R, m.tris)
        tp, ip = raycast._sphere_cast_dense(o, d, R, m.tris)
        assert _eq(tk, tp) and _eq(ik, ip)


def test_fan_capsules_kernel(gpu_map):
    W, A, F = 64, 12, 104
    pos = (_points(gpu_map, W * A, 5, (0, 1)) * 0.05).reshape(W, A, 3)
    g = torch.Generator(device="cuda").manual_seed(6)
    alive = torch.rand((W, A), generator=g, device="cuda") > 0.2
    zoff = torch.full((W, A, F), 50.0, device="cuda")
    d = _dirs(W * A * F, 7, flat=True).reshape(W, A, F, 3)
    dirs = tuple(d[..., k].contiguous() for k in range(3))
    tk, ik = raycast_cull.fan_capsules(pos, zoff, dirs, alive)
    tp, ip = raycast_cull._fan_capsules_plain(pos, zoff, dirs, alive)
    assert _eq(tk, tp) and _eq(ik, ip)


def test_sphere_cast_kernels(gpu_map):
    N = 2048
    x = _points(gpu_map, N, 8, (0, 2))
    v = _dirs(N, 9, flat=True)
    top = torch.full((N,), 50.0, device="cuda")
    low = torch.full((N,), 30.0, device="cuda")
    o1, d1, _ = movement.l1_casts(x, v, top, low)
    tk, ik = raycast.sphere_cast(o1, d1, R, gpu_map.tris)
    tp, ip = raycast._sphere_cast_dense(o1, d1, R, gpu_map.tris)
    assert _eq(tk, tp) and _eq(ik, ip)
    cells = short_cell_index(gpu_map.short, x)
    tk, ik = raycast.sphere_cast_culled(o1, d1, R, cells, gpu_map.short,
                                        gpu_map.tris)
    tp, ip = raycast._sphere_cast_culled_plain(o1, d1, R, cells,
                                               gpu_map.short, gpu_map.tris)
    assert _eq(tk, tp) and _eq(ik, ip)


@pytest.mark.parametrize("team_size", [2, 6])
def test_tail_fused_kernel(simple_map_dir, gpu_map, team_size):
    """K5 against its plain version on the card: every output leaf
    bit-equal on states that rotate, contest, take and capture zones and
    finish matches (fixtures_torch/tail_states.py)."""
    import os
    import sys

    from madrona_mp_env_tpu_torch.assets.map_data import load_map
    from madrona_mp_env_tpu_torch.ops import tail_fused as tf
    from madrona_mp_env_tpu_torch.sim.types import (init_world_state,
                                                    world_state_from_numpy,
                                                    world_state_to_numpy)

    sys.path.insert(0, os.path.join(os.path.dirname(__file__),
                                    "fixtures_torch"))
    from tail_states import NUM_WORLDS, tail_scenario

    cfg = mt.EnvConfig(task=mt.Task.Zone, team_size=team_size)
    m = load_map(simple_map_dir, cfg, device="cuda")
    leaves = world_state_to_numpy(init_world_state(cfg, m.num_goal_regions,
                                                   NUM_WORLDS))
    fr = tail_scenario(leaves, team_size, m.zone_frames.cpu().numpy(),
                       m.num_zones, m.world_min.cpu().numpy(),
                       m.world_max.cpu().numpy(), cfg.episode_len)
    st = world_state_from_numpy(leaves, device="cuda")
    fr = torch.as_tensor(fr, device="cuda")
    n0 = tf.tail_fused.launches
    sk, ck = tf.tail_fused(cfg, m, st, fr)
    assert tf.tail_fused.launches == n0 + 1
    sp, cp = tf.tail_fused_plain(cfg, m, st, fr)
    assert _eq(ck, cp)
    for k, v in sp.leaves().items():
        assert _eq(getattr(sk, k), v), k


@pytest.mark.parametrize("team_size", [2, 6])
def test_unfused_tail_equals_fused_plain_on_card(simple_map_dir, gpu_map,
                                                 team_size):
    """The reference's unfused system chain on the card equals the fused
    order through tail_fused_plain bit for bit (on the card ATen divides
    by a Python scalar through its reciprocal; both divide by tensors)."""
    import os
    import sys

    from madrona_mp_env_tpu_torch.assets.map_data import load_map
    from madrona_mp_env_tpu_torch.ops import tail_fused as tf
    from madrona_mp_env_tpu_torch.sim import step as step_mod
    from madrona_mp_env_tpu_torch.sim.types import (init_world_state,
                                                    world_state_from_numpy,
                                                    world_state_to_numpy)

    sys.path.insert(0, os.path.join(os.path.dirname(__file__),
                                    "fixtures_torch"))
    from tail_states import NUM_WORLDS, tail_scenario

    cfg = mt.EnvConfig(task=mt.Task.Zone, team_size=team_size)
    m = load_map(simple_map_dir, cfg, device="cuda")
    leaves = world_state_to_numpy(init_world_state(cfg, m.num_goal_regions,
                                                   NUM_WORLDS))
    fr = tail_scenario(leaves, team_size, m.zone_frames.cpu().numpy(),
                       m.num_zones, m.world_min.cpu().numpy(),
                       m.world_max.cpu().numpy(), cfg.episode_len)
    fr = torch.as_tensor(fr, device="cuda")
    victims = torch.as_tensor(np.random.default_rng(4).integers(
        -1, cfg.num_agents, (NUM_WORLDS, cfg.num_agents)), device="cuda")
    sf, cf = step_mod.fused_tail(cfg, m, world_state_from_numpy(
        leaves, device="cuda"), victims, fr, tail=tf.tail_fused_plain)
    su, cu = step_mod.unfused_tail(cfg, m, world_state_from_numpy(
        leaves, device="cuda"), victims, fr)
    assert _eq(cf, cu)
    for k, v in su.leaves().items():
        w = getattr(sf, k)
        assert torch.equal(v, w) or (v.dtype.is_floating_point and bool(
            ((v == w) | (torch.isnan(v) & torch.isnan(w))).all())), k


@pytest.mark.parametrize("scene", ["simple_map", "town_map"])
def test_gpu_env_matches_cpu_env(simple_map_dir, gpu_map, scene):
    """Four steps of the kernel path against the plain path."""
    import os

    cfg = mt.EnvConfig(task=mt.Task.Zone, team_size=2)
    path = os.path.join(os.path.dirname(simple_map_dir), scene)
    envs = [mt.Env(cfg, path, num_worlds=2, device=dev)
            for dev in ("cuda", "cpu")]
    outs = []
    for env in envs:
        state, _ = env.reset()
        a = env.zero_actions().replace(
            move_amount=torch.full((2, 4), 2, dtype=torch.int32,
                                   device=env.device),
            fire=torch.ones((2, 4), dtype=torch.int32, device=env.device))
        for _ in range(4):
            state, out = env.step(state, a)
        outs.append((state.pos.cpu(), state.hp.cpu()))
    assert torch.equal(outs[0][1], outs[1][1])
    assert torch.allclose(outs[0][0], outs[1][0], rtol=1e-6, atol=1e-4)
