"""The port's CUDA kernels against their plain PyTorch versions, on the
card. These need a CUDA device and nvcc; elsewhere they skip. On a GPU
machine run them with

    python -m pytest tests/test_torch_kernels.py -m cuda -q

Each kernel repeats its plain version's arithmetic op for op and is built
with --fmad=false, so results must be bit-equal: t, winner rows and
capsule indices exact, float outputs by int32 views, so -0 differs from
+0 (``_eq``). One exception, as values (``_eq_values``): K4 culled and
K4' against their plain version, whose directionless casts' t may differ
in the sign of 0. The probes P4 (tensor-core products) and P1's fma,
rcp.approx and mma chains compute otherwise than their plain versions by
design and are held to the bars their modules state
(tools/probes/sc_mxu_probe.py MAX_DT and MAX_FLIP, tools/vpu_probe.py BARS
and MM_BAR). The big-map kernels (K6, K4' packed, and K2 and K4
dense over town_map's 6,144-triangle soup) run on data/town_map; K9 on
simple_map's sensor-ray tables; K7, K8 and K3x (the kernel bench's and
Zone 3v3's) on both maps.
"""

import numpy as np
import pytest
import torch

import madrona_mp_env_tpu_torch as mt
from madrona_mp_env_tpu_torch.ops import raycast, raycast_cull
from madrona_mp_env_tpu_torch.ops.culling import (ShortTables, cell_index,
                                                   ray_cell_index,
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
    """Bit-equal: int32 views of float32 tensors (-0 differs from +0)."""
    return torch.equal(_bits(a), _bits(b))


def _eq_values(a, b):
    """Equal as values (torch.equal: -0 equals +0)."""
    torch.cuda.synchronize()
    return torch.equal(a, b)


def test_ray_vs_tris_kernel(gpu_map):
    o, d = _points(gpu_map, 4096, 0, (10, 60)), _dirs(4096, 1)
    n0 = raycast.ray_vs_tris.launches
    t = raycast.ray_vs_tris(o, d, gpu_map.tris)
    assert raycast.ray_vs_tris.launches == n0 + 1
    assert _eq(t, raycast._ray_vs_tris_dense(o, d, gpu_map.tris))


FAN_RUNS = [(24, 32, 32, 8, 8), (8,) * 13, (104,)]


def _fans(m, N, zgroups, seed, dead=False):
    """N sensor fans of runs ``zgroups`` on map m (every 16th dead when
    ``dead``: the PVS's dead cell)."""
    org = _points(m, N, seed, (0, 5))
    if dead:
        org[::16, 2] = 10000.0
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    zg = 10.0 + 50.0 * torch.rand((N, len(zgroups)), generator=g,
                                  device="cuda")
    d = _dirs(N * sum(zgroups), seed + 2).reshape(N, -1, 3)
    return org, zg, tuple(d[..., k].contiguous() for k in range(3)), zgroups


@pytest.mark.parametrize("N", [1, 13, 385])
@pytest.mark.parametrize("zgroups", FAN_RUNS, ids=["sensor", "eights", "one"])
def test_fan_kernel(gpu_map, zgroups, N):
    """K2 over simple_map's soup at N not a multiple of the fans a block
    holds, for the sensor runs, runs of 8 and one run of 104."""
    org, zg, dirs, zgroups = _fans(gpu_map, N, zgroups, 2)
    n0 = raycast.ray_fans_vs_tris.launches
    t = raycast.ray_fans_vs_tris(org, zg, dirs, zgroups, gpu_map.tris)
    assert raycast.ray_fans_vs_tris.launches == n0 + 1
    assert _eq(t, raycast._ray_fans_dense(org, zg, dirs, zgroups,
                                          gpu_map.tris))


def test_device_ms_profiler_and_events(gpu_map):
    """kernel_bench.device_ms times K2 by torch.profiler, and by CUDA
    events around single calls when no profiler event names the
    kernel."""
    from madrona_mp_env_tpu_torch.tools import kernel_bench

    org, zg, dirs, zgroups = _fans(gpu_map, 385, FAN_RUNS[0], 4)

    def call():
        return raycast.ray_fans_vs_tris(org, zg, dirs, zgroups, gpu_map.tris)

    ms, how = kernel_bench.device_ms(call, "fan_tris_rb_kernel", reps=3)
    assert how == "profiler" and ms > 0.0
    ms, how = kernel_bench.device_ms(call, "no_such_kernel", reps=3,
                                     tries=1)
    assert how == "events" and ms > 0.0


def test_fan_runs_not_octets_raise(gpu_map, town_map):
    """A run of 12 (Zone 3v3's LOS run) on CUDA tensors: K2 and K6 raise
    (fan_route sends such runs to K7), and launch nothing."""
    org, zg, dirs, zgroups = _fans(gpu_map, 8, (12, 32, 32, 8, 8), 3)
    n2, n6 = raycast.ray_fans_vs_tris.launches, raycast.ray_fans_culled.launches
    with pytest.raises(ValueError):
        raycast.ray_fans_vs_tris(org, zg, dirs, zgroups, gpu_map.tris)
    cells = cell_index(town_map.cells, org)
    with pytest.raises(ValueError):
        raycast.ray_fans_culled(org, zg, dirs, zgroups, cells, town_map.cells,
                                town_map.tris)
    assert raycast.ray_fans_vs_tris.launches == n2
    assert raycast.ray_fans_culled.launches == n6


def _town_fans(m, N, seed):
    return _fans(m, N, (24, 32, 32, 8, 8), seed, dead=True)


def _k6_cells(town_map, org):
    """The fans' cells, with fan 0 in the cell of most candidates, fan 1
    in a cell emptied of every candidate and fan 2 in the dead cell; the
    tables with that cell emptied."""
    import dataclasses

    tables = town_map.cells
    cells = cell_index(tables, org)
    counts = (tables.cand_idx >= 0).sum(-1)
    empty = int(counts[:-1].argmin())
    cand = tables.cand_idx.clone()
    cand[empty] = -1
    special = [int(counts.argmax()), empty, tables.dead_cell]
    n = min(len(special), cells.shape[0])
    cells[:n] = torch.tensor(special[:n], device=cells.device,
                             dtype=cells.dtype)
    return cells, dataclasses.replace(tables, cand_idx=cand)


@pytest.mark.parametrize("N", [1, 13, 385])
@pytest.mark.parametrize("zgroups", FAN_RUNS, ids=["sensor", "eights", "one"])
def test_fan_culled_kernel(town_map, zgroups, N):
    """K6 over each fan's PVS cell on town_map, with the fans in cell
    order (the step's) and in their own order (the probe's launch with an
    identity order): the cell of most candidates, a cell with none (inf),
    the dead cell."""
    from madrona_mp_env_tpu_torch.tools import fan_rb_probe

    org, zg, dirs, zgroups = _fans(town_map, N, zgroups, 20, dead=True)
    cells, tables = _k6_cells(town_map, org)
    want = raycast._ray_fans_culled_plain(org, zg, dirs, zgroups, cells,
                                          tables, town_map.tris)
    n0 = raycast.ray_fans_culled.launches
    t = raycast.ray_fans_culled(org, zg, dirs, zgroups, cells, tables,
                                town_map.tris)
    assert raycast.ray_fans_culled.launches == n0 + 1
    assert _eq(t, want)
    assert _eq(fan_rb_probe.k6_launch(org, zg, dirs, zgroups, cells, tables,
                                      town_map.tris, grouped=False), want)
    if N > 1:
        assert bool(torch.isinf(t[1]).all())
    if N > 13:
        assert bool(torch.isfinite(t).float().mean() > 0.3)


@pytest.mark.parametrize("N", [1, 13, 12288])
def test_fan_cell_order_kernel(town_map, N):
    """K6's cell order (one block's counting sort) groups the fans by cell
    in increasing rank: a permutation whose cells follow the stable
    sort's; by town's heavy_rank, and over 5,000 cells (more than its
    1,024 threads) by a random rank."""
    g = np.random.default_rng(N)
    perm = torch.as_tensor(g.permutation(5000).astype(np.int32),
                           device="cuda")
    for C, rank in ((town_map.cells.num_cells, town_map.cells.heavy_rank),
                    (5000, perm)):
        cells = torch.as_tensor(g.integers(0, C, N).astype(np.int32),
                                device="cuda")
        cells[: N // 3] = C - 1  # a crowded cell
        n0 = raycast.fan_cell_order.launches
        order = raycast.fan_cell_order(cells, C, rank)
        assert raycast.fan_cell_order.launches == n0 + 1
        want = raycast._fan_cell_order_plain(cells, rank)
        assert order.dtype == torch.int32
        assert _eq(torch.sort(order).values, torch.sort(want).values)
        assert _eq(cells[order.long()], cells[want.long()])


def test_fan_culled_v1_kernel(town_map):
    """K6's predecessor entry (fan_culled_v1) against the plain version."""
    org, zg, dirs, zgroups = _town_fans(town_map, 384, 21)
    cells, tables = _k6_cells(town_map, org)
    n0 = raycast.ray_fans_culled_v1.launches
    t = raycast.ray_fans_culled_v1(org, zg, dirs, zgroups, cells, tables,
                                   town_map.tris)
    assert raycast.ray_fans_culled_v1.launches == n0 + 1
    assert _eq(t, raycast._ray_fans_culled_plain(
        org, zg, dirs, zgroups, cells, tables, town_map.tris))


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
    """K2 over the 6,144-triangle soup (24 tiles of the cp.async double
    buffer)."""
    org, zg, dirs, zgroups = _town_fans(town_map, 385, 22)
    t = raycast.ray_fans_vs_tris(org, zg, dirs, zgroups, town_map.tris)
    assert _eq(t, raycast._ray_fans_dense(org, zg, dirs, zgroups,
                                          town_map.tris))


# the largest |component| a row's edges are scaled to: 1e18 keeps every
# det of the row under the sweep's bound for the fast reciprocal (8
# max|e1| max|e2| max|d| < 2^126), the others fail it and take __frcp_rn;
# inf makes one component of e1 infinite
HUGE_EDGES = (1e18, 5e18, 1e20, 1e38, float("inf"))


def _huge_edge_soup(soup, every):
    """The soup with every ``every``-th valid row's edges scaled to the
    magnitudes of HUGE_EDGES in turn (v0 and the plane kept), in its
    per-field tensors and its [T, 16] rows; and how many rows fail the
    fast reciprocal's bound whatever the directions (unit: 8 max|d| >=
    8 / sqrt 3)."""
    import dataclasses

    rows = torch.nonzero(soup.valid).squeeze(-1)[::every].tolist()
    e1, e2 = soup.e1.clone(), soup.e2.clone()
    for k, i in enumerate(rows):
        target = HUGE_EDGES[k % len(HUGE_EDGES)]
        if target == float("inf"):
            e1[i, 0] = target
            continue
        for e in (e1, e2):
            m = e[i].abs().max().double()
            e[i] = (e[i].double() * (target / m)).float()
    tri_rows = soup.tri_rows.clone()
    tri_rows[:, raycast.ROW_E1:raycast.ROW_E1 + 3] = e1
    tri_rows[:, raycast.ROW_E2:raycast.ROW_E2 + 3] = e2
    bound = (e1.abs().amax(-1).double() * e2.abs().amax(-1).double()
             * 8 / 3 ** 0.5)
    n_exact = int((bound >= 2.0 ** 126).sum())
    assert n_exact >= 4 * len(rows) // len(HUGE_EDGES)
    return dataclasses.replace(soup, e1=e1, e2=e2, tri_rows=tri_rows)


def test_fan_kernels_huge_edges(gpu_map, town_map):
    """K2 and K6 with rows whose edges reach 1e18-1e38 or infinity: each
    row that fails the bound on its dets takes the exact reciprocal, and
    the result stays bit-equal to the plain version's (and differs from
    the unscaled soup's: the scaled rows are swept)."""
    org, zg, dirs, zgroups = _fans(gpu_map, 385, FAN_RUNS[0], 23)
    soup = _huge_edge_soup(gpu_map.tris, 7)
    t = raycast.ray_fans_vs_tris(org, zg, dirs, zgroups, soup)
    assert _eq(t, raycast._ray_fans_dense(org, zg, dirs, zgroups, soup))
    assert not _eq_values(t, raycast.ray_fans_vs_tris(org, zg, dirs,
                                                      zgroups, gpu_map.tris))

    org, zg, dirs, zgroups = _town_fans(town_map, 385, 24)
    soup = _huge_edge_soup(town_map.tris, 29)
    cells = cell_index(town_map.cells, org)
    t = raycast.ray_fans_culled(org, zg, dirs, zgroups, cells,
                                town_map.cells, soup)
    assert _eq(t, raycast._ray_fans_culled_plain(
        org, zg, dirs, zgroups, cells, town_map.cells, soup))
    assert not _eq_values(t, raycast.ray_fans_culled(
        org, zg, dirs, zgroups, cells, town_map.cells, town_map.tris))


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


@pytest.mark.parametrize("scene, runs", [
    ("simple_map", "ts6"), ("simple_map", "ts3"), ("simple_map", "per_ray"),
    ("town_map", "ts3")])
def test_flat_fan_kernel(gpu_map, town_map, scene, runs):
    """K7 over the whole soup, stacked directions of any scale: the
    sensor fan's runs at team sizes 6 (aligned) and 3 (a 12-ray LOS run),
    given per ray and per group, and a z offset per ray; on town_map the
    soup is swept in tiles."""
    m = gpu_map if scene == "simple_map" else town_map
    N = 384
    zgroups = ((4 * (6 if runs == "ts6" else 3),) + (32, 32, 8, 8))
    F = sum(zgroups)
    org = _points(m, N, 40, (0, 5))
    org[::16, 2] = 10000.0
    g = torch.Generator(device="cuda").manual_seed(41)
    zg = 10.0 + 50.0 * torch.rand((N, len(zgroups)), generator=g,
                                  device="cuda")
    zoff = torch.repeat_interleave(
        zg, torch.tensor(zgroups, device="cuda"), dim=-1)
    if runs == "per_ray":
        zoff = 10.0 + 50.0 * torch.rand((N, F), generator=g, device="cuda")
    d = _dirs(N * F, 42).reshape(N, F, 3) * (
        0.5 + torch.rand((N, F, 1), generator=g, device="cuda"))
    n0 = raycast.ray_fans_vs_tris_flat.launches
    t = raycast.ray_fans_vs_tris_flat(org, zoff, d, m.tris)
    assert raycast.ray_fans_vs_tris_flat.launches == n0 + 1
    assert _eq(t, raycast._ray_fans_flat_plain(org, zoff, d, m.tris))
    assert bool(torch.isfinite(t).float().mean() > 0.3)
    if runs != "per_ray":
        assert _eq(raycast.ray_fans_vs_tris_flat(org, zg, d, m.tris,
                                                 zgroups=zgroups), t)


def _flat_fans(m, N, zgroups, seed):
    """N fans of runs ``zgroups`` in the stacked layout (fans 15, 31, ...
    dead),
    directions of scale 0.5-1.5: origins, per-group and per-ray z
    offsets, directions [N, F, 3]."""
    org = _points(m, N, seed, (0, 5))
    org[15::16, 2] = 10000.0
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    zg = 10.0 + 50.0 * torch.rand((N, len(zgroups)), generator=g,
                                  device="cuda")
    zoff = torch.repeat_interleave(
        zg, torch.tensor(zgroups, device="cuda"), dim=-1)
    F = sum(zgroups)
    d = _dirs(N * F, seed + 2).reshape(N, F, 3) * (
        0.5 + torch.rand((N, F, 1), generator=g, device="cuda"))
    return org, zg, zoff, d


@pytest.mark.parametrize("N, zgroups", [
    (385, (1, 3, 5, 12)), (385, (7,)), (385, (10, 32, 32, 8, 8)),
    (1, (12, 32, 32, 8, 8))], ids=["straddle", "F7", "F90", "one_fan"])
def test_flat_fan_quads(gpu_map, town_map, N, zgroups):
    """K7's quads where they straddle runs (1, 3, 5, 12: origin terms per
    ray), where F is not a multiple of 4 (F = 7, 21, 90: a masked last
    quad) and at N = 1, on both maps: bit-equal to the plain version, to
    the predecessor (fan_flat_v1) and to the octet launch, one launch
    counted."""
    for m in (gpu_map, town_map):
        org, zg, zoff, d = _flat_fans(m, N, zgroups, 60)
        n0 = raycast.ray_fans_vs_tris_flat.launches
        t = raycast.ray_fans_vs_tris_flat(org, zoff, d, m.tris)
        assert raycast.ray_fans_vs_tris_flat.launches == n0 + 1
        assert _eq(t, raycast._ray_fans_flat_plain(org, zoff, d, m.tris))
        assert _eq(t, raycast.ray_fans_vs_tris_flat_v1(org, zoff, d, m.tris))
        assert _eq(t, raycast._fan_flat_launch(org, zoff, d, m.tris, rays=8))
        assert _eq(t, raycast.ray_fans_vs_tris_flat(org, zg, d, m.tris,
                                                    zgroups=zgroups))
    assert bool(torch.isfinite(t).any())


@pytest.mark.parametrize("R", [1, 13, 12289])
def test_ray_vs_tris_split_kernel(town_map, R):
    """K1 over town_map's 6,144 triangles at a partial ray tile (1, 13)
    and a partial cluster tile (12,289 = 48 tiles of 256 rays + 1):
    bit-equal to the plain version and to the predecessor (ray_tris_v1),
    at every split and ray count a launch may take, one launch
    counted."""
    o, d = _points(town_map, R, 50, (10, 60)), _dirs(R, 51)
    n0 = raycast.ray_vs_tris.launches
    t = raycast.ray_vs_tris(o, d, town_map.tris)
    assert raycast.ray_vs_tris.launches == n0 + 1
    assert _eq(t, raycast._ray_vs_tris_dense(o, d, town_map.tris))
    assert _eq(t, raycast.ray_vs_tris_v1(o, d, town_map.tris))
    for split in (1, 3, 8):
        for rays in (1, 2, 4):
            assert _eq(t, raycast._ray_tris_launch(o, d, town_map.tris,
                                                   split, rays))
    if R > 1000:
        assert bool(torch.isfinite(t).float().mean() > 0.2)


def test_ray_vs_tris_huge_edges(gpu_map, town_map):
    """K1 with rows whose edges reach 1e18-1e38 or infinity, and rays of
    huge directions: the rows and rays past the fast reciprocal's bound
    take the exact one, bit-equal to the plain version and the
    predecessor (and apart from the unscaled soup's result)."""
    for m, every in ((gpu_map, 7), (town_map, 29)):
        R = 4096
        o, d = _points(m, R, 52, (10, 60)), _dirs(R, 53)
        d[::5] *= 1e30
        soup = _huge_edge_soup(m.tris, every)
        t = raycast.ray_vs_tris(o, d, soup)
        assert _eq(t, raycast._ray_vs_tris_dense(o, d, soup))
        assert _eq(t, raycast.ray_vs_tris_v1(o, d, soup))
        assert not _eq_values(t, raycast.ray_vs_tris(o, d, m.tris))


@pytest.mark.parametrize("scene", ["simple_map", "town_map"])
def test_sphere_cast_normal_kernel(gpu_map, town_map, scene):
    """K8: t and the winner's contact normal over the whole soup, on the
    L1 batch's casts (overlaps, face and edge hits, standing agents'
    directionless casts) and random casts; a finite t_max; no normals.
    Bit-equal to the plain version and to the predecessor
    (sphere_cast_vs_tris_v1), and at S = 1 and 8 blocks a cluster."""
    m = gpu_map if scene == "simple_map" else town_map
    N = 512
    x = _points(m, N, 43, (0, 2))
    v = _dirs(N, 44, flat=True)
    v[::8] = 0.0
    o1, d1, _ = movement.l1_casts(x, v, torch.full((N,), 50.0, device="cuda"),
                                  torch.full((N,), 30.0, device="cuda"))
    o2 = _points(m, N * 7, 45, (15, 50)).reshape(N, 7, 3)
    d2 = _dirs(N * 7, 46).reshape(N, 7, 3)
    for o, d in ((o1, d1), (o2, d2)):
        for t_max, with_normal in ((float("inf"), True), (20.0, True),
                                   (float("inf"), False)):
            n0 = raycast.sphere_cast_vs_tris.launches
            tk, nk = raycast.sphere_cast_vs_tris(o, d, R, m.tris, t_max,
                                                 with_normal)
            assert raycast.sphere_cast_vs_tris.launches == n0 + 1
            tp, np_ = raycast._sphere_cast_normal_plain(o, d, R, m.tris,
                                                        t_max, with_normal)
            assert _eq(tk, tp) and _eq(nk, np_)
            assert bool(torch.isfinite(tk).float().mean() > 0.2)
            tb, nb = raycast.sphere_cast_vs_tris_v1(o, d, R, m.tris, t_max,
                                                    with_normal)
            assert _eq(tk, tb) and _eq(nk, nb)
            for split in (1, 8):
                t, n = raycast._sc_dense_launch(o, d, R, m.tris, t_max,
                                                with_normal, split)
                assert _eq(t, tk) and _eq(n, nk)


def _rows_of(soup, idx):
    """The soup's rows ``idx`` (in that order) as a soup of their own."""
    return raycast.TriSoup(
        v0=soup.v0[idx], e1=soup.e1[idx], e2=soup.e2[idx],
        normal=soup.normal[idx], valid=soup.valid[idx],
        tri_rows=soup.tri_rows[idx].contiguous())


def _dense_soup(gpu_map, town_map, kind):
    """A soup for the dense entries' row split: simple_map's; its first
    20 rows (under one staged tile); town_map's first 6,107 rows (a prime
    count times 31: no split divides it); simple_map's rows twice over
    (each triangle at rows i and i + 256, in different blocks of a
    cluster of 2 or more)."""
    s, t = gpu_map.tris, town_map.tris
    ar = torch.arange
    return {"simple": s, "stage": _rows_of(s, ar(20, device="cuda")),
            "odd": _rows_of(t, ar(6107, device="cuda")),
            "twice": _rows_of(s, ar(512, device="cuda") % 256)}[kind]


def _dense_casts(m, soup, N, seed):
    """N casts around map m: from random points along random directions,
    every 5th straight down from 100 above a valid row's centroid of
    ``soup`` (a hit), every 11th straight down, every 7th directionless
    (every row ties at t = +-0: the lowest row wins), every 9th upward
    from 5000 above the map (a miss everywhere)."""
    o = _points(m, N, seed, (0, 60))
    d = _dirs(N, seed + 1)
    up = torch.tensor([0.0, 0.0, 1.0], device="cuda")
    rows = torch.nonzero(soup.valid)[:, 0]
    aim = rows[torch.arange(0, N, 5, device="cuda") % rows.numel()]
    o[::5] = (soup.v0[aim] + (soup.v0[aim] + soup.e1[aim])
              + (soup.v0[aim] + soup.e2[aim])) / 3.0 + 100.0 * up
    d[::5] = -up
    d[::11] = -up
    d[::7] = 0.0
    o[::9, 2] += 5000.0
    d[::9] = up
    return o, d


@pytest.mark.parametrize("kind", ["simple", "stage", "odd", "twice"])
def test_sphere_cast_dense_split(gpu_map, town_map, kind):
    """K4 dense (csrc/sphere_cast.cu sc_dense_kernel) at R = 2,049 casts,
    not a multiple of a block's 64 casts: t and winner row bit-equal to
    the plain version and to the predecessor (sphere_cast_v1) at every
    split a launch may take (1 .. 8 blocks a cluster), on soups under one
    staged tile, of a row count no split divides, and with every triangle
    twice (equal t in different blocks: the lower row wins); misses
    report row 0; one launch counted."""
    soup = _dense_soup(gpu_map, town_map, kind)
    o, d = _dense_casts(gpu_map if kind != "odd" else town_map, soup, 2049,
                        70)
    n0 = raycast.sphere_cast.launches
    tk, ik = raycast.sphere_cast(o, d, R, soup)
    assert raycast.sphere_cast.launches == n0 + 1
    tp, ip = raycast._sphere_cast_dense(o, d, R, soup)
    assert _eq(tk, tp) and _eq(ik, ip)
    tb, ib = raycast.sphere_cast_v1(o, d, R, soup)
    assert _eq(tk, tb) and _eq(ik, ib)
    for split in range(1, raycast.SC_MAX_SPLIT + 1):
        t, i = raycast._sc_dense_launch(o, d, R, soup, split=split)
        assert _eq(t, tk) and _eq(i, ik), split
    hit = torch.isfinite(tk)
    assert bool((ik[~hit] == 0).all()) and bool((~hit[::9]).all())
    assert bool(hit.float().mean() > 0.1)
    if kind == "twice":
        assert bool((ik < 256).all())
    for bad in (0, raycast.SC_MAX_SPLIT + 1):
        with pytest.raises(RuntimeError):
            raycast._sc_dense_launch(o, d, R, soup, split=bad)


def test_fan_capsules_explicit_kernel(gpu_map):
    """K3x: explicit origins around the agents, each ray skipping a
    capsule of its own choosing (mostly its caster's); dead agents."""
    W, A, F = 64, 6, 92
    pos = (_points(gpu_map, W * A, 47, (0, 1)) * 0.05).reshape(W, A, 3)
    g = torch.Generator(device="cuda").manual_seed(48)
    alive = torch.rand((W, A), generator=g, device="cuda") > 0.2
    o = (pos[:, :, None, :] + 30.0 * torch.randn(
        (W, A, F, 3), generator=g, device="cuda")
        + torch.tensor([0.0, 0.0, 40.0], device="cuda"))
    d = _dirs(W * A * F, 49).reshape(W, A, F, 3)
    own = torch.arange(A, device="cuda")[None, :, None].expand(W, A, F)
    other = torch.randint(0, A, (W, A, F), generator=g, device="cuda")
    self_idx = torch.where(torch.rand((W, A, F), generator=g, device="cuda")
                           < 0.7, own, other).to(torch.int32)
    n0 = raycast_cull.fan_capsules_explicit.launches
    tk, ik = raycast_cull.fan_capsules_explicit(o, d, self_idx, pos, alive)
    assert raycast_cull.fan_capsules_explicit.launches == n0 + 1
    tp, ip = raycast_cull._fan_capsules_explicit_plain(o, d, self_idx, pos,
                                                       alive)
    assert _eq(tk, tp) and _eq(ik, ip)
    assert bool((ik >= 0).float().mean() > 0.05)


def _bits(x):
    """int32 view of a float32 tensor: equality then tells -0 from +0."""
    torch.cuda.synchronize()
    return x.view(torch.int32) if x.dtype == torch.float32 else x


@pytest.mark.parametrize("A", [2, 6, 12, 32])
def test_fan_capsules_kernel(gpu_map, A):
    """K3 on the sensor runs, clustered agents, every fifth dead: t and
    capsule index bit-equal (int32 views) to the plain version and to the
    predecessor fan_capsules_v1 on per-ray offsets."""
    W, zgroups = 64, (24, 32, 32, 8, 8)
    F = sum(zgroups)
    pos = (_points(gpu_map, W * A, 5, (0, 1)) * 0.05).reshape(W, A, 3)
    g = torch.Generator(device="cuda").manual_seed(6)
    alive = (torch.rand((W, A), generator=g, device="cuda") > 0.2).float()
    zg = 10.0 + 50.0 * torch.rand((W, A, len(zgroups)), generator=g,
                                  device="cuda")
    d = _dirs(W * A * F, 7, flat=True).reshape(W, A, F, 3)
    dirs = tuple(d[..., k].contiguous() for k in range(3))
    n0 = raycast_cull.fan_capsules.launches
    tk, ik = raycast_cull.fan_capsules(pos, zg, dirs, zgroups, alive)
    assert raycast_cull.fan_capsules.launches == n0 + 1
    tp, ip = raycast_cull._fan_capsules_plain(pos, zg, dirs, zgroups, alive)
    assert _eq(tk, tp) and _eq(ik, ip)
    zoff = torch.repeat_interleave(zg, torch.tensor(zgroups, device="cuda"),
                                   dim=-1)
    tb, ib = raycast_cull.fan_capsules_v1(pos, zoff, dirs, alive > 0.0)
    assert _eq(tk, tb) and _eq(ik, ib)
    assert bool((ik >= 0).float().mean() > 0.02)


def test_sphere_cast_kernels(gpu_map):
    """K4 dense and K4 culled on the L1 batch's casts: t and winner row
    bit-equal to their plain versions, K4 dense also to its predecessor
    (sphere_cast_v1), one launch counted."""
    N = 2048
    x = _points(gpu_map, N, 8, (0, 2))
    v = _dirs(N, 9, flat=True)
    top = torch.full((N,), 50.0, device="cuda")
    low = torch.full((N,), 30.0, device="cuda")
    o1, d1, _ = movement.l1_casts(x, v, top, low)
    n0 = raycast.sphere_cast.launches
    tk, ik = raycast.sphere_cast(o1, d1, R, gpu_map.tris)
    assert raycast.sphere_cast.launches == n0 + 1
    tp, ip = raycast._sphere_cast_dense(o1, d1, R, gpu_map.tris)
    assert _eq(tk, tp) and _eq(ik, ip)
    tb, ib = raycast.sphere_cast_v1(o1, d1, R, gpu_map.tris)
    assert _eq(tk, tb) and _eq(ik, ib)
    cells = short_cell_index(gpu_map.short, x)
    tk, ik = raycast.sphere_cast_culled(o1, d1, R, cells, gpu_map.short,
                                        gpu_map.tris)
    tp, ip = raycast._sphere_cast_culled_plain(o1, d1, R, cells,
                                               gpu_map.short, gpu_map.tris)
    assert _eq(tk, tp) and _eq(ik, ip)


# the step's culled batches (cpa casts a group, the table): the L1 batch,
# the L2 pair and the L3 snap / fall cast, and 4 casts a group
SC_BATCHES = {"l1": (7, "short"), "pair": (2, "short_mv"),
              "snap": (1, "short_mv"), "four": (4, "short")}


def _sc_batch(m, N, cpa, seed):
    """N groups of cpa casts around the map: the L1 batch's casts (cpa 7,
    every 8th agent standing: directionless casts; every 9th 5000 above
    the map, whose forward casts miss), else casts from random points
    along random directions (every 7th group directionless, every 9th
    cast upward from 5000 above the map: all miss)."""
    x = _points(m, N, seed, (0, 2))
    if cpa == 7:
        x[::9, 2] += 5000.0
        v = _dirs(N, seed + 1, flat=True)
        v[::8] = 0.0
        o, d, _ = movement.l1_casts(x, v, torch.full((N,), 50.0,
                                                     device="cuda"),
                                    torch.full((N,), 30.0, device="cuda"))
        return x, o, d
    o = x[:, None, :] + 20.0 * torch.as_tensor(np.random.default_rng(
        seed + 2).normal(size=(N, cpa, 3)).astype(np.float32), device="cuda")
    d = _dirs(N * cpa, seed + 3).reshape(N, cpa, 3)
    d[::7] = 0.0
    o[::9, :, 2] += 5000.0
    d[::9] = torch.tensor([0.0, 0.0, 1.0], device="cuda")
    return x, o, d


@pytest.mark.parametrize("batch", list(SC_BATCHES))
@pytest.mark.parametrize("scene", ["simple_map", "town_map"])
def test_sphere_cast_culled_kernel(gpu_map, town_map, scene, batch):
    """K4 culled / K4' at N = 1021 groups (not a multiple of the 4 groups
    per block): t and winner row bit-equal to the plain version and to
    the predecessor (sphere_cast_culled_v1), and with every cell walked to
    K, and on a table with a -1 between its candidates and an empty cell;
    one launch counted per entry."""
    m = gpu_map if scene == "simple_map" else town_map
    cpa, table = SC_BATCHES[batch]
    short = getattr(m, table)
    N = 1021
    x, o, d = _sc_batch(m, N, cpa, 60 + cpa)
    cells = short_cell_index(short, x)
    entry = (raycast.sphere_cast_culled if table == "short"
             else raycast.sphere_cast_packed)
    n0 = entry.launches
    tk, ik = entry(o, d, R, cells, short, m.tris)
    assert entry.launches == n0 + 1
    tp, ip = raycast._sphere_cast_culled_plain(o, d, R, cells, short, m.tris)
    # against the plain version as values: the directionless casts' t may
    # differ in the sign of 0 (torch.minimum and the kernel's min2 may
    # keep different zeros of a tie); against the kernels bit for bit
    assert _eq_values(tk, tp) and _eq(ik, ip)
    tb, ib = raycast.sphere_cast_culled_v1(o, d, R, cells, short, m.tris)
    assert _eq(tk, tb) and _eq(ik, ib)
    full = torch.full_like(short.valid_span, short.K)
    t, i = raycast._sc_culled_launch(o, d, R, cells, short, m.tris,
                                     span=full)
    assert _eq(t, tk) and _eq(i, ik)
    hit = torch.isfinite(tk)
    assert bool(hit.float().mean() > 0.2) and bool((~hit).any())
    assert bool((ik[~hit] == 0).all())
    # a table that is not compacted: a -1 after every candidate, cell 0
    # emptied
    gappy = short.cand.reshape(-1, short.K).repeat_interleave(2, dim=1)
    gappy[:, 1::2] = -1
    gappy[0] = -1
    gappy = ShortTables(cand=gappy.reshape(-1).contiguous(),
                        grid_min=short.grid_min, cell_size=short.cell_size,
                        nx=short.nx, ny=short.ny, K=2 * short.K)
    tg, ig = entry(o, d, R, cells, gappy, m.tris)
    tp, ip = raycast._sphere_cast_culled_plain(o, d, R, cells, gappy, m.tris)
    assert _eq_values(tg, tp) and _eq(ig, ip)


def test_sphere_cast_culled_shapes_it_cannot_take(gpu_map):
    """More casts a group than SC_MAX_CASTS raise through
    cuda_build.check; nothing falls back."""
    short = gpu_map.short
    N = 64
    x = _points(gpu_map, N, 70, (0, 2))
    cells = short_cell_index(short, x)
    d9 = _dirs(N * 9, 71).reshape(N, 9, 3)
    o9 = x[:, None, :].expand(N, 9, 3).contiguous()
    with pytest.raises(RuntimeError):
        raycast.sphere_cast_culled(o9, d9, R, cells, short, gpu_map.tris)
    o, d = o9[:, :2], d9[:, :2]
    with pytest.raises(ValueError):
        raycast.sphere_cast_culled(o, d, R, cells[:-1], short, gpu_map.tris)


def test_sphere_cast_culled_registers(gpu_map):
    """sc_culled_kernel and the predecessor compile without spills (ptxas
    -v, saved beside the library)."""
    from madrona_mp_env_tpu_torch.ops import cuda_build

    cuda_build.launcher("sphere_cast_culled")  # built on first use
    regs, spill = cuda_build.ptxas_usage("sphere_cast", "sc_culled_kernel")
    assert spill == 0 and 0 < regs <= 255
    assert cuda_build.ptxas_usage("sphere_cast",
                                  "sphere_cast_culled_v1_kernel")[1] == 0


@pytest.mark.parametrize("team_size", [1, 2, 3, 6, 16])
def test_tail_fused_kernel(simple_map_dir, gpu_map, team_size):
    """K5 against its plain version and its predecessor (tail_fused_v1)
    on the card: every output leaf bit-equal (int32 views of the floats)
    on states that rotate, contest, take and capture zones and finish
    matches (fixtures_torch/tail_states.py), force_reset int32 and bool;
    team size 16 fills the warp."""
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
                       m.world_max.cpu().numpy(), cfg.episode_len, seed=1)
    st = world_state_from_numpy(leaves, device="cuda")
    for fr_dev in (torch.as_tensor(fr, device="cuda"),
                   torch.as_tensor(fr != 0, device="cuda")):
        n0 = tf.tail_fused.launches
        sk, ck = tf.tail_fused(cfg, m, st, fr_dev)
        assert tf.tail_fused.launches == n0 + 1
        sp, cp = tf.tail_fused_plain(cfg, m, st, fr_dev)
        sb, cb = tf.tail_fused_v1(cfg, m, st, fr_dev)
        assert _eq(ck, cp) and _eq(ck, cb)
        for k, v in sp.leaves().items():
            got = getattr(sk, k)
            assert _eq(got, v), k
            assert _eq(got, getattr(sb, k)), k


@pytest.mark.parametrize("team_size", [2, 6, 16])
@pytest.mark.parametrize("curriculum", [True, False])
def test_tail_fused_learn_shooting_kernel(simple_map_dir, gpu_map, team_size,
                                          curriculum):
    """K5 with LearnShooting and FullMatch worlds mixed, under
    SimFlags.EnableCurriculum (the kernel's LearnShooting instantiation)
    and without it (the step's, which ignores world_curriculum): every
    output leaf bit-equal (int32 views) to its plain version; the
    predecessor refuses the flag."""
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

    flags = mt.SimFlags.EnableCurriculum if curriculum else (
        mt.SimFlags.Default)
    cfg = mt.EnvConfig(task=mt.Task.Zone, team_size=team_size,
                       sim_flags=flags)
    m = load_map(simple_map_dir, cfg, device="cuda")
    leaves = world_state_to_numpy(init_world_state(cfg, m.num_goal_regions,
                                                   NUM_WORLDS))
    fr = tail_scenario(leaves, team_size, m.zone_frames.cpu().numpy(),
                       m.num_zones, m.world_min.cpu().numpy(),
                       m.world_max.cpu().numpy(), cfg.episode_len, seed=2)
    leaves["world_curriculum"] = np.array([0, 1, 0, 1], np.int32)
    st = world_state_from_numpy(leaves, device="cuda")
    fr_dev = torch.as_tensor(fr, device="cuda")
    n0 = tf.tail_fused.launches
    sk, ck = tf.tail_fused(cfg, m, st, fr_dev)
    assert tf.tail_fused.launches == n0 + 1
    sp, cp = tf.tail_fused_plain(cfg, m, st, fr_dev)
    assert _eq(ck, cp)
    for k, v in sp.leaves().items():
        assert _eq(getattr(sk, k), v), k
    if curriculum:
        with pytest.raises(ValueError, match="LearnShooting"):
            tf.tail_fused_v1(cfg, m, st, fr_dev)


@pytest.mark.parametrize("team_size", [2, 3, 6])
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


@pytest.mark.parametrize("scene,source", [("simple_map", "syn"),
                                          ("town_map", "syn"),
                                          ("simple_map", "plan")])
def test_bot_planner_on_card_equals_cpu(simple_map_dir, gpu_map, scene,
                                        source):
    """The scripted bot's planner (plain PyTorch on every device) on the
    card against the CPU planner on the states of
    fixtures_torch/zone_simple_map_bots.npz (make_bot_fixture.py: drawn
    inputs on each map, the 16 pre-step states of the Zone 2v2 rollout
    with team 1 as bots): integer actions exact, rates bit-equal."""
    import os
    from types import SimpleNamespace

    from madrona_mp_env_tpu_torch.assets.map_data import load_map
    from madrona_mp_env_tpu_torch.sim import bot
    from madrona_mp_env_tpu_torch.utils import rng

    here = os.path.dirname(os.path.abspath(__file__))
    with np.load(os.path.join(here, "fixtures_torch",
                              "zone_simple_map_bots.npz")) as z:
        pre = f"syn/{scene}/" if source == "syn" else "plan/"
        leaves = {k[len(pre):]: z[k] for k in z.files if k.startswith(pre)
                  and "/" not in k[len(pre):] and "margin" not in k}
    if source == "syn":
        leaves = {k: v[None] for k, v in leaves.items()}
    path = os.path.join(os.path.dirname(simple_map_dir), scene)
    maps = {dev: load_map(path, mt.EnvConfig(team_size=6), device=dev)
            for dev in ("cuda", "cpu")}
    for t in range(next(iter(leaves.values())).shape[0]):
        outs = []
        for dev, m in maps.items():
            s = SimpleNamespace(**{
                k: torch.as_tensor(v[t].astype(np.int64)
                                   if v.dtype == np.uint32 else v[t],
                                   device=dev) for k, v in leaves.items()})
            key = s.key if source == "syn" else rng.system_key(
                rng.step_key(s.episode_key, s.cur_step), rng.Salt.BOT)
            outs.append(bot.plan_bot_actions(None, m, s, key))
        for k, v in outs[0].leaves().items():
            assert _eq(v.cpu(), getattr(outs[1], k)), (t, k)


@pytest.mark.parametrize("route", ["culled", "dense"])
@pytest.mark.parametrize("scene", ["simple_map", "town_map"])
def test_move_fused_kernel(simple_map_dir, gpu_map, scene, route):
    """P3: the fused movement against its plain version (the split pair
    with the plain sweeps) and against the split pair on the kernels, on
    the state a real step hands the movement pair (16 worlds after 3
    steps of bench.py's actions)."""
    import os

    from madrona_mp_env_tpu_torch.tools.probes import movement_fused_probe as mf

    cfg = mt.EnvConfig(
        task=mt.Task.Zone, team_size=6,
        sim_flags=mt.SimFlags.StaggerStarts | mt.SimFlags.RandomFlipTeams)
    env, st = mf.bench_state(cfg, os.path.join(
        os.path.dirname(simple_map_dir), scene), 16, 3, "cuda")
    m = env.map_data
    n0 = mf.apply_velocity_fall_fused.launches
    got = mf.apply_velocity_fall_fused(cfg, m, st, route)
    assert mf.apply_velocity_fall_fused.launches == n0 + 1
    for want in (mf._apply_velocity_fall_fused_plain(cfg, m, st, route),
                 mf.split_pair(cfg, m, st, route)):
        assert _eq(got.pos, want.pos) and _eq(got.vel, want.vel)
    assert bool((got.pos != st.pos).any())


def test_fan_v9_probe_kernels(gpu_map):
    """P5's pre-gathered entry and P6's chunked order: K9's plain t."""
    from madrona_mp_env_tpu_torch.tools.probes import (
        v9_kernel_probe, v9_scan_timing,
    )

    x = v9_kernel_probe.make_fans(gpu_map, 2048, 0, "cuda")
    rt, soup = gpu_map.ray_cells, gpu_map.tris
    args = (x["origins"], x["zoff"], x["dirs"], x["cells"])
    want = raycast._ray_fans_v9_plain(*args, rt, soup)
    table = v9_kernel_probe.gather_tables(rt, soup)
    assert _eq(v9_kernel_probe.ray_fans_v9_gathered(*args, table), want)
    assert _eq(v9_scan_timing.ray_fans_v9_chunked(*args, rt, soup), want)


@pytest.mark.parametrize("variant", ["exact", "rcp_ieee", "rcp_approx",
                                     "dots_only", "epilogue", "chunked"])
def test_fan_probe_kernel(gpu_map, variant):
    """P2's variants against their plain versions; rcp_approx within 1e-4
    relative of the exact t on all but a few rays."""
    from madrona_mp_env_tpu_torch.tools import fan_probe
    from madrona_mp_env_tpu_torch.tools.probes import v9_kernel_probe

    x = v9_kernel_probe.make_fans(gpu_map, 1024, 0, "cuda")
    aux = fan_probe.make_aux(gpu_map.tris.num_tris, 0, "cuda")
    args = (x["origins"], x["zg"], x["dirs"], x["zgroups"], gpu_map.tris)
    got = fan_probe.ENTRIES[variant](*args, aux=aux)
    want = fan_probe._fan_probe_plain(variant, *args, aux=aux)
    if variant == "rcp_approx":
        assert fan_probe.approx_error(got, want)[1] < 1e-3
    else:
        assert _eq(got, want)


def test_sc_mxu_kernel(gpu_map):
    """P4: the 3xTF32 tensor-core sphere cast against its plain version
    within its bars (largest |t difference| where both hit, share of
    casts whose hit or miss differs), on the TPU probe's first 4,096
    casts."""
    from madrona_mp_env_tpu_torch.tools.probes import sc_mxu_probe as p4

    o, d = p4.make_casts(p4.CASTS, 0, "cuda")
    planes = p4.planes_of(o[:4096], d[:4096])
    tables = p4.probe_tables(gpu_map, "cuda")
    n0 = p4.sphere_cast_mxu.launches
    got = p4.sphere_cast_mxu(planes, *tables)
    assert p4.sphere_cast_mxu.launches == n0 + 1
    want = p4._sc_mxu_plain(planes, *tables)
    torch.cuda.synchronize()
    err, flips = p4.mxu_error(got, want)
    assert err <= p4.MAX_DT and flips <= p4.MAX_FLIP
    assert bool(torch.isfinite(got).any())


@pytest.mark.parametrize("chain", ["fma_full_tile", "mul_full_tile",
                                   "fma_lane_bcast", "fma_sublane_bcast",
                                   "recip_approx_add", "div_exact_add",
                                   "cmp_sel_add", "fan_epilogue"])
def test_vpu_chain_kernel(gpu_map, chain):
    """P1's chains against their plain versions on the TPU probe's 256 x
    256 tile at full depth (the same non-finite elements) and at
    vpu_probe.SHORT links (every element finite): mul, divide and select
    bit-equal, the others within their bars."""
    from madrona_mp_env_tpu_torch.tools import vpu_probe as vp

    a, b = vp.chain_inputs(np.random.RandomState(1), device="cuda")
    loop = vp.chain_loop(chain)
    fn = vp.ENTRIES[chain]
    n0 = fn.launches
    got = fn(a, b, loop)
    assert fn.launches == n0 + 1
    vp.check_chain(chain, got, vp._chain_plain(chain, a, b, loop),
                   vp.BARS.get(chain, 0.0))
    vp.check_short(chain, a, b)


@pytest.mark.parametrize("K", [8, 128])
def test_vpu_mma_kernel(gpu_map, K):
    """P1's bf16 mma.sync chain against its plain version (f32 products of
    the bf16 values) within its bar, at the TPU probe's shapes."""
    from madrona_mp_env_tpu_torch.tools import vpu_probe as vp

    (_, M, N), = [s for s in vp.MM_SHAPES if s[0] == K]
    a, b = vp.mm_inputs(np.random.RandomState(2), K, M, N, device="cuda")
    got = vp.MM_ENTRIES[K](a, b, vp.MM_DEPTH)
    want = vp._mm_plain(a, b, vp.MM_DEPTH)
    vp.check_chain(f"matmul K={K}", got, want, vp.MM_BAR, finite=True)
    assert torch.allclose(want, a.float() @ b.float(), rtol=1e-5)
