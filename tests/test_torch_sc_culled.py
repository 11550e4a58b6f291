"""The culled sphere-cast sweep of K4 culled and K4' (csrc/sphere_cast.cu
sc_culled_kernel on csrc/sc_sweep.cuh), on the CPU: what of it Python can
reach.

- The schedule (the kernel's thread -> group, lane -> pairs arithmetic,
  written out in numpy): every (cast, candidate) pair swept exactly once
  and every cast written once, for every cast count a group may hold,
  group counts that are not multiples of the groups per block, a cell
  with no candidate and a -1 inside a cell.
- The lanes' partial minima and the xor-shuffle combine, modelled in
  torch: equal bit for bit to ``_sphere_cast_culled_plain`` on the L1 and
  K4' casts of real CPU steps on both maps, with directionless casts
  (every candidate ties near t = 0, the lowest row wins) and groups whose
  casts all miss (row 0), on the shipped tables and on one that is not
  compacted.
- ``ShortTables.valid_span`` on the four shipped tables and on a table
  with gaps.
- The pair arithmetic (tri_math.cuh sc_pair, which every pair of the
  sweep runs on the row it reads), emulated per f32 operation in numpy
  with a group's casts against the same rows: equal to ``_sc_pairs``'s
  t_tri bit for bit on random and adversarial pairs.
- The dense entries' split of the rows over a cluster (K4 dense, K8:
  ``raycast.sc_split``): the blocks' row chunks cover every row once.
"""

import os
import sys
from unittest import mock

import numpy as np
import pytest
import torch

import madrona_mp_env_tpu_torch as mt
from madrona_mp_env_tpu_torch import consts
from madrona_mp_env_tpu_torch.assets.map_data import load_map
from madrona_mp_env_tpu_torch.ops import raycast
from madrona_mp_env_tpu_torch.ops.culling import ShortTables
from madrona_mp_env_tpu_torch.sim import movement
from madrona_mp_env_tpu_torch.tools.probes.movement_fused_probe import (
    bench_actions,
)

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(os.path.dirname(HERE), "data")
sys.path.insert(0, os.path.join(HERE, "fixtures_torch"))
from torch_threads import one_thread_under_xdist  # noqa: E402,F401

INT_MAX = 2 ** 31 - 1
R = consts.agent_radius


def _table(cand: np.ndarray) -> ShortTables:
    C, K = cand.shape
    return ShortTables(cand=torch.as_tensor(cand.reshape(-1), dtype=torch.int32),
                       grid_min=np.zeros(2), cell_size=1.0, nx=C, ny=1, K=K)


def _gappy(short: ShortTables, seed: int) -> ShortTables:
    """``short`` with its candidates spread over each cell's K slots (a -1
    between them) and cell 0 emptied: a table that is not compacted."""
    g = np.random.default_rng(seed)
    cand = short.cand.reshape(-1, short.K).numpy()
    out = np.full_like(cand, -1)
    for c in range(1, cand.shape[0]):
        rows = cand[c][cand[c] >= 0]
        slots = np.sort(g.choice(short.K, rows.size, replace=False))
        out[c, slots] = rows
    return _table(out)


# ---------------------------------------------------------------------------
# (a) the schedule
# ---------------------------------------------------------------------------

def _schedule(N, cpa, span):
    """sc_culled_kernel's thread arithmetic: ceil(N / (SC_THREADS / L))
    blocks of SC_THREADS threads, L = SC_LANES; thread t of block b is
    lane t % L of group g = b (SC_THREADS / L) + t // L. The lane takes
    the pairs p = lane, lane + L, ... < span[g] cpa, slot p // cpa against
    cast p % cpa. After the combine, lane j < cpa writes cast g cpa + j.
    span [N]: the span of each group's cell. -> (swept (cast, slot) pairs
    [P, 2] in each lane's order, written casts [W], idle threads)"""
    threads, lanes = raycast.SC_THREADS, raycast.SC_LANES
    per_block = threads // lanes
    blocks = -(-N // per_block)
    i = np.arange(blocks * threads)
    b, t = i // threads, i % threads
    g = b * per_block + t // lanes
    lane = t % lanes
    live = g < N
    g, lane = g[live], lane[live]
    items = span * cpa
    steps = -(-int(items.max(initial=0)) // lanes)
    p = lane[:, None] + lanes * np.arange(steps)[None, :]
    gp = np.broadcast_to(g[:, None], p.shape)
    ok = p < items[gp]
    gp, p = gp[ok], p[ok]
    written = (g * cpa + lane)[lane < cpa]
    return (np.stack([gp * cpa + p % cpa, p // cpa], -1), written,
            int((~live).sum()))


@pytest.mark.parametrize("N", [1, 3, 4, 5, 13, 385])
@pytest.mark.parametrize("cpa", list(range(1, raycast.SC_MAX_CASTS + 1)))
def test_schedule_covers_every_pair_once(cpa, N):
    assert cpa <= raycast.SC_MAX_CASTS <= raycast.SC_LANES == 32
    g = np.random.default_rng(10 * cpa + N)
    C, K = 9, 40
    cand = np.full((C, K), -1, np.int32)
    for c in range(1, C):  # cell 0 has no candidate
        n = int(g.integers(1, K + 1))
        slots = np.sort(g.choice(K, n, replace=False))  # -1 inside
        cand[c, slots] = g.choice(500, n, replace=False)
    table = _table(cand)
    cells = g.integers(0, C, N)
    cells[0] = 0
    span = table.valid_span.numpy()[cells]
    pairs, written, idle = _schedule(N, cpa, span)
    per_block = raycast.SC_THREADS // raycast.SC_LANES
    assert idle == (-N) % per_block * raycast.SC_LANES < raycast.SC_THREADS
    # every cast written once
    assert np.array_equal(np.sort(written), np.arange(N * cpa))
    # the swept pairs with a candidate: each (cast, valid slot) once
    keep = cand[cells[pairs[:, 0] // cpa], pairs[:, 1]] >= 0
    got = pairs[keep]
    cast, slot = np.nonzero(np.repeat(cand[cells] >= 0, cpa, axis=0))
    want = np.stack([cast, slot], -1)
    assert len(got) == len(want) == len(np.unique(got, axis=0))
    assert np.array_equal(np.unique(got, axis=0), np.unique(want, axis=0))
    # no slot past the span, none of an empty cell
    assert (pairs[:, 1] < span[pairs[:, 0] // cpa]).all()
    assert not (cells[pairs[:, 0] // cpa] == 0).any()


# ---------------------------------------------------------------------------
# (b) the lanes' partial minima and the xor-shuffle combine
# ---------------------------------------------------------------------------

def _lanes_model(o, d, r, cells, short, soup):
    """sc_culled_kernel per group, in torch: lane l of the group's L =
    SC_LANES takes its pairs p = l, l + L, ... < CPA valid_span in order,
    slot p // CPA against cast p % CPA, keeping each cast's (t, row) by
    sc_take (t < best, or t == best and row < best_row), from (inf,
    INT_MAX); then the lanes combine by xor partners L / 2, ..., 1 under
    the same rule, and a miss reports row 0. -> (t, row) [N, CPA], after
    checking that every lane ends with its group's result."""
    N, CPA = o.shape[:2]
    K, lanes = short.K, raycast.SC_LANES
    cand = short.cand.reshape(-1, K)[cells.long()]  # [N, K]
    span = short.valid_span[cells.long()]
    rows = torch.where(cand >= 0, cand, 0).long()
    t_k = raycast._sc_pairs(
        o[:, :, None, :], d[:, :, None, :], r, soup.v0[rows][:, None],
        soup.e1[rows][:, None], soup.e2[rows][:, None],
        soup.normal[rows][:, None], soup.valid[rows][:, None])["t_tri"]
    best = torch.full((N, CPA, lanes), float("inf"))
    best_row = torch.full((N, CPA, lanes), INT_MAX, dtype=torch.int32)
    lane = torch.arange(lanes)
    for m in range(-(-K * CPA // lanes)):
        item = m * lanes + lane  # [L]
        k = torch.clamp(item // CPA, max=K - 1)
        j = item % CPA
        t = t_k[:, j, k]  # [N, L]
        row = cand[:, k]
        ok = (row >= 0) & (item // CPA < span[:, None])
        b, br = best[:, j, lane], best_row[:, j, lane]
        ok &= (t < b) | ((t == b) & (row < br))
        best[:, j, lane] = torch.where(ok, t, b)
        best_row[:, j, lane] = torch.where(ok, row, br)
    off = lanes // 2
    while off:
        t2, r2 = best[..., lane ^ off], best_row[..., lane ^ off]
        ok = (t2 < best) | ((t2 == best) & (r2 < best_row))
        best, best_row = torch.where(ok, t2, best), torch.where(ok, r2,
                                                                 best_row)
        off //= 2
    assert torch.equal(best, best[..., :1].expand_as(best))
    assert torch.equal(best_row, best_row[..., :1].expand_as(best_row))
    t = best[..., 0]
    return t, torch.where(torch.isinf(t), 0, best_row[..., 0])


@pytest.fixture(scope="module", params=["simple_map", "town_map"])
def step_casts(request):
    """The map, the L1 batch and K4''s three launches of the third CPU
    step at 4 worlds (bench.py's run-and-shoot actions)."""
    cfg = mt.EnvConfig(task=mt.Task.Zone, team_size=6,
                       sim_flags=mt.SimFlags.StaggerStarts
                       | mt.SimFlags.RandomFlipTeams)
    env = mt.Env(cfg, os.path.join(DATA, request.param), num_worlds=4,
                 seed=5, device="cpu")
    state, _ = env.reset()
    acts = bench_actions(4, cfg.num_agents, 3)
    seen = {"sphere_cast_culled": [], "sphere_cast_packed": []}
    for s in range(3):
        a = env.zero_actions().replace(**{
            k: torch.as_tensor(v[s], dtype=torch.int32)
            for k, v in acts.items()})
        patches = []
        for name in seen:
            fn = getattr(movement, name)

            def rec(*args, _fn=fn, _name=name):
                seen[_name].append(args)
                return _fn(*args)

            patches.append(mock.patch.object(movement, name, rec))
        with patches[0], patches[1]:
            state, _ = env.step(state, a)
    (l1,) = seen["sphere_cast_culled"][-1:]
    return env.map_data, [l1] + seen["sphere_cast_packed"][-3:]


def _with_edge_groups(o, d):
    """o, d with group 0's casts directionless and group 1's cast upward
    from 5000 above the map (all miss)."""
    o, d = o.clone(), d.clone()
    d[0] = 0.0
    o[1, :, 2] += 5000.0
    d[1] = torch.tensor([0.0, 0.0, 1.0])
    return o, d


def _assert_same(got, want):
    (t, row), (tp, rowp) = got, want
    assert torch.equal(t, tp) and torch.equal(row, rowp.to(row.dtype))
    nz = t != 0  # ties at +-0 report one of the zeros: equal as numbers
    assert torch.equal(t[nz].view(torch.int32), tp[nz].view(torch.int32))


@pytest.mark.parametrize("gappy", [False, True])
@pytest.mark.parametrize("batch", ["l1", "pair", "snap", "fall"])
def test_lanes_model_matches_plain(step_casts, batch, gappy):
    m, batches = step_casts
    assert [b[0].shape[1] for b in batches] == [7, 2, 1, 1]
    o, d, r, cells, short, soup = batches[
        ["l1", "pair", "snap", "fall"].index(batch)]
    o, d = _with_edge_groups(o, d)
    table = _gappy(short, 7) if gappy else short
    want = raycast._sphere_cast_culled_plain(o, d, r, cells, table, soup)
    got = _lanes_model(o, d, r, cells, table, soup)
    _assert_same(got, want)
    t, row = got
    # directionless: every candidate near 0, the lowest row wins; all
    # miss: row 0
    cand0 = table.cand.reshape(-1, table.K)[cells[0].long()]
    assert bool((t[0] <= 0.0).all())
    assert bool((row[0] == cand0[cand0 >= 0].min()).all())
    assert bool(torch.isinf(t[1]).all() and (row[1] == 0).all())
    assert bool(torch.isfinite(t).float().mean() > 0.3)


# ---------------------------------------------------------------------------
# (c) ShortTables.valid_span
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scene", ["simple_map", "town_map"])
def test_valid_span_on_the_shipped_tables(scene):
    m = load_map(os.path.join(DATA, scene), mt.EnvConfig(team_size=6),
                 device="cpu")
    for short in (m.short, m.short_mv):
        cand = short.cand.reshape(-1, short.K)
        span = short.valid_span
        assert span.dtype == torch.int32 and span.shape == (cand.shape[0],)
        count = (cand >= 0).sum(-1)
        # the shipped tables are compacted: the span is the count
        assert torch.equal(span.long(), count)
        for c in range(cand.shape[0]):
            assert bool((cand[c, span[c]:] < 0).all())
            assert span[c] == 0 or cand[c, span[c] - 1] >= 0
    gappy = _gappy(m.short, 3)
    cand = gappy.cand.reshape(-1, gappy.K)
    span = gappy.valid_span
    assert span[0] == 0 and bool((span >= (cand >= 0).sum(-1)).all())
    assert bool((span > (cand >= 0).sum(-1)).any())
    for c in range(cand.shape[0]):
        assert bool((cand[c, span[c]:] < 0).all())
        assert span[c] == 0 or cand[c, span[c] - 1] >= 0


# ---------------------------------------------------------------------------
# (d) the pair arithmetic, per f32 operation
# ---------------------------------------------------------------------------

f32 = np.float32


def _dot(a, b):
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]


def _sel_inf(ok, t):
    return np.where(ok, t, f32(np.inf))


def _min2(a, b):
    return np.where(b < a, b, a)


def _safe1(x):
    return np.where(np.abs(x) > f32(1e-20), x, f32(1.0))


def _closest(p, a, ab, ac):
    """tri_math.cuh closest_point_on_tri."""
    ap = p - a
    d1, d2 = _dot(ab, ap), _dot(ac, ap)
    b = a + ab
    bp = p - b
    d3, d4 = _dot(ab, bp), _dot(ac, bp)
    c = a + ac
    cp = p - c
    d5, d6 = _dot(ab, cp), _dot(ac, cp)
    vc, vb, va = d1 * d4 - d3 * d2, d5 * d2 - d1 * d6, d3 * d6 - d5 * d4
    denom_vb, denom_vc, denom_va = d1 - d3, d2 - d6, (d4 - d3) + (d5 - d6)
    in_a = (d1 <= 0) & (d2 <= 0)
    in_b = (d3 >= 0) & (d4 <= d3)
    in_c = (d6 >= 0) & (d5 <= d6)
    on_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    on_ac = (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    on_bc = (va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0)
    v_ab = d1 / _safe1(denom_vb)
    w_ac = d2 / _safe1(denom_vc)
    w_bc = (d4 - d3) / _safe1(denom_va)
    inv_face = f32(1.0) / _safe1(va + vb + vc)
    v_f, w_f = vb * inv_face, vc * inv_face
    res = (a + v_f[..., None] * ab) + w_f[..., None] * ac
    for cond, val in ((on_bc, b + w_bc[..., None] * (c - b)),
                      (on_ac, a + w_ac[..., None] * ac),
                      (on_ab, a + v_ab[..., None] * ab),
                      (in_c, c), (in_b, b), (in_a, a)):
        res = np.where(cond[..., None], val, res)
    return res


def _sphere(o, d, dd, center, rr):
    mo = o - center
    bb = _dot(mo, d)
    cc = _dot(mo, mo) - rr
    dsc = bb * bb - dd * cc
    sq = np.sqrt(np.fmax(dsc, f32(0.0)))
    t = (-bb - sq) / np.fmax(dd, f32(1e-20))
    return _sel_inf((dsc >= 0) & (t >= 0), t)


def _capsule(o, d, p0, seg, seg_len2, rr):
    """tri_math.cuh ray_capsule."""
    m = o - p0
    dd, md, ms, ds, mm = (_dot(d, d), _dot(m, d), _dot(m, seg), _dot(d, seg),
                          _dot(m, m))
    inv_l2 = f32(1.0) / np.fmax(seg_len2, f32(1e-20))
    a = dd - ds * ds * inv_l2
    b = md - ms * ds * inv_l2
    c = mm - ms * ms * inv_l2 - rr
    disc = b * b - a * c
    sqrt_disc = np.sqrt(np.fmax(disc, f32(0.0)))
    a_ok = np.abs(a) > f32(1e-12)
    t_cyl = (-b - sqrt_disc) / np.where(a_ok, a, f32(1.0))
    s_hit = ms + t_cyl * ds
    ok = (a_ok & (disc >= 0) & (t_cyl >= 0) & (s_hit >= 0)
          & (s_hit <= seg_len2))
    t_cyl = _sel_inf(ok, t_cyl)
    return _min2(t_cyl, _min2(_sphere(o, d, dd, p0, rr),
                              _sphere(o, d, dd, p0 + seg, rr)))


def _sc_pair(o, d, r, rr, v0, e1, e2, n, valid):
    """tri_math.cuh sc_pair -> t_tri: casts o, d [R, 1, 3] against rows
    v0 e1 e2 n [T, 3], valid [T] -> [R, T]."""
    to_center = o - _closest(o, v0, e1, e2)
    overlap = (_dot(to_center, to_center) <= rr) & valid
    ndotd = _dot(n, d)
    h = _dot(o - v0, n)
    sign = np.where(h > 0, f32(1.0), np.where(h < 0, f32(-1.0), f32(1.0)))
    nd_ok = np.abs(ndotd) > f32(1e-9)
    t_face = (sign * r - h) / np.where(nd_ok, ndotd, f32(1.0))
    cp = ((o + t_face[..., None] * d) - (sign * r)[..., None] * n) - v0
    d00, d01, d11 = _dot(e1, e1), _dot(e1, e2), _dot(e2, e2)
    d20, d21 = _dot(cp, e1), _dot(cp, e2)
    denom = d00 * d11 - d01 * d01
    inv_denom = np.where(np.abs(denom) > f32(1e-20), f32(1.0) / denom,
                         f32(0.0))
    bv = (d11 * d20 - d01 * d21) * inv_denom
    bw = (d00 * d21 - d01 * d20) * inv_denom
    face_ok = (nd_ok & (t_face >= 0) & (bv >= 0) & (bw >= 0)
               & (bv + bw <= 1) & valid)
    t_face = _sel_inf(face_ok, t_face)
    v1 = v0 + e1
    t_e0 = _capsule(o, d, v0, e1, _dot(e1, e1), rr)
    t_e1 = _capsule(o, d, v0, e2, _dot(e2, e2), rr)
    e12 = e2 - e1
    t_e2 = _capsule(o, d, v1, e12, _dot(e12, e12), rr)
    t_edge = _sel_inf(valid, _min2(t_e0, _min2(t_e1, t_e2)))
    return np.where(overlap, f32(0.0), _min2(t_face, t_edge))


def _adversarial(g, T, R):
    v0 = g.uniform(-40, 40, (T, 3)).astype(f32)
    e1 = g.normal(0, 30, (T, 3)).astype(f32)
    e2 = g.normal(0, 30, (T, 3)).astype(f32)
    valid = np.ones(T, bool)
    e1[0], e2[0] = 0.0, 0.0  # a point: denom 0, inv_len2 of 0
    e1[1], e2[1] = [1e-6, 0, 0], [0, 1e-6, 0]  # tiny: |denom| under 1e-20
    e2[2] = e1[2] * f32(2.0)  # collinear edges
    valid[3] = False  # an invalid row with real edges
    v0[4] = e1[4] = e2[4] = 0.0
    valid[4] = False  # padding
    v0[5], e1[5], e2[5] = [0, 0, 0], [40, 0, 0], [0, 40, 0]  # the z = 0 plane
    n = np.cross(e1, e2)
    ln = np.linalg.norm(n, axis=-1, keepdims=True)
    n = np.where(ln > 0, n / np.where(ln > 0, ln, 1), 0).astype(f32)
    o = g.uniform(-60, 60, (R, 3)).astype(f32)
    d = g.normal(size=(R, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(f32)
    d[:8] = 0.0  # directionless
    o[8:16] = [10.0, 10.0, 15.0]  # touching the z = 0 row: h = r
    d[8:16] = [[0, 0, -1]] * 4 + [[1, 0, 0]] * 4  # down; along the face
    o[16:24] = v0[6] + f32(0.3) * e1[6]  # on a row: start overlap
    d[24:32] = [0.0, 0.0, -1.0]
    o[24:32, :2] = [5.0, 5.0]  # down onto the z = 0 row
    return o, d, v0, e1, e2, n, valid


def test_sc_pair_per_op_matches_plain_pair():
    g = np.random.default_rng(17)
    T, CASTS = 48, 7
    o, d, v0, e1, e2, n, valid = _adversarial(g, T, 64 * CASTS)
    r = f32(R)
    with np.errstate(all="ignore"):  # the guarded divides of the padding
        got = np.concatenate([  # a group's casts against the same rows
            _sc_pair(o[j::CASTS, None], d[j::CASTS, None], r, r * r, v0, e1,
                     e2, n, valid)
            for j in range(CASTS)])
    want = raycast._sc_pairs(
        *(torch.as_tensor(np.concatenate([x[j::CASTS] for j in range(
            CASTS)]))[:, None] for x in (o, d)), R,
        *(torch.as_tensor(x) for x in (v0, e1, e2, n, valid)))["t_tri"]
    want = want.numpy()
    # bit for bit but the sign of a zero: between a +0 and a -0 ATen's CPU
    # minimum returns either (its vectorized path the second operand, its
    # scalar path the first), the kernels' min2 the first; t = +-0 ties
    # compare equal in every minimum that follows
    assert np.array_equal(got, want)
    nz = want != 0
    assert np.array_equal(got[nz].view(np.int32), want[nz].view(np.int32))
    hit = np.isfinite(want)
    assert 0.1 < hit.mean() < 0.9 and (want[hit] > 0).mean() > 0.3
    assert (want == 0).any()  # start overlaps, directionless casts


# ---------------------------------------------------------------------------
# (e) K4 dense / K8: the rows split over a thread-block cluster
# ---------------------------------------------------------------------------

def test_sc_split_from_rows_and_casts():
    """The dense entries' launch choice (raycast.sc_split, 2 threads a
    cast): the town battery's chunk and the forced step's L3 / fall
    launches split 8 ways, its L2 pair 6, K8 at the kernel bench's 86,016
    casts 2 ways, many casts need no split, a soup under SC_MIN_ROWS rows
    none; each block of a cluster gets at least SC_MIN_ROWS rows and the
    blocks' row chunks cover every row once."""
    sms = 132
    assert raycast.SC_PARTS == 2
    assert raycast.sc_split(6144, 8192, sms) == 8  # the cast battery
    assert raycast.sc_split(256, 24576, sms) == 6  # the forced L2 pair
    assert raycast.sc_split(256, 12288, sms) == 8  # L3 snap, fall cast
    assert raycast.sc_split(6144, 86016, sms) == 2  # the kernel bench
    assert raycast.sc_split(20, 5, sms) == 1
    assert raycast.sc_split(6144, 2 ** 22, sms) == 1
    for T in (0, 1, 31, 32, 100, 256, 6144):
        for R in (0, 1, 13, 129, 2049, 2 ** 20):
            S = raycast.sc_split(T, R, sms)
            assert 1 <= S <= raycast.SC_MAX_SPLIT
            assert S == 1 or T // S >= raycast.SC_MIN_ROWS
            c = -(-T // S)
            rows = np.concatenate([np.arange(min(T, s * c), min(T, s * c + c))
                                   for s in range(S)] + [np.arange(0)])
            assert np.array_equal(rows, np.arange(T))
