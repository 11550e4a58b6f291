"""The port's offline asset tools against the JAX package's, on the CPU.

- The table builders (ops/culling.py): ``build_cell_tables`` on
  tests/test_culling.py's synthetic arena and ``build_ray_tables`` on
  simple_map, at cut batteries, against the JAX builders run eagerly
  (tests/fixtures_torch/asset_tools_jax.npz, make_asset_tools_fixture.py):
  candidate tables, K, k_raw and every convergence round's new bits
  equal. ``verify_tables`` / ``verify_ray_tables`` give the JAX checks'
  mismatch counts on the same tables. The builders draw numpy's random
  stream in the JAX order, so nothing here has a tolerance.
- The cast battery's sweep: the port's K4 dense plain version
  (``raycast._sphere_cast_dense``, what ``sphere_cast`` runs on the CPU)
  against the JAX builder's own closure ``sc_idx_fn`` on 4,096 casts of
  the battery's distribution over the padded soup: t bit-equal, winner
  rows equal, every hit's row a real triangle (the builder's ``idx < T``
  clamp never acts) and row 0 on a miss.
- ``load_or_build_*``: None without a file when not building; a build
  writes the map directory's file, which loads back without a build.
- ``make_town_map`` (2 blocks) and ``convert_assets`` (both of
  tests/test_assets_tools.py's inputs): the four .bin files byte-equal
  to the JAX tools' (sha256 in the fixture).
- ``golden --generate`` into a temporary path, then ``--check`` on it;
  ``generate`` refuses a CUDA device.
- The navmesh tables: the port's ``tri_adjacency`` and
  ``all_pairs_next_hop`` against the native library of the JAX package
  (as tests/test_native.py holds its numpy versions): adjacency equal,
  walk lengths within 1e-4 relative on 100 seeded pairs, on both maps.
"""

import os
import sys

import numpy as np
import pytest
import torch

from madrona_mp_env_tpu_torch.assets import formats, navmesh
from madrona_mp_env_tpu_torch.ops import culling, raycast
from madrona_mp_env_tpu_torch.tools import convert_assets, golden
from madrona_mp_env_tpu_torch.tools import make_town_map

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures_torch")
sys.path.insert(0, FIXTURES)
import make_asset_tools_fixture as fx  # noqa: E402
from torch_threads import one_thread_under_xdist  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def want():
    return dict(np.load(fx.PATH))


@pytest.fixture(scope="module")
def synth(tmp_path_factory, want):
    """The arena's PVS tables built on the CPU into a map directory."""
    tv, wp = fx.synth_inputs()
    assert np.array_equal(tv, want["synth/tv"])
    assert np.array_equal(wp, want["synth/wp"])
    cache = str(tmp_path_factory.mktemp("synth"))
    stats = {}
    tables = culling.load_or_build_cell_tables(
        tv, cache, device="cpu", walkable_points=wp, stats=stats,
        **fx.SYNTH_KW)
    return tv, wp, tables, stats, cache


@pytest.fixture(scope="module")
def ray(want):
    tv, wp = fx.map_inputs(os.path.join(REPO, "data", "simple_map"))
    assert np.array_equal(tv, want["ray/tv"])
    assert np.array_equal(wp, want["ray/wp"])
    stats = {}
    raw = culling.build_ray_tables(tv, walkable_points=wp, device="cpu",
                                   stats=stats, **fx.RAY_KW)
    return tv, wp, raw, stats


def test_build_cell_tables_matches_jax(synth, want):
    _, _, tables, stats, cache = synth
    with np.load(os.path.join(cache, "culling.npz")) as raw:
        assert np.array_equal(raw["cand_idx"], want["synth/cand_idx"])
        assert int(raw["K"]) == int(want["synth/K"]) == tables.K
        assert int(raw["k_raw"]) == int(want["synth/k_raw"])
        assert int(raw["version"]) == culling.TABLE_VERSION
    assert stats["round_bits"] == want["synth/round_bits"].tolist()
    assert np.array_equal(tables.cand_idx.numpy(), want["synth/cand_idx"])


def test_build_ray_tables_matches_jax(ray, want):
    _, _, raw, stats = ray
    assert np.array_equal(raw["cand_idx"], want["ray/cand_idx"])
    assert int(raw["K"]) == int(want["ray/K"])
    assert int(raw["k_raw"]) == int(want["ray/k_raw"])
    assert raw["version"] == culling.RAY_TABLE_VERSION
    assert stats["round_bits"] == want["ray/round_bits"].tolist()
    assert stats["chunks"] > 0 and 0 < stats["device_s"] <= stats["total_s"]


def test_sphere_cast_dense_matches_builder_closure(synth, want):
    """The battery's casts (drawn by the port's sampler from the port's
    ground heights, equal to the fixture's) through the cast sweep."""
    tv, wp, tables, _, _ = synth
    rng = np.random.default_rng(fx.SC_SEED)
    z = tv.reshape(-1, 3)[:, 2]
    tris = culling._tri_arrays(tv, "cpu")

    def ground(xy):
        return tuple(x.numpy() for x in culling._ground_heights(
            torch.as_tensor(xy), tris, float(z.max() + 50.0),
            float(z.min() - 10.0)))

    sample = culling._make_origin_sampler(
        rng, wp, ground, np.array([tables.grid_min_x, tables.grid_min_y]),
        tables.nx, tables.ny, tables.cell_size, float(z.min() - 10.0),
        float(z.max() + 50.0))
    o = sample(fx.SC_CASTS)
    d = culling._unit_dirs(rng, fx.SC_CASTS)
    assert np.array_equal(o, want["sc/o"]) and np.array_equal(d, want["sc/d"])
    soup = raycast.make_tri_soup(tv, pad_to=128)
    assert soup.num_tris == 128 > len(tv)
    t, idx = raycast.sphere_cast(torch.as_tensor(o), torch.as_tensor(d),
                                 fx.SC_RADIUS, soup)
    t, idx = t.numpy(), idx.numpy()
    assert np.array_equal(t.view(np.int32), want["sc/t"].view(np.int32))
    assert np.array_equal(idx, want["sc/idx"])
    hit = np.isfinite(t)
    assert 0.2 < hit.mean() < 1.0
    assert (idx[hit] < len(tv)).all() and (idx[~hit] == 0).all()


def test_verify_tables_matches_jax(synth, want):
    tv, wp, tables, _, _ = synth
    res = culling.verify_tables(tv, tables, walkable_points=wp,
                                **fx.SYNTH_VERIFY)
    assert res["ray_mismatch"] == int(want["synth/ray_mismatch"])
    assert res["sc_mismatch"] == int(want["synth/sc_mismatch"])
    assert (res["n_rays"], res["n_casts"]) == (20000, 4000)


def test_verify_ray_tables_matches_jax(ray, want):
    tv, wp, raw, _ = ray
    tables = culling._grid_tables(culling.RayTables, raw, "cpu")
    res = culling.verify_ray_tables(tv, tables, walkable_points=wp,
                                    **fx.RAY_VERIFY)
    assert res["ray_mismatch"] == int(want["ray/ray_mismatch"]) > 0


def test_load_or_build_round_trip(synth, tmp_path, monkeypatch):
    tv, wp, tables, _, cache = synth
    assert culling.load_or_build_cell_tables(
        tv, str(tmp_path), build_if_missing=False) is None
    assert culling.load_or_build_ray_tables(
        tv, str(tmp_path), build_if_missing=False) is None
    assert not os.listdir(tmp_path)

    def no_build(*a, **kw):
        raise AssertionError("a matching file must load, not build")

    monkeypatch.setattr(culling, "build_cell_tables", no_build)
    again = culling.load_or_build_cell_tables(tv, cache, device="cpu")
    assert torch.equal(again.cand_idx, tables.cand_idx)
    assert (again.nx, again.cell_size, again.K) == (
        tables.nx, tables.cell_size, tables.K)
    # another soup's triangles do not match the file's hash
    assert culling.load_or_build_cell_tables(
        tv[::-1].copy(), cache, build_if_missing=False) is None


def test_make_town_map_matches_jax(tmp_path, want, capsys):
    make_town_map.main(["--out", str(tmp_path)] + fx.TOWN_ARGS)
    for name, digest in fx.bin_digests(str(tmp_path)).items():
        assert digest == str(want[f"town/{name}"]), name


@pytest.mark.parametrize("case", fx.CONVERT_CASES)
def test_convert_assets_matches_jax(case, tmp_path, want, capsys):
    col, nav, js = fx.convert_inputs(case, str(tmp_path))
    out = str(tmp_path / "map")
    convert_assets.convert(col, nav, js, out)
    for name, digest in fx.bin_digests(out).items():
        assert digest == str(want[f"convert_{case}/{name}"]), name


def test_golden_generate_then_check(tmp_path, capsys):
    path = str(tmp_path / "golden.npz")
    golden.main(["--generate", "--path", path, "--num-steps", "3"])
    with np.load(path) as z:
        with np.load(golden.DEFAULT_PATH) as ref:
            assert sorted(z.files) == sorted(ref.files)
            for k in ref.files:
                assert z[k].dtype == ref[k].dtype
                assert z[k].shape == (3,) + ref[k].shape[1:]
    report = golden.main(["--cpu", "--check", "--path", path])
    assert report["steps"] == 3 and report["first_divergence_step"] == 3
    with pytest.raises(RuntimeError, match="CPU"):
        golden.generate(path, device="cuda")
    with pytest.raises(SystemExit):  # never over the committed golden
        golden.main(["--generate"])


def _walk_len(nh, cents, s, g, max_steps=1000):
    t, dist = s, 0.0
    for _ in range(max_steps):
        if t == g:
            return dist
        nxt = nh[t, g]
        if nxt < 0:
            return np.inf
        dist += np.linalg.norm(cents[t] - cents[nxt])
        t = nxt
    return np.inf


@pytest.mark.parametrize("scene", ["simple_map", "town_map"])
def test_navmesh_tables_match_native(scene):
    from madrona_mp_env_tpu.assets import native

    if native.load() is None:
        pytest.skip("the JAX package's native library did not build")
    nav = formats.load_navmesh(os.path.join(REPO, "data", scene,
                                            "navmesh.bin"))
    tris = nav.tri_indices.astype(np.int32)
    cents = nav.verts.astype(np.float32)[tris].mean(axis=1)
    adj = navmesh.tri_adjacency(tris)
    assert np.array_equal(adj, native.tri_adjacency(tris))
    nh_n = native.astar_next_hop(cents, adj)
    nh_p = navmesh.all_pairs_next_hop(cents.astype(np.float64), adj)
    assert nh_n.shape == nh_p.shape
    rng = np.random.default_rng(3)
    for _ in range(100):
        s, g = rng.integers(0, len(tris), 2)
        ln = _walk_len(nh_n, cents, s, g)
        lp = _walk_len(nh_p, cents, s, g)
        assert np.isclose(ln, lp, rtol=1e-4) or (
            np.isinf(ln) and np.isinf(lp)), f"{s}->{g}: {ln} vs {lp}"
