"""Zone 3v3, the odd team size, and the kernel bench, through the port on
the CPU:

- ``fan_route`` gives the JAX package's choice of sensor-fan kernel
  (its ops/raycast.py ray_fans_vs_tris, run with its kernel entries
  replaced by recorders and use_pallas forced on) for team sizes 1, 2, 3
  and 6 on both maps, with the default gates and with MPENV_FAN_V9=1,
  MPENV_FAN_CULL=0 and MPENV_FAN_CULL=1: a LOS run of 4 ts rays that is
  not a multiple of 8 takes the stacked-direction fan K7 over the whole
  soup, on town_map too, unless the sensor-ray tables (K9) are on.
- The Zone 3v3 slice (simple_map, 2 worlds, 16 steps) replays the
  committed JAX rollout fixtures_torch/zone3v3_simple_map_slice.npz
  (make_team3_fixture.py) within tests/test_torch_slice.py's bars:
  discrete fields exact, pos and reward within 1e-4, observations within
  1e-3, each times max(1, |x|).
- ``tools/kernel_bench.py --device cpu`` at 2 worlds and 1 iteration
  prints all four phases.
"""

import io
import os
import sys
from contextlib import redirect_stdout
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest

import madrona_mp_env_tpu_torch as mt
from madrona_mp_env_tpu.ops import raycast as jrc
from madrona_mp_env_tpu.ops import raycast_pallas as jrp
from madrona_mp_env_tpu_torch.assets.map_data import load_map
from madrona_mp_env_tpu_torch.ops import raycast
from madrona_mp_env_tpu_torch.tools import kernel_bench

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "fixtures_torch"))
import make_slice_fixture as fx  # noqa: E402
import make_team3_fixture as fx3  # noqa: E402
from test_torch_slice import compare, port_rollout  # noqa: E402
from torch_threads import one_thread_under_xdist  # noqa: E402,F401

GATE_MODES = ({}, {"MPENV_FAN_V9": "1"}, {"MPENV_FAN_CULL": "0"},
              {"MPENV_FAN_CULL": "1"})
# the JAX package's fan kernel entries, by the route each one is
JAX_FAN_ENTRIES = {"ray_fans_culled_v9": "v9",
                   "ray_fans_culled_planar": "culled",
                   "ray_fans_vs_tris_planar": "dense",
                   "ray_fans_vs_tris_pallas": "flat"}


@pytest.fixture(scope="module")
def maps(simple_map_dir):
    data = os.path.dirname(simple_map_dir)
    return {s: load_map(os.path.join(data, s), mt.EnvConfig(team_size=3),
                        device="cpu")
            for s in ("simple_map", "town_map")}


def _jax_route(m, zgroups, monkeypatch):
    """The kernel the JAX dispatch picks for the sim's sensor fan on map
    ``m`` (its operands as the JAX step passes them: PVS cells when the
    map has tables, sensor-ray cells when it has those)."""
    seen = []
    for name, route in JAX_FAN_ENTRIES.items():
        monkeypatch.setattr(jrp, name,
                            lambda *a, _r=route, **k: seen.append(_r))
    monkeypatch.setattr(jrc, "use_pallas", lambda: True)
    F, G = sum(zgroups), len(zgroups)
    soup = SimpleNamespace(packed=np.zeros((16, m.tris.num_tris)))
    tables = None if m.cells is None else SimpleNamespace(K=m.cells.K)
    cell = jnp.zeros((1,), jnp.int32)
    jrc.ray_fans_vs_tris(
        jnp.zeros((1, 3)), jnp.zeros((1, G)),
        tuple(jnp.zeros((1, F)) for _ in range(3)), soup,
        cells=None if tables is None else cell, tables=tables,
        zgroups=zgroups, ray_tables=m.ray_cells,
        ray_cells=None if m.ray_cells is None else cell)
    assert len(seen) == 1
    return seen[0]


@pytest.mark.parametrize("scene", ["simple_map", "town_map"])
@pytest.mark.parametrize("ts", [1, 2, 3, 6])
def test_fan_route_matches_jax(maps, scene, ts, monkeypatch):
    m = maps[scene]
    zgroups = kernel_bench.sensor_zgroups(ts)
    for mode in GATE_MODES:
        for k in ("MPENV_FAN_V9", "MPENV_FAN_CULL"):
            monkeypatch.delenv(k, raising=False)
        for k, v in mode.items():
            monkeypatch.setenv(k, v)
        want = _jax_route(m, zgroups, monkeypatch)
        assert raycast.fan_route(zgroups, m) == want, (mode, want)
    if ts % 2:  # an odd team size's LOS run: K7 by default
        monkeypatch.delenv("MPENV_FAN_V9", raising=False)
        monkeypatch.delenv("MPENV_FAN_CULL", raising=False)
        assert raycast.fan_route(zgroups, m) == "flat"


def test_team3_slice_matches_jax_fixture(simple_map_dir):
    want = dict(np.load(fx3.PATH))
    acts = fx.draw_actions(num_agents=2 * fx3.TEAM_SIZE)
    for k, v in acts.items():
        assert np.array_equal(want[k], v), k
    got = port_rollout(simple_map_dir, team_size=fx3.TEAM_SIZE)
    assert got["obs_opponents"].shape[-2] == fx3.TEAM_SIZE
    assert set(got) <= set(want)
    compare(got, want)


def test_kernel_bench_runs_on_the_cpu():
    out = io.StringIO()
    with redirect_stdout(out):
        res = kernel_bench.main(["--device", "cpu", "--worlds", "2",
                                 "--iters", "1", "--team-size", "3"])
    text = out.getvalue()
    for line in ("device cpu", "fans=12 rays/fan=92", "fan_kernel:",
                 "sc_kernel(normals):", "sc_kernel(no-normal):",
                 "fan_capsules:", "env.step:"):
        assert line in text, line
    assert all(np.isfinite(v) and v > 0 for v in res.values())
