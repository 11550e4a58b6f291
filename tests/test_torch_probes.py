"""The fan probes of the port (P5 tools/probes/v9_kernel_probe.py, P6
tools/probes/v9_scan_timing.py, P2 tools/fan_probe.py) on the CPU, at 64
fans of the probes' own inputs (v9_kernel_probe.make_fans: simple_map,
the sensor fan's 104 rays in 5 z-groups, fans ordered by cell).

The plain versions of the kernels that compute K9's or K2's function are
bit-equal to the plain versions those kernels are held to
(``raycast._ray_fans_v9_plain``, ``raycast._ray_fans_dense``, which
tests/test_torch_raycast.py and tests/test_torch_town.py hold to the JAX
package): the pre-gathered table and the chunked candidate order (P5,
P6), and K2's exact-divide, IEEE-reciprocal and chunked variants (P2).
Each probe's ``main`` runs on the CPU, and P3's too at 2 worlds.
"""

import os
import sys

import pytest
import torch

from madrona_mp_env_tpu_torch.ops import raycast
from madrona_mp_env_tpu_torch.tools import fan_probe
from madrona_mp_env_tpu_torch.tools.probes import (
    movement_fused_probe, v9_kernel_probe, v9_scan_timing,
)

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "fixtures_torch"))
from torch_threads import one_thread_under_xdist  # noqa: E402,F401

FANS = 64


@pytest.fixture(scope="module")
def probe():
    m = v9_kernel_probe.probe_map("cpu")
    return m, v9_kernel_probe.make_fans(m, FANS, 0, "cpu")


def test_make_fans_are_ordered_by_cell(probe):
    m, x = probe
    assert x["zoff"].shape == (FANS, 104) and x["zg"].shape == (FANS, 5)
    cells = x["cells"]
    assert bool((cells[1:] >= cells[:-1]).all())
    assert bool((x["origins"][:, 2] == 10.0).all())
    d = torch.stack(x["dirs"], dim=-1)
    assert torch.allclose(d.norm(dim=-1), torch.ones(FANS, 104), atol=1e-6)


def _v9_args(x):
    return x["origins"], x["zoff"], x["dirs"], x["cells"]


@pytest.mark.parametrize("order", ["gathered", "chunked", "full"])
def test_v9_orders_match_plain(order, probe):
    """P5's pre-gathered table, P6's chunked and full orders: the same t
    as K9's plain version, bit for bit."""
    m, x = probe
    rt, soup = m.ray_cells, m.tris
    want = raycast._ray_fans_v9_plain(*_v9_args(x), rt, soup)
    if order == "gathered":
        table = v9_kernel_probe.gather_tables(rt, soup)
        assert table.shape == (rt.num_cells, rt.K, 16)
        got = v9_kernel_probe.ray_fans_v9_gathered(*_v9_args(x), table)
    elif order == "chunked":
        got = v9_scan_timing.ray_fans_v9_chunked(*_v9_args(x), rt, soup)
    else:
        got = raycast.ray_fans_culled_v9(*_v9_args(x), rt, soup)
    assert torch.isfinite(want).any() and torch.isinf(want).any()
    assert torch.equal(got, want)


@pytest.mark.parametrize("variant", ["exact", "rcp_ieee", "chunked"])
def test_fan_probe_exact_variants_match_dense(variant, probe):
    """P2's variants that compute K2's function: their plain versions give
    _ray_fans_dense's t, bit for bit."""
    m, x = probe
    args = (x["origins"], x["zg"], x["dirs"], x["zgroups"], m.tris)
    got = fan_probe._fan_probe_plain(variant, *args)
    assert torch.equal(got, raycast._ray_fans_dense(*args))


@pytest.mark.parametrize("variant", ["dots_only", "epilogue"])
def test_fan_probe_part_variants(variant, probe):
    """The dots-only and epilogue-only plain versions: finite minima of
    the pair's dots; the epilogue's t from the buffer's dots."""
    m, x = probe
    aux = fan_probe.make_aux(m.tris.num_tris, 0, "cpu")
    args = (x["origins"], x["zg"], x["dirs"], x["zgroups"], m.tris)
    got = fan_probe.ENTRIES[variant](*args, aux=aux)
    assert got.shape == (FANS, 104)
    if variant == "dots_only":
        assert bool(torch.isfinite(got).all())
    else:
        assert bool((got > 0.0).all())


@pytest.mark.parametrize("name", ["p5", "p6", "p2", "p3"])
def test_probe_main_runs_on_cpu(name):
    if name == "p3":
        res = movement_fused_probe.main(
            ["--device", "cpu", "--worlds", "2", "--steps", "1",
             "--iters", "1"])
        assert set(res) == {"culled", "dense"}
        return
    mod, flag = {"p5": (v9_kernel_probe, "--iters"),
                 "p6": (v9_scan_timing, "--chain"),
                 "p2": (fan_probe, "--iters")}[name]
    res = mod.main(["--device", "cpu", "--fans", "16", flag, "1"])
    assert all(v >= 0.0 for v in res.values())
