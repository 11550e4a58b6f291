"""P4, the tensor-core sphere-cast probe of the port
(madrona_mp_env_tpu_torch/tools/probes/sc_mxu_probe.py), on the CPU,
against the JAX probe's own outputs (tests/fixtures_torch/sc_mxu_probe.npz,
written by make_sc_mxu_fixture.py through the Pallas interpreter).

- The casts and the ``dirm`` / ``orgm`` / ``cons`` matrices equal the JAX
  probe's bit for bit.
- ``_sc_mxu_plain`` on the first 2,048 casts: the same casts hit, and t
  within 5e-2 absolute where both hit. Not bit for bit: the JAX kernel's
  two products sum their 8 terms in XLA's order, the plain version in
  k = 0..7 order, and the uncentered origin terms (~1e6 against r^2 =
  225) leave ~1e-2 of f32 noise in t (measured: 1.73e-2, and 2.6e-2
  between the plain version in f32 and in f64).
- Against the port's plain dense sphere cast (K4's plain version) on the
  same casts, at the JAX probe's own parity bar (rtol 1e-3, atol 2e-2):
  at least 99.9% of the casts (measured: all).
- ``main --device cpu`` runs at 256 casts.
"""

import os
import sys

import numpy as np
import pytest
import torch

from madrona_mp_env_tpu_torch.ops import raycast
from madrona_mp_env_tpu_torch.tools.probes import sc_mxu_probe as p4

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "fixtures_torch"))
from torch_threads import one_thread_under_xdist  # noqa: E402,F401

FIXTURE = os.path.join(HERE, "fixtures_torch", "sc_mxu_probe.npz")
T_TOL = 5e-2
PARITY = 0.999


@pytest.fixture(scope="module")
def fx():
    return dict(np.load(FIXTURE))


@pytest.fixture(scope="module")
def probe(fx):
    """(map, tables, casts o and d, plain t) on the fixture's casts."""
    m = p4.probe_map("cpu")
    tables = p4.probe_tables(m, "cpu")
    o, d = (torch.as_tensor(fx[k]) for k in ("o", "d"))
    return m, tables, o, d, p4._sc_mxu_plain(p4.planes_of(o, d), *tables)


@pytest.mark.parametrize("name", ["dirm", "orgm", "cons"])
def test_tables_equal_jax(fx, probe, name):
    got = probe[1][("dirm", "orgm", "cons").index(name)].numpy()
    assert got.shape == fx[name].shape and np.array_equal(got, fx[name])


def test_casts_equal_jax(fx):
    o, d = p4.make_casts(p4.CASTS, 0, "cpu")
    n = len(fx["o"])
    assert np.array_equal(o[:n].numpy(), fx["o"])
    assert np.array_equal(d[:n].numpy(), fx["d"])


def test_plain_matches_jax(fx, probe):
    t = probe[4]
    want = torch.as_tensor(fx["t"])
    assert bool((torch.isfinite(t) == torch.isfinite(want)).all())
    assert bool(torch.isfinite(want).any() & torch.isinf(want).any())
    err, flips = p4.mxu_error(t, want)
    assert flips == 0.0 and err <= T_TOL


def test_plain_parity_with_dense_sphere_cast(probe):
    m, _, o, d, t = probe
    frac, _ = p4.parity(t, raycast._sphere_cast_dense(o, d, p4.R, m.tris)[0])
    assert frac >= PARITY


def test_main_runs_on_cpu():
    res = p4.main(["--device", "cpu", "--casts", "256", "--iters", "1"])
    assert res["mxu_ms"] > 0.0 and res["prod_ms"] > 0.0
    assert res["parity_frac"] >= PARITY
