"""Write the issue-rate probe fixture (P1) of the PyTorch port's tests.

Runs the JAX package's tools/vpu_probe.py ``main`` on the CPU with
numpy's global generator seeded (the probe draws its inputs from it
unseeded), ``pl.pallas_call`` run by the Pallas interpreter
(``interpret=True``) and ``_timeit`` cut to one call that records its
arguments and output. Each of the probe's ten timed calls is one chain,
in ``main``'s order (``CHAINS``): the eight 256 x 256 f32 chains, then
the bf16 matmul chains at K = 8 and K = 128.

For each chain it stores rows 0-15 of both inputs and of the output
(``<name>/a``, ``<name>/b``, ``<name>/out``): every chain's row depends
on its own row and, for the sublane broadcast, on row 0, so the rows
are a closed system. For the matmul chains, rows 0-15 of ``a`` [M, K],
the whole ``b`` [K, N] (bf16 values as float32) and rows 0-15 of the
[M, N] output.

Then it runs ``main`` once more from the same seed with every
``fori_loop`` cut to ``SHORT`` links and stores each f32 chain's rows
0-15 as ``<name>/out_short``: at full depth the broadcast chains
overflow to inf and the reciprocal and divide chains sit at their fixed
point, so only the short depth shows their values.
tests/test_torch_vpu_probe.py holds the port's plain chains
(madrona_mp_env_tpu_torch/tools/vpu_probe.py) to both.

Regenerate (only after a deliberate change of the JAX probe):

    JAX_PLATFORMS=cpu python tests/fixtures_torch/make_vpu_fixture.py
"""

from __future__ import annotations

import functools
import os
import sys
from unittest import mock

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
PATH = os.path.join(HERE, "vpu_probe_chains.npz")
SEED = 0
ROWS = 16
SHORT = 8  # links of the short pass (vpu_probe.SHORT in the port)
# the probe's timed calls, in main's order (the port's names)
CHAINS = ("fma_full_tile", "mul_full_tile", "fma_lane_bcast",
          "fma_sublane_bcast", "recip_approx_add", "div_exact_add",
          "cmp_sel_add", "fan_epilogue", "matmul_k8", "matmul_k128")


def main():
    sys.path.insert(0, REPO)
    import jax

    jax.config.update("jax_platforms", "cpu")
    from madrona_mp_env_tpu.tools import vpu_probe as vp

    calls = []

    def one_call(fn, *args, iters=20, warmup=3):
        out = jax.block_until_ready(fn(*args))
        calls.append([np.asarray(x, np.float32) for x in (*args, out)])
        return 1.0

    interpret = functools.partial(vp.pl.pallas_call, interpret=True)
    fori_loop = jax.lax.fori_loop

    def short_loop(lo, hi, body, init):
        return fori_loop(lo, min(hi, lo + SHORT), body, init)

    runs = []
    for cut in (False, True):
        calls = []
        np.random.seed(SEED)
        with mock.patch.object(vp, "_timeit", one_call), \
                mock.patch.object(vp.pl, "pallas_call", interpret), \
                mock.patch.object(jax.lax, "fori_loop",
                                  short_loop if cut else fori_loop):
            vp.main()
        if len(calls) != len(CHAINS):
            raise RuntimeError(f"expected {len(CHAINS)} timed calls, got "
                               f"{len(calls)}")
        runs.append(calls)
    out = {}
    for name, (a, b, o), (_, _, o_short) in zip(CHAINS, *runs):
        out[f"{name}/a"] = a[:ROWS]
        out[f"{name}/b"] = b if name.startswith("matmul") else b[:ROWS]
        out[f"{name}/out"] = o[:ROWS]
        if not name.startswith("matmul"):
            out[f"{name}/out_short"] = o_short[:ROWS]
    np.savez_compressed(PATH, **out)
    print(f"wrote {PATH} ({os.path.getsize(PATH)} bytes)")


if __name__ == "__main__":
    main()
