"""P1, the issue-rate probe of the port
(madrona_mp_env_tpu_torch/tools/vpu_probe.py), on the CPU, against the
JAX probe's own outputs (tests/fixtures_torch/vpu_probe_chains.npz,
written by make_vpu_fixture.py through the Pallas interpreter with
numpy's generator seeded).

The port draws the JAX probe's inputs from the same seed in the same
order. Each plain chain runs on rows 0-15 of the tile (each row depends
on itself and, for the sublane broadcast, on row 0) at two depths, and
is held to the JAX chain's rows at both:

- at full depth, where the broadcast chains are inf in every element
  and the reciprocal and divide chains sit at their fixed point, so
  these only check the depth's non-finite pattern (NaN, +inf and -inf
  in the same places, chain_error);
- at ``vpu_probe.SHORT`` = 8 links, where every element is finite and
  those chains are still far from their fixed point.

At either depth:

- mul, IEEE divide, select-add, the broadcast chains at full depth and
  the fan epilogue: bit for bit (measured; no epilogue link hits, so its
  reciprocal never decides). XLA's CPU backend flushes subnormals to
  zero, so the mul chain (a * b^2048 passes through them) is compared
  with torch's flush enabled around it;
- the fma chains otherwise within 1e-4 * max(1, |x|), because XLA may
  contract ``acc * b + a`` into one FMA (measured 2.55e-5 at full depth,
  4.0e-7 at 8 links);
- the reciprocal chain within 1e-2 relative: the interpreter's
  ``pl.reciprocal(approx=True)`` is approximate on the CPU too (measured
  5.0e-3 and 4.6e-3), the plain version exact;
- the bf16 matmul chains within 1e-5 * max(1, |x|): the same bf16
  products summed in another order (measured 2.4e-7 and 1.5e-5 absolute
  at K = 8 and 128).

The probe's ``main --device cpu`` runs at reduced depth, and the SASS
loop-body parser is checked on both of cuobjdump's branch forms.
"""

import os
import sys

import numpy as np
import pytest
import torch

from madrona_mp_env_tpu_torch.tools import vpu_probe as vp

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "fixtures_torch"))
from torch_threads import one_thread_under_xdist  # noqa: E402,F401

FIXTURE = os.path.join(HERE, "fixtures_torch", "vpu_probe_chains.npz")
ROWS = 16
SEED = 0  # make_vpu_fixture.py's
# the chains held to a tolerance (relative to max(1, |x|)); the rest exact
TOL = {"fma_full_tile": 1e-4, "recip_approx_add": 1e-2}
SHORT_TOL = {**TOL, "fma_lane_bcast": 1e-4, "fma_sublane_bcast": 1e-4}
MM_TOL = 1e-5


@pytest.fixture(scope="module")
def fx():
    return dict(np.load(FIXTURE))


@pytest.fixture(scope="module")
def inputs():
    """The port's draws from SEED in the JAX probe's order: {chain: (a,
    b)} and {K: (a, b)}."""
    rs = np.random.RandomState(SEED)
    chains = {name: vp.chain_inputs(rs) for name in vp.CHAINS}
    mms = {K: vp.mm_inputs(rs, K, M, N) for K, M, N in vp.MM_SHAPES}
    return chains, mms


def test_inputs_equal_jax(fx, inputs):
    chains, mms = inputs
    for name, (a, b) in chains.items():
        assert np.array_equal(a[:ROWS].numpy(), fx[f"{name}/a"])
        assert np.array_equal(b[:ROWS].numpy(), fx[f"{name}/b"])
    for K, (a, b) in mms.items():
        assert np.array_equal(a[:ROWS].float().numpy(), fx[f"matmul_k{K}/a"])
        assert np.array_equal(b.float().numpy(), fx[f"matmul_k{K}/b"])


@pytest.mark.parametrize("name", list(vp.CHAINS))
def test_chain_matches_jax(fx, name):
    a, b = (torch.as_tensor(fx[f"{name}/{k}"]) for k in ("a", "b"))
    want = torch.as_tensor(fx[f"{name}/out"])
    loop = vp.chain_loop(name)
    flush = name == "mul_full_tile"
    # the full depth leaves these with no finite element
    assert bool(torch.isfinite(want).any()) == (name not in (
        "fma_lane_bcast", "fma_sublane_bcast"))
    if flush:
        torch.set_flush_denormal(True)
    try:
        got = vp._chain_plain(name, a, b, loop)
    finally:
        if flush:
            torch.set_flush_denormal(False)
    if name not in TOL:
        assert torch.equal(got, want)
        return
    _, rel = vp.chain_error(got, want)
    assert rel <= TOL[name]
    assert bool(torch.isfinite(want).any())


@pytest.mark.parametrize("name", list(vp.CHAINS))
def test_short_chain_matches_jax(fx, name):
    """Each chain at SHORT links, every element finite and off the full
    depth's values."""
    a, b = (torch.as_tensor(fx[f"{name}/{k}"]) for k in ("a", "b"))
    want = torch.as_tensor(fx[f"{name}/out_short"])
    assert bool(torch.isfinite(want).all())
    assert not torch.equal(want, torch.as_tensor(fx[f"{name}/out"]))
    got = vp._chain_plain(name, a, b, vp.SHORT)
    if name not in SHORT_TOL:
        assert torch.equal(got, want)
    else:
        assert vp.chain_error(got, want)[1] <= SHORT_TOL[name]
    vp.check_chain(name, vp.ENTRIES[name](a, b, vp.SHORT), got,
                   vp.BARS.get(name, 0.0), finite=True)


@pytest.mark.parametrize("got, ok", [
    ([1.0, float("inf"), float("nan")], True),
    ([1.0, float("-inf"), float("nan")], False),
    ([1.0, float("nan"), float("inf")], False),
    ([1.0, 2.0, float("nan")], False),
])
def test_chain_error_needs_the_same_non_finite_class(got, ok):
    want = torch.tensor([1.0, float("inf"), float("nan")])
    assert (vp.chain_error(torch.tensor(got), want) == (0.0, 0.0)) == ok


def test_check_chain_finite():
    inf = torch.full((2, 2), float("inf"))
    assert vp.check_chain("all inf", inf, inf.clone(), 0.0) == (0.0, 0.0)
    with pytest.raises(AssertionError, match="not finite"):
        vp.check_chain("all inf", inf, inf.clone(), 0.0, finite=True)


@pytest.mark.parametrize("K", [8, 128])
def test_matmul_chain_matches_jax(fx, K):
    a = torch.as_tensor(fx[f"matmul_k{K}/a"]).to(torch.bfloat16)
    b = torch.as_tensor(fx[f"matmul_k{K}/b"]).to(torch.bfloat16)
    got = vp._mm_plain(a, b, vp.MM_DEPTH)
    _, rel = vp.chain_error(got, torch.as_tensor(fx[f"matmul_k{K}/out"]))
    assert rel <= MM_TOL


def test_main_runs_on_cpu():
    res = vp.main(["--device", "cpu", "--loop", "8", "--mm-depth", "1",
                   "--iters", "1"])
    assert set(res) == set(vp.CHAINS) | {"vpu_mma_k8", "vpu_mma_k128"}
    assert all(r["rate"] > 0.0 and r["ms"] > 0.0 for r in res.values())


# cuobjdump prints branch targets as addresses or, in newer toolkits, as
# labels; a loop body runs from the backward branch's target to the branch
SASS_ADDR = """
        code for sm_90a
                Function : _ZN12_GLOBAL__N_116vpu_chain_kernelILi0EEEvPKfS2_Pfii
        /*0000*/                   LDC R1, c[0x0][0x28] ;       /* 0x00000a00ff017b82 */
        /*0010*/                   FFMA R7, R5, R11, R4 ;       /* 0x0000000b05077223 */
        /*0020*/                   FFMA R11, R5, R7, R4 ;       /* 0x0000000705077223 */
        /*0030*/                   UIADD3 UR4, UR4, 0x8, URZ ;  /* 0x0000000804047890 */
        /*0040*/              @!P0 BRA 0x10 ;                   /* 0xfffffffc00e07947 */
        /*0050*/                   EXIT ;                       /* 0x000000000000794d */
        /*0060*/                   BRA 0x60;                    /* 0xfffffffc00fc7947 */
"""
SASS_LABEL = """
                Function : _ZN12_GLOBAL__N_114vpu_mma_kernelILi8EEEvPKfS2_Pfiii
        /*0000*/                   MOV R1, c[0x0][0x28] ;
.L_x_0:
        /*0010*/                   SHFL.IDX PT, R3, R2, R0, 0x1f ;
        /*0020*/                   HMMA.16816.F32.BF16 R4, R8, R12, RZ ;
        /*0030*/                   HMMA.16816.F32.BF16 R4, R8, R14, R4 ;
        /*0040*/               @P0 BRA `(.L_x_0) ;
        /*0050*/                   EXIT ;
"""


def test_parse_sass_loop_bodies():
    got = vp.parse_sass(SASS_ADDR + SASS_LABEL)
    chain, mma = got.values()
    assert chain == {"FFMA": 2, "UIADD3": 1, "BRA": 1}
    assert mma == {"SHFL.IDX": 1, "HMMA.16816": 2, "BRA": 1}
