"""P1: issue-rate probes, the op rates the raycast kernels are built on.

    python -m madrona_mp_env_tpu_torch.tools.vpu_probe [--seed 0] \
        [--loop 2048] [--mm-depth 64] [--iters 20] [--device cuda|cpu]

The port of the JAX package's tools/vpu_probe.py. Each chain runs
serially dependent on a resident 256 x 256 f32 tile, so its time is
compute issue rate: one tile element per thread, its chain in registers
(csrc/vpu_probe.cu vpu_chain), ``LOOP`` = 2048 links deep (the fan
epilogue ``LOOP // 8``). The chains, as the TPU probe names and counts
them: fma and mul over the full tile; fma with a lane broadcast
(``acc[:, 0:1]``, column 0 of the row) and a sublane broadcast
(``acc[0:1, :]``, row 0 of the column), which pass that element through
shared memory with one barrier per link; the approximate reciprocal
(``rcp.approx.f32``) and the IEEE divide, each with an add and counted as
one op; compare-select-add, counted as 3; the fan epilogue in Gpairs/s.
Then the bf16 matmul chains (vpu_mma: ``mma.sync`` m16n8k16, f32
accumulate), 64 links of M 2048 x K 8 / 128 x N 768, in Gout/s and
TMAC/s, MACs counted at K = 8 although the kernel pads K to 16. Each
link reads the first column of the previous product as the TPU chain
reads ``acc[:, 0:1]``, but of its own 32-column block's tile
(``MM_COLS``): ``a + acc[:, first].astype(bf16) * 0`` is ``a`` for every
finite product, so the chain's result is ``a @ b`` either way.

Every chain has a plain version (``_chain_plain``, ``_mm_plain``) on the
same inputs: the kernels repeat the mul, divide and select chains bit for
bit; the fma chains contract to one FFMA where the plain version rounds
twice, the reciprocal chains use ``rcp.approx`` where it is exact, and
the matmul chains sum in the tensor cores' order: each prints its
largest error. On the card each chain is held to it twice: at its depth,
where the broadcast chains are inf in every element and the reciprocal
and divide chains sit at their fixed point, with NaN, +inf and -inf in
the same places (``chain_error``); and at ``SHORT`` links, where every
element is finite and those chains are still off their fixed point
(``check_short``). Inputs are ``np.random.rand(...) + 0.5`` (the matmuls'
``np.random.rand`` in bf16) drawn from ``--seed`` in the TPU probe's
order; that probe draws them unseeded. Times are CUDA events around
``--iters`` back-to-back launches after 3 warm-up launches (``_timeit``),
so a chain of a few microseconds also shows the gap between launches;
each kernel's device time comes from ``kernel_bench.device_ms``
(torch.profiler, or CUDA events around single calls when the profiler
returns no event of the kernel: ``device_ms_by``); ``loop_sass``
prints each kernel's loop body from the built library (``cuobjdump
-sass``), per link, beside its rate. ``--device cpu`` runs
the plain versions (reduce ``--loop`` and ``--mm-depth`` there).
"""

from __future__ import annotations

import argparse
import collections
import json
import re
import shutil
import subprocess

import numpy as np
import torch

from madrona_mp_env_tpu_torch.ops import cuda_build, raycast
from madrona_mp_env_tpu_torch.ops.raycast import _f32, _ptr, _stream
from madrona_mp_env_tpu_torch.sim.env import resolve_device
from madrona_mp_env_tpu_torch.tools.kernel_bench import (
    device_line, device_ms, time_ms)

LOOP = 2048  # the chains' depth
ROWS, COLS = 256, 256  # working tile (f32)
MM_DEPTH = 64
MM_SHAPES = ((8, 2048, 768), (128, 2048, 768))  # (K, M, N)
MM_COLS = 32  # the mma kernel's column block: its first column feeds a link
UNROLL = 8  # links per main-loop iteration of vpu_chain (csrc/vpu_probe.cu)
# the depth of each chain's second check: the whole tile is still finite
# (at LOOP the broadcast chains overflow to inf) and the reciprocal and
# divide chains are still ~0.38^8 = 4e-4 from their fixed point (at LOOP
# they sit on it whatever the depth)
SHORT = 8
INF = float("inf")

# name -> (the kernel's chain code, ops per link as the TPU probe counts
# them, the TPU probe's label)
CHAINS = {
    "fma_full_tile": (0, 1, "fma_full_tile"),
    "mul_full_tile": (1, 1, "mul_full_tile"),
    "fma_lane_bcast": (2, 1, "fma_lane_bcast([R,1]xT)"),
    "fma_sublane_bcast": (3, 1, "fma_sublane_bcast([1,T]xR)"),
    "recip_approx_add": (4, 1, "recip_approx+add (as 1 op)"),
    "div_exact_add": (5, 1, "div_exact+add (as 1 op)"),
    "cmp_sel_add": (6, 3, "cmp_sel_add (3 ops)"),
    "fan_epilogue": (7, 1, "fan_epilogue (pairs/s)"),
}
# the kernel's bars against its plain version, largest |kernel - plain| /
# max(1, |plain|) with the same elements finite: one FFMA against two
# roundings per link, compounded over up to 2048 links; rcp.approx.f32 errs
# by at most 1 ulp. The other chains (mul, divide, select) are bit-equal.
BARS = {"fma_full_tile": 1e-3, "fma_lane_bcast": 1e-3,
        "fma_sublane_bcast": 1e-3, "recip_approx_add": 1e-5,
        "fan_epilogue": 1e-5}
# the matmul chains: sums of K bf16 products in another order
MM_BAR = 1e-4


def _link(name):
    """One link of chain ``name``, acc -> acc, as the TPU probe writes it
    (exact reciprocals for its approximate ones)."""
    def epilogue(acc, a, b):
        t = acc * torch.reciprocal(b)
        u = a + t * b
        v = b + t * a
        hit = (t > 0.0) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
        return torch.minimum(
            acc, torch.where(hit, t, torch.full_like(t, INF))) + a

    return {
        "fma_full_tile": lambda acc, a, b: acc * b + a,
        "mul_full_tile": lambda acc, a, b: acc * b,
        "fma_lane_bcast": lambda acc, a, b: acc[:, 0:1] * b + acc,
        "fma_sublane_bcast": lambda acc, a, b: acc[0:1, :] * b + acc,
        "recip_approx_add": lambda acc, a, b: torch.reciprocal(acc + b),
        "div_exact_add": lambda acc, a, b: b / (acc + b),
        "cmp_sel_add": lambda acc, a, b: torch.where(acc > b, acc, b) + a,
        "fan_epilogue": epilogue,
    }[name]


def chain_loop(name, loop=LOOP):
    """The TPU probe's depth of chain ``name``: ``loop``, the fan
    epilogue ``loop // 8``."""
    return loop // 8 if name == "fan_epilogue" else loop


def _chain_plain(name, a, b, loop):
    """The chain ``name`` on a, b [rows, cols], ``loop`` links from acc =
    a."""
    link, acc = _link(name), a
    for _ in range(loop):
        acc = link(acc, a, b)
    return acc


def _chain_entry(name):
    code = CHAINS[name][0]

    def vpu_chain(a, b, loop: int = LOOP):
        """``loop`` links of the chain on a, b [rows, cols] f32 -> acc.
        CUDA: csrc/vpu_probe.cu vpu_chain (one element per thread)."""
        if not raycast._route(a):
            return _chain_plain(name, a, b, loop)
        rows, cols = a.shape
        if b.shape != a.shape or loop % UNROLL:
            raise ValueError(f"vpu_chain {name}: a {tuple(a.shape)}, "
                             f"b {tuple(b.shape)}, loop {loop} (a "
                             f"multiple of {UNROLL})")
        x, y = _f32(a), _f32(b)
        out = torch.empty_like(x)
        cuda_build.check(cuda_build.launcher("vpu_chain")(
            code, _ptr(x), _ptr(y), _ptr(out), rows, cols, loop,
            _stream(a)), f"vpu_chain {name}")
        vpu_chain.launches += 1
        return out

    vpu_chain.__name__ = f"vpu_chain_{name}"
    vpu_chain.launches = 0
    return vpu_chain


def _mm_plain(a, b, depth, cols=MM_COLS):
    """``depth`` links of acc = (a + acc[:, first].bf16 * 0) @ b, first
    the first column of each ``cols``-wide block of acc, a [M, K] and b
    [K, N] bf16 -> acc [M, N] f32 (products of the bf16 values in f32)."""
    M, K = a.shape
    N = b.shape[1]
    blocks = b.float().reshape(K, N // cols, cols).permute(1, 0, 2)
    acc = torch.zeros((M, N), dtype=torch.float32, device=a.device)
    for _ in range(depth):
        feed = acc[:, ::cols].T[:, :, None].to(torch.bfloat16) * 0.0
        x = (a[None] + feed).float()  # [blocks, M, K]
        acc = torch.bmm(x, blocks).permute(1, 0, 2).reshape(M, N)
    return acc


def _mm_entry(K):
    def vpu_mma(a, b, depth: int = MM_DEPTH):
        """``depth`` chained bf16 products, a [M, K] and b [K, N] -> [M,
        N] f32. CUDA: csrc/vpu_probe.cu vpu_mma (mma.sync m16n8k16)."""
        if not raycast._route(a):
            return _mm_plain(a, b, depth)
        M, N = a.shape[0], b.shape[1]
        if a.shape[1] != K or b.shape[0] != K or a.dtype != torch.bfloat16 \
                or b.dtype != torch.bfloat16 or M % 64 or N % MM_COLS:
            raise ValueError(f"vpu_mma K={K}: a {a.dtype} "
                             f"{tuple(a.shape)}, b {b.dtype} "
                             f"{tuple(b.shape)}")
        x, y = a.contiguous(), b.contiguous()
        out = torch.empty((M, N), dtype=torch.float32, device=a.device)
        cuda_build.check(cuda_build.launcher("vpu_mma")(
            _ptr(x), _ptr(y), _ptr(out), M, N, K, depth, _stream(a)),
            f"vpu_mma K={K}")
        vpu_mma.launches += 1
        return out

    vpu_mma.__name__ = f"vpu_mma_k{K}"
    vpu_mma.launches = 0
    return vpu_mma


# one entry (and launch count) per chain and per matmul depth K
ENTRIES = {name: _chain_entry(name) for name in CHAINS}
MM_ENTRIES = {K: _mm_entry(K) for K, _, _ in MM_SHAPES}


def _timeit(fn, *args, iters=20):
    """(seconds per call of ``fn(*args)`` by kernel_bench.time_ms: CUDA
    events around ``iters`` back-to-back calls after 3 warm-up calls, the
    host clock on the CPU; the last call's output)."""
    last = [None]

    def call():
        last[0] = fn(*args)

    return time_ms(call, iters, args[0].device) / 1e3, last[0]


def chain_inputs(rs, n_in=2, rows=ROWS, cols=COLS, device="cpu"):
    """The TPU probe's chain inputs: ``np.random.rand(rows, cols) + 0.5``
    in f32, drawn from ``rs`` (a np.random.RandomState)."""
    return [torch.as_tensor((rs.rand(rows, cols) + 0.5).astype(np.float32),
                            device=device) for _ in range(n_in)]


def mm_inputs(rs, K, M, N, device="cpu"):
    """The TPU probe's matmul inputs: ``np.random.rand`` as bf16."""
    return tuple(torch.as_tensor(rs.rand(*s), device=device).to(
        torch.bfloat16) for s in ((M, K), (K, N)))


def chain_error(got, want):
    """(largest |got - want| where both are finite, the same divided by
    max(1, |want|)); both inf unless every element that is not finite is
    so in both, of the same class (NaN, +inf, -inf)."""
    same = (torch.isnan(got) == torch.isnan(want)) \
        & (torch.isposinf(got) == torch.isposinf(want)) \
        & (torch.isneginf(got) == torch.isneginf(want))
    if not bool(same.all()):
        return INF, INF
    both = torch.isfinite(got) & torch.isfinite(want)
    if not bool(both.any()):
        return 0.0, 0.0
    err = (got - want).abs()[both]
    return (float(err.max()),
            float((err / want.abs()[both].clamp(min=1.0)).max()))


def check_chain(name, got, want, bar, finite=False):
    """Raise unless ``got`` is within ``bar`` of ``want`` (bit-equal for
    bar 0), and, with ``finite``, unless every element of both is finite:
    returns chain_error's pair."""
    err = chain_error(got, want)
    if (bar == 0 and not torch.equal(got, want)) or err[1] > bar:
        raise AssertionError(f"P1 {name}: error {err} against its plain "
                             f"version beyond {bar}")
    if finite and not bool(torch.isfinite(got).all()
                           and torch.isfinite(want).all()):
        raise AssertionError(f"P1 {name}: elements not finite where the "
                             f"chain keeps them finite")
    return err


def check_short(name, a, b):
    """Chain ``name`` on a, b, SHORT links deep, against its plain version:
    every element finite and within the chain's bar (bit-equal for the
    mul, divide and select chains) -> chain_error's pair."""
    return check_chain(f"{name} at {SHORT} links", ENTRIES[name](a, b, SHORT),
                       _chain_plain(name, a, b, SHORT),
                       BARS.get(name, 0.0), finite=True)


def _run(chain, ops_per_iter, n_in=2, rows=ROWS, cols=COLS, loop=LOOP, *,
         rs, device, iters=20):
    """``chain`` (a name of CHAINS) chained ``loop`` times on fresh inputs
    -> {rate in Gops/s, ms}; on the card also its error against its
    plain version (check_chain: within BARS, else bit for bit; at ``loop``
    and at SHORT links, check_short) and its device time."""
    a, b = chain_inputs(rs, n_in, rows, cols, device)
    fn = ENTRIES[chain]
    dt, out = _timeit(fn, a, b, loop, iters=iters)
    res = {"rate": ops_per_iter * rows * cols * loop / dt / 1e9,
           "ms": dt * 1e3}
    if device.type == "cuda":
        res["err"], res["rel_err"] = check_chain(
            chain, out, _chain_plain(chain, a, b, loop),
            BARS.get(chain, 0.0))
        res["short_err"], res["short_rel_err"] = check_short(chain, a, b)
        res["device_ms"], res["device_ms_by"] = device_ms(
            lambda: fn(a, b, loop), "vpu_", reps=20)
        res["device_rate"] = res["rate"] * res["ms"] / res["device_ms"]
    return res


def _run_mm(K, M, N, depth, *, rs, device, iters=20):
    a, b = mm_inputs(rs, K, M, N, device)
    dt, out = _timeit(MM_ENTRIES[K], a, b, depth, iters=iters)
    outs = depth * M * N
    res = {"rate": outs / dt / 1e9, "tmac_s": outs * K / dt / 1e12,
           "ms": dt * 1e3}
    if device.type == "cuda":
        res["err"], res["rel_err"] = check_chain(
            f"matmul K={K}", out, _mm_plain(a, b, depth), MM_BAR,
            finite=True)
        res["device_ms"], res["device_ms_by"] = device_ms(
            lambda: MM_ENTRIES[K](a, b, depth), "vpu_", reps=20)
        res["device_tmac_s"] = res["tmac_s"] * res["ms"] / res["device_ms"]
    return res


_SASS_FUNC = re.compile(r"Function\s*:\s*(\S+)")
_SASS_INSN = re.compile(r"/\*([0-9a-f]+)\*/\s+(.+?)\s*;")
_SASS_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_SASS_BRA = re.compile(r"\bBRA\b.*?(?:`\((\.L_x_\d+)\)|(0x[0-9a-f]+))")


def parse_sass(text):
    """``cuobjdump -sass`` output -> {function: Counter of the opcodes of
    its largest loop body} (the instructions from a backward branch's
    target to the branch; an opcode is its first two dotted parts, e.g.
    MUFU.RCP, HMMA.16816)."""
    funcs, name, insns, labels, pending = {}, None, [], {}, []

    def close():
        if name is None:
            return
        best = []
        for addr, text_ in insns:
            m = _SASS_BRA.search(text_)
            if not m:
                continue
            target = labels.get(m.group(1)) if m.group(1) \
                else int(m.group(2), 16)
            if target is not None and target <= addr:
                body = [t for a, t in insns if target <= a <= addr]
                if len(body) > len(best):
                    best = body
        ops = collections.Counter()
        for t in best:
            op = re.sub(r"^@!?\w+\s+", "", t).split()[0]
            ops[".".join(op.split(".")[:2])] += 1
        funcs[name] = ops

    for line in text.splitlines():
        m = _SASS_FUNC.search(line)
        if m:
            close()
            name, insns, labels, pending = m.group(1), [], {}, []
            continue
        m = _SASS_LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = _SASS_INSN.search(line)
        if m and name is not None:
            addr = int(m.group(1), 16)
            for lab in pending:
                labels[lab] = addr
            pending = []
            insns.append((addr, m.group(2)))
    close()
    return funcs


def loop_sass():
    """{chain name or vpu_mma_k<K>: {opcode: count per link}} of the built
    library's loop bodies (``cuobjdump -sass``; vpu_chain's body is
    UNROLL links, vpu_mma's one)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    cuda_build.launcher("vpu_chain")  # built on first use
    text = subprocess.run([tool, "-sass", cuda_build.lib_path("vpu_probe")],
                          capture_output=True, text=True, timeout=120,
                          check=True).stdout
    codes = {c: n for n, (c, _, _) in CHAINS.items()}
    out = {}
    for func, ops in parse_sass(text).items():
        m = re.search(r"vpu_(chain|mma)_kernelILi(\d+)E", func)
        if not m:
            continue
        if m.group(1) == "chain":
            key, links = codes[int(m.group(2))], UNROLL
        else:
            key, links = f"vpu_mma_k{8 if m.group(2) == '1' else 128}", 1
        out[key] = {op: n / links for op, n in sorted(ops.items())}
    missing = set(CHAINS) | {f"vpu_mma_k{K}" for K, _, _ in MM_SHAPES}
    missing -= set(out)
    if missing:
        raise RuntimeError(f"no loop body found in the SASS of {missing}")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--loop", type=int, default=LOOP)
    ap.add_argument("--mm-depth", type=int, default=MM_DEPTH)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    rs = np.random.RandomState(args.seed)
    print(device_line(device))
    print(f"loop={args.loop} tile={ROWS}x{COLS} mm_depth={args.mm_depth}",
          flush=True)
    sass = loop_sass() if device.type == "cuda" else {}
    res = {}
    for name, (_, ops, label) in CHAINS.items():
        r = _run(name, ops, loop=chain_loop(name, args.loop), rs=rs,
                 device=device,
                 iters=args.iters)
        unit = "Gpairs/s" if name == "fan_epilogue" else "Gops/s"
        print(f"{label:34s} {r['rate']:8.1f} {unit}  {r['ms']:.4f} ms",
              flush=True)
        if "err" in r:
            print(f"{'':34s} device {r['device_ms']:.4f} ms "
                  f"({r['device_ms_by']}): "
                  f"{r['device_rate']:8.1f} {unit}; max err {r['err']:.6g}"
                  f" (rel {r['rel_err']:.3g}; at {SHORT} links "
                  f"{r['short_err']:.6g}, rel {r['short_rel_err']:.3g})\n"
                  f"{'':34s} SASS per link: {sass[name]}", flush=True)
        res[name] = {k: r[k] for k in ("rate", "ms", "err", "rel_err",
                                       "short_err", "short_rel_err",
                                       "device_ms", "device_ms_by",
                                       "device_rate")
                     if k in r}
    for K, M, N in MM_SHAPES:
        r = _run_mm(K, M, N, args.mm_depth, rs=rs, device=device,
                    iters=args.iters)
        name = f"vpu_mma_k{K}"
        print(f"matmul_M{M}_K{K}_N{N:28d}"[:34]
              + f" {r['rate']:8.1f} Gout/s  {r['tmac_s']:6.2f} TMAC/s "
              f"(K = {K} MACs)  {r['ms']:.4f} ms", flush=True)
        if "err" in r:
            print(f"{'':34s} device {r['device_ms']:.4f} ms "
                  f"({r['device_ms_by']}): "
                  f"{r['device_tmac_s']:6.2f} TMAC/s; max err {r['err']:.6g}"
                  f" (rel {r['rel_err']:.3g})\n{'':34s} SASS per link: "
                  f"{sass[name]}", flush=True)
        res[name] = {k: r[k] for k in ("rate", "tmac_s", "ms", "err",
                                       "rel_err", "device_ms",
                                       "device_ms_by", "device_tmac_s")
                     if k in r}
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
