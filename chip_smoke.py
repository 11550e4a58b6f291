#!/usr/bin/env python3
"""Drive the PyTorch port (madrona_mp_env_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run loudly:

1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
2. build every CUDA kernel from csrc/ (one nvcc per source, all at once);
3. each kernel against its plain PyTorch version on the card, on the
   inputs of every launch that one real step makes at 1024 worlds of Zone
   6v6 (captured where the sim calls each entry), with its time, the plain
   version's time and its bound, each summed over the step's launches of
   that entry. On data/simple_map: K1 hitscan rays, K2 sensor fans, K3
   sensor rays vs capsules, K4 culled (the L1 casts), K4' packed (the L2,
   L3 and fall casts), K5 the fused scalar tail, K4 dense on the same
   step taken with MPENV_SC_PACK=0, and K9 (the sensor fans over the
   sensor-ray tables) on the same step taken with MPENV_FAN_V9=1, with
   how often its t equals K2's on the same rays (hits and misses must
   agree on >= 99.5%); then the unfused system chain against the fused
   order through tail_fused_plain, bit for bit, on the step's tail
   inputs. On data/town_map (6,144 triangles, PVS tables): K1, K3, K4
   culled, K4', K5, K6 the cell-culled sensor fans, and K2 over the whole
   soup on K6's fans, with how often the two agree (the PVS's quality at
   full width). K2 and K6 (the register-blocked sweep,
   csrc/fan_sweep_rb.cuh) are held bit for bit against their plain
   versions and their predecessors (P2's exact entry, fan_culled_v1),
   timed beside them in turns (new, old, old, new), with their device
   time (torch.profiler), ptxas' registers and spills, the floor at one
   f32 instruction per operation, and K6's helper launches (the cell
   order). Zone 3v3 (team size 3: a LOS run of 12 rays, not a
   multiple of 8) on each map: K7, the stacked-direction fan over the
   whole soup, and K5 on one real step's launches; K8 on that step's L1
   casts over the whole soup and K3x on its sensor rays with explicit
   origins (equal to K3's hits too), and the unfused tail chain at team
   size 3. The kernel bench's shapes (tools/kernel_bench.py make_inputs,
   1024 worlds, team sizes 6 and 3, each map): K7, K8 with and without
   normals and K3x, each bit-equal to its plain version, then the kernel
   bench itself, whose launches those rows count. The probes: P3, the
   fused movement (csrc/move_fused.cu), on each map under both cast
   routes on the state a step hands the movement pair (reset + 5 steps at
   1024 worlds), bit-equal to its plain version and (culled) to the
   step's own split pair on the kernels, with the split pair's time and
   CUDA launches beside the fused launch's; P5 (K9 through cand_idx, on
   tables gathered beforehand with and without the gather), P6 (K9's
   candidates staged all at once or 8 at a time, the dense fan and the
   v9 end-to-end path beside them) and P2 (K2's sweep with an exact
   divide, an IEEE reciprocal, rcp.approx, the direction dots alone, the
   epilogue alone and 8-row chunks; one torch.matmul of the direction
   dots beside them) at 12,288 fans x 104 rays on simple_map, each
   bit-equal to its plain version (rcp.approx: its error printed); P4
   (the sphere cast with its dot products as 3xTF32 mma.sync, 24,576
   casts on simple_map) within its bars of its plain version, with K4
   dense's time and the TPU probe's parity against it, and the two
   products as torch.matmul beside it; P1 (the issue-rate chains on a
   256 x 256 tile, 2048 links deep: mul, divide and select bit-equal, the
   fma and rcp.approx chains within their bars; the bf16 mma.sync chains,
   64 links of 2048 x 8 / 128 x 768, with 64 torch.matmul calls beside
   them); then each probe's main, whose launches those rows count (P1's
   main prints each kernel's loop body from cuobjdump -sass);
4. the simple_map path: Env(device="cuda") at 1024 worlds, reset + 100
   steps of bench.py's run-and-shoot action mix, every launch counter
   zeroed before and read after: K1, K2, K3, K4 culled, K4' and K5 must
   launch (K2 101 times), K4 dense, K6, K9 and the fused movement P3
   must not; env-steps/s beside the card's
   name and limit; then CUDA launches per step from torch.profiler, with
   the fused tail and, for comparison in the same process, with the
   unfused chain it replaced; then the same path with MPENV_FAN_V9=1,
   where K9 must launch and K2 must not;
5. the crossplay eval: EvalManager on the card at 1024 worlds with P = 2
   policies at full width (weights made from seeds: the trained
   checkpoint needs JAX to read), 100 sampled steps, every counter zeroed
   before and read after; agent-steps/s, env-steps/s and the policy
   forward's ms per step;
6. K4 dense's own path: 10 simple_map steps with MPENV_SC_PACK=0;
7. the town_map path: reset + 100 steps at 1024 worlds: K1, K3, K4
   culled, K4', K5 and K6 must launch (K6 101 times), K2 and K4 dense
   must not; then 10 steps of the forced-dense fan route
   (MPENV_FAN_CULL=0), where K2 runs 11 times over the 6,144-triangle
   soup; then Zone 3v3 on each map, reset + 50
   steps at 1024 worlds: K7 and K5 must launch, K2, K6 and K9 must not;
8. the training path: the train CLI's TrainingManager at 1024 worlds x
   40 steps per update, the LSTM-512 policy, E = 1: 3 updates of Zone 6v6
   on the default fan route (K2), 2 with MPENV_FAN_V9=1 (K9), then 1 of
   Zone 3v3 (K7) on each map; updates/s, samples/s and each update's
   rollout and PPO-update ms (CUDA events); finite losses, parameters
   that move;
9. the kernel path against the plain path: the same 4-world, 16-step env
   rollout on both maps for Zone 6v6 and Zone 3v3, the same 4-world,
   16-step eval rollout, and the trainer's 4-world, 8-step rollout and
   one PPO update, on "cuda" and on "cpu" from one seed;
10. a line of kernel results (JSON, one row per kernel and map, each with
   the path whose launches it counts; K2's and K6's rows with the keys of
   REDESIGN_KEYS), then the card line, then the last line {"ok": true,
   "device": {...}}.

Exits non-zero with no result line when there is no CUDA device or when
the port's package is not beside this script.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
from unittest import mock

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SCENE = os.path.join(REPO, "data", "simple_map")
TOWN = os.path.join(REPO, "data", "town_map")
NUM_WORLDS = 1024
NUM_STEPS = 100
FORCED_STEPS = 10  # the forced-gate paths (K4 dense, K2 on town_map)
TEAM3_STEPS = 50  # the Zone 3v3 paths
TEAM_SIZE = 6

# H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor cores, HBM3
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
# the data sheet's dense tensor-core rates (flops, a multiply-add is 2)
PEAK_TF32 = 495e12
PEAK_BF16 = 989e12
# f32 instructions per second (an FMA is one): 67 TFLOP/s / 2, i.e. 132
# SMs x 128 lanes x 1.98 GHz; special-function results (MUFU: rcp) at 16
# per SM per clock (CUDA C++ Programming Guide, compute capability 9.0)
PEAK_F32_INSNS = PEAK_F32 / 2
PEAK_SFU = 132 * 16 * 1.98e9

# f32 arithmetic operations (add, sub, mul, div, sqrt, min) per pair as the
# kernels write them (csrc/tri_math.cuh); comparisons and selects not counted
OPS_RAY_TRI = 47  # two crosses (18), four dots (20), divide, 3 scales, u+v, min
OPS_FAN_PAIR = 32  # K2 after hoisting: cross, 2 dots, divide, 3 scales, u+v, min
OPS_FAN_HOIST = 20  # per (fan, group, triangle): tvec, cross, dot
OPS_CAPSULE = 75  # 5 dots, cylinder quadratic (~20), two cap spheres (~30)
OPS_SPHERE_TRI = 330  # closest point (~80), face test (~45), 3 capsules
# K8's normal per cast, after recomputing the winner's pair terms: the
# closest point at the hit (~80), the hit centre (6), a norm and three
# divides (~9)
OPS_SC_NORMAL = 95
# K5 per agent (csrc/tail_fused.cu): autoheal 2, zone distance 9,
# membership frame 7, reward terms 19, blend 4, spread 2 per teammate and
# 5 per teammate pair
OPS_TAIL_AGENT = 41
# the redesigned kernels' rows (K2, K6) also carry: their predecessor's
# time in the same call, their device time (torch.profiler), the floor at
# one f32 instruction per operation (--fmad=false: 33.5 T/s), ptxas -v's
# registers and spill bytes, and the launches of any helper per call
REDESIGN_KEYS = ("before_ms", "device_ms", "fmad_floor_ms", "registers",
                 "spill_bytes", "helper_launches", "helper_device_ms")
EVAL_WORLDS = 1024
EVAL_STEPS = 100
EVAL_POLICIES = 2


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps):
    """Mean ms per call over ``reps`` calls after a warm-up, CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timed_once(fn):
    """(fn(), ms of that one call by CUDA events): for the plain versions,
    whose ATen kernels need no build and no warm-up."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def check_equal(name, *pairs):
    """(kernel, plain) output pairs bit-equal (the kernels repeat their
    plain versions op for op, built with --fmad=false). Returns the max
    abs error over the finite values of the first pair."""
    import torch

    torch.cuda.synchronize()
    got, want = pairs[0]
    both = torch.isfinite(got) & torch.isfinite(want)
    err = float((got - want).abs()[both].max()) if bool(both.any()) else 0.0
    for i, (g, w) in enumerate(pairs):
        if not torch.equal(g, w):
            n = int((g != w).sum())
            raise AssertionError(f"{name}: output {i} differs from its "
                                 f"plain version at {n} of {w.numel()}")
    return err


def bound_ms(nbytes, nops, peak=PEAK_F32, more=()):
    """The least time for ``nbytes`` moved and ``nops`` operations at
    ``peak`` per second, plus (ops, peak) pairs ``more`` on other units
    (which may overlap it): (ms, what bounds it)."""
    b = nbytes / PEAK_BYTES
    o = max([nops / peak] + [n / p for n, p in more])
    return max(b, o) * 1e3, ("bytes" if b >= o else "operations")


def check_t(name, t_k, t_p, rel=1e-4, miss_frac=1e-5):
    """t within rel * max(1, |t|) where both hit; hit/miss disagreements at
    most miss_frac of the rays. Returns the max abs error over common
    hits."""
    import torch

    hk, hp = torch.isfinite(t_k), torch.isfinite(t_p)
    disagree = int((hk != hp).sum())
    n = t_k.numel()
    both = hk & hp
    err = (t_k - t_p).abs()[both]
    tol = rel * torch.clamp(t_p.abs()[both], min=1.0)
    bad = int((err > tol).sum())
    max_err = float(err.max()) if err.numel() else 0.0
    if bad or disagree > miss_frac * n:
        raise AssertionError(
            f"{name}: {bad} t beyond {rel}*max(1,|t|), {disagree}/{n} "
            f"hit/miss disagreements (max err {max_err})"
        )
    return max_err


def check_idx(name, i_k, i_p, gap, t_p):
    """Winner indices equal wherever the plain version's best two t differ
    by more than 1e-4 (and it hit)."""
    import torch

    decided = (gap > 1e-4) & torch.isfinite(t_p)
    wrong = int(((i_k != i_p) & decided).sum())
    if wrong:
        raise AssertionError(f"{name}: {wrong} winner indices differ")


def check_tail(got, want, rel=1e-6):
    """K5 against its plain version: integral and boolean leaves equal,
    float leaves within rel * max(1, |x|) (0 expected: the kernel repeats
    the plain version's operations). Returns the max abs float error."""
    import torch

    (sk, ck), (sp, cp) = got, want
    torch.cuda.synchronize()
    if not torch.equal(ck, cp):
        raise AssertionError("K5 new_captured differs")
    max_err = 0.0
    for name, w in sp.leaves().items():
        g = getattr(sk, name)
        if g.dtype != w.dtype or g.shape != w.shape:
            raise AssertionError(f"K5 {name}: {g.dtype} {tuple(g.shape)} vs "
                                 f"{w.dtype} {tuple(w.shape)}")
        if not w.dtype.is_floating_point:
            if not torch.equal(g, w):
                raise AssertionError(f"K5 {name} differs")
            continue
        same = (g == w) | (torch.isnan(g) & torch.isnan(w))
        e = torch.where(same, 0.0, (g.double() - w.double()).abs())
        if bool((e > rel * w.double().abs().clamp(min=1.0)).any()):
            raise AssertionError(f"K5 {name}: max abs err {float(e.max())}")
        max_err = max(max_err, float(e.max()))
    return max_err


def best_two_gap(t_pairs):
    """Second-best minus best t over the last axis (inf when < 2 hits)."""
    import torch

    two = torch.topk(t_pairs, 2, dim=-1, largest=False).values
    return two[..., 1] - two[..., 0]


def turns_ms(new, old, reps):
    """(new ms, old ms): CUDA-event means of two functions timed in turns
    (new, old, old, new), each turn ``reps`` calls after a warm-up."""
    t = [cuda_time_ms(f, reps) for f in (new, old, old, new)]
    return (t[0] + t[3]) / 2, (t[1] + t[2]) / 2


def device_ms(fn, kernel, reps=10):
    """Device ms per call of the CUDA kernels of ``fn`` whose name holds
    ``kernel`` (kernel_bench.device_ms: torch.profiler, else CUDA events
    around single calls, logged), without the host's gaps between
    calls."""
    from madrona_mp_env_tpu_torch.tools import kernel_bench

    ms, how = kernel_bench.device_ms(fn, kernel, reps)
    if how != "profiler":
        log(f"[profiler] no {kernel} event in 3 windows: its device time "
            f"by CUDA events around single calls ({ms:.4f} ms)")
    return ms


# where the step calls each kernel's entry: (sim module, name)
ENTRY_SITES = (
    ("combat", "ray_vs_tris"), ("observations", "ray_fans_vs_tris"),
    ("observations", "ray_fans_culled"),
    ("observations", "ray_fans_vs_tris_flat"),
    ("observations", "ray_fans_culled_v9"), ("observations", "fan_capsules"),
    ("movement", "sphere_cast"), ("movement", "sphere_cast_culled"),
    ("movement", "sphere_cast_packed"), ("step", "tail_fused"),
)


def _clone(x):
    import torch
    from madrona_mp_env_tpu_torch.sim.types import WorldState

    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, tuple):
        return tuple(_clone(v) for v in x)
    if isinstance(x, WorldState):
        return x.replace(**{k: v.clone() for k, v in x.leaves().items()})
    return x


def capture_step_calls(env, state, actions, expect):
    """Run one env.step with every kernel entry wrapped where the sim calls
    it; returns {entry name: [args of each call, in order]} (tensors
    cloned), so the kernels can be checked and timed on the main path's
    own launches at its own shapes. ``expect``: the entries this path
    must call (and only those)."""
    import importlib

    calls = {name: [] for _, name in ENTRY_SITES}
    saved = []
    for mod_name, name in ENTRY_SITES:
        mod = importlib.import_module(
            f"madrona_mp_env_tpu_torch.sim.{mod_name}")
        fn = getattr(mod, name)

        def rec(*args, _fn=fn, _name=name):
            calls[_name].append(_clone(args))
            return _fn(*args)

        saved.append((mod, name, fn))
        setattr(mod, name, rec)
    try:
        env.step(state, actions)
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    called = sorted(n for n, c in calls.items() if c)
    if called != sorted(expect):
        raise AssertionError(f"the step called {called}, expected "
                             f"{sorted(expect)}")
    return calls


def chunks(n, size):
    return [slice(i, min(i + size, n)) for i in range(0, n, size)]


def chunked(fn, n, size):
    """fn(slice) over chunks of the leading axis, outputs concatenated."""
    import torch

    outs = [fn(s) for s in chunks(n, size)]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(o) for o in zip(*outs))
    return torch.cat(outs)


def sc_gap(o, d, r, soup):
    """best-two gap of the dense per-triangle sweep of casts o, d."""
    from madrona_mp_env_tpu_torch.ops import raycast

    o2, d2 = o.reshape(-1, 3), d.reshape(-1, 3)
    gap = chunked(lambda s: best_two_gap(raycast._sc_pairs(
        o2[s][:, None], d2[s][:, None], r, soup.v0, soup.e1, soup.e2,
        soup.normal, soup.valid)["t_tri"]), o2.shape[0],
        max(64, 2 ** 20 // soup.num_tris))
    return gap.reshape(o.shape[:-1])


def sc_normal_plain(o, d, r, soup):
    """K8's plain version over chunks of the leading axis of o, d [N, ...,
    3], each chunk ~2^23 (cast, triangle) pairs."""
    from madrona_mp_env_tpu_torch.ops import raycast

    per = o[..., 0].numel() // o.shape[0]
    return chunked(lambda s: raycast._sphere_cast_normal_plain(
        o[s], d[s], r, soup), o.shape[0],
        max(1, 2 ** 23 // soup.num_tris // per))


def sc_dense_plain(o, d, r, soup):
    from madrona_mp_env_tpu_torch.ops import raycast

    return chunked(lambda s: raycast._sphere_cast_dense(o[s], d[s], r, soup),
                   o.shape[0], max(64, 2 ** 19 // soup.num_tris))


def kernel_row(scene, name, source, replaces, entry, err, ms, pms, nbytes,
               nops, shapes, peak=PEAK_F32, more=(), **extra):
    """One row of the kernels line, its bound from ``nbytes`` and ``nops``
    (bound_ms), logged; ``scene`` tags it."""
    bms, by = bound_ms(nbytes, nops, peak, more)
    row = dict(name=f"{name} [{scene}]", route="cuda", source=source,
               replaces=replaces, entry=entry, max_abs_err=err, ms=ms,
               plain_ms=pms, bound_ms=bms, bound_by=by, shapes=shapes,
               scene=scene, **extra)
    log(f"[kernel] {row['name']} at {shapes}: max_abs_err {err:.3g} "
        f"kernel {ms:.4f} ms/step plain {pms:.4f} ms/step bound "
        f"{bms:.4f} ms ({by})"
        + "".join(f" {k} {v}" for k, v in extra.items()))
    return row


class KernelPhase:
    """Each kernel against its plain version on the card, on the inputs of
    every launch one real step makes (captured from the main path at 1024
    worlds). ms, plain_ms and bound_ms are per step: the sum over that
    step's launches of the entry. ``scene`` tags every row."""

    def __init__(self, soup, scene):
        self.scene, self.results = scene, []
        self.soup = soup
        self.T_real = int(self.soup.valid.sum())

    def record(self, *args, **kw):
        row = kernel_row(self.scene, *args, **kw)
        self.results.append(row)
        return row

    def k1(self, calls):
        from madrona_mp_env_tpu_torch.ops import raycast

        soup = self.soup
        (o1, d1, _), = calls["ray_vs_tris"]
        R1 = o1[..., 0].numel()
        err = check_t("K1 ray_vs_tris", raycast.ray_vs_tris(o1, d1, soup),
                      raycast._ray_vs_tris_dense(o1, d1, soup))
        self.record(
            "K1 ray_vs_tris", "madrona_mp_env_tpu_torch/csrc/ray_tris.cu",
            "madrona_mp_env_tpu/ops/raycast_pallas.py:111",
            raycast.ray_vs_tris, err,
            cuda_time_ms(lambda: raycast.ray_vs_tris(o1, d1, soup), 200),
            cuda_time_ms(lambda: raycast._ray_vs_tris_dense(o1, d1, soup),
                         20),
            R1 * 28 + self.T_real * 40, R1 * self.T_real * OPS_RAY_TRI,
            [list(o1.shape[:-1])])

    def k2(self, org, zgf, dirf, zgroups):
        """K2 over the whole soup, bit-equal to its plain version and to its
        earlier kernel (P2's exact entry), the two timed in turns; returns
        its t for the PVS comparison."""
        from madrona_mp_env_tpu_torch.ops import cuda_build, raycast
        from madrona_mp_env_tpu_torch.tools import fan_probe

        soup = self.soup
        N, G = zgf.shape
        F = dirf[0].shape[-1]

        def fan_kernel():
            return raycast.ray_fans_vs_tris(org, zgf, dirf, zgroups, soup)

        def fan_plain():
            return chunked(lambda s: raycast._ray_fans_dense(
                org[s], zgf[s], tuple(c[s] for c in dirf), zgroups, soup), N,
                max(16, 2 ** 18 // soup.num_tris))

        def fan_before():
            return fan_probe.ENTRIES["exact"](org, zgf, dirf, zgroups, soup)

        t = fan_kernel()
        err = check_equal("K2 ray_fans_vs_tris", (t, fan_plain()))
        check_equal("K2 against its predecessor", (t, fan_before()))
        reps = 10 if soup.num_tris <= 1024 else 3
        ms, before = turns_ms(fan_kernel, fan_before, reps)
        regs, spill = cuda_build.ptxas_usage("fan_tris",
                                             "fan_tris_rb_kernel")
        nops = (N * F * self.T_real * OPS_FAN_PAIR
                + N * G * self.T_real * OPS_FAN_HOIST)
        self.record(
            "K2 ray_fans_vs_tris", "madrona_mp_env_tpu_torch/csrc/fan_tris.cu",
            "madrona_mp_env_tpu/ops/raycast_pallas.py:383",
            raycast.ray_fans_vs_tris, err, ms, cuda_time_ms(fan_plain, 1),
            N * (12 + 4 * G) + 3 * N * F * 4 + self.T_real * 40 + N * F * 4,
            nops, [[N, F, soup.num_tris]], before_ms=round(before, 4),
            device_ms=round(device_ms(fan_kernel, "fan_tris_rb_kernel",
                                      reps), 4),
            fmad_floor_ms=round(nops / PEAK_F32_INSNS * 1e3, 4),
            registers=regs, spill_bytes=spill,
            helper_launches=0)
        return t

    def k6(self, calls):
        """K6 over each fan's PVS cell, bit-equal to its plain version and
        to its earlier kernel (fan_culled_v1, timed with it in turns); its
        helper, the cell order; then K2 on the same fans (the soup of a
        big map), and how often the two agree."""
        import torch
        from madrona_mp_env_tpu_torch.ops import cuda_build, raycast
        from madrona_mp_env_tpu_torch.tools import kernel_bench

        soup = self.soup
        (org, zgf, dirf, zgroups, cells, tables, _), = calls[
            "ray_fans_culled"]
        N, G = zgf.shape
        F = dirf[0].shape[-1]

        def kernel():
            return raycast.ray_fans_culled(org, zgf, dirf, zgroups, cells,
                                           tables, soup)

        def plain():
            return chunked(lambda s: raycast._ray_fans_culled_plain(
                org[s], zgf[s], tuple(c[s] for c in dirf), zgroups, cells[s],
                tables, soup), N, 256)

        def before():
            return raycast.ray_fans_culled_v1(org, zgf, dirf, zgroups, cells,
                                              tables, soup)

        cl, C = cells.to(torch.int32), tables.cand_idx.shape[0]
        rank = tables.heavy_rank

        def order_kernel():
            return raycast.fan_cell_order(cl, C, rank)

        def order_plain():
            return raycast._fan_cell_order_plain(cl, rank)

        def order_library():
            return torch.sort(rank[cl.long()], stable=True)

        t6 = kernel()
        err = check_equal("K6 ray_fans_culled", (t6, plain()))
        check_equal("K6 against its predecessor", (t6, before()))
        ms, before_ms = turns_ms(kernel, before, 10)
        regs, spill = cuda_build.ptxas_usage("fan_culled",
                                             "fan_culled_rb_kernel")
        reps = 10
        events = kernel_bench.profiled(kernel, reps, "fan_culled_rb_kernel")
        if events is None:
            raise AssertionError("K6: the profiler saw no "
                                 "fan_culled_rb_kernel in 3 windows")
        launches, dev_us = {}, {}
        for e in events:
            launches[e.name] = launches.get(e.name, 0) + 1 / reps
            dev_us[e.name] = dev_us.get(e.name, 0.0) + e.device_time_total
        mine = [k for k in launches if "fan_culled_rb_kernel" in k]
        if len(mine) != 1 or round(launches[mine[0]]) != 1:
            raise AssertionError(f"K6: launches per call {launches}")
        helpers = {k: v for k, v in launches.items() if k not in mine}
        helper_us = sum(v for k, v in dev_us.items() if k not in mine)
        log(f"[kernel] K6 ray_fans_culled [{self.scene}]: CUDA launches per "
            f"call {launches}; the helpers' device time "
            f"{helper_us / 1e3 / reps:.4f} ms")
        n_valid = (tables.cand_idx >= 0).sum(-1)[cells.long()]  # [N]
        pairs = int(n_valid.sum()) * F
        nops = pairs * OPS_FAN_PAIR + int(n_valid.sum()) * G * OPS_FAN_HOIST
        row = self.record(
            "K6 ray_fans_culled",
            "madrona_mp_env_tpu_torch/csrc/fan_culled.cu",
            "madrona_mp_env_tpu/ops/raycast_pallas.py:465",
            raycast.ray_fans_culled, err, ms, cuda_time_ms(plain, 1),
            N * (16 + 4 * G) + 3 * N * F * 4 + tables.cand_idx.numel() * 4
            + self.T_real * 40 + N * F * 4,
            nops, [[N, F, tables.K]],
            mean_valid_candidates=round(float(n_valid.float().mean()), 1),
            before_ms=round(before_ms, 4),
            device_ms=round(dev_us[mine[0]] / 1e3 / reps, 4),
            helper_device_ms=round(helper_us / 1e3 / reps, 4),
            fmad_floor_ms=round(nops / PEAK_F32_INSNS * 1e3, 4),
            registers=regs, spill_bytes=spill,
            helper_launches=round(sum(helpers.values())),
            helpers=sorted(helpers))
        # its helper: the fans grouped by cell, heaviest cell first, in an
        # order free within a cell (a permutation with the stable sort's
        # cells); the library call sorts the gathered keys
        got, want = order_kernel(), order_plain()
        check_equal("K6 cell order", (torch.sort(got).values,
                                      torch.sort(want).values),
                    (cl[got.long()], cl[want.long()]))
        self.record(
            "K6 cell order", "madrona_mp_env_tpu_torch/csrc/fan_culled.cu",
            "madrona_mp_env_tpu/ops/culling.py:1214",
            raycast.fan_cell_order, 0.0, cuda_time_ms(order_kernel, 50),
            cuda_time_ms(order_plain, 50), 2 * N * 4 + C * 4, 2 * N,
            [[N, C]], library_ms=cuda_time_ms(order_library, 50),
            device_ms=round(device_ms(order_kernel, "fan_cell_order"), 4))
        t2 = self.k2(org, zgf, dirf, zgroups)
        torch.cuda.synchronize()
        same = float(((t6 == t2) | (torch.isinf(t6) & torch.isinf(t2)))
                     .float().mean())
        hitmiss = float((torch.isfinite(t6) == torch.isfinite(t2))
                        .float().mean())
        row["pvs_t_equal"] = same
        row["pvs_hit_agree"] = hitmiss
        log(f"[pvs] {self.scene}: K6 t equals K2's dense t on {same:.6f} of "
            f"{t6.numel()} rays; hit/miss agree on {hitmiss:.6f}")

    def k9(self, calls, t2):
        """K9 over each fan's sensor-ray table cell (a step taken with
        MPENV_FAN_V9=1), bit-equal to its plain version; then how often
        it agrees with K2's whole-soup t (``t2``) on the same rays."""
        import torch
        from madrona_mp_env_tpu_torch.ops import raycast

        soup = self.soup
        (org, zoff, dirf, cells, rt, _), = calls["ray_fans_culled_v9"]
        N, F = zoff.shape

        def kernel():
            return raycast.ray_fans_culled_v9(org, zoff, dirf, cells, rt,
                                              soup)

        def plain():
            return chunked(lambda s: raycast._ray_fans_v9_plain(
                org[s], zoff[s], tuple(c[s] for c in dirf), cells[s], rt,
                soup), N, 1024)

        t9, tp = kernel(), plain()
        torch.cuda.synchronize()
        if not bool(((t9 == tp) | (torch.isinf(t9) & torch.isinf(tp)))
                    .all()):
            raise AssertionError("K9 differs from its plain version")
        err = check_t("K9 ray_fans_culled_v9", t9, tp)
        n_valid = (rt.cand_idx >= 0).sum(-1)[cells.long()]  # [N]
        # z-groups of each fan: runs of equal z offsets (the kernel's own)
        runs = int((zoff[:, 1:] != zoff[:, :-1]).sum()) + N
        row = self.record(
            "K9 ray_fans_culled_v9",
            "madrona_mp_env_tpu_torch/csrc/fan_v9.cu",
            "madrona_mp_env_tpu/ops/raycast_pallas.py:743",
            raycast.ray_fans_culled_v9, err, cuda_time_ms(kernel, 50),
            cuda_time_ms(plain, 2),
            N * (12 + 4) + 4 * N * F * 4 + rt.cand_idx.numel() * 4
            + self.T_real * 40 + N * F * 4,
            int(n_valid.sum()) * F * OPS_FAN_PAIR
            + int((n_valid * runs / N).sum()) * OPS_FAN_HOIST,
            [[N, F, rt.K]],
            mean_valid_candidates=round(float(n_valid.float().mean()), 1))
        same = float(((t9 == t2) | (torch.isinf(t9) & torch.isinf(t2)))
                     .float().mean())
        hitmiss = float((torch.isfinite(t9) == torch.isfinite(t2))
                        .float().mean())
        row["tables_t_equal"] = same
        row["tables_hit_agree"] = hitmiss
        log(f"[ray tables] {self.scene}: K9 t equals K2's whole-soup t on "
            f"{same:.6f} of {t9.numel()} rays; hit/miss agree on "
            f"{hitmiss:.6f}")
        if hitmiss < 0.995:
            raise AssertionError(f"K9 hit/miss agreement {hitmiss} < 0.995")

    def k7(self, org, zoff, dirs, reps=10):
        """K7 over the whole soup: stacked directions, per-ray z offsets
        (each fan's runs found by the kernel). Bit-equal to its plain
        version; returns its t."""
        import torch
        from madrona_mp_env_tpu_torch.ops import raycast

        soup = self.soup
        N, F = zoff.shape

        def kernel():
            return raycast.ray_fans_vs_tris_flat(org, zoff, dirs, soup)

        def plain():
            return chunked(lambda s: raycast._ray_fans_flat_plain(
                org[s], zoff[s], dirs[s], soup), N,
                max(16, 2 ** 18 // soup.num_tris))

        t, (tp, pms) = kernel(), timed_once(plain)
        err = check_equal("K7 ray_fans_vs_tris_flat", (t, tp))
        runs = int((zoff[:, 1:] != zoff[:, :-1]).sum()) + N
        self.record(
            "K7 ray_fans_vs_tris_flat",
            "madrona_mp_env_tpu_torch/csrc/fan_flat.cu",
            "madrona_mp_env_tpu/ops/raycast_pallas.py:265",
            raycast.ray_fans_vs_tris_flat, err, cuda_time_ms(kernel, reps),
            pms, N * 12 + N * F * 16 + self.T_real * 40 + N * F * 4,
            N * F * self.T_real * OPS_FAN_PAIR
            + runs * self.T_real * OPS_FAN_HOIST,
            [[N, F, soup.num_tris]], runs_per_fan=round(runs / N, 3),
            hit_share=round(float(torch.isfinite(t).float().mean()), 4))
        return t

    def k8(self, o, d, r, reps=10):
        """K8 over the whole soup with the winner's contact normal: t and
        normal bit-equal to the plain version; without normals, the same
        t and zero normals."""
        import torch
        from madrona_mp_env_tpu_torch.ops import raycast

        soup = self.soup
        R = o[..., 0].numel()

        def kernel(with_normal=True):
            return raycast.sphere_cast_vs_tris(o, d, r, soup,
                                               with_normal=with_normal)

        (tk, nk), ((tp, np_), pms) = kernel(), timed_once(
            lambda: sc_normal_plain(o, d, r, soup))
        err = check_equal("K8 sphere_cast_vs_tris", (tk, tp), (nk, np_))
        t0, n0 = kernel(False)
        torch.cuda.synchronize()
        if not torch.equal(t0, tk) or bool(n0.any()):
            raise AssertionError("K8 without normals: t differs or a "
                                 "normal is not 0")
        self.record(
            "K8 sphere_cast_vs_tris",
            "madrona_mp_env_tpu_torch/csrc/sphere_cast.cu",
            "madrona_mp_env_tpu/ops/raycast_pallas.py:1364",
            raycast.sphere_cast_vs_tris, err, cuda_time_ms(kernel, reps),
            pms, R * 24 + R * 16 + self.T_real * 52,
            R * self.T_real * OPS_SPHERE_TRI
            + R * (OPS_SPHERE_TRI + OPS_SC_NORMAL), [list(o.shape[:-1])],
            no_normal_ms=round(cuda_time_ms(lambda: kernel(False), reps), 4),
            hit_share=round(float(torch.isfinite(tk).float().mean()), 4))

    def k3x(self, o, d, self_idx, pos, alive, reps=50):
        """K3x: explicit origins, a capsule to skip per ray; t and hit
        index bit-equal to the plain version."""
        import torch
        from madrona_mp_env_tpu_torch.ops import raycast_cull

        W, A, F = self_idx.shape

        def kernel():
            return raycast_cull.fan_capsules_explicit(o, d, self_idx, pos,
                                                      alive)

        def plain():
            return chunked(lambda s: raycast_cull._fan_capsules_explicit_plain(
                o[s], d[s], self_idx[s], pos[s], alive[s]), W, 128)

        (tk, ik), ((tp, ip), pms) = kernel(), timed_once(plain)
        err = check_equal("K3x fan_capsules_explicit", (tk, tp), (ik, ip))
        # capsules each ray tests: its world's live ones but the skipped
        al = alive.to(torch.int64)
        skipped_live = torch.gather(al, 1, self_idx.long().reshape(W, A * F))
        tested = int((al.sum(-1, keepdim=True) - skipped_live).sum())
        self.record(
            "K3x fan_capsules_explicit",
            "madrona_mp_env_tpu_torch/csrc/fan_capsules.cu",
            "madrona_mp_env_tpu/ops/raycast_cull.py:120",
            raycast_cull.fan_capsules_explicit, err,
            cuda_time_ms(kernel, reps), pms,
            W * A * F * 28 + W * A * 13 + W * A * F * 8,
            tested * OPS_CAPSULE, [[W, A, F]])
        return tk, ik

    def k3(self, calls):
        import torch
        from madrona_mp_env_tpu_torch.ops import raycast_cull

        (pos, zoff, dirs, alive), = calls["fan_capsules"]
        W, A, F = zoff.shape

        def cap_kernel():
            return raycast_cull.fan_capsules(pos, zoff, dirs, alive)

        def cap_plain():
            return chunked(lambda s: raycast_cull._fan_capsules_plain(
                pos[s], zoff[s], tuple(c[s] for c in dirs), alive[s]), W, 128)

        (tk, ik), (tp, ip) = cap_kernel(), cap_plain()
        err = check_t("K3 fan_capsules", tk, tp)
        me = torch.arange(A, device=pos.device)
        self_mask = (me[:, None] == me[None, :])[None, :, None, :]

        def cap_gap(s):
            zero = torch.zeros_like(zoff[s])
            o = pos[s][:, :, None, :] + torch.stack([zero, zero, zoff[s]],
                                                    dim=-1)
            tc = raycast_cull.ray_vs_capsules(
                o, torch.stack([c[s] for c in dirs], dim=-1),
                pos[s][:, None, None], alive[s][:, None, None])
            return best_two_gap(torch.where(self_mask, float("inf"), tc))

        check_idx("K3 fan_capsules", ik, ip, chunked(cap_gap, W, 128), tp)
        live = alive.sum(-1, keepdim=True) - alive.to(torch.int64)  # [W, A]
        self.record(
            "K3 fan_capsules", "madrona_mp_env_tpu_torch/csrc/fan_capsules.cu",
            "madrona_mp_env_tpu/ops/raycast_cull.py:120",
            raycast_cull.fan_capsules, err, cuda_time_ms(cap_kernel, 50),
            cuda_time_ms(cap_plain, 2),
            W * A * 13 + W * A * F * 16 + W * A * F * 8,
            int((live * F).sum()) * OPS_CAPSULE, [[W, A, F]])

    def k4_dense(self, calls):
        """The L2 pair, the L3 snap and the fall cast over the whole soup
        (a step with MPENV_SC_PACK=0)."""
        from madrona_mp_env_tpu_torch.ops import raycast

        soup = self.soup
        sc_calls = calls["sphere_cast"]
        if len(sc_calls) != 3:
            raise AssertionError(f"step made {len(sc_calls)} dense casts")
        err, ms, pms, R4, shapes = 0.0, 0.0, 0.0, 0, []
        for i, (o4, d4, r, _) in enumerate(sc_calls):
            def sc_plain(o4=o4, d4=d4, r=r):
                return sc_dense_plain(o4, d4, r, soup)

            def sc_kernel(o4=o4, d4=d4, r=r):
                return raycast.sphere_cast(o4, d4, r, soup)

            (tk, ik), (tp, ip) = sc_kernel(), sc_plain()
            name = f"K4 sphere_cast launch {i} {list(o4.shape[:-1])}"
            err = max(err, check_t(name, tk, tp))
            check_idx(name, ik, ip, sc_gap(o4, d4, r, soup), tp)
            ms += cuda_time_ms(sc_kernel, 50)
            pms += cuda_time_ms(sc_plain, 2)
            R4 += o4[..., 0].numel()
            shapes.append(list(o4.shape[:-1]))
        self.record(
            "K4 sphere_cast (dense)",
            "madrona_mp_env_tpu_torch/csrc/sphere_cast.cu",
            "madrona_mp_env_tpu/ops/raycast_pallas.py:1384",
            raycast.sphere_cast, err, ms, pms,
            R4 * 32 + 3 * self.T_real * 52,
            R4 * self.T_real * OPS_SPHERE_TRI, shapes)

    def k4_culled(self, calls):
        """The L1 batch of 7 casts per agent against the short tables."""
        import torch
        from madrona_mp_env_tpu_torch.ops import raycast
        from madrona_mp_env_tpu_torch.sim import movement

        soup = self.soup
        (o7, d7, r, cells, short, _), = calls["sphere_cast_culled"]
        N7, CPA = o7.shape[:2]

        def culled_kernel():
            return raycast.sphere_cast_culled(o7, d7, r, cells, short, soup)

        def culled_plain():
            return chunked(lambda s: raycast._sphere_cast_culled_plain(
                o7[s], d7[s], r, cells[s], short, soup), N7, 2048)

        (tk, ik), (tp, ip) = culled_kernel(), culled_plain()
        err = check_t("K4 sphere_cast_culled", tk, tp)
        # the short tables are exact for the range the step consumes
        # (movement.UNSTICK_RANGE): equal t and row there, beyond it both
        # far. A standing agent's casts have no direction: they touch every
        # triangle at t = 0, each entry reports its lowest row, and the step
        # does not read them (no_move), so they are left out here.
        td, idd = sc_dense_plain(o7, d7, r, soup)
        swept = (d7 != 0.0).any(dim=-1)
        near = (td <= movement.UNSTICK_RANGE) & swept
        far = ~near & swept
        if not (torch.equal(td[near], tp[near])
                and torch.equal(idd[near], ip[near])
                and bool((tp[far] > movement.UNSTICK_RANGE).all())):
            raise AssertionError("culled plain cast differs from the dense")
        check_idx("K4 sphere_cast_culled", ik, ip, sc_gap(o7, d7, r, soup),
                  tp)
        cand = short.cand.reshape(-1, short.K)[cells.long()]
        self.record(
            "K4 sphere_cast_culled",
            "madrona_mp_env_tpu_torch/csrc/sphere_cast.cu",
            "madrona_mp_env_tpu/ops/raycast_pallas.py:1549",
            raycast.sphere_cast_culled, err, cuda_time_ms(culled_kernel, 50),
            cuda_time_ms(culled_plain, 2),
            N7 * CPA * 32 + N7 * 4 + short.cand.numel() * 4
            + self.T_real * 52,
            int((cand >= 0).sum()) * CPA * OPS_SPHERE_TRI, [[N7, CPA]])

    def k4_packed(self, calls):
        """K4': the L2 pair, the L3 snap and the fall cast against the
        MOVE_MARGIN short tables. Against the dense sweep: every down cast
        equal at any depth; no cast nearer than the dense one (a subset's
        minimum)."""
        import torch
        from madrona_mp_env_tpu_torch.ops import raycast

        soup = self.soup
        pk_calls = calls["sphere_cast_packed"]
        if len(pk_calls) != 3:
            raise AssertionError(f"step made {len(pk_calls)} packed casts")
        err, ms, pms, nbytes, pairs, shapes = 0.0, 0.0, 0.0, 0, 0, []
        for i, (o, d, r, cells, short, _) in enumerate(pk_calls):
            N, CPA = o.shape[:2]

            def kernel(o=o, d=d, r=r, cells=cells, short=short):
                return raycast.sphere_cast_packed(o, d, r, cells, short, soup)

            def plain(o=o, d=d, r=r, cells=cells, short=short, N=N):
                return chunked(lambda s: raycast._sphere_cast_culled_plain(
                    o[s], d[s], r, cells[s], short, soup), N, 4096)

            (tk, ik), (tp, ip) = kernel(), plain()
            name = f"K4' sphere_cast_packed launch {i} {[N, CPA]}"
            err = max(err, check_t(name, tk, tp))
            check_idx(name, ik, ip, sc_gap(o, d, r, soup), tp)
            td, _ = sc_dense_plain(o, d, r, soup)
            down = (d[..., 0] == 0.0) & (d[..., 1] == 0.0) & (d[..., 2] < 0.0)
            if not (torch.equal(td[down], tp[down])
                    and bool((td <= tp).all())):
                raise AssertionError(f"{name}: packed cast differs from the "
                                     "dense cast")
            ms += cuda_time_ms(kernel, 50)
            pms += cuda_time_ms(plain, 2)
            # casts in (24 B) and out (8 B), cells, the table, the rows
            nbytes += (N * CPA * 32 + N * 4 + short.cand.numel() * 4
                       + self.T_real * 52)
            cand = short.cand.reshape(-1, short.K)[cells.long()]
            pairs += int((cand >= 0).sum()) * CPA
            shapes.append([N, CPA])
        self.record(
            "K4' sphere_cast_packed",
            "madrona_mp_env_tpu_torch/csrc/sphere_cast.cu",
            "madrona_mp_env_tpu/ops/raycast_pallas.py:2028",
            raycast.sphere_cast_packed, err, ms, pms, nbytes,
            pairs * OPS_SPHERE_TRI, shapes)

    def k5(self, calls):
        from madrona_mp_env_tpu_torch.ops import tail_fused

        (cfg5, m5, st5, fr5), = calls["tail_fused"]

        def tail_kernel():
            return tail_fused.tail_fused(cfg5, m5, st5, fr5)

        def tail_plain():
            return tail_fused.tail_fused_plain(cfg5, m5, st5, fr5)

        err = check_tail(tail_kernel(), tail_plain())
        ins, outs = tail_fused.kernel_operands(cfg5, m5, st5, fr5)
        W5, A5 = st5.hp.shape
        ts5 = cfg5.team_size
        self.record(
            "K5 tail_fused", "madrona_mp_env_tpu_torch/csrc/tail_fused.cu",
            "madrona_mp_env_tpu/ops/tail_pallas.py:143", tail_fused.tail_fused,
            err, cuda_time_ms(tail_kernel, 200), cuda_time_ms(tail_plain, 20),
            sum(x.nbytes for x in (*ins.values(), *outs.values())),
            W5 * A5 * (OPS_TAIL_AGENT + 2 * (ts5 - 1) + 5 * (ts5 - 2)),
            [[W5, A5]])


SIMPLE_ENTRIES = ("ray_vs_tris", "ray_fans_vs_tris", "fan_capsules",
                  "sphere_cast_culled", "sphere_cast_packed", "tail_fused")
TOWN_ENTRIES = ("ray_vs_tris", "ray_fans_culled", "fan_capsules",
                "sphere_cast_culled", "sphere_cast_packed", "tail_fused")
V9_ENTRIES = ("ray_vs_tris", "ray_fans_culled_v9", "fan_capsules",
              "sphere_cast_culled", "sphere_cast_packed", "tail_fused")


def tail_chain_check(env, state, actions):
    """The unfused system chain (the reference's order) on the card
    equals the fused order through tail_fused_plain bit for bit, from the
    tail's inputs of one real step (captured where the step calls
    fused_tail)."""
    import torch
    from madrona_mp_env_tpu_torch.ops import tail_fused
    from madrona_mp_env_tpu_torch.sim import step as step_mod

    seen = []
    fused = step_mod.fused_tail

    def rec(*args, **kw):
        seen.append(_clone(args))
        return fused(*args, **kw)

    step_mod.fused_tail = rec
    try:
        env.step(state, actions)
    finally:
        step_mod.fused_tail = fused
    (cfg, m, st, victims, fr), = seen
    sf, cf = fused(cfg, m, _clone(st), victims, fr,
                   tail=tail_fused.tail_fused_plain)
    su, cu = step_mod.unfused_tail(cfg, m, _clone(st), victims, fr)
    torch.cuda.synchronize()
    bad = [k for k, v in su.leaves().items()
           if not bool(((v == getattr(sf, k)) | (
               v.isnan() & getattr(sf, k).isnan()
               if v.dtype.is_floating_point else False)).all())]
    if bad or not torch.equal(cf, cu):
        raise AssertionError(f"unfused chain differs from tail_fused_plain "
                             f"on the card: {bad}")
    log(f"[tail chain] {st.hp.shape[0]} worlds: the unfused chain equals "
        f"tail_fused_plain bit for bit on the card "
        f"({len(su.leaves())} leaves)")


def simple_kernels(env, state, actions):
    """simple_map: K1, K2, K3, K4 culled, K4' and K5 on one default step;
    K4 dense on the same step with MPENV_SC_PACK=0."""
    ph = KernelPhase(env.map_data.tris, "simple_map")
    calls = capture_step_calls(env, state, actions, SIMPLE_ENTRIES)
    ph.k1(calls)
    (org, zgf, dirf, zgroups, _), = calls["ray_fans_vs_tris"]
    t2 = ph.k2(org, zgf, dirf, zgroups)
    ph.k3(calls)
    ph.k4_culled(calls)
    ph.k4_packed(calls)
    ph.k5(calls)
    with mock.patch.dict(os.environ, MPENV_SC_PACK="0"):
        dense = capture_step_calls(
            env, state, actions,
            tuple(e for e in SIMPLE_ENTRIES if e != "sphere_cast_packed")
            + ("sphere_cast",))
    ph.k4_dense(dense)
    # the same step on the sensor-ray tables: the same fans, K9 for K2
    with mock.patch.dict(os.environ, MPENV_FAN_V9="1"):
        v9 = capture_step_calls(env, state, actions, V9_ENTRIES)
    ph.k9(v9, t2)
    tail_chain_check(env, state, actions)
    return ph.results


def town_kernels(env, state, actions):
    """town_map: K1, K3, K4 culled, K4', K5 and K6 on one default step, and
    K2 over the 6,144-triangle soup on K6's fans (the forced-dense
    route's launch)."""
    ph = KernelPhase(env.map_data.tris, "town_map")
    calls = capture_step_calls(env, state, actions, TOWN_ENTRIES)
    ph.k1(calls)
    ph.k6(calls)
    ph.k3(calls)
    ph.k4_culled(calls)
    ph.k4_packed(calls)
    ph.k5(calls)
    return ph.results


TEAM3_ENTRIES = ("ray_vs_tris", "ray_fans_vs_tris_flat", "fan_capsules",
                 "sphere_cast_culled", "sphere_cast_packed", "tail_fused")


def team3_kernels(env, state, actions, scene):
    """Zone 3v3 (a LOS run of 12 rays, not a multiple of 8): K7 and K5 on
    one step's launches; K8 on the step's L1 casts over the whole soup and
    K3x on its sensor rays with the origins made explicit (K3x's t and hit
    indices must equal K3's on the same rays); the unfused tail chain at
    team size 3."""
    import torch
    from madrona_mp_env_tpu_torch.ops import raycast, raycast_cull

    ph = KernelPhase(env.map_data.tris, f"{scene} Zone 3v3")
    calls = capture_step_calls(env, state, actions, TEAM3_ENTRIES)
    (org, zoff, dirs, _), = calls["ray_fans_vs_tris_flat"]
    ph.k7(org, zoff, dirs)
    ph.k5(calls)
    soup = ph.soup
    (o7, d7, r, *_), = calls["sphere_cast_culled"]

    def k8():
        return raycast.sphere_cast_vs_tris(o7, d7, r, soup)

    (tk, nk), ((tp, np_), pms) = k8(), timed_once(
        lambda: sc_normal_plain(o7, d7, r, soup))
    check_equal("K8 on the step's L1 casts", (tk, tp), (nk, np_))
    log(f"[kernel] K8 sphere_cast_vs_tris [{ph.scene}] on the step's L1 "
        f"casts {list(o7.shape[:-1])}: bit-equal, kernel "
        f"{cuda_time_ms(k8, 20):.4f} ms plain {pms:.4f} ms")
    (pos, zf, df, alive), = calls["fan_capsules"]
    W, A, F = zf.shape
    zero = torch.zeros_like(zf)
    o = pos[:, :, None, :] + torch.stack([zero, zero, zf], dim=-1)
    d = torch.stack(df, dim=-1)
    own = torch.arange(A, dtype=torch.int32, device=pos.device)
    self_idx = own[None, :, None].expand(W, A, F).contiguous()

    def k3x():
        return raycast_cull.fan_capsules_explicit(o, d, self_idx, pos, alive)

    (tx, ix), ((tp, ip), pms) = k3x(), timed_once(
        lambda: raycast_cull._fan_capsules_explicit_plain(o, d, self_idx,
                                                          pos, alive))
    check_equal("K3x on the step's sensor rays", (tx, tp), (ix, ip))
    t3, i3 = raycast_cull.fan_capsules(pos, zf, df, alive)
    check_equal("K3x against K3 on the step's sensor rays", (tx, t3),
                (ix, i3))
    log(f"[kernel] K3x fan_capsules_explicit [{ph.scene}] on the step's "
        f"sensor rays {[W, A, F]}: bit-equal to its plain version and to "
        f"K3, kernel {cuda_time_ms(k3x, 50):.4f} ms plain {pms:.4f} ms")
    tail_chain_check(env, state, actions)
    return ph.results


BENCH_ITERS = 5


def bench_kernels(mt, scene, team_size, card):
    """K7, K8 and K3x at the kernel bench's own shapes and inputs
    (tools/kernel_bench.py make_inputs) at NUM_WORLDS worlds, each
    bit-equal to its plain version and timed; then the kernel bench
    itself (its main, as the command line runs it) with every launch
    counter zeroed just before and read just after: its launches are
    these rows'."""
    import torch
    from madrona_mp_env_tpu_torch import consts
    from madrona_mp_env_tpu_torch.assets.map_data import load_map
    from madrona_mp_env_tpu_torch.tools import kernel_bench

    name = os.path.basename(scene)
    m = load_map(scene, mt.EnvConfig(team_size=team_size), device="cuda")
    x = kernel_bench.make_inputs(NUM_WORLDS, team_size, "cuda")
    ph = KernelPhase(m.tris, f"{name} bench ts{team_size}")
    ph.k7(x["origins"], x["zoff"], x["dirs"])
    ph.k8(x["o_sc"], x["d_sc"], consts.agent_radius)
    ph.k3x(x["o_caps"], x["d_caps"], x["self_idx"], x["cap_pos"],
           x["alive"])
    del x, m
    entries = all_entries()
    for f in entries.values():
        f.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = kernel_bench.main(["--worlds", str(NUM_WORLDS), "--team-size",
                             str(team_size), "--scene", scene, "--iters",
                             str(BENCH_ITERS)])
    torch.cuda.synchronize()
    label = f"kernel bench {name} ts {team_size}"
    for row in ph.results:
        row["launches"] = row["entry"].launches
        row["path"] = label
    missing = [r["name"] for r in ph.results if r["launches"] == 0]
    if missing or not all(np.isfinite(v) and v > 0 for v in res.values()):
        raise AssertionError(f"{label}: kernels not launched {missing} or "
                             f"a bad time {res}")
    log(f"[{label}] {time.perf_counter() - t0:.1f} s on {card}; launches "
        + ", ".join(f"{n}={f.launches}" for n, f in entries.items()))
    return ph.results


P3_STEPS = 5  # the fused movement's state: Env.reset + 5 steps
P3_SOURCE = "madrona_mp_env_tpu_torch/csrc/move_fused.cu"
P3_TPU = "tools/probes/movement_fused_probe.py:54"
FAN_PROBE_CHAIN = 50  # the TPU probe's scan length
# f32 operations per (ray, row) pair of P2's part variants (as the kernel
# writes them): the direction dots, two crosses' worth of products and
# sums and two minima; the epilogue's divide, three scales, u + v, min
OPS_FAN_DOTS = 26
OPS_FAN_EPILOGUE = 6
P2_TPU = {"exact": "madrona_mp_env_tpu/tools/fan_probe.py:129",
          "rcp_ieee": "madrona_mp_env_tpu/tools/fan_probe.py:129",
          "rcp_approx": "madrona_mp_env_tpu/tools/fan_probe.py:129",
          "dots_only": "madrona_mp_env_tpu/tools/fan_probe.py:129",
          "epilogue": "madrona_mp_env_tpu/tools/fan_probe.py:129",
          "chunked": "madrona_mp_env_tpu/tools/fan_probe.py:183"}


def p3_rows(cfg, scene):
    """P3, the fused movement, under both routes on the state a step
    hands the movement pair (Env.reset + P3_STEPS steps of bench.py's
    actions at NUM_WORLDS worlds, then the movement and aim systems):
    kernel against its plain version and, bit for bit, against the split
    pair on the step's own kernels; the fused launch's time, the split
    pair's and the plain version's; the CUDA launches of one split pair
    and of one fused call (torch.profiler); the bound over the (cast,
    valid triangle) pairs and normals the kernel took (its work
    counter)."""
    import torch
    from madrona_mp_env_tpu_torch.tools.probes import (
        movement_fused_probe as mf,
    )

    env, st = mf.bench_state(cfg, scene, NUM_WORLDS, P3_STEPS, "cuda")
    m = env.map_data
    ph = KernelPhase(m.tris, os.path.basename(scene))
    N = st.pos.shape[0] * st.pos.shape[1]
    for route in ("culled", "dense"):
        rt = dict(culled="L1 short tables, L2/L3/fall MOVE_MARGIN tables",
                  dense="every cast over the whole soup")[route]

        def fused(route=route):
            return mf.apply_velocity_fall_fused(cfg, m, st, route)

        def split(route=route):
            return mf.split_pair(cfg, m, st, route)

        got = fused()
        want, pms = timed_once(
            lambda: mf._apply_velocity_fall_fused_plain(cfg, m, st, route))
        name = f"P3 move_fused ({route})"
        err = check_equal(name, (got.pos, want.pos), (got.vel, want.vel))
        sp = split()
        check_equal(f"{name} against the split pair", (got.pos, sp.pos),
                    (got.vel, sp.vel))
        moved = float((got.pos != st.pos).any(-1).float().mean())
        work = torch.zeros(2, dtype=torch.int64, device="cuda")
        mf.apply_velocity_fall_fused(cfg, m, st, route, work=work)
        pairs, normals = (int(v) for v in work.tolist())
        tables = (m.short.cand.numel() + m.short_mv.cand.numel()) * 4 \
            if route == "culled" else 0
        ph.record(
            name, P3_SOURCE, P3_TPU, mf.apply_velocity_fall_fused, err,
            cuda_time_ms(fused, 20), pms,
            N * (32 + 24) + tables + ph.T_real * 52,
            pairs * OPS_SPHERE_TRI + normals * (OPS_SPHERE_TRI
                                                + OPS_SC_NORMAL),
            [list(st.pos.shape[:2])], route_casts=rt,
            split_ms=round(cuda_time_ms(split, 5), 4),
            split_launches=mf.cuda_launches(split),
            fused_launches=mf.cuda_launches(fused), pairs=pairs,
            normals=normals, moved_share=round(moved, 4))
    return ph.results


def fan_probe_rows():
    """P5, P6 and P2 at 12,288 fans x 104 rays on simple_map (the probes'
    make_fans): each kernel against its plain version (bit-equal; P2's
    rcp.approx: its largest error and share of rays beyond 1e-4 relative
    against the exact plain version), its time, the plain version's and
    the bound over the valid (ray, row) pairs."""
    import torch
    from madrona_mp_env_tpu_torch.ops import raycast
    from madrona_mp_env_tpu_torch.tools import fan_probe as p2
    from madrona_mp_env_tpu_torch.tools.probes import (
        v9_kernel_probe as p5, v9_scan_timing as p6,
    )
    from madrona_mp_env_tpu_torch.ops.culling import ray_cell_index

    m = p5.probe_map("cuda")
    x = p5.make_fans(m, p5.FANS, 0, "cuda")
    ph = KernelPhase(m.tris, "simple_map probes")
    rt, soup = m.ray_cells, m.tris
    N, F = x["zoff"].shape
    G = len(x["zgroups"])
    v9_args = (x["origins"], x["zoff"], x["dirs"], x["cells"])
    want, pms = timed_once(lambda: p5.by_fans(
        lambda f: raycast._ray_fans_v9_plain(
            f["origins"], f["zoff"], f["dirs"], f["cells"], rt, soup), x))
    n_valid = int((rt.cand_idx >= 0).sum(-1)[x["cells"].long()].sum())
    v9_bytes = (N * 16 + 4 * N * F * 4 + rt.cand_idx.numel() * 4
                + ph.T_real * 40 + N * F * 4)
    v9_ops = n_valid * F * OPS_FAN_PAIR + n_valid * G * OPS_FAN_HOIST
    table = p5.gather_tables(rt, soup)
    dense_ms = cuda_time_ms(lambda: raycast.ray_fans_vs_tris(
        x["origins"], x["zg"], x["dirs"], x["zgroups"], soup),
        FAN_PROBE_CHAIN)
    e2e_ms = cuda_time_ms(lambda: raycast.ray_fans_culled_v9(
        x["origins"], x["zoff"], x["dirs"], ray_cell_index(rt, x["origins"]),
        rt, soup), FAN_PROBE_CHAIN)
    v9_rows = (
        ("P5 fan_v9 indirect (as shipped)", "v9_kernel_probe.py:31",
         raycast.ray_fans_culled_v9,
         lambda: raycast.ray_fans_culled_v9(*v9_args, rt, soup), {}),
        ("P5 fan_v9_gathered + gather", "v9_kernel_probe.py:31",
         p5.ray_fans_v9_gathered,
         lambda: p5.ray_fans_v9_gathered(*v9_args,
                                         p5.gather_tables(rt, soup)), {}),
        ("P5 fan_v9_gathered", "v9_kernel_probe.py:48",
         p5.ray_fans_v9_gathered,
         lambda: p5.ray_fans_v9_gathered(*v9_args, table), {}),
        ("P6 fan_v9 full", "v9_scan_timing.py:38",
         raycast.ray_fans_culled_v9,
         lambda: raycast.ray_fans_culled_v9(*v9_args, rt, soup),
         dict(dense_fan_ms=round(dense_ms, 4),
              v9_end_to_end_ms=round(e2e_ms, 4))),
        ("P6 fan_v9_chunked", "v9_scan_timing.py:38",
         p6.ray_fans_v9_chunked,
         lambda: p6.ray_fans_v9_chunked(*v9_args, rt, soup),
         dict(dense_fan_ms=round(dense_ms, 4))),
    )
    for name, tpu, entry, fn, extra in v9_rows:
        err = check_equal(name, (fn(), want))
        ph.record(name, "madrona_mp_env_tpu_torch/csrc/fan_v9.cu",
                  f"tools/probes/{tpu}", entry, err,
                  cuda_time_ms(fn, FAN_PROBE_CHAIN), pms, v9_bytes, v9_ops,
                  [[N, F, rt.K]], **extra)

    aux = p2.make_aux(soup.num_tris, 0, "cuda")
    args = (x["origins"], x["zg"], x["dirs"], x["zgroups"], soup)
    k2_bytes = (N * (12 + 4 * G) + 3 * N * F * 4 + ph.T_real * 40
                + N * F * 4)
    pairs = N * F * ph.T_real
    hoist = N * G * ph.T_real * OPS_FAN_HOIST
    exact, exact_ms = timed_once(lambda: p5.by_fans(
        lambda f: p2._fan_probe_plain("exact", f["origins"], f["zg"],
                                      f["dirs"], f["zgroups"], soup), x))
    for v in p2.VARIANTS:
        fn = p2.ENTRIES[v]

        def kernel(fn=fn):
            return fn(*args, aux=aux)

        extra, ops = {}, pairs * OPS_FAN_PAIR + hoist
        if v in ("exact", "chunked", "rcp_approx"):
            want, vms = exact, exact_ms
        else:
            want, vms = timed_once(lambda v=v: p5.by_fans(
                lambda f: p2._fan_probe_plain(v, f["origins"], f["zg"],
                                              f["dirs"], f["zgroups"], soup,
                                              aux), x))
        name = f"P2 fan_probe {v}"
        got = kernel()
        if v == "rcp_approx":
            err, share = p2.approx_error(got, want)
            extra["share_beyond_1e-4"] = share
            log(f"[kernel] {name}: rcp.approx against the exact plain "
                f"version: max abs err {err:.6g}, {share:.6g} of "
                f"{got.numel()} rays beyond 1e-4 relative or with another "
                "hit/miss")
        else:
            err = check_equal(name, (got, want))
        if v == "dots_only":
            ops = pairs * OPS_FAN_DOTS + hoist
            extra["library_ms"] = cuda_time_ms(
                lambda: p2.direction_matmul(x, soup), 10)
        elif v == "epilogue":
            ops = pairs * OPS_FAN_EPILOGUE + hoist
        ph.record(name, "madrona_mp_env_tpu_torch/csrc/fan_probe.cu",
                  P2_TPU[v], fn, err, cuda_time_ms(kernel, 20), vms,
                  k2_bytes + (soup.num_tris * 16 if v == "epilogue" else 0),
                  ops, [[N, F, soup.num_tris]], **extra)
    del want, exact
    torch.cuda.empty_cache()
    return ph.results


P4_SOURCE = "madrona_mp_env_tpu_torch/csrc/sc_mxu.cu"
P4_TPU = "tools/probes/sc_mxu_probe.py:66"
# P4 per (cast, row) pair: 18 groups x K 8 x 3 (3xTF32) tensor-core
# multiply-adds; the epilogue's f32 operations (face 19, three edge
# cylinders 23 each, three vertex spheres 10 each, the minimum)
MACS_SC_MXU = 18 * 8 * 3
OPS_SC_MXU = 19 + 3 * 23 + 3 * 10 + 1
P1_SOURCE = "madrona_mp_env_tpu_torch/csrc/vpu_probe.cu"
P1_TPU = "madrona_mp_env_tpu/tools/vpu_probe.py:35"
P1_MM_TPU = "madrona_mp_env_tpu/tools/vpu_probe.py:101"
# P1 per link, as the kernels' algebra needs them: (f32 instructions,
# special-function results); the fan epilogue's reciprocal is one per
# element (loop-invariant), counted apart
P1_WORK = {"fma_full_tile": (1, 0), "mul_full_tile": (1, 0),
           "fma_lane_bcast": (1, 0), "fma_sublane_bcast": (1, 0),
           "recip_approx_add": (1, 1), "div_exact_add": (1, 1),
           "cmp_sel_add": (3, 0), "fan_epilogue": (8, 0)}


def sc_mxu_rows():
    """P4 at the TPU probe's shape (24,576 casts x simple_map's 256 rows):
    the kernel against its plain version within its bars (the largest
    |t difference| where both hit, the share of casts whose hit or miss
    differs), its time, the plain version's, K4 dense's on the same casts
    and the share of casts at the TPU probe's parity bar against it; the
    bound over the (cast, valid row) pairs; the library row: the two
    products as torch.matmul (f32, TF32 off)."""
    import torch
    from madrona_mp_env_tpu_torch.ops import raycast
    from madrona_mp_env_tpu_torch.tools.probes import sc_mxu_probe as p4

    m = p4.probe_map("cuda")
    o, d = p4.make_casts(p4.CASTS, 0, "cuda")
    dirm, orgm, cons = p4.probe_tables(m, "cuda")
    planes = p4.planes_of(o, d)
    ph = KernelPhase(m.tris, "simple_map probes")

    def kernel():
        return p4.sphere_cast_mxu(planes, dirm, orgm, cons)

    got = kernel()
    want, pms = timed_once(lambda: p4._sc_mxu_plain(planes, dirm, orgm,
                                                    cons))
    torch.cuda.synchronize()
    err, flips = p4.mxu_error(got, want)
    if err > p4.MAX_DT or flips > p4.MAX_FLIP:
        raise AssertionError(f"P4 sc_mxu: max |dt| {err} (bar {p4.MAX_DT}),"
                             f" hit/miss differ on {flips} (bar "
                             f"{p4.MAX_FLIP})")
    frac, diff = p4.parity(got, raycast.sphere_cast(o, d, p4.R, m.tris)[0])
    library = cuda_time_ms(
        lambda: p4.library_products(planes, dirm, orgm), 10)
    N, T = o.shape[0], m.tris.num_tris
    pairs = N * ph.T_real
    log(f"[kernel] P4 sc_mxu: max |dt| {err:.6g} where both hit, hit/miss "
        f"differ on {flips:.6g} of {N} casts; against K4 dense "
        f"{frac:.6g} within the TPU probe's bar, max diff {diff:.6g}")
    ph.record(
        "P4 sc_mxu (3xTF32 mma)", P4_SOURCE, P4_TPU, p4.sphere_cast_mxu,
        err, cuda_time_ms(kernel, p4.NSCAN), pms,
        # planes' 6 rows in, t out; dirm, orgm; cons
        N * 28 + 2 * 8 * p4.G * T * 4 + T * 16 * 4,
        pairs * OPS_SC_MXU, [[N, T]],
        more=[(pairs * MACS_SC_MXU * 2, PEAK_TF32)], library_ms=library,
        hit_miss_share=flips, parity_vs_k4=frac,
        k4_dense_ms=round(cuda_time_ms(
            lambda: raycast.sphere_cast(o, d, p4.R, m.tris), p4.NSCAN), 4))
    del want
    torch.cuda.empty_cache()
    return ph.results


def vpu_rows():
    """P1 at the TPU probe's shapes: each chain on a 256 x 256 tile at its
    depth (the same elements NaN, +inf or -inf) and at vpu_probe.SHORT
    links (every element finite): the mul, divide and select chains
    bit-equal to their plain versions, the others within their bars,
    their error printed at both depths; and the two bf16 matmul
    chains; the kernel's time, the plain version's; the bound over the
    work the chain's algebra needs (f32 instructions at 33.5 T/s, the
    reciprocal and divide chains at the special-function rate, the
    matmuls at the bf16 tensor-core rate with MACs at K); the library row
    for the matmuls: 64 torch.matmul calls in bf16 (none computes a
    dependent elementwise chain in one call). Besides, each kernel's
    device time by torch.profiler: the CUDA events around back-to-back
    launches also count the host's gaps between these short launches."""
    import torch
    from madrona_mp_env_tpu_torch.tools import vpu_probe as vp

    rs = np.random.RandomState(0)
    rows, scene = [], "vpu probe"
    n = vp.ROWS * vp.COLS
    for name in vp.CHAINS:
        a, b = vp.chain_inputs(rs, device="cuda")
        loop = vp.chain_loop(name)
        fn = vp.ENTRIES[name]
        got = fn(a, b, loop)
        want, pms = timed_once(lambda: vp._chain_plain(name, a, b, loop))
        torch.cuda.synchronize()
        err, rel = vp.check_chain(name, got, want, vp.BARS.get(name, 0.0))
        short_err, short_rel = vp.check_short(name, a, b)
        insns, sfu = P1_WORK[name]
        sfu_ops = n * (1 if name == "fan_epilogue" else loop * sfu)
        log(f"[kernel] P1 {name}: max abs err {err:.6g}, max rel err "
            f"{rel:.6g} against its plain version (bar "
            f"{vp.BARS.get(name, 0.0)}), {short_err:.6g} and {short_rel:.6g}"
            f" at {vp.SHORT} links, every element finite; library: none "
            f"(no PyTorch call runs a dependent chain)")
        rows.append(kernel_row(
            scene, f"P1 vpu_chain {name}", P1_SOURCE, P1_TPU, fn, err,
            cuda_time_ms(lambda: fn(a, b, loop), 20), pms, 3 * n * 4,
            n * loop * insns, [[vp.ROWS, vp.COLS, loop]],
            peak=PEAK_F32_INSNS, more=[(sfu_ops, PEAK_SFU)], rel_err=rel,
            short_max_abs_err=short_err, short_rel_err=short_rel,
            device_ms=round(device_ms(lambda: fn(a, b, loop), "vpu_", 20),
                            5)))
    for K, M, N in vp.MM_SHAPES:
        a, b = vp.mm_inputs(rs, K, M, N, device="cuda")
        fn = vp.MM_ENTRIES[K]
        got = fn(a, b, vp.MM_DEPTH)
        want, pms = timed_once(lambda: vp._mm_plain(a, b, vp.MM_DEPTH))
        torch.cuda.synchronize()
        err, rel = vp.check_chain(f"matmul K={K}", got, want, vp.MM_BAR,
                                  finite=True)
        library = cuda_time_ms(
            lambda: [torch.matmul(a, b) for _ in range(vp.MM_DEPTH)], 5)
        log(f"[kernel] P1 vpu_mma K={K}: max abs err {err:.6g}, max rel err "
            f"{rel:.6g} against its plain version (bar {vp.MM_BAR})")
        rows.append(kernel_row(
            scene, f"P1 vpu_mma K={K}", P1_SOURCE, P1_MM_TPU, fn, err,
            cuda_time_ms(lambda: fn(a, b, vp.MM_DEPTH), 20), pms,
            M * K * 2 + K * N * 2 + M * N * 4, vp.MM_DEPTH * M * N * K * 2,
            [[M, K, N, vp.MM_DEPTH]], peak=PEAK_BF16, library_ms=library,
            rel_err=rel,
            device_ms=round(device_ms(lambda: fn(a, b, vp.MM_DEPTH), "vpu_",
                                      20), 5)))
    return rows


def probes_phase(cfg, card):
    """The probes P3 (fused movement, each map), P5, P6, P2, P4 and P1:
    their rows (p3_rows, fan_probe_rows, sc_mxu_rows, vpu_rows), then each
    probe's main as the command line runs it, with every launch counter
    zeroed just before and read just after: its launches are these
    rows'."""
    import torch
    from madrona_mp_env_tpu_torch.tools import fan_probe as p2
    from madrona_mp_env_tpu_torch.tools import vpu_probe as p1
    from madrona_mp_env_tpu_torch.tools.probes import (
        movement_fused_probe as mf, sc_mxu_probe as p4,
        v9_kernel_probe as p5, v9_scan_timing as p6,
    )

    rows = [r for scene in (SCENE, TOWN) for r in p3_rows(cfg, scene)]
    rows += fan_probe_rows() + sc_mxu_rows() + vpu_rows()
    entries = all_entries()
    for f in entries.values():
        f.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for scene in (SCENE, TOWN):
        res = mf.main(["--worlds", str(NUM_WORLDS), "--scene", scene,
                       "--steps", str(P3_STEPS), "--iters", "5"])
        bad = [k for k, v in res.items()
               if any(v[f"vs_{w}_{q}"] for w in ("plain", "split")
                      for q in ("pos", "vel"))]
        if bad:
            raise AssertionError(f"P3 main: fused differs under {bad}")
    res = {"P5": p5.main([]),
           "P6": p6.main(["--chain", str(FAN_PROBE_CHAIN)]),
           "P2": p2.main([])}
    res_p4, res_p1 = p4.main([]), p1.main([])
    torch.cuda.synchronize()
    label = "probes"
    for row in rows:
        row["launches"] = row["entry"].launches
        row["path"] = label
    missing = [r["name"] for r in rows if r["launches"] == 0]
    times = [v for r in res.values() for k, v in r.items()
             if not k.startswith("rcp_approx_")]
    times += [res_p4[k] for k in ("mxu_ms", "prod_ms")]
    times += [r[k] for r in res_p1.values() for k in ("ms", "rate")]
    if missing or not all(np.isfinite(v) and v > 0 for v in times):
        raise AssertionError(f"{label}: kernels not launched {missing} or "
                             f"a bad time {res}")
    log(f"[{label}] {time.perf_counter() - t0:.1f} s on {card}; launches "
        + ", ".join(f"{n}={f.launches}" for n, f in entries.items()))
    return rows


def bench_actions(W, A, steps, seed=0):
    """bench.py's representative run-and-shoot mix, drawn with numpy
    ([steps, W, A] each; the fused-movement probe's own draw)."""
    from madrona_mp_env_tpu_torch.tools.probes import movement_fused_probe

    return movement_fused_probe.bench_actions(W, A, steps, seed)


def actions_at(env, acts, s):
    import torch

    a = env.zero_actions()
    return a.replace(**{k: torch.as_tensor(v[s], dtype=torch.int32,
                                           device=env.device)
                        for k, v in acts.items()})


def rollout(mt, cfg, scene, W, steps, device, seed=5):
    env = mt.Env(cfg, scene, num_worlds=W, seed=seed, device=device)
    acts = bench_actions(W, cfg.num_agents, steps)
    state, obs = env.reset()
    hist = []
    for s in range(steps):
        state, out = env.step(state, actions_at(env, acts, s))
        hist.append({
            "pos": state.pos, "hp": state.hp, "alive": state.alive,
            "team_points": state.team_points, "done": out["done"],
            "reward": out["reward"], "fwd_lidar": out["obs"]["fwd_lidar"],
            "self": out["obs"]["self"],
        })
    return [{k: v.cpu().numpy() for k, v in h.items()} for h in hist]


PROFILE_STEPS = 10


def step_profile(env, state, actions, fused_tail=True, profile=True):
    """PROFILE_STEPS env steps from ``state``: wall ms per step (host clock
    around synchronized steps) and, with ``profile``, CUDA device
    operations per step and the device us per step of K5's kernel
    (torch.profiler). ``fused_tail=False`` runs the unfused chain that K5
    replaced, for comparison in the same process."""
    import torch
    from madrona_mp_env_tpu_torch.sim import step as step_mod

    saved = step_mod.use_tail_fused
    if not fused_tail:
        step_mod.use_tail_fused = lambda cfg: False
    try:
        state, _ = env.step(state, actions)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(PROFILE_STEPS):
            state, _ = env.step(state, actions)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / PROFILE_STEPS
        if not profile:
            return {"wall_ms": wall_ms}
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(PROFILE_STEPS):
                state, _ = env.step(state, actions)
            torch.cuda.synchronize()
    finally:
        step_mod.use_tail_fused = saved
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        raise AssertionError("the profiler saw no CUDA kernels")
    k5_us = sum(e.device_time_total for e in dev
                if "tail_fused_kernel" in e.name)
    return {"wall_ms": wall_ms, "launches": len(dev) / PROFILE_STEPS,
            "k5_us": k5_us / PROFILE_STEPS}


def eval_setup(mt, W, steps, chunk_steps, device):
    """EvalManager, P seeded full-width policies and seeded normalizer
    stats (numpy, so every device gets the same values), on ``device``."""
    import torch
    from madrona_mp_env_tpu_torch.train import (EvalConfig, EvalManager,
                                                build_actor_critic,
                                                init_normalizer)

    cfg = mt.EnvConfig(task=mt.Task.Zone, team_size=TEAM_SIZE,
                       sim_flags=mt.SimFlags.SimEvalMode)
    env = mt.Env(cfg, SCENE, num_worlds=W, seed=5, device=device)
    ecfg = EvalConfig(num_worlds=W, num_eval_steps=steps,
                      chunk_steps=chunk_steps, seed=10)
    mgr = EvalManager(cfg, ecfg, env, EVAL_POLICIES, device=device)
    policies = [build_actor_critic(seed=s, device=device)
                for s in range(EVAL_POLICIES)]
    _, obs, _ = mgr.init_state()
    norm = init_normalizer(mgr._policy_obs(obs))
    g = np.random.default_rng(7)
    for k in sorted(norm.mu):
        n = norm.mu[k].shape[0]
        norm.mu[k] = torch.as_tensor(g.normal(0.0, 0.1, n), dtype=torch.float32,
                                     device=device)
        norm.var[k] = torch.as_tensor(g.uniform(0.5, 2.0, n),
                                      dtype=torch.float32, device=device)
    elo = torch.full((EVAL_POLICIES,), 1500.0, device=device)
    return mgr, policies, norm, elo


def eval_phase(mt, kernels, card):
    """The crossplay eval at EVAL_WORLDS x EVAL_STEPS on the card: rates
    over the steady chunks (after the first, which holds the reset), the
    policy forward's time at the rollout's shapes (CUDA events), and the
    kernels' launches during the run."""
    import torch

    chunk = 10
    mgr, policies, norm, elo = eval_setup(mt, EVAL_WORLDS, EVAL_STEPS, chunk,
                                          "cuda")
    stamps = []

    def on_chunk(outs):
        # run() has synchronized for its zone-swap accounting already
        stamps.append(time.perf_counter())
        for k in ("values", "logits", "rewards"):
            if not bool(torch.isfinite(outs[k]).all()):
                raise AssertionError(f"eval: non-finite {k}")

    fused = all_entries()["apply_velocity_fall_fused"]
    for k in kernels:
        k["entry"].launches = 0
    fused.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    elo = mgr.run(policies, norm, elo, iter_cb=on_chunk, verbose=False)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    launches = {k["name"]: k["entry"].launches for k in kernels}
    missing = [n for n, c in launches.items() if c == 0]
    if missing:
        raise AssertionError(f"kernels not launched by the eval: {missing}")
    if fused.launches:
        raise AssertionError("the eval launched the fused movement (P3)")
    if len(stamps) != EVAL_STEPS // chunk or elo.shape != (EVAL_POLICIES,) \
            or not bool(torch.isfinite(elo).all()):
        raise AssertionError("eval: wrong chunk count or ELO")
    steps_s = (len(stamps) - 1) * chunk / (stamps[-1] - stamps[0])
    _, obs, rnn = mgr.init_state()
    with torch.no_grad():
        fwd_ms = cuda_time_ms(lambda: mgr.forward(policies, norm, obs, rnn),
                              20)
    A = mgr.A
    log(f"[eval] crossplay, {EVAL_WORLDS} worlds x {EVAL_STEPS} sampled steps,"
        f" P = {EVAL_POLICIES} seeded full-width policies: whole run "
        f"{t1 - t0:.3f} s (reset included); steady chunks "
        f"{EVAL_WORLDS * A * steps_s:.1f} agent-steps/s, "
        f"{EVAL_WORLDS * steps_s:.1f} env-steps/s, {1e3 / steps_s:.2f} "
        f"ms/step; policy forward {fwd_ms:.3f} ms/step "
        f"({fwd_ms * steps_s / 10:.1f}% of the step) on {card}; launches "
        + ", ".join(f"{n}={c}" for n, c in launches.items()))


def _gumbel_margin(logits, key):
    """Smallest top-two gap over the heads of log probs + the step key's
    Gumbel noise (ActorDistributions.sample's stream): [P, B / P]."""
    import torch
    from madrona_mp_env_tpu_torch.train.distributions import (
        AIM_BUCKETS, DISCRETE_BUCKETS, gumbel)
    from madrona_mp_env_tpu_torch.utils import rng

    ks = rng.split(key, 2)
    gaps, off = [], 0
    for k, buckets in zip(ks, (DISCRETE_BUCKETS, AIM_BUCKETS)):
        lp = logits[..., off:off + sum(buckets)]
        z = lp + gumbel(k, lp.shape)
        o = 0
        for b in buckets:
            two = torch.topk(z[..., o:o + b], 2, dim=-1).values
            gaps.append(two[..., 0] - two[..., 1])
            o += b
        off += sum(buckets)
    return torch.stack(gaps).amin(0)


def eval_rollout(mt, W, S, device):
    import torch
    from madrona_mp_env_tpu_torch.train.infer import chunk_keys

    mgr, policies, norm, elo = eval_setup(mt, W, S, S, device)
    env_state, obs, rnn = mgr.init_state()
    keys = chunk_keys(mgr.ecfg.seed, 1, S, device=device)[0]
    hist = []
    with torch.no_grad():
        for t in range(S):
            env_state, obs, rnn, elo, o = mgr.step(
                policies, norm, env_state, obs, rnn, elo, keys[t])
            hist.append({
                "discrete": o["actions"]["discrete"], "aim": o["actions"]["aim"],
                "values": o["values"], "logits": o["logits"],
                "hp": env_state.hp, "alive": env_state.alive,
                "team_points": env_state.team_points, "done": o["dones"],
                "key": keys[t],
            })
    return [{k: v.cpu() for k, v in h.items()} for h in hist]


def eval_parity(mt, W, S, margin=1e-4, rel=1e-4):
    """The eval rollout on "cuda" against "cpu": actions equal wherever the
    CPU run's Gumbel top-two margin exceeds ``margin``; values and logits
    within rel * max(1, |x|); hp, alive, team points and done exact; all
    up to the first step where an action differs."""
    gpu = eval_rollout(mt, W, S, "cuda")
    cpu = eval_rollout(mt, W, S, "cpu")
    worst, compared, undecided = {}, 0, 0
    for t, (a, b) in enumerate(zip(gpu, cpu)):
        decided = _gumbel_margin(b["logits"], b["key"]) > margin
        undecided += int((~decided).sum())
        same = (a["discrete"] == b["discrete"]).all(-1) & (
            a["aim"] == b["aim"]).all(-1)
        if not bool(same[decided].all()):
            raise AssertionError(f"eval step {t}: decided actions differ")
        for k in ("values", "logits"):  # computed before this step's actions
            e = ((a[k] - b[k]).abs() / b[k].abs().clamp(min=1.0)).max()
            worst[k] = max(worst.get(k, 0.0), float(e))
            if float(e) > rel:
                raise AssertionError(f"eval step {t}: {k} rel err {float(e)}")
        compared = t + 1
        if not bool(same.all()):
            break  # an undecided action parted the two runs
        for k in ("hp", "alive", "team_points", "done"):
            if not np.array_equal(a[k].numpy(), b[k].numpy()):
                raise AssertionError(f"eval step {t}: {k} differs cuda vs cpu")
    log(f"[eval parity] cuda vs cpu, {W} worlds x {S} steps: {compared} steps"
        f" compared, actions equal where decided ({undecided} undecided of "
        f"{compared * W * 2 * TEAM_SIZE}), hp/alive/team points/done exact, "
        + ", ".join(f"{k} max rel err {v:.3g}" for k, v in worst.items()))


def all_entries():
    """Every kernel entry of the port, by name; each counts its launches."""
    from madrona_mp_env_tpu_torch.ops import raycast, raycast_cull, tail_fused
    from madrona_mp_env_tpu_torch.tools import fan_probe, vpu_probe
    from madrona_mp_env_tpu_torch.tools.probes import (
        movement_fused_probe, sc_mxu_probe, v9_kernel_probe, v9_scan_timing,
    )

    return {f.__name__: f for f in (
        raycast.ray_vs_tris, raycast.ray_fans_vs_tris,
        raycast.ray_fans_culled, raycast.fan_cell_order,
        raycast.ray_fans_culled_v1, raycast.ray_fans_culled_v9,
        raycast.ray_fans_vs_tris_flat, raycast_cull.fan_capsules,
        raycast_cull.fan_capsules_explicit, raycast.sphere_cast,
        raycast.sphere_cast_vs_tris, raycast.sphere_cast_culled,
        raycast.sphere_cast_packed, tail_fused.tail_fused,
        movement_fused_probe.apply_velocity_fall_fused,
        v9_kernel_probe.ray_fans_v9_gathered,
        v9_scan_timing.ray_fans_v9_chunked,
        *fan_probe.ENTRIES.values(), sc_mxu_probe.sphere_cast_mxu,
        *vpu_probe.ENTRIES.values(), *vpu_probe.MM_ENTRIES.values())}


def expect_launches(rows, name, n):
    """The path's launches of the kernel row ``name`` (drive_path) are n:
    one per Env.reset and Env.step."""
    (row,) = [r for r in rows if r["name"].startswith(name + " [")]
    if row["launches"] != n:
        raise AssertionError(f"{row['name']}: {row['launches']} launches on "
                             f"{row['path']}, expected {n}")
    log(f"[launches] {row['name']}: {n} on {row['path']}")


def drive_path(label, env, acts, steps, rows, not_launched, card):
    """Reset + ``steps`` steps of ``env`` with every launch counter zeroed
    just before and read just after. Each row of ``rows`` (this path's
    kernels) gets its entry's count as ``launches`` and must be > 0; the
    entries named in ``not_launched`` must stay at 0 (a gate that fell
    back fails the run). Returns (state, out, env-steps/s)."""
    import torch

    entries = all_entries()
    for f in entries.values():
        f.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, obs = env.reset()
    t_reset = time.perf_counter()
    for s in range(steps):
        state, out = env.step(state, actions_at(env, acts, s))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    counts = {n: f.launches for n, f in entries.items()}
    for name, x in out["obs"].items():
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"{label}: non-finite obs {name}")
    for row in rows:
        row["launches"] = row["entry"].launches
        row["path"] = label
    missing = [r["name"] for r in rows if r["launches"] == 0]
    if missing:
        raise AssertionError(f"{label}: kernels not launched: {missing}")
    wrong = [n for n in not_launched if counts[n]]
    if wrong:
        raise AssertionError(f"{label}: launched {wrong}, which this path "
                             f"must not: {counts}")
    sps = env.num_worlds * steps / (t1 - t_reset)
    log(f"[{label}] {env.num_worlds} worlds x {steps} steps: reset "
        f"{t_reset - t0:.3f} s, steps {t1 - t_reset:.3f} s, {sps:.1f} "
        f"env-steps/s on {card}; launches "
        + ", ".join(f"{n}={c}" for n, c in counts.items()))
    return state, out, sps


def env_parity(mt, cfg, scene, W, S):
    """The env rollout on "cuda" against "cpu" from one seed: hp, alive,
    team points and done exact; pos and reward within 1e-4, lidar and
    self observations within 1e-3, each times max(1, |x|)."""
    gpu = rollout(mt, cfg, scene, W, S, "cuda")
    cpu = rollout(mt, cfg, scene, W, S, "cpu")
    worst = {}
    name = os.path.basename(scene)
    for s, (a, b) in enumerate(zip(gpu, cpu)):
        for k in ("hp", "alive", "team_points", "done"):
            if not np.array_equal(a[k], b[k]):
                raise AssertionError(f"{name} step {s}: {k} differs cuda vs "
                                     "cpu")
        for k, rel in (("pos", 1e-4), ("reward", 1e-4), ("fwd_lidar", 1e-3),
                       ("self", 1e-3)):
            e = np.abs(a[k] - b[k]) / np.maximum(1.0, np.abs(b[k]))
            worst[k] = max(worst.get(k, 0.0), float(e.max()))
            if e.max() > rel:
                raise AssertionError(f"{name} step {s}: {k} rel err "
                                     f"{e.max()}")
    log(f"[parity] {name} Zone {cfg.team_size}v{cfg.team_size} cuda vs cpu, "
        f"{W} worlds x {S} steps: discrete "
        "exact, " + ", ".join(f"{k} max rel err {v:.3g}"
                              for k, v in worst.items()))


TRAIN_WORLDS = 1024
TRAIN_STEPS = 40  # steps_per_update, the JAX bench's train row
# route: (map, team size, MPENV_FAN_V9, updates, the sensor fan's entry)
TRAIN_ROUTES = {
    "default": (SCENE, TEAM_SIZE, "0", 3, "ray_fans_vs_tris"),
    "v9": (SCENE, TEAM_SIZE, "1", 2, "ray_fans_culled_v9"),
    "zone3v3": (SCENE, 3, "0", 1, "ray_fans_vs_tris_flat"),
    "zone3v3 town_map": (TOWN, 3, "0", 1, "ray_fans_vs_tris_flat"),
}
FAN_ENTRIES = ("ray_fans_vs_tris", "ray_fans_culled", "ray_fans_culled_v9",
               "ray_fans_vs_tris_flat")


def train_phase(card):
    """The training path at full width through the train CLI's own
    builder: TrainingManager at TRAIN_WORLDS worlds x TRAIN_STEPS steps
    per update (4 BPTT chunks, 2 epochs x 4 minibatches), the LSTM-512
    policy, E = 1, weights from a seed, on each of TRAIN_ROUTES: Zone 6v6
    on the default fan route (K2), then with MPENV_FAN_V9=1 (K9), then
    Zone 3v3 (K7) on each map. Each update's rollout and PPO update are
    timed by CUDA events; every launch counter is zeroed before each run
    and read after it; the loss must be finite, the parameters must move,
    and the sensor fans must go through the route's entry alone."""
    import torch
    from madrona_mp_env_tpu_torch.train import train as train_cli

    for route, (scene, ts_, v9, n, fan) in TRAIN_ROUTES.items():
        with mock.patch.dict(os.environ, {"MPENV_FAN_V9": v9}):
            args = train_cli.parse_args([
                "--scene", scene, "--num-worlds", str(TRAIN_WORLDS),
                "--steps-per-update", str(TRAIN_STEPS),
                "--team-size", str(ts_)])
            _, tcfg, env, mgr = train_cli.build(args)
            ts = mgr.init()
            p0 = {k: v.clone() for k, v in ts.params[0].items()}
            entries = all_entries()
            for f in entries.values():
                f.launches = 0
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            roll_ms, ppo_ms, losses = [], [], []
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                ev[0].record()
                ts, starts, outs, boot = mgr.rollout(ts)
                ev[1].record()
                ts, metrics = mgr.ppo_update(ts, starts, outs, boot)
                ev[2].record()
                torch.cuda.synchronize()
                roll_ms.append(ev[0].elapsed_time(ev[1]))
                ppo_ms.append(ev[1].elapsed_time(ev[2]))
                losses.append(float(metrics["loss"][0]))
            t1 = time.perf_counter()
        counts = {k: f.launches for k, f in entries.items()}
        moved = max(float((ts.params[0][k] - v).abs().max())
                    for k, v in p0.items())
        if not all(np.isfinite(losses)) or moved == 0.0:
            raise AssertionError(f"train {route}: losses {losses}, params "
                                 f"moved {moved}")
        if counts[fan] != n * TRAIN_STEPS or any(
                counts[f] for f in FAN_ENTRIES if f != fan):
            raise AssertionError(f"train {route}: fan launches {counts}")
        samples = TRAIN_WORLDS * 2 * ts_ * TRAIN_STEPS
        ups = n / (t1 - t0)
        log(f"[train {route}] {TRAIN_WORLDS} worlds x {TRAIN_STEPS} steps x "
            f"{n} updates, LSTM-512, E = 1: {ups:.4f} updates/s, "
            f"{ups * samples:.1f} samples/s; rollout ms "
            + ", ".join(f"{x:.1f}" for x in roll_ms) + "; PPO update ms "
            + ", ".join(f"{x:.1f}" for x in ppo_ms)
            + f" (CUDA events); losses "
            + ", ".join(f"{x:.5f}" for x in losses)
            + f"; params moved up to {moved:.3g}; launches "
            + ", ".join(f"{k}={c}" for k, c in counts.items())
            + f" on {card}")
        del ts, mgr, env


def train_parity(W=4, S=8):
    """The trainer on "cuda" against "cpu" from one seed at W worlds x S
    steps: the rollouts' actions equal where the CPU run's Gumbel top-two
    margin exceeds 1e-4, values and rewards within 1e-4 relative, up to
    the first step an action differs; then one PPO update of each device
    on the CPU rollout's data: loss terms within 1e-4 * max(1, |x|) and
    parameters within 2.5 lr."""
    import torch
    from madrona_mp_env_tpu_torch.train import train as train_cli
    from madrona_mp_env_tpu_torch.utils import rng

    runs = {}
    for dev in ("cuda", "cpu"):
        args = train_cli.parse_args([
            "--scene", SCENE, "--num-worlds", str(W), "--steps-per-update",
            str(S), "--num-bptt-chunks", "2", "--num-minibatches", "2",
            "--team-size", str(TEAM_SIZE)] + (["--cpu"] if dev == "cpu"
                                              else []))
        _, tcfg, env, mgr = train_cli.build(args)
        ts = mgr.init()
        logits = []
        apply = mgr.apply_blocks

        def rec(*a, _apply=apply, _logits=logits):
            out = _apply(*a)
            _logits.append(out[0])
            return out

        mgr.apply_blocks = rec
        ro = mgr.rollout(ts)
        mgr.apply_blocks = apply
        runs[dev] = (mgr, ts, ro, logits[:S])
    (mg, tg, (_, _, og, _), _), (mc, tc, (tc1, sc, oc, bc), lc) = (
        runs["cuda"], runs["cpu"])
    keys = rng.split(rng.split(tc.key, 2)[1], S)  # the rollout's steps
    compared, undecided = 0, 0
    for t in range(S):
        margin = _gumbel_margin(torch.cat(
            [lc[t].discrete.packed_log_probs(),
             lc[t].aim.packed_log_probs()], -1),
            rng.split(keys[t], 2)[0]).reshape(-1)
        decided = margin > 1e-4
        undecided += int((~decided).sum())
        ag = og["act_pack"].reshape((S,) + og["act_pack"].shape[2:])[t]
        ac = oc["act_pack"].reshape((S,) + oc["act_pack"].shape[2:])[t]
        same = (ag.cpu() == ac).all(-1).reshape(-1)
        if not bool(same[decided].all()):
            raise AssertionError(f"train parity step {t}: decided actions "
                                 "differ")
        for k in ("values", "rewards"):
            a = og[k].reshape((S, -1))[t].cpu()
            b = oc[k].reshape((S, -1))[t]
            e = float(((a - b).abs() / b.abs().clamp(min=1.0)).max())
            if e > 1e-4:
                raise AssertionError(f"train parity step {t}: {k} {e}")
        compared = t + 1
        if not bool(same.all()):
            break
    # one PPO update of each device on the CPU rollout
    to = {k: (v.cuda() if isinstance(v, torch.Tensor)
              else {kk: vv.cuda() for kk, vv in v.items()})
          for k, v in oc.items()}
    tsg = dataclasses.replace(tg, key=tc1.key.cuda())
    ug, mgm = mg.ppo_update(tsg, sc.cuda(), to, bc.cuda())
    uc, mcm = mc.ppo_update(tc1, sc, oc, bc)
    worst = 0.0
    for k in mcm:
        e = float(((mgm[k].cpu() - mcm[k]).abs()
                   / mcm[k].abs().clamp(min=1.0)).max())
        worst = max(worst, e)
        if e > 1e-4:
            raise AssertionError(f"train parity: {k} rel err {e}")
    dp = max(float((ug.params[0][k].cpu() - v).abs().max())
             for k, v in uc.params[0].items())
    lr = mc.tcfg.lr
    if dp > 2.5 * lr:
        raise AssertionError(f"train parity: params differ by {dp}")
    log(f"[train parity] cuda vs cpu, {W} worlds x {S} steps: {compared} "
        f"steps compared, actions equal where decided ({undecided} "
        f"undecided), values and rewards within 1e-4; PPO update on one "
        f"rollout: loss terms max rel err {worst:.3g}, params max abs diff "
        f"{dp:.3g} ({dp / lr:.3g} lr)")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import madrona_mp_env_tpu_torch as mt
    from madrona_mp_env_tpu_torch.ops import cuda_build

    # 1. the card
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[card] {card}")
    log(f"[versions] python {sys.version.split()[0]} torch {torch.__version__}"
        f" cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build
    t0 = time.perf_counter()
    cuda_build.build_all()
    log(f"[build] {len(cuda_build.KERNEL_SOURCES)} kernels in "
        f"{time.perf_counter() - t0:.1f} s -> {cuda_build.BUILD_DIR}")
    # the fused movement's registers and spills (ptxas -v)
    for line in cuda_build.build_log("move_fused").splitlines():
        if "registers" in line or "spill" in line or "properties" in line:
            log(f"[build] move_fused: {line.strip()}")
    # the register-blocked fans K2 and K6 (csrc/fan_sweep_rb.cuh)
    for src, kern in (("fan_tris", "fan_tris_rb_kernel"),
                      ("fan_culled", "fan_culled_rb_kernel")):
        regs, spill = cuda_build.ptxas_usage(src, kern)
        log(f"[build] {kern}: {regs} registers, {spill} bytes spilled")

    cfg = mt.EnvConfig(
        task=mt.Task.Zone, team_size=TEAM_SIZE,
        sim_flags=mt.SimFlags.StaggerStarts | mt.SimFlags.RandomFlipTeams,
    )
    acts = bench_actions(NUM_WORLDS, cfg.num_agents, NUM_STEPS)

    # 3. kernels vs plain versions on one real step's launches, each map
    env = mt.Env(cfg, SCENE, num_worlds=NUM_WORLDS, seed=5, device="cuda")
    state, _ = env.reset()
    simple = simple_kernels(env, state, actions_at(env, acts, 0))
    town_env = mt.Env(cfg, TOWN, num_worlds=NUM_WORLDS, seed=5,
                      device="cuda")
    state, _ = town_env.reset()
    town = town_kernels(town_env, state, actions_at(town_env, acts, 0))
    del state
    # Zone 3v3 on each map: K7 (and K5 at team size 3) on a real step
    cfg3 = dataclasses.replace(cfg, team_size=3)
    acts3 = bench_actions(NUM_WORLDS, cfg3.num_agents, TEAM3_STEPS)
    team3 = {}
    for scene in (SCENE, TOWN):
        env3 = mt.Env(cfg3, scene, num_worlds=NUM_WORLDS, seed=5,
                      device="cuda")
        state, _ = env3.reset()
        name = os.path.basename(scene)
        team3[name] = (env3, team3_kernels(env3, state,
                                           actions_at(env3, acts3, 0), name))
        del state
    # K7, K8 and K3x at the kernel bench's shapes, and the bench itself
    bench = [row for scene in (SCENE, TOWN) for ts in (TEAM_SIZE, 3)
             for row in bench_kernels(mt, scene, ts, card)]
    # the probes P3 (each map), P5, P6, P2, P4 and P1, each through its main
    probes = probes_phase(cfg, card)
    kernels = (simple + town + [r for _, rs in team3.values() for r in rs]
               + bench + probes)

    def rows(scene, *names):
        return [k for k in kernels if k["scene"] == scene
                and k["name"].split(" [")[0] in names]

    # 4. the simple_map path on the card
    main_simple = rows("simple_map", "K1 ray_vs_tris", "K2 ray_fans_vs_tris",
                       "K3 fan_capsules", "K4 sphere_cast_culled",
                       "K4' sphere_cast_packed", "K5 tail_fused")
    state, out, _ = drive_path(
        "slice simple_map", env, acts, NUM_STEPS, main_simple,
        ("sphere_cast", "ray_fans_culled", "fan_cell_order",
         "ray_fans_culled_v1", "ray_fans_culled_v9",
         "ray_fans_vs_tris_flat", "apply_velocity_fall_fused"), card)
    expect_launches(main_simple, "K2 ray_fans_vs_tris", NUM_STEPS + 1)
    # the same steps with the fused tail and with the unfused chain, in
    # turns (fused, unfused, unfused, fused) from one state
    a0 = actions_at(env, acts, 0)
    runs = [step_profile(env, state, a0, fused_tail=f, profile=p)
            for f, p in ((True, True), (False, True), (False, False),
                         (True, False))]
    fused, unfused = runs[0], runs[1]
    wall_f = (runs[0]["wall_ms"] + runs[3]["wall_ms"]) / 2
    wall_u = (runs[1]["wall_ms"] + runs[2]["wall_ms"]) / 2
    if fused["k5_us"] <= 0.0 or unfused["k5_us"] != 0.0:
        raise AssertionError("K5's kernel missing from the fused profile")
    log(f"[launches] {NUM_WORLDS} worlds, {PROFILE_STEPS} steps each way "
        f"(torch.profiler): CUDA launches per step {fused['launches']:.1f} "
        f"with the fused tail (K5 device time {fused['k5_us']:.2f} us/step), "
        f"{unfused['launches']:.1f} with the unfused chain; wall ms/step "
        f"(fused, unfused, unfused, fused) "
        + ", ".join(f"{r['wall_ms']:.2f}" for r in runs)
        + f": fused {wall_f:.2f}, unfused {wall_u:.2f} on {card}")
    del state, out

    # 4b. the same path on the sensor-ray tables (MPENV_FAN_V9=1): K9 for K2
    with mock.patch.dict(os.environ, MPENV_FAN_V9="1"):
        drive_path("sensor-ray tables simple_map", env, acts, NUM_STEPS,
                   rows("simple_map", "K9 ray_fans_culled_v9"),
                   ("ray_fans_vs_tris", "ray_fans_culled", "fan_cell_order",
                    "sphere_cast",
                    "ray_fans_vs_tris_flat"), card)

    # 5. the crossplay eval on the card (simple_map's kernels)
    eval_phase(mt, main_simple, card)

    # 6. K4 dense: the L2/L3/fall casts over the soup (MPENV_SC_PACK=0)
    with mock.patch.dict(os.environ, MPENV_SC_PACK="0"):
        drive_path("dense casts simple_map", env, acts, FORCED_STEPS,
                   rows("simple_map", "K4 sphere_cast (dense)"),
                   ("sphere_cast_packed",), card)
    del env

    # 7. the town_map path on the card, then its forced-dense fan route
    town_rows = rows("town_map", "K1 ray_vs_tris", "K3 fan_capsules",
                     "K4 sphere_cast_culled", "K4' sphere_cast_packed",
                     "K5 tail_fused", "K6 ray_fans_culled", "K6 cell order")
    drive_path("slice town_map", town_env, acts, NUM_STEPS, town_rows,
               ("ray_fans_vs_tris", "ray_fans_culled_v1", "ray_fans_culled_v9",
                "sphere_cast", "ray_fans_vs_tris_flat",
                "apply_velocity_fall_fused"), card)
    expect_launches(town_rows, "K6 ray_fans_culled", NUM_STEPS + 1)
    expect_launches(town_rows, "K6 cell order", NUM_STEPS + 1)
    with mock.patch.dict(os.environ, MPENV_FAN_CULL="0"):
        dense_rows = rows("town_map", "K2 ray_fans_vs_tris")
        drive_path("dense fans town_map", town_env, acts, FORCED_STEPS,
                   dense_rows, ("ray_fans_culled", "fan_cell_order"), card)
        expect_launches(dense_rows, "K2 ray_fans_vs_tris", FORCED_STEPS + 1)
    del town_env

    # 7b. Zone 3v3 on each map: the world fan is K7 alone, on town_map too
    for name, (env3, rows3) in team3.items():
        drive_path(f"Zone 3v3 {name}", env3, acts3, TEAM3_STEPS, rows3,
                   ("ray_fans_vs_tris", "ray_fans_culled", "fan_cell_order",
                    "ray_fans_culled_v9", "sphere_cast"), card)
    del team3, env3

    # 8. the training path: full width on the card, then against the CPU
    train_phase(card)

    # 9. kernel path vs plain path
    env_parity(mt, cfg, SCENE, 4, 16)
    env_parity(mt, cfg, TOWN, 4, 16)
    env_parity(mt, cfg3, SCENE, 4, 16)
    env_parity(mt, cfg3, TOWN, 4, 16)
    eval_parity(mt, 4, 16)
    train_parity()

    # 10. results
    missing = [k["name"] for k in kernels if "launches" not in k]
    if missing:
        raise AssertionError(f"no path drove {missing}")
    line = {"kernels": [
        {k2: k[k2] for k2 in ("name", "route", "source", "replaces",
                              "launches", "max_abs_err", "ms", "plain_ms",
                              "bound_ms", "bound_by", "path")}
        | {"library_ms": k.get("library_ms")}
        | {k2: k[k2] for k2 in REDESIGN_KEYS if k2 in k}
        for k in kernels
    ]}
    print(json.dumps(line), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
