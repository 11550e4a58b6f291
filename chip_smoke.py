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
   full width);
4. the simple_map path: Env(device="cuda") at 1024 worlds, reset + 100
   steps of bench.py's run-and-shoot action mix, every launch counter
   zeroed before and read after: K1, K2, K3, K4 culled, K4' and K5 must
   launch, K4 dense, K6 and K9 must not; env-steps/s beside the card's
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
   culled, K4', K5 and K6 must launch, K2 and K4 dense must not; then 10
   steps of the forced-dense fan route (MPENV_FAN_CULL=0), where K2 runs
   over the 6,144-triangle soup;
8. the training path: the train CLI's TrainingManager at 1024 worlds x
   40 steps per update, the LSTM-512 policy, E = 1: 3 updates on the
   default fan route (K2), then 2 with MPENV_FAN_V9=1 (K9); updates/s,
   samples/s and each update's rollout and PPO-update ms (CUDA events);
   finite losses, parameters that move;
9. the kernel path against the plain path: the same 4-world, 16-step env
   rollout on both maps, the same 4-world, 16-step eval rollout, and the
   trainer's 4-world, 8-step rollout and one PPO update, on "cuda" and on
   "cpu" from one seed;
10. a line of kernel results (JSON, one row per kernel and map, each with
   the path whose launches it counts), then the card line, then the last
   line {"ok": true, "device": {...}}.

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
TEAM_SIZE = 6

# H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor cores, HBM3
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12

# f32 arithmetic operations (add, sub, mul, div, sqrt, min) per pair as the
# kernels write them (csrc/tri_math.cuh); comparisons and selects not counted
OPS_RAY_TRI = 47  # two crosses (18), four dots (20), divide, 3 scales, u+v, min
OPS_FAN_PAIR = 32  # K2 after hoisting: cross, 2 dots, divide, 3 scales, u+v, min
OPS_FAN_HOIST = 20  # per (fan, group, triangle): tvec, cross, dot
OPS_CAPSULE = 75  # 5 dots, cylinder quadratic (~20), two cap spheres (~30)
OPS_SPHERE_TRI = 330  # closest point (~80), face test (~45), 3 capsules
# K5 per agent (csrc/tail_fused.cu): autoheal 2, zone distance 9,
# membership frame 7, reward terms 19, blend 4, spread 2 per teammate and
# 5 per teammate pair
OPS_TAIL_AGENT = 41
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


def bound_ms(nbytes, nops):
    b = nbytes / PEAK_BYTES
    o = nops / PEAK_F32
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


# where the step calls each kernel's entry: (sim module, name)
ENTRY_SITES = (
    ("combat", "ray_vs_tris"), ("observations", "ray_fans_vs_tris"),
    ("observations", "ray_fans_culled"),
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


def sc_dense_plain(o, d, r, soup):
    from madrona_mp_env_tpu_torch.ops import raycast

    return chunked(lambda s: raycast._sphere_cast_dense(o[s], d[s], r, soup),
                   o.shape[0], max(64, 2 ** 19 // soup.num_tris))


class KernelPhase:
    """Each kernel against its plain version on the card, on the inputs of
    every launch one real step makes (captured from the main path at 1024
    worlds). ms, plain_ms and bound_ms are per step: the sum over that
    step's launches of the entry. ``scene`` tags every row."""

    def __init__(self, env, scene):
        self.env, self.scene, self.results = env, scene, []
        self.soup = env.map_data.tris
        self.T_real = int(self.soup.valid.sum())

    def record(self, name, source, replaces, entry, err, ms, pms, nbytes,
               nops, shapes, **extra):
        bms, by = bound_ms(nbytes, nops)
        row = dict(name=f"{name} [{self.scene}]", route="cuda",
                   source=source, replaces=replaces, entry=entry,
                   max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=bms,
                   bound_by=by, shapes=shapes, scene=self.scene, **extra)
        self.results.append(row)
        log(f"[kernel] {row['name']} at {shapes}: max_abs_err {err:.3g} "
            f"kernel {ms:.4f} ms/step plain {pms:.4f} ms/step bound "
            f"{bms:.4f} ms ({by})"
            + "".join(f" {k} {v}" for k, v in extra.items()))
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
        """K2 over the whole soup; returns its t for the PVS comparison."""
        from madrona_mp_env_tpu_torch.ops import raycast

        soup = self.soup
        N, G = zgf.shape
        F = dirf[0].shape[-1]

        def fan_kernel():
            return raycast.ray_fans_vs_tris(org, zgf, dirf, zgroups, soup)

        def fan_plain():
            return chunked(lambda s: raycast._ray_fans_dense(
                org[s], zgf[s], tuple(c[s] for c in dirf), zgroups, soup), N,
                max(16, 2 ** 18 // soup.num_tris))

        t = fan_kernel()
        err = check_t("K2 ray_fans_vs_tris", t, fan_plain())
        self.record(
            "K2 ray_fans_vs_tris", "madrona_mp_env_tpu_torch/csrc/fan_tris.cu",
            "madrona_mp_env_tpu/ops/raycast_pallas.py:383",
            raycast.ray_fans_vs_tris, err, cuda_time_ms(fan_kernel, 10),
            cuda_time_ms(fan_plain, 1),
            N * (12 + 4 * G) + 3 * N * F * 4 + self.T_real * 40 + N * F * 4,
            N * F * self.T_real * OPS_FAN_PAIR
            + N * G * self.T_real * OPS_FAN_HOIST,
            [[N, F, soup.num_tris]])
        return t

    def k6(self, calls):
        """K6 over each fan's PVS cell; then K2 on the same fans (the soup
        of a big map), and how often the two agree."""
        import torch
        from madrona_mp_env_tpu_torch.ops import raycast

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

        t6 = kernel()
        err = check_t("K6 ray_fans_culled", t6, plain())
        n_valid = (tables.cand_idx >= 0).sum(-1)[cells.long()]  # [N]
        pairs = int(n_valid.sum()) * F
        row = self.record(
            "K6 ray_fans_culled",
            "madrona_mp_env_tpu_torch/csrc/fan_culled.cu",
            "madrona_mp_env_tpu/ops/raycast_pallas.py:465",
            raycast.ray_fans_culled, err, cuda_time_ms(kernel, 10),
            cuda_time_ms(plain, 1),
            N * (16 + 4 * G) + 3 * N * F * 4 + tables.cand_idx.numel() * 4
            + self.T_real * 40 + N * F * 4,
            pairs * OPS_FAN_PAIR + int(n_valid.sum()) * G * OPS_FAN_HOIST,
            [[N, F, tables.K]],
            mean_valid_candidates=round(float(n_valid.float().mean()), 1))
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
    ph = KernelPhase(env, "simple_map")
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
    ph = KernelPhase(env, "town_map")
    calls = capture_step_calls(env, state, actions, TOWN_ENTRIES)
    ph.k1(calls)
    ph.k6(calls)
    ph.k3(calls)
    ph.k4_culled(calls)
    ph.k4_packed(calls)
    ph.k5(calls)
    return ph.results


def bench_actions(W, A, steps, seed=0):
    """bench.py's representative run-and-shoot mix, drawn with numpy."""
    g = np.random.default_rng(seed)
    shape = (steps, W, A)
    return {
        "move_amount": g.integers(0, 3, shape), "move_angle":
        g.integers(0, 8, shape), "fire": g.integers(0, 2, shape),
        "stand": np.zeros(shape, np.int64), "aim_yaw":
        g.integers(0, 13, shape), "aim_pitch": g.integers(0, 7, shape),
    }


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

    for k in kernels:
        k["entry"].launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    elo = mgr.run(policies, norm, elo, iter_cb=on_chunk, verbose=False)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    launches = {k["name"]: k["entry"].launches for k in kernels}
    missing = [n for n, c in launches.items() if c == 0]
    if missing:
        raise AssertionError(f"kernels not launched by the eval: {missing}")
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

    return {f.__name__: f for f in (
        raycast.ray_vs_tris, raycast.ray_fans_vs_tris,
        raycast.ray_fans_culled, raycast.ray_fans_culled_v9,
        raycast_cull.fan_capsules,
        raycast.sphere_cast, raycast.sphere_cast_culled,
        raycast.sphere_cast_packed, tail_fused.tail_fused)}


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
    log(f"[parity] {name} cuda vs cpu, {W} worlds x {S} steps: discrete "
        "exact, " + ", ".join(f"{k} max rel err {v:.3g}"
                              for k, v in worst.items()))


TRAIN_WORLDS = 1024
TRAIN_STEPS = 40  # steps_per_update, the JAX bench's train row
TRAIN_UPDATES = {"default": 3, "v9": 2}


def train_phase(card):
    """The training path at full width through the train CLI's own
    builder: TrainingManager at TRAIN_WORLDS worlds x TRAIN_STEPS steps
    per update (4 BPTT chunks, 2 epochs x 4 minibatches), the LSTM-512
    policy, E = 1, weights from a seed. TRAIN_UPDATES["default"] updates
    on the default fan route (K2), then TRAIN_UPDATES["v9"] with
    MPENV_FAN_V9=1 (K9). Each update's rollout and PPO update are timed
    by CUDA events; every launch counter is zeroed before each run and
    read after it; the loss must be finite and the parameters must
    move."""
    import torch
    from madrona_mp_env_tpu_torch.train import train as train_cli

    for route, n in TRAIN_UPDATES.items():
        env_vars = {"MPENV_FAN_V9": "1" if route == "v9" else "0"}
        with mock.patch.dict(os.environ, env_vars):
            args = train_cli.parse_args([
                "--scene", SCENE, "--num-worlds", str(TRAIN_WORLDS),
                "--steps-per-update", str(TRAIN_STEPS),
                "--team-size", str(TEAM_SIZE)])
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
        fan = "ray_fans_culled_v9" if route == "v9" else "ray_fans_vs_tris"
        other = "ray_fans_vs_tris" if route == "v9" else "ray_fans_culled_v9"
        if counts[fan] != n * TRAIN_STEPS or counts[other] or \
                counts["ray_fans_culled"]:
            raise AssertionError(f"train {route}: fan launches {counts}")
        samples = TRAIN_WORLDS * 2 * TEAM_SIZE * TRAIN_STEPS
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
    kernels = simple + town

    def rows(scene, *names):
        return [k for k in kernels if k["scene"] == scene
                and k["name"].split(" [")[0] in names]

    # 4. the simple_map path on the card
    main_simple = rows("simple_map", "K1 ray_vs_tris", "K2 ray_fans_vs_tris",
                       "K3 fan_capsules", "K4 sphere_cast_culled",
                       "K4' sphere_cast_packed", "K5 tail_fused")
    state, out, _ = drive_path(
        "slice simple_map", env, acts, NUM_STEPS, main_simple,
        ("sphere_cast", "ray_fans_culled", "ray_fans_culled_v9"), card)
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
                   ("ray_fans_vs_tris", "ray_fans_culled", "sphere_cast"),
                   card)

    # 5. the crossplay eval on the card (simple_map's kernels)
    eval_phase(mt, main_simple, card)

    # 6. K4 dense: the L2/L3/fall casts over the soup (MPENV_SC_PACK=0)
    with mock.patch.dict(os.environ, MPENV_SC_PACK="0"):
        drive_path("dense casts simple_map", env, acts, FORCED_STEPS,
                   rows("simple_map", "K4 sphere_cast (dense)"),
                   ("sphere_cast_packed",), card)
    del env

    # 7. the town_map path on the card, then its forced-dense fan route
    drive_path("slice town_map", town_env, acts, NUM_STEPS,
               rows("town_map", "K1 ray_vs_tris", "K3 fan_capsules",
                    "K4 sphere_cast_culled", "K4' sphere_cast_packed",
                    "K5 tail_fused", "K6 ray_fans_culled"),
               ("ray_fans_vs_tris", "ray_fans_culled_v9", "sphere_cast"),
               card)
    with mock.patch.dict(os.environ, MPENV_FAN_CULL="0"):
        drive_path("dense fans town_map", town_env, acts, FORCED_STEPS,
                   rows("town_map", "K2 ray_fans_vs_tris"),
                   ("ray_fans_culled",), card)
    del town_env

    # 8. the training path: full width on the card, then against the CPU
    train_phase(card)

    # 9. kernel path vs plain path
    env_parity(mt, cfg, SCENE, 4, 16)
    env_parity(mt, cfg, TOWN, 4, 16)
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
        | {"library_ms": None}
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
