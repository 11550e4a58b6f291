#!/usr/bin/env python3
"""Drive the PyTorch port (madrona_mp_env_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run loudly:

1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
2. build every CUDA kernel of the env step from csrc/ (one nvcc per
   source, all at once);
3. each kernel (K1 hitscan rays, K2 sensor fans, K3 sensor rays vs
   capsules, K4 sphere casts: dense and short-table culled, K5 the fused
   scalar tail) against its plain PyTorch version on the card, on the
   inputs of every launch that one real step of the slice makes (1024
   worlds of Zone 6v6 on simple_map, captured where the sim calls each
   entry), with its time, the plain version's time and its bound, each
   summed over the step's launches of that entry;
4. the slice: Env(device="cuda") at 1024 worlds, reset + 100 steps of
   bench.py's run-and-shoot action mix, with every launch counter zeroed
   before and read after; env-steps/s beside the card's name and limit;
   then CUDA launches per step from torch.profiler, with the fused tail
   and, for comparison in the same process, with the unfused chain it
   replaced;
5. the crossplay eval: EvalManager on the card at 1024 worlds with P = 2
   policies at full width (weights made from seeds: the trained
   checkpoint needs JAX to read), 100 sampled steps, every counter zeroed
   before and read after; agent-steps/s, env-steps/s and the policy
   forward's ms per step;
6. the kernel path against the plain path: the same 4-world, 16-step env
   rollout, and the same 4-world, 16-step eval rollout, on "cuda" and on
   "cpu" from one seed;
7. a line of kernel results (JSON), then the card line, then the last
   line {"ok": true, "device": {...}}.

Exits non-zero with no result line when there is no CUDA device or when
the port's package is not beside this script.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SCENE = os.path.join(REPO, "data", "simple_map")
NUM_WORLDS = 1024
NUM_STEPS = 100
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
    ("observations", "fan_capsules"), ("movement", "sphere_cast"),
    ("movement", "sphere_cast_culled"), ("step", "tail_fused"),
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


def capture_step_calls(env, state, actions):
    """Run one env.step with every kernel entry wrapped where the sim calls
    it; returns {entry name: [args of each call, in order]} (tensors
    cloned), so the kernels can be checked and timed on the main path's
    own launches at its own shapes."""
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
    missing = [n for n, c in calls.items() if not c]
    if missing:
        raise AssertionError(f"the step made no call to {missing}")
    return calls


def kernel_phase(env, state, actions):
    """Each kernel vs its plain version on the card, on the inputs of every
    launch one real step makes (captured from the main path at 1024
    worlds). ms, plain_ms and bound_ms are per step: the sum over that
    step's launches of the entry (1 for K1, K2, K3 and K4 culled; 3 for K4
    dense: the L2 pair [W, A, 2], the L3 snap [W, A] and the fall cast
    [W, A])."""
    import torch
    from madrona_mp_env_tpu_torch.ops import raycast, raycast_cull, tail_fused

    m = env.map_data
    soup = m.tris
    T_real = int(soup.valid.sum())
    calls = capture_step_calls(env, state, actions)
    results = []

    def chunks(n, size):
        return [slice(i, min(i + size, n)) for i in range(0, n, size)]

    def chunked(fn, n, size):
        """fn(slice) over chunks of the leading axis, outputs concatenated."""
        outs = [fn(s) for s in chunks(n, size)]
        if isinstance(outs[0], tuple):
            return tuple(torch.cat(o) for o in zip(*outs))
        return torch.cat(outs)

    def sc_gap(o, d, r):
        """best-two gap of the dense per-triangle sweep of casts o, d."""
        o2, d2 = o.reshape(-1, 3), d.reshape(-1, 3)
        gap = chunked(lambda s: best_two_gap(raycast._sc_pairs(
            o2[s][:, None], d2[s][:, None], r, soup.v0, soup.e1, soup.e2,
            soup.normal, soup.valid)["t_tri"]), o2.shape[0], 4096)
        return gap.reshape(o.shape[:-1])

    def record(name, source, replaces, entry, err, ms, pms, nbytes, nops,
               shapes):
        bms, by = bound_ms(nbytes, nops)
        results.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            entry=entry, max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=bms,
            bound_by=by, shapes=shapes,
        ))

    # --- K1: the fire system's hitscan rays ---
    (o1, d1, _), = calls["ray_vs_tris"]
    R1 = o1[..., 0].numel()
    err = check_t("K1 ray_vs_tris", raycast.ray_vs_tris(o1, d1, soup),
                  raycast._ray_vs_tris_dense(o1, d1, soup))
    record("K1 ray_vs_tris", "madrona_mp_env_tpu_torch/csrc/ray_tris.cu",
           "madrona_mp_env_tpu/ops/raycast_pallas.py:111", raycast.ray_vs_tris,
           err, cuda_time_ms(lambda: raycast.ray_vs_tris(o1, d1, soup), 200),
           cuda_time_ms(lambda: raycast._ray_vs_tris_dense(o1, d1, soup), 20),
           R1 * 28 + T_real * 40, R1 * T_real * OPS_RAY_TRI,
           [list(o1.shape[:-1])])

    # --- K2: the sensor fans ---
    (org, zgf, dirf, zgroups, _), = calls["ray_fans_vs_tris"]
    N, G = zgf.shape
    F = dirf[0].shape[-1]

    def fan_kernel():
        return raycast.ray_fans_vs_tris(org, zgf, dirf, zgroups, soup)

    def fan_plain():
        return chunked(lambda s: raycast._ray_fans_dense(
            org[s], zgf[s], tuple(c[s] for c in dirf), zgroups, soup), N, 1024)

    err = check_t("K2 ray_fans_vs_tris", fan_kernel(), fan_plain())
    record("K2 ray_fans_vs_tris", "madrona_mp_env_tpu_torch/csrc/fan_tris.cu",
           "madrona_mp_env_tpu/ops/raycast_pallas.py:383",
           raycast.ray_fans_vs_tris, err, cuda_time_ms(fan_kernel, 20),
           cuda_time_ms(fan_plain, 2),
           N * (12 + 4 * G) + 3 * N * F * 4 + T_real * 40 + N * F * 4,
           N * F * T_real * OPS_FAN_PAIR + N * G * T_real * OPS_FAN_HOIST,
           [[N, F]])

    # --- K3: the sensor rays vs the agents' capsules ---
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
        o = pos[s][:, :, None, :] + torch.stack([zero, zero, zoff[s]], dim=-1)
        tc = raycast_cull.ray_vs_capsules(
            o, torch.stack([c[s] for c in dirs], dim=-1),
            pos[s][:, None, None], alive[s][:, None, None])
        return best_two_gap(torch.where(self_mask, float("inf"), tc))

    check_idx("K3 fan_capsules", ik, ip, chunked(cap_gap, W, 128), tp)
    live = alive.sum(-1, keepdim=True) - alive.to(torch.int64)  # [W, A]
    record("K3 fan_capsules", "madrona_mp_env_tpu_torch/csrc/fan_capsules.cu",
           "madrona_mp_env_tpu/ops/raycast_cull.py:120",
           raycast_cull.fan_capsules, err, cuda_time_ms(cap_kernel, 50),
           cuda_time_ms(cap_plain, 2),
           W * A * 13 + W * A * F * 16 + W * A * F * 8,
           int((live * F).sum()) * OPS_CAPSULE, [[W, A, F]])

    # --- K4 dense: the L2 pair, the L3 snap and the fall cast ---
    sc_calls = calls["sphere_cast"]
    if len(sc_calls) != 3:
        raise AssertionError(f"step made {len(sc_calls)} dense casts, not 3")
    err, ms, pms, R4, shapes = 0.0, 0.0, 0.0, 0, []
    for i, (o4, d4, r, _) in enumerate(sc_calls):
        n = o4.shape[0]

        def sc_plain(o4=o4, d4=d4, r=r, n=n):
            return chunked(lambda s: raycast._sphere_cast_dense(
                o4[s], d4[s], r, soup), n, 256)

        def sc_kernel(o4=o4, d4=d4, r=r):
            return raycast.sphere_cast(o4, d4, r, soup)

        (tk, ik), (tp, ip) = sc_kernel(), sc_plain()
        name = f"K4 sphere_cast launch {i} {list(o4.shape[:-1])}"
        err = max(err, check_t(name, tk, tp))
        check_idx(name, ik, ip, sc_gap(o4, d4, r), tp)
        ms += cuda_time_ms(sc_kernel, 50)
        pms += cuda_time_ms(sc_plain, 2)
        R4 += o4[..., 0].numel()
        shapes.append(list(o4.shape[:-1]))
    record("K4 sphere_cast (dense)",
           "madrona_mp_env_tpu_torch/csrc/sphere_cast.cu",
           "madrona_mp_env_tpu/ops/raycast_pallas.py:1384",
           raycast.sphere_cast, err, ms, pms, R4 * 32 + 3 * T_real * 52,
           R4 * T_real * OPS_SPHERE_TRI, shapes)

    # --- K4 culled: the L1 batch of 7 casts per agent ---
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
    # (movement.UNSTICK_RANGE): equal t and row there, beyond it both far.
    # A standing agent's casts have no direction: they touch every
    # triangle at t = 0, each entry reports its lowest row, and the step
    # does not read them (no_move), so they are left out here.
    from madrona_mp_env_tpu_torch.sim import movement

    td, idd = chunked(lambda s: raycast._sphere_cast_dense(
        o7[s], d7[s], r, soup), N7, 2048)
    swept = (d7 != 0.0).any(dim=-1)
    near = (td <= movement.UNSTICK_RANGE) & swept
    far = ~near & swept
    if not (torch.equal(td[near], tp[near]) and torch.equal(idd[near],
                                                            ip[near])
            and bool((tp[far] > movement.UNSTICK_RANGE).all())):
        raise AssertionError("culled plain cast differs from the dense cast")
    check_idx("K4 sphere_cast_culled", ik, ip, sc_gap(o7, d7, r), tp)
    cand = short.cand.reshape(-1, short.K)[cells.long()]
    record("K4 sphere_cast_culled",
           "madrona_mp_env_tpu_torch/csrc/sphere_cast.cu",
           "madrona_mp_env_tpu/ops/raycast_pallas.py:1549",
           raycast.sphere_cast_culled, err, cuda_time_ms(culled_kernel, 50),
           cuda_time_ms(culled_plain, 2),
           N7 * CPA * 32 + N7 * 4 + short.cand.numel() * 4 + T_real * 52,
           int((cand >= 0).sum()) * CPA * OPS_SPHERE_TRI, [[N7, CPA]])

    # --- K5: the fused scalar tail ---
    (cfg5, m5, st5, fr5), = calls["tail_fused"]

    def tail_kernel():
        return tail_fused.tail_fused(cfg5, m5, st5, fr5)

    def tail_plain():
        return tail_fused.tail_fused_plain(cfg5, m5, st5, fr5)

    err = check_tail(tail_kernel(), tail_plain())
    ins, outs = tail_fused.kernel_operands(cfg5, m5, st5, fr5)
    W5, A5 = st5.hp.shape
    ts5 = cfg5.team_size
    record("K5 tail_fused", "madrona_mp_env_tpu_torch/csrc/tail_fused.cu",
           "madrona_mp_env_tpu/ops/tail_pallas.py:143", tail_fused.tail_fused,
           err, cuda_time_ms(tail_kernel, 200), cuda_time_ms(tail_plain, 20),
           sum(x.nbytes for x in (*ins.values(), *outs.values())),
           W5 * A5 * (OPS_TAIL_AGENT + 2 * (ts5 - 1) + 5 * (ts5 - 2)),
           [[W5, A5]])
    for k in results:
        log(f"[kernel] {k['name']} at {k['shapes']}: max_abs_err "
            f"{k['max_abs_err']:.3g} kernel {k['ms']:.4f} ms/step plain "
            f"{k['plain_ms']:.4f} ms/step bound {k['bound_ms']:.4f} ms "
            f"({k['bound_by']})")
    return results


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


def rollout(mt, cfg, W, steps, device, seed=5):
    env = mt.Env(cfg, SCENE, num_worlds=W, seed=seed, device=device)
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

    # 3. kernels vs plain versions on one real step's launches
    env = mt.Env(cfg, SCENE, num_worlds=NUM_WORLDS, seed=5, device="cuda")
    acts = bench_actions(NUM_WORLDS, cfg.num_agents, NUM_STEPS)
    state, _ = env.reset()
    kernels = kernel_phase(env, state, actions_at(env, acts, 0))
    del state

    # 4. the slice on the card
    for k in kernels:
        k["entry"].launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, obs = env.reset()
    t_reset = time.perf_counter()
    for s in range(NUM_STEPS):
        state, out = env.step(state, actions_at(env, acts, s))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for k in kernels:
        k["launches"] = k["entry"].launches
    for name, x in out["obs"].items():
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"non-finite obs {name}")
    missing = [k["name"] for k in kernels if k["launches"] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: "
                             f"{missing}")
    sps = NUM_WORLDS * NUM_STEPS / (t1 - t_reset)
    log(f"[slice] {NUM_WORLDS} worlds x {NUM_STEPS} steps: reset "
        f"{t_reset - t0:.3f} s, steps {t1 - t_reset:.3f} s, {sps:.1f} "
        f"env-steps/s on {card}; launches "
        + ", ".join(f"{k['name']}={k['launches']}" for k in kernels))
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
    del state, out, obs

    # 5. the crossplay eval on the card
    eval_phase(mt, kernels, card)

    # 6. kernel path vs plain path
    W5, S5 = 4, 16
    gpu = rollout(mt, cfg, W5, S5, "cuda")
    cpu = rollout(mt, cfg, W5, S5, "cpu")
    worst = {}
    for s, (a, b) in enumerate(zip(gpu, cpu)):
        for k in ("hp", "alive", "team_points", "done"):
            if not np.array_equal(a[k], b[k]):
                raise AssertionError(f"step {s}: {k} differs cuda vs cpu")
        for k, rel in (("pos", 1e-4), ("reward", 1e-4), ("fwd_lidar", 1e-3),
                       ("self", 1e-3)):
            e = np.abs(a[k] - b[k]) / np.maximum(1.0, np.abs(b[k]))
            worst[k] = max(worst.get(k, 0.0), float(e.max()))
            if e.max() > rel:
                raise AssertionError(f"step {s}: {k} rel err {e.max()}")
    log(f"[parity] cuda vs cpu, {W5} worlds x {S5} steps: discrete exact, "
        + ", ".join(f"{k} max rel err {v:.3g}" for k, v in worst.items()))
    eval_parity(mt, W5, S5)

    # 7. results
    line = {"kernels": [
        {k2: k[k2] for k2 in ("name", "route", "source", "replaces",
                              "launches", "max_abs_err", "ms", "plain_ms",
                              "bound_ms", "bound_by")}
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
