#!/usr/bin/env python3
"""Drive the PyTorch port (madrona_mp_env_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run loudly:

1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
2. build every CUDA kernel of the env step from csrc/ (one nvcc per
   source, all at once);
3. each kernel (K1 hitscan rays, K2 sensor fans, K3 sensor rays vs
   capsules, K4 sphere casts: dense and short-table culled) against its
   plain PyTorch version on the card, on the inputs of every launch that
   one real step of the slice makes (1024 worlds of Zone 6v6 on
   simple_map, captured where the sim calls each entry), with its time,
   the plain version's time and its bound, each summed over the step's
   launches of that entry;
4. the slice: Env(device="cuda") at 1024 worlds, reset + 100 steps of
   bench.py's run-and-shoot action mix, with every launch counter zeroed
   before and read after; env-steps/s beside the card's name and limit;
5. the kernel path against the plain path: the same 4-world, 16-step
   rollout on "cuda" and on "cpu" from one seed;
6. a line of kernel results (JSON), then the card line, then the last
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


def best_two_gap(t_pairs):
    """Second-best minus best t over the last axis (inf when < 2 hits)."""
    import torch

    two = torch.topk(t_pairs, 2, dim=-1, largest=False).values
    return two[..., 1] - two[..., 0]


# where the step calls each kernel's entry: (sim module, name)
ENTRY_SITES = (
    ("combat", "ray_vs_tris"), ("observations", "ray_fans_vs_tris"),
    ("observations", "fan_capsules"), ("movement", "sphere_cast"),
    ("movement", "sphere_cast_culled"),
)


def _clone(x):
    import torch

    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, tuple):
        return tuple(_clone(v) for v in x)
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
    from madrona_mp_env_tpu_torch.ops import raycast, raycast_cull

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

    # 5. kernel path vs plain path
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

    # 6. results
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
