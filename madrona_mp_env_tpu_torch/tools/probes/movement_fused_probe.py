"""P3: the movement contact pipeline in one launch.

    python -m madrona_mp_env_tpu_torch.tools.probes.movement_fused_probe \
        [--worlds 1024] [--scene simple_map|town_map|<map dir>] \
        [--steps 5] [--iters 20] [--device cuda|cpu]

The port of the JAX package's tools/probes/movement_fused_probe.py:
``apply_velocity_fall_fused`` runs ``apply_velocity_system`` then
``fall_system`` (sim/movement.py) for every agent in one launch of
csrc/move_fused.cu, the velocity committed from the pre-fall position.
Its plain version is the port's own split chain with the plain sweeps
under the same cast route: ``route="culled"`` is the step's (L1 against
the short tables, L2, L3 and fall against the MOVE_MARGIN tables), so
the culled kernel equals the step's movement pair bit for bit on the
card; ``route="dense"`` sweeps every cast over the whole soup
(MPENV_SC_CULL=0 MPENV_SC_PACK=0), the JAX probe's dense entry. The step
does not call it, as the JAX step does not.

``main`` builds a state from ``Env.reset`` and ``--steps`` steps of
bench.py's run-and-shoot actions, then for each route times the split
pair (the step's kernels), the fused launch and the plain version (CUDA
events), counts the CUDA launches of one split pair against one fused
call (torch.profiler) and checks the fused result against both. On the
CPU (``--device cpu``) it runs and times the plain version only.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import os

import numpy as np
import torch

import madrona_mp_env_tpu_torch as mt
from madrona_mp_env_tpu_torch import consts
from madrona_mp_env_tpu_torch.ops import cuda_build
from madrona_mp_env_tpu_torch.sim import movement
from madrona_mp_env_tpu_torch.sim.env import resolve_device
from madrona_mp_env_tpu_torch.sim.types import Pose
from madrona_mp_env_tpu_torch.tools.kernel_bench import device_line, time_ms

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def split_pair(cfg, m, state, route="culled", plain=False):
    """apply_velocity_system -> fall_system under ``route`` (a key of
    movement.ROUTES); the entries launch the kernels on the card unless
    ``plain``."""
    rt = dataclasses.replace(movement.ROUTES[route], plain=plain)
    state = movement.apply_velocity_system(cfg, m, state, rt)
    return movement.fall_system(cfg, m, state, rt)


# (cast, triangle) pairs of the L1 batch per pass of the plain version on
# the card: a dense town_map pass at 1024 worlds would hold 5e8 pairs
_PLAIN_PAIRS = 2 ** 25


def _apply_velocity_fall_fused_plain(cfg, m, state, route="culled"):
    """The fused movement's plain version: the split chain with the plain
    sweeps, on any device; on the card in passes of whole worlds (each
    agent's result depends on its own leaves alone, so the bits do not
    change)."""
    W, A = state.pos.shape[:2]
    rt = movement.ROUTES[route]
    per = max(1, _PLAIN_PAIRS // (
        A * 7 * (m.short.K if rt.culled else m.tris.num_tris)))
    if state.pos.device.type == "cpu" or per >= W:
        return split_pair(cfg, m, state, route, plain=True)
    outs = [split_pair(cfg, m, state.replace(**{
        k: v[i:i + per] for k, v in state.leaves().items()}), route,
        plain=True) for i in range(0, W, per)]
    return state.replace(pos=torch.cat([o.pos for o in outs]),
                         vel=torch.cat([o.vel for o in outs]))


_TRIG = {}


def _unstick_trig(device) -> torch.Tensor:
    """[8] sin, cos of k pi / 2 for k = 0..3, as geom.rotate_z computes
    them for the unstick directions (movement.l1_casts), made once per
    device with the same tensor operations."""
    key = str(device)
    if key not in _TRIG:
        vals = []
        for k in range(4):
            angle = torch.tensor(k * consts.pi * 0.5, device=device)
            vals += [torch.sin(angle), torch.cos(angle)]
        _TRIG[key] = torch.stack(vals).contiguous()
    return _TRIG[key]


class _MoveArgs(ctypes.Structure):
    """csrc/move_fused.cu MoveArgs, field for field."""

    _fields_ = (
        [(n, ctypes.c_void_p) for n in (
            "pos", "vel", "cur", "alive", "rows", "trig", "cand1", "cand2",
            "pos_out", "vel_out", "work")]
        + [(n, ctypes.c_int) for n in (
            "N", "T", "K1", "nx1", "ny1", "K2", "nx2", "ny2", "pose_crouch",
            "pose_prone")]
        + [(n, ctypes.c_float) for n in (
            "x0_1", "y0_1", "cs1", "x0_2", "y0_2", "cs2", "r", "hb", "two_r",
            "buf", "neg_buf", "top_crouch", "top_prone", "top_stand",
            "low_prone", "low_other", "dt", "inv_dt", "unstick_range",
            "unstick_big", "slope_max", "tiny", "fall_cast_up", "fall_max")]
    )


def _grid(st):
    """(x0, y0, cell size) as float32, as short_cell_index rounds them."""
    return (float(np.float32(st.grid_min[0])),
            float(np.float32(st.grid_min[1])),
            float(np.float32(st.cell_size)))


def apply_velocity_fall_fused(cfg, m, state, route="culled", work=None):
    """apply_velocity_system + fall_system of every agent ([W, A] leaves)
    in one launch of csrc/move_fused.cu (one warp per agent) under
    ``route`` ("culled" or "dense"), the velocity committed from the
    pre-fall position. Returns the state with pos and vel replaced. CPU:
    the plain version. ``work``: None, or an int64 [2] CUDA tensor to which
    the kernel adds the (cast, valid triangle) pairs it swept and the
    normals it took."""
    dev = state.pos.device
    if dev.type == "cpu":
        return _apply_velocity_fall_fused_plain(cfg, m, state, route)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    rt = movement.ROUTES[route]
    W, A = state.pos.shape[:2]
    N = W * A
    # held in locals until the launch
    pos = state.pos.to(torch.float32).contiguous()
    vel = state.vel.to(torch.float32).contiguous()
    cur = state.stand_cur.to(torch.int32).contiguous()
    alive = state.alive.to(torch.float32).contiguous()
    trig = _unstick_trig(dev)
    pos_out = torch.empty_like(pos)
    vel_out = torch.empty_like(vel)
    r = consts.agent_radius
    buf = 0.05 * r
    s1, s2 = m.short if rt.culled else None, m.short_mv if rt.packed else None
    g1 = _grid(s1) if s1 else (0.0, 0.0, 1.0)
    g2 = _grid(s2) if s2 else (0.0, 0.0, 1.0)
    args = _MoveArgs(
        pos=pos.data_ptr(), vel=vel.data_ptr(), cur=cur.data_ptr(),
        alive=alive.data_ptr(), rows=m.tris.tri_rows.data_ptr(),
        trig=trig.data_ptr(), cand1=s1.cand.data_ptr() if s1 else None,
        cand2=s2.cand.data_ptr() if s2 else None,
        pos_out=pos_out.data_ptr(), vel_out=vel_out.data_ptr(),
        work=None if work is None else work.data_ptr(), N=N, T=m.tris.num_tris, K1=s1.K if s1 else 0,
        nx1=s1.nx if s1 else 1, ny1=s1.ny if s1 else 1,
        K2=s2.K if s2 else 0, nx2=s2.nx if s2 else 1,
        ny2=s2.ny if s2 else 1, pose_crouch=Pose.Crouch,
        pose_prone=Pose.Prone, x0_1=g1[0], y0_1=g1[1], cs1=g1[2],
        x0_2=g2[0], y0_2=g2[1], cs2=g2[2], r=r, hb=buf * 0.5,
        two_r=2.0 * r, buf=buf, neg_buf=-buf,
        top_crouch=consts.crouch_height - r, top_prone=consts.prone_height,
        top_stand=consts.stand_height - r,
        low_prone=consts.prone_height - r + buf,
        low_other=consts.prone_height, dt=consts.delta_t,
        # ATen's CUDA division by a Python scalar: times its float inverse
        inv_dt=float(np.float32(1.0) / np.float32(consts.delta_t)),
        unstick_range=movement.UNSTICK_RANGE, unstick_big=3.0e38,
        slope_max=0.7, tiny=1e-30, fall_cast_up=r + r,
        fall_max=consts.fall_rate * consts.delta_t,
    )
    stream = torch.cuda.current_stream(dev).cuda_stream
    cuda_build.check(cuda_build.launcher("move_fused")(
        ctypes.byref(args), ctypes.c_void_p(stream)), "move_fused")
    apply_velocity_fall_fused.launches += 1
    return state.replace(pos=pos_out, vel=vel_out)


apply_velocity_fall_fused.launches = 0


def bench_actions(W, A, steps, seed=0):
    """bench.py's run-and-shoot action mix [steps, W, A], drawn with
    numpy."""
    g = np.random.default_rng(seed)
    shape = (steps, W, A)
    return {
        "move_amount": g.integers(0, 3, shape), "move_angle":
        g.integers(0, 8, shape), "fire": g.integers(0, 2, shape),
        "stand": np.zeros(shape, np.int64), "aim_yaw":
        g.integers(0, 13, shape), "aim_pitch": g.integers(0, 7, shape),
    }


def bench_state(cfg, scene, worlds, steps, device, seed=5):
    """(env, the state after Env.reset and ``steps`` steps of bench.py's
    actions, with the movement and aim systems of one more step applied:
    the state the step hands apply_velocity_system)."""
    env = mt.Env(cfg, scene, num_worlds=worlds, seed=seed, device=device)
    acts = bench_actions(worlds, cfg.num_agents, steps + 1)

    def at(s):
        return env.zero_actions().replace(**{
            k: torch.as_tensor(v[s], dtype=torch.int32, device=env.device)
            for k, v in acts.items()})

    state, _ = env.reset()
    for s in range(steps):
        state, _ = env.step(state, at(s))
    state = movement.movement_system(cfg, state, at(steps))
    return env, movement.aim_systems(cfg, state, at(steps))


def cuda_launches(fn, reps=5) -> float:
    """CUDA kernel launches per call of ``fn``, over ``reps`` calls after
    one outside the window (torch.profiler; one profiled call alone has
    come back empty)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA) / reps


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--worlds", type=int, default=1024)
    ap.add_argument("--scene", default="simple_map")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain version)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    scene = args.scene if os.sep in args.scene else os.path.join(
        REPO, "data", args.scene)
    cfg = mt.EnvConfig(
        task=mt.Task.Zone, team_size=6,
        sim_flags=mt.SimFlags.StaggerStarts | mt.SimFlags.RandomFlipTeams,
    )
    env, state = bench_state(cfg, scene, args.worlds, args.steps, device)
    m = env.map_data
    print(device_line(device))
    print(f"scene={os.path.basename(os.path.normpath(scene))} "
          f"worlds={args.worlds} agents={state.pos.shape[0] * state.pos.shape[1]}"
          f" padded_tris={m.tris.num_tris}", flush=True)
    res = {}
    for route in ("culled", "dense"):
        row = {}
        plain = _apply_velocity_fall_fused_plain(cfg, m, state, route)
        if device.type == "cuda":
            fused = apply_velocity_fall_fused(cfg, m, state, route)
            split = split_pair(cfg, m, state, route)
            torch.cuda.synchronize()
            for name, want in (("plain", plain), ("split", split)):
                row[f"vs_{name}_pos"] = float((fused.pos - want.pos).abs()
                                              .max())
                row[f"vs_{name}_vel"] = float((fused.vel - want.vel).abs()
                                              .max())
            row["fused_ms"] = time_ms(lambda: apply_velocity_fall_fused(
                cfg, m, state, route), args.iters, device)
            row["split_ms"] = time_ms(lambda: split_pair(
                cfg, m, state, route), args.iters, device)
            row["fused_launches"] = cuda_launches(
                lambda: apply_velocity_fall_fused(cfg, m, state, route))
            row["split_launches"] = cuda_launches(
                lambda: split_pair(cfg, m, state, route))
        row["plain_ms"] = time_ms(lambda: _apply_velocity_fall_fused_plain(
            cfg, m, state, route), max(1, args.iters // 10), device)
        res[route] = row
        print(f"{route}: " + json.dumps(row), flush=True)
    return res


if __name__ == "__main__":
    main()
