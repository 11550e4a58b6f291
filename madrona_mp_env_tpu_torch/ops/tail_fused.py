"""The fused scalar tail of the Zone step (K5).

One pass over every world for the scalar bookkeeping half of the step:
autoHealSystem -> zoneSystem -> zoneMatchInfoSystem -> zoneRewardSystem
(with the team-area spread bonus, the team mean and the team-spirit blend)
-> doneSystem (reference src/sim.cpp:1875-1890, 1892-1976, 4470-4673,
3849-3996, 4292-4339, 4712-4717). Breadcrumbs, filters, goal regions and
explore run before it in the step: none of them reads zone or match state,
and the filters get the post-increment step explicitly (sim/step.py).

Two implementations side by side, as for the ray kernels:

  * ``tail_fused_plain``: plain PyTorch over [W, A] / [W] tensors, the
    chain written out in the order the kernel evaluates it. It matches the
    unfused systems (combat.autoheal_system, zones.zone_system,
    zones.zone_match_info_system, rewards.reward_system) bit for bit on
    the CPU (tests/test_torch_tail.py).
  * ``csrc/tail_fused.cu``: one thread per world reading the WorldState
    tensors where they lie (a struct of device pointers) and writing fresh
    output tensors, the same operations in the same order, built with
    --fmad=false, so kernel and plain version agree bit for bit.

``tail_fused`` dispatches on the device of the state: CPU tensors take the
plain version, CUDA tensors the kernel (a failed build or launch raises).
It counts its kernel launches in ``tail_fused.launches``.

Replaces the TPU kernel madrona_mp_env_tpu/ops/tail_pallas.py
(``_make_kernel``, called through ``_get_tail_call`` / ``tail_fused_system``).
Scope: Task.Zone + RewardMode.Default, no SubZones; the LearnShooting
curriculum override (SimFlags.EnableCurriculum) is not ported and raises.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from .. import config as cfgmod
from .. import consts
from ..assets.map_data import MapData, ZONE_FRAME_COLS
from ..config import EnvConfig, RewardMode, SimFlags, Task
from ..sim import rewards, zones
from ..sim.types import WorldState
from . import cuda_build

MAX_AGENTS = 32  # csrc/tail_fused.cu kMaxAgents


def use_tail_fused(cfg: EnvConfig) -> bool:
    """The step's gate: the fused tail covers Task.Zone with
    RewardMode.Default and no sub-zones (the JAX package's
    tail_pallas.use_tail_fused without its TPU switch)."""
    return (cfg.task == Task.Zone
            and cfg.reward_mode == RewardMode.Default
            and not cfg.has_flag(SimFlags.SubZones))


def _check_scope(cfg: EnvConfig) -> None:
    if not use_tail_fused(cfg):
        raise NotImplementedError(
            "the fused tail covers Task.Zone, RewardMode.Default, no SubZones")
    if cfg.has_flag(SimFlags.EnableCurriculum):
        raise NotImplementedError(
            "the LearnShooting reward override (EnableCurriculum) is not "
            "ported")


def tail_fused_plain(cfg: EnvConfig, m: MapData, state: WorldState,
                     force_reset: torch.Tensor
                     ) -> Tuple[WorldState, torch.Tensor]:
    """The chain in plain PyTorch: state [W, ...], force_reset [W] (int or
    bool). Returns (state, new_captured [W] bool)."""
    _check_scope(cfg)
    W, A = state.hp.shape
    ts = cfg.team_size
    dev = state.hp.device
    team = (torch.arange(A, device=dev) // ts).to(torch.int32)
    team1 = team == 1
    interval = consts.zone_point_interval

    # ---- autoHealSystem ----
    alive = state.alive > 0.0
    heal = alive & (state.autoheal_steps == 0) & (state.hp < 100.0)
    hp = torch.where(
        heal,
        torch.clamp(state.hp + consts.autoheal_amount_per_step, max=100.0),
        state.hp)
    autoheal = torch.where(alive & (state.autoheal_steps > 0),
                           state.autoheal_steps - 1, state.autoheal_steps)

    # ---- zoneSystem ----
    ctrl = state.zone_controlling
    zrem = state.zone_steps_remaining - (ctrl != -1).to(torch.int32)
    rotate = zrem == 0
    zcur = torch.where(
        rotate,
        torch.where(state.zone_cur + 1 == m.num_zones, 0, state.zone_cur + 1),
        state.zone_cur)
    captured = state.zone_captured & ~rotate
    zrem = torch.where(rotate, consts.num_steps_per_zone, zrem)
    zsup = torch.where(rotate, interval, state.zone_steps_until_point)
    dist = zones.zone_center_dist(m, zcur, state.pos)
    min_dist = torch.where(rotate[:, None], dist, state.min_dist_to_zone)
    in_zone = zones.zone_membership(m, zcur, state.pos)
    num_a = (in_zone & ~team1).sum(-1)
    num_b = (in_zone & team1).sum(-1)
    zsup = zsup - 1
    contested = (num_a > 0) & (num_b > 0)
    nobody = (num_a == 0) & (num_b == 0)
    a_takes = (num_a > 0) & (num_b == 0) & (ctrl != 0)
    b_takes = (num_b > 0) & (num_a == 0) & (ctrl != 1)
    ctrl = torch.where(contested | nobody, -1,
                       torch.where(a_takes, 0, torch.where(b_takes, 1, ctrl)))
    changed = contested | nobody | a_takes | b_takes
    captured = captured & ~changed
    zsup = torch.where(changed, interval, zsup)

    # ---- zoneMatchInfoSystem ----
    cur_step = state.cur_step + 1
    finished = (cur_step >= cfg.episode_len) | (force_reset != 0)
    first = cur_step == 1
    tk = torch.where(first[:, None], 0, state.team_kills)
    tp = torch.where(first[:, None], 0, state.team_points)
    win = torch.where(first, -1, state.win_result)
    wk = state.was_killed
    tk = tk + torch.stack([(wk & team1).sum(-1), (wk & ~team1).sum(-1)], -1)
    earned = zsup == 0
    zsup = torch.where(earned, interval, zsup)
    new_captured = earned & ~captured
    captured = captured | earned
    ctrl_cl = torch.clamp(ctrl, 0, 1)
    side = torch.arange(2, device=dev)
    tp = tp + (earned[:, None] & (ctrl_cl[:, None] == side)).to(torch.int32)
    finished = finished | (tp >= consts.zone_win_points).any(-1)
    result = torch.where(tp[:, 0] > tp[:, 1], 0,
                         torch.where(tp[:, 1] > tp[:, 0], 1, 2))
    win = torch.where(finished, result, win)
    # zone stats columns [swaps, capturedA, capturedB, contested, active]
    inc = torch.stack([new_captured, captured & (ctrl_cl == 0),
                       captured & (ctrl_cl == 1), contested,
                       torch.ones_like(contested)], -1).to(torch.int32)
    mz = zcur[:, None] == torch.arange(consts.max_zones, device=dev)
    zone_stats = state.zone_stats + torch.where(mz[..., None],
                                                inc[:, None, :], 0)

    # ---- zoneRewardSystem ----
    rc = state.reward_coefs
    dead = state.alive == 0.0
    r = -rc[..., cfgmod.RC_BREADCRUMB_SCALE] * state.crumb_total_penalty
    r = r - torch.where(state.reloaded_full_mag, 0.5, 0.0)
    r = r + torch.where(state.successful_kill, 1.0, 0.0)
    r = r + torch.where(state.landed_shot_on >= 0,
                        rc[..., cfgmod.RC_SHOT_SCALE], 0.0)
    r = r - torch.where(wk, 1.5, 0.0)
    r = r - torch.where(state.was_shot_count > 0,
                        rc[..., cfgmod.RC_SHOT_SCALE], 0.0)
    r = r + state.new_cells.to(torch.float32) * rc[
        ..., cfgmod.RC_EXPLORE_SCALE]
    closer = ~in_zone & (dist < min_dist)
    scale = rc[..., cfgmod.RC_ZONE_DIST_SCALE] * torch.where(
        state.has_died, 1.0, 10.0)
    approach = torch.where(closer, scale * (min_dist - dist), 0.0)
    min_dist = torch.where(closer, dist, min_dist)
    r = r + torch.where(in_zone, rc[..., cfgmod.RC_IN_ZONE_SCALE], 0.0)
    r = r + approach
    mine = ctrl[:, None] == team
    other = (ctrl != -1)[:, None] & ~mine
    earned_a = earned[:, None]
    ctrl_s = rc[..., cfgmod.RC_ZONE_TEAM_CTRL_SCALE]
    point_s = rc[..., cfgmod.RC_ZONE_EARNED_POINT_SCALE]
    rz = torch.where(mine, ctrl_s, 0.0)
    rz = rz + torch.where(mine & earned_a, point_s, 0.0)
    rz = rz - torch.where(other, ctrl_s, 0.0)
    rz = rz - torch.where(other & earned_a, point_s, 0.0)
    r = r + rz
    r = r + torch.where(dead, 0.0,
                        rewards._team_spread_bonus(cfg, m, state, team))

    # team mean (members in index order) + team-spirit blend; the divisor
    # is a tensor so that CPU and CUDA both divide (ATen's CUDA division by
    # a Python scalar multiplies by its reciprocal)
    team_sum = rewards._seq_sum(r.reshape(W, 2, ts))
    team_mean = team_sum / torch.full((), float(ts), device=dev)
    spirit = rc[..., cfgmod.RC_TEAM_SPIRIT]
    blended = r * (1.0 - spirit) + team_mean[:, team.long()] * spirit

    i32 = torch.int32
    state = state.replace(
        hp=hp, autoheal_steps=autoheal, in_zone=in_zone,
        min_dist_to_zone=min_dist, reward=blended,
        successful_kill=state.successful_kill & ~dead,
        landed_shot_on=torch.where(dead, -1, state.landed_shot_on),
        was_killed=wk & ~dead,
        was_shot_count=torch.where(dead, 0, state.was_shot_count),
        fired_shot_t=torch.where(dead, -float("inf"), state.fired_shot_t),
        done=finished.to(i32)[:, None].expand(W, A).contiguous(),
        new_cells=torch.zeros_like(state.new_cells),
        cur_step=cur_step, is_finished=finished, win_result=win.to(i32),
        team_kills=tk.to(i32), team_points=tp.to(i32),
        zone_cur=zcur, zone_controlling=ctrl.to(i32),
        zone_contested=contested, zone_captured=captured,
        zone_earned_point=earned, zone_steps_remaining=zrem,
        zone_steps_until_point=zsup, team_rewards=team_mean,
        zone_stats=zone_stats,
    )
    return state, new_captured


# ---------------------------------------------------------------------------
# The kernel: argument struct (csrc/tail_fused.cu TailArgs, same order)
# ---------------------------------------------------------------------------

# (name, WorldState leaf, dtype, per "agent" [W, A, ...] or "world" [W, ...],
#  trailing shape)
_F, _I, _B = torch.float32, torch.int32, torch.bool
_INPUTS = (
    ("pos", _F, "agent", (3,)), ("hp", _F, "agent", ()),
    ("alive", _F, "agent", ()), ("autoheal_steps", _I, "agent", ()),
    ("min_dist_to_zone", _F, "agent", ()),
    ("crumb_total_penalty", _F, "agent", ()),
    ("fired_shot_t", _F, "agent", ()), ("successful_kill", _B, "agent", ()),
    ("landed_shot_on", _I, "agent", ()), ("was_shot_count", _I, "agent", ()),
    ("was_killed", _B, "agent", ()), ("reloaded_full_mag", _B, "agent", ()),
    ("has_died", _B, "agent", ()), ("new_cells", _I, "agent", ()),
    ("reward_coefs", _F, "agent", (cfgmod.NUM_REWARD_COEFS,)),
    ("cur_step", _I, "world", ()), ("win_result", _I, "world", ()),
    ("team_kills", _I, "world", (2,)), ("team_points", _I, "world", (2,)),
    ("zone_cur", _I, "world", ()), ("zone_controlling", _I, "world", ()),
    ("zone_captured", _B, "world", ()),
    ("zone_steps_remaining", _I, "world", ()),
    ("zone_steps_until_point", _I, "world", ()),
    ("zone_stats", _I, "world", (consts.max_zones, 5)),
)
_OUTPUTS = (
    ("hp", _F, "agent", ()), ("autoheal_steps", _I, "agent", ()),
    ("in_zone", _B, "agent", ()), ("min_dist_to_zone", _F, "agent", ()),
    ("reward", _F, "agent", ()), ("successful_kill", _B, "agent", ()),
    ("landed_shot_on", _I, "agent", ()), ("was_killed", _B, "agent", ()),
    ("was_shot_count", _I, "agent", ()), ("fired_shot_t", _F, "agent", ()),
    ("done", _I, "agent", ()), ("new_cells", _I, "agent", ()),
    ("cur_step", _I, "world", ()), ("is_finished", _B, "world", ()),
    ("win_result", _I, "world", ()), ("team_kills", _I, "world", (2,)),
    ("team_points", _I, "world", (2,)), ("zone_cur", _I, "world", ()),
    ("zone_controlling", _I, "world", ()), ("zone_contested", _B, "world", ()),
    ("zone_captured", _B, "world", ()),
    ("zone_earned_point", _B, "world", ()),
    ("zone_steps_remaining", _I, "world", ()),
    ("zone_steps_until_point", _I, "world", ()),
    ("team_rewards", _F, "world", (2,)),
    ("zone_stats", _I, "world", (consts.max_zones, 5)),
)
# scalar fields after the pointers: ints, then floats
_INT_FIELDS = ("W", "A", "team_size", "num_zones", "max_zones",
               "episode_len", "steps_per_zone", "point_interval",
               "win_points")
_FLOAT_FIELDS = ("autoheal_amount", "lift")


class _TailArgs(ctypes.Structure):
    _fields_ = (
        [(f"in_{n}", ctypes.c_void_p) for n, *_ in _INPUTS]
        + [("force_reset", ctypes.c_void_p), ("zone_frames", ctypes.c_void_p),
           ("world_min", ctypes.c_void_p), ("world_max", ctypes.c_void_p)]
        + [(f"out_{n}", ctypes.c_void_p) for n, *_ in _OUTPUTS]
        + [("new_captured", ctypes.c_void_p)]
        + [(n, ctypes.c_int) for n in _INT_FIELDS]
        + [(n, ctypes.c_float) for n in _FLOAT_FIELDS]
    )


def kernel_operands(cfg: EnvConfig, m: MapData, state: WorldState,
                    force_reset: torch.Tensor
                    ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Validate the kernel's inputs and allocate its outputs, on any
    device: (inputs by struct field, outputs by WorldState leaf plus
    ``new_captured``). Raises on a dtype or shape the kernel does not
    take; inputs are made contiguous (a no-op for the step's tensors)."""
    _check_scope(cfg)
    W, A = state.hp.shape
    if A != cfg.num_agents or A > MAX_AGENTS:
        raise ValueError(f"{A} agents per world: the kernel takes "
                         f"cfg.num_agents <= {MAX_AGENTS}")
    dev = state.hp.device

    def lead(kind):
        return (W, A) if kind == "agent" else (W,)

    ins = {}
    for name, dtype, kind, tail in _INPUTS:
        x = getattr(state, name)
        if x.dtype != dtype or tuple(x.shape) != lead(kind) + tail:
            raise ValueError(f"tail input {name}: {x.dtype} {tuple(x.shape)},"
                             f" want {dtype} {lead(kind) + tail}")
        ins[f"in_{name}"] = x.contiguous()
    fr = force_reset.to(torch.int32).contiguous()
    if tuple(fr.shape) != (W,):
        raise ValueError(f"force_reset shape {tuple(fr.shape)}, want ({W},)")
    if tuple(m.zone_frames.shape) != (consts.max_zones, ZONE_FRAME_COLS):
        raise ValueError("zone_frames has the wrong shape")
    ins.update(force_reset=fr, zone_frames=m.zone_frames,
               world_min=m.world_min, world_max=m.world_max)
    for name in ("zone_frames", "world_min", "world_max"):
        if ins[name].dtype != _F or not ins[name].is_contiguous():
            raise ValueError(f"map {name} must be contiguous float32")
    outs = {name: torch.empty(lead(kind) + tail, dtype=dtype, device=dev)
            for name, dtype, kind, tail in _OUTPUTS}
    outs["new_captured"] = torch.empty((W,), dtype=_B, device=dev)
    return ins, outs


def _launch(cfg: EnvConfig, m: MapData, ins, outs) -> None:
    W, A = ins["in_hp"].shape
    args = _TailArgs(
        **{k: v.data_ptr() for k, v in ins.items()},
        **{("new_captured" if k == "new_captured" else f"out_{k}"):
           v.data_ptr() for k, v in outs.items()},
        W=W, A=A, team_size=cfg.team_size, num_zones=m.num_zones,
        max_zones=consts.max_zones, episode_len=cfg.episode_len,
        steps_per_zone=consts.num_steps_per_zone,
        point_interval=consts.zone_point_interval,
        win_points=consts.zone_win_points,
        autoheal_amount=consts.autoheal_amount_per_step,
        lift=consts.stand_height / 2.0,
    )
    stream = torch.cuda.current_stream(ins["in_hp"].device).cuda_stream
    cuda_build.check(cuda_build.launcher("tail_fused")(
        ctypes.byref(args), ctypes.c_void_p(stream)), "tail_fused")


def tail_fused(cfg: EnvConfig, m: MapData, state: WorldState,
               force_reset: torch.Tensor) -> Tuple[WorldState, torch.Tensor]:
    """The fused tail of one step over all worlds. CPU: the plain version;
    CUDA: one launch of csrc/tail_fused.cu (one thread per world)."""
    dev = state.hp.device
    if dev.type == "cpu":
        return tail_fused_plain(cfg, m, state, force_reset)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    ins, outs = kernel_operands(cfg, m, state, force_reset)
    _launch(cfg, m, ins, outs)
    tail_fused.launches += 1
    new_captured = outs.pop("new_captured")
    return state.replace(**outs), new_captured


tail_fused.launches = 0
