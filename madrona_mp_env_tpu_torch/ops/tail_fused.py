"""The fused scalar tail of the Zone step (K5).

One pass over every world for the scalar bookkeeping half of the step:
autoHealSystem -> zoneSystem -> zoneMatchInfoSystem -> zoneRewardSystem
(with the team-area spread bonus; under SimFlags.EnableCurriculum a
LearnShooting world's learnShootingRewardSystem in its place, the team
mean and the team-spirit blend) -> doneSystem (reference
src/sim.cpp:1875-1890, 1892-1976, 4470-4673, 3849-3996, 3707-3733,
4292-4339, 4712-4717). Breadcrumbs, filters, goal regions and
explore run before it in the step: none of them reads zone or match state,
and the filters get the post-increment step explicitly (sim/step.py).

Two implementations side by side, as for the ray kernels:

  * ``tail_fused_plain``: plain PyTorch over [W, A] / [W] tensors, the
    chain written out in the order the kernel evaluates it. It matches the
    unfused systems (combat.autoheal_system, zones.zone_system,
    zones.zone_match_info_system, rewards.reward_system) bit for bit on
    the CPU (tests/test_torch_tail.py).
  * ``csrc/tail_fused.cu``: a group of lanes per world, one lane per
    agent, reading the WorldState tensors where they lie (a struct of
    device pointers) and writing fresh output tensors, the same operations
    in the same order, built with --fmad=false, so kernel and plain
    version agree bit for bit. Its predecessor (one thread per world)
    stays as ``tail_fused_v1``, launched by no path.

``tail_fused`` dispatches on the device of the state: CPU tensors take the
plain version, CUDA tensors the kernel (a failed build or launch raises).
It counts its kernel launches in ``tail_fused.launches``. The host side
checks the inputs' dtypes and shapes once per (cfg, map, dtypes, shapes)
(``_Plan``), allocates the 27 outputs in 8 tensors, passes the worlds'
``world_curriculum`` and the curriculum flag (the kernel's LearnShooting
instantiation runs only under the flag), reads
``force_reset`` in its own dtype and fills the argument struct's pointers
in one slice assignment.

Replaces the TPU kernel madrona_mp_env_tpu/ops/tail_pallas.py
(``_make_kernel``, called through ``_get_tail_call`` / ``tail_fused_system``).
Scope: Task.Zone + RewardMode.Default, no SubZones, with or without the
LearnShooting override (SimFlags.EnableCurriculum).
"""

from __future__ import annotations

import copy
import ctypes
import operator
from typing import Dict, Tuple

import torch

from .. import config as cfgmod
from .. import consts
from ..assets.map_data import MapData, ZONE_FRAME_COLS
from ..config import EnvConfig, RewardMode, SimFlags, Task
from ..sim import rewards, zones
from ..sim.types import WorldCurriculum, WorldState
from . import cuda_build

MAX_AGENTS = 32  # csrc/tail_fused.cu kMaxAgents


def use_tail_fused(cfg: EnvConfig, collect_log: bool = False) -> bool:
    """The step's gate: the fused tail covers Task.Zone with
    RewardMode.Default and no sub-zones, and not the logging step, which
    reads the step log between the zone system and match info (the JAX
    package's tail_pallas.use_tail_fused without its TPU switch)."""
    return (cfg.task == Task.Zone
            and cfg.reward_mode == RewardMode.Default
            and not cfg.has_flag(SimFlags.SubZones)
            and not collect_log)


def _check_scope(cfg: EnvConfig) -> None:
    if not use_tail_fused(cfg):
        raise NotImplementedError(
            "the fused tail covers Task.Zone, RewardMode.Default, no SubZones")


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
    min_dist_zone = min_dist
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
    if cfg.has_flag(SimFlags.EnableCurriculum):
        # a LearnShooting world: the shooting reward for the task's, the
        # zone system's distance kept
        ls = (state.world_curriculum == WorldCurriculum.LearnShooting)[:,
                                                                       None]
        r = torch.where(ls, rewards.learn_shooting_reward(state), r)
        min_dist = torch.where(ls, min_dist_zone, min_dist)

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
    ("world_curriculum", _I, "world", ()),
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
               "win_points", "force_reset_bytes", "curriculum")
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


_IN_NAMES = tuple(n for n, *_ in _INPUTS)
_OUT_NAMES = tuple(n for n, *_ in _OUTPUTS) + ("new_captured",)
_OUT_SPECS = _OUTPUTS + (("new_captured", _B, "world", ()),)
_state_inputs = operator.attrgetter(*_IN_NAMES)
_dtype, _shape = operator.attrgetter("dtype"), operator.attrgetter("shape")
# force_reset's dtypes and their element sizes (TailArgs.force_reset_bytes)
_FORCE_RESET_BYTES = {torch.bool: 1, torch.uint8: 1, torch.int8: 1,
                      torch.int16: 2, torch.int32: 4, torch.int64: 8}


class _Plan:
    """What the kernel needs of one (cfg, map, input dtypes and shapes),
    checked once: the argument struct with its scalar fields set and a view
    of its pointer fields, and the outputs grouped by shape and dtype. Raises ValueError on a dtype or
    shape the kernel does not take."""

    def __init__(self, cfg: EnvConfig, m: MapData, xs, fr: torch.Tensor):
        _check_scope(cfg)
        W, A = xs[_IN_NAMES.index("hp")].shape
        if A != cfg.num_agents or A > MAX_AGENTS:
            raise ValueError(f"{A} agents per world: the kernel takes "
                             f"cfg.num_agents <= {MAX_AGENTS}")

        def lead(kind):
            return (W, A) if kind == "agent" else (W,)

        for (name, dtype, kind, tail), x in zip(_INPUTS, xs):
            if x.dtype != dtype or tuple(x.shape) != lead(kind) + tail:
                raise ValueError(f"tail input {name}: {x.dtype} "
                                 f"{tuple(x.shape)}, want {dtype} "
                                 f"{lead(kind) + tail}")
        if fr.dtype not in _FORCE_RESET_BYTES or tuple(fr.shape) != (W,):
            raise ValueError(f"force_reset {fr.dtype} {tuple(fr.shape)}: "
                             f"want ({W},) bool or integer")
        if tuple(m.zone_frames.shape) != (consts.max_zones, ZONE_FRAME_COLS):
            raise ValueError("zone_frames has the wrong shape")
        for name in ("zone_frames", "world_min", "world_max"):
            x = getattr(m, name)
            if x.dtype != _F or not x.is_contiguous():
                raise ValueError(f"map {name} must be contiguous float32")
        self.cfg, self.m, self.device = cfg, m, xs[0].device
        # outputs of one shape and dtype share one allocation, [n, *shape],
        # unbound into n views: 8 allocations for the 27 outputs
        groups: Dict[tuple, list] = {}
        for slot, (_, dtype, kind, tail) in enumerate(_OUT_SPECS):
            groups.setdefault((lead(kind) + tail, dtype), []).append(slot)
        self.groups = tuple((shape, dtype, tuple(slots))
                            for (shape, dtype), slots in groups.items())
        self.args = _TailArgs(
            W=W, A=A, team_size=cfg.team_size, num_zones=m.num_zones,
            max_zones=consts.max_zones, episode_len=cfg.episode_len,
            steps_per_zone=consts.num_steps_per_zone,
            point_interval=consts.zone_point_interval,
            win_points=consts.zone_win_points,
            force_reset_bytes=_FORCE_RESET_BYTES[fr.dtype],
            curriculum=int(cfg.has_flag(SimFlags.EnableCurriculum)),
            autoheal_amount=consts.autoheal_amount_per_step,
            lift=consts.stand_height / 2.0,
        )
        self.ptrs = (ctypes.c_void_p * _N_POINTERS).from_buffer(self.args)
        self.args_ref = ctypes.byref(self.args)

    def outputs(self):
        """Fresh outputs in _OUT_SPECS order."""
        outs = [None] * len(_OUT_SPECS)
        for shape, dtype, slots in self.groups:
            if len(slots) == 1:
                outs[slots[0]] = torch.empty(shape, dtype=dtype,
                                             device=self.device)
                continue
            views = torch.empty((len(slots),) + shape, dtype=dtype,
                                device=self.device).unbind(0)
            for slot, v in zip(slots, views):
                outs[slot] = v
        return outs


_N_POINTERS = len(_INPUTS) + 4 + len(_OUT_SPECS)
_PLANS: Dict[tuple, _Plan] = {}


def _operands(cfg: EnvConfig, m: MapData, state: WorldState,
              force_reset: torch.Tensor):
    """(plan, inputs, outputs): the plan of these dtypes and shapes (made
    and checked on their first call), the kernel's inputs in struct order
    (made contiguous: a no-op for the step's tensors) and fresh outputs."""
    xs = _state_inputs(state)
    # the plan keeps cfg and m alive, so their ids stay theirs
    key = (id(cfg), id(m), tuple(map(_dtype, xs)), tuple(map(_shape, xs)),
           force_reset.dtype, force_reset.shape, xs[0].device)
    plan = _PLANS.get(key)
    if plan is None:
        if len(_PLANS) >= 64:
            _PLANS.clear()
        plan = _PLANS[key] = _Plan(cfg, m, xs, force_reset)
    if not all(map(torch.Tensor.is_contiguous, xs)):
        xs = tuple(x.contiguous() for x in xs)
    ins = xs + (force_reset.contiguous(), m.zone_frames, m.world_min,
                m.world_max)
    return plan, ins, plan.outputs()


def kernel_operands(cfg: EnvConfig, m: MapData, state: WorldState,
                    force_reset: torch.Tensor
                    ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """The kernel's inputs and fresh outputs, on any device, by struct
    field: (inputs, outputs by WorldState leaf plus ``new_captured``).
    Raises ValueError on a dtype or shape the kernel does not take."""
    _, ins, outs = _operands(cfg, m, state, force_reset)
    names = [f"in_{n}" for n in _IN_NAMES] + [
        "force_reset", "zone_frames", "world_min", "world_max"]
    return dict(zip(names, ins)), dict(zip(_OUT_NAMES, outs))


def _run(entry: str, cfg: EnvConfig, m: MapData, state: WorldState,
         force_reset: torch.Tensor) -> Tuple[WorldState, torch.Tensor]:
    """One launch of ``entry`` (tail_fused or tail_fused_v1) on CUDA
    tensors: (state with the outputs, new_captured)."""
    plan, ins, outs = _operands(cfg, m, state, force_reset)
    plan.ptrs[:] = list(map(torch.Tensor.data_ptr, ins + tuple(outs)))
    stream = torch.cuda.current_stream(plan.device).cuda_stream
    cuda_build.check(cuda_build.launcher(entry)(plan.args_ref, stream),
                     entry)
    # dataclasses.replace re-runs __init__ over every leaf; a shallow copy
    # with the outputs set is the same state at a tenth of the host time
    out = copy.copy(state)
    out.__dict__.update(zip(_OUT_NAMES[:-1], outs))
    return out, outs[-1]


def tail_fused(cfg: EnvConfig, m: MapData, state: WorldState,
               force_reset: torch.Tensor) -> Tuple[WorldState, torch.Tensor]:
    """The fused tail of one step over all worlds. CPU: the plain version;
    CUDA: one launch of csrc/tail_fused.cu tail_fused_kernel (a group of
    lanes per world)."""
    dev = state.hp.device
    if dev.type == "cpu":
        return tail_fused_plain(cfg, m, state, force_reset)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out = _run("tail_fused", cfg, m, state, force_reset)
    tail_fused.launches += 1
    return out


tail_fused.launches = 0


def tail_fused_v1(cfg: EnvConfig, m: MapData, state: WorldState,
                  force_reset: torch.Tensor
                  ) -> Tuple[WorldState, torch.Tensor]:
    """K5's earlier kernel (csrc/tail_fused.cu tail_fused_v1_kernel: one
    thread per world), on CUDA tensors only: the predecessor that
    chip_smoke.py times beside tail_fused, on the same host path. It has
    no LearnShooting override."""
    if state.hp.device.type != "cuda":
        raise ValueError("tail_fused_v1 takes CUDA tensors")
    if cfg.has_flag(SimFlags.EnableCurriculum):
        raise ValueError("tail_fused_v1 has no LearnShooting override")
    out = _run("tail_fused_v1", cfg, m, state, force_reset)
    tail_fused_v1.launches += 1
    return out


tail_fused_v1.launches = 0
