"""The step's record, snapshot and event exports, batched over worlds.

Each takes the [W, ...] state and returns the [W, ...] tensors that back
one binary record format; data/recorder.py packs them into the structs on
the host. They mirror pvpRecordSystem (reference src/sim.cpp:4750-4792),
writePackedStepSnapshot (sim.cpp:41-126) and the logEvent call sites, as
the JAX package's data/export.py does per world. Elementwise ops only, so
every device computes the same bits:

- the aim quaternion takes its half-angle sines and cosines from
  ``sinf`` / ``cosf``, glibc's float32 sinf / cosf (the values XLA's CPU
  backend computes) evaluated in float64 tensor ops;
- a float that becomes a narrower integer goes through ``saturate``,
  XLA's conversion rule (NaN to 0, out-of-range values clamped, the rest
  truncated toward zero). ATen's ``.to`` wraps there on the CPU and CUDA
  differs again; a yaw of +-pi or a negative hp reaches that edge. An
  integer that becomes a narrower integer wraps on both, as XLA's does;
- uint32 values (event masks, counts) are held in int64 tensors.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..config import EnvConfig
from ..ops import geom
from ..sim.types import Pose, WorldState
from .formats import MAX_PLAYERS

# glibc's __sincosf_table (sysdeps/ieee754/flt-32/s_sincosf_data.c):
# 2 / pi scaled by 2^24 for the quadrant, pi / 2, the cosine polynomial
# c0..c4 and the sine polynomial s1..s3
_H = float.fromhex
_HPI_INV = _H("0x1.45f306dc9c883p+23")
_HPI = _H("0x1.921fb54442d18p+0")
_C = (_H("0x1p0"), _H("-0x1.ffffffd0c621cp-2"), _H("0x1.55553e1068f19p-5"),
      _H("-0x1.6c087e89a359dp-10"), _H("0x1.99343027bf8c3p-16"))
_S = (_H("-0x1.555545995a603p-3"), _H("0x1.1107605230bc4p-7"),
      _H("-0x1.994eb3774cf24p-13"))
# the top 12 bits of |pi / 4| and of 2^-12 as float32 (abstop12)
_TOP_PIO4 = 0x3F4
_TOP_TINY = 0x39800000 >> 20


def _abstop12(y: torch.Tensor) -> torch.Tensor:
    return (y.view(torch.int32) >> 20) & 0x7FF


def _sincosf(y: torch.Tensor, cos: bool) -> torch.Tensor:
    """glibc's sinf (cos False) / cosf (True) of float32 ``y``, for |y| <
    120 (the sim's half angles are within pi / 2): the quadrant reduction
    and polynomials in float64, rounded once to float32."""
    x = y.double()
    top = _abstop12(y)
    small = top < _TOP_PIO4
    n = ((x * _HPI_INV).to(torch.int32) + 0x800000) >> 24
    n = torch.where(small, 0, n)
    xr = x - n.double() * _HPI
    odd_half = (n & 2) != 0
    # sign[n & 3] = (1, -1, -1, 1)
    xs = torch.where(odd_half ^ ((n & 1) != 0), -xr, xr)
    x2 = xr * xr
    x3 = xs * x2
    sin_p = (xs + x3 * _S[0]) + (x3 * x2) * (_S[1] + x2 * _S[2])
    x4 = x2 * x2
    cos_p = ((_C[0] + x2 * _C[1]) + x4 * _C[2]) + (x4 * x2) * (
        _C[3] + x2 * _C[4])
    # the second table negates the cosine polynomial
    cos_p = torch.where(odd_half, -cos_p, cos_p)
    q = (n ^ 1) if cos else n
    out = torch.where((q & 1) == 0, sin_p, cos_p).float()
    tiny = top < _TOP_TINY
    return torch.where(tiny, torch.ones_like(y) if cos else y, out)


def sinf(y: torch.Tensor) -> torch.Tensor:
    return _sincosf(y, cos=False)


def cosf(y: torch.Tensor) -> torch.Tensor:
    return _sincosf(y, cos=True)


def saturate(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """XLA's float -> integer conversion: NaN to 0, values beyond the
    integer range to its ends, the rest truncated toward zero."""
    info = torch.iinfo(dtype)
    x = torch.nan_to_num(x, nan=0.0)
    return torch.clamp(x, float(info.min), float(info.max)).to(dtype)


def aim_quat(yaw: torch.Tensor, pitch: torch.Tensor) -> torch.Tensor:
    """Aim.rot = angleAxis(yaw, up) * angleAxis(pitch, right), normalized
    (computeAim, reference src/utils.cpp:140-167): [..., 4] as w, x, y,
    z."""
    from ..ops import geom

    hy, hp = yaw * 0.5, pitch * 0.5
    cy, sy = cosf(hy), sinf(hy)
    cp, sp = cosf(hp), sinf(hp)
    q = torch.stack([cy * cp, cy * sp, sy * sp, sy * cp], dim=-1)
    ss = ((q[..., 0] * q[..., 0] + q[..., 1] * q[..., 1])
          + q[..., 2] * q[..., 2]) + q[..., 3] * q[..., 3]
    return q / geom.sqrt(ss)[..., None]


def pad_players(x: torch.Tensor, fill=0) -> torch.Tensor:
    """Pad the agent axis (dim 1) to MAX_PLAYERS."""
    pad = MAX_PLAYERS - x.shape[1]
    if pad == 0:
        return x
    shape = (x.shape[0], pad) + tuple(x.shape[2:])
    return torch.cat([x, torch.full(shape, fill, dtype=x.dtype,
                                    device=x.device)], dim=1)


def step_log_export(cfg: EnvConfig, state: WorldState
                    ) -> Dict[str, torch.Tensor]:
    """The full-precision record of every world (AgentLogData,
    types.hpp:574-589), [W, 12, ...] and cur_step [W]. The step takes it
    after the zone system and before match info, where pvpRecordSystem
    sits (sim.cpp:5557-5563)."""
    return {
        "pos": pad_players(state.pos),
        "aim_yaw": pad_players(state.yaw),
        "aim_pitch": pad_players(state.pitch),
        "aim_rot": pad_players(aim_quat(state.yaw, state.pitch)),
        "hp": pad_players(state.hp),
        "mag_bullets": pad_players(state.mag_bullets),
        "mag_reloading": pad_players(state.mag_reloading),
        "stand_cur": pad_players(state.stand_cur),
        "stand_tgt": pad_players(state.stand_tgt),
        "stand_transition": pad_players(state.stand_transition),
        "shot_agent_idx": pad_players(state.landed_shot_on, fill=-1),
        "fired_shot_t": pad_players(state.fired_shot_t),
        "was_killed": pad_players(state.was_killed),
        "successful_kill": pad_players(state.successful_kill),
        "cur_step": state.cur_step,
    }


def packed_snapshot_export(cfg: EnvConfig, state: WorldState,
                           num_events: torch.Tensor,
                           event_mask: torch.Tensor
                           ) -> Dict[str, torch.Tensor]:
    """The quantized PackedStepSnapshot of every world (sim.cpp:41-126):
    int16 positions, int16 angles * 32768 / pi, uint8 hp and magazine,
    the pose and fired-shot flags."""
    scale = 32768.0 / torch.pi
    flags = (torch.where(state.landed_shot_on >= 0, 2, 0)
             | torch.where(state.stand_cur == Pose.Crouch, 4, 0)
             | torch.where(state.stand_cur == Pose.Prone, 8, 0))
    controller = torch.where(state.zone_captured, state.zone_controlling, -1)
    return {
        "num_events": num_events,
        "event_mask": event_mask,
        "world_idx": state.world_idx,
        "episode_idx": state.episode_idx,
        "match_step": state.cur_step,
        "cur_zone": state.zone_cur,
        "cur_zone_controller": controller.to(torch.int32),
        "zone_steps_remaining": state.zone_steps_remaining,
        "steps_until_point": state.zone_steps_until_point,
        "player_pos": pad_players(saturate(state.pos, torch.int16)),
        "player_yaw": pad_players(saturate(state.yaw * scale, torch.int16)),
        "player_pitch": pad_players(saturate(state.pitch * scale,
                                             torch.int16)),
        "player_mag": pad_players(state.mag_bullets.to(torch.uint8)),
        "player_reloading": pad_players(state.mag_reloading.to(torch.uint8)),
        "player_hp": pad_players(saturate(state.hp, torch.uint8)),
        "player_flags": pad_players(flags.to(torch.uint8)),
    }


def event_export(cfg: EnvConfig, state: WorldState,
                 fire_events: Dict[str, torch.Tensor],
                 new_captured: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Every world's event flags and payloads ([W] / [W, A]), compacted
    into GameEvent records on the host (logEvent sites: reload
    sim.cpp:1464-1476, kill and player shot sim.cpp:1575-1611, capture
    sim.cpp:4592-4632)."""
    A = cfg.num_agents
    dev = state.pos.device
    agent = torch.arange(A, device=dev)
    teams = agent // cfg.team_size
    # the capture's inZoneMask: the controlling team's members in the zone
    held = state.in_zone & (teams == state.zone_controlling[:, None])
    in_zone_mask = (held.to(torch.int64) << agent).sum(-1)
    reload, shot = fire_events["reload_event"], fire_events["shot_event"]
    kill = fire_events["kill_event"]
    num_events = (reload.to(torch.int64).sum(-1) + shot.to(torch.int64).sum(-1)
                  + kill.to(torch.int64).sum(-1)
                  + new_captured.to(torch.int64))
    event_mask = (torch.where(new_captured, 1, 0)
                  | torch.where(reload.any(-1), 2, 0)
                  | torch.where(kill.any(-1), 4, 0)
                  | torch.where(shot.any(-1), 8, 0)).to(torch.int64)
    return {
        "reload_event": reload,
        "reload_bullets": fire_events["reload_bullets"],
        "shot_event": shot,
        "shot_victim": fire_events["shot_victim"],
        "kill_event": kill,
        "capture_event": new_captured,
        "capture_zone": state.zone_cur,
        "capture_team": state.zone_controlling,
        "in_zone_mask": in_zone_mask,
        "num_events": num_events,
        "event_mask": event_mask,
        "world_idx": state.world_idx,
        "episode_idx": state.episode_idx,
        "match_step": state.cur_step,
    }
