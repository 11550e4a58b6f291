"""High-level-move battle: instant-kill auto-combat.

hlBattleSystem (reference src/sim.cpp:1346-1441), which replaces
fireSystem when the env runs in high-level movement mode
(EnvConfig.highlevel_move, hooked at sim.cpp:5465-5468): each live agent
auto-targets the most aligned (then the closest) visible opponent in
front of it and within one frame's slew, and deals a lethal 100 damage,
so combat reduces to positioning. The line of sight from each agent's eye
to each opponent's eye is one ray vs the world (kernel K1,
ops/raycast.py ray_vs_tris): W * A * ts rays a step.
"""

from __future__ import annotations

import torch

from ..config import EnvConfig
from ..assets.map_data import MapData
from ..ops import geom
from ..ops.raycast import ray_vs_tris
from .combat import eye_offset
from .turret import best_target
from .types import WorldState


def hl_battle_system(cfg: EnvConfig, m: MapData, state: WorldState):
    """Auto-target and instant damage; returns (state, fire events) with
    combat.fire_system's event keys."""
    W, A = state.hp.shape
    ts = cfg.team_size
    dev = state.pos.device
    agent = torch.arange(A, device=dev)
    teams = agent // ts
    offsets = agent % ts
    opp_idx = (1 - teams[:, None]) * ts + torch.arange(ts, device=dev)

    alive = state.alive > 0.0
    eye = state.pos + eye_offset(state.stand_cur)  # fire_from and target
    fwd, _, _ = geom.aim_vectors(state.yaw, state.pitch)
    to_tgt = eye[:, opp_idx] - eye[:, :, None]  # [W, A, ts, 3]
    dist = geom.norm(to_tgt)
    to_n = to_tgt / torch.clamp(dist[..., None], min=1e-9)

    t_world = ray_vs_tris(eye[:, :, None].expand_as(to_tgt), to_n, m.tris)
    candidate = ((t_world >= dist - 1e-3) & alive[:, opp_idx]
                 & ~(state.respawn_steps[:, opp_idx] > 0) & alive[..., None])
    best, eff_cos = best_target(fwd, to_n, dist, candidate, in_front=True)
    has_tgt = torch.isfinite(torch.gather(eff_cos, 2, best[..., None])
                             )[..., 0]
    victim = torch.where(has_tgt, opp_idx[agent[:, None], best[..., None]
                                          ][..., 0], -1)
    hit_dist = torch.gather(dist, 2, best[..., None])[..., 0]

    # lethal damage into the victim's attacker slot (sim.cpp:1437-1440)
    v_c = torch.clamp(victim, 0, A - 1)
    flat = v_c * ts + offsets
    dmg = torch.zeros(W, A * ts, device=dev).scatter_add_(
        1, flat, torch.where(has_tgt, 100.0, 0.0))
    landed_on = victim.to(torch.int32)
    state = state.replace(
        landed_shot_on=landed_on,
        successful_kill=has_tgt,
        fired_shot_t=torch.where(has_tgt, hit_dist, -float("inf")),
        damage_dealt=state.damage_dealt + dmg.reshape(W, A, ts),
    )
    return state, {
        "reload_event": torch.zeros_like(has_tgt),
        "reload_bullets": state.mag_bullets,
        "shot_event": has_tgt,
        "shot_victim": landed_on,
        "kill_event": has_tgt,
    }
