"""Combat: hitscan fire, damage application, autoheal.

fireSystem (reference src/sim.cpp:1443-1615): reload handling, Box-Muller
recoil with upward bias, one hitscan ray per agent against world geometry
(kernel K1) and all agent capsules, friendly-fire and respawn-invincibility
rejection, per-attacker-slot damage writes (slots keyed by attacker offset,
so the scatter is race-free as in the reference's parallel-for).
"""

from __future__ import annotations

import torch

from .. import consts
from ..config import EnvConfig
from ..assets.map_data import MapData
from ..ops import geom
from ..ops.raycast import ray_vs_tris
from ..ops.raycast_cull import ray_vs_capsules
from ..utils import rng
from .types import Actions, Pose, WorldState

INF = float("inf")
_TINY = 1.1754943508222875e-38  # float32 smallest normal


def view_height(stand_cur):
    """viewHeight (reference src/utils.hpp:36-57): pose height minus the
    capsule's cap radius."""
    top = torch.where(
        stand_cur == Pose.Crouch, consts.crouch_height,
        torch.where(stand_cur == Pose.Prone, consts.prone_height,
                    consts.stand_height),
    )
    return top - consts.agent_radius


def eye_offset(stand_cur):
    """(0, 0, view_height) per agent, [..., 3]."""
    vh = view_height(stand_cur)
    zero = torch.zeros_like(vh)
    return torch.stack([zero, zero, vh], dim=-1)


def fire_system(cfg: EnvConfig, m: MapData, state: WorldState,
                actions: Actions, key: torch.Tensor):
    """key: per-world RNG key [W, 2]. Returns (state, fire events)."""
    W, A = state.hp.shape
    dev = state.hp.device
    ts = cfg.team_size
    agent = torch.arange(A, device=dev)
    teams = (agent // ts).to(torch.int32)
    offsets = agent % ts
    alive = state.alive > 0.0
    wt = state.weapon_type.long()

    mag_size = m.weapon_mag_size[wt]
    reload_time = m.weapon_reload_time[wt]
    dmg_per_bullet = m.weapon_dmg[wt]
    accuracy = m.weapon_accuracy[wt]

    # reload
    reloading_now = alive & (actions.fire == 2)
    reloaded_full = reloading_now & (state.mag_bullets == mag_size)
    bullets = torch.where(reloading_now, mag_size, state.mag_bullets)
    is_reloading = torch.where(reloading_now, reload_time,
                               state.mag_reloading)
    reload_in_progress = is_reloading > 0
    is_reloading = torch.where(alive & reload_in_progress, is_reloading - 1,
                               is_reloading)
    should_fire = (
        alive & (~reload_in_progress) & (bullets > 0) & (actions.fire == 1)
    )
    bullets = torch.where(should_fire, bullets - 1, bullets)

    # recoil (Box-Muller, sim.cpp:1505-1522)
    u = rng.uniform(key, (2, A), minval=_TINY, maxval=1.0)  # [W, 2, A]
    mag = geom.sqrt(-2.0 * torch.log(u[:, 0]))
    z1 = mag * torch.cos(2.0 * consts.pi * u[:, 1])
    z2 = mag * torch.sin(2.0 * consts.pi * u[:, 1])
    upward_bias = 1.5
    up_delta = torch.clamp((z1 + upward_bias) * accuracy,
                           torch.zeros_like(accuracy), 4.0 * accuracy)
    right_delta = torch.clamp(z2 * accuracy, -4.0 * accuracy, 4.0 * accuracy)
    yaw = torch.where(should_fire, state.yaw + right_delta, state.yaw)
    pitch = torch.where(should_fire, state.pitch + up_delta, state.pitch)
    yaw, pitch = geom.compute_aim(yaw, pitch)

    # hitscan; the shooter's own capsule is excluded explicitly (the ray
    # starts inside it)
    fire_from = state.pos + eye_offset(state.stand_cur)
    fire_dir, _, _ = geom.aim_vectors(yaw, pitch)
    t_caps = ray_vs_capsules(fire_from, fire_dir, state.pos[:, None],
                             alive[:, None])  # [W, shooter, target]
    is_self = agent[:, None] == agent[None, :]
    t_caps = torch.where(is_self, INF, t_caps)
    t_world = ray_vs_tris(fire_from, fire_dir, m.tris)
    t_cap_min, cap_idx = t_caps.min(dim=-1)
    cap_hit = t_cap_min < t_world
    t_hit = torch.minimum(t_world, t_cap_min)
    victim = torch.where(cap_hit, cap_idx, -1).to(torch.int32)

    hit_any = ~torch.isinf(t_hit)
    fired_shot_t = torch.where(
        should_fire, torch.where(hit_any, t_hit, 3.4e38), -INF
    )

    # hit validity
    v_c = torch.clamp(victim, 0, A - 1).long()
    same_team = teams[v_c] == teams
    victim_invincible = torch.gather(state.respawn_steps, 1, v_c) > 0
    hit_success = should_fire & (victim >= 0) & (~same_team) & (
        ~victim_invincible)
    landed_shot_on = torch.where(hit_success, victim, -1)
    victim_hp = torch.gather(state.hp, 1, v_c)
    successful_kill = hit_success & (victim_hp <= dmg_per_bullet)

    # damage_dealt[victim, attacker_offset] += dmg (one writer per slot)
    dmg = torch.where(hit_success, dmg_per_bullet, 0.0)
    flat = (v_c * ts + offsets).reshape(W, A)
    dmg_updates = torch.zeros(W, A * ts, device=dev).scatter_add_(1, flat,
                                                                 dmg)
    damage_dealt = state.damage_dealt + dmg_updates.reshape(W, A, ts)

    return state.replace(
        yaw=yaw, pitch=pitch, mag_bullets=bullets,
        mag_reloading=is_reloading, reloaded_full_mag=reloaded_full,
        fired_shot_t=fired_shot_t, landed_shot_on=landed_shot_on,
        successful_kill=successful_kill, damage_dealt=damage_dealt,
    ), {
        "reload_event": reloading_now,
        "reload_bullets": state.mag_bullets,
        "shot_event": hit_success,
        "shot_victim": landed_shot_on,
        "kill_event": successful_kill,
    }


def apply_damage_system(cfg: EnvConfig, state: WorldState):
    """applyDmgSystem (sim.cpp:1794-1836)."""
    was_shot_count = (state.damage_dealt > 0.0).sum(-1).to(torch.int32)
    got_hit = was_shot_count > 0
    autoheal_steps = torch.where(
        got_hit, consts.num_out_of_combat_steps_before_autoheal,
        state.autoheal_steps,
    )
    respawn_steps = torch.clamp(state.respawn_steps - 1, min=0)

    hp = state.hp - state.damage_dealt.sum(-1)
    dead_now = hp <= 0.0
    was_killed = (state.alive == 1.0) & dead_now
    far = torch.tensor([0.0, 0.0, 10000.0], device=hp.device)
    return state.replace(
        hp=torch.clamp(hp, min=0.0),
        alive=torch.where(dead_now, 0.0, 1.0),
        pos=torch.where(dead_now[..., None], far, state.pos),
        vel=torch.where(dead_now[..., None], 0.0, state.vel),
        was_shot_count=was_shot_count,
        was_killed=was_killed,
        has_died=state.has_died | was_killed,
        autoheal_steps=autoheal_steps,
        respawn_steps=respawn_steps,
        damage_dealt=torch.zeros_like(state.damage_dealt),
    )


def autoheal_system(cfg: EnvConfig, state: WorldState):
    """autoHealSystem (sim.cpp:1875-1890): +5 HP/step after 150 steps out
    of combat."""
    alive = state.alive > 0.0
    heal_ready = alive & (state.autoheal_steps == 0) & (state.hp < 100.0)
    hp = torch.where(
        heal_ready,
        torch.clamp(state.hp + consts.autoheal_amount_per_step, max=100.0),
        state.hp,
    )
    autoheal_steps = torch.where(
        alive & (state.autoheal_steps > 0), state.autoheal_steps - 1,
        state.autoheal_steps,
    )
    return state.replace(hp=hp, autoheal_steps=autoheal_steps)
