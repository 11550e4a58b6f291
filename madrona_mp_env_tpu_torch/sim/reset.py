"""Episode reset / world init (resetSystem + initWorld, reference
src/sim.cpp:732-872; resetPersistentEntities, src/level_gen.cpp:330-582).

A reset is a masked update: the fresh-episode state is computed for every
world and selected per world by the reset predicate. With
SimFlags.EnableCurriculum a resetting world draws its world curriculum
(LearnShooting or FullMatch) over its first 50 episodes; with
EnvConfig.enable_spawn_curriculum (on a map whose every tier has region
pairs) an episode draws its spawn tier and pair. On a map with
trajectory-curriculum snapshots (Env's curriculum_path) a fresh episode
outside eval mode restores one with probability
EnvConfig.trajectory_curriculum_prob (level_gen.cpp:498-581).
"""

from __future__ import annotations

import dataclasses

import torch

from .. import consts
from ..config import EnvConfig, SimFlags, Task
from ..assets.map_data import MapData
from ..ops import geom
from ..utils import rng
from .spawn import spawn_agents
from .types import Pose, WorldCurriculum, WorldState

# the world curriculum's schedule covers a world's first episodes
CURRICULUM_EPISODES = 50


def _spawn_curriculum_sample(cfg: EnvConfig, m: MapData, k_curr, W, dev):
    """The episode's spawn-curriculum draw (initWorld, sim.cpp:766-794):
    (active [W] bool, tier [W] i32, pair index [W] i32) from three keys
    split off ``k_curr`` [W, 2]; all zero without the curriculum."""
    if not (cfg.enable_spawn_curriculum and m.has_spawn_curriculum):
        zero = torch.zeros(W, dtype=torch.int32, device=dev)
        return zero.bool(), zero, zero
    k1, k2, k3 = rng.split(k_curr, 3).unbind(-2)
    active = rng.uniform(k1) < cfg.use_curriculum_spawn_prob
    cdf = torch.cumsum(torch.tensor(cfg.curriculum_tier_probs,
                                    dtype=torch.float32, device=dev), 0)
    u = rng.uniform(k2) * cdf[-1]
    tier = torch.clamp(torch.searchsorted(cdf, u), 0, 4)
    n_spawns = torch.clamp(m.curr_spawn_counts[tier], min=1)
    idx = rng.randint(k3, (), 0, 2 ** 30) % n_spawns
    return active, tier.to(torch.int32), idx.to(torch.int32)


def init_world(cfg: EnvConfig, m: MapData, state: WorldState,
               init_key: torch.Tensor, sim_ctrl, triggered_reset
               ) -> WorldState:
    """Fresh-episode state of every world (initWorld +
    resetPersistentEntities). sim_ctrl: host ints [eval, randomize episode
    length, randomize team sides]; triggered_reset [W] bool."""
    W, A = state.hp.shape
    dev = state.hp.device

    ep_key = rng.episode_key(init_key, state.episode_idx, state.world_idx)
    base = rng.step_key(ep_key, -1)
    keys = rng.split(base, 6)  # flip, stagger, zone, spawn, curr, coef
    k_flip, k_stagger, k_zone, k_spawn, k_curr = (keys[:, j]
                                                  for j in range(5))

    flip = bool(sim_ctrl[2]) & (rng.uniform(k_flip) < 0.5)
    team_a = flip.to(torch.int32)
    stagger = triggered_reset & bool(sim_ctrl[1])
    cur_step = torch.where(
        stagger, rng.randint(k_stagger, (), 0, cfg.episode_len - 1), 0
    ).to(torch.int32)
    if cfg.task == Task.Zone:
        zone_cur = rng.randint(k_zone, (), 0, m.num_zones)
    else:
        # ZoneCaptureDefend holds zone 3; the zoneless tasks keep 0
        zone_cur = torch.full((W,), 3 if cfg.task == Task.ZoneCaptureDefend
                              else 0, dtype=torch.int32, device=dev)

    f, i, b = torch.float32, torch.int32, torch.bool

    def full(shape, v, dtype):
        return torch.full((W,) + tuple(shape), v, dtype=dtype, device=dev)

    coefs = torch.tensor(cfg.reward_defaults.as_tuple(), dtype=f, device=dev)
    sc_active, sc_tier, sc_idx = _spawn_curriculum_sample(cfg, m, k_curr, W,
                                                          dev)
    state = state.replace(
        curr_spawn_active=sc_active,
        curr_spawn_tier=sc_tier,
        curr_spawn_idx=sc_idx,
        team_a=team_a,
        cur_step=cur_step,
        is_finished=full((), False, b),
        win_result=full((), -1, i),
        team_kills=full((2,), 0, i),
        team_points=full((2,), 0, i),
        zone_stats=torch.zeros_like(state.zone_stats),
        zone_cur=zone_cur,
        zone_controlling=full((), -1, i),
        zone_contested=full((), False, b),
        zone_captured=full((), False, b),
        zone_earned_point=full((), False, b),
        zone_steps_remaining=full((), consts.num_steps_per_zone, i),
        zone_steps_until_point=full((), consts.zone_point_interval, i),
        episode_key=ep_key,
        # agents -> far away + dead so spawn_agents respawns everyone
        pos=full((A, 3), 3.0e37, f),
        vel=full((A, 3), 0.0, f),
        alive=full((A,), 0.0, f),
        hp=full((A,), 0.0, f),
        respawn_steps=full((A,), 0, i),
        autoheal_steps=full((A,), 0, i),
        landed_shot_on=full((A,), -1, i),
        successful_kill=full((A,), False, b),
        was_shot_count=full((A,), 0, i),
        was_killed=full((A,), False, b),
        fired_shot_t=full((A,), -float("inf"), f),
        has_died=full((A,), False, b),
        reloaded_full_mag=full((A,), False, b),
        in_zone=full((A,), False, b),
        min_dist_to_zone=full((A,), float("inf"), f),
        subzone_ctrl=full((8,), -1, i),
        subzone_contested=full((8,), False, b),
        in_subzone=full((A,), False, b),
        min_dist_subzone=full((A,), float("inf"), f),
        damage_dealt=torch.zeros_like(state.damage_dealt),
        aim_vel_yaw=full((A,), 0.0, f),
        aim_vel_pitch=full((A,), 0.0, f),
        # not cleared here: last-known obs, crumbs and explore bits are
        # cleared lazily by their owning systems via was_reset
        spawn_a_used=torch.full_like(state.spawn_a_used, 0xFFFFFFFF),
        spawn_b_used=torch.full_like(state.spawn_b_used, 0xFFFFFFFF),
        spawn_respawn_used=torch.full_like(state.spawn_respawn_used,
                                           0xFFFFFFFF),
        reward_coefs=coefs.expand(W, A, -1).clone(),
        filters_last_match=full((2, 3), -(10 ** 6), i),
        filters_last_all_matched=full((2,), -(10 ** 6), i),
        goal_min_dist=torch.full_like(state.goal_min_dist, float("inf")),
        goal_team_rewards=full((2,), 0.0, f),
    )
    state = spawn_agents(cfg, m, state, k_spawn, is_respawn=False)
    state = state.replace(start_pos=state.pos)
    if m.num_curriculum_snapshots > 0:
        state = _maybe_restore_snapshot(cfg, m, state, k_curr, sim_ctrl)
    return state


def _maybe_restore_snapshot(cfg: EnvConfig, m: MapData, state: WorldState,
                            k_curr: torch.Tensor, sim_ctrl) -> WorldState:
    """The trajectory-curriculum restore (level_gen.cpp:498-581), masked
    per world: a world outside eval mode whose draw from ``k_curr`` [W,
    2] (split into k_p and k_idx) falls below
    cfg.trajectory_curriculum_prob takes snapshot randint(k_idx, 0, S):
    its players (team halves swapped when team_a is 1), aim through
    compute_aim, pose from the flag bits, the match step, and the zone
    state where the snapshot's zone is held."""
    W, A = state.hp.shape
    dev = state.hp.device
    k_p, k_idx = rng.split(k_curr, 2).unbind(-2)
    do = rng.uniform(k_p) < cfg.trajectory_curriculum_prob
    if sim_ctrl[0]:
        do = torch.zeros_like(do)
    idx = rng.randint(k_idx, (), 0, m.num_curriculum_snapshots).long()
    ms = m.curriculum_match_state[idx]  # [W, 5]
    players = m.curriculum_players[idx]  # [W, 12, 9]
    controller = ms[:, 2]
    captured = controller != -1

    # players[i] goes to agent perm[i] (level_gen.cpp:527-539)
    agent = torch.arange(A, device=dev)
    swapped = torch.where(agent < A // 2, agent + A // 2, agent - A // 2)
    perm = torch.where(state.team_a[:, None] == 0, agent, swapped)
    src = torch.argsort(perm, dim=-1)
    p = torch.gather(players, 1, src[..., None].expand(-1, -1, 9))
    yaw, pitch = geom.compute_aim(p[..., 3], p[..., 4])
    flags = p[..., 8].to(torch.int32)
    pose = torch.where((flags & 8) != 0, Pose.Prone,
                       torch.where((flags & 4) != 0, Pose.Crouch,
                                   Pose.Stand)).to(torch.int32)

    def w(new, old):
        cond = do.reshape((W,) + (1,) * (old.dim() - 1))
        return torch.where(cond, new.to(old.dtype), old)

    return state.replace(
        zone_cur=w(ms[:, 1], state.zone_cur),
        zone_controlling=w(torch.where(captured, controller, -1),
                           state.zone_controlling),
        zone_captured=w(captured, state.zone_captured),
        zone_steps_until_point=w(
            torch.where(captured, ms[:, 4], state.zone_steps_until_point),
            state.zone_steps_until_point),
        zone_steps_remaining=w(
            torch.where(captured, ms[:, 3], state.zone_steps_remaining),
            state.zone_steps_remaining),
        cur_step=w(ms[:, 0], state.cur_step),
        pos=w(p[..., 0:3], state.pos),
        yaw=w(yaw, state.yaw),
        pitch=w(pitch, state.pitch),
        hp=w(p[..., 7], state.hp),
        mag_bullets=w(p[..., 5].to(torch.int32), state.mag_bullets),
        mag_reloading=w(p[..., 6].to(torch.int32), state.mag_reloading),
        stand_cur=w(pose, state.stand_cur),
        stand_tgt=w(pose, state.stand_tgt),
        stand_transition=w(torch.zeros_like(pose), state.stand_transition),
    )


def reset_system(cfg: EnvConfig, m: MapData, state: WorldState,
                 init_key: torch.Tensor, sim_ctrl, force_reset: torch.Tensor
                 ) -> WorldState:
    """resetSystem (sim.cpp:835-872): reset the worlds whose match ended
    (auto reset) or that are forced; force_reset [W]. With
    SimFlags.EnableCurriculum a resetting world in its first
    CURRICULUM_EPISODES episodes plays FullMatch with probability
    (episode + 1) / 50, else LearnShooting (drawn from its last step's
    key), and FullMatch after them."""
    should = force_reset != 0
    if cfg.auto_reset:
        should = should | state.is_finished
    episode = state.episode_counter
    world_curr = state.world_curriculum
    if cfg.has_flag(SimFlags.EnableCurriculum):
        ck = rng.system_key(rng.step_key(state.episode_key, state.cur_step),
                            rng.Salt.CURRICULUM)
        frac = (episode.to(torch.float32) + 1.0) / torch.full(
            (), float(CURRICULUM_EPISODES), device=episode.device)
        sched = torch.where(
            (episode < CURRICULUM_EPISODES) & ~(rng.uniform(ck) < frac),
            WorldCurriculum.LearnShooting, WorldCurriculum.FullMatch)
        world_curr = torch.where(should, sched, world_curr).to(torch.int32)
    pre = state.replace(
        episode_idx=torch.where(should, episode, state.episode_idx),
        episode_counter=(episode + should.to(torch.int64)) & 0xFFFFFFFF,
        world_curriculum=world_curr,
        was_reset=should,
    )
    fresh = init_world(cfg, m, pre, init_key, sim_ctrl,
                       triggered_reset=force_reset != 0)

    def sel(new, old):
        return torch.where(should.reshape((-1,) + (1,) * (old.dim() - 1)),
                           new, old)

    return WorldState(**{
        fl.name: sel(getattr(fresh, fl.name), getattr(pre, fl.name))
        for fl in dataclasses.fields(WorldState)
    })
