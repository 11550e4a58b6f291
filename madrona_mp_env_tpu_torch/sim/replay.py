"""Deterministic replay, batched over worlds.

pvpReplaySystem (reference src/sim.cpp:4794-4843), as the JAX package's
sim/replay.py runs it per world: the movement and combat half of the step
is replaced by writing the recorded per-agent state of a StepLog, then the
rest of the step graph runs (zone, breadcrumbs, match info, goal regions,
explore, rewards, done, reset, observations), so that a recorded match
reproduces its event and analytics stream. Zone and ZoneCaptureDefend run
the zone chain, every other task (Turret too) TDM's match info. No
autoheal, no filters, no Flank LOS refresh and no full-team observations,
as in the JAX replay; its sensor fans sweep the whole soup (the JAX replay
passes no PVS cells: K2 on town_map where the step takes K6).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..config import EnvConfig, Task
from ..assets.map_data import MapData
from ..data import export
from . import breadcrumbs, explore
from . import reset as reset_mod
from . import rewards, zones
from .observations import (build_sensor_rays, lidar_system,
                           observations_system, opponent_masks_system,
                           split_visibility, visibility_system)
from .types import WorldState


def apply_step_log(cfg: EnvConfig, state: WorldState,
                   log: Dict[str, torch.Tensor]) -> WorldState:
    """Write the recorded per-agent state (sim.cpp:4795-4843): ``log``
    leaves [W, 12, ...] (the first cfg.num_agents entries are live) and
    cur_step [W]."""
    A = cfg.num_agents

    def take(k, dtype):
        return log[k][:, :A].to(dtype)

    was_killed = take("was_killed", torch.bool)
    hp = take("hp", torch.float32)
    return state.replace(
        pos=take("pos", torch.float32),
        yaw=take("aim_yaw", torch.float32),
        pitch=take("aim_pitch", torch.float32),
        hp=hp,
        mag_bullets=take("mag_bullets", torch.int32),
        mag_reloading=take("mag_reloading", torch.int32),
        stand_cur=take("stand_cur", torch.int32),
        stand_tgt=take("stand_tgt", torch.int32),
        stand_transition=take("stand_transition", torch.int32),
        landed_shot_on=take("shot_agent_idx", torch.int32),
        fired_shot_t=take("fired_shot_t", torch.float32),
        was_killed=was_killed,
        successful_kill=take("successful_kill", torch.bool),
        has_died=state.has_died | was_killed,
        alive=(hp > 0).to(torch.float32),
        cur_step=log["cur_step"].to(torch.int32),
    )


def replay_observe(cfg: EnvConfig, m: MapData, state: WorldState):
    """The replay's observation tail: sensor rays over the whole soup ->
    visibility -> masks -> obs -> lidar."""
    sensor = build_sensor_rays(cfg, m, state, culled=False)
    can_see, opp_idx = visibility_system(cfg, m, state, sensor)
    state, can_see, opp_idx = split_visibility(cfg, state, can_see, opp_idx)
    masks = opponent_masks_system(cfg, state, can_see, opp_idx)
    state, obs = observations_system(cfg, m, state, can_see, opp_idx, masks)
    state, lidar_obs = lidar_system(cfg, m, state, sensor)
    obs.update(lidar_obs)
    return state, obs


def replay_step(cfg: EnvConfig, m: MapData, state: WorldState,
                log: Dict[str, torch.Tensor], init_key: torch.Tensor,
                sim_ctrl, force_reset: torch.Tensor
                ) -> Tuple[WorldState, Dict]:
    """One replayed step of every world (the replay taskgraph,
    sim.cpp:5587-5605): the state from the log, then zones -> match info
    -> rewards -> done -> the snapshot and events -> reset (only if some
    world resets, masked as the step's) -> observations."""
    prev_bullets = state.mag_bullets  # the Reload events' bullet count
    state = apply_step_log(cfg, state, log)
    zoned = cfg.task in (Task.Zone, Task.ZoneCaptureDefend)
    if zoned:
        state = zones.zone_system(cfg, m, state)
    state = breadcrumbs.breadcrumb_system(cfg, state)
    finish = force_reset != 0
    if zoned:
        state, new_captured = zones.zone_match_info_system(cfg, m, state,
                                                           finish)
    else:
        state, new_captured = zones.tdm_match_info_system(cfg, state, finish)
    state = explore.goal_regions_system(cfg, m, state)
    state = explore.explore_visited_system(cfg, state)
    state = rewards.reward_system(cfg, m, state)
    done = state.is_finished.to(torch.int32)[:, None].expand(
        -1, cfg.num_agents).contiguous()
    state = state.replace(done=done)
    episode_result = {
        "win_result": state.win_result,
        "team_kills": state.team_kills,
        "team_points": state.team_points,
        "zone_stats": state.zone_stats,
        "match_finished": state.is_finished,
    }
    # the log holds the magazines after the reload (the fire system sets
    # reloading = reload_time - 1 on the reload step), so that step is
    # reloading == reload_time - 1, and its bullet count the previous
    # step's magazine
    reload_time = m.weapon_reload_time[state.weapon_type]
    fire_events = {
        "reload_event": state.mag_reloading == reload_time - 1,
        "reload_bullets": prev_bullets,
        "shot_event": state.landed_shot_on >= 0,
        "shot_victim": state.landed_shot_on,
        "kill_event": state.successful_kill,
    }
    ev = export.event_export(cfg, state, fire_events, new_captured)
    snapshot = export.packed_snapshot_export(cfg, state, ev["num_events"],
                                             ev["event_mask"])
    reward = state.reward
    should = finish
    if cfg.auto_reset:
        should = should | state.is_finished
    state = state.replace(was_reset=should)
    if bool(should.any()):
        state = reset_mod.reset_system(cfg, m, state, init_key, sim_ctrl,
                                       force_reset)
    state, obs = replay_observe(cfg, m, state)
    return state, {"obs": obs, "reward": reward, "done": done,
                   "episode_result": episode_result, "snapshot": snapshot,
                   "game_events": ev}
