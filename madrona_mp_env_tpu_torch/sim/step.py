"""One batched step: the reference's Step taskgraph as a function.

setupStepTasks (reference src/sim.cpp:5342-5842) in order, over all
worlds at once:

  movement -> aim -> collide -> fall -> fire -> damage -> respawn
  -> autoheal -> zone -> breadcrumbs -> match info -> filters
  -> goal regions -> explore -> rewards -> done -> [reset]
  -> sensor rays -> visibility -> masks -> obs -> lidar

For Task.Zone with RewardMode.Default and no sub-zones, autoheal, zone,
match info, rewards and done are one fused pass (ops/tail_fused.py, K5)
after breadcrumbs, filters, goal regions and explore, as in the JAX
package's step; the other tasks, Flank and SubZones take the unfused
chain (unfused_tail), and so does the logging step (``collect_log``),
which exports the step log between the zone system and match info and
the packed snapshot and game events after done (data/export.py), before
the reset wipes a finished world. The Turret task's auto-aim overlay
drives the turret rows before the movement, and EnvConfig.highlevel_move
replaces the fire system by hl_battle. The reset runs only on steps where some
world resets, as a masked update of those worlds, and the scripted bot's
planner only on steps where some agent is a bot (policy idx -1).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from .. import consts
from ..config import EnvConfig, SimFlags, Task
from ..assets.map_data import MapData
from ..data import export
from ..ops.tail_fused import tail_fused, use_tail_fused
from ..utils import rng
from . import bot, breadcrumbs, combat, explore, hl_battle, movement
from . import reset as reset_mod
from . import rewards, subzones, turret, zones
from .observations import flank_los, observe_tail
from .spawn import spawn_agents
from .types import Actions, WorldState


def fused_tail(cfg: EnvConfig, m: MapData, state: WorldState, shot_victim,
               force_reset: torch.Tensor, tail=None):
    """The fused scalar tail (ops/tail_fused.py): autoheal -> zone ->
    match info -> rewards -> done in one pass (``tail``: K5's entry by
    default, or its plain version). Breadcrumbs, filters, goal regions and explore read no zone
    or match state, so they run first; the filters take the
    post-increment step stamp. Returns (state, new_captured)."""
    state = breadcrumbs.breadcrumb_system(cfg, state)
    state = explore.filters_system(cfg, state, shot_victim,
                                   step_override=state.cur_step + 1)
    state = explore.goal_regions_system(cfg, m, state)
    state = explore.explore_visited_system(cfg, state)
    return (tail or tail_fused)(cfg, m, state, force_reset)


def unfused_tail(cfg: EnvConfig, m: MapData, state: WorldState, shot_victim,
                 force_reset: torch.Tensor, log: Optional[Dict] = None):
    """The reference's system order, one system at a time (every task;
    equal to fused_tail bit for bit where that runs). Returns (state,
    new_captured). ``log``, a dict, receives the step log under
    "step_log", taken where pvpRecordSystem runs: after the zone systems,
    before breadcrumbs and the match info's step increment."""
    state = combat.autoheal_system(cfg, state)
    if cfg.task in (Task.Zone, Task.ZoneCaptureDefend):
        state = zones.zone_system(cfg, m, state)
    if cfg.has_flag(SimFlags.SubZones):
        state = subzones.subzone_system(cfg, m, state)
    if log is not None:
        log["step_log"] = export.step_log_export(cfg, state)
    state = breadcrumbs.breadcrumb_system(cfg, state)
    finish = force_reset != 0
    if cfg.task in (Task.Zone, Task.ZoneCaptureDefend):
        state, new_captured = zones.zone_match_info_system(cfg, m, state,
                                                           finish)
    elif cfg.task == Task.Turret:
        state, new_captured = turret.turret_match_info_system(cfg, state,
                                                              finish)
    else:
        state, new_captured = zones.tdm_match_info_system(cfg, state,
                                                          finish)
    state = explore.filters_system(cfg, state, shot_victim)
    state = explore.goal_regions_system(cfg, m, state)
    state = explore.explore_visited_system(cfg, state)
    if flank_los(cfg):
        state = rewards.refresh_flank_los(cfg, m, state)
    state = rewards.reward_system(cfg, m, state)
    done = state.is_finished.to(torch.int32)[:, None].expand(
        -1, cfg.num_agents)
    return state.replace(done=done.contiguous()), new_captured


def step_world_core(cfg: EnvConfig, m: MapData, state: WorldState,
                    actions: Actions, force_reset: torch.Tensor,
                    collect_log: bool = False) -> Tuple[WorldState, Dict]:
    """Everything before the reset and the observation tail; with
    ``collect_log`` the outputs add "step_log", "snapshot" and
    "game_events"."""
    stepk = rng.step_key(state.episode_key, state.cur_step)

    # the turret rows' auto-aim (turretFireSystem, sim.cpp:1617-1792)
    actions = turret.turret_ai_system(cfg, m, state, actions)
    state = movement.movement_system(cfg, state, actions)
    state = movement.aim_systems(cfg, state, actions)
    state = movement.apply_velocity_system(cfg, m, state)
    state = movement.fall_system(cfg, m, state)

    if cfg.highlevel_move:
        state, fire_events = hl_battle.hl_battle_system(cfg, m, state)
    else:
        state, fire_events = combat.fire_system(
            cfg, m, state, actions, rng.system_key(stepk, rng.Salt.FIRE)
        )
    state = combat.apply_damage_system(cfg, state)
    if not cfg.has_flag(SimFlags.NoRespawn):
        state = spawn_agents(cfg, m, state,
                             rng.system_key(stepk, rng.Salt.SPAWN),
                             is_respawn=True)
    record = {} if collect_log else None
    if use_tail_fused(cfg, collect_log):
        state, new_captured = fused_tail(cfg, m, state,
                                         fire_events["shot_victim"],
                                         force_reset)
    else:
        state, new_captured = unfused_tail(cfg, m, state,
                                           fire_events["shot_victim"],
                                           force_reset, log=record)
    outputs = {
        "reward": state.reward,
        "done": state.done,
        "episode_result": {
            "win_result": state.win_result,
            "team_kills": state.team_kills,
            "team_points": state.team_points,
            "zone_stats": state.zone_stats,
            "match_finished": state.is_finished,
        },
        "events": {**fire_events, "capture_event": new_captured,
                   "cur_step": state.cur_step},
    }
    if collect_log:
        # after match info, rewards and done (cur_step post-increment)
        ev = export.event_export(cfg, state, fire_events, new_captured)
        record["snapshot"] = export.packed_snapshot_export(
            cfg, state, ev["num_events"], ev["event_mask"])
        record["game_events"] = ev
        outputs.update(record)
    return state, outputs


def step_batched(cfg: EnvConfig, m: MapData, state: WorldState,
                 actions: Actions, init_key: torch.Tensor, sim_ctrl,
                 force_reset: torch.Tensor, collect_log: bool = False
                 ) -> Tuple[WorldState, Dict]:
    """All worlds: [bot overlay] -> core -> reset (only if some world
    resets) -> observation tail. The overlay (the JAX step's lax.cond)
    runs when some agent of some world is a bot; that check is the step's
    one read to the host before the reset's."""
    if bool((state.policy_idx == consts.a_star_policy_id).any()):
        actions = bot.bot_overlay(cfg, m, state, actions)
    state, outputs = step_world_core(cfg, m, state, actions, force_reset,
                                     collect_log)
    should = force_reset != 0
    if cfg.auto_reset:
        should = should | state.is_finished
    state = state.replace(was_reset=should)
    if bool(should.any()):
        state = reset_mod.reset_system(cfg, m, state, init_key, sim_ctrl,
                                       force_reset)
    state, obs = observe_tail(cfg, m, state)
    return state, {"obs": obs, **outputs}


def init_and_observe(cfg: EnvConfig, m: MapData, state: WorldState,
                     init_key: torch.Tensor, sim_ctrl
                     ) -> Tuple[WorldState, Dict]:
    """Init taskgraph (setupInitTasks, sim.cpp:5322-5340): force reset,
    then the observation tail."""
    W = state.hp.shape[0]
    force = torch.ones(W, dtype=torch.int32, device=state.hp.device)
    state = reset_mod.reset_system(cfg, m, state, init_key, sim_ctrl, force)
    return observe_tail(cfg, m, state)
