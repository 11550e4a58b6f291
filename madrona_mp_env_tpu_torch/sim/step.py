"""One batched step: the reference's Step taskgraph as a function.

setupStepTasks (reference src/sim.cpp:5342-5842) in order, over all
worlds at once:

  movement -> aim -> collide -> fall -> fire -> damage -> respawn
  -> autoheal -> zone -> breadcrumbs -> match info -> filters
  -> goal regions -> explore -> rewards -> done -> [reset]
  -> sensor rays -> visibility -> masks -> obs -> lidar

For Task.Zone with RewardMode.Default (every configuration the port
runs) autoheal, zone, match info, rewards and done are one fused pass
(ops/tail_fused.py, K5) after breadcrumbs, filters, goal regions and
explore, as in the JAX package's step. The reset runs only on steps where
some world resets, as a masked update of those worlds. Ported
configuration: Task.Zone, RewardMode.Default, policy agents only (no
scripted bot).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..config import EnvConfig, SimFlags
from ..assets.map_data import MapData
from ..ops.tail_fused import tail_fused, use_tail_fused
from ..utils import rng
from . import breadcrumbs, combat, explore, movement, rewards, zones
from . import reset as reset_mod
from .observations import observe_tail
from .spawn import spawn_agents
from .types import Actions, WorldState


def step_world_core(cfg: EnvConfig, m: MapData, state: WorldState,
                    actions: Actions, force_reset: torch.Tensor
                    ) -> Tuple[WorldState, Dict]:
    """Everything before the reset and the observation tail."""
    stepk = rng.step_key(state.episode_key, state.cur_step)

    state = movement.movement_system(cfg, state, actions)
    state = movement.aim_systems(cfg, state, actions)
    state = movement.apply_velocity_system(cfg, m, state)
    state = movement.fall_system(cfg, m, state)

    state, fire_events = combat.fire_system(
        cfg, m, state, actions, rng.system_key(stepk, rng.Salt.FIRE)
    )
    state = combat.apply_damage_system(cfg, state)
    if not cfg.has_flag(SimFlags.NoRespawn):
        state = spawn_agents(cfg, m, state,
                             rng.system_key(stepk, rng.Salt.SPAWN),
                             is_respawn=True)
    if use_tail_fused(cfg):
        # the fused scalar tail (ops/tail_fused.py): autoheal -> zone ->
        # match info -> rewards -> done in one pass. Breadcrumbs, filters,
        # goal regions and explore read no zone or match state, so they
        # run first; the filters take the post-increment step stamp.
        state = breadcrumbs.breadcrumb_system(cfg, state)
        state = explore.filters_system(
            cfg, state, fire_events["shot_victim"],
            step_override=state.cur_step + 1,
        )
        state = explore.goal_regions_system(cfg, m, state)
        state = explore.explore_visited_system(cfg, state)
        state, new_captured = tail_fused(cfg, m, state, force_reset)
    else:
        state = combat.autoheal_system(cfg, state)
        state = zones.zone_system(cfg, m, state)
        state = breadcrumbs.breadcrumb_system(cfg, state)
        state, new_captured = zones.zone_match_info_system(
            cfg, m, state, force_reset != 0
        )
        state = explore.filters_system(cfg, state,
                                       fire_events["shot_victim"])
        state = explore.goal_regions_system(cfg, m, state)
        state = explore.explore_visited_system(cfg, state)
        state = rewards.reward_system(cfg, m, state)
        A = cfg.num_agents
        done = state.is_finished.to(torch.int32)[:, None].expand(-1, A)
        state = state.replace(done=done.contiguous())
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
    return state, outputs


def step_batched(cfg: EnvConfig, m: MapData, state: WorldState,
                 actions: Actions, init_key: torch.Tensor, sim_ctrl,
                 force_reset: torch.Tensor) -> Tuple[WorldState, Dict]:
    """All worlds: core -> reset (only if some world resets) ->
    observation tail."""
    state, outputs = step_world_core(cfg, m, state, actions, force_reset)
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
