"""Explore-novelty grid, goal regions and the analytics filters.

exploreVisitedSystem (reference src/sim.cpp:3508-3536): 81x81 visit grid
per agent, cells of 2 * agentRadius relative to the episode start, bit-
packed as [W, A, 81, 3] words. evaluateGoalRegionsSystem
(sim.cpp:4023-4088): shaped team rewards for approaching goal ZOBBs.
updateFiltersState (sim.cpp:128-291): hardcoded analytics filters.
"""

from __future__ import annotations

import torch

from .. import consts
from ..config import EnvConfig
from ..assets.map_data import MapData
from ..ops import geom
from .types import EXPLORE_WORDS, WorldState


def explore_visited_system(cfg: EnvConfig, state: WorldState):
    W, A = state.hp.shape
    delta = state.pos - state.start_pos
    # a tensor divisor: ATen's CUDA division by a Python scalar multiplies
    # by its reciprocal, which could move a cell boundary between devices
    cell_size = torch.full((), consts.agent_radius * 2.0, device=delta.device)
    x = ((delta[..., 0] + 0.5) / cell_size).to(torch.int32)
    y = ((delta[..., 1] + 0.5) / cell_size).to(torch.int32)
    cx = x + consts.explore_grid_max_x
    cy = y + consts.explore_grid_max_y
    in_grid = (
        (cx >= 0) & (cx < consts.explore_grid_width)
        & (cy >= 0) & (cy < consts.explore_grid_height)
    )
    cx = torch.clamp(cx, 0, consts.explore_grid_width - 1)
    cy = torch.clamp(cy, 0, consts.explore_grid_height - 1)
    word = cx >> 5
    bit = (cx & 31).to(torch.int64)

    H = consts.explore_grid_height
    flat = torch.where(state.was_reset[:, None, None, None], 0,
                       state.explore_bits).reshape(W, A, H * EXPLORE_WORDS)
    sel = (cy * EXPLORE_WORDS + word).long()  # [W, A]
    cur_bits = torch.gather(flat, 2, sel[..., None])[..., 0]
    already = ((cur_bits >> bit) & 1) == 1
    setbit = torch.where(in_grid, cur_bits | (1 << bit), cur_bits)
    explore_bits = flat.scatter(2, sel[..., None], setbit[..., None])

    far_enough = geom.dot(delta, delta) > 2.0
    newly = in_grid & (~already) & far_enough
    return state.replace(
        explore_bits=explore_bits.reshape(W, A, H, EXPLORE_WORDS),
        new_cells=state.new_cells + newly.to(torch.int32),
    )


def _dist_to_zobb(p, zmin, zmax, rot):
    """distToZOBB (sim.cpp:3998-4021); all args broadcast."""
    pf = geom.rotate_z(p, -rot)
    mnf = geom.rotate_z(zmin, -rot)
    mxf = geom.rotate_z(zmax, -rot)
    below = torch.clamp(mnf - pf, min=0.0)
    above = torch.clamp(pf - mxf, min=0.0)
    s = below * below + above * above
    return geom.sqrt(s[..., 0] + s[..., 1] + s[..., 2])


def goal_regions_system(cfg: EnvConfig, m: MapData, state: WorldState):
    W, A = state.hp.shape
    dev = state.pos.device
    if m.num_goal_regions == 0:
        return state.replace(goal_team_rewards=torch.zeros(W, 2, device=dev))
    teams = (torch.arange(A, device=dev) // cfg.team_size).to(torch.int32)
    attacker = state.team_a  # [W]

    G, S = m.goal_sub_min.shape[0], m.goal_sub_min.shape[1]
    d = _dist_to_zobb(
        state.pos[:, None, None, :, :],
        m.goal_sub_min[None, :, :, None, :],
        m.goal_sub_max[None, :, :, None, :],
        m.goal_sub_rot[None, :, :, None],
    )  # [W, G, S, A]
    region_team = torch.where(m.goal_attacker_team, attacker[:, None],
                              attacker[:, None] ^ 1)  # [W, G]
    on_team = teams == region_team[..., None]  # [W, G, A]
    d_masked = torch.where(on_team[:, :, None, :], d, float("inf"))
    min_per_sub = d_masked.amin(-1)  # [W, G, S]
    sub_valid = torch.arange(S, device=dev) < m.goal_num_sub[:, None]
    max_min = torch.where(sub_valid, min_per_sub, -float("inf")).amax(-1)

    prev = state.goal_min_dist
    first_time = torch.isinf(prev)
    diff = prev - max_min
    improved = (~first_time) & (diff > 0.0)
    new_min = torch.where(first_time | improved, max_min, prev)
    reward_per_region = torch.where(improved, diff * m.goal_reward_strength,
                                    0.0)
    team_rewards = torch.zeros(W, 2, device=dev).scatter_add_(
        1, torch.clamp(region_team, 0, 1).long(), reward_per_region
    )
    return state.replace(goal_min_dist=new_min,
                         goal_team_rewards=team_rewards)


_FILTER_REGIONS = (
    (-1272.0, -866.0, -825.0, 696.0),
    (852.0, -851.0, 1280.0, 593.0),
)
_FILTER_MIN_COUNTS = (5, 1)


def filters_system(cfg: EnvConfig, state: WorldState, shot_victims,
                   step_override=None):
    """Filter 0: >= 5 players of a team in region A; filter 1: >= 1 in
    region B; filter 2: any player-shot event by the team. A team matches
    when all three are active on the same step. ``step_override`` [W]
    lets the fused-tail step run this system before the match-info step
    increment while keeping the reference's post-increment step stamp."""
    W, A = state.hp.shape
    dev = state.pos.device
    teams = (torch.arange(A, device=dev) // cfg.team_size).to(torch.int32)
    step = (state.cur_step if step_override is None
            else step_override)[:, None]  # [W, 1]
    x, y = state.pos[..., 0], state.pos[..., 1]
    matched_cols = []
    for t in range(2):
        mine = teams == t
        row = []
        for (x0, y0, x1, y1), need in zip(_FILTER_REGIONS,
                                          _FILTER_MIN_COUNTS):
            inside = (x >= x0) & (y >= y0) & (x <= x1) & (y <= y1)
            row.append((inside & mine).sum(-1) >= need)
        row.append(((shot_victims >= 0) & mine).any(-1))
        matched_cols.append(torch.stack(row, dim=-1))
    matched = torch.stack(matched_cols, dim=1)  # [W, 2 teams, 3 filters]
    last = torch.where(matched, step[..., None], state.filters_last_match)
    all_active = (last == step[..., None]).all(-1)  # [W, 2]
    last_all = torch.where(all_active, step, state.filters_last_all_matched)
    return state.replace(filters_last_match=last.to(torch.int32),
                         filters_last_all_matched=last_all.to(torch.int32))
