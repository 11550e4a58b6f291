"""Breadcrumb repulsion markers.

leaveBreadcrumbsSystem + accumulateBreadcrumbPenaltiesSystem (reference
src/sim.cpp:4845-4926) over a fixed per-world pool of C = 6 * A slots
(penalty <= 0 marks a free slot). Each agent owns slots [i*6, i*6 + 6), so
at most one agent writes a slot; it refreshes its last crumb when nearby,
else drops a new one every 10 steps; crumbs decay by 0.025/step and
penalize nearby teammates other than the owner.
"""

from __future__ import annotations

import torch

from .. import consts
from ..config import EnvConfig
from ..ops import geom
from .types import WorldState


def breadcrumb_system(cfg: EnvConfig, state: WorldState):
    W, A = state.hp.shape
    C = cfg.breadcrumb_pool_size
    K = cfg.breadcrumb_pool_per_agent
    dev = state.pos.device
    agent = torch.arange(A, device=dev)
    teams = (agent // cfg.team_size).to(torch.int32)
    radius = consts.agent_radius * consts.breadcrumb_radius_scale
    slots = torch.arange(C, device=dev)
    pos = state.pos

    # lazy clear on the step after a reset
    wr = state.was_reset
    wr1 = wr[:, None]
    crumb_pos = torch.where(wr[:, None, None], 0.0, state.crumb_pos)
    crumb_penalty = torch.where(wr1, 0.0, state.crumb_penalty)
    crumb_team = torch.where(wr1, -1, state.crumb_team)
    crumb_owner = torch.where(wr1, -1, state.crumb_owner)

    # --- leaveBreadcrumbsSystem ---
    last = torch.where(wr1, -1, state.crumb_last)  # [W, A]
    has_last = last >= 0
    lc = torch.clamp(last, min=0).long()
    last_pen = torch.where(has_last, torch.gather(crumb_penalty, 1, lc), 0.0)
    last_own = torch.where(has_last, torch.gather(crumb_owner, 1, lc), 0)
    last_pos = torch.where(
        has_last[..., None],
        torch.gather(crumb_pos, 1, lc[..., None].expand(W, A, 3)), 0.0,
    )
    last_valid = has_last & (last_pen > 0.0) & (last_own == agent)
    near_last = (geom.norm(pos - last_pos) < radius) & last_valid

    refresh = ((last[..., None] == slots) & near_last[..., None]).any(1)
    crumb_penalty = torch.where(refresh, consts.breadcrumb_penalty,
                                crumb_penalty)

    steps_since_prev = torch.where(wr1, 0, state.crumb_steps_since)
    steps_since = torch.where(near_last, 0, steps_since_prev + 1)
    want_new = (~near_last) & (steps_since > consts.breadcrumb_frequency)

    # own slot range; first free slot, else the weakest crumb
    own_pen = crumb_penalty.reshape(W, A, K)
    own_free = own_pen <= 0.0
    has_free = own_free.any(-1)
    first_free = torch.argmax(own_free.to(torch.int32), dim=-1)
    weakest = torch.argmin(own_pen, dim=-1)
    new_slot = (agent * K + torch.where(has_free, first_free, weakest)
                ).to(torch.int32)  # [W, A]

    drop = (new_slot[..., None] == slots) & want_new[..., None]  # [W, A, C]
    dropped = drop.any(1)  # [W, C]
    owner = torch.argmax(drop.to(torch.int32), dim=1)  # [W, C]
    crumb_pos = torch.where(
        dropped[..., None],
        torch.gather(pos, 1, owner[..., None].expand(W, C, 3)), crumb_pos,
    )
    crumb_penalty = torch.where(dropped, consts.breadcrumb_penalty,
                                crumb_penalty)
    crumb_team = torch.where(dropped, teams[owner], crumb_team)
    crumb_owner = torch.where(dropped, owner.to(torch.int32), crumb_owner)
    crumb_last = torch.where(want_new, new_slot, last)
    steps_since = torch.where(want_new, 0, steps_since)

    # --- accumulateBreadcrumbPenaltiesSystem ---
    live = crumb_penalty > 0.0  # [W, C]
    d = geom.norm(pos[:, None, :, :] - crumb_pos[:, :, None, :])  # [W, C, A]
    affects = (
        live[..., None]
        & (crumb_team[..., None] == teams)
        & (crumb_owner[..., None] != agent)
        & (d <= radius)
    )
    total_penalty = torch.where(affects, crumb_penalty[..., None],
                                0.0).sum(1)
    crumb_penalty = torch.where(live, crumb_penalty - consts.breadcrumb_decay,
                                crumb_penalty)

    return state.replace(
        crumb_pos=crumb_pos,
        crumb_penalty=crumb_penalty,
        crumb_team=crumb_team.to(torch.int32),
        crumb_owner=crumb_owner.to(torch.int32),
        crumb_total_penalty=total_penalty,
        crumb_last=crumb_last.to(torch.int32),
        crumb_steps_since=steps_since.to(torch.int32),
    )
