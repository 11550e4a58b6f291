"""K5's lane schedule (csrc/tail_fused.cu tail_fused_kernel<L>), modelled
in torch on the CPU: a group of L lanes per world (16 when A <= 16, else
the warp), lane i owning agent i; lanes past the last agent, and groups
past the last world, work on the last one and store nothing; the counts
of agents in the zone and of team kills are ballots of the warp, masked
to the group and popcounted by team; the spread polygon and the team sums
gather teammates' values from the group's lanes (__shfl_sync) and add them
in index order. Every output of the model must equal ``tail_fused_plain``
bit for bit (int32 views of the float leaves):

- on the committed fixtures' states of both maps (Zone 2v2, 2 worlds:
  the tail's input of zone_simple_map_systems.npz and the town slice's
  states 0, 8 and 15), and
- on the fused-tail scenarios of fixtures_torch/tail_states.py (rotation,
  contest, take, capture, finishes, a forced reset, a first step) at
  team sizes 1, 2, 3, 6 and 16 (A = 32: the whole warp), with
  force_reset as int32 and as bool.
"""

import os
import sys

import numpy as np
import pytest
import torch

import madrona_mp_env_tpu_torch as mt
from madrona_mp_env_tpu_torch import config as cfgmod
from madrona_mp_env_tpu_torch import consts
from madrona_mp_env_tpu_torch.assets.map_data import (ZF_CENTER, ZF_COS,
                                                      ZF_MAX, ZF_MIN, ZF_SIN,
                                                      load_map)
from madrona_mp_env_tpu_torch.ops import geom
from madrona_mp_env_tpu_torch.ops import tail_fused as tf
from madrona_mp_env_tpu_torch.sim.types import (init_world_state,
                                                world_state_from_numpy,
                                                world_state_to_numpy)

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(os.path.dirname(HERE), "data")
FIX = os.path.join(HERE, "fixtures_torch")
sys.path.insert(0, FIX)
from tail_states import NUM_WORLDS, tail_scenario  # noqa: E402
from torch_threads import one_thread_under_xdist  # noqa: E402,F401

F32 = torch.float32
THREADS = 64  # csrc/tail_fused.cu kTailThreads


def _f(x):
    return torch.tensor(x, dtype=F32)


def _lanes_model(cfg, m, s, force_reset):
    """tail_fused_kernel<L> lane by lane: -> {output leaf: tensor} and
    new_captured, as the kernel stores them."""
    W, A = s.hp.shape
    ts = cfg.team_size
    L = 16 if A <= 16 else 32
    n = -(-W * L // THREADS) * THREADS
    lane = torch.arange(n)
    gw, i = lane // L, lane % L
    base = lane % 32 - i
    warp = lane // 32
    mine = (gw < W) & (i < A)
    w = torch.clamp(gw, max=W - 1)
    ag = torch.clamp(i, max=A - 1)
    team = ag // ts
    group_bits = (((1 << L) - 1) << base) & 0xFFFFFFFF
    team0 = (1 << ts) - 1
    team1 = team0 << ts

    def ballot(pred):
        """the warp's ballot, masked to the group and shifted to agent
        bits, for every lane"""
        bits = torch.zeros(n // 32, dtype=torch.int64)
        bits.index_add_(0, warp, pred.to(torch.int64) << (lane % 32))
        return (bits[warp] & group_bits) >> base

    def popc(x):
        return torch.tensor([bin(int(v)).count("1") for v in x])

    def shfl(x, j):
        return x[warp * 32 + base + j]

    def agent(x):
        return x[w, ag]

    def world(x):
        return x[w]

    # ---- autoHealSystem ----
    alive_f = agent(s.alive)
    alive = alive_f > 0.0
    ah = agent(s.autoheal_steps)
    hp = agent(s.hp)
    hp = torch.where(alive & (ah == 0) & (hp < 100.0),
                     torch.clamp(hp + _f(consts.autoheal_amount_per_step),
                                 max=100.0), hp)

    # ---- zoneSystem ----
    ctrl = world(s.zone_controlling)
    zrem = world(s.zone_steps_remaining) - (ctrl != -1).to(torch.int32)
    rotate = zrem == 0
    zcur = world(s.zone_cur)
    zcur = torch.where(rotate, torch.where(zcur + 1 == m.num_zones, 0,
                                           zcur + 1), zcur)
    captured = world(s.zone_captured) & ~rotate
    zrem = torch.where(rotate, consts.num_steps_per_zone, zrem)
    zsup = torch.where(rotate, consts.zone_point_interval,
                       world(s.zone_steps_until_point))
    f = m.zone_frames[zcur.long()]
    p = s.pos[w, ag]
    px, py, pz = p[:, 0], p[:, 1], p[:, 2]
    dist = geom.norm(p - f[:, ZF_CENTER:ZF_CENTER + 3])
    mind = torch.where(rotate, dist, agent(s.min_dist_to_zone))
    c, sn = f[:, ZF_COS], f[:, ZF_SIN]
    x = c * px - sn * py
    y = sn * px + c * py
    z = pz + _f(consts.stand_height / 2.0)
    inz = ((x >= f[:, ZF_MIN]) & (x <= f[:, ZF_MAX])
           & (y >= f[:, ZF_MIN + 1]) & (y <= f[:, ZF_MAX + 1])
           & (z >= f[:, ZF_MIN + 2]) & (z <= f[:, ZF_MAX + 2]))
    in_bits = ballot(mine & inz)
    num_a, num_b = popc(in_bits & team0), popc(in_bits & team1)
    zsup = zsup - 1
    contested = (num_a > 0) & (num_b > 0)
    nobody = (num_a == 0) & (num_b == 0)
    a_takes = (num_a > 0) & (num_b == 0) & (ctrl != 0)
    b_takes = (num_b > 0) & (num_a == 0) & (ctrl != 1)
    ctrl = torch.where(contested | nobody, -1, torch.where(
        a_takes, 0, torch.where(b_takes, 1, ctrl)))
    changed = contested | nobody | a_takes | b_takes
    captured = captured & ~changed
    zsup = torch.where(changed, consts.zone_point_interval, zsup)

    # ---- zoneMatchInfoSystem ----
    cur_step = world(s.cur_step) + 1
    finished = (cur_step >= cfg.episode_len) | (world(force_reset) != 0)
    first = cur_step == 1
    tk0 = torch.where(first, 0, s.team_kills[w, 0])
    tk1 = torch.where(first, 0, s.team_kills[w, 1])
    tp0 = torch.where(first, 0, s.team_points[w, 0])
    tp1 = torch.where(first, 0, s.team_points[w, 1])
    win = torch.where(first, -1, world(s.win_result))
    wk = agent(s.was_killed)
    wk_bits = ballot(mine & wk)
    tk0 = tk0 + popc(wk_bits & team1)
    tk1 = tk1 + popc(wk_bits & team0)
    earned = zsup == 0
    zsup = torch.where(earned, consts.zone_point_interval, zsup)
    new_captured = earned & ~captured
    captured = captured | earned
    ctrl_cl = torch.clamp(ctrl, 0, 1)
    tp0 = tp0 + (earned & (ctrl_cl == 0)).to(torch.int32)
    tp1 = tp1 + (earned & (ctrl_cl == 1)).to(torch.int32)
    finished = (finished | (tp0 >= consts.zone_win_points)
                | (tp1 >= consts.zone_win_points))
    result = torch.where(tp0 > tp1, 0, torch.where(tp1 > tp0, 1, 2))
    win = torch.where(finished, result, win)

    # ---- zoneRewardSystem ----
    area2 = _f(2.0) * ((m.world_max[0] - m.world_min[0])
                       * (m.world_max[1] - m.world_min[1]))
    rc = s.reward_coefs[w, ag]
    dead = alive_f == 0.0
    v = -rc[:, cfgmod.RC_BREADCRUMB_SCALE] * agent(s.crumb_total_penalty)
    v = v - torch.where(agent(s.reloaded_full_mag), 0.5, 0.0)
    v = v + torch.where(agent(s.successful_kill), 1.0, 0.0)
    v = v + torch.where(agent(s.landed_shot_on) >= 0,
                        rc[:, cfgmod.RC_SHOT_SCALE], 0.0)
    v = v - torch.where(wk, 1.5, 0.0)
    v = v - torch.where(agent(s.was_shot_count) > 0,
                        rc[:, cfgmod.RC_SHOT_SCALE], 0.0)
    v = v + agent(s.new_cells).to(F32) * rc[:, cfgmod.RC_EXPLORE_SCALE]
    closer = ~inz & (dist < mind)
    scale = rc[:, cfgmod.RC_ZONE_DIST_SCALE] * torch.where(
        agent(s.has_died), 1.0, 10.0)
    approach = torch.where(closer, scale * (mind - dist), 0.0)
    mind = torch.where(closer, dist, mind)
    v = v + torch.where(inz, rc[:, cfgmod.RC_IN_ZONE_SCALE], 0.0)
    v = v + approach
    own = ctrl == team
    other = (ctrl != -1) & ~own
    ctrl_s = rc[:, cfgmod.RC_ZONE_TEAM_CTRL_SCALE]
    point_s = rc[:, cfgmod.RC_ZONE_EARNED_POINT_SCALE]
    rz = torch.where(own, ctrl_s, 0.0)
    rz = rz + torch.where(own & earned, point_s, 0.0)
    rz = rz - torch.where(other, ctrl_s, 0.0)
    rz = rz - torch.where(other & earned, point_s, 0.0)
    v = v + rz
    # the spread polygon: teammates' x, y by shuffle, in index order
    poly = torch.zeros(n)
    ex0, ey0 = torch.zeros(n), torch.zeros(n)
    have = torch.zeros(n, dtype=torch.bool)
    for q in range(ts):
        j = team * ts + q
        ex, ey = shfl(px, j) - px, shfl(py, j) - py
        take = j != ag
        poly = torch.where(take & have,
                           poly + torch.abs(ex0 * ey - ey0 * ex), poly)
        ex0, ey0 = torch.where(take, ex, ex0), torch.where(take, ey, ey0)
        have = have | take
    v = v + torch.where(dead, 0.0, poly / area2 * _f(0.01))
    # team sums in index order, then the mean and the spirit blend
    s0, s1 = torch.zeros(n), torch.zeros(n)
    for j in range(ts):
        s0 = s0 + shfl(v, j)
    for j in range(ts, A):
        s1 = s1 + shfl(v, j)
    mean0, mean1 = s0 / _f(float(ts)), s1 / _f(float(ts))
    sp = rc[:, cfgmod.RC_TEAM_SPIRIT]
    reward = v * (_f(1.0) - sp) + torch.where(team == 0, mean0, mean1) * sp

    out = {}
    keep = lambda x: x[mine].reshape(W, A)  # noqa: E731
    out.update(
        hp=keep(hp),
        autoheal_steps=keep(torch.where(alive & (ah > 0), ah - 1, ah)),
        successful_kill=keep(agent(s.successful_kill) & ~dead),
        landed_shot_on=keep(torch.where(dead, -1, agent(s.landed_shot_on))),
        was_killed=keep(wk & ~dead),
        was_shot_count=keep(torch.where(dead, 0, agent(s.was_shot_count))),
        fired_shot_t=keep(torch.where(dead, -float("inf"),
                                      agent(s.fired_shot_t))),
        in_zone=keep(inz), min_dist_to_zone=keep(mind),
        done=keep(finished.to(torch.int32)),
        new_cells=keep(torch.zeros(n, dtype=torch.int32)),
        reward=keep(reward))
    first_lane = (i == 0) & (gw < W)
    for name, val in dict(
            cur_step=cur_step, is_finished=finished, win_result=win,
            zone_cur=zcur, zone_controlling=ctrl, zone_contested=contested,
            zone_captured=captured, zone_earned_point=earned,
            zone_steps_remaining=zrem, zone_steps_until_point=zsup).items():
        out[name] = val[first_lane]
    out["team_kills"] = torch.stack([tk0, tk1], -1)[first_lane]
    out["team_points"] = torch.stack([tp0, tp1], -1)[first_lane]
    out["team_rewards"] = torch.stack([mean0, mean1], -1)[first_lane]
    # the zone stats, element e = i, i + L, ... of the world's row
    zs = torch.empty_like(s.zone_stats).reshape(W, -1)
    cols = [new_captured, captured & (ctrl_cl == 0),
            captured & (ctrl_cl == 1), contested, torch.ones_like(contested)]
    for e0 in range(0, zs.shape[1], L):
        e = e0 + i
        ok = (gw < W) & (e < zs.shape[1])
        col = torch.stack(cols, -1).to(torch.int32)[lane, (e % 5).clamp(max=4)]
        inc = torch.where(e // 5 == zcur, col, 0)
        zs[w[ok], e[ok]] = s.zone_stats.reshape(W, -1)[w[ok], e[ok]] + inc[ok]
    out["zone_stats"] = zs.reshape(s.zone_stats.shape)
    return out, new_captured[first_lane]


def _bits(x):
    return x.view(torch.int32) if x.dtype == F32 else x


def _assert_bit_equal(cfg, m, state, fr):
    out, cap = _lanes_model(cfg, m, state, fr)
    want, want_cap = tf.tail_fused_plain(cfg, m, state, fr)
    assert torch.equal(cap, want_cap)
    assert set(out) == set(tf._OUT_NAMES[:-1])
    for name, got in out.items():
        w = getattr(want, name)
        assert got.shape == w.shape, name
        if got.dtype == torch.int64:  # the model's Python-int selects
            got = got.to(w.dtype)
        assert got.dtype == w.dtype, name
        assert torch.equal(_bits(got), _bits(w)), name


def _cfg(ts):
    return mt.EnvConfig(
        task=mt.Task.Zone, team_size=ts,
        sim_flags=mt.SimFlags.StaggerStarts | mt.SimFlags.RandomFlipTeams)


@pytest.fixture(scope="module")
def maps():
    return {name: load_map(os.path.join(DATA, name), _cfg(2), device="cpu")
            for name in ("simple_map", "town_map")}


def _fixture_states(scene):
    """(tag, leaves) of the committed fixtures' Zone 2v2 states."""
    if scene == "simple_map":
        data = np.load(os.path.join(FIX, "zone_simple_map_systems.npz"))
        i = [str(n) for n in data["names"]].index("autoheal")
        return [(f"systems/{i}", {k.split("/", 1)[1]: v for k, v in
                                  data.items() if k.startswith(f"{i}/")})]
    data = np.load(os.path.join(FIX, "zone_town_map_slice.npz"))
    return [(tag, {k.split("/", 1)[1]: v for k, v in data.items()
                   if k.startswith(f"{tag}/")})
            for tag in ("state0", "state8", "state15")]


@pytest.mark.parametrize("scene", ["simple_map", "town_map"])
def test_lanes_model_on_fixture_states(maps, scene):
    cfg, m = _cfg(2), maps[scene]
    for tag, leaves in _fixture_states(scene):
        state = world_state_from_numpy(leaves)
        W = state.hp.shape[0]
        _assert_bit_equal(cfg, m, state, torch.zeros(W, dtype=torch.int32))


@pytest.mark.parametrize("ts", [1, 2, 3, 6, 16])
def test_lanes_model_on_scenarios(maps, ts):
    cfg, m = _cfg(ts), maps["simple_map"]
    leaves = world_state_to_numpy(init_world_state(cfg, m.num_goal_regions,
                                                   NUM_WORLDS))
    fr = tail_scenario(leaves, ts, m.zone_frames.numpy(), m.num_zones,
                       m.world_min.numpy(), m.world_max.numpy(),
                       cfg.episode_len, seed=1)
    state = world_state_from_numpy(leaves)
    for force_reset in (torch.as_tensor(fr), torch.as_tensor(fr != 0)):
        _assert_bit_equal(cfg, m, state, force_reset)
    # the scenario's worlds contest, take and capture at every team size
    got, cap = tf.tail_fused_plain(cfg, m, state, torch.as_tensor(fr))
    assert bool(got.zone_contested[0]) and cap.tolist()[1]
    assert got.zone_controlling.tolist()[1:3] == [0, 1]
