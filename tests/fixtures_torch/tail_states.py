"""States for the fused-tail tests: 4 worlds whose zone and match fields
are set so that one step of the tail rotates a zone, contests it, lets a
team take it, earns and captures a point, finishes matches by points, by
length and by a forced reset, and starts a match (cur_step 0). Per-agent
combat flags and reward coefficients are drawn with numpy from a seed.
Pure numpy on the port's state leaves (world_state_to_numpy layout).
"""

from __future__ import annotations

import numpy as np

NUM_WORLDS = 4


def _zone_after_rotation(zone_cur, ctrl, remaining, num_zones):
    rot = remaining - (ctrl != -1) == 0
    nxt = np.where(zone_cur + 1 == num_zones, 0, zone_cur + 1)
    return np.where(rot, nxt, zone_cur)


def tail_scenario(leaves: dict, team_size: int, zone_frames: np.ndarray,
                  num_zones: int, world_min, world_max, episode_len: int,
                  seed: int = 0):
    """Fill ``leaves`` (4 worlds, [W, ...] numpy state leaves) in place;
    returns force_reset [W] int32."""
    g = np.random.default_rng(seed)
    W, A = leaves["hp"].shape
    assert W == NUM_WORLDS and A == 2 * team_size
    f32 = np.float32

    # per-agent combat state
    leaves["hp"] = np.where(g.random((W, A)) < 0.3, 100.0,
                            g.uniform(0, 100, (W, A))).astype(f32)
    leaves["alive"] = (g.random((W, A)) < 0.8).astype(f32)
    leaves["autoheal_steps"] = g.integers(0, 3, (W, A)).astype(np.int32)
    leaves["min_dist_to_zone"] = g.uniform(0, 3000, (W, A)).astype(f32)
    leaves["crumb_total_penalty"] = g.uniform(0, 0.3, (W, A)).astype(f32)
    leaves["fired_shot_t"] = np.where(g.random((W, A)) < 0.5, -np.inf,
                                      g.uniform(0, 1, (W, A))).astype(f32)
    for k in ("successful_kill", "was_killed", "reloaded_full_mag",
              "has_died"):
        leaves[k] = g.random((W, A)) < 0.3
    leaves["landed_shot_on"] = g.integers(-1, A, (W, A)).astype(np.int32)
    leaves["was_shot_count"] = g.integers(0, 3, (W, A)).astype(np.int32)
    leaves["new_cells"] = g.integers(0, 3, (W, A)).astype(np.int32)
    leaves["reward_coefs"] = g.uniform(0, 1, (W, A, 9)).astype(f32)

    # per-world zone and match state: w0 rotates and is contested, w1 has
    # team 0 holding the zone and earning its winning point (a capture),
    # w2 has team 1 taking the zone on the last step of the episode, w3
    # is empty, rotates with wrap-around and is force-reset on step 0
    lz = num_zones - 1
    i32 = np.int32
    leaves["zone_cur"] = np.array([0, lz, 0, lz], i32)
    leaves["zone_controlling"] = np.array([1, 0, -1, 1], i32)
    leaves["zone_steps_remaining"] = np.array([1, 300, 50, 1], i32)
    leaves["zone_steps_until_point"] = np.array([7, 1, 5, 20], i32)
    leaves["zone_captured"] = np.array([True, False, True, False])
    leaves["zone_contested"] = np.zeros(W, bool)
    leaves["cur_step"] = np.array([5, 20, episode_len - 1, 0], i32)
    leaves["win_result"] = np.full(W, -1, i32)
    leaves["team_kills"] = g.integers(0, 9, (W, 2)).astype(i32)
    leaves["team_points"] = np.array([[3, 4], [124, 3], [10, 11], [0, 0]],
                                     i32)
    leaves["zone_stats"] = g.integers(
        0, 50, leaves["zone_stats"].shape).astype(i32)
    force_reset = np.array([0, 0, 0, 1], i32)

    # positions: anywhere in the map, then the agents meant to stand in
    # the (post-rotation) zone at its centre
    lo, hi = np.asarray(world_min, f32), np.asarray(world_max, f32)
    pos = g.uniform(lo, hi, (W, A, 3)).astype(f32)
    zc = _zone_after_rotation(leaves["zone_cur"], leaves["zone_controlling"],
                              leaves["zone_steps_remaining"], num_zones)
    inside = {0: (0, 1), 1: (0,), 2: (1,), 3: ()}
    lift = 65.0 / 2.0
    for w, teams in inside.items():
        for t in teams:
            # all but one of the team (its only agent at team size 1)
            for i in range(t * team_size,
                           t * team_size + max(1, team_size - 1)):
                c = zone_frames[zc[w], 0:3]
                pos[w, i] = (c[0] + g.uniform(-3, 3), c[1] + g.uniform(-3, 3),
                             c[2] - lift)
    leaves["pos"] = pos
    return force_reset
