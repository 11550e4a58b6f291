"""Write the game-mode fixture of the PyTorch port's tests.

Runs the JAX package on the CPU, on data/simple_map at 2 worlds, seed 5,
team size 2, StaggerStarts | RandomFlipTeams plus each configuration's
own settings (CONFIGS): TDM, ZoneCaptureDefend + HardcodedSpawns, Turret,
Explore + NavmeshSpawn (1 agent), Zone + RewardMode.Flank, Zone +
SubZones (policy ids 0-7 across the agents), TDM + highlevel_move and
Zone + RandomizeHPMagazine. For each, the reset and NUM_STEPS steps of
numpy-drawn actions (make_slice_fixture.draw_actions) are run eagerly
(jax_rollout says why) and recorded as make_slice_fixture records them,
under ``<config>/``.

Then the planted cases (PLANTS), where a rollout this short reaches no
end: from a configuration's state after its last step (stored under
``base/<config>/``), the leaves under ``plant/<case>/`` are replaced and
one system (or a match-info system and the rewards) runs, jitted and
vmapped over the worlds; its outputs go under ``out/<case>/``. The turret
and hl_battle cases place agents on navmesh centroid pairs found here,
one whose eye-to-eye ray reaches the other and one that a wall blocks
(``meta/<case>/visible`` holds each case's eye-to-eye visibility). The
SpawnInMiddle case resets 8 worlds with the mid-map spawn boxes cut to
the usage tables' 128 (both bundled maps have more, and the JAX
package's spawn fails on the whole table).

tests/test_torch_modes.py replays all of it through the port on the CPU.

Regenerate (only after a deliberate change of the JAX reference; ~25
minutes, most of it the eager rollouts):

    JAX_PLATFORMS=cpu python tests/fixtures_torch/make_modes_fixture.py
"""

from __future__ import annotations

import os
import sys

import numpy as np

import make_slice_fixture as fx

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
PATH = os.path.join(HERE, "zone_modes.npz")

NUM_WORLDS = 2
TEAM_SIZE = 2
NUM_STEPS = 12
SEED = 5
BASE_FLAGS = ("StaggerStarts", "RandomFlipTeams")

# name: EnvConfig settings (names shared by both packages' config modules)
CONFIGS = {
    "tdm": dict(task="TDM"),
    "zcd": dict(task="ZoneCaptureDefend", flags=("HardcodedSpawns",)),
    "turret": dict(task="Turret"),
    "explore": dict(task="Explore", flags=("NavmeshSpawn",)),
    "flank": dict(task="Zone", reward_mode="Flank"),
    "subzones": dict(task="Zone", flags=("SubZones",)),
    "tdm_hl": dict(task="TDM", highlevel_move=True),
    "hp_mag": dict(task="Zone", flags=("RandomizeHPMagazine",)),
}
# case: (configuration, system); the planted leaves are in the fixture
PLANTS = {
    "zcd_points": ("zcd", "match_reward"),
    "zcd_attackers_died": ("zcd", "match_reward"),
    "tdm_side_dead": ("tdm", "match_reward"),
    "turret_side_dead": ("turret", "match_reward"),
    "turret_targets": ("turret", "turret_ai"),
    "hl_targets": ("tdm_hl", "hl_battle"),
    "subzone_machine": ("subzones", "subzone"),
}
MATCH_KEYS = ("cur_step", "is_finished", "win_result", "team_kills",
              "team_points", "reward", "team_rewards", "min_dist_to_zone")
TURRET_KEYS = ("move_amount", "fire", "aim_yaw_rate", "aim_pitch_rate",
               "aim_yaw", "aim_pitch")
HL_KEYS = ("landed_shot_on", "successful_kill", "fired_shot_t",
           "damage_dealt")
SUBZONE_KEYS = ("in_subzone", "min_dist_subzone", "subzone_ctrl",
                "subzone_contested")
# the SpawnInMiddle reset: worlds, boxes a side kept, leaves compared
MIDDLE_WORLDS = 8
MIDDLE_BOXES = 128
MIDDLE_FLAGS = BASE_FLAGS + ("SpawnInMiddle", "RandomizeHPMagazine")
MIDDLE_KEYS = ("pos", "yaw", "hp", "mag_bullets", "alive", "weapon_type",
               "spawn_a_used", "spawn_b_used", "in_zone",
               "min_dist_to_zone", "zone_cur", "team_a")


def make_cfg(mod, name, flags=None):
    """Configuration ``name`` of CONFIGS in package ``mod`` (either
    package: the names are shared)."""
    spec = CONFIGS[name]
    if flags is None:
        flags = BASE_FLAGS + spec.get("flags", ())
    fl = mod.SimFlags.Default
    for f in flags:
        fl |= getattr(mod.SimFlags, f)
    return mod.EnvConfig(
        task=getattr(mod.Task, spec["task"]), sim_flags=fl,
        reward_mode=getattr(mod.RewardMode,
                            spec.get("reward_mode", "Default")),
        highlevel_move=spec.get("highlevel_move", False),
        team_size=TEAM_SIZE,
    )


def policy_ids(name, num_agents):
    """[W, A] policy ids of the rollout: SubZones assigns each agent the
    sub-zone of its id, so the agents spread over all 8; else None."""
    if name != "subzones":
        return None
    return (np.arange(NUM_WORLDS * num_agents, dtype=np.int32)
            .reshape(NUM_WORLDS, num_agents) % 8)


def jax_rollout(mp, name, steps=NUM_STEPS):
    """(rollout record, env, state after the last step), run eagerly
    (jax.disable_jit): under jit, XLA's CPU backend fuses multiply-adds,
    which moves a position by an ulp (2.4e-3 in velocity at x > 1024,
    where ZoneCaptureDefend's hardcoded spawns put side B) and in Explore
    decides a spawn-contact collision the other way (step 8: the agent
    steps up 35 units under jit and stays put eagerly, as in the port)."""
    import jax
    import jax.numpy as jnp
    from madrona_mp_env_tpu.sim.types import Actions

    cfg = make_cfg(mp, name)
    env = mp.Env(cfg, os.path.join(REPO, "data", "simple_map"),
                 num_worlds=NUM_WORLDS, seed=SEED)
    acts = fx.draw_actions(steps, NUM_WORLDS, cfg.num_agents)
    rec = {}
    with jax.disable_jit():
        state, obs = env.reset()
        pid = policy_ids(name, cfg.num_agents)
        if pid is not None:
            state = state.replace(policy_idx=jnp.asarray(pid))
        fx.record(rec, state, obs)
        zf = jnp.zeros((NUM_WORLDS, cfg.num_agents), jnp.float32)
        for s in range(steps):
            a = Actions(**{k: jnp.asarray(v[s]) for k, v in acts.items()},
                        aim_yaw_rate=zf, aim_pitch_rate=zf)
            state, out = env.step(state, a)
            fx.record(rec, state, out["obs"], out["reward"], out["done"])
    hist = {k: np.stack(v) for k, v in rec.items()}
    hist.update(acts)
    return hist, env, state


def leaves(state):
    return {k: np.asarray(getattr(state, k))
            for k in state.__dataclass_fields__}


def los_pairs(m):
    """Two pairs of navmesh centroids (p, q) 100-600 apart, for standing
    agents: the first with a clear eye-to-eye line, the second blocked by
    the map."""
    import jax.numpy as jnp
    from madrona_mp_env_tpu import consts
    from madrona_mp_env_tpu.ops.raycast import ray_vs_tris

    c = np.asarray(m.nav_centroids)
    g = np.random.default_rng(7)
    i = g.integers(0, len(c), 4096)
    j = g.integers(0, len(c), 4096)
    eye = consts.stand_height - consts.agent_radius
    o = c[i] + [0.0, 0.0, eye]
    d = c[j] + [0.0, 0.0, eye] - o
    dist = np.linalg.norm(d, axis=-1)
    ok = (dist > 100.0) & (dist < 600.0)
    i, j, o, d, dist = i[ok], j[ok], o[ok], d[ok], dist[ok]
    t = np.asarray(ray_vs_tris(jnp.asarray(o, jnp.float32),
                               jnp.asarray(d / dist[:, None], jnp.float32),
                               m.tris))
    vis = np.nonzero(t >= dist - 1e-3)[0]
    occ = np.nonzero(t < 0.5 * dist)[0]
    return [(c[i[k]], c[j[k]]) for k in (vis[0], occ[0])]


def facing(p, q):
    """Yaw that faces from p to q (fwd = (-sin yaw, cos yaw))."""
    d = q - p
    return np.float32(-np.arctan2(d[0], d[1]))


def _standing(base, A):
    """Every agent alive, standing, full hp and magazine, pitch 0."""
    W = NUM_WORLDS
    return {
        "alive": np.ones((W, A), np.float32),
        "hp": np.full((W, A), 100.0, np.float32),
        "stand_cur": np.zeros((W, A), np.int32),
        "pitch": np.zeros((W, A), np.float32),
        "respawn_steps": np.zeros((W, A), np.int32),
        "mag_bullets": np.full((W, A), 30, np.int32),
        "mag_reloading": np.zeros((W, A), np.int32),
        "vel": np.zeros((W, A, 3), np.float32),
    }


def plant(case, base, m):
    """The planted leaves of ``case`` on the configuration's base state
    (leaves as numpy)."""
    W, A = base["hp"].shape
    ts = TEAM_SIZE
    p = {}
    if case == "zcd_points":
        # world 0: the attackers hold 1 point, world 1: the defenders 8
        att = (base["team_a"] == 1).astype(np.int64)
        tp = np.zeros((W, 2), np.int32)
        tp[0, att[0]] = 1
        tp[1, 1 - att[1]] = 8
        p["team_points"] = tp
        p["cur_step"] = np.full((W,), 40, np.int32)
    elif case == "zcd_attackers_died":
        # world 0: every attacker has died once (alive again)
        att = (base["team_a"] == 1).astype(np.int64)
        hd = np.zeros((W, A), bool)
        hd[0, att[0] * ts:(att[0] + 1) * ts] = True
        p["has_died"] = hd
        p["team_points"] = np.zeros((W, 2), np.int32)
        p["cur_step"] = np.full((W,), 40, np.int32)
    elif case in ("tdm_side_dead", "turret_side_dead"):
        # world 0: team 1 (the turrets) dead; world 1: team 0 dead, one of
        # them killed this step
        alive = np.ones((W, A), np.float32)
        alive[0, ts:] = 0.0
        alive[1, :ts] = 0.0
        wk = np.zeros((W, A), bool)
        wk[1, 0] = True
        p["alive"] = alive
        p["was_killed"] = wk
        p["cur_step"] = np.full((W,), 40, np.int32)
    elif case in ("turret_targets", "hl_targets"):
        (p1, q1), (p2, q2) = los_pairs(m)
        p.update(_standing(base, A))
        pos = np.zeros((W, A, 3), np.float32)
        yaw = np.zeros((W, A), np.float32)
        # agent 0 / agent 2 on the clear pair, 1 / 3 on the blocked one,
        # each facing its partner
        for w in range(W):
            pos[w, 0], pos[w, 2] = q1, p1
            pos[w, 1], pos[w, 3] = q2, p2
            yaw[w, 0], yaw[w, 2] = facing(q1, p1), facing(p1, q1)
            yaw[w, 1], yaw[w, 3] = facing(q2, p2), facing(p2, q2)
        if case == "turret_targets":
            # world 1: turret 2 turned away (slews, does not fire) and
            # turret 3's magazine empty (reloads)
            yaw[1, 2] = np.float32(yaw[1, 2] + 1.0)
            p["mag_bullets"][1, 3] = 0
        else:
            # world 1: agent 2 invincible, agent 0 turned around
            p["respawn_steps"][1, 2] = 3
            yaw[1, 0] = np.float32(yaw[1, 0] + np.pi)
        p["pos"], p["yaw"] = pos, yaw
    elif case == "subzone_machine":
        from madrona_mp_env_tpu.sim.subzones import subzone_boxes

        mins, maxs, _ = subzone_boxes(m)
        center0 = np.asarray(0.5 * (mins[0] + maxs[0]))
        # world 0: agent 0 alone in sub-zone 0; world 1: opponent 2 too
        pos = np.tile(np.float32([10000.0, 10000.0, 0.0]), (W, A, 1))
        pos[:, 0] = center0
        pos[1, 2] = center0 + [1.0, 0.0, 0.0]
        p["pos"] = pos
        p["alive"] = np.ones((W, A), np.float32)
        p["policy_idx"] = np.zeros((W, A), np.int32)
    else:
        raise KeyError(case)
    return p


def run_plant(mp, env, system, state):
    """Run ``system`` on the planted state: {output leaf: array}."""
    import jax
    import jax.numpy as jnp
    from madrona_mp_env_tpu.sim import (hl_battle, rewards, subzones, turret,
                                        zones)
    from madrona_mp_env_tpu.sim.types import Actions

    cfg, m = env.cfg, env.map_data
    W = NUM_WORLDS
    if system == "match_reward":
        def f(s):
            fr = jnp.asarray(False)
            if cfg.task == mp.Task.Turret:
                s, _ = turret.turret_match_info_system(cfg, s, fr)
            elif cfg.task == mp.Task.TDM:
                s, _ = zones.tdm_match_info_system(cfg, s, fr)
            else:
                s, _ = zones.zone_match_info_system(cfg, m, s, fr)
            return rewards.reward_system(cfg, m, s)

        s = jax.jit(jax.vmap(f))(state)
        return {k: np.asarray(getattr(s, k)) for k in MATCH_KEYS}
    if system == "turret_ai":
        acts = jax.tree_util.tree_map(
            lambda x: jnp.broadcast_to(x, (W,) + x.shape),
            Actions.zeros(cfg.num_agents))
        a = jax.jit(jax.vmap(
            lambda s, a: turret.turret_ai_system(cfg, m, s, a)))(state, acts)
        return {k: np.asarray(getattr(a, k)) for k in TURRET_KEYS}
    if system == "hl_battle":
        s, ev = jax.jit(jax.vmap(
            lambda s: hl_battle.hl_battle_system(cfg, m, s)))(state)
        out = {k: np.asarray(getattr(s, k)) for k in HL_KEYS}
        out["shot_victim"] = np.asarray(ev["shot_victim"])
        return out
    if system == "subzone":
        s = jax.jit(jax.vmap(
            lambda s: subzones.subzone_system(cfg, m, s)))(state)
        return {k: np.asarray(getattr(s, k)) for k in SUBZONE_KEYS}
    raise KeyError(system)


def eye_visibility(m, pos):
    """[W, A, A] eye-to-eye clear lines of standing agents at pos."""
    import jax.numpy as jnp
    from madrona_mp_env_tpu import consts
    from madrona_mp_env_tpu.ops.raycast import ray_vs_tris

    eye = pos + np.float32([0.0, 0.0,
                            consts.stand_height - consts.agent_radius])
    d = eye[:, None, :, :] - eye[:, :, None, :]
    dist = np.linalg.norm(d, axis=-1)
    n = d / np.maximum(dist, 1e-9)[..., None]
    o = np.broadcast_to(eye[:, :, None, :], d.shape)
    t = np.asarray(ray_vs_tris(jnp.asarray(o, jnp.float32),
                               jnp.asarray(n, jnp.float32), m.tris))
    return t >= dist - 1e-3


def middle_spawn_map(m, n_default, keep=MIDDLE_BOXES):
    """The spawn boxes cut to ``keep`` a side: the defaults, then the
    first mid-map extras."""
    return dict(side_spawns=m.side_spawns[:, :keep],
                num_extra_side_spawns=np.asarray(keep - n_default,
                                                 np.int32))


def jax_middle_reset(mp):
    """The SpawnInMiddle | RandomizeHPMagazine reset at MIDDLE_WORLDS
    worlds on the cut spawn table: leaves MIDDLE_KEYS."""
    import jax
    import jax.numpy as jnp
    from madrona_mp_env_tpu.sim import reset as reset_mod

    cfg = make_cfg(mp, "hp_mag", flags=MIDDLE_FLAGS)
    env = mp.Env(cfg, os.path.join(REPO, "data", "simple_map"),
                 num_worlds=MIDDLE_WORLDS, seed=SEED)
    m = env.map_data
    nd = np.asarray(m.num_default_side_spawns)
    cut = middle_spawn_map(m, nd)
    m2 = m._replace(side_spawns=cut["side_spawns"],
                    num_extra_side_spawns=jnp.asarray(
                        cut["num_extra_side_spawns"]))
    ctrl = env.default_sim_ctrl()
    s = jax.jit(jax.vmap(lambda s: reset_mod.reset_system(
        cfg, m2, s, env.init_key_data, ctrl, jnp.int32(1))))(
            env.init_state())
    return {k: np.asarray(getattr(s, k)) for k in MIDDLE_KEYS}


def main():
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")
    if jax.default_backend() != "cpu":
        raise RuntimeError("the modes fixture needs JAX's CPU backend")
    sys.path.insert(0, REPO)
    import jax.numpy as jnp
    import madrona_mp_env_tpu as mp

    out = {}
    envs, finals = {}, {}
    for name in CONFIGS:
        hist, env, state = jax_rollout(mp, name)
        out.update({f"{name}/{k}": v for k, v in hist.items()})
        envs[name], finals[name] = env, state
        print(f"{name}: {NUM_STEPS} steps", flush=True)
    for case, (name, system) in PLANTS.items():
        env, state = envs[name], finals[name]
        base = leaves(state)
        if f"base/{name}/hp" not in out:
            out.update({f"base/{name}/{k}": v for k, v in base.items()})
        p = plant(case, base, env.map_data)
        out.update({f"plant/{case}/{k}": v for k, v in p.items()})
        planted = state.replace(**{k: jnp.asarray(v) for k, v in p.items()})
        res = run_plant(mp, env, system, planted)
        out.update({f"out/{case}/{k}": v for k, v in res.items()})
        if "pos" in p and system != "subzone":
            vis = eye_visibility(env.map_data, p["pos"])
            out[f"meta/{case}/visible"] = vis
            assert vis[0, 2, 0] and not vis[0, 3, 1], case
        print(f"{case}: " + ", ".join(f"{k} {v.tolist()}"
                                      for k, v in res.items()
                                      if v.ndim <= 2), flush=True)
    mid = jax_middle_reset(mp)
    out.update({f"middle/{k}": v for k, v in mid.items()})
    in_mid = ((np.abs(mid["pos"][..., 0]) <= 280.0)
              & (np.abs(mid["pos"][..., 1]) <= 200.0))
    # both draws of the middle coin: some worlds mid-map, some not
    assert in_mid.all(-1).any() and (~in_mid).all(-1).any(), in_mid
    np.savez_compressed(PATH, **out)
    print(f"wrote {PATH} ({os.path.getsize(PATH)} bytes)")


if __name__ == "__main__":
    main()
