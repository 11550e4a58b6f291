"""Write the record / replay / analytics fixture of the PyTorch port's tests.

Runs the JAX package on the CPU, eagerly (jax.disable_jit;
make_modes_fixture.jax_rollout says why), on data/simple_map:

- ``rec/``: Zone 2v2, 2 worlds, seed SEED, episode_len EPISODE_LEN (a
  match ends and a reset happens inside the window), Env(collect_log=True),
  REC_STEPS steps of record_actions (tests/test_data.py's: everyone moves,
  fire alternating with reload so that reload events occur): every step's
  ``step_log``, ``snapshot`` and ``game_events`` leaves; ``files/`` holds
  the bytes of the record file (RecordLogWriter) and of the event log's
  events.bin and steps.bin (EventLogWriter);
- ``replay/``: Env.replay_step over that record from a fresh reset (the
  replay's default eval-mode sim_ctrl): each step's observations
  (OBS_KEYS), reward, done, snapshot and game events;
- ``db/``: the tables build_db makes of that event log, each as its rows
  ``SELECT * ... ORDER BY id`` (the team_states hull blobs apart);
- ``data/``: select_windows' DumpItem streams for the masks of
  SELECT_MASKS (windows of SELECT_WINDOW steps), build_curriculum on the
  first of them (trajectories of SELECT_WINDOW, every 2nd step), the
  100-step trajectory of wrapped step ids that tests/test_data.py builds
  and its curriculum file (every 20th step: 5 snapshots), and a planted
  curriculum file (save_curriculum_snapshots: those snapshots' players
  with crouch / prone flags and hp planted, match states captured and
  not);
- ``restore/``: Env(curriculum_path=<the planted file>) resets:
  ``p1/`` with trajectory_curriculum_prob 1.0 and RandomFlipTeams at
  RESTORE_WORLDS worlds (the seed's flips differ between worlds), ``eval/``
  the same env reset in eval mode (sim_ctrl (1, 0, 0): nothing restored),
  ``p05/`` the default prob 0.5 at 2 worlds with a seed whose two worlds
  draw differently; each with RESTORE_KEYS, the "self" observation and the
  draws (do, idx) computed from the JAX package's key stream;
- ``edge/``: packed_snapshot_export on a planted world (yaw exactly +-pi,
  hp below 0 and above 255, positions beyond int16, a magazine above
  255, NaN hp) and event_export on a planted capture with every event
  flag: inputs and outputs.

tests/test_torch_record.py and tests/test_torch_data.py replay them
through the port on the CPU.

Regenerate (only after a deliberate change of the JAX reference; ~5
minutes on one CPU, the eager rollouts):

    JAX_PLATFORMS=cpu python tests/fixtures_torch/make_record_fixture.py
"""

from __future__ import annotations

import dataclasses
import os
import sqlite3
import sys
import tempfile

import numpy as np

import make_slice_fixture as fx

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
PATH = os.path.join(HERE, "zone_record.npz")

SEED = 11
TEAM_SIZE = 2
REC_WORLDS = 2
REC_STEPS = 12
EPISODE_LEN = 8
OBS_KEYS = fx.OBS_KEYS
DB_TABLES = ("matches", "match_steps", "team_states", "player_states",
             "capture_events", "reload_events", "kill_events",
             "player_shot_events")
SELECT_MASKS = (0, 2, 8)
SELECT_WINDOW = 4
SELECT_MAX = 6
RESTORE_WORLDS = 4
RESTORE_KEYS = ("pos", "yaw", "pitch", "hp", "mag_bullets", "mag_reloading",
                "stand_cur", "stand_tgt", "stand_transition", "cur_step",
                "zone_cur", "zone_controlling", "zone_captured",
                "zone_steps_remaining", "zone_steps_until_point", "team_a",
                "alive", "start_pos")
# planted curriculum match states: (step, zone, controller, remaining,
# until point); controller -1 is a zone nobody holds
PLANTED_MATCH_STATE = ((3, 1, -1, 600, 40), (37, 2, 1, 500, 7),
                       (120, 0, 0, 233, 19), (5, 3, -1, 11, 2),
                       (64, 1, 1, 1, 1))
# planted player flags / hp of snapshot s, player p: (s, p, flags, hp)
PLANTED_PLAYERS = ((0, 0, 4, 37), (1, 1, 8, 100), (1, 2, 6, 250),
                   (2, 3, 12, 1), (3, 0, 2, 99), (4, 2, 4, 0))


def make_cfg(mod, episode_len=EPISODE_LEN, flags=(), **kw):
    """Zone 2v2 in package ``mod`` (either package: the names are
    shared)."""
    fl = mod.SimFlags.Default
    for f in flags:
        fl |= getattr(mod.SimFlags, f)
    return mod.EnvConfig(task=mod.Task.Zone, team_size=TEAM_SIZE,
                         episode_len=episode_len, sim_flags=fl, **kw)


def record_actions(steps=REC_STEPS, worlds=REC_WORLDS,
                   agents=2 * TEAM_SIZE):
    """tests/test_data.py's actions, [steps, W, A] int32 each: everyone
    moves forward, aim centred; fire 2 (reload) on every third step from
    step 0, else 1."""
    shape = (steps, worlds, agents)
    fire = np.where((np.arange(steps) % 3 == 0)[:, None, None], 2, 1)
    return {
        "move_amount": np.ones(shape, np.int32),
        "move_angle": np.zeros(shape, np.int32),
        "fire": np.broadcast_to(fire, shape).astype(np.int32),
        "stand": np.zeros(shape, np.int32),
        "aim_yaw": np.full(shape, 6, np.int32),
        "aim_pitch": np.full(shape, 3, np.int32),
    }


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _bytes(path):
    return np.frombuffer(open(path, "rb").read(), np.uint8)


def db_tables(db_path):
    """{table: rows [N, C] int64} and the team_states hull blobs [N, 26]."""
    db = sqlite3.connect(db_path)
    out = {}
    for t in DB_TABLES:
        rows = db.execute(f"SELECT * FROM {t} ORDER BY id").fetchall()
        if t == "team_states":
            out[t + "_hull"] = np.array(
                [np.frombuffer(r[-1], np.uint8) for r in rows],
                np.uint8).reshape(len(rows), -1)
            rows = [r[:-1] for r in rows]
        ncol = len(db.execute(f"SELECT * FROM {t} LIMIT 0").description)
        ncol -= t == "team_states"
        out[t] = np.array(rows, np.int64).reshape(len(rows), ncol)
    db.close()
    return out


def restore_draws(env, prob, eval_mode=False):
    """(do [W] bool, idx [W] i32) of the trajectory-curriculum restore at
    the first reset, from the JAX package's key stream (sim/reset.py
    init_world's k_curr, split into k_p and k_idx)."""
    import jax
    import jax.numpy as jnp
    from madrona_mp_env_tpu.utils import rng

    do, idx = [], []
    S = env.map_data.num_curriculum_snapshots
    for w in range(env.num_worlds):
        ep = rng.episode_key(env.init_key_data, jnp.uint32(0), jnp.int32(w))
        base = rng.step_key(ep, jnp.int32(-1))
        k_curr = jax.random.split(base, 6)[4]
        k_p, k_idx = jax.random.split(k_curr)
        do.append(bool(jax.random.uniform(k_p, ()) < prob) and not eval_mode)
        idx.append(int(jax.random.randint(k_idx, (), 0, S)))
    return np.array(do), np.array(idx, np.int32)


def record_run(mp, out_dir):
    """The ``rec/`` rollout and its files, then the ``replay/`` run."""
    import jax
    import jax.numpy as jnp
    from madrona_mp_env_tpu.data import EventLogWriter, RecordLogWriter
    from madrona_mp_env_tpu.data.recorder import ReplayLogReader
    from madrona_mp_env_tpu.sim.types import Actions

    cfg = make_cfg(mp)
    env = mp.Env(cfg, os.path.join(REPO, "data", "simple_map"),
                 num_worlds=REC_WORLDS, seed=SEED, collect_log=True)
    acts = record_actions()
    rec_path = os.path.join(out_dir, "record.bin")
    ev_dir = os.path.join(out_dir, "events")
    out = {}
    with jax.disable_jit():
        state, _ = env.reset()
        zf = jnp.zeros((REC_WORLDS, cfg.num_agents), jnp.float32)
        with RecordLogWriter(rec_path) as rw, EventLogWriter(ev_dir) as ew:
            for s in range(REC_STEPS):
                a = Actions(**{k: jnp.asarray(v[s]) for k, v in
                               acts.items()},
                            aim_yaw_rate=zf, aim_pitch_rate=zf)
                state, o = env.step(state, a)
                rw.append(o["step_log"])
                ew.append(o["snapshot"], o["game_events"])
                for g in ("step_log", "snapshot", "game_events"):
                    for k, v in _np(o[g]).items():
                        out.setdefault(f"rec/{g}/{k}", []).append(v)
                print(f"rec step {s}", flush=True)
        reader = ReplayLogReader(rec_path, REC_WORLDS)
        state, _ = env.reset()
        for s in range(len(reader)):
            log = {k: jnp.asarray(v) for k, v in reader.step(s).items()}
            state, o = env.replay_step(state, log)
            for k in OBS_KEYS:
                out.setdefault(f"replay/obs_{k}", []).append(
                    np.asarray(o["obs"][k]))
            for k in ("reward", "done"):
                out.setdefault(f"replay/{k}", []).append(np.asarray(o[k]))
            for g in ("snapshot", "game_events"):
                for k, v in _np(o[g]).items():
                    out.setdefault(f"replay/{g}/{k}", []).append(v)
            print(f"replay step {s}", flush=True)
    out = {k: np.stack(v) for k, v in out.items()}
    out["files/record"] = _bytes(rec_path)
    out["files/events"] = _bytes(os.path.join(ev_dir, "events.bin"))
    out["files/steps"] = _bytes(os.path.join(ev_dir, "steps.bin"))
    # a match ended and its world reset inside the window
    assert (np.diff(out["rec/snapshot/match_step"], axis=0) < 0).any()
    assert out["files/events"].size, "no game events"
    return out, ev_dir


def data_tools(out_dir, ev_dir):
    """The ``db/`` tables and the ``data/`` files."""
    from madrona_mp_env_tpu.data import formats
    from madrona_mp_env_tpu.data.build_db import build_db
    from madrona_mp_env_tpu.data.build_trajectory_curriculum import (
        build_curriculum)
    from madrona_mp_env_tpu.data.select_trajectories import select_windows
    from madrona_mp_env_tpu.data.trajectory_db import write_dump_items

    out = {}
    db_path = os.path.join(out_dir, "analytics.db")
    build_db(ev_dir, db_path)
    out.update({f"db/{k}": v for k, v in db_tables(db_path).items()})
    for mask in SELECT_MASKS:
        sid, tid = select_windows(db_path, mask, SELECT_WINDOW, SELECT_MAX)
        p = os.path.join(out_dir, f"dump_m{mask}.bin")
        write_dump_items(p, sid, tid)
        out[f"data/dump_m{mask}"] = _bytes(p)
    p = os.path.join(out_dir, "curr_w.bin")
    build_curriculum(db_path, os.path.join(out_dir, f"dump_m{SELECT_MASKS[0]}"
                                           ".bin"), p, SELECT_WINDOW, 2)
    out["data/curr_window"] = _bytes(p)
    db = sqlite3.connect(db_path)
    ids = [r[0] for r in db.execute(
        "SELECT id FROM match_steps ORDER BY id LIMIT 100").fetchall()]
    db.close()
    ids = np.asarray((ids * 100)[:100], np.int64)
    dump = os.path.join(out_dir, "traj100.bin")
    write_dump_items(dump, ids, np.zeros(100, np.int64))
    out["data/dump_100"] = _bytes(dump)
    curr = os.path.join(out_dir, "curr100.bin")
    assert build_curriculum(db_path, dump, curr) == 5
    out["data/curr_100"] = _bytes(curr)

    raw = np.fromfile(curr, formats.CURRICULUM_SNAPSHOT_DTYPE)
    players = raw["players"].copy()
    for s, p, flags, hp in PLANTED_PLAYERS:
        players[s, p]["flags"] = flags
        players[s, p]["hp"] = hp
    planted = os.path.join(out_dir, "curr_planted.bin")
    formats.save_curriculum_snapshots(
        planted, np.asarray(PLANTED_MATCH_STATE, np.int64), players)
    out["data/curr_planted"] = _bytes(planted)
    return out, planted


def _restore_case(mp, planted, worlds, prob, flags, seed, sim_ctrl=None):
    import jax
    import jax.numpy as jnp

    cfg = make_cfg(mp, episode_len=mp.EnvConfig.episode_len, flags=flags,
                   trajectory_curriculum_prob=prob)
    env = mp.Env(cfg, os.path.join(REPO, "data", "simple_map"),
                 num_worlds=worlds, seed=seed, curriculum_path=planted)
    assert env.map_data.num_curriculum_snapshots == len(PLANTED_MATCH_STATE)
    with jax.disable_jit():
        ctrl = None if sim_ctrl is None else jnp.asarray(sim_ctrl, jnp.int32)
        state, obs = env.reset(ctrl)
    rec = {k: np.asarray(getattr(state, k)) for k in RESTORE_KEYS}
    rec["obs_self"] = np.asarray(obs["self"])
    do, idx = restore_draws(env, prob, eval_mode=sim_ctrl is not None)
    rec.update(do=do, idx=idx, seed=np.int64(seed))
    return rec


def restore_cases(mp, planted):
    """``restore/``: prob 1.0 (a seed whose worlds flip differently), the
    same env in eval mode, prob 0.5 (a seed whose two worlds draw
    differently)."""
    import jax
    import jax.numpy as jnp

    m = mp.Env(make_cfg(mp), os.path.join(REPO, "data", "simple_map"),
               num_worlds=1, curriculum_path=planted).map_data

    def first_seed(pred, worlds, prob, flags):
        for seed in range(100):
            cfg = make_cfg(mp, flags=flags, trajectory_curriculum_prob=prob)
            env = mp.Env(cfg, "", num_worlds=worlds, seed=seed, map_data=m)
            if pred(env):
                return seed
        raise RuntimeError("no seed found")

    def flips_differ(env):
        from madrona_mp_env_tpu.utils import rng

        fl = []
        for w in range(env.num_worlds):
            ep = rng.episode_key(env.init_key_data, jnp.uint32(0),
                                 jnp.int32(w))
            k_flip = jax.random.split(rng.step_key(ep, jnp.int32(-1)), 6)[0]
            fl.append(bool(jax.random.uniform(k_flip, ()) < 0.5))
        _, idx = restore_draws(env, 1.0)
        return len(set(fl)) == 2 and len(set(idx.tolist())) > 1

    def draws_differ(env):
        do, _ = restore_draws(env, 0.5)
        return len(set(do.tolist())) == 2

    out = {}
    flags = ("RandomFlipTeams",)
    s1 = first_seed(flips_differ, RESTORE_WORLDS, 1.0, flags)
    for name, ctrl in (("p1", None), ("eval", (1, 0, 0))):
        rec = _restore_case(mp, planted, RESTORE_WORLDS, 1.0, flags, s1, ctrl)
        out.update({f"restore/{name}/{k}": v for k, v in rec.items()})
        print(f"restore {name}: seed {s1}, do {rec['do']}", flush=True)
    s5 = first_seed(draws_differ, 2, 0.5, ())
    rec = _restore_case(mp, planted, 2, 0.5, (), s5)
    out.update({f"restore/p05/{k}": v for k, v in rec.items()})
    print(f"restore p05: seed {s5}, do {rec['do']}", flush=True)
    return out


def edge_cases(mp):
    """``edge/``: the exports on planted worlds (inputs and outputs)."""
    import jax
    import jax.numpy as jnp
    from madrona_mp_env_tpu.data import export

    cfg = make_cfg(mp)
    env = mp.Env(cfg, os.path.join(REPO, "data", "simple_map"),
                 num_worlds=1, seed=SEED)
    with jax.disable_jit():
        state, _ = env.reset()
        s = jax.tree_util.tree_map(lambda x: x[0], state)
        pi = np.float32(np.pi)
        s = s.replace(
            yaw=jnp.asarray([pi, -pi, 3.1415925, -0.0], jnp.float32),
            pitch=jnp.asarray([pi / 4, -pi / 4, 1e-9, -1.5], jnp.float32),
            hp=jnp.asarray([-5.5, 300.7, 255.9, np.nan], jnp.float32),
            pos=jnp.asarray([[40000.5, -40000.0, 32767.9],
                             [-32768.9, 0.49, -0.51],
                             [3.0e37, -3.0e37, 1234.56],
                             [np.inf, -np.inf, -7.99]], jnp.float32),
            mag_bullets=jnp.asarray([300, -3, 255, 256], jnp.int32),
            mag_reloading=jnp.asarray([0, 1, 257, -1], jnp.int32),
            landed_shot_on=jnp.asarray([2, -1, 0, -1], jnp.int32),
            stand_cur=jnp.asarray([0, 1, 2, 1], jnp.int32),
            zone_captured=jnp.asarray(True),
            zone_controlling=jnp.asarray(1, jnp.int32),
            in_zone=jnp.asarray([True, False, True, True]),
        )
        fire = {
            "reload_event": jnp.asarray([True, False, False, True]),
            "reload_bullets": jnp.asarray([3, 0, 0, 29], jnp.int32),
            "shot_event": jnp.asarray([True, False, True, False]),
            "shot_victim": jnp.asarray([2, -1, 0, -1], jnp.int32),
            "kill_event": jnp.asarray([False, False, True, False]),
        }
        ev = _np(export.event_export(cfg, s, fire, jnp.asarray(True)))
        snap = _np(export.packed_snapshot_export(
            cfg, s, jnp.asarray(ev["num_events"]),
            jnp.asarray(ev["event_mask"])))
        log = _np(export.step_log_export(cfg, s))
    out = {f"edge/state/{f.name}": np.asarray(getattr(s, f.name))[None]
           for f in dataclasses.fields(s)}
    out.update({f"edge/fire/{k}": np.asarray(v)[None]
                for k, v in fire.items()})
    out.update({f"edge/events/{k}": np.asarray(v)[None]
                for k, v in ev.items()})
    out.update({f"edge/snapshot/{k}": np.asarray(v)[None]
                for k, v in snap.items()})
    out.update({f"edge/step_log/{k}": np.asarray(v)[None]
                for k, v in log.items()})
    return out


def main():
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")
    if jax.default_backend() != "cpu":
        raise RuntimeError("the record fixture needs JAX's CPU backend")
    sys.path.insert(0, REPO)
    import madrona_mp_env_tpu as mp

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        rec, ev_dir = record_run(mp, tmp)
        out.update(rec)
        data, planted = data_tools(tmp, ev_dir)
        out.update(data)
        out.update(restore_cases(mp, planted))
    out.update(edge_cases(mp))
    np.savez_compressed(PATH, **out)
    print(f"{PATH}: {os.path.getsize(PATH)} bytes", flush=True)


if __name__ == "__main__":
    main()
