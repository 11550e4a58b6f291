"""The port's data tools and the trajectory-curriculum restore against the
JAX package, on the CPU.

The formats' dtypes equal the JAX package's. The data tools run on the
event log of fixtures_torch/zone_record.npz (make_record_fixture.py),
which tests/test_torch_record.py holds byte-equal to the port's own:
build_db's tables equal the JAX package's, row for row (``SELECT * ...
ORDER BY id``, the hull blobs byte for byte), select_windows' DumpItem
streams and build_curriculum's snapshot files are byte-equal, and the
TrajectoryDB round-trips and writes the JAX package's training set. The
restore: Env(curriculum_path=<the fixture's planted file>) resets as the
eager JAX Env does (pos, hp, magazines, pose, zone state, cur_step and
team side exact; yaw and pitch bit-equal; the "self" observation within
1e-3 * max(1, |x|)): with trajectory_curriculum_prob 1.0 and team flips,
in eval mode (nothing restored) and at the default 0.5, where the
fixture's two worlds draw differently.
"""

import os
import sqlite3
import sys

import numpy as np
import pytest
import torch

import madrona_mp_env_tpu as mp
from madrona_mp_env_tpu.data import build_db as jbuild_db
from madrona_mp_env_tpu.data import formats as jformats
from madrona_mp_env_tpu.data import trajectory_db as jtraj

import madrona_mp_env_tpu_torch as mt
from madrona_mp_env_tpu_torch.data import build_db, formats, trajectory_db
from madrona_mp_env_tpu_torch.data.build_trajectory_curriculum import (
    build_curriculum)
from madrona_mp_env_tpu_torch.data.select_trajectories import select_windows
from madrona_mp_env_tpu_torch.sim import reset as reset_mod

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "fixtures_torch"))
import make_record_fixture as rx  # noqa: E402
from torch_threads import one_thread_under_xdist  # noqa: E402,F401

DTYPES = ("AGENT_LOG_DTYPE", "STEP_LOG_DTYPE", "PACKED_PLAYER_DTYPE",
          "PACKED_MATCH_STATE_DTYPE", "PACKED_STEP_SNAPSHOT_DTYPE",
          "GAME_EVENT_DTYPE", "CURRICULUM_SNAPSHOT_DTYPE", "TEAM_HULL_DTYPE")
# tests/test_data.py:35-45
ITEMSIZES = (72, 868, 14, 8, 192, 24, 176, 26)


@pytest.fixture(scope="module")
def data():
    return dict(np.load(rx.PATH))


@pytest.fixture(scope="module")
def files(data, tmp_path_factory):
    """The fixture's event log and data files on disk, and the port's
    database of that event log."""
    tmp = tmp_path_factory.mktemp("data")
    (tmp / "events").mkdir()
    for name, rel in (("events", "events/events.bin"),
                      ("steps", "events/steps.bin")):
        (tmp / rel).write_bytes(data[f"files/{name}"].tobytes())
    for k, v in data.items():
        if k.startswith("data/"):
            (tmp / (k[5:] + ".bin")).write_bytes(v.tobytes())
    build_db.build_db(str(tmp / "events"), str(tmp / "port.db"))
    return tmp


@pytest.mark.parametrize("name,size", list(zip(DTYPES, ITEMSIZES)))
def test_formats_match_jax(name, size):
    got, want = getattr(formats, name), getattr(jformats, name)
    assert got == want and got.itemsize == size


def _rows(db_path, table):
    db = sqlite3.connect(db_path)
    rows = db.execute(f"SELECT * FROM {table} ORDER BY id").fetchall()
    db.close()
    return rows


@pytest.mark.parametrize("table", rx.DB_TABLES)
def test_build_db_matches_jax(data, files, table):
    """The port's tables equal the fixture's (the JAX build_db of the
    same event log), and the JAX build_db run here on the same files."""
    rows = _rows(str(files / "port.db"), table)
    hull = None
    if table == "team_states":
        hull = np.array([np.frombuffer(r[-1], np.uint8) for r in rows])
        rows = [r[:-1] for r in rows]
        assert np.array_equal(hull, data["db/team_states_hull"])
    got = np.array(rows, np.int64).reshape(data[f"db/{table}"].shape)
    assert np.array_equal(got, data[f"db/{table}"])
    if table == "matches":
        jdb = files / "jax.db"
        if not jdb.exists():
            jbuild_db.build_db(str(files / "events"), str(jdb))
        for t in rx.DB_TABLES:
            assert _rows(str(files / "port.db"), t) == _rows(str(jdb), t), t


def test_convex_hull_matches_jax():
    g = np.random.default_rng(0)
    for n in (1, 2, 3, 6, 12):
        pts = g.integers(-50, 50, size=(n, 2)).astype(np.int16)
        pts[n // 2:] = pts[0] if n > 3 else pts[n // 2:]
        got = build_db.convex_hull_i16(pts)
        assert np.array_equal(got, jbuild_db.convex_hull_i16(pts))
        assert build_db.hull_blob(got) == jbuild_db.hull_blob(got)


@pytest.mark.parametrize("mask", rx.SELECT_MASKS)
def test_select_windows_matches_jax(data, files, tmp_path, mask):
    sid, tid = select_windows(str(files / "port.db"), mask,
                              rx.SELECT_WINDOW, rx.SELECT_MAX)
    out = tmp_path / "dump.bin"
    trajectory_db.write_dump_items(str(out), sid, tid)
    assert out.read_bytes() == data[f"data/dump_m{mask}"].tobytes()
    assert len(sid) > 0 or mask


@pytest.mark.parametrize("case", ["window", "100"])
def test_build_curriculum_matches_jax(data, files, tmp_path, case):
    out = tmp_path / "curr.bin"
    if case == "window":
        dump = files / f"dump_m{rx.SELECT_MASKS[0]}.bin"
        n = build_curriculum(str(files / "port.db"), str(dump), str(out),
                             rx.SELECT_WINDOW, 2)
    else:
        n = build_curriculum(str(files / "port.db"),
                             str(files / "dump_100.bin"), str(out))
        assert n == 5
    want = data[f"data/curr_{case}"].tobytes()
    assert n and out.read_bytes() == want


def test_curriculum_file_round_trip(data, files, tmp_path):
    """save_curriculum_snapshots writes the fixture's planted file, and
    load_curriculum_snapshots reads it as the JAX package's loader."""
    planted = str(files / "curr_planted.bin")
    raw = np.fromfile(str(files / "curr_100.bin"),
                      formats.CURRICULUM_SNAPSHOT_DTYPE)
    players = raw["players"].copy()
    for s, p, flags, hp in rx.PLANTED_PLAYERS:
        players[s, p]["flags"] = flags
        players[s, p]["hp"] = hp
    out = tmp_path / "planted.bin"
    formats.save_curriculum_snapshots(
        str(out), np.asarray(rx.PLANTED_MATCH_STATE, np.int64), players)
    assert out.read_bytes() == data["data/curr_planted"].tobytes()
    got = formats.load_curriculum_snapshots(planted)
    want = jformats.load_curriculum_snapshots(planted)
    assert got.tobytes() == want.tobytes() and got.dtype == want.dtype


def test_trajectory_db_round_trip(tmp_path):
    steps = np.zeros(10, dtype=[("pos", "<f4", (3,)), ("yaw", "<f4"),
                                ("action", "<i4")])
    steps["yaw"] = np.arange(10)
    steps["pos"] = np.arange(30).reshape(10, 3)
    db = trajectory_db.TrajectoryDB(str(tmp_path / "traj.db"))
    tid = db.save_trajectory(trajectory_db.TrajectoryType.RL, "tag", steps)
    tid2 = db.save_trajectory(trajectory_db.TrajectoryType.HUMAN, None,
                              steps[:4])
    assert db.num_trajectories() == 2 and db.trajectory_ids() == [tid, tid2]
    assert db.get_steps(tid).tobytes() == steps.tobytes()
    assert db.get_tag(tid) == "tag" and db.get_type(tid2) == 0
    assert db.advance_n(tid, 1) == tid2 and db.advance_n(tid2, 1) == tid
    assert db.save_trajectory(2, "x", steps[:2], traj_id=tid) == tid
    assert db.get_type(tid) == 2 and len(db.get_steps(tid)) == 2
    assert trajectory_db.build_training_set(
        db, [tid2, tid2], str(tmp_path / "set.bin")) == 8
    jdb = jtraj.TrajectoryDB(str(tmp_path / "jtraj.db"))
    j = jdb.save_trajectory(1, "tag", steps[:4])
    jtraj.build_training_set(jdb, [j, j], str(tmp_path / "jset.bin"))
    assert ((tmp_path / "set.bin").read_bytes()
            == (tmp_path / "jset.bin").read_bytes())
    db.remove_trajectory(tid)
    assert db.num_trajectories() == 1 and list(dict(iter(db))) == [tid2]
    with pytest.raises(KeyError):
        db.get_steps(tid)
    db.close()
    jdb.close()


RESTORE_CASES = {
    # fixture group: (worlds, prob, flags, sim_ctrl)
    "p1": (rx.RESTORE_WORLDS, 1.0, ("RandomFlipTeams",), None),
    "eval": (rx.RESTORE_WORLDS, 1.0, ("RandomFlipTeams",), (1, 0, 0)),
    "p05": (2, 0.5, (), None),
}


@pytest.mark.parametrize("case", sorted(RESTORE_CASES))
def test_restore_matches_jax(data, files, case):
    worlds, prob, flags, ctrl = RESTORE_CASES[case]
    want = {k.split("/", 2)[2]: v for k, v in data.items()
            if k.startswith(f"restore/{case}/")}
    cfg = rx.make_cfg(mt, episode_len=mt.EnvConfig.episode_len, flags=flags,
                      trajectory_curriculum_prob=prob)
    env = mt.Env(cfg, "data/simple_map", num_worlds=worlds,
                 seed=int(want["seed"]), device="cpu",
                 curriculum_path=str(files / "curr_planted.bin"))
    assert env.map_data.num_curriculum_snapshots == len(
        rx.PLANTED_MATCH_STATE)
    state, obs = env.reset(ctrl)
    for k in rx.RESTORE_KEYS:
        got = getattr(state, k).numpy()
        assert got.shape == want[k].shape, k
        assert np.array_equal(got.view(np.int32) if got.dtype == np.float32
                              else got, want[k].view(np.int32)
                              if want[k].dtype == np.float32 else want[k]), k
    err = np.abs(obs["self"].numpy() - want["obs_self"]) / np.maximum(
        1.0, np.abs(want["obs_self"]))
    assert err.max() <= 1e-3
    # the draws: restored worlds hold their snapshot's step
    ms = np.asarray(rx.PLANTED_MATCH_STATE)[want["idx"]]
    restored = state.cur_step.numpy() == ms[:, 0]
    assert np.array_equal(restored, want["do"]), (restored, want["do"])
    if case == "p05":
        assert want["do"].any() and not want["do"].all()
    if case == "p1":
        assert len(set(want["team_a"].tolist())) == 2


def test_restore_needs_snapshots(monkeypatch, files, simple_map_dir):
    """Without a curriculum file no restore code runs; a map loaded with
    one is not shared with an Env of another curriculum."""
    monkeypatch.setattr(reset_mod, "_maybe_restore_snapshot",
                        lambda *a: pytest.fail("restore without snapshots"))
    cfg = mt.EnvConfig(team_size=2, trajectory_curriculum_prob=1.0)
    env = mt.Env(cfg, simple_map_dir, num_worlds=2, device="cpu")
    assert env.map_data.num_curriculum_snapshots == 0
    env.reset()
    monkeypatch.undo()
    curr = str(files / "curr_planted.bin")
    with_c = mt.Env(cfg, simple_map_dir, num_worlds=1, device="cpu",
                    curriculum_path=curr)
    mt.Env(cfg, simple_map_dir, num_worlds=1, device="cpu",
           curriculum_path=curr, map_data=with_c.map_data)
    for other in (dict(), dict(curriculum_path=str(files / "curr_100.bin"))):
        with pytest.raises(ValueError, match="map_data"):
            mt.Env(cfg, simple_map_dir, num_worlds=1, device="cpu",
                   map_data=with_c.map_data, **other)
    # the JAX Env reads the same file into the same arrays
    jm = mp.Env(mp.EnvConfig(team_size=2), simple_map_dir, num_worlds=1,
                curriculum_path=curr).map_data
    assert np.array_equal(with_c.map_data.curriculum_players.numpy(),
                          np.asarray(jm.curriculum_players))
    assert np.array_equal(with_c.map_data.curriculum_match_state.numpy(),
                          np.asarray(jm.curriculum_match_state))
    state, _ = with_c.reset()
    _, out = with_c.step(state, with_c.zero_actions())
    assert bool(torch.isfinite(out["reward"]).all())
