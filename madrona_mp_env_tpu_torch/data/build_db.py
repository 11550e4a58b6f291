"""events.bin + steps.bin -> the SQLite analytics database.

The reference's ``build_db`` tool (src/build_db.cpp), as the JAX package's
data/build_db.py builds it: the same schema (matches, match_steps,
team_states with the int16 convex-hull blobs of build_db.cpp:9-72,
player_states, the capture / reload / kill / player-shot event tables,
step_tokens) and the same rows, so that the curriculum builder and the
analytics queries read a database of either producer.

    python -m madrona_mp_env_tpu_torch.data.build_db <event_log_dir> <out.db>
"""

from __future__ import annotations

import sqlite3
import sys
from typing import Tuple

import numpy as np

from .formats import EventType, TEAM_HULL_DTYPE
from .recorder import read_event_log, read_step_snapshots

SCHEMA = """
CREATE TABLE matches (
  id INTEGER PRIMARY KEY AUTOINCREMENT,
  orig_id INTEGER NOT NULL,
  num_steps INTEGER NOT NULL
);

CREATE TABLE match_steps (
  id INTEGER PRIMARY KEY AUTOINCREMENT,
  match_id INTEGER NOT NULL,
  step_idx INTEGER NOT NULL,
  cur_zone INTEGER NOT NULL,
  cur_zone_controller INTEGER NOT NULL,
  zone_steps_remaining INTEGER NOT NULL,
  zone_steps_until_point INTEGER NOT NULL,
  num_events INTEGER NOT NULL,
  event_mask INTEGER NOT NULL,
  world_id INTEGER NOT NULL,
  global_idx INTEGER NOT NULL,
  UNIQUE(match_id, step_idx)
);

CREATE TABLE team_states (
  id INTEGER PRIMARY KEY AUTOINCREMENT,
  step_id INTEGER NOT NULL,
  team_idx INTEGER NOT NULL,
  centroid_x INTEGER NOT NULL,
  centroid_y INTEGER NOT NULL,
  extent_x INTEGER NOT NULL,
  extent_y INTEGER NOT NULL,
  hull_data BLOB NOT NULL,
  UNIQUE(step_id, team_idx)
);

CREATE TABLE player_states (
  id INTEGER PRIMARY KEY AUTOINCREMENT,
  step_id INTEGER NOT NULL,
  player_idx INTEGER NOT NULL,
  pos_x INTEGER NOT NULL,
  pos_y INTEGER NOT NULL,
  pos_z INTEGER NOT NULL,
  yaw INTEGER NOT NULL,
  pitch INTEGER NOT NULL,
  num_bullets INTEGER NOT NULL,
  is_reloading INTEGER NOT NULL,
  fired_shot INTEGER NOT NULL,
  hp INTEGER NOT NULL,
  stand_state INTEGER NOT NULL,
  flags INTEGER NOT NULL,
  UNIQUE(step_id, player_idx)
);

CREATE TABLE capture_events (
  id INTEGER PRIMARY KEY AUTOINCREMENT,
  step_id INTEGER NOT NULL,
  zone_idx INTEGER NOT NULL,
  capture_team_idx INTEGER NOT NULL,
  in_zone_mask INTEGER NOT NULL,
  num_in_zone INTEGER NOT NULL,
  UNIQUE(step_id, zone_idx)
);

CREATE TABLE reload_events (
  id INTEGER PRIMARY KEY AUTOINCREMENT,
  step_id INTEGER NOT NULL,
  player_state_id INTEGER NOT NULL,
  num_bullets INTEGER NOT NULL,
  UNIQUE(step_id, player_state_id)
);

CREATE TABLE kill_events (
  id INTEGER PRIMARY KEY AUTOINCREMENT,
  step_id INTEGER NOT NULL,
  killer_id INTEGER NOT NULL,
  killed_id INTEGER NOT NULL,
  UNIQUE(step_id, killer_id, killed_id)
);

CREATE TABLE player_shot_events (
  id INTEGER PRIMARY KEY AUTOINCREMENT,
  step_id INTEGER NOT NULL,
  attacker_id INTEGER NOT NULL,
  target_id INTEGER NOT NULL,
  UNIQUE(step_id, attacker_id, target_id)
);

CREATE TABLE step_tokens (
  id INTEGER PRIMARY KEY AUTOINCREMENT,
  match_id INTEGER NOT NULL,
  tick INTEGER NOT NULL,
  token INTEGER NOT NULL
);

CREATE UNIQUE INDEX idx_find_match_by_orig_id ON matches (orig_id);
"""


def convex_hull_i16(pts: np.ndarray) -> np.ndarray:
    """Monotone-chain hull of int16 XY points [N, 2], at most 6 vertices,
    with the reference's conventions (build_db.cpp:9-72): collinear
    points dropped by the <= 0 cross test."""
    pts = pts[np.lexsort((pts[:, 1], pts[:, 0]))]
    if len(pts) <= 1:
        return pts

    def cross(o, a, b):
        return (int(a[0] - o[0]) * int(b[1] - o[1])
                - int(a[1] - o[1]) * int(b[0] - o[0]))

    def chain(points):
        out = []
        for p in points:
            while len(out) >= 2 and cross(out[-2], out[-1], p) <= 0:
                out.pop()
            out.append(p)
        return out

    hull = chain(pts)[:-1] + chain(pts[::-1])[:-1]
    return np.asarray(hull[:6], dtype=np.int16)


def hull_blob(hull: np.ndarray) -> bytes:
    """A TeamConvexHull record's bytes."""
    rec = np.zeros(1, dtype=TEAM_HULL_DTYPE)
    rec["num_verts"] = len(hull)
    rec["verts"][0, :len(hull)] = hull
    return rec.tobytes()


def _insert(cur, table, row):
    cols = ", ".join(row)
    marks = ",".join("?" * len(row))
    cur.execute(f"INSERT OR IGNORE INTO {table} ({cols}) VALUES ({marks})",
                tuple(row.values()))
    return cur.lastrowid


def build_db(event_dir: str, out_path: str, team_size: int = 6
             ) -> Tuple[int, int]:
    """Fill a new database at ``out_path`` from the event log in
    ``event_dir``; ``team_size`` players a team (the snapshots pad to 6).
    Returns (matches, steps) inserted."""
    events = read_event_log(event_dir)
    snaps = read_step_snapshots(event_dir)

    db = sqlite3.connect(out_path)
    db.executescript("PRAGMA journal_mode = WAL; PRAGMA synchronous = NORMAL;")
    db.executescript(SCHEMA)
    cur = db.cursor()

    # matches in matchID order, each step in global write order
    order = np.argsort(snaps["match_id"], kind="stable")
    match_ids, starts = np.unique(snaps["match_id"][order], return_index=True)
    ends = np.append(starts[1:], len(order))
    match_rows = {}
    for mid, n in zip(match_ids, ends - starts):
        cur.execute("INSERT INTO matches (orig_id, num_steps) VALUES (?, ?)",
                    (int(mid), int(n)))
        match_rows[int(mid)] = cur.lastrowid

    step_rows = {}  # (matchID, step) -> match_steps.id
    player_rows = {}  # (matchID, step, player) -> player_states.id
    for gi in range(len(snaps)):
        s = snaps[gi]
        mid = int(s["match_id"])
        ms = s["match_state"]
        step = int(ms["step"])
        step_id = _insert(cur, "match_steps", {
            "match_id": match_rows[mid],
            "step_idx": step,
            "cur_zone": int(ms["cur_zone"]),
            "cur_zone_controller": int(ms["cur_zone_controller"]),
            "zone_steps_remaining": int(ms["zone_steps_remaining"]),
            "zone_steps_until_point": int(ms["steps_until_point"]),
            "event_mask": int(s["event_mask"]),
            "num_events": int(s["num_events"]),
            "world_id": mid >> 32,
            "global_idx": gi,
        })
        step_rows[(mid, step)] = step_id

        players = s["players"]
        for pi in range(2 * team_size):
            p = players[pi]
            fl = int(p["flags"])
            player_rows[(mid, step, pi)] = _insert(cur, "player_states", {
                "step_id": step_id,
                "player_idx": pi,
                "pos_x": int(p["pos"][0]),
                "pos_y": int(p["pos"][1]),
                "pos_z": int(p["pos"][2]),
                "yaw": int(p["yaw"]),
                "pitch": int(p["pitch"]),
                "num_bullets": int(p["mag_bullets"]),
                "is_reloading": int(p["is_reloading"]),
                "fired_shot": 1 if fl & 2 else 0,
                "hp": int(p["hp"]),
                "stand_state": 1 if fl & 4 else (2 if fl & 8 else 0),
                "flags": fl,
            })

        for team in range(2):
            xy = players["pos"][team * team_size:(team + 1) * team_size,
                                :2].astype(np.int16)
            lo, hi = xy.min(axis=0), xy.max(axis=0)
            centroid = xy.mean(axis=0).astype(int)
            _insert(cur, "team_states", {
                "step_id": step_id,
                "team_idx": team,
                "centroid_x": int(centroid[0]),
                "centroid_y": int(centroid[1]),
                "extent_x": int(hi[0] - lo[0]),
                "extent_y": int(hi[1] - lo[1]),
                "hull_data": hull_blob(convex_hull_i16(xy)),
            })

    # an event references its step's row, and a player that step's
    # player_states row id, as the reference's lookupPlayerID
    # (build_db.cpp:465, 525-544)
    for e in events:
        mid, step = int(e["match_id"]), int(e["step"])
        step_id = step_rows.get((mid, step))
        if step_id is None:
            continue

        def prow(player):
            return player_rows.get((mid, step, int(player)), -1)

        et = int(e["type"])
        if et == EventType.CAPTURE:
            mask = int(e["c"])
            _insert(cur, "capture_events", {
                "step_id": step_id, "zone_idx": int(e["a"]),
                "capture_team_idx": int(e["b"]), "in_zone_mask": mask,
                "num_in_zone": bin(mask).count("1")})
        elif et == EventType.RELOAD:
            _insert(cur, "reload_events", {
                "step_id": step_id, "player_state_id": prow(e["a"]),
                "num_bullets": int(e["b"])})
        elif et == EventType.KILL:
            _insert(cur, "kill_events", {
                "step_id": step_id, "killer_id": prow(e["a"]),
                "killed_id": prow(e["b"])})
        elif et == EventType.PLAYER_SHOT:
            _insert(cur, "player_shot_events", {
                "step_id": step_id, "attacker_id": prow(e["a"]),
                "target_id": prow(e["b"])})

    db.commit()
    db.close()
    return len(match_ids), len(snaps)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2:
        print("usage: build_db EVENT_LOG_DIR OUT_DB", file=sys.stderr)
        sys.exit(1)
    n_matches, n_steps = build_db(argv[0], argv[1])
    print(f"{n_matches} matches, {n_steps} steps")


if __name__ == "__main__":
    main()
