"""Analytics DB + trajectory dump -> a trajectory-curriculum snapshot file.

The reference's ``build_trajectory_curriculum`` tool
(src/build_trajectory_curriculum.cpp), as the JAX package's
data/build_trajectory_curriculum.py: it reads a DumpItem stream
(trajectories of match_steps row ids, 100 steps each), takes every 20th
step, loads that step's players and match state from the DB and writes
CurriculumSnapshot records, the file that Env(curriculum_path=...)
restores at reset (sim/reset.py; reference mgr.cpp:1424-1441,
level_gen.cpp:498-581).

    python -m madrona_mp_env_tpu_torch.data.build_trajectory_curriculum \\
        <db.sqlite> <trajectories.bin> <curriculum_out.bin>
"""

from __future__ import annotations

import sqlite3
import sys

import numpy as np

from .formats import CURRICULUM_SNAPSHOT_DTYPE, MAX_PLAYERS
from .trajectory_db import DUMP_ITEM_DTYPE

TRAJECTORY_LEN = 100  # build_trajectory_curriculum.cpp:112
SUBSAMPLE = 20  # build_trajectory_curriculum.cpp:113


def load_snapshot(db: sqlite3.Connection, step_id: int) -> np.ndarray:
    """One CurriculumSnapshot record of a match_steps row id
    (loadCurriculumSnapshot, build_trajectory_curriculum.cpp:9-82)."""
    snap = np.zeros(1, dtype=CURRICULUM_SNAPSHOT_DTYPE)
    players = db.execute(
        """SELECT pos_x, pos_y, pos_z, yaw, pitch, num_bullets, is_reloading,
                  fired_shot, hp, stand_state
           FROM player_states WHERE step_id = ? ORDER BY player_idx""",
        (step_id,)).fetchall()
    if len(players) != MAX_PLAYERS:
        raise ValueError(f"step {step_id}: {len(players)} player rows, "
                         f"expected {MAX_PLAYERS}")
    pl = snap["players"][0]
    for i, (px, py, pz, yaw, pitch, bullets, reloading, fired, hp,
            stand) in enumerate(players):
        pl[i]["pos"] = (px, py, pz)
        pl[i]["yaw"] = yaw
        pl[i]["pitch"] = pitch
        pl[i]["mag_bullets"] = bullets
        pl[i]["is_reloading"] = reloading
        pl[i]["hp"] = hp
        # FiredShot, then Crouch or Prone
        pl[i]["flags"] = ((2 if fired else 0)
                          | {1: 4, 2: 8}.get(stand, 0))
    row = db.execute(
        """SELECT step_idx, cur_zone, cur_zone_controller,
                  zone_steps_remaining, zone_steps_until_point
           FROM match_steps WHERE id = ?""", (step_id,)).fetchone()
    if row is None:
        raise ValueError(f"no match_steps row {step_id}")
    ms = snap["match_state"]
    for name, v in zip(("step", "cur_zone", "cur_zone_controller",
                        "zone_steps_remaining", "steps_until_point"), row):
        ms[name] = v
    return snap


def build_curriculum(db_path: str, trajectories_path: str, out_path: str,
                     trajectory_len: int = TRAJECTORY_LEN,
                     subsample: int = SUBSAMPLE) -> int:
    """Every ``subsample``-th step of each ``trajectory_len``-step
    trajectory of the dump, as snapshots in ``out_path``. Returns the
    snapshots written."""
    items = np.fromfile(trajectories_path, dtype=DUMP_ITEM_DTYPE)
    if len(items) % trajectory_len:
        raise ValueError(f"{len(items)} dump items do not divide into "
                         f"trajectories of {trajectory_len}")
    db = sqlite3.connect(db_path)
    n = 0
    with open(out_path, "wb") as f:
        for start in range(0, len(items), trajectory_len):
            for off in range(0, trajectory_len, subsample):
                load_snapshot(db, int(items[start + off]["step_id"])).tofile(f)
                n += 1
    db.close()
    return n


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 3:
        print("usage: build_trajectory_curriculum SQL_DB TRAJECTORIES "
              "CURRICULUM_OUT", file=sys.stderr)
        sys.exit(1)
    print(build_curriculum(*argv))


if __name__ == "__main__":
    main()
