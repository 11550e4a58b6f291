"""Tagged trajectory store.

The reference's trajectory DB (src/trajectory_db.hpp:34-54:
openTrajectoryDB, saveTrajectory, getTrajectorySteps, removeTrajectory,
buildTrajectoryTrainingSet), as the JAX package's data/trajectory_db.py
keeps it: a SQLite table of tagged trajectories, each one structured
numpy blob with one record per step (AgentTrajectoryStep,
trajectory_db.hpp:14-30). The curriculum builder reads the reference's
``DumpItem`` {stepID i64, teamID i64} stream (db.hpp:27-30).
"""

from __future__ import annotations

import ast
import sqlite3
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np


class TrajectoryType:
    """TrajectoryType (trajectory_db.hpp:7-12)."""

    HUMAN = 0
    RL = 1
    HARDCODED = 2


DUMP_ITEM_DTYPE = np.dtype(
    {"names": ["step_id", "team_id"], "formats": ["<i8", "<i8"],
     "itemsize": 16})

_SCHEMA = """
CREATE TABLE IF NOT EXISTS trajectories (
  id INTEGER PRIMARY KEY AUTOINCREMENT,
  type INTEGER NOT NULL,
  tag TEXT,
  num_steps INTEGER NOT NULL,
  step_dtype TEXT NOT NULL,
  steps BLOB NOT NULL
);
"""


class TrajectoryDB:
    def __init__(self, path: str):
        self.db = sqlite3.connect(path)
        self.db.executescript(_SCHEMA)

    def close(self) -> None:
        self.db.close()

    def save_trajectory(self, ttype: int, tag: Optional[str],
                        steps: np.ndarray,
                        traj_id: Optional[int] = None) -> int:
        """``steps``: a 1-D structured array, one record per step; with
        ``traj_id`` the row of that id is replaced. Returns the id
        (saveTrajectory, trajectory_db.hpp:37-39)."""
        row = (ttype, tag, len(steps), str(steps.dtype.descr),
               steps.tobytes())
        cur = self.db.cursor()
        if traj_id is None:
            cur.execute("INSERT INTO trajectories (type, tag, num_steps, "
                        "step_dtype, steps) VALUES (?,?,?,?,?)", row)
        else:
            cur.execute("INSERT OR REPLACE INTO trajectories (id, type, tag, "
                        "num_steps, step_dtype, steps) VALUES (?,?,?,?,?,?)",
                        (traj_id,) + row)
        self.db.commit()
        return cur.lastrowid

    def remove_trajectory(self, traj_id: int) -> None:
        self.db.execute("DELETE FROM trajectories WHERE id = ?", (traj_id,))
        self.db.commit()

    def num_trajectories(self) -> int:
        (n,) = self.db.execute("SELECT COUNT(*) FROM trajectories").fetchone()
        return n

    def trajectory_ids(self) -> List[int]:
        return [r[0] for r in self.db.execute(
            "SELECT id FROM trajectories ORDER BY id").fetchall()]

    def advance_n(self, cur_id: int, n: int = 1) -> int:
        """The id ``n`` rows after ``cur_id``, wrapping
        (advanceNTrajectories, trajectory_db.hpp:45)."""
        ids = self.trajectory_ids()
        if not ids:
            return cur_id
        i = ids.index(cur_id) if cur_id in ids else -1
        return ids[(i + n) % len(ids)]

    def _column(self, traj_id: int, col: str):
        row = self.db.execute(f"SELECT {col} FROM trajectories WHERE id = ?",
                              (traj_id,)).fetchone()
        if row is None:
            raise KeyError(f"no trajectory {traj_id}")
        return row

    def get_steps(self, traj_id: int) -> np.ndarray:
        descr, blob = self._column(traj_id, "step_dtype, steps")
        # the dtype's descr, written by str(): a Python literal
        return np.frombuffer(blob, dtype=np.dtype(ast.literal_eval(descr)))

    def get_type(self, traj_id: int) -> int:
        return self._column(traj_id, "type")[0]

    def get_tag(self, traj_id: int) -> Optional[str]:
        return self._column(traj_id, "tag")[0]

    def __iter__(self) -> Iterator[Tuple[int, np.ndarray]]:
        for tid in self.trajectory_ids():
            yield tid, self.get_steps(tid)


def build_training_set(db: TrajectoryDB, trajectory_ids: Sequence[int],
                       output_path: str) -> int:
    """The selected trajectories' step records, one after another, in one
    raw file (buildTrajectoryTrainingSet, trajectory_db.hpp:52-53).
    Returns the steps written."""
    total = 0
    with open(output_path, "wb") as f:
        for tid in trajectory_ids:
            steps = db.get_steps(tid)
            steps.tofile(f)
            total += len(steps)
    return total


def write_dump_items(path: str, step_ids: np.ndarray,
                     team_ids: np.ndarray) -> None:
    """A DumpItem stream (db.hpp:27-30): the curriculum builder's
    trajectories."""
    out = np.zeros(len(step_ids), dtype=DUMP_ITEM_DTYPE)
    out["step_id"] = step_ids
    out["team_id"] = team_ids
    out.tofile(path)
