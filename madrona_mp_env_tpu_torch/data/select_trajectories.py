"""Pick trajectory windows out of the analytics DB by their events.

The headless counterpart of the reference viewer's analytics filters and
its stepID dump (src/viz.cpp:1229-1348, :1644), as the JAX package's
data/select_trajectories.py: fixed-length windows of match steps whose
event masks meet a filter, written as a DumpItem stream for
data/build_trajectory_curriculum.py.

    python -m madrona_mp_env_tpu_torch.data.select_trajectories \\
        <db.sqlite> <out.bin> --event-mask 4 --window 100 --max 50
"""

from __future__ import annotations

import argparse
import sqlite3

import numpy as np

from .trajectory_db import write_dump_items


def select_windows(db_path: str, event_mask: int = 0, window: int = 100,
                   max_windows: int = 100, team_id: int = 0,
                   min_hits: int = 1):
    """Non-overlapping windows of ``window`` match steps, match by match,
    with at least ``min_hits`` steps whose event_mask meets
    ``event_mask`` (0: every window); a window that falls short moves on
    by a quarter window (at least a step: the JAX package's loop stays in
    place forever for windows under 4). Returns (step_ids [N * window],
    team_ids [N * window])."""
    db = sqlite3.connect(db_path)
    windows = []
    for match_id, _ in db.execute(
            "SELECT id, num_steps FROM matches").fetchall():
        if len(windows) >= max_windows:
            break
        rows = db.execute(
            "SELECT id, event_mask FROM match_steps WHERE match_id = ? "
            "ORDER BY step_idx", (match_id,)).fetchall()
        if len(rows) < window:
            continue
        ids = np.asarray([r[0] for r in rows], np.int64)
        masks = np.asarray([r[1] for r in rows], np.int64)
        hit = (np.ones_like(masks, bool) if event_mask == 0
               else (masks & event_mask) != 0)
        csum = np.concatenate([[0], np.cumsum(hit.astype(np.int64))])
        start = 0
        while start + window <= len(ids) and len(windows) < max_windows:
            if csum[start + window] - csum[start] >= min_hits:
                windows.append(ids[start:start + window])
                start += window
            else:
                start += max(window // 4, 1)
    db.close()
    if not windows:
        return np.zeros((0,), np.int64), np.zeros((0,), np.int64)
    step_ids = np.concatenate(windows)
    return step_ids, np.full_like(step_ids, team_id)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("db")
    ap.add_argument("out")
    ap.add_argument("--event-mask", type=int, default=0,
                    help="bitmask: 1 capture, 2 reload, 4 kill, 8 shot")
    ap.add_argument("--window", type=int, default=100)
    ap.add_argument("--max", type=int, default=100)
    ap.add_argument("--team", type=int, default=0)
    ap.add_argument("--min-hits", type=int, default=1)
    args = ap.parse_args(argv)
    step_ids, team_ids = select_windows(args.db, args.event_mask,
                                        args.window, args.max, args.team,
                                        args.min_hits)
    write_dump_items(args.out, step_ids, team_ids)
    print(f"{len(step_ids) // max(args.window, 1)} windows "
          f"({len(step_ids)} steps) -> {args.out}")


if __name__ == "__main__":
    main()
