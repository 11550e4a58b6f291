"""Event-mask tokens per 40-step window -> the analytics DB's step_tokens
table (the JAX package's tools/tokenize_steps.py, the reference's
scripts/tokenize_steps.py): for each match, OR the per-step event masks
over 40-step windows and insert one token row per window.

    python -m madrona_mp_env_tpu_torch.tools.tokenize_steps <db.sqlite>
"""

from __future__ import annotations

import sqlite3
import sys

WINDOW = 40  # steps per token (tokenize_steps.py:17)


def tokenize(db_path: str, window: int = WINDOW, verbose: bool = True) -> int:
    """Rewrite step_tokens from match_steps; returns the rows inserted. A
    window closes when a step lies ``window`` or more steps past its start
    or another match begins; the last window of the table is not
    written, as in the reference."""
    con = sqlite3.connect(db_path)
    cur = con.cursor()

    rows = cur.execute(
        "SELECT match_id, step_idx, event_mask FROM match_steps "
        "ORDER BY match_id, step_idx;"
    ).fetchall()
    cur.execute("DELETE FROM step_tokens;")

    if not rows:
        con.commit()
        return 0

    cur_match_id = rows[0][0]
    cur_step_idx = 0
    cur_mask = 0
    n = 0
    for match_id, step_idx, event_mask in rows:
        if step_idx - cur_step_idx >= window or match_id != cur_match_id:
            if verbose:
                print(cur_match_id, cur_step_idx, cur_mask)
            cur.execute(
                "INSERT INTO step_tokens (match_id, tick, token) "
                "VALUES (?, ?, ?)",
                (cur_match_id, cur_step_idx, cur_mask),
            )
            n += 1
            cur_match_id = match_id
            cur_step_idx = step_idx
            cur_mask = 0
        cur_mask |= event_mask

    con.commit()
    con.close()
    return n


if __name__ == "__main__":
    tokenize(sys.argv[1])
