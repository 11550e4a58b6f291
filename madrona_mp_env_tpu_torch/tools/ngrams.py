"""Top event-token n-grams across matches (the JAX package's
tools/ngrams.py, the reference's scripts/ngrams.py): count the 5-grams of
each match's step_tokens and print the 30 most frequent.

    python -m madrona_mp_env_tpu_torch.tools.ngrams <db.sqlite>
"""

from __future__ import annotations

import sqlite3
import sys
from collections import Counter

NGRAM_LENGTH = 5  # ngrams.py:11
TOP_K = 30


def top_ngrams(db_path: str, n: int = NGRAM_LENGTH, top_k: int = TOP_K):
    """(the n-grams counted, the ``top_k`` most common as (tuple, count)),
    ties in first-seen order. As in the reference, a match of L tokens
    gives L - n n-grams (its last is not counted)."""
    con = sqlite3.connect(db_path)
    cur = con.cursor()
    matches = cur.execute(
        "SELECT DISTINCT match_id FROM step_tokens"
    ).fetchall()

    counts: Counter = Counter()
    total = 0
    for (match_id,) in matches:
        tokens = [
            r[0]
            for r in cur.execute(
                "SELECT token FROM step_tokens WHERE match_id = ? "
                "ORDER BY tick;",
                (match_id,),
            ).fetchall()
        ]
        for start in range(0, len(tokens) - n):
            counts[tuple(tokens[start : start + n])] += 1
            total += 1
    con.close()
    return total, counts.most_common(top_k)


if __name__ == "__main__":
    total, top = top_ngrams(sys.argv[1])
    print(total)
    for ngram, count in top:
        print(f"{ngram}: {count}")
