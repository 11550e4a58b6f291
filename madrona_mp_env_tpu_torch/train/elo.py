"""ELO rating updates over the policy slots (the JAX package's
train/elo.py): the crossplay eval, the trainer's matches and the PBT
eval fold each finished match into the ratings of the two slots that
played it."""

from __future__ import annotations

import numpy as np
import torch


def expected_score(r_a, r_b):
    """1 / (1 + 10^((r_b - r_a) / 400)), the division taken as XLA takes
    it under jit (and ATen on CUDA): times float32(1 / 400)."""
    return 1.0 / (1.0 + 10.0 ** ((r_b - r_a) * 0.0025))


def elo_update(ratings, match_pairs, scores, k: float = 32.0):
    """ratings [E]; match_pairs [M, 2] policy indices; scores [M] score of
    match_pairs[:, 0] in [0, 1]. Every match counts."""
    return elo_update_masked(ratings, match_pairs, scores,
                             torch.ones_like(scores, dtype=torch.bool), k)


def elo_update_masked(ratings, pairs, scores, valid, k: float = 32.0):
    """ratings [E]; pairs [M, 2] policy indices; scores [M] score of
    pairs[:, 0]; valid [M] bool (matches that finished). The deltas are
    added into a copy of the ratings with index_add_, first side then
    second: in index order on the CPU, as jitted XLA scatters them into
    the ratings on the CPU; by atomics on CUDA."""
    pairs = pairs.long()
    ea = expected_score(ratings[pairs[:, 0]], ratings[pairs[:, 1]])
    delta = torch.where(valid, k * (scores - ea), 0.0)
    out = ratings.clone()
    out.index_add_(0, pairs[:, 0], delta)
    out.index_add_(0, pairs[:, 1], -delta)
    return out


def accumulate_match_scores(win_results, team_policies):
    """Finished-match outcomes -> (pairs, scores, valid): win_results [N]
    (-1 unfinished, 0 / 1 the winning team, 2 a draw), team_policies [N,
    2] the policy of each team; scores 1 / 0 / 0.5 for team 0, valid
    where a match finished."""
    score_a = torch.where(win_results == 0, 1.0,
                          torch.where(win_results == 1, 0.0, 0.5))
    return team_policies, score_a, win_results >= 0


def print_elos(elos) -> None:
    """Per-policy ELO ratings (reference scripts/common.py print_elos)."""
    print("ELO:")
    for i, e in enumerate(np.asarray(elos).reshape(-1)):
        print(f"  policy {i}: {float(e):.1f}")
