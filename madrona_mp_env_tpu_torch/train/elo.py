"""ELO rating updates over the policy ensemble (the JAX package's
train/elo.py): the crossplay eval folds each finished match into the
ratings of the two policies that played it."""

from __future__ import annotations

import torch


def expected_score(r_a, r_b):
    return 1.0 / (1.0 + 10.0 ** ((r_b - r_a) / 400.0))


def elo_update_masked(ratings, pairs, scores, valid, k: float = 32.0):
    """ratings [E]; pairs [M, 2] policy indices; scores [M] score of
    pairs[:, 0]; valid [M] bool (matches that finished). The deltas are
    added into the ratings with index_add_, first side then second."""
    pairs = pairs.long()
    ea = expected_score(ratings[pairs[:, 0]], ratings[pairs[:, 1]])
    delta = torch.where(valid, k * (scores - ea), 0.0)
    updates = torch.zeros_like(ratings)
    updates.index_add_(0, pairs[:, 0], delta)
    updates.index_add_(0, pairs[:, 1], -delta)
    return ratings + updates
