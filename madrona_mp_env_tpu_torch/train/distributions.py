"""Multi-head discrete action distributions.

The counterpart of the JAX package's train/distributions.py: a set of
independent categorical heads over one feature vector, with the head
logits kept packed in one [..., sum(buckets)] tensor. Sampling is
Gumbel-max with its noise drawn from the port's threefry (utils/rng.py)
in the JAX key stream, so a fixed key gives the JAX package's actions up
to ulp-level differences in log/exp.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from ..utils import rng

DISCRETE_BUCKETS = (3, 8, 3, 3)  # moveAmount, moveAngle, fire, stand
AIM_BUCKETS = (13, 7)  # yaw, pitch


def gumbel(key: torch.Tensor, shape, counters=None) -> torch.Tensor:
    """jax.random.gumbel(key, shape, float32) in its default ("low") mode:
    -log(-log(u)), u uniform in [tiny, 1); ``counters``: the elements of
    that draw to take (rng.random_bits)."""
    tiny = torch.finfo(torch.float32).tiny
    u = rng.uniform(key, shape, minval=tiny, maxval=1.0, counters=counters)
    return -torch.log(-torch.log(u))


@dataclass
class DiscreteActionDistributions:
    """logits: one packed [..., S] tensor, S = sum(buckets)."""

    logits: torch.Tensor
    buckets: Tuple[int, ...]

    def _segments(self):
        off = 0
        for b in self.buckets:
            yield off, b
            off += b

    def offsets(self) -> torch.Tensor:
        offs = [o for o, _ in self._segments()]
        return torch.tensor(offs, dtype=torch.int64, device=self.logits.device)

    def packed_log_probs(self) -> torch.Tensor:
        """Per-head log-softmax, packed [..., S]: x - max, then minus the
        log of the sum of exp, head by head."""
        x = self.logits
        shifted = torch.cat(
            [x[..., o:o + b] - x[..., o:o + b].amax(-1, keepdim=True)
             for o, b in self._segments()], dim=-1)
        e = torch.exp(shifted)
        lse = torch.cat(
            [torch.log(e[..., o:o + b].sum(-1, keepdim=True)).expand(
                e[..., o:o + b].shape) for o, b in self._segments()], dim=-1)
        return shifted - lse

    def _argmax_heads(self, z: torch.Tensor) -> torch.Tensor:
        return torch.stack([z[..., o:o + b].argmax(-1)
                            for o, b in self._segments()],
                           dim=-1).to(torch.int32)

    def sample(self, key: torch.Tensor, rows=None):
        """Gumbel-max per head from one packed noise draw. Returns
        (actions [..., H] int32, total log_prob [...]). ``rows`` [N]: the
        logits [N, S] are rows ``rows`` of a global [R, S] whose noise
        the key draws (a data-parallel rank's share of the blocks)."""
        lp = self.packed_log_probs()
        if rows is None:
            noise = gumbel(key, self.logits.shape)
        else:
            S = self.logits.shape[-1]
            noise = gumbel(key, None, rows[:, None] * S + torch.arange(
                S, dtype=torch.int64, device=rows.device))
        actions = self._argmax_heads(lp + noise)
        alp = torch.gather(lp, -1, actions.long() + self.offsets())
        return actions, alp.sum(-1)

    def best(self) -> torch.Tensor:
        return self._argmax_heads(self.logits)

    def action_stats(self, actions: torch.Tensor):
        """actions [..., H] -> (log_prob [...], entropy [...])."""
        lp = self.packed_log_probs()
        alp = torch.gather(lp, -1, actions.long() + self.offsets())
        ent = -(torch.exp(lp) * lp).sum(-1)
        return alp.sum(-1), ent


@dataclass
class ActorDistributions:
    """The two action groups of the env policy: 'discrete'
    (move/fire/stand) and 'aim' (yaw/pitch buckets)."""

    discrete: DiscreteActionDistributions
    aim: DiscreteActionDistributions

    def sample(self, key: torch.Tensor, rows=None):
        """The JAX stream: split the key in two, discrete draws from the
        first and aim from the second (``rows``: as
        DiscreteActionDistributions.sample)."""
        k = rng.split(key, 2)
        da, dlp = self.discrete.sample(k[0], rows)
        aa, alp = self.aim.sample(k[1], rows)
        return {"discrete": da, "aim": aa}, {"discrete": dlp, "aim": alp}

    def best(self):
        return {"discrete": self.discrete.best(), "aim": self.aim.best()}

    def action_stats(self, actions):
        dlp, dent = self.discrete.action_stats(actions["discrete"])
        alp, aent = self.aim.action_stats(actions["aim"])
        return ({"discrete": dlp, "aim": alp},
                {"discrete": dent, "aim": aent})
