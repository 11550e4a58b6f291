"""A seeded behaviour-cloning dump in the eval's ``--bc-dump-dir`` layout
(per step [P, B / P, ...] blocks, one raw file per key and the ``shapes``
JSON), made with numpy alone, so that the port's BC tests and
make_bc_fixture.py (the JAX package's bc_update_fn on it) read the same
samples. Observations are random_obs's with the lidar planes flat, as
the eval stores them; actions lie in their heads' ranges; the stored
logits are per-head log-softmaxes; recurrent states N(0, 0.25).

    write_bc_dump(out_dir, seed=0, steps=2, num_policies=2, block=40)
"""

from __future__ import annotations

import json
import os

import numpy as np

from policy_weights import HIDDEN, random_obs

BUCKETS = (3, 8, 3, 3, 13, 7)  # the discrete then the aim heads


def write_bc_dump(out_dir: str, seed: int = 0, steps: int = 2,
                  num_policies: int = 2, block: int = 40) -> int:
    """Write the dump; returns its sample count steps * P * block."""
    os.makedirs(out_dir, exist_ok=True)
    g = np.random.default_rng(seed)
    S, P, BP = steps, num_policies, block
    n = S * P * BP
    obs = random_obs(seed + 1, n)
    for k in ("fwd_lidar", "rear_lidar"):
        obs[k] = obs[k].reshape(n, -1)
    actions = np.stack([g.integers(0, b, n) for b in BUCKETS],
                       -1).astype(np.int32)
    logits = []
    for b in BUCKETS:
        x = g.standard_normal((n, b)).astype(np.float32)
        x = x - x.max(-1, keepdims=True)
        logits.append(x - np.log(np.exp(x).sum(-1, keepdims=True)))
    files = {**{k: obs[k] for k in sorted(obs)}, "actions": actions,
             "action_logits": np.concatenate(logits, -1).astype(np.float32),
             "rewards": g.standard_normal(n).astype(np.float32)}
    meta = {"obs": {k: [P, BP] + list(obs[k].shape[1:]) for k in sorted(obs)}}
    for k in ("actions", "action_logits", "rewards"):
        meta[k] = [P, BP] + list(files[k].shape[1:])
    files["rnn_states"] = (0.5 * g.standard_normal(
        (S, 2, 2, P, BP, HIDDEN))).astype(np.float32)
    meta["rnn_states"] = [2, 2, P, BP, HIDDEN]
    with open(os.path.join(out_dir, "shapes"), "w") as f:
        json.dump(meta, f)
    for k, v in files.items():
        v.tofile(os.path.join(out_dir, k))
    return n
