"""The port's crossplay eval against the JAX package's EvalManager.run.

Replays the committed fixture tests/fixtures_torch/zone_eval_crossplay.npz
(make_eval_fixture.py: Zone 6v6 on simple_map, 2 worlds, P = 2 seeded
full-width policies, the trained checkpoint's normalizer stats,
episode_len 6, 10 sampled steps in chunks of 5) through
madrona_mp_env_tpu_torch's EvalManager on the CPU, with the same seeds.

Bar: actions equal wherever the fixture's smallest top-two Gumbel margin
exceeds 1e-4 (ATen's and XLA's log and exp differ by an ulp); values and
packed log probs within 1e-4 * max(1, |x|) (float32 forward summed in
another order); rewards within 1e-4 * max(1, |x|) and dones, match
results and team points exact, as in tests/test_torch_slice.py; the final
ELO within 1e-4 relative. Every comparison stops after the first step
where an action differs below the margin (the trajectories part there);
the run must reach the end of the matches (and the ELO update) first.
"""

import os
import sys

import numpy as np
import pytest
import torch

import madrona_mp_env_tpu_torch as mt
from madrona_mp_env_tpu_torch.train import (EvalConfig, EvalManager,
                                            build_actor_critic,
                                            normalizer_from_jax,
                                            params_from_jax)

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "fixtures_torch"))
import make_eval_fixture as fx  # noqa: E402
from policy_weights import random_flax_params  # noqa: E402
from torch_threads import one_thread_under_xdist  # noqa: E402,F401

REL = 1e-4
MARGIN = 1e-4


def _cfg():
    return mt.EnvConfig(task=mt.Task.Zone, team_size=fx.TEAM_SIZE,
                        sim_flags=mt.SimFlags.SimEvalMode,
                        episode_len=fx.EPISODE_LEN)


def _manager(simple_map_dir):
    env = mt.Env(_cfg(), simple_map_dir, num_worlds=fx.NUM_WORLDS,
                 seed=fx.ENV_SEED, device="cpu")
    ecfg = EvalConfig(num_worlds=fx.NUM_WORLDS, num_eval_steps=fx.NUM_STEPS,
                      chunk_steps=fx.CHUNK_STEPS, seed=fx.EVAL_SEED)
    return EvalManager(_cfg(), ecfg, env, fx.NUM_POLICIES, device="cpu")


def _rel_close(name, got, want):
    err = np.abs(got.astype(np.float64) - want)
    tol = REL * np.maximum(1.0, np.abs(want.astype(np.float64)))
    assert np.all(err <= tol), (name, float(err.max()))


def test_eval_matches_jax_fixture(simple_map_dir):
    want = dict(np.load(fx.PATH))
    norm = normalizer_from_jax({
        "mu": {k.split("/")[1]: v for k, v in want.items()
               if k.startswith("norm_mu/")},
        "var": {k.split("/")[1]: v for k, v in want.items()
                if k.startswith("norm_var/")},
        "count": want["norm_count"]})
    policies = [build_actor_critic(sd, device="cpu") for sd in
                params_from_jax(random_flax_params(fx.WEIGHT_SEED,
                                                   fx.NUM_POLICIES))]
    mgr = _manager(simple_map_dir)
    chunks = []
    elo = mgr.run(policies, norm, torch.as_tensor(want["elo0"]),
                  iter_cb=chunks.append, verbose=False)

    def cat(get):
        return np.concatenate([get(c).numpy() for c in chunks])

    got = {
        "actions_discrete": cat(lambda c: c["actions"]["discrete"]),
        "actions_aim": cat(lambda c: c["actions"]["aim"]),
        "values": cat(lambda c: c["values"]),
        "rewards": cat(lambda c: c["rewards"]),
        "dones": cat(lambda c: c["dones"]),
        "logits": cat(lambda c: c["logits"]),
    }
    for k in ("win_result", "team_points", "match_finished"):
        got[k] = cat(lambda c: c["episode_result"][k])

    decided = want["margins"] > MARGIN
    last = fx.NUM_STEPS - 1
    for t in range(fx.NUM_STEPS):
        same = ((got["actions_discrete"][t] == want["actions_discrete"][t])
                .all(-1)
                & (got["actions_aim"][t] == want["actions_aim"][t]).all(-1))
        assert same[decided[t]].all(), f"step {t}: decided actions differ"
        for k in ("values", "logits"):
            _rel_close(f"step {t} {k}", got[k][t], want[k][t])
        _rel_close(f"step {t} rewards", got["rewards"][t], want["rewards"][t])
        for k in ("dones", "win_result", "team_points", "match_finished"):
            assert np.array_equal(got[k][t], want[k][t]), (t, k)
        if not same.all():
            last = t
            break
    ended = np.nonzero(want["match_finished"].any(-1))[0]
    assert ended.size and ended[0] <= last, "no match ended before parting"
    if last == fx.NUM_STEPS - 1:
        _rel_close("elo", elo.numpy(), want["elo"])
    assert not np.array_equal(want["elo"], want["elo0"])


def test_eval_refuses_what_is_not_ported(simple_map_dir, monkeypatch):
    mgr = _manager(simple_map_dir)
    with pytest.raises(NotImplementedError, match="dumps"):
        mgr.run([], None, torch.zeros(2), record_path="x")
    with pytest.raises(NotImplementedError, match="bot"):
        EvalManager(_cfg(), mgr.ecfg, mgr.env, 2, vs_bot=True, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        EvalManager(_cfg(), mgr.ecfg, mgr.env, 2)
