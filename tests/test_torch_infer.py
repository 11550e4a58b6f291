"""The port's eval against the JAX package's EvalManager.run.

Replays the committed fixture tests/fixtures_torch/zone_eval_crossplay.npz
(make_eval_fixture.py: Zone 6v6 on simple_map, 2 worlds, P = 2 seeded
full-width policies, the trained checkpoint's normalizer stats,
episode_len 6, 10 sampled steps in chunks of 5) through
madrona_mp_env_tpu_torch's EvalManager on the CPU, with the same seeds;
then its vs-bot variant zone_eval_vs_bot.npz (``--vs-bot``: team 1 the
scripted bot, world w policy w % P) through EvalManager(vs_bot=True) and
through the eval CLI, where besides the bars below the win/draw/loss
counts are exact, the ELO stays as given and team 1's policy idx is -1.

Bar: actions equal wherever the fixture's smallest top-two Gumbel margin
exceeds 1e-4 (ATen's and XLA's log and exp differ by an ulp); values and
packed log probs within 1e-4 * max(1, |x|) (float32 forward summed in
another order); rewards within 1e-4 * max(1, |x|) and dones, match
results and team points exact, as in tests/test_torch_slice.py; the final
ELO within 1e-4 relative. Every comparison stops after the first step
where an action differs below the margin (the trajectories part there);
the run must reach the end of the matches (and the ELO update) first.
"""

import functools
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
from madrona_mp_env_tpu_torch.train import infer
from madrona_mp_env_tpu_torch.train.convert import flatten
from madrona_mp_env_tpu_torch.train.infer import tally_vs_bot

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


def _manager(simple_map_dir, vs_bot=False):
    env = mt.Env(_cfg(), simple_map_dir, num_worlds=fx.NUM_WORLDS,
                 seed=fx.ENV_SEED, device="cpu")
    ecfg = EvalConfig(num_worlds=fx.NUM_WORLDS, num_eval_steps=fx.NUM_STEPS,
                      chunk_steps=fx.CHUNK_STEPS, seed=fx.EVAL_SEED)
    return EvalManager(_cfg(), ecfg, env, fx.NUM_POLICIES, vs_bot=vs_bot,
                       device="cpu")


def _rel_close(name, got, want):
    err = np.abs(got.astype(np.float64) - want)
    tol = REL * np.maximum(1.0, np.abs(want.astype(np.float64)))
    assert np.all(err <= tol), (name, float(err.max()))


def _normalizer(want):
    return normalizer_from_jax({
        "mu": {k.split("/")[1]: v for k, v in want.items()
               if k.startswith("norm_mu/")},
        "var": {k.split("/")[1]: v for k, v in want.items()
                if k.startswith("norm_var/")},
        "count": want["norm_count"]})


def _policies():
    return [build_actor_critic(sd, device="cpu") for sd in
            params_from_jax(random_flax_params(fx.WEIGHT_SEED,
                                               fx.NUM_POLICIES))]


def _replay(mgr, want, policies=None, norm=None):
    """Run ``mgr`` with the fixture's weights, stats and ELO: (recorded
    outputs in the fixture's layout, final ELO)."""
    chunks = []
    elo = mgr.run(policies or _policies(), norm or _normalizer(want),
                  torch.as_tensor(want["elo0"]), iter_cb=chunks.append,
                  verbose=False)
    return _record(chunks), elo


def _record(chunks):
    """A run's chunks in the fixture's layout."""
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
    return got


def _compare(got, want):
    """The bars above, up to the first step where an action differs below
    the margin; returns that step (the last one if none)."""
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
    return last


def test_eval_matches_jax_fixture(simple_map_dir):
    want = dict(np.load(fx.PATH))
    got, elo = _replay(_manager(simple_map_dir), want)
    last = _compare(got, want)
    if last == fx.NUM_STEPS - 1:
        _rel_close("elo", elo.numpy(), want["elo"])
    assert not np.array_equal(want["elo"], want["elo0"])


def test_eval_vs_bot_matches_jax_fixture(simple_map_dir):
    want = dict(np.load(fx.VS_BOT_PATH))
    mgr = _manager(simple_map_dir, vs_bot=True)
    assert np.array_equal(mgr.init_state()[0].policy_idx.numpy(),
                          want["policy_idx"])
    got, elo = _replay(mgr, want)
    assert _compare(got, want) == fx.NUM_STEPS - 1
    assert np.array_equal(mgr.vs_bot_wdl, want["vs_bot_wdl"])
    assert mgr.vs_bot_wdl.sum() == want["match_finished"].sum()
    assert np.array_equal(elo.numpy(), want["elo0"])
    assert np.array_equal(want["elo"], want["elo0"])


def test_vs_bot_tally_columns():
    """win_result 0 (team 0, the policy, won) -> wins, 2 -> draws, 1 ->
    losses; unfinished matches and win_result -1 are not counted."""
    wdl = np.zeros((2, 3), np.int64)
    win = np.array([[0, 1, 2, 0], [2, -1, 0, 1]])
    finished = np.array([[True, True, True, False], [True, True, True,
                                                      True]])
    tally_vs_bot(wdl, win, finished, np.array([0, 1, 0, 1]))
    assert wdl.tolist() == [[2, 2, 0], [0, 0, 2]]


def test_eval_cli_vs_bot_matches_fixture(simple_map_dir, tmp_path,
                                         monkeypatch, capsys):
    """The CLI with --cpu --vs-bot on an export_policy.py-layout .npz of
    the fixture's weights: the same run as above, the counts printed."""
    want = dict(np.load(fx.VS_BOT_PATH))
    tree = {"params": random_flax_params(fx.WEIGHT_SEED, fx.NUM_POLICIES),
            "normalizer": {
                "mu": {k.split("/")[1]: v for k, v in want.items()
                       if k.startswith("norm_mu/")},
                "var": {k.split("/")[1]: v for k, v in want.items()
                        if k.startswith("norm_var/")},
                "count": want["norm_count"]},
            "elo": want["elo0"]}
    path = str(tmp_path / "policy.npz")
    np.savez(path, **flatten(tree))
    # the fixture's env seed, episode length and eval chunks
    monkeypatch.setattr(infer, "EvalConfig", functools.partial(
        EvalConfig, chunk_steps=fx.CHUNK_STEPS, seed=fx.EVAL_SEED))
    monkeypatch.setattr(infer, "EnvConfig", functools.partial(
        mt.EnvConfig, episode_len=fx.EPISODE_LEN))
    monkeypatch.setattr(infer, "Env", functools.partial(
        _env_with_seed, fx.ENV_SEED))
    monkeypatch.setattr(infer, "EvalManager", _Recording)
    mgr, elo = infer.main([
        "--cpu", "--vs-bot", "--num-worlds", str(fx.NUM_WORLDS),
        "--num-steps", str(fx.NUM_STEPS), "--team-size", str(fx.TEAM_SIZE),
        "--scene", simple_map_dir, "--ckpt-path", path])
    assert mgr.vs_bot and mgr.device.type == "cpu"
    assert _compare(_record(mgr.chunks), want) == fx.NUM_STEPS - 1
    assert np.array_equal(mgr.vs_bot_wdl, want["vs_bot_wdl"])
    assert np.array_equal(elo.numpy(), want["elo0"])
    out = capsys.readouterr().out
    assert "policy 0 vs bot: 0W/1D/0L" in out and "policy 1: 1550.0" in out


class _Recording(EvalManager):
    """EvalManager that keeps the chunks its run hands iter_cb."""

    def run(self, *args, **kw):
        self.chunks = []
        return super().run(*args, iter_cb=self.chunks.append, **kw)


def _env_with_seed(env_seed, cfg, scene, num_worlds, seed, device,
                   collect_log=False):
    return mt.Env(cfg, scene, num_worlds, seed=env_seed, device=device,
                  collect_log=collect_log)


@pytest.mark.parametrize("flag", ["--bf16", "--fp16"])
def test_eval_cli_runs_low_precision(flag, simple_map_dir, tmp_path,
                                     monkeypatch):
    """--bf16 / --fp16: the policies computing in that dtype on the
    fixture's weights, crossplay at 2 worlds x 10 steps (episode_len 6,
    so matches end): finite values, log probs and ELO."""
    want = dict(np.load(fx.PATH))
    tree = {"params": random_flax_params(fx.WEIGHT_SEED, fx.NUM_POLICIES),
            "normalizer": {
                "mu": {k.split("/")[1]: v for k, v in want.items()
                       if k.startswith("norm_mu/")},
                "var": {k.split("/")[1]: v for k, v in want.items()
                        if k.startswith("norm_var/")},
                "count": want["norm_count"]},
            "elo": want["elo0"]}
    path = str(tmp_path / "policy.npz")
    np.savez(path, **flatten(tree))
    monkeypatch.setattr(infer, "EnvConfig", functools.partial(
        mt.EnvConfig, episode_len=fx.EPISODE_LEN))
    monkeypatch.setattr(infer, "EvalManager", _Recording)
    mgr, elo = infer.main([
        "--cpu", "--num-worlds", str(fx.NUM_WORLDS), "--num-steps", "10",
        "--team-size", str(fx.TEAM_SIZE), "--scene", simple_map_dir,
        "--ckpt-path", path, flag])
    dtype = torch.bfloat16 if flag == "--bf16" else torch.float16
    assert mgr.ecfg.policy_dtype == dtype
    got = _record(mgr.chunks)
    assert np.isfinite(got["values"]).all() and np.isfinite(
        got["logits"]).all()
    ended = got["match_finished"] & (got["win_result"] >= 0)
    assert ended.any()
    assert np.isfinite(elo.numpy()).all()


def test_eval_refuses_what_is_not_ported(simple_map_dir, monkeypatch):
    """The eval runs on the card unless asked for the CPU (the dumps are
    ported: tests/test_torch_record.py)."""
    mgr = _manager(simple_map_dir)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        EvalManager(_cfg(), mgr.ecfg, mgr.env, 2)
