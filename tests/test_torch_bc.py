"""Behaviour cloning end to end and the DB's token tools, against the JAX
package, on the CPU.

- An eval run of the port (2 worlds, Zone 2v2, 20 steps in chunks of 10,
  two seeded policies) writes the event log and the BC dump; the DB
  (data/build_db.py) and two trajectory windows of SEQ steps
  (select_windows) come from it. ``load_bc_data`` reads the dump (step
  blocks) and the dataset tool's BC set (sequences) into arrays equal to
  the JAX function's; the dataset tool's BC and KL files are byte-equal
  to the JAX tool's on the same DB, items and dump.
- One BC epoch of 2 minibatches at E = 2 (run_bc from a checkpoint file,
  float32, lr 0.01) on fixtures_torch/bc_data.py's seeded dump, kl_coef
  0 and 0.1, against fixtures_torch/bc_jax.npz (make_bc_fixture.py: the
  JAX bc_update_fn on the same weights and samples): the epoch's order
  equal, each minibatch's bc_loss within 1e-5 * max(1, |x|) (measured
  9.5e-7 on the first minibatch, 2.5e-5 of 22.85 on the second: after one
  Adam step at lr 0.01, gradients near zero can part in sign), and of the
  parameters' change (a digest: sampled elements and per-leaf sums) at
  least 95% of the samples within 0.5 lr of JAX's (measured 100%) and
  each leaf's summed change within 0.01 lr x its element count (measured
  1.1e-3).
- The CLI from a TrainingManager checkpoint writes
  ``<out-run-name>/<update>.pt``, which restore_ckpt resumes PPO from.
- tokenize_steps' step_tokens rows, ngrams' top 30 and print_assignments'
  output equal the JAX tools' on the same DB or arguments.
"""

import os
import shutil
import sqlite3
import sys

import numpy as np
import pytest
import torch

from madrona_mp_env_tpu.tools import build_trajectory_training_dataset as jbt
from madrona_mp_env_tpu.tools import ngrams as jngrams
from madrona_mp_env_tpu.tools import print_assignments as jprint
from madrona_mp_env_tpu.tools import tokenize_steps as jtok
from madrona_mp_env_tpu.train import bc as jbc

import madrona_mp_env_tpu_torch as mt
from madrona_mp_env_tpu_torch.data import build_db
from madrona_mp_env_tpu_torch.data.select_trajectories import select_windows
from madrona_mp_env_tpu_torch.data.trajectory_db import write_dump_items
from madrona_mp_env_tpu_torch.tools import build_trajectory_training_dataset \
    as tbt
from madrona_mp_env_tpu_torch.tools import ngrams, print_assignments
from madrona_mp_env_tpu_torch.tools import tokenize_steps
from madrona_mp_env_tpu_torch.train import (EvalConfig, EvalManager,
                                            PPOConfig, TrainConfig,
                                            TrainingManager,
                                            build_actor_critic,
                                            init_normalizer, params_from_jax)
from madrona_mp_env_tpu_torch.train import bc

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "fixtures_torch"))
import make_bc_fixture as bfx  # noqa: E402
from bc_data import write_bc_dump  # noqa: E402
from make_train_fixture import sample_index  # noqa: E402
from policy_weights import random_flax_params  # noqa: E402
from torch_threads import one_thread_under_xdist  # noqa: E402,F401

W, TS, STEPS, SEQ = 2, 2, 20, 5
LOSS_BAR = 1e-5
SUM_BAR = 0.01  # x lr x the leaf's elements


@pytest.fixture(scope="module")
def pipeline(tmp_path_factory, simple_map_dir):
    """The eval's dumps, the DB, the items and both tools' datasets."""
    out = tmp_path_factory.mktemp("bc_pipeline")
    cfg = mt.EnvConfig(task=mt.Task.Zone, team_size=TS,
                       sim_flags=mt.SimFlags.SimEvalMode)
    env = mt.Env(cfg, simple_map_dir, num_worlds=W, device="cpu",
                 collect_log=True)
    mgr = EvalManager(cfg, EvalConfig(num_worlds=W, num_eval_steps=STEPS,
                                      chunk_steps=10), env, 2, device="cpu")
    policies = [build_actor_critic(seed=s, device="cpu") for s in (0, 1)]
    _, obs, _ = mgr.init_state()
    mgr.run(policies, init_normalizer(mgr._policy_obs(obs)),
            torch.full((2,), 1500.0), event_log_dir=str(out / "events"),
            bc_dump_dir=str(out / "dump"), verbose=False)
    db = str(out / "analytics.db")
    build_db.build_db(str(out / "events"), db)
    step_ids, team_ids = select_windows(db, 0, SEQ, 2)
    items = str(out / "items.bin")
    write_dump_items(items, step_ids, team_ids)
    for tool, tag in ((tbt, ""), (jbt, "jax_")):
        tool.build(db, items, str(out / "dump"), str(out / f"{tag}bc"),
                   str(out / f"{tag}kl"), W, team_size=TS, seq_len=SEQ)
    return out


@pytest.mark.parametrize("layout", ["dump", "bc"])
def test_load_bc_data_matches_jax(pipeline, layout):
    want = jbc.load_bc_data(str(pipeline / layout))
    got = bc.load_bc_data(str(pipeline / layout), device="cpu")
    n = {"dump": STEPS * W * 2 * TS, "bc": 2 * SEQ * TS}[layout]
    assert got["actions"].shape == (n, 6)
    assert got["rnn_states"].shape == (n, 2, 2, 512)
    for k in ("actions", "action_logits", "rewards", "rnn_states"):
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    assert set(got["obs"]) == set(want["obs"]) and len(want["obs"]) == 13
    for k, v in want["obs"].items():
        np.testing.assert_array_equal(got["obs"][k].numpy(), v, err_msg=k)


@pytest.mark.parametrize("which", ["bc", "kl"])
def test_dataset_files_match_jax(pipeline, which):
    names = sorted(os.listdir(pipeline / which))
    assert names == sorted(os.listdir(pipeline / f"jax_{which}"))
    assert len(names) == 13 + 5
    for n in names:
        got = (pipeline / which / n).read_bytes()
        assert got and got == (pipeline / f"jax_{which}" / n).read_bytes(), n
    # the KL set: 10x the BC set's trajectories, or every one left over
    rows = os.path.getsize(pipeline / which / "rewards") // 4
    assert rows == {"bc": 2, "kl": (W * STEPS // SEQ - 2)}[which] * SEQ * TS


def _ckpt(path, params, update_idx=3):
    torch.save({"params": params, "update_idx": update_idx}, path)
    return path


@pytest.mark.parametrize("kl_coef", bfx.KL_COEFS)
def test_bc_epoch_matches_jax(tmp_path, kl_coef):
    fx = np.load(bfx.PATH)
    prefix = f"kl{kl_coef}/"
    write_bc_dump(str(tmp_path / "dump"), bfx.DATA_SEED, bfx.STEPS, 2,
                  bfx.BLOCK)
    params0 = params_from_jax(random_flax_params(bfx.WEIGHT_SEED, bfx.E))
    run = bc.run_bc(_ckpt(str(tmp_path / "in.pt"), params0),
                    str(tmp_path / "out"), str(tmp_path / "dump"),
                    lr=bfx.LR, num_epochs=1, minibatch_size=bfx.MB,
                    kl_coef=kl_coef, seed=bfx.SEED, device="cpu",
                    verbose=False)
    assert run.losses.shape == (1, 2, bfx.E)
    want = fx[prefix + "bc_loss"]
    err = np.abs(run.losses[0] - want)
    assert np.all(err <= LOSS_BAR * np.maximum(1.0, np.abs(want))), err
    assert run.path == str(tmp_path / "out" / "3.pt")
    close, total = 0, 0
    for e in range(bfx.E):
        for k, p0 in params0[e].items():
            d = (run.params[e][k] - p0).reshape(-1)
            want = fx[f"{prefix}delta{e}/{k}"]
            got = d[torch.as_tensor(sample_index(k, d.numel()))].numpy()
            close += int((np.abs(got - want) <= 0.5 * bfx.LR).sum())
            total += want.size
            s = d.double().sum().item()
            assert abs(s - fx[f"{prefix}sum{e}/{k}"]) <= \
                SUM_BAR * bfx.LR * d.numel(), k
    assert close >= 0.95 * total, close / total


def test_bc_epoch_order_matches_jax():
    """run_bc's epoch order: PRNGKey(seed), split, permutation, [E, N/E]."""
    from madrona_mp_env_tpu_torch.utils import rng

    fx = np.load(bfx.PATH)
    n = bfx.STEPS * 2 * bfx.BLOCK
    _, sub = rng.split(rng.prng_key(bfx.SEED), 2)
    order = rng.permutation(sub, n).reshape(bfx.E, -1).numpy()
    for kl in bfx.KL_COEFS:
        np.testing.assert_array_equal(order, fx[f"kl{kl}/order"])


def test_bc_cli_writes_a_resumable_checkpoint(pipeline, tmp_path,
                                              simple_map_dir):
    cfg = mt.EnvConfig(task=mt.Task.Zone, team_size=TS)
    tcfg = TrainConfig(num_worlds=1, steps_per_update=2, num_bptt_chunks=1,
                       ppo=PPOConfig(num_epochs=1, num_minibatches=1))
    env = mt.Env(cfg, simple_map_dir, num_worlds=1, device="cpu")
    mgr = TrainingManager(cfg, tcfg, env, device="cpu")
    ts = mgr.init()
    ckpts = tmp_path / "ckpts"
    mgr.save_ckpt(ts, str(ckpts / "run"))
    run = bc.main(["--cpu", "--ckpt-dir", str(ckpts), "--in-run-name", "run",
                   "--out-run-name", "run-bc", "--start-update", "0",
                   "--bc-data-dir", str(pipeline / "bc"), "--kl-data-dir",
                   str(pipeline / "kl"), "--num-epochs", "2",
                   "--minibatch-size", "16", "--kl-coef", "0.1"])
    assert run.path == str(ckpts / "run-bc" / "0.pt")
    assert run.losses.shape == (2, 1, 1) and np.isfinite(run.losses).all()
    back = mgr.restore_ckpt(ts, run.path)
    for k, v in run.params[0].items():
        assert torch.equal(back.params[0][k], v)
        assert torch.equal(back.opt_state[0].mu[k], ts.opt_state[0].mu[k])
    # BC moves the actor and leaves the critic (no gradient) alone
    for k in ("actor_head_discrete.dense.weight", "actor_rnn.x_proj.weight"):
        assert not torch.equal(run.params[0][k], ts.params[0][k]), k
    for k in ("critic_head.dense.weight", "critic_rnn.x_proj.weight"):
        assert torch.equal(run.params[0][k], ts.params[0][k]), k
    ts2, metrics = mgr.update_iter(back)
    assert ts2.update_idx == 1
    assert np.isfinite(metrics["loss"].numpy()).all()


def test_bc_refuses_samples_not_divisible_by_policies(tmp_path):
    write_bc_dump(str(tmp_path / "dump"), 0, 1, 1, 3)  # 3 samples
    params = params_from_jax(random_flax_params(0, 2))
    with pytest.raises(ValueError, match="divisible"):
        bc.run_bc(_ckpt(str(tmp_path / "in.pt"), params),
                  str(tmp_path / "out"), str(tmp_path / "dump"),
                  num_epochs=1, device="cpu", verbose=False)


# ------------------------------------------------------ the token tools

def _token_db(path):
    """match_steps of 3 matches x 800 steps, sparse seeded event masks,
    and an empty step_tokens table (the JAX test's schema)."""
    g = np.random.default_rng(3)
    con = sqlite3.connect(path)
    con.executescript(
        "CREATE TABLE match_steps (id INTEGER PRIMARY KEY AUTOINCREMENT, "
        "match_id INTEGER, step_idx INTEGER, event_mask INTEGER);"
        "CREATE TABLE step_tokens (id INTEGER PRIMARY KEY AUTOINCREMENT, "
        "match_id INTEGER, tick INTEGER, token INTEGER);")
    rows = [(m, s, int(g.choice([0, 1, 2, 4, 8], p=[0.9, 0.025, 0.025,
                                                    0.025, 0.025])))
            for m in (1, 2, 3) for s in range(800)]
    con.executemany("INSERT INTO match_steps (match_id, step_idx, "
                    "event_mask) VALUES (?, ?, ?)", rows)
    con.commit()
    con.close()


def _tokens(path):
    con = sqlite3.connect(path)
    rows = con.execute("SELECT id, match_id, tick, token FROM step_tokens "
                       "ORDER BY id").fetchall()
    con.close()
    return rows


def test_tokenize_and_ngrams_match_jax(tmp_path):
    port_db, jax_db = str(tmp_path / "port.db"), str(tmp_path / "jax.db")
    _token_db(port_db)
    shutil.copy(port_db, jax_db)
    n = tokenize_steps.tokenize(port_db, verbose=False)
    assert n == jtok.tokenize(jax_db, verbose=False) > 40
    assert _tokens(port_db) == _tokens(jax_db)
    got = ngrams.top_ngrams(port_db)
    assert got == jngrams.top_ngrams(jax_db)
    assert got[0] > 0 and len(got[1]) == ngrams.TOP_K


@pytest.mark.parametrize("worlds, policies", [(8, 2), (100, 3)])
def test_print_assignments_matches_jax(capsys, worlds, policies):
    jprint.print_assignments(worlds, policies)
    want = capsys.readouterr().out
    print_assignments.print_assignments(worlds, policies)
    assert capsys.readouterr().out == want and want
