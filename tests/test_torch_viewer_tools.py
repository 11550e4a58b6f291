"""The port's offline viewer (tools/viewer.py), its weight export
(tools/convert_weights.py) and the inverse weight map
(train/convert.py params_to_jax, full_team_params_to_jax) against the
JAX package's, on the CPU.

- the frame readers over the record and event log of
  fixtures_torch/zone_record.npz (written as tests/test_torch_viz.py
  writes them) equal the JAX viewer's field for field, and ``main``
  renders frames and the --heatmap PNG (matplotlib, lazily imported);
- ``convert`` of a checkpoint holding the port's state_dicts writes the
  file set the JAX ``save_arrays`` writes from the flax tree, byte for
  byte: a MaxPoolNet, an attention and a full-team tree with E = 2 (the
  first two narrowed, the full-team tree's shapes from flax's own init
  through jax.eval_shape, which compiles nothing);
- params_to_jax(params_from_jax(tree)) and the full-team pair give the
  tree back bit for bit, and an entry neither map knows raises;
- ``convert`` reads a TrainingManager.save_ckpt file.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from madrona_mp_env_tpu.tools import convert_weights as jax_cw
from madrona_mp_env_tpu.tools import viewer as jax_viewer
from madrona_mp_env_tpu.train import full_team_policy as jft
from madrona_mp_env_tpu_torch.data import read_step_snapshots
from madrona_mp_env_tpu_torch.tools import convert_weights, viewer
from madrona_mp_env_tpu_torch.train import full_team_policy as tft
from madrona_mp_env_tpu_torch.train.convert import (
    flatten, full_team_params_from_jax, full_team_params_to_jax,
    params_from_jax, params_to_jax)

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "fixtures_torch"))
sys.path.insert(0, HERE)
import make_record_fixture as rx  # noqa: E402
from policy_weights import random_flax_params  # noqa: E402
from test_torch_viz import TEAM_SIZE, write_logs  # noqa: E402
from torch_threads import one_thread_under_xdist  # noqa: E402,F401

E = 2
TREES = ("maxpool", "attention", "full_team")


@pytest.fixture(scope="module")
def logs(tmp_path_factory):
    return write_logs(str(tmp_path_factory.mktemp("viewer")))


def same_frames(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(np.asarray(g[k]),
                                          np.asarray(w[k]), err_msg=k)
            assert np.asarray(g[k]).dtype == np.asarray(w[k]).dtype, k


@pytest.mark.parametrize("world", range(rx.REC_WORLDS))
def test_frame_readers_match_jax(logs, world):
    record, events, _ = logs
    same_frames(viewer.frames_from_record(record, rx.REC_WORLDS, world),
                jax_viewer.frames_from_record(record, rx.REC_WORLDS, world))
    snaps = read_step_snapshots(events)
    same_frames(viewer.frames_from_snapshots(snaps, world),
                jax_viewer.frames_from_snapshots(snaps, world))


def test_viewer_main_renders(logs, simple_map_dir, tmp_path):
    record, events, _ = logs
    common = ["--scene", simple_map_dir, "--team-size", str(TEAM_SIZE),
              "--world", "1"]
    frames = tmp_path / "frames"
    viewer.main(["--record", record, "--num-worlds", str(rx.REC_WORLDS),
                 "--out", str(frames), "--stride", "5", "--max-frames", "2"]
                + common)
    assert sorted(os.listdir(frames)) == [
        f"frame_{i:05d}.png" for i in range(2)]  # steps 0 and 5
    heat = tmp_path / "heat"
    viewer.main(["--events", events, "--out", str(heat), "--heatmap"]
                + common)
    with open(heat / "heatmap.png", "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def full_team_tree(seed):
    """One policy's flax tree of the JAX FullTeamActorCriticNet (team
    size 2), its shapes from jax.eval_shape, filled from ``seed``."""
    g = np.random.default_rng(seed)
    B, ts = 2, 2
    my, enemy, lk = tft.obs_dims(ts)
    obs = {
        "full_team_global": jnp.zeros((B, tft.GLOBAL_DIM)),
        "full_team_players": jnp.zeros((B, ts, my)),
        "full_team_enemies": jnp.zeros((B, ts, enemy)),
        "full_team_last_known_enemies": jnp.zeros((B, ts, lk)),
        "full_team_fwd_lidar": jnp.zeros((B, ts, 2, 32, 4)),
        "full_team_rear_lidar": jnp.zeros((B, ts, 2, 8, 4)),
    }
    rnn = jnp.zeros((2, 2, B, jft.TEAM_RNN_HIDDEN))
    model = jft.FullTeamActorCriticNet(dtype=jnp.float32)
    shapes = jax.eval_shape(lambda r, o: model.init(
        jax.random.PRNGKey(0), r, o, False), rnn, obs)["params"]
    return jax.tree_util.tree_map(
        lambda x: g.standard_normal(x.shape).astype(np.float32), shapes)


def make_tree(kind):
    """(flax tree with E policies on the leading axis, the port's E
    state_dicts)."""
    if kind == "full_team":
        trees = [full_team_tree(s) for s in range(E)]
        tree = jax.tree_util.tree_map(lambda *x: np.stack(x), *trees)
        return tree, [full_team_params_from_jax(t) for t in trees]
    tree = random_flax_params(3, E, attention=kind == "attention",
                              embed_dim=8, hidden=16)
    return tree, params_from_jax(tree)


@pytest.fixture(scope="module")
def trees():
    return {kind: make_tree(kind) for kind in TREES}


def files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            with open(os.path.join(d, n), "rb") as f:
                out[os.path.relpath(os.path.join(d, n), root)] = f.read()
    return out


@pytest.mark.parametrize("kind", TREES)
def test_convert_writes_the_jax_files(trees, kind, tmp_path):
    tree, sds = trees[kind]
    jax_cw.save_arrays(tree, str(tmp_path / "jax"), verbose=False)
    ckpt = str(tmp_path / "0.pt")
    torch.save({"params": sds}, ckpt)
    convert_weights.convert(ckpt, str(tmp_path / "port"), verbose=False)
    want = files(tmp_path / "jax")
    assert {os.path.dirname(k) for k in want} == {str(e) for e in range(E)}
    assert files(tmp_path / "port") == want


@pytest.mark.parametrize("kind", TREES)
def test_inverse_map_round_trips(trees, kind):
    tree, sds = trees[kind]
    if kind == "full_team":
        back = [full_team_params_to_jax(sd) for sd in sds]
        back = jax.tree_util.tree_map(lambda *x: np.stack(x), *back)
    else:
        back = params_to_jax(sds)
    want, got = flatten(tree), flatten(back)
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        np.testing.assert_array_equal(got[k].view(np.int32),
                                      w.view(np.int32), err_msg=k)
    sd = dict(sds[0], extra=torch.zeros(2, 2))
    with pytest.raises(ValueError, match="unmapped port params"):
        if kind == "full_team":
            full_team_params_to_jax(sd)
        else:
            params_to_jax([sd])


def test_convert_reads_a_save_ckpt_file(simple_map_dir, tmp_path):
    import madrona_mp_env_tpu_torch as mt
    from madrona_mp_env_tpu_torch.train import (PPOConfig, TrainConfig,
                                                TrainingManager)

    cfg = mt.EnvConfig(task=mt.Task.Zone, team_size=TEAM_SIZE)
    tcfg = TrainConfig(num_worlds=1, steps_per_update=2, num_bptt_chunks=1,
                       ppo=PPOConfig(num_epochs=1, num_minibatches=1))
    env = mt.Env(cfg, simple_map_dir, num_worlds=1, device="cpu")
    mgr = TrainingManager(cfg, tcfg, env, device="cpu")
    ts = mgr.init()
    path = mgr.save_ckpt(ts, str(tmp_path / "run"))
    out = tmp_path / "weights"
    convert_weights.convert(path, str(out), verbose=False)
    tree = params_to_jax(ts.params)
    jax_cw.save_arrays(tree, str(tmp_path / "jax"), verbose=False)
    assert files(out) == files(tmp_path / "jax")
    name = "actor_rnn_OptimizedLSTMCell_0_hf_kernel"
    with open(out / "0" / name, "rb") as f:
        ndim = np.fromfile(f, np.int32, 1)[0]
        shape = np.fromfile(f, np.int32, ndim)
        data = np.fromfile(f, np.float32)
    assert ndim == 2
    np.testing.assert_array_equal(
        data.reshape(shape),
        flatten(tree)[name.replace("_OptimizedLSTMCell_0_hf_", "/Optimized"
                                   "LSTMCell_0/hf/")][0])
    for k, v in params_from_jax(tree)[0].items():
        assert torch.equal(v, ts.params[0][k]), k
