"""The port's training path against the JAX package, on the CPU.

Units, on random inputs made with numpy:

- ``rng.permutation`` equals ``jax.random.permutation`` bit for bit
  (one and two rounds of its sort);
- ``compute_gae`` and ``ppo_loss`` (its three value-loss branches) within
  1e-5 * max(1, |x|) of JAX's;
- ``PolicyLSTM.sequence`` within 1e-5 + 1e-5 * |x| of flax's (jitted),
  with states cleared on dones;
- ``update_normalizer`` within 1e-6 * max(1, |x|);
- ``adam_step`` against the optax chain clip_by_global_norm ->
  scale_by_adam -> scale(-1), x lr (jitted), from non-zero moments, with
  and without clipping: parameters within 1e-6 relative, moments within
  1e-6 of the magnitudes of their terms (XLA's FMAs); and
  ``opt_state_from_jax`` maps moments as it maps parameters.

The trainer against fixtures_torch/zone_train.npz (make_train_fixture.py:
the JAX TrainingManager at 2 worlds, Zone 2v2, 8 steps in 2 BPTT chunks,
1 epoch of 2 minibatches, seeded full-width weights), started from the
same weights, zero Adam moments, env seed and key:

- the rollout: actions equal where the Gumbel top-two margin exceeds 1e-4
  (ATen's and XLA's log differ by an ulp), dones exact, rewards and the
  sampled actions' log probs within 1e-4 and values within 1e-3 relative
  (the env's own bars against jitted JAX: tests/test_torch_slice.py);
  where every action agreed, the bootstrap values within 1e-3 and the
  BPTT chunk start states within 1e-4 too;
- GAE on the fixture's rollout within 1e-5 relative;
- the first minibatch's order exact, its loss terms and gradient global
  norm within 1e-4 * max(1, |x|);
- the parameters after one update_iter within 2.5 lr of JAX's on a fixed
  sample of every leaf (Adam's first steps are ~lr * sign(g) each); where
  every rollout action agreed, also within 0.5 lr, moved the same way
  wherever JAX's change exceeds lr, and the update's loss, pg_loss and
  v_loss within 1e-4 relative.

The train CLI runs two tiny updates on the CPU with two policies,
checkpoints, restores, and raises on the flags it does not support.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from madrona_mp_env_tpu.train import models as jmodels
from madrona_mp_env_tpu.train import normalizer as jnorm
from madrona_mp_env_tpu.train import ppo as jppo

import madrona_mp_env_tpu_torch as mt
from madrona_mp_env_tpu_torch.train import (EMANormalizerState, PPOConfig,
                                            TrainConfig, TrainingManager,
                                            compute_gae, opt_state_from_jax,
                                            params_from_jax, ppo_loss,
                                            update_normalizer)
from madrona_mp_env_tpu_torch.train import train as train_cli
from madrona_mp_env_tpu_torch.train.models import PolicyLSTM
from madrona_mp_env_tpu_torch.train.trainer import AdamState, adam_step
from madrona_mp_env_tpu_torch.utils import rng

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
SCENE = os.path.join(REPO, "data", "simple_map")
FIXTURE = os.path.join(HERE, "fixtures_torch", "zone_train.npz")
sys.path.insert(0, os.path.join(HERE, "fixtures_torch"))
import make_train_fixture as mtf  # noqa: E402
from policy_weights import random_flax_params  # noqa: E402
from torch_threads import one_thread_under_xdist  # noqa: E402,F401


def _close(got, want, rel, atol=0.0, scale_floor=1.0):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want)
    tol = atol + rel * np.maximum(np.abs(want), scale_floor)
    assert np.all(err <= tol), f"max err {err.max():.3g}"


def _key(seed):
    """jax.random.PRNGKey(seed)'s two words as the port's int64 key."""
    return torch.as_tensor(np.asarray(jax.random.PRNGKey(seed), np.int64))


# ------------------------------------------------------------------ units

@pytest.mark.parametrize("n", [1, 5, 100, 1625, 1626, 3000])
def test_permutation_matches_jax(n):
    for seed in (0, 7):
        want = np.asarray(jax.random.permutation(jax.random.PRNGKey(seed), n))
        got = rng.permutation(_key(seed), n)
        np.testing.assert_array_equal(got.numpy(), want)


def test_compute_gae_matches_jax():
    g = np.random.default_rng(0)
    T, B = 12, 7
    r = g.normal(size=(T, B)).astype(np.float32)
    v = g.normal(size=(T, B)).astype(np.float32)
    d = (g.uniform(size=(T, B)) < 0.2).astype(np.int32)
    boot = g.normal(size=B).astype(np.float32)
    ja, jr = jppo.compute_gae(r, v, d, boot, 0.998, 0.95)
    ta, tr = compute_gae(*(torch.as_tensor(x) for x in (r, v, d, boot)),
                         0.998, 0.95)
    _close(ta, ja, 1e-5)
    _close(tr, jr, 1e-5)


@pytest.mark.parametrize("mode", ["default", "clip_value_loss",
                                  "huber_value_loss"])
def test_ppo_loss_matches_jax(mode):
    g = np.random.default_rng(1)
    shape = (6, 10)

    def n(s=1.0):
        return (s * g.normal(size=shape)).astype(np.float32)

    args = [{"discrete": n(0.3), "aim": n(0.3)},
            {"discrete": np.abs(n()), "aim": np.abs(n())}, n(2.0),
            {"discrete": n(0.3), "aim": n(0.3)}, n(2.0), n(), n(2.0)]
    kw = {} if mode == "default" else {mode: True}
    jl, jm = jppo.ppo_loss(*args, jppo.PPOConfig(**kw))

    def t(x):
        if isinstance(x, dict):
            return {k: torch.as_tensor(v) for k, v in x.items()}
        return torch.as_tensor(x)

    tl, tm = ppo_loss(*(t(a) for a in args), PPOConfig(**kw))
    assert set(tm) == set(jm)
    for k in jm:
        _close(tm[k], jm[k], 1e-5)
    _close(tl, jl, 1e-5)


def test_lstm_sequence_matches_flax():
    C, H, T, B = 8, 16, 5, 3
    g = np.random.default_rng(2)
    model = jmodels.PolicyLSTM(hidden_dim=H, dtype=jnp.float32)
    xs = g.normal(size=(T, B, C)).astype(np.float32)
    start = g.normal(size=(2, B, H)).astype(np.float32)
    dones = (g.uniform(size=(T, B)) < 0.3).astype(np.float32)
    tree = jax.jit(model.init, static_argnames="method")(
        jax.random.PRNGKey(0), start, dones, xs, method=model.sequence)
    tree = jax.tree_util.tree_map(
        lambda x: g.normal(size=x.shape).astype(np.float32) * 0.5,
        tree["params"])
    want = jax.jit(lambda p: model.apply({"params": p}, start, dones, xs,
                                         method=model.sequence))(tree)
    cell = tree["OptimizedLSTMCell_0"]
    gates = ("i", "f", "g", "o")
    net = PolicyLSTM(C, H)
    net.load_state_dict({
        "x_proj.weight": torch.as_tensor(np.concatenate(
            [cell[f"i{x}"]["kernel"] for x in gates], -1).T),
        "h_proj.weight": torch.as_tensor(np.concatenate(
            [cell[f"h{x}"]["kernel"] for x in gates], -1).T),
        "h_proj.bias": torch.as_tensor(np.concatenate(
            [cell[f"h{x}"]["bias"] for x in gates], -1)),
        "out_ln.weight": torch.as_tensor(
            tree["LayerNorm_0"]["LayerNorm_0"]["scale"]),
        "out_ln.bias": torch.as_tensor(
            tree["LayerNorm_0"]["LayerNorm_0"]["bias"]),
    })
    with torch.no_grad():
        got = net.sequence(torch.as_tensor(start), torch.as_tensor(dones),
                           torch.as_tensor(xs))
    _close(got, want, 1e-5, atol=1e-5, scale_floor=0.0)


def test_update_normalizer_matches_jax():
    g = np.random.default_rng(3)
    obs = {"self": g.normal(2.0, 3.0, (1, 24, 5)).astype(np.float32),
           "teammates": g.normal(size=(1, 24, 3, 4)).astype(np.float32),
           "self_pos": g.normal(size=(1, 24, 3)).astype(np.float32)}
    mu = {"self": g.normal(size=5).astype(np.float32),
          "teammates": g.normal(size=4).astype(np.float32)}
    var = {k: g.uniform(0.5, 2.0, v.shape).astype(np.float32)
           for k, v in mu.items()}
    want = jnorm.update_normalizer(
        jnorm.EMANormalizerState(mu=mu, var=var, count=jnp.int32(4)), obs)
    got = update_normalizer(EMANormalizerState(
        mu={k: torch.as_tensor(v) for k, v in mu.items()},
        var={k: torch.as_tensor(v) for k, v in var.items()},
        count=torch.tensor(4, dtype=torch.int32)),
        {k: torch.as_tensor(v) for k, v in obs.items()})
    assert int(got.count) == 5 and set(got.mu) == set(mu)
    for k in mu:
        _close(got.mu[k], want.mu[k], 1e-6)
        _close(got.var[k], want.var[k], 1e-6)


_TX = optax.chain(optax.clip_by_global_norm(0.5), optax.scale_by_adam(),
                  optax.scale(-1.0))


@jax.jit
def _optax_step(p, g, st, lr):
    u, st = _TX.update(g, st, p)
    return optax.apply_updates(p, jax.tree_util.tree_map(
        lambda x: x * lr, u)), st


@pytest.mark.parametrize("grad_scale", [1e-2, 1.0])  # unclipped, clipped
def test_adam_step_matches_optax(grad_scale):
    """From non-zero moments at count 3. XLA contracts a * b + c into one
    FMA under jit, so each result is held to 1e-6 of the magnitudes of
    the terms it sums (and 1e-6 relative for the parameters)."""
    g = np.random.default_rng(5)
    shapes = {"w": (16, 8), "b": (8,), "s": (3,)}

    def tree(scale, positive=False):
        out = {k: scale * g.standard_normal(v) for k, v in shapes.items()}
        return {k: (np.abs(v) if positive else v).astype(np.float32)
                for k, v in out.items()}

    params, grads = tree(0.3), tree(grad_scale)
    mu, nu = tree(1e-2), tree(1e-4, positive=True)
    lr = np.float32(3e-4)
    st = (optax.EmptyState(),
          optax.ScaleByAdamState(count=jnp.int32(3), mu=mu, nu=nu),
          optax.EmptyState())
    want_p, want_st = _optax_step(params, grads, st, lr)

    def t(d):
        return {k: torch.as_tensor(v) for k, v in d.items()}

    got_p, got_st = adam_step(
        t(params), t(grads),
        AdamState(count=torch.tensor(3, dtype=torch.int32), mu=t(mu),
                  nu=t(nu)), torch.tensor(lr), 0.5)
    assert int(got_st.count) == 4
    norm = np.sqrt(sum((v.astype(np.float64) ** 2).sum()
                       for v in grads.values()))
    clip = min(1.0, 0.5 / norm)
    for k in shapes:
        gk = np.abs(grads[k]) * clip
        _close(got_p[k], want_p[k], 1e-6, scale_floor=0.0)
        _close(got_st.mu[k], want_st[1].mu[k], 0.0,
               atol=1e-6 * (0.1 * gk + 0.9 * np.abs(mu[k])))
        _close(got_st.nu[k], want_st[1].nu[k], 0.0,
               atol=1e-6 * (1e-3 * gk ** 2 + 0.999 * nu[k]))


def test_opt_state_from_jax():
    """Adam moments carry across like the parameters they shadow."""
    mu, nu = random_flax_params(6, 2), random_flax_params(7, 2)
    states = opt_state_from_jax(mu, nu, np.array([3, 5], np.int32))
    assert [int(s.count) for s in states] == [3, 5]
    for e, (pm, pn) in enumerate(zip(params_from_jax(mu),
                                     params_from_jax(nu))):
        assert states[e].mu.keys() == pm.keys()
        for k in pm:
            assert torch.equal(states[e].mu[k], pm[k])
            assert torch.equal(states[e].nu[k], pn[k])


# ------------------------------------------------- trainer vs the fixture

def _cfg(team_size=mtf.TEAM_SIZE):
    return mt.EnvConfig(
        task=mt.Task.Zone, team_size=team_size,
        sim_flags=mt.SimFlags.StaggerStarts | mt.SimFlags.RandomFlipTeams)


def _gumbel_margin(logits, key):
    """Smallest top-two gap over the heads of log probs + the key's
    Gumbel noise (ActorDistributions.sample's stream)."""
    from madrona_mp_env_tpu_torch.train.distributions import gumbel

    gaps = []
    for k, d in zip(rng.split(key, 2), (logits.discrete, logits.aim)):
        z = d.packed_log_probs() + gumbel(k, d.logits.shape)
        o = 0
        for b in d.buckets:
            two = torch.topk(z[..., o:o + b], 2, dim=-1).values
            gaps.append(two[..., 0] - two[..., 1])
            o += b
    return torch.stack(gaps).amin(0)


@pytest.fixture(scope="module")
def trainer():
    """The port's manager at the fixture's configuration, its initial
    state from the fixture's weights, and its first rollout with each
    step's Gumbel margins."""
    fx = dict(np.load(FIXTURE))
    cfg = _cfg()
    tcfg = TrainConfig(
        num_worlds=mtf.NUM_WORLDS, steps_per_update=mtf.STEPS,
        num_bptt_chunks=mtf.CHUNKS,
        ppo=PPOConfig(num_epochs=mtf.EPOCHS,
                      num_minibatches=mtf.MINIBATCHES),
        seed=mtf.TRAIN_SEED)
    env = mt.Env(cfg, SCENE, num_worlds=mtf.NUM_WORLDS, seed=mtf.ENV_SEED,
                 device="cpu")
    mgr = TrainingManager(cfg, tcfg, env, device="cpu")
    ts0 = mgr.init(params=params_from_jax(
        random_flax_params(mtf.WEIGHT_SEED, 1)))
    margins = []
    apply = mgr.apply_blocks

    def recording(params, rnn, obs):
        out = apply(params, rnn, obs)
        margins.append(out[0])
        return out

    mgr.apply_blocks = recording
    ro = mgr.rollout(ts0)
    mgr.apply_blocks = apply
    T = mtf.STEPS
    keys = rng.split(rng.split(ts0.key, 2)[1], T)
    margins = [_gumbel_margin(d, rng.split(keys[t], 2)[0])
               for t, d in enumerate(margins[:T])]
    return fx, mgr, ts0, ro, torch.stack(margins)


def test_initial_key_matches_fixture(trainer):
    fx, _, ts0, _, _ = trainer
    np.testing.assert_array_equal(ts0.key.numpy(), fx["key0"])


def test_rollout_matches_fixture(trainer):
    """Step by step up to the first step where an action differs (only
    where the Gumbel margin is below 1e-4 may one differ)."""
    fx, mgr, _, (ts1, rnn_starts, outs, bootstrap), margin = trainer
    T = mtf.STEPS

    def steps(x):
        x = x.numpy() if isinstance(x, torch.Tensor) else x
        return x.reshape((T,) + x.shape[2:])

    act, want_act = steps(outs["act_pack"]), steps(fx["act_pack"])
    decided = margin.reshape(T, 1, -1).numpy() > 1e-4
    compared = 0
    for t in range(T):
        same = (act[t] == want_act[t]).all(-1)
        assert same[decided[t]].all(), f"step {t}: decided actions differ"
        _close(steps(outs["rewards"])[t], steps(fx["rewards"])[t], 1e-4)
        _close(steps(outs["values"])[t], steps(fx["values"])[t], 1e-3)
        np.testing.assert_array_equal(steps(outs["dones"])[t],
                                      steps(fx["dones"])[t])
        for head in ("discrete", "aim"):
            _close(steps(outs["log_probs"][head])[t][same],
                   steps(fx[f"log_probs_{head}"])[t][same], 1e-4)
        compared += 1
        if not same.all():
            break  # an undecided action parted the two rollouts
    assert compared >= 4
    if compared == T:
        np.testing.assert_array_equal(ts1.key.numpy(), fx["key1"])
        _close(bootstrap, fx["bootstrap"], 1e-3)
        _close(rnn_starts, fx["rnn_starts"], 1e-4)


def test_gae_matches_fixture(trainer):
    fx, mgr, _, _, _ = trainer
    outs = {k: torch.as_tensor(fx[k]) for k in ("rewards", "values",
                                                "dones")}
    adv, ret = mgr.advantages(outs, torch.as_tensor(fx["bootstrap"]))
    _close(adv, fx["adv"], 1e-5)
    _close(ret, fx["ret"], 1e-5)


def test_first_minibatch_matches_fixture(trainer):
    fx, mgr, ts0, _, _ = trainer
    outs = {k: torch.as_tensor(fx[k]) for k in ("obs_pack", "act_pack",
                                                "values", "rewards",
                                                "dones")}
    outs["log_probs"] = {"discrete": torch.as_tensor(fx["log_probs_discrete"]),
                         "aim": torch.as_tensor(fx["log_probs_aim"])}
    bufs = mgr.ppo_buffers(torch.as_tensor(fx["rnn_starts"]), outs,
                           torch.as_tensor(fx["bootstrap"]))
    num_units = mtf.CHUNKS * mgr.BE
    sub = rng.split(torch.as_tensor(fx["key1"].astype(np.int64)), 2)[1]
    order = mgr.minibatch_order(rng.split(sub, mtf.EPOCHS)[0], num_units)
    np.testing.assert_array_equal(order.numpy(), fx["order"])
    mb = num_units // mtf.MINIBATCHES
    grads, metrics = mgr.loss_and_grads(
        ts0.params[0], mgr.gather_batch(bufs, 0, order[0, :mb]))
    for k, v in metrics.items():
        _close(v, fx[f"mb0/{k}"], 1e-4)
    from madrona_mp_env_tpu_torch.train.trainer import global_norm

    _close(global_norm(grads.values()), fx["mb0/grad_norm"], 1e-4)


def test_update_params_match_fixture(trainer):
    """2.5 lr always; where the rollout's actions all agreed (so both
    updates saw the same data), 0.5 lr, JAX's direction wherever its change
    exceeds lr, and the update's loss terms within 1e-4 relative."""
    fx, mgr, ts0, (_, _, outs, _), _ = trainer
    ts2, metrics = mgr.update_iter(ts0)
    assert ts2.update_idx == 1
    assert int(ts2.opt_state[0].count) == int(fx["update/count"][0])
    same_rollout = bool((outs["act_pack"].numpy() == fx["act_pack"]).all())
    lr = mgr.tcfg.lr
    moved = 0
    for k, p0 in ts0.params[0].items():
        i = torch.as_tensor(mtf.sample_index(k, p0.numel()))
        got = (ts2.params[0][k] - p0).reshape(-1)[i].numpy()
        want = fx[f"delta/{k}"]
        _close(got, want, 0.0, atol=2.5 * lr)
        if same_rollout:
            _close(got, want, 0.0, atol=0.5 * lr)
            big = np.abs(want) > lr
            assert (np.sign(got[big]) == np.sign(want[big])).all(), k
        moved += int((got != 0).sum())
    assert moved > 0
    for k in ("loss", "pg_loss", "v_loss"):
        assert np.isfinite(metrics[k].numpy()).all()
        if same_rollout:
            _close(metrics[k], fx[f"update/{k}"], 1e-4)


# ------------------------------------------------------------------ CLI

def _cli_args(tmp_path, num_updates):
    return ["--cpu", "--scene", SCENE, "--num-worlds", "2",
            "--team-size", "2", "--steps-per-update", "4",
            "--num-bptt-chunks", "2", "--num-minibatches", "2",
            "--pbt-ensemble-size", "2", "--num-updates", str(num_updates),
            "--metrics-buffer-size", "1", "--ckpt-frequency", "1",
            "--ckpt-dir", str(tmp_path / "ck"),
            "--tb-dir", str(tmp_path / "tb"), "--run-name", "r"]


def test_train_cli_runs_checkpoints_and_restores(tmp_path, monkeypatch):
    """Two policies (the cross-play block routing), two updates, a
    checkpoint after each; then a restore from the second continues to
    the third. JSONL metrics only: TensorBoard's import takes ~13 s."""
    import json

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    ts = train_cli.main(_cli_args(tmp_path, 2))
    assert ts.update_idx == 2
    rows = [json.loads(line)
            for line in open(tmp_path / "tb" / "r" / "metrics.jsonl")]
    assert {r["step"] for r in rows} == {1, 2}
    tags = {r["tag"] for r in rows}
    assert {"p0/loss", "p1/loss", "p1/elo", "reward_mean", "fps"} <= tags
    assert all(np.isfinite(r["value"]) for r in rows)
    ck = torch.load(tmp_path / "ck" / "r" / "2.pt", weights_only=True)
    for k, v in ts.params[1].items():
        assert torch.equal(ck["params"][1][k], v)
    ts3 = train_cli.main(_cli_args(tmp_path, 3) + ["--restore", "2"])
    assert ts3.update_idx == 3
    assert (tmp_path / "ck" / "r" / "3.pt").exists()
    # 3 updates of 2 epochs x 2 minibatches; of 4 rollout steps
    assert int(ts3.opt_state[0].count) == 3 * 2 * 2
    assert int(ts3.normalizer.count) == 3 * 4


@pytest.mark.parametrize("flags", [
    ["--pbt-update-frequency", "5"], ["--pbt-past-policies", "1"],
    ["--num-devices", "2"], ["--distributed"], ["--bf16"], ["--fp16"],
])
def test_train_cli_rejects_unsupported_flags(flags):
    with pytest.raises(NotImplementedError, match="not supported"):
        train_cli.build(train_cli.parse_args(["--cpu"] + flags))
