"""The port's mixed precision (bfloat16 / float16) against the JAX
package, on the CPU.

eps below is the dtype's machine epsilon: 2^-7 for bfloat16, 2^-10 for
float16. Both frameworks keep the parameters in float32 and cast them and
the inputs to the compute dtype at each dense layer; they round at
different points. XLA's CPU backend multiplies bfloat16 in float32 and,
inside a fusion, drops a round trip through bfloat16 (a dense layer's
product feeds its LayerNorm unrounded); ATen rounds every op's output.
The port rounds Python constants to the dtype as jnp rounds a weakly
typed scalar (pi in the position encoding, the LeakyReLU slope), adds a
bias after the product (ATen's fused addmm rounds once, XLA twice) and
keeps float32 where flax does (LayerNorm statistics, heads' outputs, the
LSTM state between steps).

Units, on random inputs made with numpy (bars per array):

- the position encoding of bfloat16 positions equals jitted JAX's bit
  for bit, of float16 positions within one rounding, |d| <= eps * |x|
  (9 of 196,608 elements one ulp apart: ATen's and XLA's float32 sin and
  cos differ in the last bit);
- ``normalize_obs`` in the compute dtype within one rounding of JAX's:
  |d| <= eps * |x| (float32 statistics, ATen's and XLA's rsqrt);
- the policy forward (3 recurrent steps, state cleared between the first
  and the second) against flax ``ActorCriticNet(dtype=...)`` under
  jax.jit: logits, values and the float32 recurrent state within
  4 eps * max |x| of the array (measured 1.2-1.6 eps in bfloat16,
  1.0-1.3 eps in float16: a few roundings apart in every layer);
- ``PolicyLSTM.sequence`` within 4 eps * max |x|.

The trainer in bfloat16 against fixtures_torch/zone_train_bf16.npz
(make_train_fixture.py --bf16, the float32 fixture's configuration with
TrainConfig.compute_dtype bfloat16), from the same point:

- the rollout, step by step up to the first step where an action
  differs: actions equal where the Gumbel top-two margin exceeds 2^-4
  (the sampled log probs differ by up to 0.03; an action parted at a
  margin of 4.3e-3), dones exact, rewards within 1e-4 (the env's bar),
  values within 4 eps * max(1, |x|), the sampled actions' log probs
  within 4 eps * max(1, |x|), the packed observations (bfloat16) within
  one rounding, eps * |x|, + 1e-6 (the env's float32 noise about 0: a
  normalized 1.5e-13 against 0); the key after it exact and, where every step
  agreed, the BPTT start states (stored in bfloat16) and the bootstrap
  values within 4 eps * max |x|;
- the first minibatch on the fixture's buffers: its order exact, its
  loss terms within eps * max(1, |x|) and its gradient's global norm
  within eps relative (measured 0.2%);
- one update_iter: every sampled parameter's change within 4.01 lr of
  JAX's (two Adam steps move a parameter at most ~2.003 lr each way: a
  gradient element whose sign differs in bfloat16 moves it the other
  way), at least 95% of them within 0.5 lr (measured 97.7%), the sign of
  JAX's change wherever it exceeds 1.5 lr on at least 95% (98.4%), and
  the loss terms within 4 eps * max(1, |x|).

float16 runs one update at the same size with finite losses and its
buffers in float16. Every float32 test of the port is unchanged: the
float32 path runs the same ops as before (each cast a no-op).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrona_mp_env_tpu.train import models as jmodels
from madrona_mp_env_tpu.train import normalizer as jnorm
from madrona_mp_env_tpu.train import policy as jpolicy

import madrona_mp_env_tpu_torch as mt
from madrona_mp_env_tpu_torch.train import (EvalConfig, EvalManager, PPOConfig,
                                            TrainConfig, TrainingManager,
                                            build_actor_critic,
                                            normalize_obs,
                                            normalizer_from_jax,
                                            params_from_jax)
from madrona_mp_env_tpu_torch.train.models import PolicyLSTM
from madrona_mp_env_tpu_torch.train.policy import (clear_rnn_states,
                                                   init_rnn_states,
                                                   sinusoidal_embedding)
from madrona_mp_env_tpu_torch.train.trainer import global_norm
from madrona_mp_env_tpu_torch.utils import rng

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
SCENE = os.path.join(REPO, "data", "simple_map")
sys.path.insert(0, os.path.join(HERE, "fixtures_torch"))
import make_train_fixture as mtf  # noqa: E402
from policy_weights import random_flax_params, random_obs  # noqa: E402
from torch_threads import one_thread_under_xdist  # noqa: E402,F401
from test_torch_train import _gumbel_margin  # noqa: E402

DTYPES = {"bf16": (jnp.bfloat16, torch.bfloat16, 2.0 ** -7),
          "fp16": (jnp.float16, torch.float16, 2.0 ** -10)}
EPS = DTYPES["bf16"][2]
MARGIN = 2.0 ** -4
B, STEPS = 64, 3


def _f64(x):
    if isinstance(x, torch.Tensor):
        return x.double().numpy()
    return np.asarray(np.asarray(x).astype(np.float32), np.float64)


def _scaled(got, want, bar):
    """|got - want| <= bar * max |want| over the array."""
    got, want = _f64(got), _f64(want)
    assert got.shape == want.shape
    err = np.abs(got - want)
    assert err.max() <= bar * np.abs(want).max(), (
        float(err.max()), float(np.abs(want).max()))


def _rel(got, want, bar, floor=1.0):
    """|got - want| <= bar * max(floor, |want|) element by element."""
    got, want = _f64(got), _f64(want)
    assert got.shape == want.shape
    err = np.abs(got - want)
    tol = bar * np.maximum(np.abs(want), floor)
    assert np.all(err <= tol), float((err - tol).max())


# ------------------------------------------------------------------ units

@pytest.mark.parametrize("name", list(DTYPES))
def test_position_encoding_matches_jax(name):
    jdt, tdt, eps = DTYPES[name]
    pos = np.random.default_rng(0).uniform(-1, 1, (4096, 3)).astype(
        np.float32)
    want = jax.jit(jpolicy.sinusoidal_embedding)(jnp.asarray(pos).astype(jdt))
    got = sinusoidal_embedding(torch.as_tensor(pos).to(tdt))
    assert got.dtype == tdt
    if name == "bf16":
        np.testing.assert_array_equal(_f64(got), _f64(want))
    err = np.abs(_f64(got) - _f64(want))
    assert np.all(err <= eps * np.abs(_f64(want)))


@pytest.mark.parametrize("name", list(DTYPES))
def test_normalize_obs_matches_jax(name):
    jdt, tdt, eps = DTYPES[name]
    obs = random_obs(5, 16)
    g = np.random.default_rng(6)
    stats = {"mu": {}, "var": {}, "count": np.int32(9)}
    for k in ("self", "teammates", "opponents", "reward_coefs"):
        n = obs[k].shape[-1]
        stats["mu"][k] = g.standard_normal(n).astype(np.float32)
        stats["var"][k] = g.uniform(0.1, 3.0, n).astype(np.float32)
    jstate = jnorm.EMANormalizerState(
        mu={k: jnp.asarray(v) for k, v in stats["mu"].items()},
        var={k: jnp.asarray(v) for k, v in stats["var"].items()},
        count=jnp.asarray(stats["count"]))
    want = jax.jit(jnorm.normalize_obs, static_argnums=2)(
        jstate, {k: jnp.asarray(v) for k, v in obs.items()}, jdt)
    got = normalize_obs(normalizer_from_jax(stats),
                        {k: torch.as_tensor(v) for k, v in obs.items()}, tdt)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == tdt, k
        err = np.abs(_f64(got[k]) - _f64(want[k]))
        assert np.all(err <= eps * np.abs(_f64(want[k]))), k


def _flax_step_fn(jdt):
    model = jpolicy.ActorCriticNet(dtype=jdt)

    @jax.jit
    def step(params, rnn, obs):
        d, v, rnn = model.apply({"params": params}, rnn, obs, False)
        return d.discrete.logits, d.aim.logits, v, rnn

    return step


@pytest.mark.parametrize("name", list(DTYPES))
def test_forward_matches_flax(name):
    jdt, tdt, eps = DTYPES[name]
    step = _flax_step_fn(jdt)
    tree = random_flax_params(seed=0, num_policies=1)
    jparams = jax.tree_util.tree_map(lambda x: jnp.asarray(x[0]), tree)
    net = build_actor_critic(params_from_jax(tree)[0], device="cpu",
                             dtype=tdt)
    assert net.dtype == tdt
    assert all(p.dtype == torch.float32 for p in net.parameters())
    clear = np.arange(B) % 2 == 0
    jr, tr = jpolicy.init_rnn_states((B,)), init_rnn_states((B,))
    for t in range(STEPS):
        if t == 1:
            jr = jpolicy.clear_rnn_states(jr, jnp.asarray(clear))
            tr = clear_rnn_states(tr, torch.as_tensor(clear))
        obs = random_obs(10 + t, B)
        dl, al, v, jr = step(jparams, jr, {k: jnp.asarray(x).astype(jdt)
                                           for k, x in obs.items()})
        td, tv, tr = net(tr, {k: torch.tensor(x).to(tdt)
                              for k, x in obs.items()})
        for got, want in ((td.discrete.logits, dl), (td.aim.logits, al),
                          (tv, v), (tr, jr)):
            assert got.dtype == torch.float32
            _scaled(got, want, 4 * eps)


def test_lstm_sequence_matches_flax():
    C, H, T, Bs = 8, 16, 5, 3
    g = np.random.default_rng(2)
    model = jmodels.PolicyLSTM(hidden_dim=H, dtype=jnp.bfloat16)
    xs = g.normal(size=(T, Bs, C)).astype(np.float32)
    start = g.normal(size=(2, Bs, H)).astype(np.float32)
    dones = (g.uniform(size=(T, Bs)) < 0.3).astype(np.float32)
    tree = jax.jit(model.init, static_argnames="method")(
        jax.random.PRNGKey(0), start, dones, xs, method=model.sequence)
    tree = jax.tree_util.tree_map(
        lambda x: g.normal(size=x.shape).astype(np.float32) * 0.5,
        tree["params"])
    want = jax.jit(lambda p: model.apply({"params": p}, start, dones, xs,
                                         method=model.sequence))(tree)
    cell = tree["OptimizedLSTMCell_0"]
    gates = ("i", "f", "g", "o")
    net = PolicyLSTM(C, H, torch.bfloat16)
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
    assert got.dtype == torch.bfloat16
    _scaled(got, want, 4 * EPS)


def test_eval_needs_policies_of_its_dtype(simple_map_dir):
    cfg = mt.EnvConfig(task=mt.Task.Zone, team_size=2,
                       sim_flags=mt.SimFlags.SimEvalMode)
    env = mt.Env(cfg, simple_map_dir, num_worlds=2, device="cpu")
    mgr = EvalManager(cfg, EvalConfig(num_worlds=2, num_eval_steps=1,
                                      policy_dtype=torch.bfloat16), env, 2,
                      device="cpu")
    nets = [build_actor_critic(seed=s, device="cpu") for s in (0, 1)]
    with pytest.raises(ValueError, match="bfloat16"):
        mgr.run(nets, None, torch.full((2,), 1000.0), verbose=False)


# ------------------------------------------- trainer vs the bf16 fixture

def _manager(dtype):
    cfg = mt.EnvConfig(
        task=mt.Task.Zone, team_size=mtf.TEAM_SIZE,
        sim_flags=mt.SimFlags.StaggerStarts | mt.SimFlags.RandomFlipTeams)
    tcfg = TrainConfig(
        num_worlds=mtf.NUM_WORLDS, steps_per_update=mtf.STEPS,
        num_bptt_chunks=mtf.CHUNKS,
        ppo=PPOConfig(num_epochs=mtf.EPOCHS,
                      num_minibatches=mtf.MINIBATCHES),
        compute_dtype=dtype, seed=mtf.TRAIN_SEED)
    env = mt.Env(cfg, SCENE, num_worlds=mtf.NUM_WORLDS, seed=mtf.ENV_SEED,
                 device="cpu")
    mgr = TrainingManager(cfg, tcfg, env, device="cpu")
    return mgr, mgr.init(params=params_from_jax(
        random_flax_params(mtf.WEIGHT_SEED, 1)))


@pytest.fixture(scope="module")
def bf16_trainer():
    """The port's bfloat16 manager at the fixture's configuration, its
    first rollout with each step's Gumbel margins, and one update_iter."""
    fx = dict(np.load(mtf.BF16_PATH))
    mgr, ts0 = _manager(torch.bfloat16)
    dists = []
    apply = mgr.apply_blocks

    def recording(params, rnn, obs):
        out = apply(params, rnn, obs)
        dists.append(out[0])
        return out

    mgr.apply_blocks = recording
    ro = mgr.rollout(ts0)
    mgr.apply_blocks = apply
    keys = rng.split(rng.split(ts0.key, 2)[1], mtf.STEPS)
    margins = torch.stack([_gumbel_margin(d, rng.split(keys[t], 2)[0])
                           for t, d in enumerate(dists[:mtf.STEPS])])
    return fx, mgr, ts0, ro, margins, mgr.update_iter(ts0)


def test_bf16_rollout_matches_fixture(bf16_trainer):
    fx, mgr, _, (ts1, rnn_starts, outs, bootstrap), margin, _ = bf16_trainer
    T = mtf.STEPS
    assert outs["obs_pack"].dtype == torch.bfloat16
    assert rnn_starts.dtype == torch.bfloat16
    assert ts1.rnn_states.dtype == torch.float32

    def steps(x):
        x = _f64(x) if isinstance(x, torch.Tensor) else x
        return x.reshape((T,) + x.shape[2:])

    act, want_act = steps(outs["act_pack"]), steps(fx["act_pack"])
    decided = margin.reshape(T, 1, -1).numpy() > MARGIN
    compared = 0
    for t in range(T):
        same = (act[t] == want_act[t]).all(-1)
        assert same[decided[t]].all(), f"step {t}: decided actions differ"
        _rel(steps(outs["rewards"])[t], steps(fx["rewards"])[t], 1e-4)
        _rel(steps(outs["values"])[t], steps(fx["values"])[t], 4 * EPS)
        np.testing.assert_array_equal(steps(outs["dones"])[t],
                                      steps(fx["dones"])[t])
        for head in ("discrete", "aim"):
            _rel(steps(outs["log_probs"][head])[t][same],
                 steps(fx[f"log_probs_{head}"])[t][same], 4 * EPS)
        got, want = steps(outs["obs_pack"])[t], steps(fx["obs_pack"])[t]
        assert np.all(np.abs(got - want) <= EPS * np.abs(want) + 1e-6), t
        compared += 1
        if not same.all():
            break  # an undecided action parted the two rollouts
    assert compared >= 4
    np.testing.assert_array_equal(ts1.key.numpy(), fx["key1"])
    if compared == T:
        _scaled(bootstrap, fx["bootstrap"], 4 * EPS)
        _scaled(rnn_starts, fx["rnn_starts"], 4 * EPS)


def test_bf16_first_minibatch_matches_fixture(bf16_trainer):
    fx, mgr, ts0, _, _, _ = bf16_trainer
    outs = {k: torch.as_tensor(fx[k]) for k in ("act_pack", "values",
                                                "rewards", "dones")}
    outs["obs_pack"] = torch.as_tensor(fx["obs_pack"]).to(torch.bfloat16)
    outs["log_probs"] = {"discrete": torch.as_tensor(fx["log_probs_discrete"]),
                         "aim": torch.as_tensor(fx["log_probs_aim"])}
    bufs = mgr.ppo_buffers(
        torch.as_tensor(fx["rnn_starts"]).to(torch.bfloat16), outs,
        torch.as_tensor(fx["bootstrap"]))
    num_units = mtf.CHUNKS * mgr.BE
    sub = rng.split(torch.as_tensor(fx["key1"].astype(np.int64)), 2)[1]
    order = mgr.minibatch_order(rng.split(sub, mtf.EPOCHS)[0], num_units)
    np.testing.assert_array_equal(order.numpy(), fx["order"])
    mb = num_units // mtf.MINIBATCHES
    grads, metrics = mgr.loss_and_grads(
        ts0.params[0], mgr.gather_batch(bufs, 0, order[0, :mb]))
    assert all(g.dtype == torch.float32 for g in grads.values())
    for k, v in metrics.items():
        _rel(v, fx[f"mb0/{k}"], EPS)
    _rel(global_norm(grads.values()), fx["mb0/grad_norm"], EPS, floor=0.0)


def test_bf16_update_matches_fixture(bf16_trainer):
    fx, mgr, ts0, _, _, (ts2, metrics) = bf16_trainer
    assert int(ts2.opt_state[0].count) == int(fx["update/count"][0])
    lr = mgr.tcfg.lr
    got, want = [], []
    for k, p0 in ts0.params[0].items():
        assert ts2.params[0][k].dtype == torch.float32
        i = torch.as_tensor(mtf.sample_index(k, p0.numel()))
        got.append((ts2.params[0][k] - p0).reshape(-1)[i].numpy() / lr)
        want.append(fx[f"delta/{k}"] / lr)
    got, want = np.concatenate(got), np.concatenate(want)
    err = np.abs(got - want)
    assert err.max() <= 4.01
    assert (err <= 0.5).mean() >= 0.95
    big = np.abs(want) > 1.5
    assert (np.sign(got[big]) == np.sign(want[big])).mean() >= 0.95
    for k in ("loss", "pg_loss", "v_loss"):
        _rel(metrics[k], fx[f"update/{k}"], 4 * EPS)


def test_fp16_update_runs():
    """float16, as the JAX package runs it (no loss scaling): one update
    at the fixture's size, float16 buffers, finite losses, moved
    parameters."""
    mgr, ts0 = _manager(torch.float16)
    ts, starts, outs, boot = mgr.rollout(ts0)
    assert outs["obs_pack"].dtype == starts.dtype == torch.float16
    ts, metrics = mgr.ppo_update(ts, starts, outs, boot)
    for k in ("loss", "pg_loss", "v_loss"):
        assert torch.isfinite(metrics[k]).all(), k
    assert any(not torch.equal(ts.params[0][k], v)
               for k, v in ts0.params[0].items())
