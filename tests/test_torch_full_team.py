"""The full-team interface and its policy against the JAX package, on the
CPU.

(a) Zone 2v2 with SimFlags.FullTeamPolicy (2 worlds, 16 steps) replays
    the committed eager JAX rollout of fixtures_torch/zone_curriculum.npz
    (make_curriculum_fixture.py, ``ft/``): pos, vel and reward bit-exact
    at every step; every full_team_* observation, state.ft_last_known and
    the rest to tests/test_torch_slice.py's bars (hp, alive, team points
    and done exact, the float observations within 1e-3 * max(1, |x|));
    the team reward is the sum of its members' and done their all.
(f) ``FullTeamActorCriticNet`` against flax's (train/full_team_policy.py,
    under jax.jit) from the same parameters (flax's tree filled from a
    seed, carried by convert.full_team_params_from_jax), at team
    sizes 2 and 6 on 2 worlds' teams: in float32 the forward's logits,
    value and recurrent state and the sequence's log probs, entropies and
    values (3 steps, dones in the first two) within 1e-5 * max(1, |x|),
    the sampled actions equal where the Gumbel top-two margin exceeds
    1e-5, and (team size 2) the gradient of a scalar of both within 1e-4
    of each parameter's largest gradient; in bfloat16 (team size 2) the
    same outputs within
    4 eps * max |x| of each array (eps 2^-7), the bar of
    tests/test_torch_mixed_precision.py.
The minimap's scatter-mean and flax's "SAME" padding widths (units).
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from madrona_mp_env_tpu.train import full_team_policy as jft

from madrona_mp_env_tpu_torch.train import full_team_policy as tft
from madrona_mp_env_tpu_torch.train.convert import full_team_params_from_jax
from madrona_mp_env_tpu_torch.train.distributions import gumbel
from madrona_mp_env_tpu_torch.utils import rng

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "fixtures_torch"))
sys.path.insert(0, HERE)
import make_curriculum_fixture as cx  # noqa: E402
from test_torch_curriculum import (compare_case, data,  # noqa: E402,F401
                                   group)
from torch_threads import one_thread_under_xdist  # noqa: E402,F401

BF16_EPS = 2.0 ** -7
MARGIN = 1e-5
T, WORLDS = 3, 2


def test_full_team_rollout_matches_jax(data, simple_map_dir):  # noqa: F811
    got = compare_case(data, "ft", simple_map_dir)
    want = group(data, "ft")
    for k in ("obs_full_team_done", "obs_full_team_global"):
        assert np.array_equal(got[k], want[k]), k
    ts = cx.TEAM_SIZE
    steps, W = got["reward"].shape[:2]
    r = got["reward"].reshape(steps, W, 2, ts)
    total = r[..., 0]
    for k in range(1, ts):
        total = total + r[..., k]
    assert np.array_equal(got["obs_full_team_reward"][1:], total)
    assert np.array_equal(got["obs_full_team_done"][1:],
                          (got["done"].reshape(steps, W, 2, ts) != 0).all(-1))
    # the last-known table fills and its state is the observation
    assert np.array_equal(got["ft_last_known"],
                          got["obs_full_team_last_known_enemies"])
    assert (got["ft_last_known"] != 0).any()


def _obs(ts, lead, g):
    """Full-team observations [*lead, ...] with the env's ranges: flags
    0 / 1 (the enemy mask last), positions in [0, 1], lidar depths."""
    my, enemy, lk = tft.obs_dims(ts)
    f32 = np.float32
    obs = {
        "full_team_global": g.random(lead + (tft.GLOBAL_DIM,)).astype(f32),
        "full_team_players": g.random(lead + (ts, my)).astype(f32),
        "full_team_enemies": (g.random(lead + (ts, enemy)) < 0.5).astype(
            f32),
        "full_team_last_known_enemies": g.random(lead + (ts, lk)).astype(
            f32),
        "full_team_fwd_lidar": g.uniform(-1, 500, lead + (ts, 2, 32, 4)
                                         ).astype(f32),
        "full_team_rear_lidar": g.uniform(-1, 500, lead + (ts, 2, 8, 4)
                                          ).astype(f32),
    }
    off = 2 + ts
    obs["full_team_enemies"][..., off:off + 3] = g.random(lead + (ts, 3))
    return obs


def _case(ts, seed=0):
    """(params, rnn start [2, 2, B, H], obs [B], dones [T, B], obs_seq
    [T, B], actions [T, B, ts]) as numpy, B = 2 worlds' teams."""
    g = np.random.default_rng(seed + ts)
    B = 2 * WORLDS
    obs0 = _obs(ts, (B,), g)
    seq = _obs(ts, (T, B), g)
    rnn_state = (0.5 * g.standard_normal((2, 2, B, tft.TEAM_RNN_HIDDEN))
                 ).astype(np.float32)
    dones = np.zeros((T, B), np.int32)
    dones[1, 1] = dones[0, 3] = 1
    acts = {"discrete": np.stack([g.integers(0, n, (T, B, ts)) for n in
                                  (3, 8, 3, 3)], -1).astype(np.int32),
            "aim": np.stack([g.integers(0, n, (T, B, ts)) for n in (13, 7)],
                            -1).astype(np.int32)}
    # flax's parameter tree by shape alone (jax.eval_shape compiles
    # nothing), filled from the seed: kernels N(0, 1 / fan_in), biases
    # N(0, 0.05^2), LayerNorm scales 1 + N(0, 0.05^2)
    model = jft.FullTeamActorCriticNet(dtype=jnp.float32)
    shapes = jax.eval_shape(lambda r, o: model.init(
        jax.random.PRNGKey(0), r, o, False), rnn_state, obs0)["params"]

    def fill(path, x):
        w = g.standard_normal(x.shape).astype(np.float32)
        name = path[-1].key
        if name == "kernel":
            return w / np.float32(np.sqrt(np.prod(x.shape[:-1])))
        return (name == "scale") + np.float32(0.05) * w

    params = jax.tree_util.tree_map_with_path(fill, shapes)
    return params, rnn_state, obs0, dones, seq, acts


def _scalar(xp, lp, ent, vals):
    return (xp.mean(lp["discrete"] + lp["aim"])
            + 0.01 * xp.mean(ent["discrete"] + ent["aim"])
            + 0.5 * xp.mean(vals * vals))


def _flax(ts, jdtype, params, rnn_state, obs0, dones, seq, acts, grad):
    model = jft.FullTeamActorCriticNet(dtype=jdtype)
    key = jax.random.PRNGKey(7)

    def run(p):
        d, v, r2 = model.apply({"params": p}, rnn_state, obs0, False)
        sampled, _ = d.sample(key)
        lp, ent, vals = model.apply({"params": p}, rnn_state, dones, seq,
                                    acts, method=model.sequence)
        out = dict(logits_d=d.discrete.logits, logits_a=d.aim.logits,
                   value=v, rnn=r2, lp_d=lp["discrete"], lp_a=lp["aim"],
                   ent_d=ent["discrete"], ent_a=ent["aim"], values=vals,
                   act_d=sampled["discrete"], act_a=sampled["aim"])
        return _scalar(jnp, lp, ent, vals), out

    if grad:
        (_, out), grads = jax.jit(jax.value_and_grad(run, has_aux=True))(
            params)
        return {k: np.asarray(v) for k, v in out.items()}, grads
    return {k: np.asarray(v) for k, v in jax.jit(run)(params)[1].items()}, \
        None


def _port(ts, dtype, params, rnn_state, obs0, dones, seq, acts, grad):
    net = tft.FullTeamActorCriticNet(ts, dtype)
    net.load_state_dict(full_team_params_from_jax(params))
    t = torch.as_tensor
    with torch.set_grad_enabled(grad):
        d, v, r2 = net(t(rnn_state), {k: t(x) for k, x in obs0.items()})
        lp, ent, vals = net.sequence(
            t(rnn_state), t(dones), {k: t(x) for k, x in seq.items()},
            {k: t(x) for k, x in acts.items()})
        if grad:
            _scalar(torch, lp, ent, vals).backward()
    key = rng.split(rng.prng_key(7), 2)
    out = dict(logits_d=d.discrete.logits, logits_a=d.aim.logits, value=v,
               rnn=r2, lp_d=lp["discrete"], lp_a=lp["aim"],
               ent_d=ent["discrete"], ent_a=ent["aim"], values=vals)
    out = {k: x.detach().float().numpy() for k, x in out.items()}
    noise = {h: gumbel(key[i], dist.logits.shape)
             for i, (h, dist) in enumerate((("d", d.discrete),
                                            ("a", d.aim)))}
    return out, net, noise, d


def _margins(dist, noise):
    """The Gumbel top-two margin of each head [..., H]."""
    z = (dist.packed_log_probs() + noise).detach()
    out = []
    for o, b in dist._segments():
        top = torch.topk(z[..., o:o + b], 2, -1).values
        out.append(top[..., 0] - top[..., 1])
    return torch.stack(out, -1).numpy()


@pytest.mark.parametrize("ts", [2, 6])
def test_full_team_policy_matches_flax(ts):
    grad = ts == 2  # the gradient at one team size: its compile is long
    case = _case(ts)
    want, grads = _flax(ts, jnp.float32, *case, grad=grad)
    got, net, noise, d = _port(ts, torch.float32, *case, grad=grad)
    for k, g in got.items():
        w = want[k]
        assert g.shape == w.shape, (k, g.shape, w.shape)
        err = np.abs(g.astype(np.float64) - w)
        assert np.all(err <= 1e-5 * np.maximum(1.0, np.abs(w))), (
            k, float(err.max()))
    actions, _ = d.sample(rng.prng_key(7))
    for h, dist, act in (("d", d.discrete, "act_d"), ("a", d.aim, "act_a")):
        decided = _margins(dist, noise[h]) > MARGIN
        assert decided.mean() > 0.99
        got_a = actions["discrete" if h == "d" else "aim"].numpy()
        assert np.array_equal(got_a[decided], want[act][decided]), h
    if not grad:
        return
    want_g = full_team_params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                              grads))
    named = dict(net.named_parameters())
    assert set(named) == set(want_g)
    for k, w in want_g.items():
        g = named[k].grad
        scale = float(w.abs().max())
        assert scale > 0.0, k
        assert float((g - w).abs().max()) <= 1e-4 * scale, k


def test_full_team_policy_bf16_matches_flax():
    ts = 2
    case = _case(ts, seed=3)
    want, _ = _flax(ts, jnp.bfloat16, *case, grad=False)
    got, *_ = _port(ts, torch.bfloat16, *case, grad=False)
    for k, g in got.items():
        w = want[k].astype(np.float32)
        bar = 4 * BF16_EPS * max(1e-30, float(np.abs(w).max()))
        assert float(np.abs(g - w).max()) <= bar, k


def test_build_minimap_mean():
    """A cell's value is the mean of the background and the valid
    entities in it; a masked entity leaves its cell the background."""
    glob = torch.zeros(1, 4)
    feats = torch.ones(1, 3, 4) * torch.tensor([1.0, 3.0, 10.0])[None, :,
                                                                  None]
    pos = torch.tensor([[[0.0, 0.0, 0.5], [0.01, 0.01, 0.5],
                         [0.5, 0.5, 0.5]]])
    mm = tft.build_minimap(glob, feats, pos, torch.tensor([[1.0, 1.0, 0.0]]))
    assert mm.shape == (1, 16, 16, 4)
    assert torch.equal(mm[0, 0, 0], torch.full((4,), 4.0 / 3.0))
    assert torch.equal(mm[0, 8, 8], torch.zeros(4))
    # positions outside [0, 1] land on the edge cells
    far = tft.build_minimap(glob, feats, pos * 0 + torch.tensor(
        [-0.5, 1.5, 0.0]), torch.ones(1, 3))
    assert torch.equal(far[0, 15, 0], torch.full((4,), 14.0 / 4.0))


def test_same_padding_widths():
    """flax's "SAME" at stride 2: 0 before and 1 after an even width, so
    32 -> 16 -> 8 -> 4, 8 -> 4 -> 2 -> 1 and 16 -> 8 -> 4 -> 2."""
    assert tft._same_pad(32, 3, 2) == (0, 1)
    assert tft._same_pad(2, 3, 2) == (0, 1)
    assert tft._same_pad(5, 3, 2) == (1, 1)
    net = tft.FullTeamActorCriticNet(2)
    assert net.prefix.fwd_lidar_conv.out_dim == 4 * tft.LIDAR_CH
    assert net.prefix.rear_lidar_conv.out_dim == 1 * tft.LIDAR_CH
    assert net.actor_net.backbone.ln.normalized_shape == (256,)
