"""The port's policy against the JAX package's flax policy, on the CPU.

Weights: the flax param tree made with numpy from a seed at full width
(fixtures_torch/policy_weights.py), carried across with
convert.params_from_jax. The flax ActorCriticNet.apply (no init) runs on a
batch of 64 agents for 3 recurrent steps, with half the agents' state
cleared between the first and the second. It runs under one jax.jit:
eagerly, its first call spends 5-10 s compiling each primitive on the
CPU, against about 2 s for the jitted step.

Bar: logits, values and the recurrent state within 1e-4 + 1e-4 * |x|
(float32 matmuls and layer norms summed in other orders, XLA's fused
multiply-adds, and flax's one-pass variance). Distributions on the same
logits and key: packed log probs within 1e-5, best actions exact, sampled
actions equal wherever the Gumbel top-two margin exceeds 1e-5 (ATen's and
XLA's log differ by an ulp).
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from madrona_mp_env_tpu.train import distributions as jdist
from madrona_mp_env_tpu.train import normalizer as jnorm
from madrona_mp_env_tpu.train import policy as jpolicy

from madrona_mp_env_tpu_torch.train import (build_actor_critic,
                                            load_policy_npz, normalize_obs,
                                            normalizer_from_jax,
                                            params_from_jax)
from madrona_mp_env_tpu_torch.train import distributions as tdist
from madrona_mp_env_tpu_torch.train.policy import (clear_rnn_states,
                                                   init_rnn_states)
from madrona_mp_env_tpu_torch.utils import rng

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, os.path.join(HERE, "fixtures_torch"))
from policy_weights import random_flax_params, random_obs  # noqa: E402
from torch_threads import one_thread_under_xdist  # noqa: E402,F401

B, STEPS = 64, 3
TOL = 1e-4


def _close(got, want, atol=TOL, rtol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want)
    assert np.all(err <= atol + rtol * np.abs(want)), float(err.max())


_MODEL = jpolicy.ActorCriticNet(dtype=jnp.float32)


@jax.jit
def _flax_step(params, rnn, obs):
    d, v, rnn = _MODEL.apply({"params": params}, rnn, obs, False)
    return d.discrete.logits, d.aim.logits, v, rnn


def _rollouts(jparams, net, obs_seq, clear):
    """The same 3 steps through flax and the port; returns both sides'
    [(discrete logits, aim logits, value, rnn state)] per step."""
    jr = jpolicy.init_rnn_states((B,))
    tr = init_rnn_states((B,))
    jout, tout = [], []
    for t, obs in enumerate(obs_seq):
        if t == 1:
            jr = jpolicy.clear_rnn_states(jr, jnp.asarray(clear))
            tr = clear_rnn_states(tr, torch.as_tensor(clear))
        dl, al, v, jr = _flax_step(jparams, jr,
                                   {k: jnp.asarray(x) for k, x in obs.items()})
        jout.append((dl, al, v, jr))
        td, tv, tr = net(tr, {k: torch.tensor(x) for k, x in obs.items()})
        tout.append((td.discrete.logits, td.aim.logits, tv, tr))
    return jout, tout


def test_forward_matches_flax():
    tree = random_flax_params(seed=0, num_policies=1)
    jparams = jax.tree_util.tree_map(lambda x: jnp.asarray(x[0]), tree)
    net = build_actor_critic(params_from_jax(tree)[0], device="cpu")
    obs_seq = [random_obs(10 + t, B) for t in range(STEPS)]
    clear = np.arange(B) % 2 == 0
    jout, tout = _rollouts(jparams, net, obs_seq, clear)
    for j, t in zip(jout, tout):
        for a, b in zip(j, t):
            _close(b.numpy(), a)


def _margins(z, buckets):
    """Top-two gap of each head's scores, min over heads: [...]."""
    out, off = [], 0
    for b in buckets:
        two = np.sort(z[..., off:off + b], axis=-1)[..., -2:]
        out.append(two[..., 1] - two[..., 0])
        off += b
    return np.min(out, axis=0)


@jax.jit
def _jax_dists(dl, al, key):
    d = jdist.ActorDistributions(
        discrete=jdist.DiscreteActionDistributions(dl, jdist.DISCRETE_BUCKETS),
        aim=jdist.DiscreteActionDistributions(al, jdist.AIM_BUCKETS))
    acts, lps = d.sample(key)
    stats = d.action_stats(acts)
    return (d.discrete.packed_log_probs(), d.aim.packed_log_probs(),
            d.best(), acts, lps, stats)


def test_distributions_match_jax():
    g = np.random.default_rng(4)
    dl = (2.0 * g.standard_normal((2, B, 17))).astype(np.float32)
    al = (2.0 * g.standard_normal((2, B, 20))).astype(np.float32)
    jdl, jal, jbest, jacts, jlps, (jalp, jent) = _jax_dists(
        jnp.asarray(dl), jnp.asarray(al), jax.random.PRNGKey(7))

    d = tdist.ActorDistributions(
        discrete=tdist.DiscreteActionDistributions(torch.as_tensor(dl),
                                                   tdist.DISCRETE_BUCKETS),
        aim=tdist.DiscreteActionDistributions(torch.as_tensor(al),
                                              tdist.AIM_BUCKETS))
    key = rng.prng_key(7)
    _close(d.discrete.packed_log_probs().numpy(), jdl, 1e-5, 0.0)
    _close(d.aim.packed_log_probs().numpy(), jal, 1e-5, 0.0)
    best = d.best()
    for k in ("discrete", "aim"):
        assert np.array_equal(best[k].numpy(), np.asarray(jbest[k])), k
    acts, lps = d.sample(key)
    for k, group, sub in (("discrete", d.discrete, 0), ("aim", d.aim, 1)):
        scores = group.packed_log_probs() + tdist.gumbel(
            rng.split(key, 2)[sub], group.logits.shape)
        decided = _margins(scores.numpy(), group.buckets) > 1e-5
        assert decided.mean() > 0.99
        same = (acts[k].numpy() == np.asarray(jacts[k])).all(-1)
        assert same[decided].all(), k
        _close(lps[k].numpy()[decided], np.asarray(jlps[k])[decided])
    alp, ent = d.action_stats({k: torch.as_tensor(np.array(v))
                               for k, v in jacts.items()})
    for k in ("discrete", "aim"):
        _close(alp[k].numpy(), jalp[k])
        _close(ent[k].numpy(), jent[k])


def test_normalize_obs_matches_jax():
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
    want = jnorm.normalize_obs(jstate, {k: jnp.asarray(v)
                                        for k, v in obs.items()}, jnp.float32)
    got = normalize_obs(normalizer_from_jax(stats),
                        {k: torch.as_tensor(v) for k, v in obs.items()})
    assert set(got) == set(want)
    for k in want:
        _close(got[k].numpy(), want[k], 1e-5, 1e-6)


def test_builder_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_actor_critic()
    a = build_actor_critic(seed=1, device="cpu")
    b = build_actor_critic(seed=1, device="cpu")
    for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), k


@pytest.mark.slow
def test_real_checkpoint_matches_flax(tmp_path):
    """artifacts/zone6v6_r5_policy0 through export_policy.py and
    load_policy_npz: the same 3-step comparison on normalized
    observations, with the checkpoint's normalizer stats."""
    import export_policy

    ckpt = os.path.join(REPO, "artifacts", "zone6v6_r5_policy0")
    path = export_policy.export(ckpt, str(tmp_path / "policy.npz"))
    nets, norm, elo = load_policy_npz(path, device="cpu")
    raw = export_policy.load_checkpoint(ckpt)
    assert len(nets) == 1 and np.array_equal(elo.numpy(), raw["elo"])
    jparams = jax.tree_util.tree_map(lambda x: jnp.asarray(x[0]),
                                     raw["params"])
    jstate = jnorm.EMANormalizerState(
        mu={k: jnp.asarray(v) for k, v in raw["normalizer"]["mu"].items()},
        var={k: jnp.asarray(v) for k, v in raw["normalizer"]["var"].items()},
        count=jnp.asarray(raw["normalizer"]["count"]))
    obs_seq = []
    for t in range(STEPS):
        obs = random_obs(20 + t, B)
        for k in ("fwd_lidar", "rear_lidar"):
            obs[k] = obs[k].reshape(B, -1)
        want = jnorm.normalize_obs(jstate, {k: jnp.asarray(v)
                                            for k, v in obs.items()},
                                   jnp.float32)
        got = normalize_obs(norm, {k: torch.as_tensor(v)
                                   for k, v in obs.items()})
        for k in want:
            _close(got[k].numpy(), want[k], 1e-5, 1e-6)
        obs_seq.append({k: np.asarray(v) for k, v in want.items()})
    jout, tout = _rollouts(jparams, nets[0], obs_seq, np.arange(B) % 3 == 0)
    for j, t in zip(jout, tout):
        for a, b in zip(j, t):
            _close(b.numpy(), a)
