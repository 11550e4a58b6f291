"""The port's other models against the JAX package, on the CPU: symlog /
symexp, the DreamerV3 and HL-Gauss critics, the hash-grid encoder and the
attention backbone (EntitySelfAttentionNet, ActorCriticNet(use_attention
=True)).

Bars (each array):

- symlog, symexp and DreamerV3Critic.two_hot_target bit-equal to JAX
  (float32 views, signed zeros included): the port evaluates XLA's CPU
  exp / log1p op for op (utils/xla_math.py) and divides by a tensor, as
  eager JAX does (XLA under jit turns two_hot_target's division by a
  constant into a product and differs on ~1 in 20 elements);
- the critics' values within 1e-5 * max(1, |x|) (measured 2.3e-6 / 3.5e-6): the softmax's sum and
  the expectation over 255 / 128 bins run in ATen's reduction order, not
  XLA's, and torch.linspace's 255 centres differ from jnp.linspace's by
  an ulp on about half of them (jnp.linspace's own result differs
  between its eager and jitted calls);
- HashGridEncoder bit-equal to the flax module applied eagerly, at dim 2
  and 3 (the corners summed in order, as XLA's reduction of a short axis
  runs; under jit XLA fuses multiply-adds, 2.4e-7 apart);
- the attention backbone within 1e-5 * max|x| in float32 and 4 eps *
  max|x| in bfloat16 (eps = 2^-7), the bars of
  tests/test_torch_mixed_precision.py.

The JAX side is fixtures_torch/models_jax.npz (make_models_fixture.py:
the hash encoder and two_hot_target applied eagerly, the critics and the
attention nets under jax.jit, on the inputs and weights its helpers make
from seeds); symlog and symexp run live.
"""

import os
import sys

import jax
import numpy as np
import pytest
import torch

from madrona_mp_env_tpu.train import hash_encoder as jhash
from madrona_mp_env_tpu.train import models as jmodels

from madrona_mp_env_tpu_torch.train import (build_actor_critic,
                                            init_rnn_states, params_from_jax)
from madrona_mp_env_tpu_torch.train import models as tmodels
from madrona_mp_env_tpu_torch.train.convert import uses_attention
from madrona_mp_env_tpu_torch.train.hash_encoder import HashGridEncoder
from madrona_mp_env_tpu_torch.train.policy import clear_rnn_states

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "fixtures_torch"))
import make_models_fixture as mfx  # noqa: E402
from policy_weights import random_flax_params, random_obs  # noqa: E402
from torch_threads import one_thread_under_xdist  # noqa: E402,F401

DTYPES = {"f32": (torch.float32, 1e-5), "bf16": (torch.bfloat16,
                                                 4 * 2.0 ** -7)}
CRITIC_BAR = 1e-5


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


@pytest.fixture(scope="module")
def fx():
    return dict(np.load(mfx.PATH))


@pytest.mark.parametrize("name", ["symlog", "symexp"])
def test_symlog_symexp_bit_equal(name):
    x = mfx.critic_values()
    if name == "symexp":
        x = np.clip(x, -80.0, 80.0)  # finite: exp(88.7) is float32's top
    want = jax.jit(getattr(jmodels, name))(x)
    got = getattr(tmodels, name)(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("name", mfx.CRITICS)
def test_critic_matches_flax(fx, name):
    tc = getattr(tmodels, name)(32)
    feats, k, b = mfx.critic_inputs(tc.num_bins)
    with torch.no_grad():
        tc.dense.weight.copy_(torch.from_numpy(k.T))
        tc.dense.bias.copy_(torch.from_numpy(b))
        got = tc(torch.from_numpy(feats)).numpy()
    want = fx[f"{name}/value"]
    assert got.shape == want.shape == (64,)
    err = np.abs(got.astype(np.float64) - want)
    assert np.all(err <= CRITIC_BAR * np.maximum(1.0, np.abs(want))), \
        float(err.max())
    centers, want_c = tc.bin_centers().numpy(), fx[f"{name}/centers"]
    if name == "HLGaussCritic":  # jnp.linspace's 129 edges equal torch's
        np.testing.assert_array_equal(centers, want_c)
    else:
        np.testing.assert_allclose(centers, want_c, rtol=0, atol=4e-6)


def test_two_hot_target_bit_equal(fx):
    got = tmodels.DreamerV3Critic(8).two_hot_target(
        torch.from_numpy(mfx.critic_values()))
    assert got.dtype == torch.float32 and got.shape[-1] == 255
    np.testing.assert_array_equal(_bits(got), _bits(fx["two_hot"]))


@pytest.mark.parametrize("dim", [2, 3])
def test_hash_encoder_matches_flax(fx, dim):
    pos, table = mfx.hash_inputs(dim)
    port = HashGridEncoder(dim=dim, **mfx.HASH)
    with torch.no_grad():
        port.hash_table.copy_(torch.from_numpy(table))
        got = port(torch.from_numpy(pos[None]))  # a leading batch axis
    assert got.shape == (1, 257, 8)
    np.testing.assert_array_equal(_bits(got[0]), _bits(fx[f"hash{dim}"]))


def test_hash_encoder_resolutions_match_flax():
    enc = jhash.HashGridEncoder(dim=3, **mfx.HASH)
    assert HashGridEncoder(dim=3, **mfx.HASH).resolutions() == \
        np.asarray(enc.resolutions()).tolist()


# ----------------------------------------------- the attention backbone

@pytest.fixture(scope="module")
def attention(fx):
    tree = random_flax_params(mfx.WEIGHT_SEED, 1, attention=True)
    return fx, params_from_jax(tree)[0]


def _scaled(got, want, bar):
    got = got.double().numpy()
    assert got.shape == want.shape
    err = np.abs(got - want)
    assert err.max() <= bar * np.abs(want).max(), (
        float(err.max()), float(np.abs(want).max()))


@pytest.mark.parametrize("name", list(DTYPES))
def test_attention_net_matches_flax(attention, name):
    fx, sd = attention
    tdt, bar = DTYPES[name]
    net = tmodels.EntitySelfAttentionNet(64, 512, 4, tdt)
    net.load_state_dict({k[len("actor_net."):]: v for k, v in sd.items()
                         if k.startswith("actor_net.")})
    feats = {k: torch.from_numpy(v).to(tdt)
             for k, v in mfx.prefix_features(mfx.DATA_SEED, mfx.B).items()}
    with torch.no_grad():
        got = net(feats)
    assert got.dtype == tdt
    _scaled(got, fx[f"{name}/net"], bar)


@pytest.mark.parametrize("name", list(DTYPES))
def test_attention_policy_forward_matches_flax(attention, name):
    fx, sd = attention
    tdt, bar = DTYPES[name]
    assert uses_attention(sd)
    net = build_actor_critic(sd, device="cpu", dtype=tdt, use_attention=True)
    rnn = init_rnn_states((mfx.B,))
    clear = torch.as_tensor(np.arange(mfx.B) % 2 == 0)
    with torch.no_grad():
        for t in range(mfx.STEPS):
            if t == 1:
                rnn = clear_rnn_states(rnn, clear)
            obs = {k: torch.tensor(v).to(tdt)
                   for k, v in random_obs(mfx.DATA_SEED + 1 + t,
                                          mfx.B).items()}
            d, v, rnn = net(rnn, obs)
            for got, key in ((d.discrete.logits, "discrete"),
                             (d.aim.logits, "aim"), (v, "value")):
                assert got.dtype == torch.float32
                _scaled(got, fx[f"{name}/step{t}/{key}"], bar)
    _scaled(rnn, fx[f"{name}/rnn"], bar)


@pytest.mark.parametrize("name", list(DTYPES))
def test_attention_policy_sequence_matches_flax(attention, name):
    fx, sd = attention
    tdt, bar = DTYPES[name]
    net = build_actor_critic(sd, device="cpu", dtype=tdt, use_attention=True)
    obs, dones, actions = mfx.sequence_inputs(mfx.DATA_SEED + 10)
    start = (0.5 * np.random.default_rng(mfx.DATA_SEED + 20)
             .standard_normal((2, 2, mfx.B, 512))).astype(np.float32)
    with torch.no_grad():
        lp, ent, values = net.sequence(
            torch.from_numpy(start), torch.from_numpy(dones),
            {k: torch.from_numpy(v).to(tdt) for k, v in obs.items()},
            {"discrete": torch.from_numpy(actions[..., :4]),
             "aim": torch.from_numpy(actions[..., 4:])})
    for head in ("discrete", "aim"):
        _scaled(lp[head], fx[f"{name}/seq/log_probs_{head}"], bar)
        _scaled(ent[head], fx[f"{name}/seq/entropy_{head}"], bar)
    _scaled(values, fx[f"{name}/seq/values"], bar)


def test_attention_params_map_every_leaf():
    """params_from_jax maps the attention tree onto the port's net leaf
    for leaf (load_state_dict is strict) and refuses a leftover leaf."""
    tree = random_flax_params(0, 1, attention=True)
    sd = params_from_jax(tree)[0]
    net = tmodels.EntitySelfAttentionNet(64, 512, 4)
    assert sd["actor_net.attn.query.weight"].shape == (64, 64)
    assert torch.equal(sd["actor_net.attn.out.weight"], torch.from_numpy(
        tree["actor_net"]["MultiHeadDotProductAttention_0"]["out"]["kernel"]
        [0].reshape(64, 64).T.copy()))
    net.load_state_dict({k[len("critic_net."):]: v for k, v in sd.items()
                         if k.startswith("critic_net.")})
    tree["actor_net"]["extra"] = {"kernel": np.zeros((1, 2, 2), np.float32)}
    with pytest.raises(ValueError, match="unmapped"):
        params_from_jax(tree)
