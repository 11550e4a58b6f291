"""The port's threefry2x32 is bit-exact against jax.random (partitionable
threefry, the jax default): fold_in, split, uniform, randint and the sim's
keying helpers, over many keys and shapes. Tolerance: none, bits equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrona_mp_env_tpu.utils import rng as jrng
from madrona_mp_env_tpu_torch.utils import rng as trng

SEEDS = (0, 5, 7, 123456, 2 ** 31 - 1)


def _keys(seed, n=6):
    """n distinct raw keys derived from a seed (jax and torch forms)."""
    base = jax.random.PRNGKey(seed)
    ks = np.asarray(jax.random.key_data(jax.random.split(base, n)))
    return ks, torch.as_tensor(ks.astype(np.int64))


def test_threefry_partitionable_is_on():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_and_fold_in(seed):
    k = jax.random.PRNGKey(seed)
    assert np.array_equal(np.asarray(jax.random.key_data(k)),
                          trng.prng_key(seed).numpy())
    kt = trng.prng_key(seed)
    for data in (0, 1, 2, 3, 4, 5, 17, 2999, -1, 2 ** 31 - 1):
        want = np.asarray(jax.random.key_data(
            jax.random.fold_in(k, jnp.int32(data))))
        assert np.array_equal(want, trng.fold_in(kt, data).numpy()), data


@pytest.mark.parametrize("seed", SEEDS)
def test_split(seed):
    ks, kt = _keys(seed)
    for n in (2, 6, 8):
        want = np.stack([np.asarray(jax.random.key_data(jax.random.split(
            jax.random.wrap_key_data(jnp.asarray(k)), n))) for k in ks])
        assert np.array_equal(want, trng.split(kt, n).numpy())


@pytest.mark.parametrize("seed", SEEDS)
def test_uniform(seed):
    ks, kt = _keys(seed)
    tiny = float(np.finfo(np.float32).tiny)
    for shape, lo, hi in (((), 0.0, 1.0), ((7,), 0.0, 1.0),
                          ((2, 12), tiny, 1.0), ((12, 6), 0.0, 1.0),
                          ((3, 4, 5), -2.0, 3.5)):
        want = np.stack([np.asarray(jax.random.uniform(
            jax.random.wrap_key_data(jnp.asarray(k)), shape, minval=lo,
            maxval=hi)) for k in ks])
        got = trng.uniform(kt, shape, lo, hi).numpy()
        assert got.dtype == np.float32
        assert np.array_equal(want.view(np.uint32), got.view(np.uint32))


@pytest.mark.parametrize("seed", SEEDS)
def test_randint(seed):
    ks, kt = _keys(seed)
    for shape, lo, hi in (((), 0, 2999), ((12,), 0, 1), ((12,), 1, 11),
                          ((), 0, 3), ((5, 3), -7, 100000), ((4,), 3, 3)):
        want = np.stack([np.asarray(jax.random.randint(
            jax.random.wrap_key_data(jnp.asarray(k)), shape, lo, hi))
            for k in ks])
        assert np.array_equal(want, trng.randint(kt, shape, lo, hi).numpy())


def test_sim_keying_helpers():
    """episode_key / step_key / system_key, batched over worlds as the
    port's sim calls them, equal the JAX helpers world by world."""
    ikd = jax.random.key_data(jax.random.PRNGKey(5)).astype(jnp.uint32)
    ep = np.array([0, 1, 2, 7, 4000000000], np.uint32)
    world = np.array([0, 1, 2, 3, 1023], np.int32)
    step = np.array([-1, 0, 5, 2998, 123], np.int32)
    ek_t = trng.episode_key(trng.prng_key(5), torch.as_tensor(ep.astype(
        np.int64)), torch.as_tensor(world))
    for w in range(len(ep)):
        ek = jrng.episode_key(ikd, jnp.uint32(ep[w]), jnp.int32(world[w]))
        assert np.array_equal(np.asarray(ek), ek_t[w].numpy())
        sk = jrng.step_key(ek, jnp.int32(step[w]))
        sk_t = trng.step_key(ek_t[w:w + 1], torch.as_tensor(step[w:w + 1]))
        assert np.array_equal(np.asarray(jax.random.key_data(sk)),
                              sk_t[0].numpy())
        for salt in (trng.Salt.SPAWN, trng.Salt.FIRE):
            sy = jax.random.key_data(jrng.system_key(sk, salt))
            assert np.array_equal(np.asarray(sy),
                                  trng.system_key(sk_t, salt)[0].numpy())
