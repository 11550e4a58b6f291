"""The port's threefry2x32 is bit-exact against jax.random (partitionable
threefry, the jax default): fold_in, split, uniform, randint and the sim's
keying helpers, over many keys and shapes. Tolerance: none, bits equal.

jax.random compiles each shape on its first eager call (seconds a test),
so the JAX side of prng_key, fold_in, split, uniform and randint comes
from tests/fixtures_torch/rng_jax.npz (make_rng_fixture.py, which runs
the cases below); the keying helpers' case calls JAX here."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrona_mp_env_tpu.utils import rng as jrng
from madrona_mp_env_tpu_torch.utils import rng as trng

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "fixtures_torch"))
import make_rng_fixture as fx  # noqa: E402
from torch_threads import one_thread_under_xdist  # noqa: E402,F401

SEEDS = (0, 5, 7, 123456, 2 ** 31 - 1)
FOLD_DATA = (0, 1, 2, 3, 4, 5, 17, 2999, -1, 2 ** 31 - 1)
SPLIT_NS = (2, 6, 8)
UNIFORM_CASES = (((), 0.0, 1.0), ((7,), 0.0, 1.0),
                 ((2, 12), float(np.finfo(np.float32).tiny), 1.0),
                 ((12, 6), 0.0, 1.0), ((3, 4, 5), -2.0, 3.5))
RANDINT_CASES = (((), 0, 2999), ((12,), 0, 1), ((12,), 1, 11), ((), 0, 3),
                 ((5, 3), -7, 100000), ((4,), 3, 3))


@pytest.fixture(scope="module")
def want():
    return dict(np.load(fx.PATH))


def _keys(want, seed):
    """The 6 distinct raw keys split from a seed (jax's, from the
    fixture, and as the port's int64 tensor)."""
    ks = want[f"{seed}/keys"]
    return ks, torch.as_tensor(ks.astype(np.int64))


def test_threefry_partitionable_is_on():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_and_fold_in(want, seed):
    assert np.array_equal(want[f"{seed}/key"], trng.prng_key(seed).numpy())
    kt = trng.prng_key(seed)
    for i, data in enumerate(FOLD_DATA):
        assert np.array_equal(want[f"{seed}/fold_in/{i}"],
                              trng.fold_in(kt, data).numpy()), data


@pytest.mark.parametrize("seed", SEEDS)
def test_split(want, seed):
    ks, kt = _keys(want, seed)
    for n in SPLIT_NS:
        assert np.array_equal(want[f"{seed}/split/{n}"],
                              trng.split(kt, n).numpy())


@pytest.mark.parametrize("seed", SEEDS)
def test_uniform(want, seed):
    ks, kt = _keys(want, seed)
    for i, (shape, lo, hi) in enumerate(UNIFORM_CASES):
        w = want[f"{seed}/uniform/{i}"]
        got = trng.uniform(kt, shape, lo, hi).numpy()
        assert got.dtype == np.float32 and w.shape == got.shape
        assert np.array_equal(w.view(np.uint32), got.view(np.uint32))


@pytest.mark.parametrize("seed", SEEDS)
def test_randint(want, seed):
    ks, kt = _keys(want, seed)
    for i, (shape, lo, hi) in enumerate(RANDINT_CASES):
        w = want[f"{seed}/randint/{i}"]
        got = trng.randint(kt, shape, lo, hi).numpy()
        assert w.shape == got.shape and np.array_equal(w, got)


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
