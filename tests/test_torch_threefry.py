"""The port's counter RNG (``utils/threefry.py``) against ``jax.random``.

Seeded grids of ``(seed, tag, cid, k)`` go through ``jax.random`` and the
port on the CPU. Keys, bits, ``split``, ``randint`` and ``uniform`` must be
bit-identical; ``normal`` within 2 ulp (the port's ``sqrt`` is correctly
rounded, XLA's CPU one is not, which moves ``erf_inv`` by 1 ulp on under
1e-4 of inputs); XLA's float32 ``exp``, ``log`` and ``log1p`` bit-identical
over the ranges the population engine feeds them and beyond.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.utils import threefry

SEEDS = (0, 3, 9, 2 ** 31 - 1, -5)


def _grid(n=3000, seed=0):
    rng = np.random.default_rng(seed)
    cids = rng.integers(0, 2 ** 31 - 1, n).astype(np.int32)
    cids[:64] = np.arange(64)  # small client ids, as the engine's
    ks = rng.integers(0, 5000, n).astype(np.int32)
    return cids, ks


def _jax(fn, *args) -> np.ndarray:
    """``fn(*args)`` in JAX, materialised as a numpy copy before any torch
    work starts (JAX dispatches asynchronously)."""
    return np.array(fn(*args))


def _keys(seed, tag, n=3000):
    cids, ks = _grid(n, seed=abs(seed))
    stream = jax.random.fold_in(jax.random.PRNGKey(seed), tag)
    jk = _jax(jax.vmap(lambda c, k: jax.random.fold_in(
        jax.random.fold_in(stream, c), k)), cids, ks)
    tk = threefry.fold_in(threefry.fold_in(
        threefry.fold_in(threefry.prng_key(seed), tag),
        torch.from_numpy(cids.copy())), torch.from_numpy(ks.copy()))
    return jk, tk


def _words(key: threefry.Key) -> np.ndarray:
    return np.stack([key.k0.numpy(), key.k1.numpy()], -1).astype(np.uint32)


def _ulps(a, b) -> np.ndarray:
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key(seed):
    key = threefry.prng_key(seed)
    assert [int(key.k0), int(key.k1)] == \
        np.asarray(jax.random.PRNGKey(seed)).tolist()


def test_prng_key_rejects_wide_seeds():
    with pytest.raises(ValueError, match="int32"):
        threefry.prng_key(2 ** 31)


@pytest.mark.parametrize("seed,tag", [(0, 101), (3, 202), (9, 303),
                                      (-5, 404)])
def test_fold_in(seed, tag):
    jk, tk = _keys(seed, tag)
    np.testing.assert_array_equal(_words(tk), np.asarray(jk))


@pytest.mark.parametrize("shape", [(), (1,), (5,), (32,), (2, 3)])
def test_random_bits(shape):
    jk, tk = _keys(3, 101, n=500)
    want = _jax(jax.vmap(lambda k: jax.random.bits(k, shape, jnp.uint32)),
                jk)
    got = threefry.random_bits32(tk, shape)
    assert got.shape == (500,) + shape
    np.testing.assert_array_equal(got.numpy().astype(np.uint32),
                                  np.asarray(want))


@pytest.mark.parametrize("num", [2, 3, 7])
def test_split(num):
    jk, tk = _keys(0, 303, n=500)
    want = _jax(jax.vmap(lambda k: jax.random.split(k, num)), jk)
    np.testing.assert_array_equal(_words(threefry.split(tk, num)),
                                  np.asarray(want))


@pytest.mark.parametrize("hi", [1, 7, 1500, 70_000, 2 ** 31 - 1])
@pytest.mark.parametrize("shape", [(), (32,)])
def test_randint(hi, shape):
    jk, tk = _keys(9, 303)
    want = _jax(jax.vmap(lambda k: jax.random.randint(k, shape, 0, hi)),
                jk)
    got = threefry.randint(tk, shape, 0, hi)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_randint_bounds():
    jk, tk = _keys(0, 304)
    rng = np.random.default_rng(1)
    sizes = rng.integers(1, 70_000, len(jk)).astype(np.int32)
    want = _jax(jax.vmap(lambda k, s: jax.random.randint(k, (8,), 0, s)),
                jk, sizes)
    got = threefry.randint(tk, (8,), 0, torch.from_numpy(sizes))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # lower bound, empty span (maxval <= minval gives minval)
    for lo, hi in ((-40, 17), (5, 5), (9, 3)):
        want = _jax(jax.vmap(lambda k: jax.random.randint(k, (4,), lo, hi)),
                    jk)
        np.testing.assert_array_equal(
            threefry.randint(tk, (4,), lo, hi).numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="int32"):
        threefry.randint(tk, (), 0, 2 ** 31)
    with pytest.raises(TypeError, match="int32"):
        threefry.randint(tk, (), 0, torch.ones(len(jk), dtype=torch.int64))


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (0.0, float(np.log(10.0))),
                                   (0.0, 24.0), (-3.5, 2.25),
                                   (float(np.nextafter(np.float32(-1.0),
                                                       np.float32(0.0))),
                                    1.0)])
@pytest.mark.parametrize("shape", [(), (4,)])
def test_uniform(lo, hi, shape):
    jk, tk = _keys(3, 402)
    want = _jax(jax.vmap(lambda k: jax.random.uniform(k, shape, jnp.float32,
                                                      lo, hi)), jk)
    got = threefry.uniform(tk, shape, lo, hi)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", [0, 3])
def test_normal_within_2_ulp(seed):
    jk, tk = _keys(seed, 101, n=20_000)
    want = _jax(jax.vmap(lambda k: jax.random.normal(k, (), jnp.float32)),
                jk)
    got = threefry.normal(tk)
    assert got.dtype == torch.float32
    assert _ulps(got.numpy(), want).max() <= 2
    # scalar draw vs a (B,) draw: the same counter layout as JAX's
    want = _jax(jax.vmap(lambda k: jax.random.normal(k, (3,), jnp.float32)),
                jk)
    assert _ulps(threefry.normal(tk, (3,)).numpy(), want).max() <= 2


@pytest.mark.parametrize("name,lo,hi,log_space", [
    ("exp", -87.0, 88.3, False), ("exp", -6.0, 6.0, False),
    ("log", 1e-37, 3e38, True), ("log", 1e-7, 1.0, False),
    ("log1p", -0.9999999, 0.9999, False), ("log1p", 1.0, 1e30, True)])
def test_xla_transcendentals_bit_exact(name, lo, hi, log_space):
    rng = np.random.default_rng(7)
    x = (np.exp(rng.uniform(np.log(lo), np.log(hi), 200_000)) if log_space
         else rng.uniform(lo, hi, 200_000)).astype(np.float32)
    want = _jax(jax.jit(getattr(jnp, name)), x)
    got = getattr(threefry, name)(torch.from_numpy(x.copy())).numpy()
    np.testing.assert_array_equal(got, want)


def test_log_special_values():
    x = np.array([0.0, -1.0, np.inf, 1.0, 2.0], np.float32)
    got = threefry.log(torch.from_numpy(x)).numpy()
    assert got[0] == -np.inf and np.isnan(got[1]) and got[2] == np.inf
    assert got[3] == 0.0 and got[4] == np.float32(np.log(2.0))


def test_erf_inv_within_1_ulp():
    rng = np.random.default_rng(3)
    x = rng.uniform(-0.99999994, 0.99999994, 400_000).astype(np.float32)
    want = _jax(jax.jit(jax.lax.erf_inv), x)
    got = threefry.erf_inv(torch.from_numpy(x.copy())).numpy()
    assert _ulps(got, want).max() <= 1
    assert (_ulps(got, want) > 0).mean() < 1e-4
    edge = threefry.erf_inv(torch.tensor([1.0, -1.0])).numpy()
    assert edge[0] == np.inf and edge[1] == -np.inf
