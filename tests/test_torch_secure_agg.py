"""The port's secure-aggregation masks against the JAX package's.

``repro_torch.core.secure_agg`` draws its pairwise masks with the port's
threefry (``utils/threefry.py``), so for the same round key, cohort and
update they must equal ``repro.core.secure_agg``'s bit for bit. The updates
are LeNet-shaped (the JAX init's leaves, numpy from a seed).
"""
import numpy as np
import pytest
import torch

from repro_torch.core.secure_agg import mask_update, secure_sum
from repro_torch.utils import threefry


def _jax():
    import jax
    import jax.numpy as jnp

    return jax, jnp


@pytest.fixture(scope="module")
def lenet_updates():
    """Five LeNet-shaped updates (numpy, seeded), the JAX init's leaves."""
    jax, _ = _jax()
    from repro.models.lenet import init_lenet

    shapes = jax.tree.map(lambda a: a.shape, init_lenet(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(7)
    return [jax.tree.map(lambda s: (0.01 * rng.standard_normal(s))
                         .astype(np.float32), shapes,
                         is_leaf=lambda x: isinstance(x, tuple))
            for _ in range(5)]


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _leaves(tree):
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    return [np.asarray(tree)]


def _jax_masked(updates, ids, seed, scale):
    jax, jnp = _jax()
    from repro.core.secure_agg import mask_update as j_mask_update

    rk = jax.random.PRNGKey(seed)
    return [jax.tree.map(np.asarray, j_mask_update(
        rk, jax.tree.map(jnp.asarray, u), i, ids, scale=scale))
        for u, i in zip(updates, ids)]


@pytest.mark.parametrize("ids,seed,scale", [
    ([0, 1, 2], 0, 1.0),
    ([3, 7, 11, 20], 5, 1.0),
    ([2, 4, 6, 8, 10], 9, 0.25),
])
def test_masks_equal_jax_bit_for_bit(lenet_updates, ids, seed, scale):
    updates = lenet_updates[:len(ids)]
    want = _jax_masked(updates, ids, seed, scale)
    rk = threefry.prng_key(seed)
    for u, i, w in zip(updates, ids, want):
        got = mask_update(rk, _torch(u), i, ids, scale=scale)
        for a, b in zip(_leaves(got), _leaves(w)):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), i
        # the mask alone: the masked update less the update
        mask = [a - b for a, b in zip(_leaves(got), _leaves(u))]
        assert max(np.abs(m).max() for m in mask) > 0.1 * scale


def test_secure_sum_of_masked_equals_the_raw_sum(lenet_updates):
    ids = [3, 7, 11, 20]
    updates = [_torch(u) for u in lenet_updates[:4]]
    rk = threefry.prng_key(1)
    masked = [mask_update(rk, u, i, ids) for u, i in zip(updates, ids)]
    raw, sec = secure_sum(updates), secure_sum(masked)
    for a, b in zip(_leaves(sec), _leaves(raw)):
        # four masks of scale 1 cancel to f32 rounding of their sum
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-6)


def test_secure_sum_matches_jax(lenet_updates):
    jax, _ = _jax()
    from repro.core.secure_agg import secure_sum as j_secure_sum

    ids = [0, 1, 2]
    want = j_secure_sum(_jax_masked(lenet_updates[:3], ids, 2, 1.0))
    rk = threefry.prng_key(2)
    got = secure_sum([mask_update(rk, _torch(u), i, ids)
                      for u, i in zip(lenet_updates[:3], ids)])
    for a, b in zip(_leaves(got), _leaves(jax.tree.map(np.asarray, want))):
        assert a.tobytes() == b.tobytes()


def test_empty_cohort_raises_value_error():
    """As the JAX package's: an empty buffer drain is a protocol error."""
    with pytest.raises(ValueError, match="at least one"):
        secure_sum([])
