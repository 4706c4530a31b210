"""The port's K4 wrapper and plain version against the JAX package's.

On the CPU the port's ``ops.int8_sq_dists`` runs its plain version
(``ref.py``); the JAX side runs both its jnp reference and the Pallas kernel
in interpret mode, as the JAX package's own tests do. Tolerance rtol/atol
1e-5: both sum the same f32 squared differences in different orders. The
decode itself (product and sum rounded separately) is compared exactly.

The CUDA kernel is held against the plain version on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ring_codec import dequant_ref as j_dequant
from repro.kernels.ring_codec import int8_sq_dists_ref as j_ref
from repro.kernels.ring_codec.kernel import int8_sq_dists_pallas
from repro_torch.kernels.ring_codec import kernel as tkernel
from repro_torch.kernels.ring_codec import ops as tops
from repro_torch.kernels.ring_codec import ref as tref

RTOL = ATOL = 1e-5

# (k, n, qblock, block_n): the shapes of tests/test_version_store.py
SHAPES = [(1, 256, 128, 256), (3, 512, 128, 256), (5, 1024, 256, 512),
          (8, 2048, 64, 256), (4, 640, 128, 128)]


def _case(k, n, qblock, seed=0):
    """int8 codes, per-block scale/zero (one block per row at scale 0, a
    constant block) and x, from numpy."""
    rng = np.random.default_rng(seed + 1000 * k + n)
    codes = rng.integers(-127, 128, size=(k, n)).astype(np.int8)
    scales = rng.uniform(1e-4, 2e-2, size=(k, n // qblock)).astype(np.float32)
    scales[:, -1] = 0.0
    zeros = rng.normal(size=(k, n // qblock)).astype(np.float32)
    x = rng.normal(size=n).astype(np.float32)
    return x, codes, scales, zeros


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("k,n,qblock,block_n", SHAPES)
def test_int8_sq_dists_matches_jax(k, n, qblock, block_n):
    x, codes, scales, zeros = _case(k, n, qblock)
    want_ref = np.asarray(j_ref(x, codes, scales, zeros, qblock))
    want_kernel = np.asarray(int8_sq_dists_pallas(
        jnp.asarray(x), jnp.asarray(codes), jnp.asarray(scales),
        jnp.asarray(zeros), qblock=qblock, block_n=block_n, interpret=True))
    got_ref = tref.int8_sq_dists_ref(*_t(x, codes, scales, zeros), qblock)
    got_ops = tops.int8_sq_dists(*_t(x, codes, scales, zeros), qblock=qblock)
    assert got_ops.shape == (k,) and got_ops.dtype == torch.float32
    for got in (got_ref, got_ops):
        for want in (want_ref, want_kernel):
            np.testing.assert_allclose(got.numpy(), want, rtol=RTOL,
                                       atol=ATOL)


@pytest.mark.parametrize("k,n,qblock,block_n", SHAPES)
def test_dequant_is_bit_identical_to_jax(k, n, qblock, block_n):
    _, codes, scales, zeros = _case(k, n, qblock)
    got = tref.dequant_ref(*_t(codes, scales, zeros), qblock).numpy()
    want = np.asarray(j_dequant(codes, scales, zeros, qblock))
    assert got.tobytes() == want.tobytes()
    # a scale-0 block decodes to its zero exactly
    np.testing.assert_array_equal(got[:, -qblock:],
                                  np.repeat(zeros[:, -1:], qblock, axis=1))


def test_cpu_path_never_builds(monkeypatch):
    """CPU tensors take the plain version and never touch nvcc."""

    def refuse(*a, **k):
        raise AssertionError("the CPU path tried to build or load K4")

    monkeypatch.setattr(tkernel.LIBRARY, "build", refuse)
    monkeypatch.setattr(tkernel.LIBRARY, "load", refuse)
    before = tops.int8_sq_dists.launches
    tops.int8_sq_dists(*_t(*_case(2, 512, 128)), qblock=128)
    assert tops.int8_sq_dists.launches == before


def test_wrapper_rejects_bad_inputs():
    x, codes, scales, zeros = _t(*_case(3, 512, 128))
    with pytest.raises(TypeError, match="int8"):
        tops.int8_sq_dists(x, codes.to(torch.int16), scales, zeros,
                           qblock=128)
    with pytest.raises(TypeError, match="float32"):
        tops.int8_sq_dists(x.double(), codes, scales, zeros, qblock=128)
    with pytest.raises(TypeError, match="float32"):
        tops.int8_sq_dists(x, codes, scales.half(), zeros, qblock=128)
    with pytest.raises(ValueError, match="does not divide"):
        tops.int8_sq_dists(x, codes, scales, zeros, qblock=100)
    with pytest.raises(ValueError, match="scales"):
        tops.int8_sq_dists(x, codes, scales[:, :2], zeros, qblock=128)
    with pytest.raises(ValueError, match="x must be"):
        tops.int8_sq_dists(x[:10], codes, scales, zeros, qblock=128)
    with pytest.raises(ValueError, match="contiguous"):
        tops.int8_sq_dists(x, codes.t().contiguous().t(), scales, zeros,
                           qblock=128)
