"""The port's weighted_agg wrappers against the JAX package's Pallas kernels.

On the CPU the port's ``ops`` run their plain versions (``ref.py``); the JAX
kernels run in interpret mode, as the JAX package's own tests run them.
Tolerance rtol 2e-5, atol 1e-6 (for the fused update, 2e-5 of its largest
element): both sides sum f32 terms in different orders (tiles of 16384 on
the JAX side, PyTorch's reduction on ours), so values agree to a few ulps
of the largest partial sum.

The CUDA kernels themselves are held against the plain versions on the
card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch

from repro.core.weighting import POLICIES
from repro.kernels.weighted_agg import ops as jops
from repro_torch.kernels.weighted_agg import kernel as tkernel
from repro_torch.kernels.weighted_agg import ops as tops

RTOL, ATOL = 2e-5, 1e-6


def _case(k, n, seed=0):
    rng = np.random.default_rng(seed + k * 7 + n)
    x = rng.normal(size=n).astype(np.float32)
    scale = np.linspace(0.0, 0.05, k, dtype=np.float32)[:, None]
    bases = (x[None] + scale * rng.normal(size=(k, n))).astype(np.float32)
    deltas = (0.01 * rng.normal(size=(k, n))).astype(np.float32)
    p = rng.uniform(50.0, 150.0, k).astype(np.float32)
    taus = (np.arange(k) % 9).astype(np.float32)
    mask = np.ones(k, np.float32)
    mask[[0, k // 2]] = 0.0
    return x, bases, deltas, p, taus, mask


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("k,n", [(1, 1000), (8, 1000), (32, 130007)])
def test_sq_dists(k, n):
    x, bases, *_ = _case(k, n)
    want = np.asarray(jops.sq_dists(x, bases, interpret=True))
    got = tops.sq_dists(*_t(x, bases))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    assert got[0] == 0.0  # row 0 is x itself


@pytest.mark.parametrize("k,n", [(1, 1000), (8, 1000), (32, 130007)])
def test_weighted_sum(k, n):
    _, _, deltas, p, *_ = _case(k, n)
    w = (p / p.mean()).astype(np.float32)
    want = np.asarray(jops.weighted_sum(deltas, w, interpret=True))
    got = tops.weighted_sum(*_t(deltas, w))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def _server_update_case(policy, normalize, use_mask, k, n):
    x, bases, deltas, p, taus, mask = _case(k, n)
    m = mask if use_mask else None
    cfg = dict(policy=policy, eta_g=0.7, normalize=normalize)
    want = jops.server_update(x, bases, deltas, p, taus, m, interpret=True,
                              **cfg)
    got = tops.server_update(*_t(x, bases, deltas, p, taus),
                             None if m is None else torch.from_numpy(m), **cfg)
    for name, g, w in zip(("upd", "sq_dists", "weights"), got, want):
        w = np.asarray(w)
        # upd sums K terms with cancellation: its rounding scales with the
        # largest term, so the absolute bound does too
        atol = RTOL * float(np.abs(w).max()) if name == "upd" else ATOL
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL, atol=atol,
                                   err_msg=name)


@pytest.mark.parametrize("use_mask", [False, True])
@pytest.mark.parametrize("normalize", ["mean", "none"])
@pytest.mark.parametrize("policy", POLICIES)
def test_server_update_small(policy, normalize, use_mask):
    _server_update_case(policy, normalize, use_mask, 8, 1000)


@pytest.mark.parametrize("policy", POLICIES)
def test_server_update_ragged(policy):
    _server_update_case(policy, "mean", True, 32, 130007)


def test_pick_block_matches_jax():
    for n in (1, 127, 128, 1000, 16383, 16384, 44426, 130007):
        assert tops.pick_block(n) == jops.pick_block(n)
        assert tops.pad_to(n, 16384) == jops.pad_to(n, 16384)


def test_cpu_path_never_builds(monkeypatch):
    """CPU tensors take the plain versions and never touch nvcc."""

    def refuse(*a, **k):
        raise AssertionError("the CPU path tried to build or load the kernels")

    monkeypatch.setattr(tkernel.LIBRARY, "build", refuse)
    monkeypatch.setattr(tkernel.LIBRARY, "load", refuse)
    x, bases, deltas, p, taus, mask = _t(*_case(4, 300))
    before = (tops.sq_dists.launches, tops.weighted_sum.launches,
              tops.server_update.launches)
    tops.sq_dists(x, bases)
    tops.weighted_sum(deltas, p)
    tops.server_update(x, bases, deltas, p, taus, mask)
    assert (tops.sq_dists.launches, tops.weighted_sum.launches,
            tops.server_update.launches) == before


def test_wrappers_validate_shapes():
    x, bases, deltas, p, taus, _ = _t(*_case(4, 300))
    with pytest.raises(ValueError):
        tops.sq_dists(x[:10], bases)
    with pytest.raises(ValueError):
        tops.weighted_sum(deltas, p[:2])
    with pytest.raises(ValueError):
        tops.server_update(x, bases, deltas[:2], p, taus)
    with pytest.raises(ValueError):
        tops.server_update(x, bases, deltas, p, taus, policy="nope")
