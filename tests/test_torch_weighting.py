"""The port's eq. 3/4/5 weighting against ``repro.core.weighting``.

Same numpy inputs through both; tolerance rtol 1e-6: the maths is the same
f32 expression in the same order, so only the sums over K (PyTorch's CPU
reduction vs XLA's) may round differently, by an ulp or so.
"""
import numpy as np
import pytest
import torch

from repro.core import weighting as jw
from repro_torch.core import weighting as tw

RTOL, ATOL = 1e-6, 1e-12
K = 9


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    d = rng.uniform(0.0, 2.0, K).astype(np.float32)
    d[2] = 0.0  # a fresh client
    p = rng.uniform(50.0, 150.0, K).astype(np.float32)
    tau = (np.arange(K) % 10).astype(np.float32)  # straddles the hinge knee
    mask = np.ones(K, np.float32)
    mask[[2, 5]] = 0.0  # the fresh slot is absent
    return d, p, tau, mask


def test_policy_table_matches():
    assert tw.POLICIES == jw.POLICIES
    assert tw.FEDASYNC_POLICIES == jw.FEDASYNC_POLICIES


@pytest.mark.parametrize("use_mask", [False, True])
@pytest.mark.parametrize("normalize", ["mean", "none"])
@pytest.mark.parametrize("policy", jw.POLICIES)
def test_contribution_weights(policy, normalize, use_mask):
    d, p, tau, mask = _inputs()
    m = mask if use_mask else None
    j_s = jw.staleness_degree(d, arrival_mask=m)
    t_s = tw.staleness_degree(torch.from_numpy(d),
                              arrival_mask=None if m is None
                              else torch.from_numpy(m))
    np.testing.assert_allclose(t_s.numpy(), np.asarray(j_s), rtol=RTOL,
                               atol=ATOL)
    j_w = jw.contribution_weights(policy, p, j_s, tau, normalize=normalize,
                                  arrival_mask=m)
    t_w = tw.contribution_weights(policy, torch.from_numpy(p), t_s,
                                  torch.from_numpy(tau), normalize=normalize,
                                  arrival_mask=None if m is None
                                  else torch.from_numpy(m))
    assert t_w.dtype == torch.float32
    np.testing.assert_allclose(t_w.numpy(), np.asarray(j_w), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("ref", [0.0, 0.3])
def test_ref_sq_dist(ref):
    d, _, _, _ = _inputs(1)
    np.testing.assert_allclose(
        tw.staleness_degree(torch.from_numpy(d), ref_sq_dist=ref).numpy(),
        np.asarray(jw.staleness_degree(d, ref_sq_dist=ref)), rtol=RTOL,
        atol=ATOL)


@pytest.mark.parametrize("flag", ["constant", "hinge", "poly"])
def test_fedasync_discount(flag):
    tau = np.arange(12, dtype=np.float32)
    np.testing.assert_allclose(
        tw.fedasync_discount(flag, torch.from_numpy(tau)).numpy(),
        np.asarray(jw.fedasync_discount(flag, tau)), rtol=RTOL)


def test_statistical_effect_and_errors():
    _, p, _, _ = _inputs(2)
    sizes = np.full(K, 1500.0, np.float32)
    np.testing.assert_array_equal(
        tw.statistical_effect(torch.from_numpy(p), torch.from_numpy(sizes))
        .numpy(), np.asarray(jw.statistical_effect(p, sizes)))
    with pytest.raises(ValueError):
        tw.contribution_weights("nope", torch.ones(2), torch.ones(2),
                                torch.zeros(2))
    with pytest.raises(ValueError):
        tw.contribution_weights("paper", torch.ones(2), torch.ones(2),
                                torch.zeros(2), normalize="max")
