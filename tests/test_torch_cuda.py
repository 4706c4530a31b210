"""The port on a CUDA device: kernels against their plain versions, and the
engine on the card against the engine on the CPU.

Every test here needs a card and skips without one. The file imports
nothing of JAX, so on a machine with a card and no JAX it runs as

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: kernel vs plain version rtol 1e-4 (both sum f32 terms, in
different orders); the engine on the card vs on the CPU rtol 1e-3 on the
round log and atol 1e-5 on the params (cuDNN vs CPU convolutions, with TF32
off, over 3 rounds).
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.base import FLConfig
from repro_torch.core import run_async
from repro_torch.kernels.ring_codec import ops as rc_ops
from repro_torch.kernels.ring_codec import ref as rc_ref
from repro_torch.kernels.weighted_agg import ops, ref
from repro_torch.models import init_lenet, lenet_loss
from repro_torch.sim.scenarios import get_scenario

POLICIES = ("paper", "multiplicative", "fedbuff", "polynomial", "fedasync",
            "fedasync_constant", "fedasync_hinge", "fedasync_poly")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(k, n, device):
    g = torch.Generator().manual_seed(k * 7 + n)
    x = torch.randn(n, generator=g)
    scale = torch.linspace(0.0, 0.05, k)[:, None]
    bases = x[None] + scale * torch.randn(k, n, generator=g)
    deltas = 0.01 * torch.randn(k, n, generator=g)
    p = 50.0 + 100.0 * torch.rand(k, generator=g)
    taus = torch.arange(k, dtype=torch.float32) % 9
    mask = torch.ones(k)
    mask[[0, k // 2]] = 0.0
    return [t.to(device) for t in (x, bases, deltas, p, taus, mask)]


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", [(1, 1), (10, 49152), (32, 130007)])
def test_kernels_match_plain(cuda, k, n):
    x, bases, deltas, p, taus, mask = _case(k, n, cuda)
    d = ops.sq_dists(x, bases)
    assert torch.equal(d, ops.sq_dists(x, bases))  # fixed summation order
    torch.testing.assert_close(d, ref.sq_dists_ref(x, bases), rtol=1e-4,
                               atol=0.0)
    w = p / p.mean()
    torch.testing.assert_close(ops.weighted_sum(deltas, w),
                               ref.weighted_sum_ref(deltas, w), rtol=1e-4,
                               atol=1e-6)
    for policy in POLICIES:
        for normalize in ("mean", "none"):
            got = ops.server_update(x, bases, deltas, p, taus, mask,
                                    policy=policy, normalize=normalize)
            want = ref.server_update_ref(x, bases, deltas, p, taus, mask,
                                         policy=policy, normalize=normalize)
            for g, w_ in zip(got, want):
                torch.testing.assert_close(
                    g, w_, rtol=1e-4, atol=1e-5 * float(w_.abs().max()))


@pytest.mark.cuda
def test_cuda_wrappers_count_launches(cuda):
    x, bases, deltas, p, taus, mask = _case(4, 1000, cuda)
    ops.reset_launches()
    ops.sq_dists(x, bases)
    ops.weighted_sum(deltas, p)
    ops.server_update(x, bases, deltas, p, taus, mask)
    assert (ops.sq_dists.launches, ops.weighted_sum.launches,
            ops.server_update.launches) == (1, 1, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["fused", "batched"])
def test_engine_on_card_matches_cpu(cuda, mode):
    fl = FLConfig(num_clients=6, buffer_size=3, local_steps=2, batch_size=8,
                  max_staleness=4, server_pass_mode=mode)
    sc = get_scenario("paper-fig1")
    init = init_lenet(torch.Generator().manual_seed(0))
    runs = {}
    for device in ("cuda", "cpu"):
        clients, _ = sc.make_dataset(6, samples_per_client=64, seed=0)
        ops.reset_launches()
        runs[device] = run_async(lenet_loss, init, clients, fl, 3, seed=0,
                                 scenario=sc, device=device)
        if device == "cuda":
            counts = (ops.server_update.launches, ops.sq_dists.launches,
                      ops.weighted_sum.launches)
            assert counts == ((3, 0, 0) if mode == "fused" else (0, 3, 3))
    for a, b in zip(runs["cuda"].round_log, runs["cpu"].round_log):
        assert a["clients"] == b["clients"] and a["tau"] == b["tau"]
        for f in ("sq_dists", "staleness_deg", "stat_effect", "weights"):
            np.testing.assert_allclose(a[f], b[f], rtol=1e-3, atol=1e-6)
    for layer, leaves in runs["cpu"].final_params.items():
        for key, v in leaves.items():
            torch.testing.assert_close(runs["cuda"].final_params[layer][key]
                                       .cpu(), v, rtol=0, atol=1e-5)


def _int8_case(k, n, qblock, device):
    g = torch.Generator().manual_seed(k * 11 + n)
    codes = torch.randint(-127, 128, (k, n), generator=g).to(torch.int8)
    scales = 1e-4 + 2e-2 * torch.rand(k, n // qblock, generator=g)
    scales[:, ::7] = 0.0  # constant blocks
    zeros = torch.randn(k, n // qblock, generator=g)
    x = torch.randn(n, generator=g)
    return [t.to(device) for t in (x, codes, scales, zeros)]


@pytest.mark.cuda
@pytest.mark.parametrize("k,n,qblock", [(1, 256, 128), (4, 640, 64),
                                        (10, 49152, 256), (32, 130048, 128),
                                        (3, 1000, 8)])
def test_int8_kernel_matches_plain(cuda, k, n, qblock):
    x, codes, scales, zeros = _int8_case(k, n, qblock, cuda)
    rc_ops.reset_launches()
    d = rc_ops.int8_sq_dists(x, codes, scales, zeros, qblock=qblock)
    assert torch.equal(d, rc_ops.int8_sq_dists(x, codes, scales, zeros,
                                               qblock=qblock))
    assert rc_ops.int8_sq_dists.launches == 2
    torch.testing.assert_close(
        d, rc_ref.int8_sq_dists_ref(x, codes, scales, zeros, qblock),
        rtol=1e-4, atol=0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("codec", ["int8", "delta"])
def test_codec_engine_on_card_matches_cpu(cuda, codec):
    fl = FLConfig(num_clients=6, buffer_size=3, local_steps=2, batch_size=8,
                  max_staleness=4, ring_codec=codec, ring_base_refresh=2)
    sc = get_scenario("paper-fig1")
    init = init_lenet(torch.Generator().manual_seed(0))
    runs = {}
    for device in ("cuda", "cpu"):
        clients, _ = sc.make_dataset(6, samples_per_client=64, seed=0)
        ops.reset_launches()
        rc_ops.reset_launches()
        runs[device] = run_async(lenet_loss, init, clients, fl, 3, seed=0,
                                 scenario=sc, device=device)
        if device == "cuda":
            counts = (rc_ops.int8_sq_dists.launches,
                      ops.server_update.launches, ops.sq_dists.launches,
                      ops.weighted_sum.launches)
            assert counts == ((3, 0, 0, 3) if codec == "int8"
                              else (0, 0, 0, 3))
    for a, b in zip(runs["cuda"].round_log, runs["cpu"].round_log):
        assert a["clients"] == b["clients"] and a["tau"] == b["tau"]
        for f in ("sq_dists", "staleness_deg", "stat_effect", "weights"):
            np.testing.assert_allclose(a[f], b[f], rtol=1e-3, atol=1e-6)
    for layer, leaves in runs["cpu"].final_params.items():
        for key, v in leaves.items():
            torch.testing.assert_close(runs["cuda"].final_params[layer][key]
                                       .cpu(), v, rtol=0, atol=1e-5)
