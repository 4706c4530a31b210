"""The port on a CUDA device: kernels against their plain versions, and the
engine on the card against the engine on the CPU.

Every test here needs a card and skips without one. The file imports
nothing of JAX, so on a machine with a card and no JAX it runs as

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: kernel vs plain version rtol 1e-4 (both sum f32 terms, in
different orders); the engine on the card vs on the CPU rtol 1e-3 on the
round log and atol 1e-5 on the params (cuDNN vs CPU convolutions, with TF32
off, over 3 rounds). K5 at bf16: the plain version computes in f32 and
rounds the output once; the kernel's products run on the tensor cores with
P carried as two bf16 terms (within 2^-16 relative) and f32 sums, so the
two differ by at most one bf16 ulp of the output (rtol 8e-3). The 2-layer
full-width Hymba prefill on the card vs on the CPU at f32: atol 1e-4 times
the largest logit (the same f32 maths, cuBLAS vs CPU matmuls, over 2
layers).
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.configs.base import FLConfig
from repro_torch.core import run_async
from repro_torch.kernels.flash_attn import ops as fa_ops
from repro_torch.kernels.flash_attn import ref as fa_ref
from repro_torch.kernels.ring_codec import ops as rc_ops
from repro_torch.kernels.ring_codec import ref as rc_ref
from repro_torch.kernels.ssm_scan import ops as ss_ops
from repro_torch.kernels.ssm_scan import ref as ss_ref
from repro_torch.kernels.weighted_agg import ops, ref
from repro_torch.models import Model, init_lenet, lenet_loss
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
@pytest.mark.parametrize("n", [1, 3, 1023, 44426, 130007])
@pytest.mark.parametrize("k", [1, 9, 33, 64])
def test_weighted_sum_kernel_edges(cuda, k, n):
    """K3 at K = 1, a partial row group (9), one past two groups (33) and
    four groups (64); N below one block, and odd N, whose odd rows start off
    the 16-byte grid (scalar loads)."""
    _, _, deltas, p, _, _ = _case(k, n, cuda)
    w = p / p.mean() - 0.5
    ops.reset_launches()
    got = ops.weighted_sum(deltas, w)
    assert ops.weighted_sum.launches == 1
    assert torch.equal(got, ops.weighted_sum(deltas, w))
    torch.testing.assert_close(got, ref.weighted_sum_ref(deltas, w),
                               rtol=1e-4, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1, 2])
def test_weighted_sum_kernel_unaligned_rows(cuda, offset):
    """Rows of a view that starts ``offset`` floats into its storage: the
    16-byte path only where the pointers allow it (offset 0)."""
    k, n = 10, 49152
    _, _, deltas, p, _, _ = _case(k, n, cuda)
    store = torch.zeros(k * n + offset, device=cuda)
    store[offset:] = deltas.reshape(-1)
    view = store[offset:].view(k, n)
    w = p / p.mean()
    got = ops.weighted_sum(view, w)
    assert torch.equal(got, ops.weighted_sum(deltas, w))
    torch.testing.assert_close(got, ref.weighted_sum_ref(deltas, w),
                               rtol=1e-4, atol=1e-6)


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,hkv,d,window", [
    (2, 1, 25, 5, 64, 1024),     # one token
    (2, 200, 25, 5, 64, 64),     # ragged S, window, n_rep 5
    (2, 333, 4, 4, 32, 0),       # ragged S, causal, n_rep 1
    (2, 512, 5, 1, 64, 1024),    # window wider than S
    (2, 130, 8, 2, 128, 48),     # D = 128, ragged, window not a tile multiple
    # S on each side of the kv tile (64 keys) and the query tile (128 rows)
    (2, 63, 25, 5, 64, 0),
    (2, 64, 4, 4, 32, 64),       # window = the kv tile
    (2, 65, 5, 1, 64, 1024),
    (2, 127, 8, 2, 128, 0),
    (2, 129, 25, 5, 64, 128),    # window = the query tile
    (2, 300, 4, 2, 64, 1),       # window 1: the diagonal alone
    (2, 200, 10, 2, 32, 96),     # D 32, 64, 128 with n_rep 5
    (2, 257, 25, 5, 64, 1024),
    (2, 190, 10, 2, 128, 0),
    (1, 4096, 25, 5, 64, 1024),  # the Hymba-1.5B prefill's shape at B = 1
])
def test_flash_attention_kernel_matches_plain(cuda, dtype, b, s, h, hkv, d,
                                              window):
    g = torch.Generator().manual_seed(s + h + d)
    q = torch.randn(b, s, h, d, generator=g).to(cuda, dtype)
    k = torch.randn(b, s, hkv, d, generator=g).to(cuda, dtype)
    v = torch.randn(b, s, hkv, d, generator=g).to(cuda, dtype)
    fa_ops.reset_launches()
    out = fa_ops.flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    assert fa_ops.flash_attention.launches == 1
    assert out.dtype == dtype and out.shape == q.shape
    # no atomics: a second launch gives the same bits
    assert torch.equal(out, fa_ops.flash_attention(q, k, v, window=window))
    want = fa_ref.flash_attention_ref(q, k, v, window=window)
    tol = dict(rtol=1e-4, atol=1e-5) if dtype == torch.float32 else \
        dict(rtol=8e-3, atol=1e-5)
    torch.testing.assert_close(out.float(), want.float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,di,n", [(2, 64, 3200, 16), (1, 333, 100, 16),
                                      (3, 37, 70, 8), (1, 1, 64, 4),
                                      (2, 100, 130, 32)])
def test_selective_scan_kernel_matches_plain(cuda, b, s, di, n):
    g = torch.Generator().manual_seed(b * 1000 + s + di + n)
    x = torch.randn(b, s, di, generator=g)
    dt = torch.nn.functional.softplus(torch.randn(b, s, di, generator=g) - 1)
    bb = torch.randn(b, s, n, generator=g)
    c = torch.randn(b, s, n, generator=g)
    a = -torch.exp(0.5 * torch.randn(di, n, generator=g))
    args = [t.to(cuda) for t in (x, dt, bb, c, a)]
    ss_ops.reset_launches()
    y = ss_ops.selective_scan(*args)
    torch.cuda.synchronize()
    assert ss_ops.selective_scan.launches == 1
    want = ss_ref.selective_scan_ref(*args)
    torch.testing.assert_close(y, want, rtol=1e-4,
                               atol=1e-5 * float(want.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,di,n", [
    # di off the 32-channel tile; S at 1 and on each side of the 32-step chunk
    *[(2, s, di, n) for di in (70, 130) for n in (4, 8, 32)
      for s in (1, 31, 33)],
    (1, 1000, 64, 16),  # a grid of 2 blocks, far smaller than the card
])
def test_selective_scan_kernel_edges(cuda, b, s, di, n):
    g = torch.Generator().manual_seed(b * 1000 + s + di + n)
    x = torch.randn(b, s, di, generator=g)
    dt = torch.nn.functional.softplus(torch.randn(b, s, di, generator=g) - 1)
    bb = torch.randn(b, s, n, generator=g)
    c = torch.randn(b, s, n, generator=g)
    a = -torch.exp(0.5 * torch.randn(di, n, generator=g))
    args = [t.to(cuda) for t in (x, dt, bb, c, a)]
    ss_ops.reset_launches()
    y = ss_ops.selective_scan(*args)
    torch.cuda.synchronize()
    assert ss_ops.selective_scan.launches == 1
    assert torch.equal(y, ss_ops.selective_scan(*args))  # no atomics
    want = ss_ref.selective_scan_ref(*args)
    torch.testing.assert_close(y, want, rtol=1e-4,
                               atol=1e-5 * float(want.abs().max()))


@pytest.mark.cuda
def test_hymba_full_width_prefill_card_matches_cpu(cuda):
    """Hymba-1.5B at full width, 2 layers, f32, S = 512: K5 and K6 on the
    card against their plain versions on the CPU, through prefill_logits."""
    cfg = get_arch("hymba-1.5b").model.replace(
        num_layers=2, param_dtype="float32", compute_dtype="float32")
    card = Model(cfg, device="cuda")
    params = card.init(torch.Generator(device="cuda").manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, 512)))
    fa_ops.reset_launches()
    ss_ops.reset_launches()
    with torch.no_grad():
        got = card.prefill_logits(params, {"tokens": tokens.to(cuda)})
        torch.cuda.synchronize()
        assert (fa_ops.flash_attention.launches,
                ss_ops.selective_scan.launches) == (2, 2)
        want = Model(cfg, device="cpu").prefill_logits(_to_cpu(params),
                                                      {"tokens": tokens})
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.cpu(), want, rtol=0,
                               atol=1e-4 * float(want.abs().max()))


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree.cpu()
