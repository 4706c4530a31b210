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
layers). Slice C: the cohort step with straggler masks on the card
against reference mode on the card and on the CPU (rtol 1e-3 / atol 1e-5,
as the engine); ``aggregate_fused`` (one K3 launch) against ``aggregate``
(rtol 1e-5); the serving controller on the card against the CPU (the same
counters and fold journal exactly, params atol 1e-5); pulls from worker
threads while the fold thread applies (digests exact). Slice D: threefry
draws (keys, bits, ``randint``, ``uniform``, ``normal``, XLA's ``exp`` and
``log``) on the card bit-identical to the CPU's (IEEE operations only); the
population windows on the card equal the host twin's and the CPU's exactly;
``run_population`` in fused/batched mode against reference mode and the CPU
(events exact, weights rtol 1e-3 / atol 1e-5, as the engine); resume
bit-identical at the entry point's own cuDNN/TF32 flags, the caller's flags
restored.
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
from repro_torch.kernels.weighted_agg import kernel, ops, ref
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
@pytest.mark.parametrize("n", [1, 3, 2047, 2049, 44426, 600000])
@pytest.mark.parametrize("k", [1, 9, 33, 64])
def test_fused_server_kernel_edges(cuda, k, n):
    """K1, one cooperative launch, at K = 1 and K past the 8-row groups;
    N on each side of a 2,048-element distance tile, odd N (scalar loads in
    the eq. 5 phase) and more than 256 tiles a row (600,000). Every policy,
    no mask and a mask that drops every slot: a second call gives the same
    bits, the distances are K2's bit for bit, the update is K3's on
    ``w * eta_g / k_eff`` bit for bit, and all three are within the plain
    version's tolerance."""
    x, bases, deltas, p, taus, _ = _case(k, n, cuda)
    dists = ops.sq_dists(x, bases)
    eta_g = 0.7
    for mask in (None, torch.zeros(k, device=cuda)):
        ones = torch.ones(k, device=cuda) if mask is None else mask
        # an f32 tensor over an f32 tensor, as the kernel's eta_g / k_eff
        scale = (torch.tensor(eta_g, dtype=torch.float32, device=cuda)
                 / torch.clamp(ones.sum(), min=1.0))
        for policy in POLICIES:
            cfg = dict(policy=policy, normalize="mean", eta_g=eta_g)
            upd, d, w = ops.server_update(x, bases, deltas, p, taus, mask,
                                          **cfg)
            again = ops.server_update(x, bases, deltas, p, taus, mask, **cfg)
            assert all(torch.equal(a, b) for a, b in zip((upd, d, w), again))
            assert torch.equal(d, dists)
            assert torch.equal(upd, ops.weighted_sum(deltas, w * scale))
            want = ref.server_update_ref(x, bases, deltas, p, taus, mask,
                                         **cfg)
            for g, w_ in zip((upd, d, w), want):
                torch.testing.assert_close(
                    g, w_, rtol=1e-4, atol=1e-5 * float(w_.abs().max()))


@pytest.mark.cuda
def test_fused_server_refused_launch_raises(cuda):
    """K1 keeps 6 K-vectors in shared memory: at K = 10,000 (240 KB) the
    cooperative launch is refused, and the wrapper raises rather than fall
    back to another form."""
    x, bases, deltas, p, taus, _ = _case(10_000, 1, cuda)
    with pytest.raises(RuntimeError, match="fused_server launch failed"):
        ops.server_update(x, bases, deltas, p, taus)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 1000, 2047, 2049, 44426, 130007, 600000])
@pytest.mark.parametrize("k", [1, 3, 5, 64])
def test_sq_dists_kernel_edges(cuda, k, n):
    """K2, one launch with arrival tickets, at K = 1, K off the 4-row
    groups (3, 5) and many groups (64); N below one 2,048-element tile, on
    each side of it, ragged and odd, and more than 256 tiles a row
    (600,000), so the wrapper takes tasks of 1 row at some shapes and of 4
    at others. One launch a call; the distances equal K1's bit for bit; a
    second call gives the same bits (the tickets are zero again); within
    the plain version's tolerance."""
    x, bases, deltas, p, taus, _ = _case(k, n, cuda)
    _, k1_dists, _ = ops.server_update(x, bases, deltas, p, taus)
    ops.reset_launches()
    d = ops.sq_dists(x, bases)
    assert ops.sq_dists.launches == 1
    assert torch.equal(d, k1_dists)
    assert torch.equal(d, ops.sq_dists(x, bases))
    torch.testing.assert_close(d, ref.sq_dists_ref(x, bases), rtol=1e-4,
                               atol=0.0)


@pytest.mark.cuda
def test_sq_dists_kernel_streams_keep_their_tickets(cuda):
    """Calls back to back on two streams at once, each stream with its own
    ticket buffer: every call gives the same bits."""
    x, bases, *_ = _case(10, 49152, cuda)
    want = ops.sq_dists(x, bases)
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    outs = []
    for _ in range(20):
        for s in streams:
            with torch.cuda.stream(s):
                outs.append(ops.sq_dists(x, bases))
    torch.cuda.synchronize()
    assert all(torch.equal(o, want) for o in outs)


@pytest.mark.cuda
def test_sq_dists_kernel_refuses_graph_capture(cuda):
    """K2's tickets belong to the stream a call runs on, so a call inside a
    CUDA graph capture raises rather than tie a graph to them."""
    x, bases, *_ = _case(10, 49152, cuda)
    side = torch.cuda.Stream()
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="CUDA graph"):
        with torch.cuda.graph(graph, stream=side):
            kernel.sq_dists(x, bases)


@pytest.mark.cuda
def test_legacy_engine_on_card_matches_cpu(cuda):
    """One round of the per-event legacy engine in batched mode: K2 and K3
    once each, the round log within the engine tests' tolerance of the
    CPU run."""
    fl = FLConfig(num_clients=6, buffer_size=3, local_steps=2, batch_size=8,
                  max_staleness=4, server_pass_mode="batched")
    sc = get_scenario("paper-fig1")
    init = init_lenet(torch.Generator().manual_seed(0))
    runs = {}
    for device in ("cuda", "cpu"):
        clients, _ = sc.make_dataset(6, samples_per_client=64, seed=0)
        ops.reset_launches()
        runs[device] = run_async(lenet_loss, init, clients, fl, 1, seed=0,
                                 scenario=sc, engine="legacy", device=device)
        if device == "cuda":
            assert (ops.server_update.launches, ops.sq_dists.launches,
                    ops.weighted_sum.launches) == (0, 1, 1)
    a, b = runs["cuda"].round_log[0], runs["cpu"].round_log[0]
    assert a["clients"] == b["clients"] and a["tau"] == b["tau"]
    for f in ("sq_dists", "staleness_deg", "stat_effect", "weights"):
        np.testing.assert_allclose(a[f], b[f], rtol=1e-3, atol=1e-6)


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
@pytest.mark.parametrize("n,qblock", [(1000, 8), (49152, 8), (49152, 64),
                                      (49152, 256), (4096 * 257, 8),
                                      (4096 * 257, 64), (4096 * 257, 256)])
@pytest.mark.parametrize("k", [1, 17, 33, 64])
def test_int8_kernel_edges(cuda, k, n, qblock):
    """K4, one cooperative launch, at K = 1 and K past the 8-row groups;
    qblock 8 (a scale run starts inside a thread's 16 codes), 64 and 256;
    element loads (N = 1,000) and more than 256 tiles a row (4096 x 257)."""
    x, codes, scales, zeros = _int8_case(k, n, qblock, cuda)
    rc_ops.reset_launches()
    d = rc_ops.int8_sq_dists(x, codes, scales, zeros, qblock=qblock)
    assert rc_ops.int8_sq_dists.launches == 1
    assert torch.equal(d, rc_ops.int8_sq_dists(x, codes, scales, zeros,
                                               qblock=qblock))
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


# ---------------------------------------------------------------------------
# Slice C: the cohort step, the serving controller, aggregate_fused
# ---------------------------------------------------------------------------

# stragglers; the slots that arrived last round (tau 0) absent; everyone
COHORT_MASKS = ([1, 0, 1, 0], [0, 1, 0, 1], [1, 1, 1, 1])


def _cohort_rounds(c=4, m=2, b=8):
    rng = np.random.default_rng(0)
    return [{"local": (rng.normal(size=(c, m, b, 28, 28, 1)).astype(
                 np.float32), rng.integers(0, 10, (c, m, b)).astype(np.int32)),
             "probe": (rng.normal(size=(c, b, 28, 28, 1)).astype(np.float32),
                       rng.integers(0, 10, (c, b)).astype(np.int32)),
             "arrival": np.asarray(mask, np.float32),
             "data_sizes": np.asarray([40.0, 80.0, 20.0, 60.0], np.float32)}
            for mask in COHORT_MASKS]


def _cohort_run(mode, device, rounds):
    from repro_torch.core import init_cohort_state, make_cohort_step

    fl = FLConfig(buffer_size=4, local_steps=2, local_lr=0.05,
                  server_pass_mode=mode)
    step = make_cohort_step(lenet_loss, fl, device=device)
    init = init_lenet(torch.Generator().manual_seed(0), device=device)
    state, mets = init_cohort_state(init, 4), []
    ops.reset_launches()
    for batch in rounds:
        state, m = step(state, batch)
        mets.append({k: float(v) for k, v in m.items()})
    launches = (ops.server_update.launches, ops.sq_dists.launches,
                ops.weighted_sum.launches)
    return state, mets, launches


@pytest.mark.cuda
def test_cohort_step_on_card_matches_reference_and_cpu(cuda):
    """The cohort step with straggler masks (the fresh slots absent in
    round 2): fused (K1 once a round) and batched (K2 + K3) on the card
    against reference on the card and on the CPU (rtol 1e-3 on the
    telemetry, atol 1e-5 on the params, as the engine above)."""
    rounds = _cohort_rounds()
    runs = {mode: _cohort_run(mode, "cuda", rounds)
            for mode in ("fused", "batched", "reference")}
    runs["cpu"] = _cohort_run("reference", "cpu", rounds)
    assert runs["fused"][2] == (3, 0, 0)
    assert runs["batched"][2] == (0, 3, 3)
    assert runs["reference"][2] == (0, 0, 0)
    want_state, want_mets, _ = runs["cpu"]
    for name in ("fused", "batched", "reference"):
        state, mets, _ = runs[name]
        for a, b in zip(mets, want_mets):
            for key in b:
                np.testing.assert_allclose(a[key], b[key], rtol=1e-3,
                                           atol=1e-6, err_msg=f"{name} {key}")
        assert state.client_version.tolist() == \
            want_state.client_version.tolist()
        for field in ("global_params", "client_params", "client_base"):
            got, want = getattr(state, field), getattr(want_state, field)
            for layer, leaves in want.items():
                for key, v in leaves.items():
                    torch.testing.assert_close(got[layer][key].cpu(), v,
                                               rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_aggregate_fused_on_card_is_one_k3_launch(cuda):
    from repro_torch.core import aggregate, aggregate_fused

    g = torch.Generator().manual_seed(3)
    params = init_lenet(g, device="cuda")
    deltas = {layer: {k: 0.01 * torch.randn((10,) + tuple(v.shape),
                                            generator=g).cuda()
                      for k, v in leaves.items()}
              for layer, leaves in params.items()}
    w = torch.rand(10, generator=g).cuda() + 0.5
    ops.reset_launches()
    new_f, upd_f = aggregate_fused(params, deltas, w, 0.9, 10)
    assert ops.weighted_sum.launches == 1
    new_a, upd_a = aggregate(params, deltas, w, 0.9, 10)
    for layer in params:
        for key in params[layer]:
            torch.testing.assert_close(new_f[layer][key], new_a[layer][key],
                                       rtol=1e-5, atol=1e-6)
            torch.testing.assert_close(upd_f[layer][key], upd_a[layer][key],
                                       rtol=1e-4, atol=1e-7)


def _serve(device, rounds=4):
    from repro_torch.core import ServeConfig, ServingController, serve_stream
    from repro_torch.sim.arrivals import TrafficGenerator

    sc = get_scenario("paper-fig1")
    clients, _ = sc.make_dataset(8, samples_per_client=64, seed=0)
    fl = FLConfig(num_clients=8, buffer_size=4, local_steps=1, batch_size=8,
                  max_staleness=12)
    ctrl = ServingController(lenet_loss,
                             init_lenet(torch.Generator().manual_seed(0)), fl,
                             ServeConfig(adapt_every=2), device=device)
    folds = []
    ctrl.fold_hook = lambda up, tau: folds.append((up.client_id, up.seq, tau))
    out = serve_stream(ctrl, TrafficGenerator(clients, sc.behavior(
        8, seed=0), fl), max_rounds=rounds)
    return ctrl, out, folds


@pytest.mark.cuda
def test_serving_controller_on_card_matches_cpu(cuda):
    """The same scenario stream served on the card and on the CPU: the same
    counters, K trajectory and fold journal; params within atol 1e-5."""
    ctrl, out, folds = _serve("cuda")
    cpu_ctrl, cpu_out, cpu_folds = _serve("cpu")
    assert folds == cpu_folds
    for key in ("admitted", "folded", "rounds", "version", "k", "k_history",
                "round_latency_p50", "round_latency_p99"):
        assert out[key] == cpu_out[key], key
    for layer, leaves in cpu_ctrl.params.items():
        for key, v in leaves.items():
            assert ctrl.params[layer][key].is_cuda
            torch.testing.assert_close(ctrl.params[layer][key].cpu(), v,
                                       rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_card_pulls_stay_those_of_their_version(cuda):
    """``pull`` hammered from worker threads while the fold thread applies
    on the card: every pulled pair, serialised outside the lock (a device
    to host copy), hashes to the digest recorded at that version's apply."""
    import sys
    import threading

    from repro_torch.core import ServeConfig, ServingController
    from repro_torch.core.serving import tree_to_wire
    from repro_torch.sim.arrivals import draw_upload
    from repro_torch.transport import wire

    clients, _ = get_scenario("paper-fig1").make_dataset(
        2, samples_per_client=64, seed=0)
    fl = FLConfig(buffer_size=1, local_steps=1, batch_size=8,
                  max_staleness=1000)
    ctrl = ServingController(lenet_loss,
                             init_lenet(torch.Generator().manual_seed(0)), fl,
                             ServeConfig(adapt_every=0, k_min=1,
                                         queue_capacity=256), device="cuda")
    digests = {0: wire.params_sha256(*ctrl.pull())}
    pulled, stop = [], threading.Event()

    def puller():
        while not stop.is_set():
            v, p = ctrl.pull()
            tensors = {}
            tree_to_wire("params", p, tensors)
            pulled.append((v, tensors))

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    threads = [threading.Thread(target=puller) for _ in range(6)]
    try:
        for t in threads:
            t.start()
        for i in range(30):
            up = draw_upload(clients[i % 2], i % 2, fl,
                             base_version=ctrl.version, t=0.0, seq=i)
            ctrl.offer(up, 0.0)
            ctrl.pump(0.0)
            digests[ctrl.version] = wire.params_sha256(*ctrl.pull())
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=60)
        sys.setswitchinterval(prev)
    assert not any(t.is_alive() for t in threads)
    assert ctrl.version == 30 and len(pulled) > 30
    for v, tensors in pulled:
        tree = {}
        for name, arr in tensors.items():
            _, layer, key = name.split(".")
            tree.setdefault(layer, {})[key] = arr
        assert wire.params_sha256(v, tree) == digests[v]


@pytest.mark.cuda
def test_fold_thread_on_card_replays_to_same_digest(cuda, tmp_path):
    """``AggregatorServer.serve`` on a thread that is not the main one, so
    the local training and every device call of the folds run there; two
    tcp clients; the fold journal replayed in process on the card lands on
    the live digest (deterministic cuDNN, as serve_fl sets it)."""
    import threading

    from repro_torch.core import ServeConfig, ServingController
    from repro_torch.launch.serve_fl import _attach_journal, replay_journal
    from repro_torch.transport import wire
    from repro_torch.transport.client import RemoteAggregator, run_client
    from repro_torch.transport.server import AggregatorServer

    sc = get_scenario("paper-fig1")
    fl = FLConfig(num_clients=4, buffer_size=4, local_steps=1, batch_size=8,
                  max_staleness=100)

    def controller():
        return ServingController(
            lenet_loss, init_lenet(torch.Generator().manual_seed(0)), fl,
            ServeConfig(adapt_every=0, queue_capacity=64), device="cuda")

    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        ctrl, rounds = controller(), 3
        journal = tmp_path / "folds.jsonl"
        with open(journal, "w") as f:
            _attach_journal(ctrl, f)
            srv = AggregatorServer(ctrl, transport="tcp")
            srv.start()
            folder = threading.Thread(target=srv.serve, kwargs={
                "stop": lambda: ctrl.version >= rounds, "poll": 0.01},
                daemon=True)
            folder.start()
            clients, _ = sc.make_dataset(4, samples_per_client=64, seed=0)

            def one_client(cid):
                svc = RemoteAggregator("127.0.0.1", srv.port, seed=cid)
                try:
                    run_client(svc, clients[cid], cid, fl, uploads=10,
                               stop_at_version=rounds, seed=cid)
                except ConnectionError:
                    pass  # pulled after the server shut down: the race
                finally:
                    svc.close()

            threads = [threading.Thread(target=one_client, args=(c,))
                       for c in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            folder.join(timeout=120)
            srv.shutdown()
        assert not folder.is_alive() and ctrl.version >= rounds
        assert not any(t.is_alive() for t in threads)
        replay = controller()
        replay_journal(str(journal), replay, sc.make_dataset(
            4, samples_per_client=64, seed=0)[0], fl)
        assert wire.params_sha256(*replay.pull()) == \
            wire.params_sha256(*ctrl.pull())
    finally:
        torch.backends.cudnn.deterministic = prev


# ---------------------------------------------------------------------------
# Slice D: the population engine on the card
# ---------------------------------------------------------------------------


def _pop_keys(n, device):
    from repro_torch.utils import threefry
    g = torch.Generator().manual_seed(n)
    cid = torch.randint(0, 2 ** 31 - 1, (n,), generator=g, dtype=torch.int32)
    k = torch.randint(0, 5000, (n,), generator=g, dtype=torch.int32)
    key = threefry.fold_in(threefry.fold_in(threefry.fold_in(
        threefry.prng_key(7, device), 101), cid.to(device)), k.to(device))
    return key


@pytest.mark.cuda
def test_threefry_draws_on_card_equal_cpu(cuda):
    """Integer draws and uniform bit for bit; normal, exp and log as well,
    since their float arithmetic is IEEE operations only."""
    from repro_torch.utils import threefry
    card, host = _pop_keys(200_000, cuda), _pop_keys(200_000, "cpu")
    assert torch.equal(card.k0.cpu(), host.k0)
    assert torch.equal(card.k1.cpu(), host.k1)
    assert torch.equal(threefry.random_bits32(card, (3,)).cpu(),
                       threefry.random_bits32(host, (3,)))
    for hi in (7, 1500, 70_000, 2 ** 31 - 1):
        assert torch.equal(threefry.randint(card, (4,), 0, hi).cpu(),
                           threefry.randint(host, (4,), 0, hi))
    assert torch.equal(threefry.uniform(card, (), -3.5, 2.25).cpu(),
                       threefry.uniform(host, (), -3.5, 2.25))
    assert torch.equal(threefry.normal(card).cpu(), threefry.normal(host))
    x = torch.linspace(-80.0, 80.0, 100_003)
    assert torch.equal(threefry.exp(x.to(cuda)).cpu(), threefry.exp(x))
    y = torch.logspace(-30, 30, 100_003)
    assert torch.equal(threefry.log(y.to(cuda)).cpu(), threefry.log(y))


@pytest.mark.cuda
@pytest.mark.parametrize("preset", ["paper-fig1", "dropout-bernoulli"])
def test_population_windows_on_card_match_host_twin(cuda, preset):
    from repro_torch.sim.population import (
        CounterBehavior,
        collect_windows,
        host_walk_windows,
    )
    n, k, t = 2_000, 64, 20
    fl = FLConfig(num_clients=n, buffer_size=k, max_staleness=8)
    sc = get_scenario(preset)
    card = collect_windows(sc, n, fl, t, seed=0, device=cuda)
    host = host_walk_windows(CounterBehavior(sc, n, seed=0, device=cuda), fl,
                             t)
    for f in ("clients", "tau", "slots", "t"):
        np.testing.assert_array_equal(card[f], host[f])
    assert card["num_events"] == host["num_events"]
    cpu = collect_windows(sc, n, fl, t, seed=0, device="cpu")
    for f in ("clients", "tau", "slots", "t"):
        np.testing.assert_array_equal(card[f], cpu[f])


def _pop_run(mode, device, rounds=6, **kw):
    from repro_torch.sim.population import run_population
    clients, _ = get_scenario("dropout-bernoulli").make_dataset(
        8, samples_per_client=64, seed=0)
    fl = FLConfig(num_clients=8, buffer_size=4, local_steps=2, batch_size=8,
                  max_staleness=4, server_pass_mode=mode)
    params = init_lenet(torch.Generator().manual_seed(0))
    return run_population(lenet_loss, params, clients, fl, rounds,
                          scenario=get_scenario("dropout-bernoulli"), seed=2,
                          device=device, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["fused", "batched"])
def test_population_run_on_card_matches_reference(cuda, mode):
    ops.reset_launches()
    res = _pop_run(mode, cuda)
    if mode == "fused":
        assert ops.server_update.launches == 6
    else:
        assert ops.sq_dists.launches == ops.weighted_sum.launches == 6
    ref_run = _pop_run("reference", cuda)
    cpu = _pop_run("reference", "cpu")
    for other in (ref_run, cpu):
        assert res.num_events == other.num_events
        for a, b in zip(res.round_log, other.round_log):
            assert (a["clients"], a["tau"]) == (b["clients"], b["tau"])
            np.testing.assert_allclose(a["weights"], b["weights"], rtol=1e-3,
                                       atol=1e-5)


@pytest.mark.cuda
def test_population_resume_on_card_bit_identical(cuda):
    # run_population sets its own cuDNN and TF32 flags and puts the
    # caller's back: the resume holds at the entry point's defaults
    cudnn = torch.backends.cudnn
    prev = cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32
    cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32 = False, True, True
    try:
        full = _pop_run("fused", cuda, rounds=8, capture_state=True)
        half = _pop_run("fused", cuda, rounds=4, capture_state=True)
        resumed = _pop_run("fused", cuda, rounds=8,
                           init_state=half.final_state, capture_state=True)
        assert (cudnn.deterministic, cudnn.benchmark,
                cudnn.allow_tf32) == (False, True, True)
    finally:
        cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32 = prev
    assert resumed.round_log == full.round_log
    for layer, p in full.final_params.items():
        for key, v in p.items():
            assert torch.equal(resumed.final_params[layer][key], v)
    for f in ("t_next", "k_next", "batch_k", "base_version"):
        np.testing.assert_array_equal(getattr(resumed.final_state, f),
                                      getattr(full.final_state, f))
