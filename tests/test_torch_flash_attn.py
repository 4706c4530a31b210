"""The port's K5 wrapper and plain version against the JAX package's.

On the CPU the port's ``ops.flash_attention`` runs its plain version
(``ref.py``), which takes grouped-query K/V as the port's attention makes
them; the JAX side runs its Pallas kernel in interpret mode and its jnp
reference, as the JAX package's own tests do, on K/V expanded to every
query head (``np.repeat`` over the head axis is the JAX package's
``_repeat_kv`` mapping).

Tolerances: f32 rtol/atol 2e-5 (the same f32 maths, summed in other
orders; the JAX package's own kernel-vs-reference tolerance). bf16: both
compute in f32 and round the output to bf16 once, so an element differs by
at most one bf16 ulp (2^-8 relative, 2^-7 just above a power of two):
rtol 8e-3, atol 1e-5.

The CUDA kernel is held against the plain version on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``; its bf16 instance
carries P as two bf16 terms, and a test here shows on the CPU why one is
not enough.

The backward's plain version (``flash_attention_bwd_ref``, formulas, not
autograd, on the forward's lse) is held at f32 against ``torch.autograd`` of the plain forward
(rtol 1e-5, atol 1e-5 times the largest gradient: the same maths in other
orders) and against ``jax.vjp`` of the JAX package's training attention
(``_full_attention``; ``_sliding_window_attention`` where S is a multiple
of its query chunk) at rtol 1e-4, atol 1e-4 times the largest gradient
(XLA's and PyTorch's f32 sums over up to S terms).
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.flash_attn.ops import flash_attention as j_flash
from repro.kernels.flash_attn.ref import attention_ref as j_ref
from repro.models import attention as j_attn
from repro_torch.kernels.flash_attn import ops as tops
from repro_torch.kernels.flash_attn import ref as tref

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=8e-3, atol=1e-5)}
NP_DTYPE = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16}
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _case(b, s, h, hkv, d, dtype, seed=0):
    rng = np.random.default_rng(seed + 97 * s + 13 * h + d)
    q = rng.normal(size=(b, s, h, d)).astype(np.float32)
    k = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    v = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    return [a.astype(NP_DTYPE[dtype]) for a in (q, k, v)]


def _torch(a, dtype):
    return torch.from_numpy(a.astype(np.float32)).to(TORCH_DTYPE[dtype])


def _jax_both(q, k, v, n_rep, causal, window, block):
    """JAX kernel (interpret mode) and jnp reference on expanded K/V."""
    ke, ve = np.repeat(k, n_rep, axis=2), np.repeat(v, n_rep, axis=2)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(ke), jnp.asarray(ve)
    kern = j_flash(jq, jk, jv, causal=causal, window=window, use_kernel=True,
                   interpret=True, block_q=block, block_k=block)
    b, s, h, d = q.shape

    def bh(x):
        return x.transpose(0, 2, 1, 3).reshape(b * h, s, d)

    ref = j_ref(bh(jq), bh(jk), bh(jv), causal=causal, window=window)
    ref = np.asarray(ref).reshape(b, h, s, d).transpose(0, 2, 1, 3)
    return np.asarray(kern, np.float32), np.asarray(ref, np.float32)


# (b, s, h, hkv, d, causal, window, block)
CASES = [
    (2, 64, 4, 4, 32, True, 0, 32),      # causal, n_rep 1
    (1, 128, 5, 1, 64, True, 0, 64),     # causal, n_rep 5
    (2, 96, 10, 2, 32, True, 32, 32),    # window, n_rep 5
    (1, 128, 4, 4, 64, True, 48, 64),    # window not a block multiple
    (1, 256, 2, 2, 32, True, 64, 128),   # window, S = 256
    (1, 100, 5, 1, 64, True, 24, 64),    # ragged S (JAX pads), window
    (2, 64, 4, 2, 32, False, 0, 32),     # bidirectional
    # the head dims of stablelm-12b (5120 / 32 = 160) and gemma-7b (256)
    (1, 128, 4, 4, 160, True, 0, 64),    # causal, n_rep 1
    (2, 96, 8, 2, 160, True, 40, 32),    # window, n_rep 4
    (1, 128, 4, 1, 256, True, 0, 64),    # causal, n_rep 4
    (1, 100, 4, 2, 256, True, 24, 64),   # ragged S, window
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,hkv,d,causal,window,block", CASES)
def test_plain_matches_jax(b, s, h, hkv, d, causal, window, block, dtype):
    q, k, v = _case(b, s, h, hkv, d, dtype)
    want_kernel, want_ref = _jax_both(q, k, v, h // hkv, causal, window,
                                      block)
    tq, tk, tv = (_torch(a, dtype) for a in (q, k, v))
    got_ref = tref.flash_attention_ref(tq, tk, tv, causal=causal,
                                       window=window)
    got_ops = tops.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert got_ops.dtype == TORCH_DTYPE[dtype]
    assert got_ops.shape == (b, s, h, d)
    assert torch.equal(got_ops, got_ref)
    for want in (want_kernel, want_ref):
        np.testing.assert_allclose(got_ops.float().numpy(), want,
                                   **TOL[dtype])


def test_p_as_two_bf16_terms_keeps_the_bf16_tolerance():
    """The card's bf16 kernel runs P.V on the tensor cores, which take P in
    bf16. Rounded once (2^-9 relative), P moves outputs near zero past the
    bf16 tolerance against the plain version. The kernel carries it as
    P_hi + P_lo: P_hi is p truncated to bf16, P_lo the exact remainder
    rounded to bf16, and the two products are summed in f32; that stays
    inside. The kernel's arithmetic, emulated here in f32 on the CPU."""
    s, window = 512, 128
    q, k, v = (_torch(a, "bfloat16") for a in _case(1, s, 2, 2, 64,
                                                    "bfloat16"))
    want = tref.flash_attention_ref(q, k, v, window=window).float()
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float() * 64 ** -0.5,
                          k.float())
    mask = tref.band_mask(s, s, True, window, q.device)
    p = torch.exp(scores.masked_fill(~mask, float("-inf"))
                  - scores.masked_fill(~mask, tref.NEG_INF).amax(-1, True))
    vv = v.float().transpose(1, 2)
    p_hi = (p.view(torch.int32) & -65536).view(torch.float32)  # truncated
    p_lo = (p - p_hi).to(torch.bfloat16).float()

    def out(pv):
        return (pv / p.sum(-1, True)).transpose(1, 2).to(torch.bfloat16) \
            .float()

    one = out(p.to(torch.bfloat16).float() @ vv)
    two = out(p_hi @ vv + p_lo @ vv)
    assert not torch.allclose(one, want, **TOL["bfloat16"])
    torch.testing.assert_close(two, want, **TOL["bfloat16"])


def test_window_wider_than_sequence_is_plain_causal():
    q, k, v = (_torch(a, "float32") for a in _case(1, 40, 4, 2, 32,
                                                   "float32"))
    torch.testing.assert_close(
        tops.flash_attention(q, k, v, window=1024),
        tops.flash_attention(q, k, v, window=0), rtol=0, atol=0)


def test_cpu_wrapper_launches_no_kernel():
    q, k, v = (_torch(a, "float32") for a in _case(1, 16, 2, 1, 32,
                                                   "float32"))
    tops.reset_launches()
    tops.flash_attention(q, k, v)
    assert tops.flash_attention.launches == 0


@pytest.mark.parametrize("bad", ["head_dim", "gqa", "dtype", "layout",
                                 "window", "seq"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    q = torch.zeros(1, 8, 4, 32)
    k = v = torch.zeros(1, 8, 2, 32)
    if bad == "head_dim":
        q, k, v = q[..., :16], k[..., :16], v[..., :16]
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    elif bad == "gqa":
        k = v = torch.zeros(1, 8, 3, 32)
    elif bad == "dtype":
        q = q.half()
    elif bad == "layout":
        q = torch.zeros(1, 4, 8, 32).transpose(1, 2)
    elif bad == "seq":
        k = v = torch.zeros(1, 9, 2, 32)
    with pytest.raises((ValueError, TypeError)):
        tops.flash_attention(q, k, v, window=-1 if bad == "window" else 0)


# ------------------------------------------------------------------ backward

# (b, s, h, hkv, d, causal, window, q_chunk): q_chunk > 0 runs the JAX
# package's _sliding_window_attention (S a multiple of it), else
# _full_attention
BWD_CASES = [
    (2, 40, 4, 4, 32, True, 0, 0),      # causal, n_rep 1
    (1, 48, 5, 1, 64, True, 0, 0),      # causal, n_rep 5
    (2, 48, 10, 2, 32, True, 16, 16),   # window, n_rep 5, banded JAX path
    (1, 37, 5, 1, 64, True, 9, 0),      # ragged S, window, n_rep 5
    (2, 33, 4, 2, 128, False, 0, 0),    # bidirectional, D 128
]


def _bwd_case(b, s, h, hkv, d, seed=3):
    rng = np.random.default_rng(seed + 7 * s + h + d)
    return [rng.normal(size=shape).astype(np.float32) for shape in
            ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, d), (b, s, h, d))]


def _close_rel(got, want, tol):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=tol,
                               atol=tol * float(np.abs(want).max()))


@pytest.mark.parametrize("b,s,h,hkv,d,causal,window,q_chunk", BWD_CASES)
def test_backward_plain_matches_autograd(b, s, h, hkv, d, causal, window,
                                         q_chunk):
    q, k, v, do = (torch.from_numpy(a) for a in _bwd_case(b, s, h, hkv, d))
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    o, lse = tref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                      with_lse=True)
    want = torch.autograd.grad(o, (q, k, v), do)
    got = tref.flash_attention_bwd_ref(q.detach(), k.detach(), v.detach(),
                                       o.detach(), do, lse.detach(),
                                       causal=causal, window=window)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        _close_rel(g.numpy(), w.numpy(), 1e-5)


@pytest.mark.parametrize("b,s,h,hkv,d,causal,window,q_chunk", BWD_CASES)
def test_backward_plain_matches_jax_grad(b, s, h, hkv, d, causal, window,
                                         q_chunk):
    q, k, v, do = _bwd_case(b, s, h, hkv, d)
    n_rep = h // hkv

    def j_attention(q, k, v):
        k, v = j_attn._repeat_kv(k, n_rep), j_attn._repeat_kv(v, n_rep)
        if q_chunk:
            return j_attn._sliding_window_attention(q, k, v, window, q_chunk)
        return j_attn._full_attention(q, k, v, causal=causal, window=window)

    o, pullback = jax.vjp(j_attention, *map(jnp.asarray, (q, k, v)))
    want = pullback(jnp.asarray(do))
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    _, lse = tops.flash_attention_lse(tq, tk, tv, causal=causal,
                                      window=window)
    got = tops.flash_attention_bwd(tq, tk, tv,
                                   torch.from_numpy(np.array(o)), tdo, lse,
                                   causal=causal, window=window)
    for g, w in zip(got, want):
        _close_rel(g.numpy(), w, 1e-4)


def test_backward_kernel_head_dims_are_named():
    """The backward kernel takes every D of HEAD_DIMS, as the forward does;
    its plain version any D. A card is needed to reach the kernel, so the
    CPU path shows the plain version takes D = 160 and 256 and the source
    dispatches each D of the set."""
    for d in (160, 256):
        q, k, v, do = (torch.from_numpy(a) for a in _bwd_case(1, 16, 2, 1, d))
        o, lse = tops.flash_attention_lse(q, k, v)
        dq, dk, dv = tops.flash_attention_bwd(q, k, v, o, do, lse)
        assert dq.shape == q.shape and dk.shape == k.shape
    assert tops.HEAD_DIMS == (32, 64, 128, 160, 256)
    assert not hasattr(tops, "BWD_HEAD_DIMS")
    # the backward dispatches through the head-dim switch it shares with
    # the forward (csrc/hopper.cuh)
    src = (tops._k.BWD_LIBRARY.source).read_text()
    assert src.count("hopper::by_dim(head_dim,") == 3
    shared = (tops._k.BWD_LIBRARY.source.parent / "hopper.cuh").read_text()
    for d in tops.HEAD_DIMS:
        assert f"case {d}:" in shared


# ------------------------------------------- the forward's lse, the bf16 design


def _j_attention(n_rep, causal, window, q_chunk):
    def attend(q, k, v):
        k, v = j_attn._repeat_kv(k, n_rep), j_attn._repeat_kv(v, n_rep)
        if q_chunk:
            return j_attn._sliding_window_attention(q, k, v, window, q_chunk)
        return j_attn._full_attention(q, k, v, causal=causal, window=window)
    return attend


def _j_lse(q, k, n_rep, causal, window):
    """jax.nn.logsumexp of the JAX package's masked, scaled scores (the
    masking of ``_full_attention``)."""
    k = j_attn._repeat_kv(jnp.asarray(k), n_rep)
    scores = jnp.einsum("bqhd,bkhd->bhqk",
                        jnp.asarray(q) * q.shape[-1] ** -0.5, k)
    if causal:
        pos = jnp.arange(q.shape[1])
        mask = pos[:, None] >= pos[None, :]
        if window:
            mask &= pos[None, :] > pos[:, None] - window
        scores = jnp.where(mask[None, None], scores, j_attn.NEG_INF)
    return np.asarray(jax.nn.logsumexp(scores, axis=-1))


@pytest.mark.parametrize("b,s,h,hkv,d,causal,window,q_chunk", BWD_CASES)
def test_plain_lse_matches_jax_logsumexp(b, s, h, hkv, d, causal, window,
                                         q_chunk):
    """The lse the forward writes for the backward: the plain version and
    the two-output Function on CPU tensors, against jax.nn.logsumexp (f32,
    rtol 1e-5: sums over S terms in other orders)."""
    q, k, v, _ = _bwd_case(b, s, h, hkv, d)
    want = _j_lse(q, k, h // hkv, causal, window)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    out, lse = tref.flash_attention_ref(tq, tk, tv, causal=causal,
                                        window=window, with_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (b, h, s)
    np.testing.assert_allclose(lse.numpy(), want, rtol=1e-5, atol=1e-5)
    got_out, got_lse = tops.flash_attention_lse(tq, tk, tv, causal=causal,
                                                window=window)
    assert torch.equal(got_out, out) and torch.equal(got_lse, lse)


def _bf(x):
    return x.to(torch.bfloat16).float()


def _bf16_backward_emulated(q, k, v, do, causal, window):
    """The bf16 kernels' arithmetic, in f32 on the CPU, from bf16 inputs:
    o (bf16) and lse as the forward writes them; every product of bf16
    operands summed in f32, as the tensor cores do; the dQ kernel's dS =
    P (dP - D) rounded to bf16 once; the dK/dV kernel's P^T rounded to bf16
    once, its dS^T = bf16(P^T) (dP^T - D) rounded once; the gradients
    rounded to bf16."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    n_rep = h // hkv
    o, lse = tref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                      with_lse=True)
    qf, dof = q.float(), do.float()
    kk, vv = (tref.repeat_kv(t, n_rep).float() for t in (k, v))
    mask = tref.band_mask(s, s, causal, window, q.device)
    scores = torch.einsum("bqhd,bkhd->bhqk", qf, kk) * d ** -0.5
    p = torch.exp(scores - lse[..., None]).masked_fill(~mask, 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vv)
    delta = (dof * o.float()).sum(-1).permute(0, 2, 1)[..., None]
    ds_q = _bf(p * (dp - delta))
    p_t = _bf(p)
    ds_k = _bf(p_t * (dp - delta))
    dq = torch.einsum("bhqk,bkhd->bqhd", ds_q, kk) * d ** -0.5
    dk = torch.einsum("bhqk,bqhd->bkhd", ds_k, qf) * d ** -0.5
    dv = torch.einsum("bhqk,bqhd->bkhd", p_t, dof)

    def fold(t):
        return t.reshape(b, s, hkv, n_rep, d).sum(3)

    return tuple(t.to(torch.bfloat16) for t in (dq, fold(dk), fold(dv)))


# (b, s, h, hkv, d, causal, window, q_chunk): D 64, 128, 160, 256; n_rep 1
# and 5; window 0 and 16; ragged S
BF16_BWD_CASES = [
    (1, 48, 5, 1, 64, True, 0, 0),
    (2, 48, 10, 2, 64, True, 16, 16),
    (1, 37, 4, 4, 128, True, 16, 0),
    (2, 33, 5, 1, 128, True, 0, 0),
    (1, 40, 5, 1, 160, True, 16, 0),
    (1, 35, 4, 4, 160, True, 0, 0),
    (1, 37, 5, 1, 256, True, 0, 0),
    (1, 48, 4, 4, 256, True, 16, 16),
]


@pytest.mark.parametrize("b,s,h,hkv,d,causal,window,q_chunk",
                         BF16_BWD_CASES)
def test_bf16_backward_design_keeps_the_bf16_tolerance(
        b, s, h, hkv, d, causal, window, q_chunk):
    """The card's bf16 backward feeds P^T and dS^T (and dQ's dS) to the
    tensor cores rounded to bf16 once. Unlike the forward's P (which needs
    two bf16 terms, above), one rounding keeps the gradients inside the bf16
    tolerance the card holds them to (rtol 8e-3, atol 4e-3 times the
    largest gradient): emulated here from bf16 inputs, against jax.vjp of
    the JAX package's attention on the same values in f32."""
    q, k, v, do = (a.astype(ml_dtypes.bfloat16).astype(np.float32)
                   for a in _bwd_case(b, s, h, hkv, d, seed=11))
    _, pullback = jax.vjp(_j_attention(h // hkv, causal, window, q_chunk),
                          *map(jnp.asarray, (q, k, v)))
    want = [np.asarray(w) for w in pullback(jnp.asarray(do))]
    got = _bf16_backward_emulated(*(torch.from_numpy(a).to(torch.bfloat16)
                                    for a in (q, k, v, do)), causal, window)
    scale = max(float(np.abs(w).max()) for w in want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.float().numpy(), w, rtol=8e-3,
                                   atol=4e-3 * scale)


def _function_grads(fn, q, k, v, do):
    """Gradients of sum(fn(q, k, v) * do) with respect to q, k, v."""
    q, k, v = (t.clone().requires_grad_() for t in (q, k, v))
    return torch.autograd.grad((fn(q, k, v) * do).sum(), (q, k, v))


@pytest.mark.parametrize("how", ["alone", "vmap", "remat"])
def test_two_output_function_grads_match_jax_vjp(how):
    """The Function's backward takes the lse it saved (the kernel path);
    its gradients against jax.vjp of the JAX package's attention: called
    alone, under vmap (the cohort's slots, lse folded like the output) and
    inside utils/remat.py's remat (its backward re-runs the Function under
    torch.func.vjp). f32, rtol 1e-4, atol 1e-4 of the largest gradient."""
    from torch.func import grad, vmap

    from repro_torch.utils.remat import remat

    b, s, h, hkv, d, causal, window = 2, 37, 5, 1, 64, True, 9
    attend = _j_attention(h // hkv, causal, window, 0)
    slots = 3 if how == "vmap" else 1
    cases = [_bwd_case(b, s, h, hkv, d, seed=20 + i) for i in range(slots)]
    want = []
    for q, k, v, do in cases:
        _, pullback = jax.vjp(attend, *map(jnp.asarray, (q, k, v)))
        want.append([np.asarray(w) for w in pullback(jnp.asarray(do))])

    def fn(q, k, v):
        out, lse = tops.flash_attention_lse(q, k, v, causal=causal,
                                            window=window)
        assert lse.shape == (q.shape[0], h, s) and not lse.requires_grad
        return out

    tq, tk, tv, tdo = (torch.from_numpy(np.stack(a)) for a in zip(*cases))
    if how == "vmap":
        def loss(q, k, v, do):
            return (fn(q, k, v) * do).sum()

        got = vmap(grad(loss, argnums=(0, 1, 2)))(tq, tk, tv, tdo)
    elif how == "remat":
        got = [g[None] for g in _function_grads(remat(fn), tq[0], tk[0],
                                                tv[0], tdo[0])]
    else:
        got = [g[None] for g in _function_grads(fn, tq[0], tk[0], tv[0],
                                                tdo[0])]
    for i in range(slots):
        for g, w in zip(got, want[i]):
            _close_rel(g[i].detach().numpy(), w, 1e-4)


@pytest.mark.parametrize("bad", ["shape", "dtype"])
def test_backward_rejects_an_lse_it_cannot_read(bad):
    """The backward reads the forward's f32 (B, H, S) lse; another shape or
    dtype is refused before anything runs."""
    q, k, v, do = (torch.from_numpy(a) for a in _bwd_case(1, 16, 4, 2, 32))
    o, lse = tops.flash_attention_lse(q, k, v)
    lse = lse[:, :2] if bad == "shape" else lse.double()
    with pytest.raises(ValueError, match="lse"):
        tops.flash_attention_bwd(q, k, v, o, do, lse)
