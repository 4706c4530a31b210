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
autograd) is held at f32 against ``torch.autograd`` of the plain forward
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
    o = tref.flash_attention_ref(q, k, v, causal=causal, window=window)
    want = torch.autograd.grad(o, (q, k, v), do)
    got = tref.flash_attention_bwd_ref(q.detach(), k.detach(), v.detach(),
                                       o.detach(), do, causal=causal,
                                       window=window)
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
    got = tops.flash_attention_bwd(tq, tk, tv,
                                   torch.from_numpy(np.array(o)), tdo,
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
        o = tops.flash_attention(q, k, v)
        dq, dk, dv = tops.flash_attention_bwd(q, k, v, o, do)
        assert dq.shape == q.shape and dk.shape == k.shape
    assert tops.HEAD_DIMS == (32, 64, 128, 160, 256)
    assert not hasattr(tops, "BWD_HEAD_DIMS")
    src = (tops._k.BWD_LIBRARY.source).read_text()
    for d in tops.HEAD_DIMS:
        assert f"case {d}:" in src
