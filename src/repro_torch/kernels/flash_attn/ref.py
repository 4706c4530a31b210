"""Plain-PyTorch versions of the K5 attention kernel and of its backward.

The masked, materialised softmax of the JAX package's
``kernels/flash_attn/ref.py::attention_ref``, in f32, taking the port's
(B, S, H, D) layout and grouped-query K/V (expanded here, never in the
kernel). It builds the (B, H, S, S) scores the kernel exists to avoid; the
``ops`` wrapper runs it for CPU tensors, and the tests and
``chip_smoke.py`` hold the kernel against it on the card.

``flash_attention_ref(..., with_lse=True)`` also returns each row's
log-sum-exp of its masked, scaled scores, f32 (B, H, S), as the kernel's
forward writes it for the backward.

``flash_attention_bwd_ref`` is the backward written out as formulas (not
autograd of the forward): the softmax recomputed from q, k and the
forward's lse (``p = exp(s - lse)``, as the kernel reads it), ``D_i =
rowsum(do * o)`` from the output it is given, ``ds = p * (dp - D)``, and
the grouped heads' dk and dv summed over each group. The ``ops``
backward runs it for CPU tensors; the tests pin it to ``torch.autograd`` of
the plain forward and to ``jax.grad`` of the JAX package's attention.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, Hkv, D) -> (B, S, Hkv * n_rep, D); expanded head kvh * n_rep + r
    is kv head kvh (the JAX package's ``_repeat_kv``)."""
    if n_rep == 1:
        return x
    b, s, h, d = x.shape
    return x[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(
        b, s, h * n_rep, d)


def band_mask(sq: int, sk: int, causal: bool, window: int,
              device: torch.device) -> torch.Tensor:
    """(Sq, Sk) bool: key j visible to query i."""
    qpos = torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= qpos >= kpos
    if window > 0:
        mask &= kpos > qpos - window
    return mask


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: int = 0,
                        with_lse: bool = False):
    """q: (B, S, H, D), k, v: (B, S, Hkv, D) -> (B, S, H, D) in q's dtype;
    with ``with_lse``, also the rows' lse, f32 (B, H, S)."""
    n_rep = q.shape[2] // k.shape[2]
    kk = repeat_kv(k, n_rep).float()
    vv = repeat_kv(v, n_rep).float()
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, kk)
    mask = band_mask(q.shape[1], k.shape[1], causal, window, q.device)
    s = torch.where(mask, s, torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, vv).to(q.dtype)
    return (out, torch.logsumexp(s, dim=-1)) if with_lse else out


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            o: torch.Tensor, do: torch.Tensor,
                            lse: torch.Tensor, causal: bool = True,
                            window: int = 0):
    """q, o, do: (B, S, H, D), k, v: (B, S, Hkv, D), lse (B, H, S) -> (dq,
    dk, dv) in the dtypes of q, k, v; every sum in f32."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    n_rep = h // hkv
    kk = repeat_kv(k, n_rep).float()
    vv = repeat_kv(v, n_rep).float()
    qf, dof = q.float(), do.float()
    scale = d ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", qf, kk) * scale
    mask = band_mask(s, k.shape[1], causal, window, q.device)
    scores = torch.where(mask, scores, torch.full((), NEG_INF, device=q.device))
    p = torch.exp(scores - lse.float()[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vv)
    delta = (dof * o.float()).sum(-1).permute(0, 2, 1)  # (B, H, S)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kk) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)

    def fold(t):  # expanded head kvh * n_rep + r -> kv head kvh
        return t.reshape(b, t.shape[1], hkv, n_rep, d).sum(3)

    return dq.to(q.dtype), fold(dk).to(k.dtype), fold(dv).to(v.dtype)
