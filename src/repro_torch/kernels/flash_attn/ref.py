"""Plain-PyTorch version of the K5 attention kernel.

The masked, materialised softmax of the JAX package's
``kernels/flash_attn/ref.py::attention_ref``, in f32, taking the port's
(B, S, H, D) layout and grouped-query K/V (expanded here, never in the
kernel). It builds the (B, H, S, S) scores the kernel exists to avoid; the
``ops`` wrapper runs it for CPU tensors, and the tests and
``chip_smoke.py`` hold the kernel against it on the card.
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
                        causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B, S, H, D), k, v: (B, S, Hkv, D) -> (B, S, H, D) in q's dtype."""
    n_rep = q.shape[2] // k.shape[2]
    kk = repeat_kv(k, n_rep).float()
    vv = repeat_kv(v, n_rep).float()
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, kk)
    mask = band_mask(q.shape[1], k.shape[1], causal, window, q.device)
    s = torch.where(mask, s, torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vv).to(q.dtype)
