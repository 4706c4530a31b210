"""Public wrapper: the K5 CUDA kernel for CUDA tensors, the plain version for CPU.

As in the other kernel packages, the device decides: CPU tensors take the
plain version (``ref.py``), CUDA tensors launch the kernel or raise. There
is no fallback and no switch. ``flash_attention.launches`` counts the
kernel's launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attn import kernel as _k
from repro_torch.kernels.flash_attn import ref as _ref
from repro_torch.utils.device import on_cuda

HEAD_DIMS = (32, 64, 128, 160, 256)


def _check_inputs(q, k, v, window: int) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, S, H, D) and (B, S, Hkv, D)")
    b, s, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[1] != s \
            or k.shape[3] != d:
        raise ValueError(f"k, v must be ({b}, {s}, Hkv, {d}); got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if b < 1 or s < 1 or k.shape[2] < 1 or h % k.shape[2]:
        raise ValueError(f"need B, S >= 1 and H % Hkv == 0; got q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if q.dtype not in _k.DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one of {list(_k.DTYPES)}; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if window < 0:
        raise ValueError(f"window must be >= 0; got {window}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Attention over a full sequence with an online softmax.

    q: (B, S, H, D), k, v: (B, S, Hkv, D) with H % Hkv == 0 (query head h
    reads kv head h // (H // Hkv)); key j visible to query i where
    ``(not causal or i >= j) and (window == 0 or j > i - window)``. Returns
    (B, S, H, D) in q's dtype. Any S; D in ``HEAD_DIMS``; f32 or bf16.
    """
    _check_inputs(q, k, v, window)
    if not on_cuda(q, k, v):
        return _ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    out = _k.flash_attention(q, k, v, causal, window)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def reset_launches() -> None:
    """Set the wrapper's launch count to 0."""
    flash_attention.launches = 0
