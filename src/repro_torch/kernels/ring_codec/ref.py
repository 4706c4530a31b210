"""Plain-PyTorch versions of the int8 dequantize-distance kernel.

The plain version DOES materialize the (K, N) decoded rows, which is the
memory cost the CUDA kernel exists to avoid, but it fixes the arithmetic
the kernel reproduces: the product and the sum of the decode are rounded
separately, as in the JAX package's ``kernels/ring_codec/ref.py``. The
``ops`` wrapper runs it for CPU tensors; the tests and ``chip_smoke.py``
hold the kernel against it on the card.
"""
from __future__ import annotations

import torch


def dequant_ref(codes: torch.Tensor, scales: torch.Tensor,
                zeros: torch.Tensor, qblock: int) -> torch.Tensor:
    """codes: (K, N) int8, scales/zeros: (K, N // qblock) f32 -> (K, N) f32.

    Per-block affine decode: ``row[b*qblock + j] = q * scale[b] + zero[b]``.
    """
    k, n = codes.shape
    q = codes.to(torch.float32).reshape(k, n // qblock, qblock)
    deq = q * scales[..., None] + zeros[..., None]
    return deq.reshape(k, n)


def int8_sq_dists_ref(x: torch.Tensor, codes: torch.Tensor,
                      scales: torch.Tensor, zeros: torch.Tensor,
                      qblock: int) -> torch.Tensor:
    """x: (N,) f32 vs K quantized rows -> (K,) ||x - dequant(row_k)||^2."""
    diff = dequant_ref(codes, scales, zeros, qblock) - x[None]
    return torch.sum(diff * diff, dim=1)
