"""Public wrapper: the K4 CUDA kernel for CUDA tensors, the plain version for CPU.

As in ``kernels/weighted_agg/ops.py``, the device decides: CPU tensors take
the plain version (``ref.py``), CUDA tensors launch the kernel or raise.
There is no fallback and no switch. ``int8_sq_dists.launches`` counts the
kernel's launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ring_codec import kernel as _k
from repro_torch.kernels.ring_codec import ref as _ref
from repro_torch.utils.device import on_cuda


def _check_inputs(x, codes, scales, zeros, qblock: int) -> None:
    if codes.dtype != torch.int8:
        raise TypeError(f"codes must be int8; got {codes.dtype}")
    for name, t in (("x", x), ("scales", scales), ("zeros", zeros)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32; got {t.dtype}")
    if codes.dim() != 2 or codes.shape[0] < 1 or codes.shape[1] < 1:
        raise ValueError(f"codes must be (K, N) with K, N >= 1; got "
                         f"{tuple(codes.shape)}")
    k, n = codes.shape
    if qblock < 1 or n % qblock:
        raise ValueError(f"qblock {qblock} does not divide N = {n}")
    if tuple(x.shape) != (n,):
        raise ValueError(f"x must be ({n},); got {tuple(x.shape)}")
    for name, t in (("scales", scales), ("zeros", zeros)):
        if tuple(t.shape) != (k, n // qblock):
            raise ValueError(f"{name} must be ({k}, {n // qblock}); got "
                             f"{tuple(t.shape)}")
    for name, t in (("x", x), ("codes", codes), ("scales", scales),
                    ("zeros", zeros)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def int8_sq_dists(x: torch.Tensor, codes: torch.Tensor, scales: torch.Tensor,
                  zeros: torch.Tensor, *, qblock: int) -> torch.Tensor:
    """eq. 3 squared distances against K int8-quantized ring rows.

    x: (N,) f32, codes: (K, N) int8, scales/zeros: (K, N // qblock) f32 ->
    (K,) ``||x - dequant(row_k)||^2``. Any N with ``N % qblock == 0``.
    """
    _check_inputs(x, codes, scales, zeros, qblock)
    if not on_cuda(x, codes, scales, zeros):
        return _ref.int8_sq_dists_ref(x, codes, scales, zeros, qblock)
    out = _k.int8_sq_dists(x, codes, scales, zeros, qblock)
    int8_sq_dists.launches += 1
    return out


int8_sq_dists.launches = 0


def reset_launches() -> None:
    """Set the wrapper's launch count to 0."""
    int8_sq_dists.launches = 0
