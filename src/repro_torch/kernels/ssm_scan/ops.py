"""Public wrapper: the K6 CUDA kernel for CUDA tensors, the plain version for CPU.

As in the other kernel packages, the device decides: CPU tensors take the
plain version (``ref.py``), CUDA tensors launch the kernel or raise. There
is no fallback and no switch. ``selective_scan.launches`` counts the
kernel's launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ssm_scan import kernel as _k
from repro_torch.kernels.ssm_scan import ref as _ref
from repro_torch.utils.device import on_cuda

STATE_SIZES = (4, 8, 16, 32)


def _check_inputs(x, dt, b, c, a) -> None:
    for name, t in (("x", x), ("dt", dt), ("b", b), ("c", c), ("a", a)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32; got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.dim() != 3 or x.shape[0] < 1 or x.shape[1] < 1 or x.shape[2] < 1:
        raise ValueError(f"x must be (B, S, di) with B, S, di >= 1; got "
                         f"{tuple(x.shape)}")
    bsz, s, di = x.shape
    if a.dim() != 2 or a.shape[0] != di or a.shape[1] not in STATE_SIZES:
        raise ValueError(f"a must be ({di}, N) with N in {STATE_SIZES}; got "
                         f"{tuple(a.shape)}")
    n = a.shape[1]
    if dt.shape != x.shape:
        raise ValueError(f"dt must be {tuple(x.shape)}; got {tuple(dt.shape)}")
    for name, t in (("b", b), ("c", c)):
        if tuple(t.shape) != (bsz, s, n):
            raise ValueError(f"{name} must be ({bsz}, {s}, {n}); got "
                             f"{tuple(t.shape)}")


def selective_scan(x: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
                   c: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Mamba-1 selective scan from a zero state.

    x, dt: (B, S, di); b, c: (B, S, N); a: (di, N); all f32 and contiguous
    -> y (B, S, di) f32 with ``y_t = C_t . h_t``, ``h_t = exp(dt_t A) h_{t-1}
    + (dt_t x_t) B_t``. Any S and di; N in ``STATE_SIZES``.
    """
    _check_inputs(x, dt, b, c, a)
    if not on_cuda(x, dt, b, c, a):
        return _ref.selective_scan_ref(x, dt, b, c, a)
    y = _k.selective_scan(x, dt, b, c, a)
    selective_scan.launches += 1
    return y


selective_scan.launches = 0


def reset_launches() -> None:
    """Set the wrapper's launch count to 0."""
    selective_scan.launches = 0
