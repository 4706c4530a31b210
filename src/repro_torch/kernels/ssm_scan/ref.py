"""Plain-PyTorch version of the K6 selective-scan kernel.

The sequential scan of the JAX package's
``kernels/ssm_scan/ref.py::selective_scan_ref``: one step per time step,
the (B, di, N) state carried in a tensor. The ``ops`` wrapper runs it for
CPU tensors; the tests and ``chip_smoke.py`` hold the kernel against it on
the card.
"""
from __future__ import annotations

import torch


def selective_scan_ref(x: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
                       c: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """x, dt: (B, S, di); b, c: (B, S, N); a: (di, N) -> y (B, S, di) f32,
    ``y_t = C_t . h_t`` with ``h_t = exp(dt_t A) h_{t-1} + (dt_t x_t) B_t``."""
    bsz, s, di = x.shape
    h = torch.zeros((bsz, di, a.shape[1]), dtype=torch.float32,
                    device=x.device)
    ys = []
    for t in range(s):
        dtt = dt[:, t]
        da = torch.exp(dtt[..., None] * a[None])  # (B, di, N)
        h = da * h + (dtt * x[:, t])[..., None] * b[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, c[:, t]))
    return torch.stack(ys, dim=1)
