"""Plain-PyTorch versions of the K6 selective-scan kernel and of its backward.

The sequential scan of the JAX package's
``kernels/ssm_scan/ref.py::selective_scan_ref``: one step per time step,
the (B, di, N) state carried in a tensor. ``a`` is one (di, N) matrix
shared by every batch row, or (G, di, N) with G dividing B (row r reads
``a[r // (B // G)]``). The ``ops`` wrapper runs it for CPU tensors; the
tests and ``chip_smoke.py`` hold the kernel against it on the card.

``selective_scan_bwd_ref`` is the backward written out as formulas (not
autograd of the forward): the states recomputed forward, then the reverse
recurrence ``g_t = C_t dy_t + exp(dt_{t+1} A) g_{t+1}`` and each input's
gradient from it. The ``ops`` backward runs it for CPU tensors; the tests
pin it to ``torch.autograd`` of the plain forward and to ``jax.grad`` of the
JAX package's scan.
"""
from __future__ import annotations

import torch


def _per_row(a: torch.Tensor, bsz: int) -> torch.Tensor:
    """(di, N) -> (1, di, N) (broadcast); (G, di, N) -> (B, di, N)."""
    if a.dim() == 2:
        return a[None]
    return a.repeat_interleave(bsz // a.shape[0], dim=0)


def selective_scan_ref(x: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
                       c: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """x, dt: (B, S, di); b, c: (B, S, N); a: (di, N) or (G, di, N) -> y
    (B, S, di) f32, ``y_t = C_t . h_t`` with ``h_t = exp(dt_t A) h_{t-1} +
    (dt_t x_t) B_t``."""
    bsz, s, di = x.shape
    ar = _per_row(a, bsz)
    h = torch.zeros((bsz, di, a.shape[-1]), dtype=torch.float32,
                    device=x.device)
    ys = []
    for t in range(s):
        dtt = dt[:, t]
        da = torch.exp(dtt[..., None] * ar)  # (B, di, N)
        h = da * h + (dtt * x[:, t])[..., None] * b[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, c[:, t]))
    return torch.stack(ys, dim=1)


def selective_scan_bwd_ref(x: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
                           c: torch.Tensor, a: torch.Tensor, dy: torch.Tensor):
    """The gradients of ``sum(selective_scan_ref(x, dt, b, c, a) * dy)``:
    (dx, ddt, db, dc, da), da shaped like ``a`` (summed over the rows that
    share each matrix)."""
    bsz, s, di = x.shape
    ar = _per_row(a, bsz)
    hs = []
    h = torch.zeros((bsz, di, a.shape[-1]), dtype=torch.float32,
                    device=x.device)
    for t in range(s):
        h = torch.exp(dt[:, t, :, None] * ar) * h \
            + (dt[:, t] * x[:, t])[..., None] * b[:, t, None, :]
        hs.append(h)
    g = torch.zeros_like(h)
    a_next = torch.zeros_like(h)
    d_rows = torch.zeros_like(h)  # dA per batch row
    dx, ddt = torch.empty_like(x), torch.empty_like(x)
    db, dc = torch.empty_like(b), torch.empty_like(c)
    for t in range(s - 1, -1, -1):
        g = c[:, t, None, :] * dy[:, t, :, None] + a_next * g
        da_t = torch.exp(dt[:, t, :, None] * ar)
        gh = g * (hs[t - 1] if t else torch.zeros_like(g)) * da_t
        gb = g * b[:, t, None, :]
        dx[:, t] = dt[:, t] * gb.sum(-1)
        ddt[:, t] = (gb * x[:, t, :, None]).sum(-1) + (gh * ar).sum(-1)
        db[:, t] = (g * (dt[:, t] * x[:, t])[..., None]).sum(1)
        dc[:, t] = (hs[t] * dy[:, t, :, None]).sum(1)
        d_rows = d_rows + gh * dt[:, t, :, None]
        a_next = da_t
    if a.dim() == 2:
        da = d_rows.sum(0)
    else:
        da = d_rows.reshape(a.shape[0], bsz // a.shape[0], di, -1).sum(1)
    return dx, ddt, db, dc, da
