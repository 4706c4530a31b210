"""Plain PyTorch versions of the RMSNorm kernels: the models' eager chain.

``rms_norm_ref`` is the op chain the models ran before the kernel, in its
order, so on the CPU the numbers (and the JAX-parity tests) stay bit for
bit; ``rms_norm_bwd_ref`` is ``torch.func.vjp`` of that chain. ``w`` is one
(d,) weight shared by every row, or (G, d): row r of the (rows, d) view of
``x`` reads ``w[r // (rows // G)]`` (the vmapped calls folded into the
rows, each with its own weight).
"""
from __future__ import annotations

import torch


def _gain(out: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``out * (1 + w)``, a row group of ``out`` per row of a 2-D ``w``."""
    g = 1.0 + w.float()
    if w.dim() == 1:
        return out * g
    d = out.shape[-1]
    return (out.reshape(w.shape[0], -1, d) * g[:, None, :]).reshape(out.shape)


def rms_norm_ref(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6):
    """(y in x's dtype, rstd f32 of shape ``x.shape[:-1]``)."""
    return _chain(x, w, eps)


def _chain(x: torch.Tensor, w: torch.Tensor, eps: float):
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    out = xf * rstd
    return _gain(out, w).to(x.dtype), rstd[..., 0]


def rms_norm_bwd_ref(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor,
                     eps: float = 1e-6, dw_groups: int = 0):
    """(dx in x's dtype, dw f32) for the cotangent ``dy``. dw is shaped like
    ``w``, or (dw_groups, d) with each row group's own sum where
    ``dw_groups`` (a multiple of w's groups) is given."""
    groups = w.shape[0] if w.dim() == 2 else 1
    if dw_groups and dw_groups != groups:
        # one weight row per dw group, equal within each of w's groups
        w = w.reshape(groups, 1, -1).expand(
            groups, dw_groups // groups, w.shape[-1]).reshape(dw_groups, -1)
    _, pullback = torch.func.vjp(lambda a, b: _chain(a, b, eps)[0], x, w)
    return pullback(dy)
