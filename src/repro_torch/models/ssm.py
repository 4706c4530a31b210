"""Mamba-1 selective SSM block (port of the JAX package's ``models/ssm.py``).

The full-sequence path runs the scan through kernel K6
(``kernels/ssm_scan/ops.py::selective_scan``: the CUDA kernel for CUDA
tensors, its plain sequential version for CPU tensors); the JAX package
runs its own chunked associative scan there, which computes the same
recurrence. The decode path is the O(1) recurrent update.

``softplus``: ``jax.nn.softplus`` has no linear cut-over, while
``torch.nn.functional.softplus`` goes linear above its threshold (20 by
default). The port writes it as ``log1p(exp(-|x|)) + relu(x)``, the same
formula as ``jnp.logaddexp(x, 0)``, with no threshold.

Jamba's Mamba layers (the layered stack's) put an RMSNorm on each of dt,
B and C after ``x_proj``, before ``dt_proj`` and the scan: their weights
are ``init_inner_norms``'s, and ``normed_ssm_inputs``, which the layered
stack hands to ``ssm_train`` and ``ssm_decode`` in place of
``_ssm_inputs``, applies them.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssm_scan import ops as scan_ops
from repro_torch.models.layers import Init, dense_init, dtype_of, rms_norm

Params = Dict[str, torch.Tensor]

SSM_CHUNK = 256  # the JAX package's scan chunk: S % min(256, S) == 0


def softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.log1p(torch.exp(-torch.abs(x))) + torch.relu(x)


def init_ssm(init: Init, cfg) -> Params:
    dtype = dtype_of(cfg.param_dtype)
    d, di, n = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_state
    dtr = cfg.resolved_dt_rank
    # S4D-real initialisation for A
    a_init = torch.arange(1, n + 1, dtype=torch.float32)[None, :].repeat(di, 1)
    return {
        "in_proj": dense_init(init, d, 2 * di, dtype),
        "conv_w": init.normal((cfg.ssm_conv, di), cfg.ssm_conv ** -0.5, dtype),
        "conv_b": init.full((di,), 0.0, dtype),
        "x_proj": dense_init(init, di, dtr + 2 * n, dtype),
        "dt_proj": dense_init(init, dtr, di, torch.float32, scale=dtr ** -0.5),
        "dt_bias": init.full((di,), -4.6, torch.float32),  # softplus^-1(0.01)
        "A_log": init.tensor(torch.log(a_init)),
        "D": init.full((di,), 1.0, torch.float32),
        "out_proj": dense_init(init, di, d, dtype, scale=di ** -0.5),
    }


def init_inner_norms(init: Init, cfg) -> Params:
    """Jamba's dt, B and C RMSNorm weights (f32, 0: a scale of 1 + w)."""
    n, dtr = cfg.ssm_state, cfg.resolved_dt_rank
    return {key: {"w": init.full((width,), 0.0, torch.float32)}
            for key, width in (("dt_norm", dtr), ("b_norm", n), ("c_norm", n))}


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv as a sum of shifted slices (left pad K-1).
    x: (B, S, di), w: (K, di)."""
    k = w.shape[0]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = sum(xp[:, i:i + x.shape[1], :] * w[i][None, None, :]
              for i in range(k))
    return out + b


def _ssm_inputs(cfg, p: Params, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Shared pre-scan projections. x: (B, S, di) post-conv post-silu.

    Returns dt (B,S,di) f32, B_ (B,S,N) f32, C_ (B,S,N) f32.
    """
    n = cfg.ssm_state
    dtr = cfg.resolved_dt_rank
    dbc = (x @ p["x_proj"]).float()
    dt, b_, c_ = torch.split(dbc, [dtr, n, n], dim=-1)
    dt = softplus(dt @ p["dt_proj"] + p["dt_bias"])  # (B,S,di)
    return dt, b_, c_


def normed_ssm_inputs(cfg, p: Params, x: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``_ssm_inputs`` with Jamba's RMSNorms (eps 1e-6, scaled by 1 + w, in
    f32) on dt before ``dt_proj`` and on B and C before the scan."""
    n = cfg.ssm_state
    dtr = cfg.resolved_dt_rank
    dbc = (x @ p["x_proj"]).float()
    dt, b_, c_ = torch.split(dbc, [dtr, n, n], dim=-1)
    dt = rms_norm(dt, p["dt_norm"]["w"])
    b_ = rms_norm(b_, p["b_norm"]["w"])
    c_ = rms_norm(c_, p["c_norm"]["w"])
    dt = softplus(dt @ p["dt_proj"] + p["dt_bias"])
    return dt, b_, c_


def ssm_train(cfg, p: Params, u: torch.Tensor,
              ssm_inputs=_ssm_inputs) -> torch.Tensor:
    """u: (B, S, d_model) -> (B, S, d_model). ``ssm_inputs`` makes dt, B
    and C from the conv's output."""
    s = u.shape[1]
    chunk = min(SSM_CHUNK, s)
    if s % chunk:
        # the JAX package's precondition, kept so both accept the same inputs
        raise ValueError(f"seq {s} not divisible by ssm chunk {chunk}")
    xz = u @ p["in_proj"]
    x, z = torch.chunk(xz, 2, dim=-1)  # (B,S,di) each
    x = F.silu(_causal_conv(x, p["conv_w"], p["conv_b"]))
    dt, b_, c_ = ssm_inputs(cfg, p, x)
    a = -torch.exp(p["A_log"])  # (di, N)
    xf = x.float()
    y = scan_ops.selective_scan(xf.contiguous(), dt.contiguous(),
                                b_.contiguous(), c_.contiguous(),
                                a.contiguous())
    y = y + xf * p["D"]
    y = (y * F.silu(z.float())).to(u.dtype)
    return y @ p["out_proj"]


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def init_ssm_cache(cfg, batch: int, dtype: torch.dtype,
                   device: torch.device) -> Params:
    di, n, k = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_conv
    return {
        "conv": torch.zeros((batch, k - 1, di), dtype=dtype, device=device),
        "h": torch.zeros((batch, di, n), dtype=torch.float32, device=device),
    }


def ssm_decode(cfg, p: Params, u: torch.Tensor, cache: Params,
               ssm_inputs=_ssm_inputs) -> torch.Tensor:
    """u: (B, 1, d_model). Returns y (B, 1, d_model); updates ``cache`` in
    place (the JAX package returns a new cache)."""
    xz = u @ p["in_proj"]
    x, z = torch.chunk(xz, 2, dim=-1)  # (B,1,di)
    # conv over [cached K-1 inputs, current]
    conv_in = torch.cat([cache["conv"], x.to(cache["conv"].dtype)], dim=1)
    xconv = torch.einsum("bkd,kd->bd", conv_in, p["conv_w"]) + p["conv_b"]
    x1 = F.silu(xconv)[:, None, :]  # (B,1,di)
    dt, b_, c_ = ssm_inputs(cfg, p, x1)
    a = -torch.exp(p["A_log"])
    da = torch.exp(dt[:, 0, :, None] * a[None])  # (B,di,N)
    dbx = (dt[:, 0] * x1[:, 0].float())[..., None] * b_[:, 0, None, :]
    h = da * cache["h"] + dbx
    y = torch.einsum("bdn,bn->bd", h, c_[:, 0])
    y = y + x1[:, 0].float() * p["D"]
    y = (y * F.silu(z[:, 0].float())).to(u.dtype)
    cache["conv"].copy_(conv_in[:, 1:])
    cache["h"].copy_(h)
    return (y @ p["out_proj"])[:, None, :]
