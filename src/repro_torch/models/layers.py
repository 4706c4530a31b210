"""Shared layers of the language models (port of the JAX package's
``models/layers.py``).

Parameters are plain dicts of tensors in the JAX package's layout (dense
weights ``(d_in, d_out)``, activations ``(..., S, H, D)``), so weights
carry across with ``models/convert.py`` and the tests compare like with
like. Norms and RoPE compute in f32 and cast back, as in the JAX package.

Initialisers draw from an explicit ``torch.Generator`` with the JAX
package's distributions (not its numbers: ``jax.random`` and torch's
generators differ). An ``Init`` without a generator makes tensors on the
``meta`` device, which gives shapes and parameter counts without memory.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.kernels.rms_norm.ops import rms_norm as rms_norm_fn

Params = Dict[str, object]


def dtype_of(name: str) -> torch.dtype:
    """A config's dtype string (``"float32"``, ``"bfloat16"``) as a torch dtype."""
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16,
              "float16": torch.float16}
    if name not in dtypes:
        raise ValueError(f"unsupported dtype {name!r}; known: {sorted(dtypes)}")
    return dtypes[name]


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


class Init:
    """Draws parameters from ``generator`` (on the generator's device) and
    places them on ``device``; with ``generator=None`` it makes ``meta``
    tensors of the same shapes and dtypes."""

    def __init__(self, generator: Optional[torch.Generator],
                 device: torch.device):
        self.generator = generator
        self.device = device if generator is not None else torch.device("meta")

    def normal(self, shape: Sequence[int], scale: float,
               dtype: torch.dtype) -> torch.Tensor:
        """N(0, 1) * scale drawn in f32, then cast (``jax.random.normal(...)
        * scale).astype(dtype)``)."""
        if self.generator is None:
            return torch.empty(tuple(shape), dtype=dtype, device="meta")
        x = torch.randn(tuple(shape), generator=self.generator,
                        device=self.generator.device, dtype=torch.float32)
        # scaled in place: one f32 draw is the only scratch
        return x.mul_(scale).to(dtype=dtype, device=self.device)

    def stacked_normal(self, n: int, shape: Sequence[int], scale: float,
                       dtype: torch.dtype) -> torch.Tensor:
        """``n`` draws of ``normal(shape, scale, dtype)`` stacked on a new
        leading axis, each drawn straight into its slice: the f32 draw of
        one slice is the only scratch (a stack of experts in f32 would be
        twice its bf16 result)."""
        if self.generator is None:
            return torch.empty((n, *shape), dtype=dtype, device="meta")
        out = torch.empty((n, *shape), dtype=dtype, device=self.device)
        for i in range(n):
            out[i] = self.normal(shape, scale, dtype)
        return out

    def full(self, shape: Sequence[int], value: float,
             dtype: torch.dtype) -> torch.Tensor:
        return torch.full(tuple(shape), value, dtype=dtype, device=self.device)

    def tensor(self, t: torch.Tensor) -> torch.Tensor:
        """A tensor computed on the CPU (e.g. ``A_log``), placed on the device."""
        if self.generator is None:
            return torch.empty(t.shape, dtype=t.dtype, device="meta")
        return t.to(self.device)


def dense_init(init: Init, in_dim: int, out_dim: int, dtype: torch.dtype,
               scale: Optional[float] = None) -> torch.Tensor:
    scale = scale if scale is not None else in_dim ** -0.5
    return init.normal((in_dim, out_dim), scale, dtype)


def embed_init(init: Init, vocab: int, dim: int,
               dtype: torch.dtype) -> torch.Tensor:
    return init.normal((vocab, dim), 0.02, dtype)


# ---------------------------------------------------------------------------
# norms (computed in f32, cast back)
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """The RMSNorm kernel on CUDA tensors, the eager chain on CPU tensors
    (``kernels/rms_norm``), differentiable and vmappable either way."""
    return rms_norm_fn(x, weight, eps)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * weight.float() + bias.float()).to(x.dtype)


def make_norm_params(cfg, dim: int, init: Init) -> Params:
    if cfg.norm == "rmsnorm":
        return {"w": init.full((dim,), 0.0, torch.float32)}
    return {"w": init.full((dim,), 1.0, torch.float32),
            "b": init.full((dim,), 0.0, torch.float32)}


def apply_norm(cfg, p: Params, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm == "rmsnorm":
        return rms_norm(x, p["w"])
    return layer_norm(x, p["w"], p["b"])


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float,
                     device: torch.device) -> torch.Tensor:
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, Dh); positions: broadcastable to (..., S). Rotates
    the two halves of each head (not interleaved pairs), in f32."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)  # (Dh/2,)
    angles = positions.float()[..., None] * freqs  # (..., S, Dh/2)
    cos = torch.cos(angles)[..., None, :]  # (..., S, 1, Dh/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(positions: torch.Tensor, dim: int) -> torch.Tensor:
    """Classic transformer sinusoid table, computed on the fly.

    positions: (...,) int -> (..., dim) float32.
    """
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)
    ang = positions.float()[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# gated MLP
# ---------------------------------------------------------------------------


def init_mlp(init: Init, cfg, d_model: Optional[int] = None,
             d_ff: Optional[int] = None) -> Params:
    d_model = d_model or cfg.d_model
    d_ff = d_ff or cfg.d_ff
    dtype = dtype_of(cfg.param_dtype)
    if cfg.activation in ("swiglu", "geglu"):
        return {
            "w_gate": dense_init(init, d_model, d_ff, dtype),
            "w_up": dense_init(init, d_model, d_ff, dtype),
            "w_down": dense_init(init, d_ff, d_model, dtype, scale=d_ff ** -0.5),
        }
    return {
        "w_up": dense_init(init, d_model, d_ff, dtype),
        "b_up": init.full((d_ff,), 0.0, dtype),
        "w_down": dense_init(init, d_ff, d_model, dtype, scale=d_ff ** -0.5),
        "b_down": init.full((d_model,), 0.0, dtype),
    }


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def apply_mlp(cfg, p: Params, x: torch.Tensor) -> torch.Tensor:
    if cfg.activation in ("swiglu", "geglu"):
        gate = x @ p["w_gate"]
        act = F.silu(gate) if cfg.activation == "swiglu" else _gelu(gate)
        return (act * (x @ p["w_up"])) @ p["w_down"]
    h = _gelu(x @ p["w_up"] + p["b_up"])
    return h @ p["w_down"] + p["b_down"]
