"""Precision of the reference: where it rounds, and to what.

``Numerics("f32")`` is the reference: every operation in float32 with TF32
off, the parameters kept in the dtype that the configuration states for
them (``param_dtype``: a bf16 weight stays bf16-valued after each update,
as the configuration's storage makes it). ``Numerics("fp8")`` is the
control: the same code with each matrix product's operands, and each
stored parameter, rounded to float8 e4m3 under a per-tensor scale, the
precision below the configuration's bf16.
"""
from __future__ import annotations

import torch

FP8_MAX = 448.0  # largest finite float8 e4m3fn


def to_fp8(t: torch.Tensor) -> torch.Tensor:
    """Round-trip through float8 e4m3 with a per-tensor scale, in f32."""
    t = t.float()
    amax = t.detach().abs().amax()
    scale = torch.where(amax > 0, amax / FP8_MAX, torch.ones_like(amax))
    q = (t / scale).to(torch.float8_e4m3fn).float() * scale
    # the rounding is not differentiated: the gradient passes straight
    return t + (q - t).detach()


class Numerics:
    def __init__(self, kind: str = "f32"):
        if kind not in ("f32", "fp8"):
            raise ValueError(f"unknown numerics {kind!r}")
        self.kind = kind
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def operand(self, t: torch.Tensor) -> torch.Tensor:
        """A matrix product's operand, in f32 (or fp8-rounded)."""
        t = t.float()
        return to_fp8(t) if self.kind == "fp8" else t

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.operand(a) @ self.operand(b)

    def store(self, t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """A parameter written back to its storage dtype."""
        if self.kind == "fp8":
            return to_fp8(t.detach()).to(dtype)
        return t.to(dtype)
