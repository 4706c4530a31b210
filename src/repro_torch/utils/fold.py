"""Helpers of the kernel Functions' ``vmap`` rules and their input guard.

A kernel is launched through ``ctypes`` on plain tensors: a ``torch.func``
wrapper (a batched tensor of ``vmap``, a grad-tracking tensor of ``grad``)
has no device pointer of its own. So each kernel Function has a ``vmap``
rule that folds the vmapped dimension into the batch dimension and makes
one call on plain tensors, and ``require_plain`` raises if a wrapper ever
reaches a kernel or its plain version.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch._C._functorch import is_functorch_wrapped_tensor


def require_plain(what: str, *tensors: torch.Tensor) -> None:
    """Raise if any input is a ``torch.func`` wrapper."""
    if any(is_functorch_wrapped_tensor(t) for t in tensors):
        raise RuntimeError(f"{what} received a batched or grad-tracking "
                           "tensor: its autograd.Function must unwrap it")


def fold_batch(t: torch.Tensor, in_dim: Optional[int], n: int) -> torch.Tensor:
    """(vmapped n at ``in_dim``, B, ...) -> contiguous (n * B, ...); an input
    that is not vmapped (``in_dim`` None) is repeated n times."""
    t = t.expand(n, *t.shape) if in_dim is None else t.movedim(in_dim, 0)
    return t.reshape(n * t.shape[1], *t.shape[2:]).contiguous()


def unfold_batch(t: torch.Tensor, n: int) -> torch.Tensor:
    """(n * B, ...) -> (n, B, ...)."""
    return t.reshape(n, t.shape[0] // n, *t.shape[1:])
