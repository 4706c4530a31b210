"""Public wrappers: the CUDA kernel for CUDA tensors, the plain version for CPU.

A wrapper takes its plain PyTorch version (``ref.py``) only because the
tensors it was given lie on the CPU. For CUDA tensors it launches the
kernel or raises; there is no fallback. Each wrapper counts its kernel
launches in a plain integer attribute (``sq_dists.launches`` etc.), so a
run can show that its main path went through the kernels.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.weighting import POLICIES
from repro_torch.kernels.weighted_agg import kernel as _k
from repro_torch.kernels.weighted_agg import ref as _ref
from repro_torch.utils.device import on_cuda

LANE = 128
DEFAULT_BLOCK_N = 16 * 1024


def pad_to(n: int, block: int) -> int:
    return (n + block - 1) // block * block


def pick_block(n: int) -> int:
    """The JAX package's tile rule, kept so ``FlatSpec.n_padded`` matches it.

    n >= DEFAULT_BLOCK_N: the default tile; below it, one lane-padded tile.
    The CUDA kernels take any N; the padding only keeps the flat layout,
    and with it every version-ring row, identical to the JAX package's.
    """
    if n >= DEFAULT_BLOCK_N:
        return DEFAULT_BLOCK_N
    return max(LANE, pad_to(n, LANE))


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32).contiguous()


def _check_kn(a: torch.Tensor, name: str) -> Tuple[int, int]:
    if a.dim() != 2 or a.shape[0] < 1 or a.shape[1] < 1:
        raise ValueError(f"{name} must be (K, N) with K, N >= 1; got {tuple(a.shape)}")
    return a.shape[0], a.shape[1]


def _check_vec(a: torch.Tensor, size: int, name: str) -> None:
    if tuple(a.shape) != (size,):
        raise ValueError(f"{name} must be ({size},); got {tuple(a.shape)}")


def sq_dists(x: torch.Tensor, bases: torch.Tensor) -> torch.Tensor:
    """x: (N,), bases: (K, N) -> (K,) squared distances ||x - base_k||^2."""
    k, n = _check_kn(bases, "bases")
    _check_vec(x, n, "x")
    if not on_cuda(x, bases):
        return _ref.sq_dists_ref(x, bases)
    out = _k.sq_dists(_f32(x), _f32(bases))
    sq_dists.launches += 1
    return out


sq_dists.launches = 0


def weighted_sum(deltas: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """deltas: (K, N), weights: (K,) -> (N,) = sum_k w_k * deltas_k."""
    k, _ = _check_kn(deltas, "deltas")
    _check_vec(weights, k, "weights")
    if not on_cuda(deltas, weights):
        return _ref.weighted_sum_ref(deltas, weights)
    out = _k.weighted_sum(_f32(deltas), _f32(weights))
    weighted_sum.launches += 1
    return out


weighted_sum.launches = 0


def server_update(x: torch.Tensor, bases: torch.Tensor, deltas: torch.Tensor,
                  p_stat: torch.Tensor, taus: torch.Tensor,
                  arrival_mask: Optional[torch.Tensor] = None, *,
                  policy: str = "paper", eta_g: float = 1.0,
                  s_min: float = 1e-3, poly_a: float = 0.5,
                  hinge_a: float = 10.0, hinge_b: float = 6.0,
                  normalize: str = "mean"
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused server pass (eq. 3 + weighting + eq. 5).

    x: (N,), bases/deltas: (K, N), p_stat/taus/arrival_mask: (K,). Returns
    ``(upd (N,), sq_dists (K,), weights (K,))``; ``upd`` carries eq. 5's
    ``eta_g / k_eff`` scale, so ``x_new = x - upd``.
    """
    if policy not in POLICIES:
        raise ValueError(f"unknown policy {policy!r}; valid: {POLICIES}")
    if normalize not in ("mean", "none"):
        raise ValueError(f"unknown normalize {normalize!r}")
    k, n = _check_kn(bases, "bases")
    if tuple(deltas.shape) != (k, n):
        raise ValueError(f"deltas must be ({k}, {n}); got {tuple(deltas.shape)}")
    _check_vec(x, n, "x")
    vecs = [("p_stat", p_stat), ("taus", taus)]
    if arrival_mask is not None:
        vecs.append(("arrival_mask", arrival_mask))
    for name, v in vecs:
        _check_vec(v, k, name)
    cfg = dict(policy=policy, eta_g=eta_g, s_min=s_min, poly_a=poly_a,
               hinge_a=hinge_a, hinge_b=hinge_b, normalize=normalize)
    if not on_cuda(x, bases, deltas, *(v for _, v in vecs)):
        return _ref.server_update_ref(x, bases, deltas, p_stat, taus,
                                      arrival_mask, **cfg)
    # no mask: the kernel takes a null pointer as "every slot arrived"
    mask = None if arrival_mask is None else _f32(arrival_mask)
    out = _k.fused_server(_f32(x), _f32(bases), _f32(deltas), _f32(p_stat),
                          _f32(taus), mask, **cfg)
    server_update.launches += 1
    return out


server_update.launches = 0


def reset_launches() -> None:
    """Set every wrapper's launch count to 0."""
    sq_dists.launches = 0
    weighted_sum.launches = 0
    server_update.launches = 0
