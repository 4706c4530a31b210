"""Plain-PyTorch versions of the weighted_agg kernels.

The ``ops`` wrappers run these for CPU tensors; the tests and
``chip_smoke.py`` hold each CUDA kernel against them on the same inputs.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.weighting import (
    contribution_weights,
    staleness_degree,
)


def weighted_sum_ref(deltas: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """deltas: (K, N), weights: (K,) -> (N,)."""
    return torch.sum(deltas.to(torch.float32)
                     * weights.to(torch.float32)[:, None], dim=0)


def sq_dists_ref(x: torch.Tensor, bases: torch.Tensor) -> torch.Tensor:
    """x: (N,), bases: (K, N) -> (K,)."""
    diff = bases.to(torch.float32) - x.to(torch.float32)[None]
    return torch.sum(diff * diff, dim=1)


def server_update_ref(x: torch.Tensor, bases: torch.Tensor,
                      deltas: torch.Tensor, p_stat: torch.Tensor,
                      taus: torch.Tensor,
                      arrival_mask: Optional[torch.Tensor] = None, *,
                      policy: str = "paper", eta_g: float = 1.0,
                      s_min: float = 1e-3, poly_a: float = 0.5,
                      hinge_a: float = 10.0, hinge_b: float = 6.0,
                      normalize: str = "mean"
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The fused pass's function: (upd (N,), sq_dists (K,), weights (K,))."""
    k = bases.shape[0]
    mask = (torch.ones((k,), dtype=torch.float32, device=bases.device)
            if arrival_mask is None else arrival_mask.to(torch.float32))
    dists = sq_dists_ref(x, bases)
    s = staleness_degree(dists, arrival_mask=mask)
    w = contribution_weights(policy, p_stat.to(torch.float32), s,
                             taus.to(torch.float32), s_min=s_min,
                             poly_a=poly_a, hinge_a=hinge_a, hinge_b=hinge_b,
                             normalize=normalize, arrival_mask=mask)
    k_eff = torch.clamp(torch.sum(mask), min=1.0)
    upd = weighted_sum_ref(deltas, w * (eta_g / k_eff))
    return upd, dists, w
