"""Contribution-aware update weighting — the paper's central equations.

eq. (3)  S_i^t = min_j ||x^t - x^{t-tau_j}||^2 / ||x^t - x^{t-tau_i}||^2
eq. (4)  P_i^t = N_i * (1/|zeta_i|) F_i(x^t, zeta_i)
eq. (5)  x_{t+1} = x_t - eta_g * (1/K) * sum_i (P_i^t / S_i^t) * Delta_i

Policies:
  paper          : w_i = P_i / max(S_i, s_min)          (eq. 5, literal)
  multiplicative : w_i = P_i * S_i                      (typo-corrected read)
  fedbuff        : w_i = 1                              (uniform baseline)
  polynomial     : w_i = (1 + tau_i)^-a                 (a = 0.5)
  fedasync       : alias of polynomial
  fedasync_constant / fedasync_hinge / fedasync_poly : FedAsync's s(tau)
  family (Xie et al., arXiv:1903.03934).

``normalize="mean"`` rescales weights to mean 1 over the arrived slots;
``"none"`` is the literal form. Every function takes and returns f32
tensors on the caller's device and never syncs with the host; the
constants (``eps=1e-12``, the hinge floor, the normalization floors) are
those of the JAX package's ``core/weighting.py``.
"""
from __future__ import annotations

from typing import Optional

import torch

FEDASYNC_POLICIES = ("fedasync_constant", "fedasync_hinge", "fedasync_poly")
POLICIES = ("paper", "multiplicative", "fedbuff", "polynomial",
            "fedasync") + FEDASYNC_POLICIES


def fedasync_discount(flag: str, tau_rounds: torch.Tensor, *,
                      hinge_a: float = 10.0, hinge_b: float = 6.0,
                      poly_a: float = 0.5) -> torch.Tensor:
    """FedAsync's ``s(tau)`` discount (``constant`` / ``hinge`` / ``poly``).

    The hinge denominator is floored at 1e-12 so tau == b stays finite.
    """
    tau = tau_rounds.to(torch.float32)
    if flag == "constant":
        return torch.ones_like(tau)
    if flag == "hinge":
        return torch.where(
            tau <= hinge_b, torch.ones_like(tau),
            1.0 / torch.clamp(hinge_a * (tau - hinge_b), min=1e-12))
    if flag == "poly":
        return torch.pow(1.0 + tau, -poly_a)
    raise ValueError(f"unknown fedasync flag {flag!r}; "
                     "valid: constant, hinge, poly")


def staleness_degree(sq_dists: torch.Tensor, eps: float = 1e-12, *,
                     ref_sq_dist: Optional[float] = None,
                     arrival_mask: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """eq. (3). sq_dists: (K,) ||x^t - x^{base_i}||^2. Returns (K,) in [0, 1].

    With ``arrival_mask`` the ``min_j`` reference runs over arrived
    (mask > 0) slots only; absent slots park on ``max(d)``, which never
    wins while any slot arrived. ``ref_sq_dist`` pins the reference to a
    fixed squared distance instead.
    """
    d = torch.clamp(sq_dists.to(torch.float32), min=0.0)
    if ref_sq_dist is not None:
        m = torch.as_tensor(ref_sq_dist, dtype=torch.float32, device=d.device)
    elif arrival_mask is not None:
        m = torch.min(torch.where(arrival_mask > 0, d, torch.max(d)))
    else:
        m = torch.min(d)
    s = (m + eps) / (d + eps)
    return torch.clamp(s, 0.0, 1.0)


def statistical_effect(batch_losses: torch.Tensor,
                       data_sizes: torch.Tensor) -> torch.Tensor:
    """eq. (4): (K,) N_i * mean fresh-batch loss."""
    return data_sizes.to(torch.float32) * batch_losses.to(torch.float32)


def contribution_weights(policy: str,
                         p_stat: torch.Tensor,
                         s_stale: torch.Tensor,
                         tau_rounds: torch.Tensor,
                         *,
                         s_min: float = 1e-3,
                         poly_a: float = 0.5,
                         hinge_a: float = 10.0,
                         hinge_b: float = 6.0,
                         normalize: str = "mean",
                         arrival_mask: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Per-update aggregation weights w_i (before the 1/K of eq. 5).

    ``arrival_mask``: optional (K,) {0,1}; masked-out slots get weight 0 and
    are excluded from the normalization.
    """
    if policy not in POLICIES:
        raise ValueError(f"unknown policy {policy!r}; valid: {POLICIES}")
    if policy == "paper":
        w = p_stat / torch.clamp(s_stale, min=s_min)
    elif policy == "multiplicative":
        w = p_stat * s_stale
    elif policy == "fedbuff":
        w = torch.ones_like(p_stat)
    elif policy in FEDASYNC_POLICIES:
        w = fedasync_discount(policy.split("_", 1)[1], tau_rounds,
                              hinge_a=hinge_a, hinge_b=hinge_b,
                              poly_a=poly_a)
    else:  # polynomial / fedasync
        w = torch.pow(1.0 + tau_rounds.to(torch.float32), -poly_a)
    w = w.to(torch.float32)
    if arrival_mask is not None:
        mask = arrival_mask.to(torch.float32)
        w = w * mask
        denom_n = torch.clamp(torch.sum(mask), min=1.0)
    else:
        denom_n = torch.tensor(float(w.shape[0]), dtype=torch.float32,
                               device=w.device)
    if normalize == "mean":
        w = w * denom_n / torch.clamp(torch.sum(w), min=1e-12)
    elif normalize != "none":
        raise ValueError(f"unknown normalize {normalize!r}")
    return w
