"""Server-side weighted aggregation (eq. 5) over stacked client deltas."""
from __future__ import annotations

import torch

from repro_torch.utils.tree import tree_map, tree_sub


def tree_weighted_sum(trees_stacked, weights: torch.Tensor):
    """sum_k w_k * leaf[k] over the leading (client) axis of every leaf."""

    def _ws(leaf):
        w = weights.to(torch.float32).reshape((-1,) + (1,) * (leaf.dim() - 1))
        return torch.sum(leaf.to(torch.float32) * w, dim=0).to(leaf.dtype)

    return tree_map(_ws, trees_stacked)


def aggregate(global_params, deltas_stacked, weights: torch.Tensor,
              eta_g: float, k: int):
    """eq. (5): x_{t+1} = x_t - eta_g * (1/K) sum_i w_i Delta_i.

    deltas_stacked: tree with leading (K, ...) leaves. weights: (K,).
    Returns (new_params, update).
    """
    scale = eta_g / float(k)
    upd = tree_weighted_sum(deltas_stacked, weights.to(torch.float32) * scale)
    return tree_sub(global_params, upd), upd
