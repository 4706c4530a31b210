"""Server-side weighted aggregation (eq. 5) over stacked client deltas.

Two equivalent implementations:
  * ``aggregate``       — plain PyTorch, leaf by leaf;
  * ``aggregate_fused`` — the flat hot loop through the K3 kernel
    (``kernels/weighted_agg/ops.weighted_sum``): one launch streams every
    parameter once. On CPU tensors the wrapper runs its plain version.
"""
from __future__ import annotations

import torch

from repro_torch.core.server_pass import (
    flatten_stacked,
    flatten_tree,
    make_flat_spec,
    unflatten_like,
)
from repro_torch.kernels.weighted_agg import ops
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


def aggregate_fused(global_params, deltas_stacked, weights: torch.Tensor,
                    eta_g: float, k: int):
    """Same maths as ``aggregate`` in ONE K3 launch over the flattened tree.

    The FlatSpec adapter (``core/server_pass.py``) concatenates and
    zero-pads all leaves to one (K, n_padded) matrix, so a single kernel
    streams every parameter once instead of one launch per leaf.
    """
    spec = make_flat_spec(global_params)
    x = flatten_tree(spec, global_params)
    d = flatten_stacked(spec, deltas_stacked)
    w = weights.to(torch.float32) * (eta_g / float(k))
    u = ops.weighted_sum(d, w)
    return unflatten_like(spec, x - u), unflatten_like(spec, u)
