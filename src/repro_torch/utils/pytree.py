"""Tree arithmetic helpers (the JAX package's ``utils/pytree.py``).

Leaf-wise over the port's trees (nested dicts of tensors, leaves in
``jax.tree.leaves`` order: ``utils/tree.py``). Reductions accumulate in
f32, one partial a leaf in leaf order, as the JAX helpers do.
"""
from __future__ import annotations

from typing import Any, List

import torch

from repro_torch.utils.tree import (  # noqa: F401
    tree_add,
    tree_leaves,
    tree_map,
    tree_sq_dist,
    tree_stack,
    tree_sub,
)


def tree_scale(a: Any, s) -> Any:
    """Scale every leaf of ``a`` by scalar ``s`` (a number or 0-d tensor)."""
    return tree_map(lambda x: x * s, a)


def tree_axpy(alpha, x: Any, y: Any) -> Any:
    """alpha * x + y, leaf-wise."""
    return tree_map(lambda xi, yi: alpha * xi + yi, x, y)


def tree_zeros_like(a: Any) -> Any:
    return tree_map(torch.zeros_like, a)


def tree_dot(a: Any, b: Any) -> torch.Tensor:
    """Sum of elementwise products across all leaves (f32 accumulation)."""
    parts = [torch.dot(x.to(torch.float32).reshape(-1),
                       y.to(torch.float32).reshape(-1))
             for x, y in zip(tree_leaves(a), tree_leaves(b))]
    return torch.sum(torch.stack(parts))


def tree_sq_norm(a: Any) -> torch.Tensor:
    """Squared L2 norm across all leaves (f32 accumulation)."""
    parts = [torch.sum(torch.square(x.to(torch.float32)))
             for x in tree_leaves(a)]
    return torch.sum(torch.stack(parts))


def tree_weighted_sum(trees_stacked: Any, weights: torch.Tensor) -> Any:
    """Weighted sum over the leading (client) axis of a stacked tree:
    leaves (K, ...) and ``weights`` (K,) give ``sum_k w_k * leaf[k]`` in
    each leaf's dtype, summed in f32."""

    def ws(leaf):
        w = weights.to(torch.float32).reshape((-1,) + (1,) * (leaf.dim() - 1))
        return torch.sum(leaf.to(torch.float32) * w, dim=0).to(leaf.dtype)

    return tree_map(ws, trees_stacked)


def tree_unstack(tree: Any, n: int) -> List[Any]:
    """Inverse of ``tree_stack`` for a known leading size ``n``."""
    return [tree_map(lambda x, i=i: x[i], tree) for i in range(n)]


def tree_count_params(a: Any) -> int:
    return sum(int(x.numel()) for x in tree_leaves(a))


def tree_bytes(a: Any) -> int:
    return sum(int(x.numel()) * x.element_size() for x in tree_leaves(a))


def tree_cast(a: Any, dtype: torch.dtype) -> Any:
    """Floating leaves cast to ``dtype``; other leaves kept."""
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x, a)


def tree_isfinite(a: Any) -> torch.Tensor:
    """True iff every element of every floating leaf is finite."""
    parts = [torch.all(torch.isfinite(x)) for x in tree_leaves(a)
             if x.is_floating_point()]
    if not parts:
        return torch.tensor(True)
    return torch.all(torch.stack(parts))


def tree_flatten_to_vector(a: Any) -> torch.Tensor:
    """Concatenate all leaves into one flat f32 vector (for analysis/tests)."""
    return torch.cat([x.to(torch.float32).reshape(-1) for x in tree_leaves(a)])
