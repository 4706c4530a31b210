"""Nested-dict parameter trees, flattened in the JAX package's leaf order.

Parameters in the port are nested ``dict``s of tensors (``{"c1": {"b":
..., "w": ...}, ...}``). ``tree_leaves`` walks dict keys in sorted order at
every level, which is the order ``jax.tree.flatten`` uses, so the flat
parameter vector and every version-ring row line up element for element
with the JAX package's.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

import numpy as np
import torch

Path = Tuple[str, ...]


def tree_paths(tree: Any, prefix: Path = ()) -> List[Path]:
    """Key paths of every leaf, dict keys sorted at every level."""
    if isinstance(tree, dict):
        out: List[Path] = []
        for key in sorted(tree):
            out.extend(tree_paths(tree[key], prefix + (key,)))
        return out
    return [prefix]


def tree_leaves(tree: Any) -> List[Any]:
    """Leaves in sorted-key order (``jax.tree.leaves`` order for dicts)."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in tree_leaves(tree[key])]
    return [tree]


def tree_unflatten(paths: List[Path], leaves: List[Any]) -> Any:
    """Inverse of ``tree_paths``/``tree_leaves``."""
    if len(paths) == 1 and paths[0] == ():
        return leaves[0]
    out: dict = {}
    for path, leaf in zip(paths, leaves):
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return out


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leaf-wise over trees (dicts and tuples) of one structure."""
    if isinstance(tree, dict):
        return {key: tree_map(fn, tree[key], *(r[key] for r in rest))
                for key in tree}
    if isinstance(tree, tuple):
        return tuple(tree_map(fn, *items) for items in zip(tree, *rest))
    return fn(tree, *rest)


def tree_map_with_path(fn: Callable, tree: Any) -> Any:
    """``fn(path, leaf)`` over a nested dict's leaves (``tree_paths``'
    paths), the structure kept (``jax.tree_util.tree_map_with_path``)."""
    paths = tree_paths(tree)
    return tree_unflatten(paths, [fn(p, leaf) for p, leaf in
                                  zip(paths, tree_leaves(tree))])


def tree_add(a: Any, b: Any) -> Any:
    return tree_map(torch.add, a, b)


def tree_sub(a: Any, b: Any) -> Any:
    return tree_map(torch.sub, a, b)


def tree_stack(trees: List[Any]) -> Any:
    """Stack a list of same-structure trees along a new leading axis, leaf
    by leaf (``repro.utils.pytree.tree_stack``)."""
    return tree_map(lambda *xs: torch.stack(xs, dim=0), *trees)


def tree_sq_dist(a: Any, b: Any) -> torch.Tensor:
    """Squared L2 distance ||a - b||^2 across all leaves (f32 accumulation,
    one partial per leaf in leaf order, as ``repro.utils.pytree``)."""
    parts = [torch.sum(torch.square(x.to(torch.float32) - y.to(torch.float32)))
             for x, y in zip(tree_leaves(a), tree_leaves(b))]
    return torch.sum(torch.stack(parts))


def tree_to_device(tree: Any, device: torch.device) -> Any:
    """Arrays or tensors -> tensors on ``device``, leaf by leaf. Read-only
    numpy arrays (views of a decoded wire frame) are copied first."""

    def leaf(a):
        if isinstance(a, np.ndarray) and not a.flags.writeable:
            a = a.copy()
        return torch.as_tensor(a).to(device)

    return tree_map(leaf, tree)
