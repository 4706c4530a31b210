"""Nested-dict checkpoints to ``.npz``, readable by the JAX package too.

A tree of nested dicts of arrays or tensors is flattened to one ``.npz``
entry per leaf, keyed by its path in the format of
``jax.tree_util.keystr`` for dict keys: ``['ring']['codes']``, keys
sorted as ``jax.tree.flatten`` orders them. So an engine checkpoint
written by either package (``sim/engine.py::engine_state_to_tree``)
loads in the other. The write is atomic: a temp file in the target
directory, then a rename.

Not ported: the JAX package's multi-process coordinator gating comes with
the distributed substrate (ROADMAP.md, Slice E).
"""
from __future__ import annotations

import os
import tempfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


def _flatten(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        return [item for key in sorted(tree)
                for item in _flatten(tree[key], f"{prefix}[{key!r}]")]
    return [(prefix, tree)]


def _unflatten(like: Any, leaves: Dict[str, Any], prefix: str = "") -> Any:
    if isinstance(like, dict):
        return {key: _unflatten(like[key], leaves, f"{prefix}[{key!r}]")
                for key in like}
    return leaves[prefix]


def _to_numpy(v: Any) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def save_checkpoint(path: str, tree: Any, step: Optional[int] = None) -> None:
    """Write ``tree`` to ``path`` atomically (temp file + rename)."""
    payload = {key: _to_numpy(v) for key, v in _flatten(tree)}
    if step is not None:
        payload["__step__"] = np.asarray(step)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_checkpoint(path: str, like: Any = None):
    """Load a checkpoint; if ``like`` is given, restore into its structure
    (each leaf cast to the dtype of ``like``'s leaf, shapes checked).

    Returns ``(tree_or_flat_dict, step_or_None)``.
    """
    with np.load(path) as z:
        data = {k: z[k] for k in z.files}
    step = int(data.pop("__step__")) if "__step__" in data else None
    if like is None:
        return data, step
    leaves = {}
    for key, v in _flatten(like):
        if key not in data:
            raise KeyError(f"checkpoint missing key {key}")
        want = _to_numpy(v)
        arr = data[key]
        if tuple(arr.shape) != tuple(want.shape):
            raise ValueError(f"shape mismatch for {key}: {arr.shape} vs "
                             f"{want.shape}")
        leaves[key] = arr.astype(want.dtype)
    return _unflatten(like, leaves), step
