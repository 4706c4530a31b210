"""Carry weights between the JAX package and the port.

Both keep the same parameter layout (conv HWIO, fc ``(din, dout)``), so
conversion is a copy of nested dicts of arrays; no transpose.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.utils.device import DeviceLike, resolve_device


def params_from_jax(tree: Any, device: DeviceLike = "cuda") -> Any:
    """Nested dicts of numpy arrays -> the same dicts of tensors on ``device``."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_jax(v, dev) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree), device=dev)


def params_to_numpy(tree: Any) -> Any:
    """Nested dicts of tensors -> the same dicts of numpy arrays."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()
