"""Carry weights between the JAX package and the port.

Both keep the same parameter layout (conv HWIO, dense ``(din, dout)``,
language-model layers stacked on a leading axis), so conversion is a copy
of nested dicts of arrays; no transpose. bf16 leaves arrive from JAX as
``ml_dtypes.bfloat16`` numpy arrays, which ``torch.tensor`` cannot take:
they go through float32, which is exact both ways.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.utils.device import DeviceLike, resolve_device


def _leaf_to_tensor(arr: Any, dev: torch.device) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.tensor(arr.astype(np.float32), device=dev).to(
            torch.bfloat16)
    return torch.tensor(arr, device=dev)


def params_from_jax(tree: Any, device: DeviceLike = "cuda") -> Any:
    """Nested dicts of numpy arrays -> the same dicts of tensors on ``device``."""
    dev = resolve_device(device)

    def convert(t):
        if isinstance(t, dict):
            return {k: convert(v) for k, v in t.items()}
        return _leaf_to_tensor(t, dev)

    return convert(tree)


def params_to_numpy(tree: Any) -> Any:
    """Nested dicts of tensors -> the same dicts of numpy arrays; bf16 leaves
    as ``ml_dtypes.bfloat16`` (what ``jnp.asarray`` takes as bf16)."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # only needed for bf16 leaves

        return t.float().numpy().astype(ml_dtypes.bfloat16)
    return t.numpy()


def lm_params_from_jax(tree: Any, device: DeviceLike = "cuda") -> Any:
    """A language model's params from the JAX package (``jax.device_get`` of
    its ``Model.init``) -> the port's ``Model`` params on ``device``: the same
    dicts, layers stacked on the leading axis, bf16 leaves kept bf16."""
    return params_from_jax(tree, device)


def lm_params_to_jax(tree: Any) -> Any:
    """Inverse of ``lm_params_from_jax``: numpy arrays that ``jnp.asarray``
    turns back into the JAX package's params, bit for bit."""
    return params_to_numpy(tree)
