"""Synchronous FedAvg server (the Fig. 1 baseline rows).

The buffered-async ``AsyncServer`` of the JAX package is not ported yet;
the vectorized engine (``sim/engine.py``) runs the async protocol.
"""
from __future__ import annotations

from typing import Any, List

import torch

from repro_torch.configs.base import FLConfig
from repro_torch.core.aggregation import aggregate
from repro_torch.utils.tree import tree_leaves


class SyncServer:
    """FedAvg: waits for all selected clients, size-weighted average."""

    def __init__(self, init_params: Any, fl: FLConfig):
        self.fl = fl
        self.params = init_params
        self.version = 0

    def round(self, deltas_stacked: Any, data_sizes: List[int]) -> None:
        """Apply one round from the selected clients' stacked (K, ...) deltas."""
        k = len(data_sizes)
        device = tree_leaves(deltas_stacked)[0].device
        w = torch.as_tensor(data_sizes, dtype=torch.float32, device=device)
        w = w * k / torch.sum(w)  # size-weighted, mean-1 normalised
        self.params, _ = aggregate(self.params, deltas_stacked, w,
                                   self.fl.global_lr, k)
        self.version += 1
