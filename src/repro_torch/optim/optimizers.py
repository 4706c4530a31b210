"""Functional SGD on nested dicts of tensors (the JAX package's ``sgd``).

    opt = sgd(lr=0.1, momentum=0.9)
    state = opt.init(params)
    updates, state = opt.update(grads, state)
    params = apply_updates(params, updates)

``update`` returns the delta to add to params (already negated and scaled
by the learning rate). Momentum follows ``m = mu * m + g``, update
``-lr * m``. Pure functions, so they compose with ``torch.func.vmap``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.utils.tree import tree_map


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[[Any, Any], Any]  # (grads, state) -> (updates, state)


def sgd(lr: float, momentum: float = 0.0) -> Optimizer:
    """State is the momentum tree (None without momentum)."""
    use_mom = momentum != 0.0

    def init(params):
        return tree_map(torch.zeros_like, params) if use_mom else None

    def update(grads, mom):
        if use_mom:
            mom = tree_map(lambda m, g: momentum * m + g, mom, grads)
            grads = mom
        return tree_map(lambda g: -lr * g, grads), mom

    return Optimizer(init=init, update=update)


def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)
