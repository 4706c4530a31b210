"""Functional optimizers on nested dicts of tensors (the JAX package's
``optim/optimizers.py``).

    opt = sgd(lr=0.1, momentum=0.9)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

``update`` returns the delta to add to params (already negated and scaled
by the learning rate). ``lr`` is a float or a callable ``step -> lr`` (a
schedule of ``optim/schedules.py``); the state carries the step counter.
The learning rate is an f32 tensor, as ``jnp.asarray(lr, float32)`` is in
the JAX package, so a bf16 gradient's update is computed in f32 and cast
to the parameter's dtype when it is applied. Pure functions, so they
compose with ``torch.func.vmap``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Union

import torch

from repro_torch.utils.tree import tree_leaves, tree_map

LrType = Union[float, Callable[[torch.Tensor], torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    # (grads, state, params=None) -> (updates, state)
    update: Callable[..., Any]


def _resolve_lr(lr: LrType, step: torch.Tensor) -> torch.Tensor:
    if callable(lr):
        return lr(step)
    return torch.tensor(lr, dtype=torch.float32, device=step.device)


def _step0(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)


class SgdState(NamedTuple):
    step: torch.Tensor
    momentum: Any  # tree like params, or None without momentum


def sgd(lr: LrType, momentum: float = 0.0, weight_decay: float = 0.0,
        nesterov: bool = False) -> Optimizer:
    """Momentum ``m = mu * m + g`` (Nesterov: the step takes ``mu * m + g``
    with the new m); ``weight_decay * p`` is added to the gradient."""
    use_mom = momentum != 0.0

    def init(params):
        mom = tree_map(torch.zeros_like, params) if use_mom else None
        return SgdState(step=_step0(params), momentum=mom)

    def update(grads, state, params=None):
        step_lr = _resolve_lr(lr, state.step)
        if weight_decay and params is not None:
            grads = tree_map(lambda g, p: g + weight_decay * p, grads, params)
        if use_mom:
            new_mom = tree_map(lambda m, g: momentum * m + g, state.momentum,
                               grads)
            eff = tree_map(lambda m, g: momentum * m + g, new_mom, grads) \
                if nesterov else new_mom
        else:
            new_mom, eff = None, grads
        updates = tree_map(lambda g: -step_lr * g.to(torch.float32), eff)
        return updates, SgdState(step=state.step + 1, momentum=new_mom)

    return Optimizer(init=init, update=update)


class AdamWState(NamedTuple):
    step: torch.Tensor
    mu: Any
    nu: Any


def adamw(lr: LrType, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    """Adam with decoupled weight decay; moments in f32, updates in the
    parameter's dtype."""

    def init(params):
        def zeros(p):
            return torch.zeros_like(p, dtype=torch.float32)

        return AdamWState(step=_step0(params), mu=tree_map(zeros, params),
                          nu=tree_map(zeros, params))

    def update(grads, state, params=None):
        step = state.step + 1
        step_lr = _resolve_lr(lr, state.step)
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.to(torch.float32),
                      state.mu, grads)
        nu = tree_map(lambda v, g: b2 * v
                      + (1 - b2) * torch.square(g.to(torch.float32)),
                      state.nu, grads)
        stepf = step.to(torch.float32)
        bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                           device=stepf.device), stepf)
        bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                           device=stepf.device), stepf)

        def upd(m, v, p):
            u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if weight_decay and p is not None:
                u = u + weight_decay * p.to(torch.float32)
            return (-step_lr * u).to(p.dtype if p is not None else m.dtype)

        if params is None:
            updates = tree_map(lambda m, v: upd(m, v, None), mu, nu)
        else:
            updates = tree_map(upd, mu, nu, params)
        return updates, AdamWState(step=step, mu=mu, nu=nu)

    return Optimizer(init=init, update=update)


def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)
