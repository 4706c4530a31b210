"""FL client: M local SGD steps from a (possibly stale) base model.

``make_local_update_fn`` builds

    (base_params, batches) -> (delta, metrics)

where ``delta = base - end`` is the paper's cumulative update Delta_i and
``batches`` is a tree whose leaves carry a leading (M, ...) local-step
axis. The function is pure, so ``torch.func.vmap`` runs K clients in one
call (``core/round_body.py``); the M steps are a Python loop where the JAX
package has ``lax.scan``.

``make_fresh_loss_fn`` evaluates the CURRENT global model on a fresh local
mini-batch — the P_i^t probe of eq. (4).
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.func import grad

from repro_torch.optim.optimizers import apply_updates, sgd
from repro_torch.utils.tree import tree_map, tree_sub


def make_local_update_fn(loss_fn: Callable, local_steps: int, local_lr: float,
                         momentum: float = 0.0,
                         prox_mu: float = 0.0) -> Callable:
    """loss_fn(params, batch) -> (scalar, metrics_dict).

    ``prox_mu > 0`` adds the FedProx proximal term mu/2 * ||w - w_base||^2
    to each local step.
    """
    opt = sgd(local_lr, momentum=momentum)
    grad_fn = grad(lambda p, b: loss_fn(p, b)[0])

    def local_update(base_params, batches):
        params, ostate = base_params, opt.init(base_params)
        for m in range(local_steps):
            batch = tree_map(lambda a: a[m], batches)
            g = grad_fn(params, batch)
            if prox_mu:
                g = tree_map(lambda gi, p, b: gi + prox_mu * (p - b).to(gi.dtype),
                             g, params, base_params)
            upd, ostate = opt.update(g, ostate)
            params = apply_updates(params, upd)
        return tree_sub(base_params, params), {}

    return local_update


def make_fresh_loss_fn(loss_fn: Callable) -> Callable:
    """(global_params, fresh_batch) -> scalar mean per-sample loss (f32)."""

    def fresh_loss(global_params, fresh_batch):
        loss, _ = loss_fn(global_params, fresh_batch)
        return loss.to(torch.float32)

    return fresh_loss
