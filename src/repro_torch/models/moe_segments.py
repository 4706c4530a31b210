"""The held experts' dropless dispatch for serving: each held expert runs
on its segment of the (token, choice) pairs sorted by expert id, with no
padding and no pair dropped.

The segments' bounds are read on the host, one read a MoE layer, so this
runs only outside ``torch.func`` transforms (``moe.moe_share_ffn`` takes
it where ``utils.fold.level()`` is None: prefill, decode and a plain
autograd loss); under ``vmap(grad)`` the MoE takes the capacity dispatch
in ``moe.py``, whose source holds no host read.

The counters ``moe.pairs_held`` and ``moe.pairs_absent`` of
``obs.metrics.default_registry()`` count the routed pairs by whether this
device holds their expert, from the host ints the bounds already give.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.obs.metrics import default_registry
from repro_torch.obs.trace import (
    SPAN_MOE_COMBINE,
    SPAN_MOE_DISPATCH,
    active_tracer,
)

Params = Dict[str, object]


def dropless_share(cfg, p: Params, xf: torch.Tensor,
                    gate_vals: torch.Tensor, expert_ids: torch.Tensor,
                    held: int) -> torch.Tensor:
    """Every pair of a held expert, none padded: the pairs in the stable
    sort by expert id, whose first entries are the held experts' (ids
    below ``held``); each held expert's segment (its bounds read on the
    host) through its SwiGLU; each token's terms summed in ascending
    expert id, as ``dispatch_combine`` sums them."""
    k = cfg.experts_per_token
    tracer = active_tracer()
    with tracer.span(SPAN_MOE_DISPATCH, cat="moe"):
        flat_e = expert_ids.reshape(-1)
        sort_idx = torch.argsort(flat_e, stable=True)
        bounds = torch.searchsorted(
            flat_e[sort_idx], torch.arange(held + 1, device=xf.device)
        ).tolist()  # the layer's one host read
        n_held = bounds[-1]
        xs = xf[sort_idx[:n_held] // k]
    outs = []
    for j in range(held):
        a, b = bounds[j], bounds[j + 1]
        if b > a:
            h = F.silu(xs[a:b] @ p["w_gate"][j]) * (xs[a:b] @ p["w_up"][j])
            outs.append(h @ p["w_down"][j])
    with tracer.span(SPAN_MOE_COMBINE, cat="moe"):
        terms = torch.cat(outs) if outs else xf.new_zeros((0, xf.shape[1]))
        w = gate_vals.reshape(-1)[sort_idx[:n_held]].to(terms.dtype)
        # a zero row past the held entries: an absent pair reads it
        terms = torch.cat([terms * w[:, None],
                           terms.new_zeros((1, terms.shape[1]))])
        at = torch.empty_like(sort_idx)
        at[sort_idx] = torch.arange(sort_idx.numel(), device=xf.device)
        order = torch.clamp(torch.sort(at.reshape(-1, k), dim=-1).values,
                            max=n_held)
        y = terms[order[:, 0]]
        for j in range(1, k):
            y = y + terms[order[:, j]]
    reg = default_registry()
    reg.counter("moe.pairs_held").inc(n_held)
    reg.counter("moe.pairs_absent").inc(flat_e.numel() - n_held)
    return y
