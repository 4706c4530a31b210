"""Mixture-of-Experts FFN with sort-based capacity dispatch (port of the JAX
package's ``models/moe.py``).

Tokens are routed top-k by an f32 router, sorted by expert id (a stable
sort), and each expert takes at most ``cap`` of its tokens into a static
(E, cap, d) buffer; tokens over capacity are dropped. The experts run as
batched matrix products over that buffer, and each token sums its k expert
outputs, weighted by its renormalised gates.

The group step is split in two so that a check can hold the arithmetic
under a routing shared with another run: ``route`` (router, softmax, top-k,
gates) and ``dispatch_combine`` (sort, capacity, experts, combine), with
``dispatch_plan`` the integer bookkeeping between them.

Orders kept from the JAX package, since they decide which tokens drop and
the bf16 bits: top-k ties go to the lower expert id (``jax.lax.top_k``),
taken here as a stable descending sort cut to k, never ``torch.topk``; the
expert sort is stable (``jnp.argsort``); each token's k terms are summed in
the compute dtype in ascending expert id, the order of JAX's scatter-add
over the sorted entries. The combine gathers instead of scattering
(``index_add_`` on the card sums in an atomics order that changes from run
to run), so a card run is repeatable.

Under a traced call (``obs.trace.active_tracer()``, which a traced
``make_cohort_step`` sets) the dispatch and the combine are the
``moe_dispatch`` and ``moe_combine`` spans; the experts between them are in
neither.

``moe_share_ffn`` is the layered stack's MoE (``LayeredConfig``): the
router keeps all ``num_experts`` outputs, but the layer holds only experts
``[0, experts_held)`` (its share under expert parallelism) and computes
their part of the output; a token's choice of an absent expert adds
nothing here. Its gates are left as the softmax gives them (Jamba), and
it drops no pair: outside ``torch.func`` transforms it runs each held
expert on its segment of the pairs sorted by expert (``moe_segments.py``,
which reads the segments' bounds on the host, and so never runs under a
transform); under a transform (the cohort round's ``vmap(grad)``) it takes the
capacity dispatch here at T slots an expert (capacity factor E / k),
which cannot drop since no token picks an expert twice. Nothing in this
module reads on the host.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import moe_segments
from repro_torch.models.layers import Init, dense_init, dtype_of
from repro_torch.obs.trace import (
    SPAN_MOE_COMBINE,
    SPAN_MOE_DISPATCH,
    active_tracer,
)
from repro_torch.utils import fold

Params = Dict[str, object]


def init_moe(init: Init, cfg) -> Params:
    dtype = dtype_of(cfg.param_dtype)
    d, dff, e = cfg.d_model, cfg.resolved_moe_d_ff, cfg.num_experts
    e = getattr(cfg, "experts_held", 0) or e  # experts stored here
    p: Params = {
        "router": dense_init(init, d, cfg.num_experts, torch.float32,
                             scale=0.02),
        "w_gate": init.stacked_normal(e, (d, dff), d ** -0.5, dtype),  # (E, d, dff)
        "w_up": init.stacked_normal(e, (d, dff), d ** -0.5, dtype),
        "w_down": init.stacked_normal(e, (dff, d), dff ** -0.5, dtype),
    }
    if cfg.num_shared_experts:
        sd = dff * cfg.num_shared_experts
        p["shared"] = {
            "w_gate": dense_init(init, d, sd, dtype),
            "w_up": dense_init(init, d, sd, dtype),
            "w_down": dense_init(init, sd, d, dtype, scale=sd ** -0.5),
        }
    return p


def _expert_ffn(p: Params, x: torch.Tensor) -> torch.Tensor:
    """x: (E, C, d) -> (E, C, d) with per-expert SwiGLU weights."""
    h = F.silu(torch.bmm(x, p["w_gate"])) * torch.bmm(x, p["w_up"])
    return torch.bmm(h, p["w_down"])


def route(cfg, p: Params, xf: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """xf: (T, d). Returns (probs (T, E) f32, gate_vals (T, k) f32
    renormalised over the k, expert_ids (T, k) int64, largest first, ties
    to the lower id)."""
    probs = torch.softmax(xf.float() @ p["router"], dim=-1)
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.experts_per_token
    gate_vals, expert_ids = vals[:, :k], ids[:, :k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    return probs, gate_vals, expert_ids


class Plan(NamedTuple):
    """Where each (token, choice) goes. Entries are in the stable sort by
    expert id; ``order`` maps them back: entry ``order[t, j]`` is token t's
    choice of its j-th smallest expert id."""
    sort_idx: torch.Tensor   # (T*k,) flat (token, choice) of each entry
    token_idx: torch.Tensor  # (T*k,) its token
    keep: torch.Tensor       # (T*k,) bool: within its expert's capacity
    slot: torch.Tensor       # (T*k,) its row of the (E*cap, d) buffer
    order: torch.Tensor      # (T, k) entries of each token, ascending id


def dispatch_plan(cfg, expert_ids: torch.Tensor, cap: int) -> Plan:
    """The sort-based dispatch of one token group: entry i of the stable
    sort by expert id keeps slot ``pos_in_e`` of its expert while that is
    below ``cap``; later entries of a full expert are dropped."""
    e, k = cfg.num_experts, cfg.experts_per_token
    flat_e = expert_ids.reshape(-1)
    sort_idx = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[sort_idx]
    entries = torch.arange(flat_e.numel(), device=flat_e.device)
    # each expert's first entry (no host read, unlike bincount on the card)
    offsets = torch.searchsorted(sorted_e,
                                 torch.arange(e, device=flat_e.device))
    pos_in_e = entries - offsets[sorted_e]
    keep = pos_in_e < cap
    slot = sorted_e * cap + torch.where(keep, pos_in_e,
                                        torch.zeros_like(pos_in_e))
    at = torch.empty_like(sort_idx)
    at[sort_idx] = entries
    order = torch.sort(at.reshape(-1, k), dim=-1).values
    return Plan(sort_idx, sort_idx // k, keep, slot, order)


def dispatch_combine(cfg, p: Params, xf: torch.Tensor,
                     gate_vals: torch.Tensor, expert_ids: torch.Tensor,
                     cap: int) -> torch.Tensor:
    """Dispatch ``xf`` (T, d) under a given routing into the (E, cap, d)
    buffer, run the experts, and combine. Returns y (T, d) in xf's dtype."""
    e = cfg.num_experts
    tg, d = xf.shape
    tracer = active_tracer()
    with tracer.span(SPAN_MOE_DISPATCH, cat="moe"):
        plan = dispatch_plan(cfg, expert_ids, cap)
        # kept entries fill unique slots; dropped ones land in a spare last
        # row that is cut off (no host read to select the kept ones)
        dest = torch.where(plan.keep, plan.slot,
                           torch.full_like(plan.slot, e * cap))
        buf = xf.new_zeros((e * cap + 1, d))
        buf[dest] = xf[plan.token_idx]
    out_buf = _expert_ffn(p, buf[:-1].reshape(e, cap, d)).reshape(e * cap, d)
    with tracer.span(SPAN_MOE_COMBINE, cat="moe"):
        w = gate_vals.reshape(-1)[plan.sort_idx].to(out_buf.dtype)
        terms = out_buf[plan.slot] * plan.keep[:, None].to(out_buf.dtype) \
            * w[:, None]
        y = terms[plan.order[:, 0]]
        for j in range(1, plan.order.shape[1]):
            y = y + terms[plan.order[:, j]]
    return y


def capacity(cfg, tokens: int, capacity_factor: float) -> int:
    """Slots per expert for a group of ``tokens``."""
    k, e = cfg.experts_per_token, cfg.num_experts
    return int(max(1, (k * tokens / e) * capacity_factor))


def moe_ffn(cfg, p: Params, x: torch.Tensor, capacity_factor: float = None):
    """x: (B, S, d). Returns (y (B, S, d), aux_loss).

    Dispatch runs independently in ``cfg.moe_groups`` token groups, or in
    one group when the tokens do not split evenly. Decode (S == 1) is
    dropless: capacity factor at least E / k.
    """
    if capacity_factor is None:
        capacity_factor = cfg.moe_capacity_factor
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    t = b * s
    if s == 1:
        capacity_factor = max(capacity_factor, float(e) / max(k, 1))
    g = cfg.moe_groups if (cfg.moe_groups > 1 and t % cfg.moe_groups == 0) \
        else 1
    tg = t // g
    cap = capacity(cfg, tg, capacity_factor)
    ys, auxes = [], []
    for xf in x.reshape(g, tg, d):
        probs, gate_vals, expert_ids = route(cfg, p, xf)
        # load-balance aux (Switch): E * sum_e f_e * p_e; the one-hot is a
        # comparison (F.one_hot reads its input's maximum on the host,
        # which torch.func.vmap refuses)
        ce = (expert_ids[:, :1] == torch.arange(e, device=xf.device)
              ).float().mean(dim=0)
        auxes.append(e * torch.sum(probs.mean(dim=0) * ce)
                     * cfg.router_aux_coef)
        ys.append(dispatch_combine(cfg, p, xf, gate_vals, expert_ids, cap))
    y = torch.cat(ys).reshape(t, d)
    aux = torch.stack(auxes).mean()

    if cfg.num_shared_experts:  # always active
        y = y + shared_ffn(p, x.reshape(t, d))
    return y.reshape(b, s, d), aux


def shared_ffn(p: Params, xf: torch.Tensor) -> torch.Tensor:
    """The shared experts (one SwiGLU of width d_ff * num_shared) on every
    token of xf (T, d)."""
    sp = p["shared"]
    h = F.silu(xf @ sp["w_gate"]) * (xf @ sp["w_up"])
    return h @ sp["w_down"]


# ---------------------------------------------------------------------------
# the layered stack's MoE: a held share of the routed experts
# ---------------------------------------------------------------------------


def route_share(cfg, p: Params, xf: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``route`` over all ``num_experts`` (held or not), with the top-k
    gates as the softmax gives them (not renormalised over the k)."""
    probs = torch.softmax(xf.float() @ p["router"], dim=-1)
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.experts_per_token
    return probs, vals[:, :k], ids[:, :k]


def _capacity_share(cfg, p: Params, xf: torch.Tensor,
                    gate_vals: torch.Tensor, expert_ids: torch.Tensor,
                    cap: int, held: int) -> torch.Tensor:
    """``dispatch_combine`` over the held experts' buffer (held, cap, d):
    a pair of an absent expert is dropped like one over capacity."""
    d = xf.shape[1]
    tracer = active_tracer()
    with tracer.span(SPAN_MOE_DISPATCH, cat="moe"):
        plan = dispatch_plan(cfg, expert_ids, cap)
        # a kept pair's slot is expert * cap + its place: below held * cap
        # exactly when its expert is held
        keep = plan.keep & (plan.slot < held * cap)
        slot = torch.where(keep, plan.slot, torch.zeros_like(plan.slot))
        dest = torch.where(keep, plan.slot,
                           torch.full_like(plan.slot, held * cap))
        buf = xf.new_zeros((held * cap + 1, d))
        buf[dest] = xf[plan.token_idx]
    out_buf = _expert_ffn(p, buf[:-1].reshape(held, cap, d)).reshape(
        held * cap, d)
    with tracer.span(SPAN_MOE_COMBINE, cat="moe"):
        w = gate_vals.reshape(-1)[plan.sort_idx].to(out_buf.dtype)
        terms = out_buf[slot] * keep[:, None].to(out_buf.dtype) * w[:, None]
        y = terms[plan.order[:, 0]]
        for j in range(1, plan.order.shape[1]):
            y = y + terms[plan.order[:, j]]
    return y


def moe_share_ffn(cfg, p: Params, x: torch.Tensor):
    """x: (B, S, d). Returns (y (B, S, d), aux_loss): the held experts'
    part of the MoE output, in one token group. The load-balance aux is
    ``moe_ffn``'s over all ``num_experts``."""
    b, s, d = x.shape
    e, t = cfg.num_experts, b * s
    held = cfg.resolved_experts_held
    xf = x.reshape(t, d)
    probs, gate_vals, expert_ids = route_share(cfg, p, xf)
    ce = (expert_ids[:, :1] == torch.arange(e, device=xf.device)
          ).float().mean(dim=0)
    aux = e * torch.sum(probs.mean(dim=0) * ce) * cfg.router_aux_coef
    if fold.level() is None:
        y = moe_segments.dropless_share(cfg, p, xf, gate_vals, expert_ids,
                                        held)
    else:
        # dropless under a transform: capacity T, factor E / k (no expert
        # gets a token twice)
        y = _capacity_share(cfg, p, xf, gate_vals, expert_ids, t, held)
    return y.reshape(b, s, d), aux
