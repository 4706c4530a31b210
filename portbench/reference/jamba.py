"""The plain reference of Jamba (arXiv:2403.19887, arXiv:2408.12570;
transformers' ``JambaForCausalLM``), in PyTorch.

It imports nothing of the program. It reads the parameter tree that the
benchmark made (``harness/weights.py``; dense weights ``(d_in, d_out)``):
under ``layers``, ``norm1`` and ``norm2`` stacked over every layer, and
``ssm``, ``attn``, ``mlp`` and ``moe`` each stacked over the layers of
that kind, in layer order. The configuration file's keys are transformers'
``JambaConfig`` names. It computes in float32 (``numerics.Numerics``):

* layer i is attention where ``i % attn_layer_period ==
  attn_layer_offset``, else Mamba-1; its FFN is the MoE where ``i %
  expert_layer_period == expert_layer_offset``, else a SwiGLU MLP
  (``JambaConfig.layers_block_type`` / ``layers_num_experts``). Each half
  is pre-normed (RMSNorm, ``1 + w``, eps 1e-6) with a residual.
* attention: causal GQA with no positional encoding at all, in blocks of
  ``QUERY_BLOCK`` queries against every earlier key.
* Mamba-1: in-projection, depthwise causal conv with bias, SiLU,
  ``x_proj``, RMSNorms on dt, B and C, ``dt_proj`` with its bias,
  softplus, the selective scan (``lm.selective_scan``), the skip ``D``,
  the SiLU gate, out-projection.
* MoE: a softmax router over all ``num_experts``, the top
  ``num_experts_per_tok`` (ties to the lower id) with their gates as the
  softmax gives them (not renormalised). This device holds experts ``[0,
  experts_held)``: each runs on every pair routed to it (nothing dropped),
  and a pair of an absent expert adds nothing. The load-balance aux is the
  Switch loss over each token's first choice, times
  ``router_aux_loss_coef``.

``last_logits`` runs each sequence of a batch alone (nothing couples them
once no pair is dropped; it halves the transients); ``loss`` runs the
batch as one token group, as the program's router aux sees it.

Given ``routes`` (the expert ids another side chose, per MoE layer), the
MoE runs those choices, with the gates this router gives them, and
``flips`` records per MoE layer the share of tokens whose set of choices
differs from this router's own top-k on the same input: a check of the
other side's numerics that a near-tie decided otherwise does not tip,
beside a check of its routing.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from portbench.reference.lm import layer_params, rms, selective_scan, \
    softplus, swiglu
from portbench.reference.numerics import Numerics

QUERY_BLOCK = 256


def kinds(cfg: Dict, i: int) -> Tuple[str, str]:
    """(mixer, FFN) of layer i: ("attn" | "ssm", "moe" | "mlp")."""
    attn = i % cfg["attn_layer_period"] == cfg["attn_layer_offset"]
    moe = i % cfg["expert_layer_period"] == cfg["expert_layer_offset"]
    return ("attn" if attn else "ssm"), ("moe" if moe else "mlp")


def attention(cfg: Dict, p: Dict, h: torch.Tensor, num: Numerics
              ) -> torch.Tensor:
    b, s, _ = h.shape
    hq, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg["hidden_size"] // hq
    rep = hq // hkv  # query head g * rep + r reads kv head g
    q = num.mm(h, p["wq"]).reshape(b, s, hkv, rep, hd)
    k = num.mm(h, p["wk"]).reshape(b, s, hkv, hd)
    v = num.mm(h, p["wv"]).reshape(b, s, hkv, hd)
    scale = hd ** -0.5
    outs = []
    for q0 in range(0, s, QUERY_BLOCK):
        q1 = min(s, q0 + QUERY_BLOCK)
        qb = num.operand(q[:, q0:q1]) * scale
        sc = torch.einsum("bqgrd,bkgd->bgrqk", qb, num.operand(k[:, :q1]))
        qpos = torch.arange(q0, q1, device=h.device)[:, None]
        kpos = torch.arange(0, q1, device=h.device)[None, :]
        sc = sc.masked_fill(kpos > qpos, float("-inf"))
        pr = torch.softmax(sc, dim=-1)
        del sc
        outs.append(torch.einsum("bgrqk,bkgd->bqgrd", num.operand(pr),
                                 num.operand(v[:, :q1])))
    o = torch.cat(outs, dim=1).reshape(b, s, hq * hd)
    return num.mm(o, p["wo"])


def ssm(cfg: Dict, p: Dict, h: torch.Tensor, num: Numerics) -> torch.Tensor:
    n = cfg["mamba_d_state"]
    di = cfg["mamba_expand"] * cfg["hidden_size"]
    dtr = cfg["mamba_dt_rank"]
    xz = num.mm(h, p["in_proj"])
    x, z = xz[..., :di], xz[..., di:]
    w = p["conv_w"].float()  # (K, di): out_t = sum_i x_{t-K+1+i} w_i
    kk = w.shape[0]
    xp = F.pad(x, (0, 0, kk - 1, 0))
    x = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(kk)) \
        + p["conv_b"].float()
    del xp, xz
    x = F.silu(x)
    dbc = num.mm(x, p["x_proj"])
    dt = rms(dbc[..., :dtr], p["dt_norm"]["w"])
    bm = rms(dbc[..., dtr:dtr + n], p["b_norm"]["w"])
    cm = rms(dbc[..., dtr + n:], p["c_norm"]["w"])
    dt = softplus(num.mm(dt, p["dt_proj"]) + p["dt_bias"].float())
    a = -torch.exp(p["A_log"].float())
    y = selective_scan(x, dt, bm, cm, a) + x * p["D"].float()
    y = y * F.silu(z)
    return num.mm(y, p["out_proj"])


def route(cfg: Dict, p: Dict, xf: torch.Tensor, num: Numerics
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(router probabilities (T, E), the top-k expert ids (T, k))."""
    probs = torch.softmax(num.mm(xf, p["router"]), dim=-1)
    ids = torch.sort(probs.detach(), dim=-1, descending=True,
                     stable=True).indices[:, :cfg["num_experts_per_tok"]]
    return probs, ids


def flip_share(own: torch.Tensor, other: torch.Tensor) -> float:
    """The share of rows whose set of ids differs between (T, k) id
    tables."""
    same = (own[:, :, None] == other[:, None, :]).any(-1).all(-1)
    return 1.0 - float(same.float().mean())


def moe(cfg: Dict, p: Dict, h: torch.Tensor, num: Numerics,
        ids: torch.Tensor = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The held experts' part of the MoE on h (B, S, d): (y, aux); with
    ``ids`` (B * S, k), those experts in place of this router's top-k."""
    b, s, d = h.shape
    e = cfg["num_experts"]
    held = cfg.get("experts_held") or e
    xf = h.reshape(b * s, d)
    probs, own = route(cfg, p, xf, num)
    ids = own if ids is None else ids.to(own.device)
    gates = probs.gather(1, ids)
    y = torch.zeros_like(xf, dtype=torch.float32)
    for j in range(held):
        rows, cols = (ids == j).nonzero(as_tuple=True)
        if rows.numel() == 0:
            continue
        pe = {"w_gate": p["w_gate"][j], "w_up": p["w_up"][j],
              "w_down": p["w_down"][j]}
        y = y.index_add(0, rows, swiglu(pe, xf[rows], num)
                        * gates[rows, cols, None])
    top1 = (ids[:, :1] == torch.arange(e, device=h.device)).float().mean(0)
    aux = e * torch.sum(probs.mean(0) * top1) * cfg["router_aux_loss_coef"]
    return y.reshape(b, s, d), aux


def hidden(cfg: Dict, params: Dict, tokens: torch.Tensor, num: Numerics,
           routes=None, flips=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The final-normed hidden states (B, S, d) and the summed aux loss;
    ``routes``: expert ids (B * S, k) per MoE layer to run instead of this
    router's, with each layer's flip share appended to ``flips``."""
    x = params["embed"][tokens.long()].float()
    aux = x.new_zeros(())
    seen = {"attn": 0, "ssm": 0, "mlp": 0, "moe": 0}
    stacked = params["layers"]
    for i in range(cfg["num_hidden_layers"]):
        mixer, ffn = kinds(cfg, i)
        pm = layer_params(stacked[mixer], seen[mixer])
        pf = layer_params(stacked[ffn], seen[ffn])
        seen[mixer] += 1
        seen[ffn] += 1
        h = rms(x, stacked["norm1"]["w"][i])
        x = x + (attention if mixer == "attn" else ssm)(cfg, pm, h, num)
        h = rms(x, stacked["norm2"]["w"][i])
        if ffn == "moe":
            ids = None
            if routes is not None:
                ids = routes[seen["moe"] - 1]
                _, own = route(cfg, pf, h.reshape(-1, h.shape[-1]), num)
                flips.append(flip_share(own, ids.to(own.device)))
            y, la = moe(cfg, pf, h, num, ids=ids)
            aux = aux + la
        else:
            y = swiglu(pf, h, num)
        x = x + y
    return rms(x, params["final_norm"]["w"]), aux


def loss(cfg: Dict, params: Dict, batch: Dict, num: Numerics
         ) -> torch.Tensor:
    """Mean next-token cross-entropy over every token, plus the MoE aux."""
    x, aux = hidden(cfg, params, batch["tokens"], num)
    logits = num.mm(x, params["lm_head"])
    ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                         batch["labels"].reshape(-1).long())
    return ce + aux


def last_logits(cfg: Dict, params: Dict, tokens: torch.Tensor,
                num: Numerics, routes=None, flips=None) -> torch.Tensor:
    """The logits of each sequence's last position (B, V), a sequence at a
    time; ``routes`` (per MoE layer, ids (B * S, k) of the whole batch) and
    ``flips`` as ``hidden``'s."""
    rows = []
    s = tokens.shape[1]
    for i in range(tokens.shape[0]):
        mine = None if routes is None else [r[i * s:(i + 1) * s]
                                            for r in routes]
        x, _ = hidden(cfg, params, tokens[i:i + 1], num, mine, flips)
        rows.append(num.mm(x[:, -1], params["lm_head"]))
        del x
    return torch.cat(rows)
