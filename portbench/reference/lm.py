"""The plain reference of the benchmark's language models, in PyTorch.

It imports nothing of the program. It reads the parameter tree that the
benchmark made (``harness/weights.py``: layers stacked on a leading axis,
dense weights ``(d_in, d_out)``) and the configuration file's sizes, and
computes in float32 (``numerics.Numerics``) from the published equations:

* Hymba (arXiv:2411.13676), as the configuration file states it: every
  layer runs attention (GQA, RoPE on the two halves of each head, a
  sliding window) and a Mamba-1 SSM in parallel on the same normed input;
  their outputs are RMS-normed and averaged, then a SwiGLU MLP.
* DeepSeekMoE (arXiv:2401.06066): causal attention, then 64 routed
  experts (softmax router, top 6, gates renormalised, capacity
  ``int(k T / E * cf)`` a group, dispatched in a stable sort by expert)
  beside 2 shared experts; the Switch load-balance loss.

RMSNorm scales by ``1 + w`` (eps 1e-6). Attention runs in query blocks
against the keys the window and causality admit; the SSM scan runs in
chunks of ``SCAN_CHUNK`` steps, each chunk's recurrence in closed form
from its cumulative log decay, the chunks chained one after another.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.reference.numerics import Numerics

SCAN_CHUNK = 32
QUERY_BLOCK = 1024
NORM_EPS = 1e-6


def rms(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    x = x.float()
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + NORM_EPS) \
        * (1.0 + w.float())


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, D): rotate the two halves of each head by position."""
    s, d = x.shape[1], x.shape[-1]
    half = d // 2
    freqs = 1.0 / theta ** (torch.arange(half, dtype=torch.float32,
                                         device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(cfg: Dict, p: Dict, h: torch.Tensor, num: Numerics
              ) -> torch.Tensor:
    b, s, _ = h.shape
    hq, hkv = cfg["num_heads"], cfg["num_kv_heads"]
    hd = cfg.get("head_dim") or cfg["d_model"] // hq
    window = cfg.get("attn_window") or 0
    q = num.mm(h, p["wq"]).reshape(b, s, hq, hd)
    k = num.mm(h, p["wk"]).reshape(b, s, hkv, hd)
    v = num.mm(h, p["wv"]).reshape(b, s, hkv, hd)
    q, k = rope(q, cfg["rope_theta"]), rope(k, cfg["rope_theta"])
    rep = hq // hkv  # query head i reads kv head i // rep
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    scale = hd ** -0.5
    outs = []
    for q0 in range(0, s, QUERY_BLOCK):
        q1 = min(s, q0 + QUERY_BLOCK)
        k0 = max(0, q0 - window + 1) if window else 0
        qb = num.operand(q[:, q0:q1]) * scale
        sc = torch.einsum("bqhd,bkhd->bhqk", qb, num.operand(k[:, k0:q1]))
        qpos = torch.arange(q0, q1, device=h.device)[:, None]
        kpos = torch.arange(k0, q1, device=h.device)[None, :]
        ok = kpos <= qpos
        if window:
            ok = ok & (kpos > qpos - window)
        sc = sc.masked_fill(~ok, float("-inf"))
        pr = torch.softmax(sc, dim=-1)
        outs.append(torch.einsum("bhqk,bkhd->bqhd", num.operand(pr),
                                 num.operand(v[:, k0:q1])))
    o = torch.cat(outs, dim=1).reshape(b, s, hq * hd)
    return num.mm(o, p["wo"])


def softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.log1p(torch.exp(-x.abs())) + torch.relu(x)


def sequential_scan(x, dt, bm, cm, a, h0):
    """The recurrence step by step (the fallback of ``selective_scan``)."""
    ys = []
    for t in range(x.shape[1]):
        h0 = torch.exp(dt[:, t, :, None] * a) * h0 \
            + (dt[:, t] * x[:, t])[..., None] * bm[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h0, cm[:, t]))
    return torch.stack(ys, dim=1), h0


def selective_scan(x, dt, bm, cm, a):
    """y_t = C_t . h_t, h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t.
    x, dt (B, S, di); bm, cm (B, S, N); a (di, N). Chunked: inside a chunk
    h_t = e^{L_t} h_0 + e^{L_t - L_m} sum_{s<=t} e^{L_m - L_s} u_s, L the
    cumulative log decay from the chunk's start and L_m its value at the
    chunk's middle, the factors in float64 (each spans half a chunk's
    decay); the chunks are chained one after another. A pass whose
    output is not finite is run again step by step."""
    bsz, s, di = x.shape
    n = a.shape[-1]
    t = min(SCAN_CHUNK, s)
    if s % t:
        raise ValueError(f"sequence {s} is not a multiple of {t}")
    h0 = x.new_zeros((bsz, di, n))
    ys = []
    group = max(1, (1 << 26) // max(1, bsz * t * di * n)) * t  # steps a pass
    for g0 in range(0, s, group):
        g1 = min(s, g0 + group)
        c = (g1 - g0) // t
        dtg = dt[:, g0:g1].reshape(bsz, c, t, di)
        la = torch.cumsum(dtg[..., None].double() * a.double(), dim=2)
        mid = la[:, :, t // 2 - 1:t // 2]
        u = (dtg * x[:, g0:g1].reshape(bsz, c, t, di))[..., None] \
            * bm[:, g0:g1].reshape(bsz, c, t, 1, n)
        part = (torch.exp(la - mid)
                * torch.cumsum(torch.exp(mid - la) * u.double(), dim=2)
                ).float()
        decay = torch.exp(la).float()
        # chain the chunks: the state entering each chunk
        starts, h_in = [], h0
        for j in range(c):
            starts.append(h0)
            h0 = part[:, j, -1] + decay[:, j, -1] * h0
        hs = part + decay * torch.stack(starts, dim=1)[:, :, None]
        cg = cm[:, g0:g1].reshape(bsz, c, t, 1, n)
        y = (hs * cg).sum(-1).reshape(bsz, g1 - g0, di)
        if not bool(torch.isfinite(y).all()):
            y, h0 = sequential_scan(x[:, g0:g1], dt[:, g0:g1], bm[:, g0:g1],
                                    cm[:, g0:g1], a, h_in)
        ys.append(y)
    return torch.cat(ys, dim=1)


def ssm(cfg: Dict, p: Dict, h: torch.Tensor, num: Numerics) -> torch.Tensor:
    n = cfg["ssm_state"]
    di = cfg.get("ssm_expand", 2) * cfg["d_model"]
    dtr = cfg.get("ssm_dt_rank") or -(-cfg["d_model"] // 16)
    xz = num.mm(h, p["in_proj"])
    x, z = xz[..., :di], xz[..., di:]
    w = p["conv_w"].float()  # (K, di): out_t = sum_i x_{t-K+1+i} w_i
    kk = w.shape[0]
    xp = F.pad(x, (0, 0, kk - 1, 0))
    x = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(kk)) \
        + p["conv_b"].float()
    x = F.silu(x)
    dbc = num.mm(x, p["x_proj"])
    dt, bm, cm = dbc[..., :dtr], dbc[..., dtr:dtr + n], dbc[..., dtr + n:]
    dt = softplus(num.mm(dt, p["dt_proj"]) + p["dt_bias"].float())
    a = -torch.exp(p["A_log"].float())
    y = selective_scan(x, dt, bm, cm, a) + x * p["D"].float()
    y = y * F.silu(z)
    return num.mm(y, p["out_proj"])


def swiglu(p: Dict, h: torch.Tensor, num: Numerics) -> torch.Tensor:
    return num.mm(F.silu(num.mm(h, p["w_gate"])) * num.mm(h, p["w_up"]),
                  p["w_down"])


def moe(cfg: Dict, p: Dict, h: torch.Tensor, num: Numerics
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The routed and shared experts on h (B, S, d): (y, aux)."""
    b, s, d = h.shape
    e, k = cfg["num_experts"], cfg["experts_per_token"]
    xf = h.reshape(b * s, d)
    tk = xf.shape[0]
    probs = torch.softmax(num.mm(xf, p["router"]), dim=-1)
    # top k, ties to the lower expert id
    ids = torch.sort(probs.detach(), dim=-1, descending=True,
                     stable=True).indices[:, :k]
    gates = probs.gather(1, ids)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    cap = int(max(1, (k * tk / e) * cfg["moe_capacity_factor"]))
    flat = ids.reshape(-1)
    order = torch.argsort(flat, stable=True)
    sorted_e = flat[order]
    first = torch.searchsorted(sorted_e, torch.arange(e, device=h.device))
    pos = torch.arange(flat.numel(), device=h.device) - first[sorted_e]
    kept = torch.zeros_like(flat, dtype=torch.bool)
    kept[order] = pos < cap
    y = torch.zeros_like(xf, dtype=torch.float32)
    tok = torch.arange(tk, device=h.device).repeat_interleave(k)
    g = gates.reshape(-1)
    for j in range(e):
        sel = ((flat == j) & kept).nonzero(as_tuple=True)[0]
        if sel.numel() == 0:
            continue
        xe = xf[tok[sel]]
        pe = {"w_gate": p["w_gate"][j], "w_up": p["w_up"][j],
              "w_down": p["w_down"][j]}
        y = y.index_add(0, tok[sel], swiglu(pe, xe, num) * g[sel, None])
    top1 = (ids[:, :1] == torch.arange(e, device=h.device)).float().mean(0)
    aux = e * torch.sum(probs.mean(0) * top1) * cfg["router_aux_coef"]
    if cfg.get("num_shared_experts"):
        y = y + swiglu(p["shared"], xf, num)
    return y.reshape(b, s, d), aux


def layer(cfg: Dict, p: Dict, x: torch.Tensor, num: Numerics
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    h = rms(x, p["norm1"]["w"])
    if cfg.get("parallel_ssm_attn"):
        a = attention(cfg, p["attn"], h, num)
        s = ssm(cfg, p["ssm"], h, num)
        x = x + 0.5 * (rms(a, p["fuse_norm_a"]["w"])
                       + rms(s, p["fuse_norm_s"]["w"]))
    else:
        x = x + attention(cfg, p["attn"], h, num)
    h = rms(x, p["norm2"]["w"])
    if cfg.get("num_experts"):
        y, aux = moe(cfg, p["moe"], h, num)
    else:
        y, aux = swiglu(p["mlp"], h, num), x.new_zeros(())
    return x + y, aux


def layer_params(stacked: Any, i: int) -> Any:
    if isinstance(stacked, dict):
        return {k: layer_params(v, i) for k, v in stacked.items()}
    return stacked[i]


def num_layers(params: Dict) -> int:
    t = params["layers"]
    while isinstance(t, dict):
        t = next(iter(t.values()))
    return t.shape[0]


def hidden(cfg: Dict, params: Dict, tokens: torch.Tensor, num: Numerics,
           remat: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """The final-normed hidden states (B, S, d) and the summed aux loss."""
    x = params["embed"][tokens.long()].float()
    aux = x.new_zeros(())
    for i in range(num_layers(params)):
        p = layer_params(params["layers"], i)
        if remat:
            x, la = checkpoint(lambda xx, pp: layer(cfg, pp, xx, num), x, p,
                               use_reentrant=False)
        else:
            x, la = layer(cfg, p, x, num)
        aux = aux + la
    return rms(x, params["final_norm"]["w"]), aux


def loss(cfg: Dict, params: Dict, batch: Dict, num: Numerics,
         remat: bool = False) -> torch.Tensor:
    """Mean next-token cross-entropy over every token, plus the MoE aux."""
    x, aux = hidden(cfg, params, batch["tokens"], num, remat=remat)
    logits = num.mm(x, params["lm_head"])
    ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                         batch["labels"].reshape(-1).long())
    return ce + aux


def last_logits(cfg: Dict, params: Dict, tokens: torch.Tensor,
                num: Numerics) -> torch.Tensor:
    """The logits of each sequence's last position (B, V)."""
    x, _ = hidden(cfg, params, tokens, num)
    return num.mm(x[:, -1], params["lm_head"])


def fp32_copy(tree: Any, requires_grad: bool = False) -> Any:
    if isinstance(tree, dict):
        return {k: fp32_copy(v, requires_grad) for k, v in tree.items()}
    t = tree.detach().float()
    return t.requires_grad_(requires_grad) if requires_grad else t

