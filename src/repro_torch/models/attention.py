"""Attention (port of the JAX package's ``models/attention.py``): GQA,
qk-norm, optional bias, RoPE; causal / sliding-window self-attention over a
full sequence through kernel K5; single-token decode against a full or ring
KV cache; cross-attention (encoder-decoder) over a full sequence and, in
decode, against the encoder's precomputed K/V.

Causal self-attention, windowed or not, goes through
``kernels/flash_attn/ops.py::flash_attention``: the K5 CUDA kernel for CUDA
tensors, its plain version for CPU tensors. That one function stands in
for the JAX package's full, sliding-window and chunked jnp paths (its XLA
fallbacks of the same kernel). Non-causal attention stays plain
(``_full_attention``: the encoder and cross-attention), as the JAX
package's kernel branch also requires ``causal``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels.flash_attn import ops as flash_ops
from repro_torch.kernels.flash_attn.ref import NEG_INF, band_mask, repeat_kv
from repro_torch.models.layers import Init, apply_rope, dense_init, dtype_of, rms_norm

Params = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------


def init_attention(init: Init, cfg, cross: bool = False) -> Params:
    """Projections of one attention block; a cross-attention block
    (``cross``) has the same leaves."""
    dtype = dtype_of(cfg.param_dtype)
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    p = {
        "wq": dense_init(init, d, cfg.num_heads * hd, dtype),
        "wk": dense_init(init, d, cfg.num_kv_heads * hd, dtype),
        "wv": dense_init(init, d, cfg.num_kv_heads * hd, dtype),
        "wo": dense_init(init, cfg.num_heads * hd, d, dtype,
                         scale=(cfg.num_heads * hd) ** -0.5),
    }
    if cfg.qkv_bias:
        p["bq"] = init.full((cfg.num_heads * hd,), 0.0, dtype)
        p["bk"] = init.full((cfg.num_kv_heads * hd,), 0.0, dtype)
        p["bv"] = init.full((cfg.num_kv_heads * hd,), 0.0, dtype)
    if cfg.qk_norm:
        p["q_norm"] = init.full((hd,), 0.0, torch.float32)
        p["k_norm"] = init.full((hd,), 0.0, torch.float32)
    return p


def _project_q(cfg, p: Params, x: torch.Tensor) -> torch.Tensor:
    hd = cfg.resolved_head_dim
    q = x @ p["wq"]
    if cfg.qkv_bias:
        q = q + p["bq"]
    q = q.reshape(x.shape[:-1] + (cfg.num_heads, hd))
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
    return q


def _project_kv(cfg, p: Params, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    hd = cfg.resolved_head_dim
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        k = k + p["bk"]
        v = v + p["bv"]
    k = k.reshape(x.shape[:-1] + (cfg.num_kv_heads, hd))
    v = v.reshape(x.shape[:-1] + (cfg.num_kv_heads, hd))
    if cfg.qk_norm:
        k = rms_norm(k, p["k_norm"])
    return k, v


# ---------------------------------------------------------------------------
# core attention maths
# ---------------------------------------------------------------------------


def _full_attention(q, k, v, causal: bool, window: int = 0) -> torch.Tensor:
    """Materialised-scores attention. q: (B,Sq,H,D), k, v: (B,Sk,H,D); the
    probabilities are cast to v's dtype before P.V, as in the JAX package."""
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k.float())
    if causal:
        mask = band_mask(q.shape[1], k.shape[1], True, window, q.device)
        scores = torch.where(mask, scores,
                             torch.full((), NEG_INF, device=q.device))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


def attention_train(cfg, p: Params, x: torch.Tensor,
                    kv_x: Optional[torch.Tensor] = None, causal: bool = True,
                    positions: Optional[torch.Tensor] = None,
                    window: Optional[int] = None) -> torch.Tensor:
    """Self (or cross, via kv_x) attention over a full sequence."""
    b, s, _ = x.shape
    q = _project_q(cfg, p, x)
    k, v = _project_kv(cfg, p, kv_x if kv_x is not None else x)
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    if cfg.rope_theta and kv_x is None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    window = window if window is not None else cfg.attn_window
    if causal and kv_x is None:
        out = flash_ops.flash_attention(q, k, v, causal=True,
                                        window=window or 0)
    else:
        n_rep = cfg.num_heads // cfg.num_kv_heads
        out = _full_attention(q, repeat_kv(k, n_rep), repeat_kv(v, n_rep),
                              causal=causal, window=window or 0)
    return out.reshape(b, s, -1) @ p["wo"]


# ---------------------------------------------------------------------------
# decode (single new token against a KV cache)
# ---------------------------------------------------------------------------


def init_kv_cache(cfg, batch: int, cache_len: int, dtype: torch.dtype,
                  device: torch.device) -> Params:
    """Full cache, or ring cache of size ``attn_window`` when SWA."""
    hd = cfg.resolved_head_dim
    length = min(cache_len, cfg.attn_window) if cfg.attn_window else cache_len
    shape = (batch, length, cfg.num_kv_heads, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attention_decode(cfg, p: Params, x: torch.Tensor, cache: Params,
                     pos: int) -> torch.Tensor:
    """x: (B, 1, d); pos: the current position. Returns y (B, 1, d).

    Writes the new K/V into ``cache`` in place (the JAX package returns a
    new cache): a full cache at index ``pos``, a ring (SWA) cache at
    ``pos % length``, masking its slots by recency.
    """
    b = x.shape[0]
    q = _project_q(cfg, p, x)  # (B,1,H,Dh)
    k_new, v_new = _project_kv(cfg, p, x)  # (B,1,Hkv,Dh)
    if cfg.rope_theta:
        pp = torch.full((b, 1), pos, device=x.device)
        q = apply_rope(q, pp, cfg.rope_theta)
        k_new = apply_rope(k_new, pp, cfg.rope_theta)
    length = cache["k"].shape[1]
    write_idx = (pos % length) if cfg.attn_window else pos
    cache["k"][:, write_idx] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][:, write_idx] = v_new[:, 0].to(cache["v"].dtype)
    n_rep = cfg.num_heads // cfg.num_kv_heads
    kk = repeat_kv(cache["k"], n_rep)
    vv = repeat_kv(cache["v"], n_rep)
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale,
                          kk.float())  # (B,H,1,L)
    slot = torch.arange(length, device=x.device)
    if cfg.attn_window:
        # slots hold positions pos-window+1..pos (mod window) once warm;
        # torch.remainder is floor mod, like jnp's %
        valid = min(pos + 1, length) > torch.remainder(write_idx - slot,
                                                       length)
    else:
        valid = slot <= pos
    scores = torch.where(valid[None, None, None, :], scores,
                         torch.full((), NEG_INF, device=x.device))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(vv.dtype), vv)
    return out.reshape(b, 1, -1) @ p["wo"]


def cross_attention_decode(cfg, p: Params, x: torch.Tensor,
                           enc_kv: Params) -> torch.Tensor:
    """Decoder cross-attention of x (B, S, d) against the encoder's
    precomputed K/V (``precompute_cross_kv``), every frame visible."""
    b = x.shape[0]
    q = _project_q(cfg, p, x)
    n_rep = cfg.num_heads // cfg.num_kv_heads
    out = _full_attention(q, repeat_kv(enc_kv["k"], n_rep),
                          repeat_kv(enc_kv["v"], n_rep), causal=False)
    return out.reshape(b, x.shape[1], -1) @ p["wo"]


def precompute_cross_kv(cfg, p: Params, enc_out: torch.Tensor) -> Params:
    k, v = _project_kv(cfg, p, enc_out)
    return {"k": k, "v": v}
