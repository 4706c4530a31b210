"""Decoder blocks and the layer stack (port of the JAX package's
``models/blocks.py``).

Layer parameters are stacked on a leading layer axis, as the JAX package's
``init_stack`` makes them (``jax.vmap`` over layer keys), so weights carry
across unchanged; the stack runs as a Python loop over that axis, layer
``i`` reading views ``leaf[i]``. The decode caches carry the same leading
layer axis and are updated in place, where the JAX package's ``lax.scan``
returns new ones.

Ported families: dense, hybrid (attention and SSM in parallel, Hymba) and
SSM-only. The MoE FFN, the encoder and the cross-attention branches raise
``NotImplementedError`` naming ROADMAP Slice F.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.models import attention as attn
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import Init, apply_mlp, apply_norm, init_mlp, make_norm_params

Params = Dict[str, Any]

_NOT_PORTED = ("is not ported yet (ROADMAP Slice F: moe.py, the encoder, "
               "cross-attention and patch branches)")


def check_ported(cfg) -> None:
    """Raise for a config that needs a branch the port does not have."""
    if cfg.is_moe:
        raise NotImplementedError(f"the MoE FFN of {cfg.name} {_NOT_PORTED}")
    if cfg.is_encdec:
        raise NotImplementedError(
            f"the encoder-decoder stack of {cfg.name} {_NOT_PORTED}")
    if cfg.num_patches:
        raise NotImplementedError(f"the VLM patches of {cfg.name} {_NOT_PORTED}")


def layer_view(stacked: Params, i: int) -> Params:
    """Layer ``i``'s parameters (or cache) as views into the stacked leaves."""
    if isinstance(stacked, dict):
        return {k: layer_view(v, i) for k, v in stacked.items()}
    return stacked[i]


def num_stacked(stacked: Params) -> int:
    """Length of the leading layer axis."""
    while isinstance(stacked, dict):
        stacked = next(iter(stacked.values()))
    return stacked.shape[0]


def _stack(trees: list) -> Params:
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


# ---------------------------------------------------------------------------
# per-layer init
# ---------------------------------------------------------------------------


def init_layer(init: Init, cfg) -> Params:
    """One decoder layer's params for the cfg's family."""
    check_ported(cfg)
    p: Params = {"norm1": make_norm_params(cfg, cfg.d_model, init)}
    if cfg.is_ssm_only:
        p["ssm"] = ssm_mod.init_ssm(init, cfg)
        return p
    p["attn"] = attn.init_attention(init, cfg)
    if cfg.is_hybrid:
        p["ssm"] = ssm_mod.init_ssm(init, cfg)
        p["fuse_norm_a"] = make_norm_params(cfg, cfg.d_model, init)
        p["fuse_norm_s"] = make_norm_params(cfg, cfg.d_model, init)
    p["norm2"] = make_norm_params(cfg, cfg.d_model, init)
    p["mlp"] = init_mlp(init, cfg)
    return p


def init_stack(init: Init, cfg, num_layers: int) -> Params:
    """Layer params stacked on a leading axis of ``num_layers``."""
    return _stack([init_layer(init, cfg) for _ in range(num_layers)])


# ---------------------------------------------------------------------------
# full-sequence (train / prefill) block application
# ---------------------------------------------------------------------------


def _mixer_train(cfg, p: Params, x: torch.Tensor,
                 window: Optional[int]) -> torch.Tensor:
    """Token mixer (attn / ssm / hybrid) with pre-norm + residual."""
    h = apply_norm(cfg, p["norm1"], x)
    if cfg.is_ssm_only:
        return x + ssm_mod.ssm_train(cfg, p["ssm"], h)
    if cfg.is_hybrid:
        a = attn.attention_train(cfg, p["attn"], h, window=window)
        s = ssm_mod.ssm_train(cfg, p["ssm"], h)
        fused = 0.5 * (apply_norm(cfg, p["fuse_norm_a"], a) +
                       apply_norm(cfg, p["fuse_norm_s"], s))
        return x + fused
    return x + attn.attention_train(cfg, p["attn"], h, window=window)


def _ffn_train(cfg, p: Params, x: torch.Tensor):
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.is_ssm_only:
        return x, zero  # mamba block subsumes the MLP
    h = apply_norm(cfg, p["norm2"], x)
    return x + apply_mlp(cfg, p["mlp"], h), zero


def decoder_layer_train(cfg, p: Params, x: torch.Tensor,
                        window: Optional[int] = None):
    """Returns (x, aux_loss)."""
    x = _mixer_train(cfg, p, x, window)
    return _ffn_train(cfg, p, x)


def run_stack_train(cfg, stacked: Params, x: torch.Tensor,
                    window: Optional[int] = None):
    """Run the layer stack in order. Returns (x, total_aux)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(num_stacked(stacked)):
        x, a = decoder_layer_train(cfg, layer_view(stacked, i), x,
                                   window=window)
        aux = aux + a
    return x, aux


# ---------------------------------------------------------------------------
# decode (single token) block application
# ---------------------------------------------------------------------------


def init_layer_cache(cfg, batch: int, cache_len: int, dtype: torch.dtype,
                     device: torch.device) -> Params:
    c: Params = {}
    if not cfg.is_ssm_only:
        c["kv"] = attn.init_kv_cache(cfg, batch, cache_len, dtype, device)
    if cfg.is_ssm_only or cfg.is_hybrid:
        c["ssm"] = ssm_mod.init_ssm_cache(cfg, batch, dtype, device)
    return c


def init_stack_cache(cfg, num_layers: int, batch: int, cache_len: int,
                     dtype: torch.dtype, device: torch.device) -> Params:
    """Layer-stacked cache (leading axis L), zeros."""
    one = init_layer_cache(cfg, batch, cache_len, dtype, device)

    def stack(t):
        if isinstance(t, dict):
            return {k: stack(v) for k, v in t.items()}
        return t.new_zeros((num_layers,) + tuple(t.shape))

    return stack(one)


def decoder_layer_decode(cfg, p: Params, x: torch.Tensor, cache: Params,
                         pos: int) -> torch.Tensor:
    """x: (B,1,d). Returns x; updates the layer's ``cache`` in place."""
    h = apply_norm(cfg, p["norm1"], x)
    if cfg.is_ssm_only:
        return x + ssm_mod.ssm_decode(cfg, p["ssm"], h, cache["ssm"])
    if cfg.is_hybrid:
        a = attn.attention_decode(cfg, p["attn"], h, cache["kv"], pos)
        s = ssm_mod.ssm_decode(cfg, p["ssm"], h, cache["ssm"])
        x = x + 0.5 * (apply_norm(cfg, p["fuse_norm_a"], a) +
                       apply_norm(cfg, p["fuse_norm_s"], s))
    else:
        x = x + attn.attention_decode(cfg, p["attn"], h, cache["kv"], pos)
    h = apply_norm(cfg, p["norm2"], x)
    return x + apply_mlp(cfg, p["mlp"], h)


def run_stack_decode(cfg, stacked: Params, x: torch.Tensor, caches: Params,
                     pos: int) -> torch.Tensor:
    """Run the layers in order on one token; the stacked ``caches`` are
    updated in place. Returns x."""
    for i in range(num_stacked(stacked)):
        x = decoder_layer_decode(cfg, layer_view(stacked, i), x,
                                 layer_view(caches, i), pos)
    return x
