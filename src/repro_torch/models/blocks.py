"""Decoder and encoder blocks and the layer stack (port of the JAX
package's ``models/blocks.py``).

Layer parameters are stacked on a leading layer axis, as the JAX package's
``init_stack`` makes them (``jax.vmap`` over layer keys), so weights carry
across unchanged; the stack runs as a Python loop over that axis, layer
``i`` reading views ``leaf[i]``. The decode caches carry the same leading
layer axis and are updated in place, where the JAX package's ``lax.scan``
returns new ones.

Families: dense, MoE (with arctic's dense residual FFN), hybrid (attention
and SSM in parallel, Hymba), SSM-only, and the encoder-decoder's encoder
layers and cross-attention.

A ``LayeredConfig`` (Jamba) gives each layer its own mixer (Mamba or
attention) and FFN (MLP or MoE) by its ``schedule``. Its parameters stay
under ``layers``, grouped by kind, each group stacked on a leading axis of
that kind's layers: ``norm1`` and ``norm2`` (every layer), ``ssm``,
``attn``, ``mlp``, ``moe``; its decode cache holds ``attn`` K/V for the
attention layers and ``ssm`` state for the Mamba layers alone.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import Init, apply_mlp, apply_norm, init_mlp, make_norm_params
from repro_torch.obs.trace import (
    SPAN_ATTN_MIXER,
    SPAN_MOE_FFN,
    SPAN_SSM_MIXER,
    active_tracer,
)
from repro_torch.utils.remat import remat, remat_scan

Params = Dict[str, Any]


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


# ---------------------------------------------------------------------------
# per-layer init
# ---------------------------------------------------------------------------


def init_layer(init: Init, cfg, cross: bool = False) -> Params:
    """One decoder layer's params for the cfg's family (``cross``: with
    cross-attention over the encoder's output)."""
    p: Params = {"norm1": make_norm_params(cfg, cfg.d_model, init)}
    if cfg.is_ssm_only:
        p["ssm"] = ssm_mod.init_ssm(init, cfg)
        return p
    p["attn"] = attn.init_attention(init, cfg)
    if cfg.is_hybrid:
        p["ssm"] = ssm_mod.init_ssm(init, cfg)
        p["fuse_norm_a"] = make_norm_params(cfg, cfg.d_model, init)
        p["fuse_norm_s"] = make_norm_params(cfg, cfg.d_model, init)
    if cross:
        p["norm_x"] = make_norm_params(cfg, cfg.d_model, init)
        p["xattn"] = attn.init_attention(init, cfg, cross=True)
    p["norm2"] = make_norm_params(cfg, cfg.d_model, init)
    if cfg.is_moe:
        p["moe"] = moe_mod.init_moe(init, cfg)
        if cfg.dense_residual_ff:
            p["mlp"] = init_mlp(init, cfg)
    else:
        p["mlp"] = init_mlp(init, cfg)
    return p


def init_stack(init: Init, cfg, num_layers: int, cross: bool = False
               ) -> Params:
    """Layer params stacked on a leading axis of ``num_layers``.

    Each stacked leaf is allocated once and layer ``i`` is drawn, then
    copied into its slice, so the init holds the stack and one layer (not
    two copies of the stack); the draws are those of ``init_layer`` layer
    after layer."""
    return _stack_draws(lambda: init_layer(init, cfg, cross=cross),
                        num_layers)


def _stack_draws(draw, num_layers: int) -> Params:
    """``draw()``'s tree, drawn ``num_layers`` times into stacked leaves."""
    stacked: Params = {}

    def put(dst: Params, src: Params, i: int) -> None:
        for key, val in src.items():
            if isinstance(val, dict):
                put(dst.setdefault(key, {}), val, i)
                continue
            if key not in dst:
                dst[key] = val.new_empty((num_layers, *val.shape))
            if val.device.type != "meta":
                dst[key][i].copy_(val)

    for i in range(num_layers):
        put(stacked, draw(), i)
    return stacked


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


def _ffn(cfg, p: Params, h: torch.Tensor):
    """The FFN on the normed input: the MLP, or the MoE (plus arctic's
    dense residual MLP). Returns (y, aux_loss)."""
    if cfg.is_moe:
        y, aux = moe_mod.moe_ffn(cfg, p["moe"], h)
        if cfg.dense_residual_ff:
            y = y + apply_mlp(cfg, p["mlp"], h)
        return y, aux
    return apply_mlp(cfg, p["mlp"], h), \
        torch.zeros((), dtype=torch.float32, device=h.device)


def _ffn_train(cfg, p: Params, x: torch.Tensor):
    if cfg.is_ssm_only:  # mamba block subsumes the MLP
        return x, torch.zeros((), dtype=torch.float32, device=x.device)
    y, aux = _ffn(cfg, p, apply_norm(cfg, p["norm2"], x))
    return x + y, aux


def decoder_layer_train(cfg, p: Params, x: torch.Tensor,
                        enc_out: Optional[torch.Tensor] = None,
                        window: Optional[int] = None):
    """Returns (x, aux_loss). ``enc_out`` enables cross-attention
    (encoder-decoder)."""
    x = _mixer_train(cfg, p, x, window)
    if enc_out is not None and "xattn" in p:
        h = apply_norm(cfg, p["norm_x"], x)
        x = x + attn.attention_train(cfg, p["xattn"], h, kv_x=enc_out,
                                     causal=False)
    return _ffn_train(cfg, p, x)


def encoder_layer_train(cfg, p: Params, x: torch.Tensor) -> torch.Tensor:
    h = apply_norm(cfg, p["norm1"], x)
    x = x + attn.attention_train(cfg, p["attn"], h, causal=False)
    x, _ = _ffn_train(cfg, p, x)
    return x


def run_stack_train(cfg, stacked: Params, x: torch.Tensor,
                    enc_out: Optional[torch.Tensor] = None,
                    window: Optional[int] = None):
    """Run the layer stack in order. Returns (x, total_aux).

    Each layer's activations are recomputed in the backward
    (``utils/remat.py``; the JAX package's ``remat=True`` default), so only
    the layer boundaries are kept. ``cfg.remat_block = G`` (G > 1 dividing
    the layer count) rematerialises groups of G layers instead
    (``remat_scan``): only the L / G group boundaries are kept, and each
    group's G layer boundaries come back transiently in its backward, where
    each layer is recomputed once more. Remat changes no number.
    """
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def layer(p, carry, enc):
        h, la = decoder_layer_train(cfg, p, carry[0], enc_out=enc,
                                    window=window)
        return h, carry[1] + la

    nl = num_stacked(stacked)
    g = getattr(cfg, "remat_block", 0)
    if g and g > 1 and nl % g == 0:
        group = remat_scan(layer)
        for i in range(0, nl, g):
            x, aux = group([layer_view(stacked, j) for j in range(i, i + g)],
                           (x, aux), enc_out)
        return x, aux
    step = remat(layer)
    for i in range(nl):
        x, aux = step(layer_view(stacked, i), (x, aux), enc_out)
    return x, aux


def run_encoder_stack(cfg, stacked: Params, x: torch.Tensor) -> torch.Tensor:
    """The encoder layers in order, each rematerialised."""
    def layer(p, h):
        return encoder_layer_train(cfg, p, h)

    step = remat(layer)
    for i in range(num_stacked(stacked)):
        x = step(layer_view(stacked, i), x)
    return x


# ---------------------------------------------------------------------------
# decode (single token) block application
# ---------------------------------------------------------------------------


def init_layer_cache(cfg, batch: int, cache_len: int, dtype: torch.dtype,
                     device: torch.device, cross: bool = False) -> Params:
    c: Params = {}
    if not cfg.is_ssm_only:
        c["kv"] = attn.init_kv_cache(cfg, batch, cache_len, dtype, device)
    if cfg.is_ssm_only or cfg.is_hybrid:
        c["ssm"] = ssm_mod.init_ssm_cache(cfg, batch, dtype, device)
    if cross:
        shape = (batch, cfg.encoder_seq_len, cfg.num_kv_heads,
                 cfg.resolved_head_dim)
        c["cross"] = {"k": torch.zeros(shape, dtype=dtype, device=device),
                      "v": torch.zeros(shape, dtype=dtype, device=device)}
    return c


def init_stack_cache(cfg, num_layers: int, batch: int, cache_len: int,
                     dtype: torch.dtype, device: torch.device,
                     cross: bool = False) -> Params:
    """Layer-stacked cache (leading axis L), zeros."""
    one = init_layer_cache(cfg, batch, cache_len, dtype, device, cross=cross)
    return _zeros_stacked(one, num_layers)


def _zeros_stacked(tree: Params, n: int) -> Params:
    if isinstance(tree, dict):
        return {k: _zeros_stacked(v, n) for k, v in tree.items()}
    return tree.new_zeros((n,) + tuple(tree.shape))


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
    if "xattn" in p and "cross" in cache:
        h = apply_norm(cfg, p["norm_x"], x)
        x = x + attn.cross_attention_decode(cfg, p["xattn"], h,
                                            cache["cross"])
    y, _ = _ffn(cfg, p, apply_norm(cfg, p["norm2"], x))
    return x + y


def run_stack_decode(cfg, stacked: Params, x: torch.Tensor, caches: Params,
                     pos: int) -> torch.Tensor:
    """Run the layers in order on one token; the stacked ``caches`` are
    updated in place. Returns x."""
    for i in range(num_stacked(stacked)):
        x = decoder_layer_decode(cfg, layer_view(stacked, i), x,
                                 layer_view(caches, i), pos)
    return x


# ---------------------------------------------------------------------------
# layered stack (LayeredConfig): a mixer kind and an FFN kind per layer
# ---------------------------------------------------------------------------


def init_layered_stack(init: Init, cfg) -> Params:
    """``norm1`` / ``norm2`` stacked over every layer, then each kind's
    params stacked over its layers, drawn kind after kind."""
    counts = cfg.layer_counts()
    draws = {"ssm": lambda: {**ssm_mod.init_ssm(init, cfg),
                             **ssm_mod.init_inner_norms(init, cfg)},
             "attn": lambda: attn.init_attention(init, cfg),
             "mlp": lambda: init_mlp(init, cfg),
             "moe": lambda: moe_mod.init_moe(init, cfg)}
    p: Params = {
        "norm1": _stack_draws(
            lambda: make_norm_params(cfg, cfg.d_model, init), cfg.num_layers),
        "norm2": _stack_draws(
            lambda: make_norm_params(cfg, cfg.d_model, init), cfg.num_layers)}
    for kind, draw in draws.items():
        if counts[kind]:
            p[kind] = _stack_draws(draw, counts[kind])
    return p


def _layered_ffn(cfg, kind: str, p: Params, h: torch.Tensor):
    """The FFN of one layer on the normed input: (y, aux_loss)."""
    if kind == "moe":
        with active_tracer().span(SPAN_MOE_FFN, cat="moe"):
            return moe_mod.moe_share_ffn(cfg, p, h)
    return apply_mlp(cfg, p, h), \
        torch.zeros((), dtype=torch.float32, device=h.device)


def _layered_layer(cfg, kinds, p: Params, carry):
    """One layer of the layered stack: pre-norm mixer and pre-norm FFN,
    each with its residual. ``kinds``: (mixer kind, FFN kind)."""
    mixer, ffn = kinds
    x, aux = carry
    h = apply_norm(cfg, p["norm1"], x)
    if mixer == "ssm":
        with active_tracer().span(SPAN_SSM_MIXER, cat="layer"):
            x = x + ssm_mod.ssm_train(cfg, p["mixer"], h,
                                      ssm_inputs=ssm_mod.normed_ssm_inputs)
    else:
        with active_tracer().span(SPAN_ATTN_MIXER, cat="layer"):
            x = x + attn.attention_train(cfg, p["mixer"], h)
    y, la = _layered_ffn(cfg, ffn, p["ffn"], apply_norm(cfg, p["norm2"], x))
    return x + y, aux + la


def _layer_parts(stacked: Params, i: int, entry) -> Params:
    """Layer i's parameters as views, by its ``schedule`` entry."""
    mixer, mi, ffn, fi = entry
    return {"norm1": layer_view(stacked["norm1"], i),
            "norm2": layer_view(stacked["norm2"], i),
            "mixer": layer_view(stacked[mixer], mi),
            "ffn": layer_view(stacked[ffn], fi)}


def run_layered_train(cfg, stacked: Params, x: torch.Tensor):
    """The layered stack in order, each layer rematerialised as
    ``run_stack_train``'s are (``remat_block`` is not read). Returns (x,
    total_aux)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def layer(kinds, p, carry):
        return _layered_layer(cfg, kinds, p, carry)

    step = remat(layer)
    for i, entry in enumerate(cfg.schedule):
        x, aux = step((entry[0], entry[2]), _layer_parts(stacked, i, entry),
                      (x, aux))
    return x, aux


def init_layered_cache(cfg, batch: int, cache_len: int, dtype: torch.dtype,
                       device: torch.device) -> Params:
    """K/V stacked over the attention layers, SSM state over the Mamba
    layers, zeros."""
    counts = cfg.layer_counts()
    c: Params = {}
    if counts["attn"]:
        c["attn"] = _zeros_stacked(
            attn.init_kv_cache(cfg, batch, cache_len, dtype, device),
            counts["attn"])
    if counts["ssm"]:
        c["ssm"] = _zeros_stacked(
            ssm_mod.init_ssm_cache(cfg, batch, dtype, device), counts["ssm"])
    return c


def run_layered_decode(cfg, stacked: Params, x: torch.Tensor,
                       caches: Params, pos: int) -> torch.Tensor:
    """The layered stack on one token; ``caches`` updated in place."""
    for i, entry in enumerate(cfg.schedule):
        mixer, mi, ffn, _ = entry
        p = _layer_parts(stacked, i, entry)
        h = apply_norm(cfg, p["norm1"], x)
        cache = layer_view(caches[mixer], mi)
        if mixer == "ssm":
            x = x + ssm_mod.ssm_decode(cfg, p["mixer"], h, cache,
                                       ssm_inputs=ssm_mod.normed_ssm_inputs)
        else:
            x = x + attn.attention_decode(cfg, p["mixer"], h, cache, pos)
        y, _ = _layered_ffn(cfg, ffn, p["ffn"], apply_norm(cfg, p["norm2"], x))
        x = x + y
    return x
