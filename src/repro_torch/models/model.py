"""Language model: embedding -> decoder stack -> LM head (port of the JAX
package's ``models/model.py``).

Params are plain dicts of tensors in the JAX package's layout (layers
stacked on a leading axis), so ``models/convert.py`` carries them across
and the tests compare both packages like with like. Every method is a
function of (params, inputs); the decode cache is updated in place.

One class covers every family of the registry (dense, MoE, hybrid, SSM,
VLM, audio). Batch dicts:

  LM     : ``{"tokens": (B, S) int, "labels": (B, S) int}`` (labels for
           ``loss`` only)
  VLM    : + ``{"patches": (B, P, d_model)}`` (stub frontend output),
           projected and prepended; the text positions come out
  audio  : + ``{"frames": (B, S_enc, d_model)}`` (stub conv/mel output)
           through the encoder; the decoder cross-attends to it

``loss`` is the training objective: mean next-token cross-entropy plus the
MoE's auxiliary loss, differentiable under ``torch.func`` (the layer stack
and the chunked cross-entropy rematerialise through ``utils/remat.py``).

``build_model`` gives a ``LayeredConfig`` (layers of different kinds,
Jamba) a ``LayeredModel``: the same methods over the layered stack, with
no positions at all (NoPE: no RoPE, no sinusoid).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, blocks
from repro_torch.models.layers import (
    Init,
    apply_norm,
    dense_init,
    dtype_of,
    embed_init,
    make_norm_params,
    sinusoidal_positions,
)
from repro_torch.utils.device import DeviceLike, resolve_device
from repro_torch.utils.remat import remat

Params = Dict[str, Any]


def _ce_sum(x: torch.Tensor, head: torch.Tensor, labels: torch.Tensor,
            valid: torch.Tensor) -> torch.Tensor:
    """Sum of the cross-entropy of one token chunk: x (T, d) through the LM
    head, (T, V) logits local to the chunk."""
    logits = (x @ head).float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[:, None].long())[:, 0]
    return torch.sum((lse - gold) * valid)


class Model:
    """One config's model on one device (``"cuda"`` unless the caller asks
    for the CPU; raises without a card)."""

    def __init__(self, cfg: ModelConfig, device: DeviceLike = "cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)

    # ------------------------------------------------------------------ init
    def init(self, generator: Optional[torch.Generator]) -> Params:
        """Random params with the JAX package's distributions, drawn from
        ``generator`` (on its own device) and placed on the model's device.
        ``generator=None`` gives ``meta`` tensors: shapes only."""
        cfg = self.cfg
        init = Init(generator, self.device)
        dtype = dtype_of(cfg.param_dtype)
        p: Params = {
            "embed": embed_init(init, cfg.vocab_size, cfg.d_model, dtype),
            "final_norm": make_norm_params(cfg, cfg.d_model, init),
            "layers": blocks.init_stack(init, cfg, cfg.num_layers,
                                        cross=cfg.is_encdec),
        }
        if not cfg.tie_embeddings:
            p["lm_head"] = dense_init(init, cfg.d_model, cfg.vocab_size, dtype)
        if cfg.num_patches:
            p["projector"] = dense_init(init, cfg.d_model, cfg.d_model, dtype)
        if cfg.is_encdec:
            p["encoder"] = {
                "layers": blocks.init_stack(init, cfg, cfg.encoder_layers),
                "final_norm": make_norm_params(cfg, cfg.d_model, init),
            }
        return p

    # ------------------------------------------------------------- embedding
    def _scale_embed(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        if cfg.family == "dense" and cfg.tie_embeddings:
            # gemma-style input scaling, in the embedding's dtype
            # (torch.full, not torch.tensor: the latter detaches in place,
            # which torch.func refuses on a meta tensor)
            x = x * torch.full((), cfg.d_model ** 0.5, dtype=x.dtype,
                               device=x.device)
        return x

    def _embed(self, params: Params, tokens: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = self._scale_embed(params["embed"][tokens])
        if not cfg.rope_theta:
            pos = torch.arange(tokens.shape[1], device=tokens.device)
            x = x + sinusoidal_positions(pos, cfg.d_model)[None].to(x.dtype)
        return x.to(dtype_of(cfg.compute_dtype))

    def _logits(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = apply_norm(cfg, params["final_norm"], x)
        if cfg.tie_embeddings:
            return x @ params["embed"].T
        return x @ params["lm_head"]

    def _encode(self, params: Params, frames: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        pos = torch.arange(frames.shape[1], device=frames.device)
        x = frames.to(dtype_of(cfg.compute_dtype))
        x = x + sinusoidal_positions(pos, cfg.d_model)[None].to(x.dtype)
        x = blocks.run_encoder_stack(cfg, params["encoder"]["layers"], x)
        return apply_norm(cfg, params["encoder"]["final_norm"], x)

    # --------------------------------------------------------- full sequence
    def hidden(self, params: Params, batch: Dict[str, torch.Tensor],
               window: Optional[int] = None):
        """Full-sequence forward without the LM head, on the text positions
        only. Returns (hidden (B, S, d), aux_loss)."""
        cfg = self.cfg
        x = self._embed(params, batch["tokens"])
        enc_out = None
        if cfg.num_patches:
            patches = batch["patches"].to(x.dtype) @ params["projector"]
            x = torch.cat([patches, x], dim=1)
        if cfg.is_encdec:
            enc_out = self._encode(params, batch["frames"])
        x, aux = blocks.run_stack_train(cfg, params["layers"], x,
                                        enc_out=enc_out, window=window)
        if cfg.num_patches:
            x = x[:, batch["patches"].shape[1]:]
        return x, aux

    def apply(self, params: Params, batch: Dict[str, torch.Tensor],
              window: Optional[int] = None):
        """Full-sequence forward. Returns (logits (B, S, V), aux_loss)."""
        x, aux = self.hidden(params, batch, window=window)
        return self._logits(params, x), aux

    def prefill_logits(self, params: Params, batch: Dict[str, torch.Tensor],
                       window: Optional[int] = None) -> torch.Tensor:
        """Serving prefill: last-token logits (B, 1, V) only; the (B, S, V)
        logits are never built (the LM head sees one position)."""
        x, _ = self.hidden(params, batch, window=window)
        return self._logits(params, x[:, -1:])

    def loss(self, params: Params, batch: Dict[str, torch.Tensor],
             window: Optional[int] = None):
        """Mean next-token cross-entropy (+ MoE aux). Returns (loss,
        {"ce", "aux"}).

        With ``cfg.ce_chunk > 0`` the LM head and the cross-entropy run per
        chunk of tokens, each chunk rematerialised, so the (T, V) logits
        never exist; a last chunk that T does not fill is padded and masked
        out of the sum.
        """
        cfg = self.cfg
        labels = batch["labels"]
        if not cfg.ce_chunk:
            logits, aux = self.apply(params, batch, window=window)
            logits = logits.float()
            lse = torch.logsumexp(logits, dim=-1)
            gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
            ce = torch.mean(lse - gold)
            return ce + aux, {"ce": ce, "aux": aux}

        x, aux = self.hidden(params, batch, window=window)
        x = apply_norm(cfg, params["final_norm"], x)
        head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
        b, s, d = x.shape
        t = b * s
        chunk = min(cfg.ce_chunk, t)
        nc = -(-t // chunk)
        pad = nc * chunk - t
        xf = x.reshape(t, d)
        lf = labels.reshape(t)
        valid = torch.ones((t,), dtype=torch.float32, device=x.device)
        if pad:
            xf = F.pad(xf, (0, 0, 0, pad))
            lf = F.pad(lf, (0, pad))
            valid = F.pad(valid, (0, pad))
        body = remat(_ce_sum)
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(nc):
            rows = slice(i * chunk, (i + 1) * chunk)
            total = total + body(xf[rows], head, lf[rows], valid[rows])
        ce = total / t
        return ce + aux, {"ce": ce, "aux": aux}

    # ------------------------------------------------------------------ serve
    def init_cache(self, batch: int, cache_len: int) -> Params:
        """Layer-stacked decode cache (leading axis L) on the model's device:
        a ring KV cache of ``min(cache_len, attn_window)`` slots under SWA,
        the SSM state and conv tail for SSM layers, and the cross K/V of
        ``encoder_seq_len`` frames for an encoder-decoder."""
        cfg = self.cfg
        return blocks.init_stack_cache(cfg, cfg.num_layers, batch, cache_len,
                                       dtype_of(cfg.compute_dtype),
                                       self.device, cross=cfg.is_encdec)

    def prefill_cross(self, params: Params, cache: Params,
                      frames: torch.Tensor) -> Params:
        """Encoder-decoder only: run the encoder on ``frames`` (B, S_enc, d)
        and write each layer's cross K/V into the stacked cross cache, in
        place. Returns the cache."""
        cross = cache["cross"]
        if tuple(frames.shape[:2]) != tuple(cross["k"].shape[1:3]):
            raise ValueError(f"frames {tuple(frames.shape)} do not fit the "
                             f"cross cache {tuple(cross['k'].shape)}")
        enc_out = self._encode(params, frames)
        for i in range(self.cfg.num_layers):
            layer = blocks.layer_view(params["layers"], i)
            kv = attention.precompute_cross_kv(self.cfg, layer["xattn"],
                                               enc_out)
            cross["k"][i] = kv["k"]
            cross["v"][i] = kv["v"]
        return cache

    def decode_step(self, params: Params, cache: Params, tokens: torch.Tensor,
                    pos: int):
        """tokens: (B, 1) int; pos: the tokens' position. Returns (logits
        (B, 1, V), cache), the cache updated in place."""
        cfg = self.cfg
        x = self._scale_embed(params["embed"][tokens])
        if not cfg.rope_theta:
            at = torch.full((1,), pos, device=tokens.device)
            x = x + sinusoidal_positions(at, cfg.d_model)[None].to(x.dtype)
        x = x.to(dtype_of(cfg.compute_dtype))
        x = blocks.run_stack_decode(cfg, params["layers"], x, cache, pos)
        return self._logits(params, x), cache

    # ------------------------------------------------------------- utilities
    def param_count(self, params: Optional[Params] = None) -> int:
        if params is None:
            params = self.init(None)

        def count(t) -> int:
            if isinstance(t, dict):
                return sum(count(v) for v in t.values())
            return t.numel()

        return count(params)

    def active_param_count(self, params: Optional[Params] = None) -> int:
        """Params touched per token (MoE: shared + top-k routed only)."""
        cfg = self.cfg
        if params is None:
            params = self.init(None)
        total = self.param_count(params)
        if not cfg.is_moe:
            return total
        moe = params["layers"]["moe"]
        routed = sum(moe[k].numel() for k in ("w_gate", "w_up", "w_down"))
        active = routed * cfg.experts_per_token // cfg.num_experts
        return total - routed + active


class LayeredModel(Model):
    """A ``LayeredConfig``'s model: a decoder-only LM over the layered
    stack (``blocks.run_layered_train`` / ``run_layered_decode``)."""

    def init(self, generator: Optional[torch.Generator]) -> Params:
        cfg = self.cfg
        init = Init(generator, self.device)
        dtype = dtype_of(cfg.param_dtype)
        p: Params = {
            "embed": embed_init(init, cfg.vocab_size, cfg.d_model, dtype),
            "final_norm": make_norm_params(cfg, cfg.d_model, init),
            "layers": blocks.init_layered_stack(init, cfg),
        }
        if not cfg.tie_embeddings:
            p["lm_head"] = dense_init(init, cfg.d_model, cfg.vocab_size, dtype)
        return p

    def _embed(self, params: Params, tokens: torch.Tensor) -> torch.Tensor:
        x = self._scale_embed(params["embed"][tokens])
        return x.to(dtype_of(self.cfg.compute_dtype))

    def hidden(self, params: Params, batch: Dict[str, torch.Tensor],
               window: Optional[int] = None):
        """(hidden (B, S, d), aux_loss); ``window`` is not read (no layer
        of a layered config is windowed)."""
        x = self._embed(params, batch["tokens"])
        return blocks.run_layered_train(self.cfg, params["layers"], x)

    def init_cache(self, batch: int, cache_len: int) -> Params:
        """``{"attn": K/V of the attention layers, "ssm": state and conv
        tail of the Mamba layers}``, each stacked over its kind's layers."""
        return blocks.init_layered_cache(self.cfg, batch, cache_len,
                                         dtype_of(self.cfg.compute_dtype),
                                         self.device)

    def decode_step(self, params: Params, cache: Params, tokens: torch.Tensor,
                    pos: int):
        x = self._embed(params, tokens)
        x = blocks.run_layered_decode(self.cfg, params["layers"], x, cache,
                                      pos)
        return self._logits(params, x), cache


def build_model(cfg: ModelConfig, device: DeviceLike = "cuda") -> Model:
    if hasattr(cfg, "schedule"):  # a LayeredConfig
        return LayeredModel(cfg, device)
    return Model(cfg, device)
