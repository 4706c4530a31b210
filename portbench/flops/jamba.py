"""Model FLOPs and kernel bounds of a Jamba prefill, from the configuration
file's keys (transformers' ``JambaConfig`` names), by ``flops/lm.py``'s
rules: 2 operations a weight a token passes through (the embedding a
lookup, the depthwise conv counted like a matrix, the LM head at the last
position only) plus attention's 4 D a visible key and head.

The layer types are ``reference/jamba.py``'s rule (``kinds``). A MoE layer
counts its router over all ``num_experts`` and, of the ``num_experts_per_tok``
experts a token reaches, the share held on this device: k x held / E
experts a token (2 x 8 / 16 = 1 in the benchmark's cell), on average over
a uniform router. The SSM scan's elementwise work is left out.
"""
from __future__ import annotations

from typing import Dict

from portbench.reference.jamba import kinds
from portbench.rooflines import bound_s
from portbench.rooflines import kernels as rk


def layer_counts(cfg: Dict) -> Dict[str, int]:
    counts = {"attn": 0, "ssm": 0, "mlp": 0, "moe": 0}
    for i in range(cfg["num_hidden_layers"]):
        for kind in kinds(cfg, i):
            counts[kind] += 1
    return counts


def kind_weights(cfg: Dict) -> Dict[str, float]:
    """Weights a token passes through in one layer of each kind."""
    d = cfg["hidden_size"]
    h, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = d // h
    di = cfg["mamba_expand"] * d
    n, dtr = cfg["mamba_d_state"], cfg["mamba_dt_rank"]
    ff = 3 * d * cfg["intermediate_size"]
    e, k = cfg["num_experts"], cfg["num_experts_per_tok"]
    held = cfg.get("experts_held") or e
    return {
        "attn": float(d * h * hd * 2 + d * hkv * hd * 2),
        "ssm": float(d * 2 * di + di * (dtr + 2 * n) + dtr * di + di * d
                     + cfg["mamba_d_conv"] * di),
        "mlp": float(ff),
        "moe": float(d * e + ff * k * held / e),
    }


def prefill_request(cfg: Dict, mix: Dict) -> float:
    """B sequences of S through every layer, the head at the last
    position."""
    b, s = mix["batch"], mix["seq"]
    d = cfg["hidden_size"]
    counts, w = layer_counts(cfg), kind_weights(cfg)
    per_tok = sum(2.0 * w[kind] * counts[kind] for kind in counts)
    pairs = rk.visible_pairs(s, 0)
    attn = counts["attn"] * 4.0 * d * pairs / s  # 4 hd h, hd h = d
    return b * s * (per_tok + attn) + b * 2.0 * d * cfg["vocab_size"]


def kernel_bounds(cfg: Dict, mix: Dict, card: str) -> Dict[str, float]:
    """K5's forward over the attention layers, K6's over the Mamba layers:
    the least seconds a request."""
    b, s = mix["batch"], mix["seq"]
    d = cfg["hidden_size"]
    h, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    counts = layer_counts(cfg)
    return {
        "k5_fwd": counts["attn"] * bound_s(
            rk.k5_fwd(b, s, h, hkv, d // h, 0), card),
        "k6_fwd": counts["ssm"] * bound_s(
            rk.k6_fwd(b, s, cfg["mamba_expand"] * d, cfg["mamba_d_state"]),
            card),
    }
