"""Model FLOPs of the benchmark's language models, from the configuration
file's sizes (no recompute, no padding, active parameters only).

A token's forward is 2 operations a weight it passes through (every
matrix of a layer, the routed experts scaled by top-k / experts, the LM
head; the embedding is a lookup, the depthwise conv counted like a matrix)
plus attention's 4 D a visible key and head (QK^T and PV). A backward is
twice its forward. The SSM scan's elementwise work is left out (under 1%
of a layer's).
"""
from __future__ import annotations

from typing import Dict

from portbench.rooflines.kernels import visible_pairs


def layer_weights(cfg: Dict) -> float:
    """Active weights a token passes through in one layer."""
    d = cfg["d_model"]
    h, hkv = cfg["num_heads"], cfg["num_kv_heads"]
    hd = cfg.get("head_dim") or d // h
    w = d * h * hd * 2 + d * hkv * hd * 2  # wq, wo; wk, wv
    if cfg.get("ssm_state"):
        di = cfg.get("ssm_expand", 2) * d
        n = cfg["ssm_state"]
        dtr = cfg.get("ssm_dt_rank") or -(-d // 16)
        w += d * 2 * di + di * (dtr + 2 * n) + dtr * di + di * d
        w += cfg.get("ssm_conv", 4) * di
    if cfg.get("num_experts"):
        e, k = cfg["num_experts"], cfg["experts_per_token"]
        dff = cfg.get("moe_d_ff") or cfg["d_ff"]
        w += d * e  # router
        w += 3 * d * dff * k  # the k routed experts a token reaches
        w += 3 * d * dff * cfg.get("num_shared_experts", 0)
    else:
        w += 3 * d * cfg["d_ff"]
    return float(w)


def attention_per_token(cfg: Dict, s: int) -> float:
    """Attention's operations a token, averaged over a sequence of s."""
    d = cfg["d_model"]
    h = cfg["num_heads"]
    hd = cfg.get("head_dim") or d // h
    pairs = visible_pairs(s, cfg.get("attn_window") or 0)
    return 4.0 * hd * h * pairs / s


def forward_per_token(cfg: Dict, layers: int, s: int) -> float:
    """A token's forward through ``layers`` layers and the LM head."""
    head = 2.0 * cfg["d_model"] * cfg["vocab_size"]
    return layers * (2.0 * layer_weights(cfg) + attention_per_token(cfg, s)) \
        + head


def train_round(cfg: Dict, layers: int, mix: Dict) -> float:
    """A cohort round: C M b S trained tokens (forward + backward) and the
    eq. 4 probe's C bp S tokens (forward)."""
    s = mix["seq"]
    fwd = forward_per_token(cfg, layers, s)
    trained = mix["cohort"] * mix["local_steps"] * mix["batch"] * s
    probed = mix["cohort"] * mix["probe_batch"] * s
    return 3.0 * fwd * trained + fwd * probed


def prefill_request(cfg: Dict, layers: int, mix: Dict) -> float:
    """A prefill of B sequences of S: every position through the layers,
    the LM head at the last position only."""
    b, s = mix["batch"], mix["seq"]
    head = 2.0 * cfg["d_model"] * cfg["vocab_size"]
    per_tok = forward_per_token(cfg, layers, s) - head
    return b * s * per_tok + b * head
