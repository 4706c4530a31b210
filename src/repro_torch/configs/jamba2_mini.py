"""AI21 Jamba2-Mini: Mamba-1 layers with one NoPE GQA attention layer in
eight, and a MoE of 16 SwiGLU experts (top 2, gates as the softmax gives
them) in every other layer.
[hf:ai21labs/AI21-Jamba2-Mini config.json; arXiv:2403.19887, 2408.12570]

``config_from_dict`` builds the config from a dict of transformers'
``JambaConfig`` keys (the benchmark's configuration file), so the file is
the configuration as it is run.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.layered import LayeredConfig

# transformers' JambaConfig keys -> the port's fields
KEYS = {
    "num_hidden_layers": "num_layers",
    "hidden_size": "d_model",
    "num_attention_heads": "num_heads",
    "num_key_value_heads": "num_kv_heads",
    "intermediate_size": "d_ff",
    "vocab_size": "vocab_size",
    "num_experts": "num_experts",
    "num_experts_per_tok": "experts_per_token",
    "mamba_d_state": "ssm_state",
    "mamba_d_conv": "ssm_conv",
    "mamba_expand": "ssm_expand",
    "mamba_dt_rank": "ssm_dt_rank",
    "attn_layer_period": "attn_layer_period",
    "attn_layer_offset": "attn_layer_offset",
    "expert_layer_period": "expert_layer_period",
    "expert_layer_offset": "expert_layer_offset",
    "router_aux_loss_coef": "router_aux_coef",
    "experts_held": "experts_held",
}


def config_from_dict(cfg: Dict, name: str = "jamba2-mini") -> LayeredConfig:
    """The port's config of a Jamba model from transformers' keys; the
    parts of the architecture that no key states are Jamba's: SwiGLU
    experts as wide as the MLP, RMSNorm, and (in the layered stack itself)
    no positions, the inner dt/B/C norms, ungated top-k, dropless MoE."""
    if cfg.get("model_type", "jamba") != "jamba":
        raise ValueError(f"not a Jamba config: {cfg.get('model_type')!r}")
    if cfg.get("hidden_act", "silu") != "silu" or cfg.get("sliding_window"):
        raise ValueError("only SiLU experts and full attention are ported")
    kw = {field: cfg[key] for key, field in KEYS.items() if key in cfg}
    return LayeredConfig(
        name=name, family="hybrid", moe_d_ff=kw["d_ff"], rope_theta=0.0,
        tie_embeddings=bool(cfg.get("tie_word_embeddings", False)),
        param_dtype=cfg.get("param_dtype", "bfloat16"),
        compute_dtype=cfg.get("compute_dtype", "bfloat16"),
        activation="swiglu", norm="rmsnorm", **kw)


PUBLISHED = {
    "attn_layer_offset": 4, "attn_layer_period": 8,
    "expert_layer_offset": 1, "expert_layer_period": 2,
    "hidden_act": "silu", "hidden_size": 4096, "intermediate_size": 14336,
    "mamba_d_conv": 4, "mamba_d_state": 16, "mamba_dt_rank": 256,
    "mamba_expand": 2, "model_type": "jamba", "num_attention_heads": 32,
    "num_experts": 16, "num_experts_per_tok": 2, "num_hidden_layers": 32,
    "num_key_value_heads": 8, "sliding_window": None,
    "tie_word_embeddings": False, "vocab_size": 65536,
    "router_aux_loss_coef": 0.001,
}

CONFIG = ArchConfig(
    model=config_from_dict(PUBLISHED),
    source="[hf:ai21labs/AI21-Jamba2-Mini]",
    notes="Layer types by JambaConfig.layers_block_type / "
          "layers_num_experts (the config's periods and offsets); every "
          "expert held (experts_held 0). router_aux_loss_coef is "
          "transformers' default.",
)
