"""Qwen3-1.7B — dense decoder with QK-norm, GQA kv=8. [hf:Qwen/Qwen3-8B]"""
from repro_torch.configs.base import ArchConfig, ModelConfig

CONFIG = ArchConfig(
    model=ModelConfig(
        name="qwen3-1.7b",
        family="dense",
        num_layers=28,
        d_model=2048,
        num_heads=16,
        num_kv_heads=8,
        d_ff=6144,
        vocab_size=151936,
        activation="swiglu",
        qk_norm=True,
        rope_theta=1000000.0,
        tie_embeddings=True,
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
    ),
    source="[hf:Qwen/Qwen3-8B]",
    notes="Per-head RMSNorm on q and k before RoPE.",
    long_context_window=4096,
)
