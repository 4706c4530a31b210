"""Snowflake Arctic 480B — dense-MoE hybrid: 128 experts top-2 with a dense
residual branch in parallel. [hf:Snowflake/snowflake-arctic-base]"""
from repro_torch.configs.base import ArchConfig, ModelConfig

CONFIG = ArchConfig(
    model=ModelConfig(
        name="arctic-480b",
        family="moe",
        num_layers=35,
        d_model=7168,
        num_heads=56,
        num_kv_heads=8,
        d_ff=4864,
        vocab_size=32000,
        activation="swiglu",
        num_experts=128,
        experts_per_token=2,
        moe_d_ff=4864,
        dense_residual_ff=True,
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
    ),
    source="[hf:Snowflake/snowflake-arctic-base]",
    notes="Dense-MoE hybrid residual: dense FFN (d_ff=4864) parallel to "
          "128-expert top-2 MoE in every layer; experts expert-parallel "
          "over the model axis.",
    long_context_window=4096,
    fl_mode="distributed",  # 960 GB of bf16 params: a client spans the mesh
)
