"""NVIDIA Hymba-1.5B — hybrid-head: attention and mamba heads run in
parallel within every layer and their (normalized) outputs are fused.
[arXiv:2411.13676]"""
from repro_torch.configs.base import ArchConfig, ModelConfig

CONFIG = ArchConfig(
    model=ModelConfig(
        name="hymba-1.5b",
        family="hybrid",
        num_layers=32,
        d_model=1600,
        num_heads=25,
        num_kv_heads=5,
        d_ff=5504,
        vocab_size=32001,
        activation="swiglu",
        ssm_state=16,
        parallel_ssm_attn=True,
        attn_window=1024,  # hymba uses SWA on most layers; global layers omitted
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
    ),
    source="[arXiv:2411.13676]",
    notes="Parallel attn+mamba heads fused by mean of per-branch RMSNorm; "
          "meta-tokens from the paper omitted (orthogonal to this repro). "
          "Sub-quadratic natively (SWA + SSM) => long_500k runs as-is.",
)
