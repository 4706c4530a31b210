"""DeepSeekMoE-16B — fine-grained MoE: 2 shared + 64 routed experts, top-6,
per-expert d_ff=1408. [arXiv:2401.06066]"""
from repro_torch.configs.base import ArchConfig, ModelConfig

CONFIG = ArchConfig(
    model=ModelConfig(
        name="deepseek-moe-16b",
        family="moe",
        num_layers=28,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        d_ff=1408,
        vocab_size=102400,
        activation="swiglu",
        num_experts=64,
        experts_per_token=6,
        num_shared_experts=2,
        moe_d_ff=1408,
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
    ),
    source="[arXiv:2401.06066]",
    notes="Fine-grained expert segmentation; shared experts always active. "
          "Deviation: the released model's first layer is dense — we use "
          "MoE in all layers for scan-over-layers homogeneity (protocol- "
          "irrelevant; recorded).",
    long_context_window=4096,
)
