"""Falcon-Mamba-7B — pure Mamba-1 SSM, attention-free. [arXiv:2410.05355]"""
from repro_torch.configs.base import ArchConfig, ModelConfig

CONFIG = ArchConfig(
    model=ModelConfig(
        name="falcon-mamba-7b",
        family="ssm",
        num_layers=64,
        d_model=4096,
        num_heads=0,
        num_kv_heads=0,
        d_ff=0,  # mamba block subsumes the MLP (expand=2)
        vocab_size=65024,
        ssm_state=16,
        ssm_conv=4,
        ssm_expand=2,
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
    ),
    source="[arXiv:2410.05355]",
    notes="Attention-free; O(1) decode state => long_500k runs natively. "
          "CA-AFL applies unchanged (protocol is architecture-agnostic); "
          "the attention-sharding aspect of other papers is moot here — "
          "see DESIGN.md §Arch-applicability.",
)
