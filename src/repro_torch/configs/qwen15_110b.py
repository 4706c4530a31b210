"""Qwen1.5-110B — dense decoder with QKV bias, GQA kv=8.
[hf:Qwen/Qwen1.5-0.5B]"""
from repro_torch.configs.base import ArchConfig, ModelConfig

CONFIG = ArchConfig(
    model=ModelConfig(
        name="qwen1.5-110b",
        family="dense",
        num_layers=80,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        d_ff=49152,
        vocab_size=152064,
        activation="swiglu",
        qkv_bias=True,
        rope_theta=1000000.0,
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
    ),
    source="[hf:Qwen/Qwen1.5-0.5B]",
    notes="Largest dense arch in the pool; FSDP over the data axis is "
          "required to fit v5e HBM.",
    long_context_window=4096,
    fl_mode="distributed",  # 220 GB of bf16 params: a client spans the mesh
)
