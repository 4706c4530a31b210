"""StableLM-2-12B — dense decoder, GQA kv=8. [hf:stabilityai/stablelm-2-1_6b]"""
from repro_torch.configs.base import ArchConfig, ModelConfig

CONFIG = ArchConfig(
    model=ModelConfig(
        name="stablelm-12b",
        family="dense",
        num_layers=40,
        d_model=5120,
        num_heads=32,
        num_kv_heads=8,
        d_ff=13824,
        vocab_size=100352,
        activation="swiglu",
        norm="layernorm",
        rope_theta=10000.0,
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
    ),
    source="[hf:stabilityai/stablelm-2-1_6b]",
    notes="Dense decoder; parallel attention/MLP omitted (sequential blocks).",
    long_context_window=4096,  # long_500k runs as SWA variant
)
