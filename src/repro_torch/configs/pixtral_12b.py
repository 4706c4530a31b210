"""Pixtral-12B — VLM: pixtral-ViT frontend (STUBBED per assignment) feeding
a mistral-nemo-style dense decoder. [hf:mistralai/Pixtral-12B-2409]"""
from repro_torch.configs.base import ArchConfig, ModelConfig

CONFIG = ArchConfig(
    model=ModelConfig(
        name="pixtral-12b",
        family="vlm",
        num_layers=40,
        d_model=5120,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,  # mistral-nemo: head_dim 128 != d_model/32=160
        d_ff=14336,
        vocab_size=131072,
        activation="swiglu",
        rope_theta=1000000.0,
        num_patches=256,  # stub vision frontend emits 256 patch embeddings
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
    ),
    source="[hf:mistralai/Pixtral-12B-2409]",
    notes="Vision encoder + projector stubbed: input_specs() provides "
          "precomputed patch embeddings (B, 256, d_model) prepended to the "
          "token stream. Decoder is the trainable backbone.",
    long_context_window=4096,
)
