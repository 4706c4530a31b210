"""Gemma-7B — dense decoder, GeGLU, head_dim=256, 16 heads / 16 kv heads
(MHA; the 2B variant uses MQA). [arXiv:2403.08295]"""
from repro_torch.configs.base import ArchConfig, ModelConfig

CONFIG = ArchConfig(
    model=ModelConfig(
        name="gemma-7b",
        family="dense",
        num_layers=28,
        d_model=3072,
        num_heads=16,
        num_kv_heads=16,
        head_dim=256,  # head_dim * heads = 4096 != d_model
        d_ff=24576,
        vocab_size=256000,
        activation="geglu",
        tie_embeddings=True,
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
    ),
    source="[arXiv:2403.08295]",
    notes="GeGLU MLP, embedding-scaled inputs, tied softmax/embedding. "
          "256k vocab makes the embedding/LM head the sharding hot-spot.",
    long_context_window=4096,
)
