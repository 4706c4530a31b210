"""Whisper-tiny — encoder-decoder with conv/mel frontend (STUBBED per
assignment): input_specs() provides precomputed frame embeddings.
[arXiv:2212.04356]"""
from repro_torch.configs.base import ArchConfig, ModelConfig

CONFIG = ArchConfig(
    model=ModelConfig(
        name="whisper-tiny",
        family="audio",
        num_layers=4,  # decoder layers
        d_model=384,
        num_heads=6,
        num_kv_heads=6,
        d_ff=1536,
        vocab_size=51865,
        activation="gelu",
        norm="layernorm",
        rope_theta=0.0,  # learned absolute positions, no RoPE
        encoder_layers=4,
        encoder_seq_len=1500,  # 30s audio -> 1500 frames post-conv
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
    ),
    source="[arXiv:2212.04356]",
    notes="Mel-spectrogram + conv feature extractor stubbed: encoder "
          "consumes (B, 1500, 384) frame embeddings. decode_32k lowers "
          "(self-attn KV ring + cross-attn cache).",
    skip_shapes=("long_500k",),  # full attention, 448-token trained context;
    # no faithful sub-quadratic variant — recorded in DESIGN.md.
)
