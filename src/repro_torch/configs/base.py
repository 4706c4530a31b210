"""Config dataclasses (copies of the JAX package's ``configs/base.py``).

The port keeps its own frozen dataclasses with the same fields, defaults
and derived properties, so one set of keyword arguments configures both
packages identically (pinned by ``tests/test_torch_lm.py``). Each ported
architecture has one module in this package defining ``CONFIG:
ArchConfig`` with the published dimensions (citation in ``source``);
``smoke_variant()`` derives the reduced CPU-testable config of the same
family.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# model config
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default d_model // num_heads
    activation: str = "swiglu"  # swiglu | geglu | gelu
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    # --- attention variant ---
    attn_window: Optional[int] = None  # sliding-window size; None = full causal
    force_chunked_attn: bool = False  # JAX package's chunked attention at
    # short seq; the port's causal attention (K5) never builds (S, S) scores
    ce_chunk: int = 0  # perf: cross-entropy in token chunks — the (T, V)
    # logits tensor is never materialised (head matmul fused per chunk)
    remat_block: int = 0  # perf: sqrt-remat — checkpoint every Nth layer
    # boundary instead of every layer (L/N saved carries + N transient)
    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    num_shared_experts: int = 0
    moe_d_ff: Optional[int] = None  # per-expert hidden size (defaults to d_ff)
    dense_residual_ff: bool = False  # arctic: dense FFN in parallel with MoE
    router_aux_coef: float = 0.01
    moe_capacity_factor: float = 1.25
    moe_groups: int = 1  # dispatch groups: sort/scatter stay local to each
    # group (group = data shard)
    # --- SSM (mamba-1) ---
    ssm_state: int = 0  # N (state size); 0 = no ssm
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_dt_rank: Optional[int] = None  # default ceil(d_model / 16)
    # --- hybrid ---
    parallel_ssm_attn: bool = False  # hymba: attn and mamba heads in parallel
    # --- encoder/decoder (audio) ---
    encoder_layers: int = 0  # >0 => enc-dec with cross attention
    encoder_seq_len: int = 0  # stubbed frontend output frames
    # --- vlm ---
    num_patches: int = 0  # stubbed vision frontend output patches
    # --- numerics ---
    param_dtype: str = "float32"
    compute_dtype: str = "float32"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.num_heads

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def is_ssm_only(self) -> bool:
        return self.ssm_state > 0 and self.num_heads == 0

    @property
    def is_hybrid(self) -> bool:
        return self.parallel_ssm_attn

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def resolved_dt_rank(self) -> int:
        if self.ssm_dt_rank:
            return self.ssm_dt_rank
        return max(1, (self.d_model + 15) // 16)

    @property
    def resolved_moe_d_ff(self) -> int:
        return self.moe_d_ff if self.moe_d_ff else self.d_ff

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# input shapes (assigned)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


TRAIN_4K = ShapeConfig("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")

INPUT_SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


# ---------------------------------------------------------------------------
# FL / training configs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FLConfig:
    """Contribution-aware asynchronous FL hyper-parameters (the paper)."""

    num_clients: int = 30
    buffer_size: int = 10  # K — server aggregates once K updates arrive
    local_steps: int = 4  # M local SGD steps per upload
    local_lr: float = 0.05
    local_momentum: float = 0.0
    global_lr: float = 1.0  # eta_g
    batch_size: int = 32
    clients_per_round: int = 0  # sync FedAvg participation; 0 = all N
    weighting: str = "paper"  # paper | multiplicative | fedbuff | polynomial
    # | fedasync | fedasync_{constant,hinge,poly} (core/weighting.POLICIES)
    normalize: str = "mean"  # mean | none
    s_min: float = 1e-3  # floor on S_i for the paper's division (numerics)
    poly_a: float = 0.5  # exponent for the polynomial staleness discount
    hinge_a: float = 10.0  # fedasync_hinge slope (FLGo default)
    hinge_b: float = 6.0  # fedasync_hinge knee: s(tau)=1 while tau <= b
    staleness_mode: str = "model_diff"  # model_diff (eq.3) | rounds
    max_staleness: int = 32  # ring-buffer depth for version tracking
    seed: int = 0
    # perf knobs
    accum_dtype: str = "float32"  # distributed-mode delta accumulator dtype
    probe_batch: int = 4  # eq.-4 probe sequences per data-parallel group
    # server pass (core/server_pass.py): auto picks the fused CUDA kernel
    # for a CUDA device and the plain-PyTorch reference body for the CPU
    server_pass_mode: str = "auto"  # auto | reference | batched | fused
    server_pass_block_n: int = 0  # flat-vector tile; 0 = auto (lane-aligned)
    # compressed version store (core/version_store.py)
    ring_codec: str = "f32"  # f32 | int8 | delta
    ring_qblock: int = 256  # int8: params per affine quantization block
    ring_delta_density: float = 0.05  # delta: kept residual fraction of Np
    ring_base_refresh: int = 0  # delta: ring writes between base-snapshot
    # refreshes; 0 = every R = max_staleness + 1 writes (one ring lap)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    model: ModelConfig
    source: str  # citation: [hf:...] or [arXiv:...]
    notes: str = ""
    # shapes this arch skips, with reasons
    skip_shapes: Tuple[str, ...] = ()
    # per-shape model overrides, e.g. long_500k -> sliding window variant
    long_context_window: Optional[int] = None  # if set, long_500k uses SWA
    # FL deployment mapping: "replicated" = one client per
    # data-axis group (exact eq.-3 staleness); "distributed" = one client
    # spans the mesh (FSDP x TP), K-buffer fills sequentially.
    fl_mode: str = "replicated"


def smoke_variant(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    d_model = min(cfg.d_model, 128)
    num_heads = min(cfg.num_heads, 4) or 0
    head_dim = None
    if cfg.num_heads:
        # keep any special head_dim relation (e.g. gemma 256 > d_model/H)
        head_dim = 32 if cfg.resolved_head_dim != cfg.d_model // cfg.num_heads else None
    num_kv = min(cfg.num_kv_heads, num_heads) if num_heads else 0
    if num_heads and num_kv and num_heads % num_kv:
        num_kv = 1
    kw = dict(
        name=cfg.name + "-smoke",
        num_layers=2,
        d_model=d_model,
        num_heads=num_heads,
        num_kv_heads=num_kv,
        head_dim=head_dim,
        d_ff=min(cfg.d_ff, 256) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 512),
        param_dtype="float32",
        compute_dtype="float32",
    )
    if cfg.is_moe:
        kw.update(
            num_experts=min(cfg.num_experts, 4),
            experts_per_token=min(cfg.experts_per_token, 2),
            num_shared_experts=min(cfg.num_shared_experts, 1),
            moe_d_ff=min(cfg.resolved_moe_d_ff, 128),
            moe_capacity_factor=8.0,  # dropless in smoke: decode == forward
        )
    if cfg.encoder_layers:
        kw.update(encoder_layers=1, encoder_seq_len=min(cfg.encoder_seq_len, 64))
    if cfg.num_patches:
        kw.update(num_patches=min(cfg.num_patches, 16))
    if cfg.attn_window:
        kw.update(attn_window=min(cfg.attn_window, 32))
    overrides = getattr(cfg, "smoke_overrides", None)  # a port-only subclass
    if overrides is not None:
        kw.update(overrides(kw))
    return cfg.replace(**kw)
