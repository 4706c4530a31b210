"""FL hyper-parameters of the paper (a copy of the JAX package's ``FLConfig``).

The port keeps its own frozen dataclass with the same fields and defaults,
so one set of keyword arguments configures both packages identically.
"""
from __future__ import annotations

import dataclasses


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
