"""Shared pieces of the benchmark's CPU tests: the checkout and the port on
the path, and small cells (smoke widths) that drive a whole run on the
CPU through the port's plain paths."""
from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

HYMBA_SMOKE = {
    "name": "hymba-smoke", "family": "hybrid", "num_layers": 2,
    "d_model": 64, "num_heads": 2, "num_kv_heads": 1, "d_ff": 128,
    "vocab_size": 256, "activation": "swiglu", "norm": "rmsnorm",
    "rope_theta": 10000.0, "tie_embeddings": False, "attn_window": 32,
    "ssm_state": 4, "ssm_conv": 4, "ssm_expand": 2, "ssm_dt_rank": 4,
    "parallel_ssm_attn": True, "param_dtype": "float32",
    "compute_dtype": "float32", "train_layers": 2,
}
MOE_SMOKE = {
    "name": "moe-smoke", "family": "moe", "num_layers": 2, "d_model": 64,
    "num_heads": 2, "num_kv_heads": 2, "d_ff": 32, "vocab_size": 256,
    "activation": "swiglu", "norm": "rmsnorm", "rope_theta": 10000.0,
    "tie_embeddings": False, "num_experts": 8, "experts_per_token": 2,
    "num_shared_experts": 1, "moe_d_ff": 32, "moe_capacity_factor": 1.25,
    "router_aux_coef": 0.01, "moe_groups": 1, "param_dtype": "float32",
    "compute_dtype": "float32",
}
COHORT_SMOKE = {
    "driver": "cohort_round", "cohort": 3, "buffer": 2, "local_steps": 2,
    "batch": 1, "seq": 64, "probe_batch": 2, "local_lr": 0.05,
    "global_lr": 1.0, "s_min": 0.001, "weighting": "paper",
    "server_pass_mode": "reference", "max_slowdown": 10.0,
    "schedule_rounds": 64, "data_sizes": [500, 2000], "pool_rounds": 4,
    "checked_rounds": 2, "traced_rounds": 1,
}
PREFILL_SMOKE = {"driver": "prefill", "batch": 2, "seq": 128,
                 "pool_requests": 3, "checked_requests": 2,
                 "traced_requests": 1}
TRAIN_LIMITS = {"loss_gap": 1e-4, "update_gap": 1e-3, "change_gap": 1e-3}
PREFILL_LIMITS = {"logit_gap": 1e-3}


def smoke_cell(kind: str):
    """A cell of the real benchmark's name at smoke widths, in f32."""
    from portbench.harness.bench import Cell, benchmark

    bench = benchmark()
    name, config, mix, limits = {
        "hymba-train": ("hymba-train-c4-s2048", HYMBA_SMOKE, COHORT_SMOKE,
                        TRAIN_LIMITS),
        "moe-train": ("dsmoe-train-c2-s2048", MOE_SMOKE, COHORT_SMOKE,
                      TRAIN_LIMITS),
        "prefill": ("hymba-prefill-s32k", HYMBA_SMOKE, PREFILL_SMOKE,
                    PREFILL_LIMITS),
    }[kind]
    entry = {w["name"]: w for w in bench["workloads"]}[name]
    return Cell.from_parts(name, entry, dict(config), dict(mix),
                           dict(limits), bench)


@pytest.fixture
def cell_of():
    return smoke_cell
