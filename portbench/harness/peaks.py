"""Published peaks of the card, picked by its name (as ``chip_smoke.py``'s
``HBM_BYTES_PER_S`` picks them).

NVIDIA's data sheets, dense rates without sparsity, at the full power
limit: H100 SXM 989 TFLOP/s in bf16, 67 TFLOP/s in float32 outside the
tensor cores, 3.35 TB/s of HBM3; the H100 NVL and PCIe parts and the H200
differ in bandwidth, listed first so that the longest name matches first.
"""
from __future__ import annotations

HBM_BYTES_PER_S = (("H200", 4.8e12), ("H100 NVL", 3.9e12),
                   ("H100 PCIe", 2.0e12), ("H100", 3.35e12))
BF16_FLOPS = 989e12
F32_FLOPS = 67e12


def hbm_rate(card: str) -> float:
    for part, rate in HBM_BYTES_PER_S:
        if part in card:
            return rate
    raise ValueError(f"no HBM bandwidth known for {card!r}")


def flops_peak(card: str, dtype: str) -> float:
    hbm_rate(card)  # an unknown card has no peaks here either
    return {"bfloat16": BF16_FLOPS, "float16": BF16_FLOPS,
            "float32": F32_FLOPS}[dtype]
