"""Architecture registry of the port: ``get_arch(id)`` / ``list_archs()``.

IDs match the JAX package's registry. Only the architectures whose every
branch the port runs are listed (and ``lenet``, the paper's own backbone);
any other id of the JAX package raises ``KeyError`` naming the ROADMAP
slice that brings it.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import ArchConfig

_MODULES: Dict[str, str] = {
    "hymba-1.5b": "repro_torch.configs.hymba_1p5b",
    "qwen3-1.7b": "repro_torch.configs.qwen3_1p7b",
    "falcon-mamba-7b": "repro_torch.configs.falcon_mamba_7b",
    # paper's own experiment backbone (not in the assigned pool)
    "lenet": "repro_torch.configs.lenet_fmnist",
}

ASSIGNED_ARCHS: List[str] = [k for k in _MODULES if k != "lenet"]


def get_arch(arch_id: str) -> ArchConfig:
    if arch_id not in _MODULES:
        raise KeyError(
            f"arch {arch_id!r} is not ported; ported: {sorted(_MODULES)}. "
            "The rest of the JAX package's registry (MoE, encoder-decoder, "
            "VLM and the other dense archs) comes with ROADMAP Slice F")
    mod = importlib.import_module(_MODULES[arch_id])
    return mod.CONFIG


def list_archs() -> List[str]:
    return list(ASSIGNED_ARCHS)
