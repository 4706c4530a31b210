"""Architecture registry of the port: ``get_arch(id)`` / ``list_archs()``.

IDs and their order match the JAX package's registry (``--arch <id>`` in
the launchers). ``lenet`` and the port-only ``jamba2-mini`` are known to
``get_arch`` but not listed.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import ArchConfig

_MODULES: Dict[str, str] = {
    "stablelm-12b": "repro_torch.configs.stablelm_12b",
    "arctic-480b": "repro_torch.configs.arctic_480b",
    "hymba-1.5b": "repro_torch.configs.hymba_1p5b",
    "qwen1.5-110b": "repro_torch.configs.qwen15_110b",
    "pixtral-12b": "repro_torch.configs.pixtral_12b",
    "gemma-7b": "repro_torch.configs.gemma_7b",
    "deepseek-moe-16b": "repro_torch.configs.deepseek_moe_16b",
    "qwen3-1.7b": "repro_torch.configs.qwen3_1p7b",
    "falcon-mamba-7b": "repro_torch.configs.falcon_mamba_7b",
    "whisper-tiny": "repro_torch.configs.whisper_tiny",
    # paper's own experiment backbone (not in the assigned pool)
    "lenet": "repro_torch.configs.lenet_fmnist",
    # port-only (the JAX package has no layered stack)
    "jamba2-mini": "repro_torch.configs.jamba2_mini",
}

ASSIGNED_ARCHS: List[str] = [k for k in _MODULES
                             if k not in ("lenet", "jamba2-mini")]


def get_arch(arch_id: str) -> ArchConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(_MODULES[arch_id])
    return mod.CONFIG


def list_archs() -> List[str]:
    return list(ASSIGNED_ARCHS)
