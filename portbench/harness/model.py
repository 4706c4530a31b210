"""The program's model, built from a configuration file of the benchmark.

The configuration file holds the port's ``ModelConfig`` fields at its top
level (beside ``source``, ``reduced``, ``assumed`` and notes), so the file
is the configuration as it is run; ``layers`` overrides the depth (a
training cell's pipeline stage).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional


def model_config(cfg: Dict, layers: Optional[int] = None):
    from repro_torch.configs.base import ModelConfig

    names = {f.name for f in dataclasses.fields(ModelConfig)}
    kw = {k: v for k, v in cfg.items() if k in names}
    if layers is not None:
        kw["num_layers"] = layers
    return ModelConfig(**kw)

