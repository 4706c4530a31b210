from repro_torch.configs.base import (  # noqa: F401
    INPUT_SHAPES,
    ArchConfig,
    FLConfig,
    ModelConfig,
    ShapeConfig,
    smoke_variant,
)
from repro_torch.configs.lenet_fmnist import PAPER_FL  # noqa: F401
from repro_torch.configs.registry import ASSIGNED_ARCHS, get_arch, list_archs  # noqa: F401
