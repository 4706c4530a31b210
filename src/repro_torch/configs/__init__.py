from repro_torch.configs.base import FLConfig  # noqa: F401
from repro_torch.configs.lenet_fmnist import PAPER_FL  # noqa: F401
