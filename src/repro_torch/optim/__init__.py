from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer,
    adamw,
    apply_updates,
    sgd,
)
from repro_torch.optim.schedules import (  # noqa: F401
    constant_schedule,
    cosine_schedule,
    warmup_cosine_schedule,
)
