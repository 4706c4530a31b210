from repro_torch.models.convert import params_from_jax, params_to_numpy  # noqa: F401
from repro_torch.models.lenet import (  # noqa: F401
    LeNet,
    apply_lenet,
    init_lenet,
    lenet_loss,
)
