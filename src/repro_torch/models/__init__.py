from repro_torch.models.convert import (  # noqa: F401
    lm_params_from_jax,
    lm_params_to_jax,
    params_from_jax,
    params_to_numpy,
)
from repro_torch.models.lenet import (  # noqa: F401
    LeNet,
    apply_lenet,
    init_lenet,
    lenet_loss,
)
from repro_torch.models.model import Model, build_model  # noqa: F401
