from repro_torch.data.partition import dirichlet_partition, shard_partition  # noqa: F401
from repro_torch.data.synthetic import (  # noqa: F401
    ClientDataset,
    make_federated_image_dataset,
    make_lm_token_stream,
    synthetic_image_classes,
)
