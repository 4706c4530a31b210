from repro_torch.sharding.specs import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    PartitionSpec,
    client_state_pspec,
    flat_param_pspec,
    flat_stacked_pspec,
    info_pspec,
    kclient_pspec,
    mesh_axis_size,
    ring_codes_pspec,
    ring_pspec,
    ring_scales_pspec,
)
