from repro_torch.core.weighting import (  # noqa: F401
    FEDASYNC_POLICIES,
    POLICIES,
    contribution_weights,
    fedasync_discount,
    staleness_degree,
    statistical_effect,
)
from repro_torch.core.aggregation import aggregate, aggregate_fused  # noqa: F401
from repro_torch.core.buffer import BufferEntry, UpdateBuffer, VersionHistory  # noqa: F401
from repro_torch.core.client import make_fresh_loss_fn, make_local_update_fn  # noqa: F401
from repro_torch.core.cohort import (  # noqa: F401
    CohortState,
    DistFLState,
    init_cohort_state,
    init_dist_state,
    make_cohort_step,
    make_dist_step,
)
from repro_torch.core.round_body import (  # noqa: F401
    StreamingRoundBody,
    make_ring_round,
    make_round_body,
    make_streaming_round_body,
)
from repro_torch.core.server import AsyncServer, SyncServer  # noqa: F401
from repro_torch.core.serving import (  # noqa: F401
    Admission,
    ServeConfig,
    ServingController,
    Upload,
    serve_stream,
)
from repro_torch.core.server_pass import (  # noqa: F401
    FlatSpec,
    apply_server_round,
    flatten_stacked,
    flatten_tree,
    make_flat_spec,
    make_server_pass,
    resolve_mode,
    unflatten_like,
    unflatten_stacked,
)
from repro_torch.core.simulator import run_async, run_async_legacy, run_sync  # noqa: F401
