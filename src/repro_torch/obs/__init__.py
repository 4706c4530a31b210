"""Observability plane: a copy of the JAX package's ``obs/``.

Three pieces every runner reports into:

* ``obs.metrics`` — process-local registry of counters / gauges /
  fixed-bucket histograms with a flat ``snapshot()`` export and a
  merge path over per-process snapshots;
* ``obs.trace`` — round-lifecycle span tracer emitting Chrome-trace
  JSON, each span doubling as a ``torch.profiler.record_function`` so
  windowed device profiles line up with host spans;
* ``obs.sink`` — JSONL event sink (gated on process 0) plus the
  stdlib-logging configurator.

The process-0 gates follow ``sharding/collectives.is_coordinator``: rank 0 of
a ``torch.distributed`` world, or the one process when none is up.
``tests/test_torch_obs.py`` pins every output to the JAX package's.
"""
from repro_torch.obs.metrics import (  # noqa: F401
    DEFAULT_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    default_registry,
    export_snapshot,
    merge_snapshots,
)
from repro_torch.obs.sink import (  # noqa: F401
    InMemorySink,
    JsonlSink,
    configure_logging,
    emit_snapshot,
)
from repro_torch.obs.trace import (  # noqa: F401
    COHORT_SPAN_NAMES,
    LAYER_SPAN_NAMES,
    NULL_TRACER,
    SPAN_APPLY,
    SPAN_CHECKPOINT,
    SPAN_COLLECT,
    SPAN_CONTRIBUTE,
    SPAN_HOST_SYNC,
    SPAN_NAMES,
    SpanEdges,
    Tracer,
    active_tracer,
    WindowedProfiler,
    span_coverage,
    validate_trace,
)
