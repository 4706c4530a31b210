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

The port runs in one process until the distributed substrate (Slice E,
ROADMAP.md) is ported, so the process-0 gates are always open.
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
    NULL_TRACER,
    SPAN_APPLY,
    SPAN_CHECKPOINT,
    SPAN_COLLECT,
    SPAN_CONTRIBUTE,
    SPAN_HOST_SYNC,
    SPAN_NAMES,
    Tracer,
    WindowedProfiler,
    span_coverage,
    validate_trace,
)
