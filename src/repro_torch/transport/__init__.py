"""Real-transport serving ingress (DESIGN.md §12): a copy of the JAX
package's ``transport/`` that drives the port's ``ServingController``.

The serving loop's network face, split so no layer leaks into another:

* ``transport.wire`` — the versioned, codec-aware wire schema: length-
  prefixed frames (JSON header + raw tensor blobs, flat f32 or int8
  per-block affine payloads), ``schema_version`` stamped and checked;
* ``transport.server`` — stdlib-only TCP/HTTP ingress: threaded socket
  accept loop feeding the thread-safe ``ServingController.offer`` queue,
  with the existing single-threaded ``pump()`` fold loop on wall-clock;
* ``transport.client`` — ``RemoteAggregator`` (the socket-side
  ``AggregatorService``) plus the client training loop that honors
  ``retry_after`` backoff, staleness re-pulls, and connection-loss
  retry with jittered exponential backoff.

``core/serving.py`` defines the ``AggregatorService`` protocol both
sides meet; the deterministic in-process twin (``sim/arrivals.py``)
stays the CI path, and loopback parity between the two is pinned byte-
for-byte (tests/test_torch_transport.py). Frames and digests are
byte-identical to the JAX package's for the same inputs.
"""
from repro_torch.transport.wire import (  # noqa: F401
    SCHEMA_VERSION,
    WIRE_CODECS,
    WireError,
    decode_message,
    encode_message,
    params_sha256,
    payload_sha256,
    read_message,
)
from repro_torch.transport.server import AggregatorServer  # noqa: F401
from repro_torch.transport.client import (  # noqa: F401
    RemoteAggregator,
    run_client,
)
