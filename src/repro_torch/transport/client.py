"""Socket-side ``AggregatorService``: the FL client runner (§12).

``RemoteAggregator`` speaks the wire schema to an ``AggregatorServer``
over a persistent TCP or HTTP connection and presents the SAME
``offer`` / ``pull`` / ``snapshot`` protocol as the in-process
``ServingController`` — callers (the client loop below, the parity
tests, the transport benchmark) cannot tell a socket from a direct
call. Connection loss is retried with jittered exponential backoff
(deterministic under a seed), so client churn and server restarts are
survivable instead of fatal.

``run_client`` is the client lifecycle the paper's serving regime
needs, mirroring ``sim/arrivals.py``'s in-process twin semantics
event for event:

    pull (version, params) -> local training (the streaming mapping
    folds server-side, so "training" = drawing the seeded local-step
    batches + eq.-4 probe; Upload docstring) -> offer
      * admitted / dropped-stale -> re-pull the CURRENT version, next
        local round (the stale drop means the base fell out of the
        version window: restart, don't ship unweightable work)
      * queue full -> sleep the advertised retry_after (plus jitter)
        and re-offer the SAME upload — same seq, same base_version,
        now staler
"""
from __future__ import annotations

import dataclasses
import http.client
import logging
import random
import socket
import time
from typing import Any, Callable, Dict, Optional, Tuple

from repro_torch.configs.base import FLConfig
from repro_torch.core.serving import (
    REJECT_QUEUE_FULL,
    Admission,
    AggregatorService,
    Upload,
    tree_from_wire,
)
from repro_torch.transport import wire

logger = logging.getLogger("repro_torch.transport.client")


class TransportError(ConnectionError):
    """RPC failed after exhausting the reconnect budget."""


# THE shared draw (sim/arrivals.py): the in-process twin, real clients,
# and the journal replay all materialize uploads through one function,
# so a client's seq-th upload is bit-identical everywhere — the property
# the loopback parity gate rides on.
from repro_torch.sim.arrivals import draw_upload  # noqa: E402,F401


class RemoteAggregator(AggregatorService):
    """``AggregatorService`` over a persistent socket (tcp or http).

    Every RPC is wrapped in the reconnect loop: on a connection error
    the proxy sleeps ``backoff_base * 2**attempt`` seconds (capped at
    ``backoff_cap``, multiplied by a seeded uniform jitter in
    [0.5, 1.5) so a fleet of clients doesn't reconnect in lockstep)
    and redials, up to ``max_retries`` times before raising
    ``TransportError``.
    """

    def __init__(self, host: str, port: int, *, transport: str = "tcp",
                 codec: str = "f32", max_retries: int = 8,
                 backoff_base: float = 0.05, backoff_cap: float = 2.0,
                 timeout: float = 30.0, seed: int = 0):
        if codec not in wire.WIRE_CODECS:
            raise ValueError(f"codec must be one of {wire.WIRE_CODECS}")
        self.host, self.port = host, port
        self.transport = transport
        self.codec = codec
        self.max_retries = max_retries
        self.backoff_base = backoff_base
        self.backoff_cap = backoff_cap
        self.timeout = timeout
        self._jitter = random.Random(seed)
        self._sock: Optional[socket.socket] = None
        self._file = None
        self._http: Optional[http.client.HTTPConnection] = None
        self.reconnects = 0  # telemetry: how flaky was the link

    # -- connection management -------------------------------------------
    def _connect(self) -> None:
        self.close()
        if self.transport == "tcp":
            self._sock = socket.create_connection(
                (self.host, self.port), timeout=self.timeout)
            self._sock.setsockopt(socket.IPPROTO_TCP,
                                  socket.TCP_NODELAY, 1)
            self._file = self._sock.makefile("rwb")
        else:
            self._http = http.client.HTTPConnection(
                self.host, self.port, timeout=self.timeout)
            self._http.connect()
            # headers and body go out in separate sends; without NODELAY
            # Nagle + delayed-ACK stalls every request ~40ms
            self._http.sock.setsockopt(socket.IPPROTO_TCP,
                                       socket.TCP_NODELAY, 1)

    def close(self) -> None:
        for closer in (self._file, self._sock, self._http):
            if closer is not None:
                try:
                    closer.close()
                except OSError:
                    pass
        self._sock = self._file = self._http = None

    def _rpc(self, frame: bytes, *, path: str, method: str
             ) -> Tuple[str, Dict[str, Any], Dict[str, Any]]:
        """One request/response with connection-loss retry + backoff."""
        last: Exception = ConnectionError("never connected")
        for attempt in range(self.max_retries):
            try:
                if self._sock is None and self._http is None:
                    self._connect()
                if self.transport == "tcp":
                    wire.write_frame(self._file, frame)
                    return wire.read_message(self._file)
                # GET endpoints carry no body (the server synthesizes the
                # request frame); a body on a GET would linger unread in
                # the keep-alive stream and corrupt the next request line
                self._http.request(method, path,
                                   body=frame if method == "POST" else None)
                resp = self._http.getresponse()
                body = resp.read()
                if resp.status != 200:
                    raise wire.WireError(
                        f"HTTP {resp.status}: {body[:200]!r}")
                return wire.decode_message(body)
            except (ConnectionError, socket.timeout, OSError,
                    http.client.HTTPException) as e:
                last = e
                self.close()
                self.reconnects += 1
                delay = min(self.backoff_cap,
                            self.backoff_base * (2.0 ** attempt))
                delay *= 0.5 + self._jitter.random()  # jittered
                logger.debug("rpc %s failed (%s); retry %d/%d in %.3fs",
                             path, e, attempt + 1, self.max_retries, delay)
                time.sleep(delay)
        raise TransportError(
            f"{method} {path} to {self.host}:{self.port} failed after "
            f"{self.max_retries} attempts: {last}") from last

    # -- AggregatorService ------------------------------------------------
    def offer(self, upload: Upload, now: float) -> Admission:
        meta, tensors = upload.to_wire()
        frame = wire.encode_message("offer", meta, tensors,
                                    codec=self.codec)
        kind, rmeta, _ = self._rpc(frame, path="/v1/offer", method="POST")
        if kind != "admission":
            raise wire.WireError(f"expected admission, got {kind!r}: "
                                 f"{rmeta}")
        return Admission.from_wire(rmeta)

    def pull(self) -> Tuple[int, Any]:
        frame = wire.encode_message("pull", {})
        kind, meta, tensors = self._rpc(frame, path="/v1/model",
                                        method="GET")
        if kind != "model":
            raise wire.WireError(f"expected model, got {kind!r}: {meta}")
        return int(meta["version"]), tree_from_wire(meta["params"], tensors)

    def snapshot(self) -> Dict[str, Any]:
        frame = wire.encode_message("metrics", {})
        kind, meta, _ = self._rpc(frame, path="/v1/metrics", method="GET")
        if kind != "metrics":
            raise wire.WireError(f"expected metrics, got {kind!r}: {meta}")
        return meta["metrics"]


def run_client(service: AggregatorService, ds, cid: int, fl: FLConfig, *,
               uploads: int, stop_at_version: int = 0,
               think_time: float = 0.0, max_wall_time: float = 0.0,
               clock: Callable[[], float] = time.monotonic,
               sleep: Callable[[float], None] = time.sleep,
               seed: int = 0) -> Dict[str, int]:
    """Drive one client against ANY ``AggregatorService`` (remote proxy
    or an in-process controller — the tests use both interchangeably).

    Draws up to ``uploads`` local rounds; stops early once the pulled
    version reaches ``stop_at_version`` (> 0) or ``max_wall_time``
    elapses. Returns the client-side ledger (draws / admitted /
    queue-full retries / stale drops / reconnect-ish failures).
    """
    jitter = random.Random(seed * 1000003 + cid)
    t_start = clock()
    stats = {"drawn": 0, "admitted": 0, "retries": 0, "dropped_stale": 0}
    version, _params = service.pull()
    for seq in range(uploads):
        if stop_at_version and version >= stop_at_version:
            break
        if max_wall_time and clock() - t_start > max_wall_time:
            break
        if think_time:
            sleep(think_time)  # models local-training wall time
        up = draw_upload(ds, cid, fl, base_version=version, t=clock(),
                         seq=seq)
        stats["drawn"] += 1
        while True:
            adm = service.offer(
                dataclasses.replace(up, sent_at=clock()), clock())
            if adm.accepted or adm.reason != REJECT_QUEUE_FULL:
                break
            # backpressure: honor the hint (same upload, now staler);
            # small multiplicative jitter de-synchronizes the fleet
            stats["retries"] += 1
            sleep(adm.retry_after * (1.0 + 0.1 * jitter.random()))
        if adm.accepted:
            stats["admitted"] += 1
        else:
            stats["dropped_stale"] += 1
        # admitted or hopelessly stale: either way re-pull and retrain
        version, _params = service.pull()
    return stats
