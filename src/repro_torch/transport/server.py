"""Stdlib-only TCP/HTTP ingress for the serving loop (DESIGN.md §12).

``AggregatorServer`` puts a real, unreliable-network face on a
``ServingController`` without the controller ever learning about
sockets:

* a **threaded accept loop** — either a raw framed-TCP listener (one
  thread per connection, persistent connections, the fast path the
  transport benchmark gates) or a ``ThreadingHTTPServer`` speaking the
  same frames as POST/GET bodies (``--transport http``, the CI smoke
  lane) — both dispatching into one ``_handle``;
* the controller's **thread-safe offer queue**: worker threads call
  ``ServingController.offer`` directly (its single lock IS the
  admission queue's synchronization) and nudge the fold loop through a
  condition variable;
* the **single-threaded fold loop**: ``serve()`` runs the existing
  ``pump()`` on the caller's thread with wall-clock ``now``, preserving
  the single-owner fold contract — folding (and with it the local
  training and every device call of the round) never migrates off the
  aggregator thread, whichever thread that is (the controller's
  documented thread-safety contract).

Observability: every worker reports ``transport_rx_bytes_total`` /
``transport_tx_bytes_total`` / ``transport_requests_total`` labeled by a
bounded ``worker`` slot (thread-id mod 8 — fixed label cardinality on a
long-lived service), decode latency lands in a
``transport_decode_seconds`` histogram, and each request opens
``transport_decode`` -> ``transport_offer`` spans on the tracer.
"""
from __future__ import annotations

import logging
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional

from repro_torch.core.serving import ServingController
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import (
    NULL_TRACER,
    SPAN_TRANSPORT_DECODE,
    SPAN_TRANSPORT_OFFER,
    Tracer,
)
from repro_torch.transport import wire

logger = logging.getLogger("repro_torch.transport.server")

TRANSPORTS = ("tcp", "http")
_WORKER_SLOTS = 8  # bounded label cardinality for per-worker series


def _json_safe(obj: Any) -> Any:
    """Metrics dicts hold numpy scalars / tuples; make them JSON-able."""
    if isinstance(obj, dict):
        return {str(k): _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_safe(v) for v in obj]
    if hasattr(obj, "item"):
        return obj.item()
    return obj


class AggregatorServer:
    """One serving endpoint: listener threads -> offer queue -> fold loop.

    The server implements the WIRE side of ``AggregatorService``: every
    request frame maps 1:1 onto a protocol method (offer / pull /
    snapshot). Construction binds the socket (``port=0`` picks an
    ephemeral port, reported by ``.port``); ``serve()`` runs the fold
    loop on the calling thread until ``stop()`` returns True or
    ``shutdown()`` is called from elsewhere.
    """

    def __init__(self, controller: ServingController, *,
                 transport: str = "tcp", host: str = "127.0.0.1",
                 port: int = 0, registry: Optional[MetricsRegistry] = None,
                 tracer: Optional[Tracer] = None):
        if transport not in TRANSPORTS:
            raise ValueError(f"transport must be one of {TRANSPORTS}, "
                             f"got {transport!r}")
        self.controller = controller
        self.transport = transport
        self.registry = (registry if registry is not None
                         else controller.registry)
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self._decode_hist = self.registry.histogram(
            "transport_decode_seconds")
        self._t0 = time.monotonic()
        self._cond = threading.Condition()
        self._stop = threading.Event()
        self._threads = []
        if transport == "tcp":
            self._listener = socket.create_server((host, port))
            self.port = self._listener.getsockname()[1]
            self._httpd = None
        else:
            server = self

            class Handler(BaseHTTPRequestHandler):
                protocol_version = "HTTP/1.1"
                # headers and body are separate sends; Nagle + the
                # peer's delayed ACK would stall every response ~40ms
                disable_nagle_algorithm = True

                def log_message(self, *a):  # quiet: obs plane has counters
                    pass

                def _reply(self, code: int, body: bytes,
                           ctype: str = "application/octet-stream"):
                    self.send_response(code)
                    self.send_header("Content-Type", ctype)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)

                def do_POST(self):
                    if self.path != "/v1/offer":
                        self._reply(404, b"unknown endpoint",
                                    "text/plain")
                        return
                    n = int(self.headers.get("Content-Length", 0))
                    self._reply(200, server._handle(self.rfile.read(n)))

                def do_GET(self):
                    if self.path == "/v1/model":
                        req = wire.encode_message("pull", {})
                    elif self.path == "/v1/metrics":
                        req = wire.encode_message("metrics", {})
                    else:
                        self._reply(404, b"unknown endpoint",
                                    "text/plain")
                        return
                    self._reply(200, server._handle(req))

            self._listener = None
            self._httpd = ThreadingHTTPServer((host, port), Handler)
            self._httpd.daemon_threads = True
            self.port = self._httpd.server_address[1]
        logger.info("%s transport listening on %s:%d", transport, host,
                    self.port)

    # -- service clock ---------------------------------------------------
    def clock(self) -> float:
        """Wall-clock seconds since the server came up — the ``now`` every
        offer and the fold loop share (retry_after hints are in these
        units, per the Admission contract)."""
        return time.monotonic() - self._t0

    # -- request dispatch (shared by both listeners) ---------------------
    def _worker_label(self) -> str:
        return f"w{threading.get_ident() % _WORKER_SLOTS}"

    def _handle(self, data: bytes) -> bytes:
        """Decode one request frame, run the protocol method, encode the
        response. Runs on a transport worker thread."""
        worker = self._worker_label()
        rx = self.registry.counter("transport_rx_bytes_total",
                                   worker=worker)
        tx = self.registry.counter("transport_tx_bytes_total",
                                   worker=worker)
        rx.inc(len(data))
        t0 = time.perf_counter()
        try:
            with self.tracer.span(SPAN_TRANSPORT_DECODE, cat="transport",
                                  worker=worker):
                kind, meta, tensors = wire.decode_message(data)
            self._decode_hist.observe(time.perf_counter() - t0)
        except wire.WireError as e:
            resp = wire.encode_message("error", {"error": str(e)})
            tx.inc(len(resp))
            return resp
        self.registry.counter("transport_requests_total", kind=kind,
                              worker=worker).inc()
        if kind == "offer":
            import dataclasses

            from repro_torch.core.serving import Upload

            upload = Upload.from_wire(meta, tensors)
            # re-stamp arrival on the SERVICE clock (Upload.sent_at
            # contract): the client's clock is a different process's
            # monotonic origin, meaningless for round-latency math here
            now = self.clock()
            upload = dataclasses.replace(upload, sent_at=now)
            with self.tracer.span(SPAN_TRANSPORT_OFFER, cat="transport",
                                  worker=worker, client=upload.client_id):
                adm = self.controller.offer(upload, now)
            with self._cond:
                self._cond.notify()  # wake the fold loop
            resp = wire.encode_message("admission", adm.to_wire())
        elif kind == "pull":
            from repro_torch.core.serving import tree_to_wire

            version, params = self.controller.pull()
            out: Dict[str, Any] = {}
            skel = tree_to_wire("params", params, out)
            # model dissemination stays f32: the parity gate pins the
            # pulled bytes == the served params bytes
            resp = wire.encode_message("model",
                                       {"version": version,
                                        "params": skel}, out)
        elif kind == "metrics":
            resp = wire.encode_message(
                "metrics", {"metrics": _json_safe(
                    self.controller.snapshot())})
        else:
            resp = wire.encode_message("error",
                                       {"error": f"unknown kind {kind!r}"})
        tx.inc(len(resp))
        return resp

    # -- TCP listener -----------------------------------------------------
    def _tcp_accept_loop(self) -> None:
        conn_id = 0
        while not self._stop.is_set():
            try:
                conn, addr = self._listener.accept()
            except OSError:  # listener closed by shutdown()
                return
            t = threading.Thread(target=self._tcp_serve_conn,
                                 args=(conn,), daemon=True,
                                 name=f"transport-conn-{conn_id}")
            conn_id += 1
            t.start()

    def _tcp_serve_conn(self, conn: socket.socket) -> None:
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        try:
            with conn, conn.makefile("rwb") as f:
                while not self._stop.is_set():
                    try:
                        (total,) = wire._LEN.unpack(
                            wire._read_exact(f, wire._LEN.size))
                        if total > wire.MAX_FRAME_BYTES:
                            raise wire.WireError("oversized frame")
                        data = wire._read_exact(f, total)
                    except (ConnectionError, OSError):
                        return  # peer went away: normal churn
                    resp = self._handle(data)
                    wire.write_frame(f, resp)
        except (ConnectionError, OSError):
            return

    # -- lifecycle --------------------------------------------------------
    def start(self) -> None:
        """Start the listener threads (accept loop / HTTP server)."""
        if self.transport == "tcp":
            t = threading.Thread(target=self._tcp_accept_loop, daemon=True,
                                 name="transport-accept")
        else:
            t = threading.Thread(target=self._httpd.serve_forever,
                                 kwargs={"poll_interval": 0.05},
                                 daemon=True, name="transport-http")
        t.start()
        self._threads.append(t)

    def serve(self, *, stop: Optional[Callable[[], bool]] = None,
              round_hook: Optional[Callable[[int], None]] = None,
              poll: float = 0.05) -> None:
        """The fold loop: run ``pump`` on THIS thread (the single
        aggregator thread) whenever offers arrive, until ``stop()`` or
        ``shutdown()``. ``round_hook(version)`` fires once per applied
        round, same contract as ``serve_stream``."""
        ctrl = self.controller
        while not self._stop.is_set():
            with self._cond:
                self._cond.wait(timeout=poll)
            before = ctrl.version
            ctrl.pump(self.clock())
            if round_hook is not None:
                for v in range(before + 1, ctrl.version + 1):
                    round_hook(v)
            if stop is not None and stop():
                return

    def shutdown(self) -> None:
        """Stop listeners and wake the fold loop (idempotent)."""
        self._stop.set()
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
        with self._cond:
            self._cond.notify_all()
