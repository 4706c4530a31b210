"""Always-on FL serving controller (DESIGN.md §8): the JAX package's
``core/serving.py`` on PyTorch.

Everything else in the repo is run-to-completion simulation; this module
is the first consumer of the round substrate as a *service*. It wraps
``core/round_body.py::make_streaming_round_body`` — the O(1)-state online
form of eq. 5 — in the three pieces a long-running aggregation endpoint
actually needs:

* **Admission control.** Uploads land in a bounded ingress queue. A full
  queue rejects with a ``retry_after`` backoff hint (the client re-offers
  the SAME update later, staler); queued updates whose staleness outgrows
  ``FLConfig.max_staleness`` are evicted oldest-first (their eq. 3 base
  fell out of the version ring, so folding them would be unweightable).
  Every rejection reason has its own counter — nothing is dropped
  silently.

* **Adaptive buffer size K.** The time to gather a K-buffer is ~K/λ for
  arrival rate λ, so a fixed K couples round cadence to traffic. The
  controller EWMA-estimates λ from admitted inter-arrival gaps and steers
  K toward ``K* = λ · target_round_latency`` with a damped proportional
  step every ``adapt_every`` rounds. The streaming accumulator makes K a
  pure control decision: the apply is triggered by a host-side count, no
  device state is shaped by K (the v-buffer is padded to ``k_max``).

* **Telemetry.** Sustained uploads folded/sec, round-latency quantiles
  (p50/p99), queue-depth high-water mark, per-reason rejection counts,
  and the K trajectory — the numbers ``benchmarks/bench_serve.py`` gates
  on. The counters live on an ``obs.metrics`` registry (DESIGN.md §9) —
  ``controller.counters`` and ``metrics()`` are stable views of it, so
  the historical dict shape is unchanged while the registry snapshot
  gives the JSONL sink / nightly diffing the same numbers with labeled
  series. An optional ``obs.trace.Tracer`` times the round lifecycle
  (``collect_window`` open -> K-th fold, ``contribute`` per fold,
  ``apply`` per round) as Chrome-trace spans.

Time is injected by the caller (``now``): the driver below runs on the
sim/ scenario clock so tests and CI are deterministic, while a real
deployment would pass wall-clock. Service cost is modeled by
``service_time`` (sim-time to fold one upload); with arrival rate above
``1/service_time`` the queue fills and backpressure engages — exactly
the regime the burst tests pin.

The weighting inherits the FULL policy zoo of ``core/weighting.py``,
including the FedAsync staleness-discount family
(``fedasync_constant`` / ``fedasync_hinge`` / ``fedasync_poly``), because
the streaming round body runs ``contribution_weights`` verbatim. Parity
of the served aggregate against the exact ``apply_server_round`` path is
pinned in tests/test_torch_serving.py for every policy.

The folds and applies run on ``device`` (CUDA unless the caller asks for
the CPU). Uploads stay host (numpy) data in the queue and go to the
device at fold time. The streaming round reaches no kernel: its sums run
over one client at a time.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
from typing import (Any, Callable, Deque, Dict, List, Optional, Protocol,
                    Tuple, runtime_checkable)

import numpy as np
import torch

from repro_torch.configs.base import FLConfig
from repro_torch.core.round_body import make_streaming_round_body
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import (
    NULL_TRACER,
    SPAN_APPLY,
    SPAN_COLLECT,
    SPAN_CONTRIBUTE,
    Tracer,
)
from repro_torch.utils.device import DeviceLike, resolve_device
from repro_torch.utils.tree import tree_leaves, tree_map, tree_to_device

# admission outcomes (Admission.reason values)
ADMITTED = "admitted"
REJECT_QUEUE_FULL = "queue_full"
DROP_MAX_STALENESS = "max_staleness"


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Knobs of the serving loop (separate from the FL maths in FLConfig)."""

    queue_capacity: int = 64  # bounded ingress queue (admission control)
    service_time: float = 0.0  # sim-time to fold ONE upload into the accum
    target_round_latency: float = 2.0  # cadence the adaptive K steers toward
    k_min: int = 2  # adaptive-K clamp (floor keeps secure-agg viable)
    k_max: int = 64  # also the padded v-buffer length
    adapt_every: int = 4  # rounds between K adjustments; 0 = fixed K
    adapt_gain: float = 0.5  # damping toward K* = lambda_hat * target
    arrival_ewma: float = 0.2  # EWMA factor of the inter-arrival estimate
    retry_after_min: float = 0.1  # floor on the advertised backoff
    # ceiling on the advertised backoff: the drain-time hint is linear in
    # queue depth, so without a clamp a deep queue at a slow modeled
    # service rate would tell a WALL-CLOCK client to sleep unboundedly
    retry_after_max: float = 30.0


# -- wire-able trees ----------------------------------------------------
# Upload/Admission travel over the transport (DESIGN.md §12) as a
# JSON-able meta dict plus a flat {name: ndarray} tensor map; the byte
# encoding (framing, payload codec) lives in transport/wire.py so this
# module never learns about sockets. A tree of arrays becomes a
# JSON-able skeleton whose leaves are {"__tensor__": name} references.
# Tensor leaves (on any device) are copied to host numpy arrays.

def _host_array(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def tree_to_wire(prefix: str, tree: Any,
                 tensors: Dict[str, np.ndarray]) -> Any:
    """JSON-able skeleton of ``tree``; array leaves land in ``tensors``."""
    if isinstance(tree, dict):
        return {"__dict__": {k: tree_to_wire(f"{prefix}.{k}", v, tensors)
                             for k, v in sorted(tree.items())}}
    if isinstance(tree, (list, tuple)):
        return {"__tuple__": [tree_to_wire(f"{prefix}.{i}", v, tensors)
                              for i, v in enumerate(tree)]}
    tensors[prefix] = _host_array(tree)
    return {"__tensor__": prefix}


def tree_from_wire(skel: Any, tensors: Dict[str, np.ndarray]) -> Any:
    """Inverse of ``tree_to_wire`` (tuples come back as tuples)."""
    if "__tensor__" in skel:
        return tensors[skel["__tensor__"]]
    if "__dict__" in skel:
        return {k: tree_from_wire(v, tensors)
                for k, v in skel["__dict__"].items()}
    return tuple(tree_from_wire(v, tensors) for v in skel["__tuple__"])


@dataclasses.dataclass(frozen=True)
class Upload:
    """One client upload as the ingress queue holds it.

    The streaming mapping folds the local training server-side (the
    distributed-client entry shape), so the message carries the client's
    batches rather than a precomputed delta; ``base_version`` is the
    global version the client pulled, from which the controller derives
    staleness at FOLD time (it grows while the upload queues).

    Field-by-field (the wire schema mirrors these, DESIGN.md §12):

    * ``client_id`` — stable integer identity of the uploading client;
    * ``base_version`` — the global model version the client pulled and
      trained from (staleness = controller version - base_version);
    * ``data_size`` — |D_i|, the client's sample count (eq. 5 weight);
    * ``batch`` — (M, b, ...) stacked local-step batches, any tree
      (dicts, tuples) of numpy arrays;
    * ``probe`` — (bp, ...) eq.-4 fresh-loss probe batch, any tree;
    * ``sent_at`` — seconds on the SERVICE clock when the upload reached
      the endpoint (sim-seconds on the scenario clock, wall-clock
      seconds behind a real transport);
    * ``seq`` — client-local draw index of this upload (0, 1, 2, ...;
      a queue-full retry re-offers the SAME seq). Lets the loopback
      parity replay reconstruct a concurrent run's fold stream from
      seeded client datasets; -1 when the producer doesn't track it.
    """

    client_id: int
    base_version: int
    data_size: float
    batch: Any
    probe: Any
    sent_at: float
    seq: int = -1

    def to_wire(self) -> Tuple[Dict[str, Any], Dict[str, np.ndarray]]:
        """(JSON-able meta, flat tensor map) — transport/wire.py encodes
        these into one length-prefixed frame."""
        tensors: Dict[str, np.ndarray] = {}
        meta = {
            "client_id": int(self.client_id),
            "base_version": int(self.base_version),
            "data_size": float(self.data_size),
            "sent_at": float(self.sent_at),
            "seq": int(self.seq),
            "batch": tree_to_wire("batch", self.batch, tensors),
            "probe": tree_to_wire("probe", self.probe, tensors),
        }
        return meta, tensors

    @classmethod
    def from_wire(cls, meta: Dict[str, Any],
                  tensors: Dict[str, np.ndarray]) -> "Upload":
        return cls(client_id=int(meta["client_id"]),
                   base_version=int(meta["base_version"]),
                   data_size=float(meta["data_size"]),
                   batch=tree_from_wire(meta["batch"], tensors),
                   probe=tree_from_wire(meta["probe"], tensors),
                   sent_at=float(meta["sent_at"]),
                   seq=int(meta.get("seq", -1)))


@dataclasses.dataclass(frozen=True)
class Admission:
    """The admission-control verdict for one ``offer``.

    * ``accepted`` — True iff the upload entered the ingress queue;
    * ``reason`` — ADMITTED / REJECT_QUEUE_FULL / DROP_MAX_STALENESS;
    * ``retry_after`` — backoff hint in seconds on the SAME clock the
      caller passed as ``now`` (sim-seconds on the scenario clock,
      wall-clock seconds over a real transport); > 0 only for
      REJECT_QUEUE_FULL, and clamped to ``ServeConfig.retry_after_max``
      so a wall-clock client never sleeps unboundedly on a deep queue.
    """

    accepted: bool
    reason: str
    retry_after: float

    def to_wire(self) -> Dict[str, Any]:
        return {"accepted": bool(self.accepted), "reason": self.reason,
                "retry_after": float(self.retry_after)}

    @classmethod
    def from_wire(cls, meta: Dict[str, Any]) -> "Admission":
        return cls(accepted=bool(meta["accepted"]),
                   reason=str(meta["reason"]),
                   retry_after=float(meta["retry_after"]))


@runtime_checkable
class AggregatorService(Protocol):
    """The aggregation endpoint, as its CLIENTS see it (DESIGN.md §12).

    Three methods, deliberately transport-shaped: they are exactly the
    RPCs of the wire schema, so the in-process twin (``sim/arrivals.py``
    driving a ``ServingController`` directly — the deterministic CI
    path) and the socket path (``transport/client.py::RemoteAggregator``
    speaking to ``transport/server.py``) are interchangeable behind one
    type. ``core/serving.py`` never learns about sockets; the transport
    never learns about folding.

    * ``offer(upload, now)`` — submit one upload for admission; ``now``
      is the caller's clock reading (sim or wall seconds — whatever
      clock the service runs on);
    * ``pull()`` — ``(version, params)`` of the CURRENT served model
      (the client trains from this and stamps ``base_version``);
    * ``snapshot()`` — the service's metrics dict (telemetry only; no
      aggregation state).
    """

    def offer(self, upload: Upload, now: float) -> Admission: ...

    def pull(self) -> Tuple[int, Any]: ...

    def snapshot(self) -> Dict[str, Any]: ...


class ServingController:
    """Admission control + adaptive-K state machine over the streaming round.

    Host-side object: the queue, counters, and the K decision live on the
    host; the device (``device``, CUDA unless the caller asks for the CPU)
    runs ``contribute`` (folding one upload) and ``apply`` (completing
    eq. 5). Every device-side shape — params, accumulator, the (k_max,)
    v-buffer, the (max_staleness,) update-norm ring — is independent of
    the current K.

    This is the in-process implementation of ``AggregatorService``
    (``offer`` / ``pull`` / ``snapshot``); the socket path wraps it
    without subclassing (transport/server.py).

    **Thread-safety contract (DESIGN.md §12).** One internal lock
    (``self._lock``) guards every piece of state shared between admission
    and folding: the ingress queue, ``version``, ``params``, counters,
    and the arrival estimator. Under it:

    * ``offer`` / ``pull`` / ``snapshot`` are safe to call from ANY
      thread (the transport's per-connection workers call them
      concurrently);
    * ``pump`` must only ever run on ONE thread — the aggregator thread.
      The fold state it owns (``accum``, ``v_buf``, ``count``,
      ``busy_until``, the tracer round bookkeeping) is single-owner by
      design: folding stays on one thread so eq. 5's accumulation order
      is the arrival order, deterministically, and the fold thread alone
      may update ``accum`` and ``v_buf`` in place. ``pump`` takes the
      lock per fold iteration (not for its whole run), so admission
      stays live while a long round folds.

    Tensors are mutable where the JAX package's arrays are not, so the
    contract has one more rule: ``pull`` hands out a reference that the
    caller serialises outside the lock, and ``apply`` therefore REBINDS
    ``self.params`` to new tensors under the lock and never writes into
    tensors a ``pull`` may have handed out.

    The sim path (serve_stream) is single-threaded and pays only the
    uncontended-lock cost.
    """

    def __init__(self, loss_fn: Callable, init_params: Any, fl: FLConfig,
                 cfg: ServeConfig = ServeConfig(),
                 registry: Optional[MetricsRegistry] = None,
                 tracer: Optional[Tracer] = None,
                 device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        if cfg.k_min < 1 or cfg.k_max < cfg.k_min:
            raise ValueError(f"need 1 <= k_min <= k_max, got "
                             f"[{cfg.k_min}, {cfg.k_max}]")
        if cfg.queue_capacity < 1:
            raise ValueError("queue_capacity must be >= 1")
        self.fl = fl
        self.cfg = cfg
        self._body = make_streaming_round_body(loss_fn, fl)

        dev = self.device
        acc_dtype = getattr(torch, fl.accum_dtype)
        self.params = tree_map(
            lambda v: torch.as_tensor(v).to(dev, copy=True), init_params)
        self.accum = tree_map(
            lambda x: torch.zeros(x.shape, dtype=acc_dtype, device=dev),
            self.params)
        self.v_buf = torch.zeros((cfg.k_max,), dtype=torch.float32,
                                 device=dev)
        self.update_norm_ring = torch.zeros((fl.max_staleness,),
                                            dtype=torch.float32, device=dev)
        self.count = 0  # uploads folded into the open round
        self.version = 0  # global rounds applied
        self.k = int(np.clip(fl.buffer_size, cfg.k_min, cfg.k_max))

        self.queue: Deque[Upload] = collections.deque()
        self.busy_until = 0.0  # service-model clock (sim-time)
        # the single lock of the thread-safety contract (class docstring)
        self._lock = threading.RLock()
        # transport hook: called as fold_hook(upload, tau) right after an
        # upload folds — the fold JOURNAL the loopback parity replay
        # consumes (launch/serve_fl.py --journal-out). None = disabled.
        self.fold_hook: Optional[Callable[[Upload, int], None]] = None
        # private registry by default: two controllers in one process must
        # not alias series (pass a shared registry to aggregate instead)
        self.registry = registry if registry is not None else MetricsRegistry()
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self._counters = {
            "admitted": self.registry.counter("serve_admitted_total"),
            "rejected_queue_full": self.registry.counter(
                "serve_rejected_total", reason="queue_full"),
            "dropped_stale_ingress": self.registry.counter(
                "serve_dropped_total", reason="stale_ingress"),
            "dropped_stale_queue": self.registry.counter(
                "serve_dropped_total", reason="stale_queue"),
            "folded": self.registry.counter("serve_folded_total"),
            "rounds": self.registry.counter("serve_rounds_total"),
        }
        self._queue_depth = self.registry.gauge("serve_queue_depth")
        self._k_gauge = self.registry.gauge("serve_k")
        self._k_gauge.set(self.k)
        # compressed-ring config (DESIGN.md §11): the streaming path's
        # eq. 3 state is the (max_staleness,) SCALAR update-norm ring —
        # O(R) bytes independent of model size, so the codec changes
        # nothing here; the active codec + ring bytes are exported as
        # registry series so serving telemetry stays comparable with
        # engine runs of the same FLConfig
        self.ring_codec = fl.ring_codec
        self.registry.gauge("serve_update_norm_ring_bytes",
                            codec=fl.ring_codec).set(
            float(self.update_norm_ring.nbytes))
        self._latency_hist = self.registry.histogram(
            "serve_round_latency_seconds")
        self._round_wall_open: Optional[float] = None  # tracer clock
        self.round_latencies: List[float] = []
        self.round_times: List[float] = []  # apply completion times
        self.k_history: List[Tuple[int, int]] = [(0, self.k)]
        self.queue_depth_max = 0
        self._round_open_at: Optional[float] = None
        self._interarrival: Optional[float] = None
        self._last_arrival: Optional[float] = None

    @property
    def counters(self) -> Dict[str, int]:
        """The historical counter dict, now a VIEW of the obs registry —
        same keys, same values (tests/test_torch_serving.py)."""
        return {k: int(c.value) for k, c in self._counters.items()}

    # -- admission control ---------------------------------------------
    def staleness(self, upload: Upload) -> int:
        return self.version - upload.base_version

    def _evict_stale(self) -> None:
        """Drop-oldest: head entries whose base outgrew the version ring."""
        while self.queue and self.staleness(self.queue[0]) > \
                self.fl.max_staleness:
            self.queue.popleft()
            self._counters["dropped_stale_queue"].inc()

    def _retry_after(self) -> float:
        """Backoff hint: the time to drain the current queue at the modeled
        service rate — floored so zero-cost services still spread retries,
        and CLAMPED to ``retry_after_max`` so a deep queue never advertises
        an unbounded sleep to a wall-clock client (Admission docstring)."""
        return min(self.cfg.retry_after_max,
                   max(self.cfg.retry_after_min,
                       len(self.queue) * self.cfg.service_time))

    def offer(self, upload: Upload, now: float) -> Admission:
        """Admit one upload into the bounded ingress queue.

        Safe from any thread (AggregatorService contract)."""
        with self._lock:
            self._evict_stale()
            if self.staleness(upload) > self.fl.max_staleness:
                self._counters["dropped_stale_ingress"].inc()
                return Admission(False, DROP_MAX_STALENESS, 0.0)
            if len(self.queue) >= self.cfg.queue_capacity:
                self._counters["rejected_queue_full"].inc()
                return Admission(False, REJECT_QUEUE_FULL,
                                 self._retry_after())
            self.queue.append(upload)
            self._counters["admitted"].inc()
            self._queue_depth.set(len(self.queue))
            self.queue_depth_max = max(self.queue_depth_max, len(self.queue))
            self._observe_arrival(now)
            return Admission(True, ADMITTED, 0.0)

    def pull(self) -> Tuple[int, Any]:
        """``(version, params)`` of the CURRENT served model — the model-
        pull RPC of AggregatorService. Safe from any thread; the pair is
        read atomically under the lock so a client never sees version N
        with version N-1's params."""
        with self._lock:
            return self.version, self.params

    def snapshot(self) -> Dict[str, Any]:
        """AggregatorService telemetry: ``metrics()`` read under the lock."""
        with self._lock:
            return self.metrics()

    def _observe_arrival(self, now: float) -> None:
        if self._last_arrival is not None:
            gap = max(now - self._last_arrival, 1e-9)
            a = self.cfg.arrival_ewma
            self._interarrival = (gap if self._interarrival is None
                                  else (1.0 - a) * self._interarrival + a * gap)
        self._last_arrival = now

    def arrival_rate(self) -> float:
        """EWMA admitted uploads per sim-second (0 before two arrivals)."""
        return 0.0 if not self._interarrival else 1.0 / self._interarrival

    # -- service + aggregation -----------------------------------------
    def pump(self, now: float) -> int:
        """Fold queued uploads whose service completes by ``now``; run the
        eq. 5 apply whenever the open round reaches K. Returns the number
        of rounds applied.

        Single-owner: only the aggregator thread may call this (class
        docstring). The lock is taken per fold so concurrent ``offer``
        calls interleave between folds rather than stalling for a round.
        """
        rounds = 0
        while True:
            with self._lock:
                if self.count >= self.k:  # also catches K adapted downward
                    self._apply_round(max(self.busy_until, now))
                    rounds += 1
                    continue
                if not self.queue:
                    break
                done = max(self.busy_until,
                           now if self.cfg.service_time == 0.0
                           else self.queue[0].sent_at) + self.cfg.service_time
                if self.cfg.service_time > 0.0 and done > now:
                    break  # the server is still busy; leave the rest queued
                upload = self.queue.popleft()
                tau = self.staleness(upload)
                if tau > self.fl.max_staleness:  # out-aged while queued
                    self._counters["dropped_stale_queue"].inc()
                    continue
                with self.tracer.span(SPAN_CONTRIBUTE,
                                      client=upload.client_id, tau=tau):
                    self._contribute(upload, tau)
                self.busy_until = done
                if self.count == 0:
                    self._round_open_at = upload.sent_at
                    if self._round_wall_open is None:  # first-ever round
                        self._round_wall_open = self.tracer.now()
                self.count += 1
                self._counters["folded"].inc()
                if self.fold_hook is not None:
                    self.fold_hook(upload, tau)
        with self._lock:
            self._queue_depth.set(len(self.queue))
        return rounds

    def _contribute(self, upload: Upload, tau: int) -> None:
        """Fold one upload: its batches go to the device here. The
        accumulator and the v-buffer belong to the fold thread alone and
        are updated in place."""
        dev = self.device
        accum, v, _ = self._body.contribute(
            self.params, self.accum, self.update_norm_ring,
            tree_to_device(upload.batch, dev),
            tree_to_device(upload.probe, dev),
            torch.tensor(upload.data_size, dtype=torch.float32, device=dev),
            tau)
        self.accum = accum
        self.v_buf[self.count] = v

    def _apply_round(self, t_done: float) -> None:
        # the whole collect window is one retroactive span. It opens when
        # the PREVIOUS apply finished (the server is collecting from that
        # instant, even before the first fold lands), so collect_window +
        # apply spans tile the full round wall-time — the property the
        # trace-coverage acceptance gate (>= 95%) checks.
        apply_start = self.tracer.now()
        if self._round_wall_open is not None:
            self.tracer.complete(SPAN_COLLECT, self._round_wall_open,
                                 apply_start - self._round_wall_open,
                                 version=self.version, k=self.count)
        with self.tracer.span(SPAN_APPLY, version=self.version,
                              k=self.count):
            # rebinds self.params to new tensors (class docstring)
            self.params, self.update_norm_ring = self._body.apply(
                self.params, self.accum, self.v_buf, self.count,
                self.update_norm_ring)
            # the accumulator reset is part of completing the round: keep
            # it inside the apply span so spans tile the round wall-time
            for a in tree_leaves(self.accum):
                a.zero_()
            self.v_buf.zero_()
        self.count = 0
        self.version += 1
        self._counters["rounds"].inc()
        open_at = self._round_open_at if self._round_open_at is not None \
            else t_done
        # clamped: over a live transport an upload can land DURING the
        # pump loop with sent_at later than the loop's ``now`` — the true
        # latency is sub-poll-interval, not negative
        lat = max(0.0, t_done - open_at)
        self.round_latencies.append(lat)
        self._latency_hist.observe(lat)
        self.round_times.append(t_done)
        self._round_open_at = None
        self._round_wall_open = self.tracer.now()  # next window opens now
        if self.cfg.adapt_every and \
                self._counters["rounds"].value % self.cfg.adapt_every == 0:
            self._adapt_k()

    def _adapt_k(self) -> None:
        """Damped proportional step toward K* = lambda_hat * target."""
        lam = self.arrival_rate()
        if lam <= 0.0:
            return
        k_star = lam * self.cfg.target_round_latency
        g = self.cfg.adapt_gain
        new_k = int(np.clip(round((1.0 - g) * self.k + g * k_star),
                            self.cfg.k_min, self.cfg.k_max))
        if new_k != self.k:
            self.k = new_k
            self._k_gauge.set(new_k)
            self.k_history.append((self.version, self.k))

    # -- telemetry -------------------------------------------------------
    def metrics(self) -> Dict[str, Any]:
        lat = sorted(self.round_latencies)

        def pct(p: float) -> float:
            if not lat:
                return float("nan")
            return lat[min(len(lat) - 1, int(p * len(lat)))]

        cadence = (np.diff(self.round_times).tolist()
                   if len(self.round_times) > 1 else [])
        return {
            **self.counters,
            "k": self.k,
            "k_history": list(self.k_history),
            "version": self.version,
            "arrival_rate": self.arrival_rate(),
            "round_latency_p50": pct(0.50),
            "round_latency_p99": pct(0.99),
            "round_cadence_mean": (float(np.mean(cadence)) if cadence
                                   else float("nan")),
            "queue_depth_now": len(self.queue),
            "queue_depth_max": self.queue_depth_max,
        }


def serve_stream(controller: ServingController, gen,
                 *, max_rounds: Optional[int] = None,
                 max_events: Optional[int] = None,
                 max_time: Optional[float] = None,
                 round_hook: Optional[Callable[[int], None]] = None
                 ) -> Dict[str, Any]:
    """Drive the controller from a continuous arrival stream.

    ``gen`` is a ``sim.arrivals.TrafficGenerator`` (or anything with its
    ``pop`` / ``realize`` / ``settle`` protocol). Events are consumed in
    global (time, client) order until one of the bounds trips; the final
    partial buffer is left unapplied (a service has no "end of run").
    ``round_hook(version)`` fires once per applied round — the periodic
    metrics flush / windowed-profiler hook serve_fl installs. Returns
    ``controller.metrics()`` plus the event/time bookkeeping.
    """
    if max_rounds is None and max_events is None and max_time is None:
        raise ValueError("need at least one of max_rounds / max_events / "
                         "max_time")
    events = 0
    now = 0.0
    while not gen.empty():
        if max_rounds is not None and controller.version >= max_rounds:
            break
        if max_events is not None and events >= max_events:
            break
        t, cid = gen.pop()
        if max_time is not None and t > max_time:
            break
        now = t
        events += 1
        upload = gen.realize(cid, t, controller.version)
        if upload is None:  # lost in transit (scenario dropout)
            continue
        adm = controller.offer(upload, t)
        before = controller.version
        controller.pump(t)
        if round_hook is not None:
            for v in range(before + 1, controller.version + 1):
                round_hook(v)
        gen.settle(cid, t, adm, controller.version, upload)
    out = controller.metrics()
    out["events"] = events
    out["sim_time"] = now
    out["lost_in_transit"] = gen.lost
    out["retries_scheduled"] = gen.retries
    return out
