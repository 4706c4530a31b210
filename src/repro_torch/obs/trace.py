"""Round-lifecycle span tracing: Chrome-trace JSON + device-profile hooks.

A copy of the JAX package's ``obs/trace.py`` with its profiler hooks
re-pointed to ``torch.profiler``.

``Tracer.span(name)`` times a host-side phase of the round lifecycle and
records it as a Chrome trace event (``ph: "X"`` complete event, micro-
second timestamps) loadable in perfetto / ``chrome://tracing``. The span
taxonomy is fixed (the JAX package's) so traces from every runner line up:

    collect_window   host event-loop window pre-compute / serving wait
    contribute       one streaming fold (serving path)
    apply            the round dispatch (engine chunk / eq. 5)
    host_sync        device -> host fetches (round log, eval metrics)
    checkpoint       state capture + write
    transport_decode wire-frame decode on a transport worker (§12)
    transport_offer  admission call on a transport worker (decode->offer)

Each span also opens a ``torch.profiler.record_function``, so a device
profile collected by ``WindowedProfiler`` (or any ``torch.profiler``
capture) shows host spans on the same timeline as the kernels they
launched.

The training path (``core/cohort.py``, ``core/round_body.py``,
``core/client.py``, ``models/moe.py``; ``COHORT_SPAN_NAMES``) and the
kernel builds (``kernels/cuda_build.py``) add spans of their own;
``SPAN_NAMES`` stays the JAX package's:

    cohort_step      one ``make_cohort_step`` call
      local_train    C slots x M local steps (vmapped forward, backward, SGD)
        local_forward  one local step's forward, inside the grad-ed loss
      probe          the eq. 4 fresh-loss forward
      server_pass    flat vectors, K1 / K2 + K3, eq. 3-5, unflatten
      resync         arrivals' re-sync, versions, the round telemetry
    moe_dispatch     MoE sort, capacity and buffer fill (in any forward)
    moe_combine      MoE gathers and the weighted sum of the k outputs

The layered stack (``models/blocks.py::run_layered_train``,
``LAYER_SPAN_NAMES``) records each layer's mixer and MoE:

    ssm_mixer        a Mamba layer's mixer (``ssm_train``), norm excluded
    attn_mixer       an attention layer's mixer, norm excluded
    moe_ffn          a MoE layer's FFN: router, ``moe_dispatch``, the
                     experts, ``moe_combine``
    kernel_load      a CUDA library's first load in a process
      kernel_build   its nvcc run, when the build was not there

Code below a traced entry point that takes no tracer (the MoE FFN inside
``Model.loss``, the kernel loads) reaches it through ``active_tracer()``,
which ``Tracer.activate`` sets for the length of a call. The slot is one
per process, not per thread, so spans entered on the autograd engine's
device thread (a rematerialised forward inside the backward) are recorded
too.

Clocks: the Chrome events keep ``perf_counter`` microseconds from the
tracer's creation. ``Tracer.edges`` holds every span again with its edges
in Unix-epoch nanoseconds, the clock ``torch.profiler``'s events carry, so
a span and the kernels it launched can be lined up without recording the
host's side of a profile; and, for the names in ``device_spans``, a pair
of CUDA events recorded on the current stream at the span's edges, read
after the traced work by ``read_device`` (one synchronize).

Overhead contract: a disabled tracer (``Tracer(enabled=False)``, or the
module ``NULL_TRACER``) returns one shared no-op context manager from
``span`` and ``activate`` — no allocation, no clock read, no CUDA event —
so instrumented code paths cost nothing when tracing is off.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Collection, Dict, List, Optional

SPAN_COLLECT = "collect_window"
SPAN_CONTRIBUTE = "contribute"
SPAN_APPLY = "apply"
SPAN_HOST_SYNC = "host_sync"
SPAN_CHECKPOINT = "checkpoint"
SPAN_TRANSPORT_DECODE = "transport_decode"
SPAN_TRANSPORT_OFFER = "transport_offer"
SPAN_NAMES = (SPAN_COLLECT, SPAN_CONTRIBUTE, SPAN_APPLY, SPAN_HOST_SYNC,
              SPAN_CHECKPOINT, SPAN_TRANSPORT_DECODE, SPAN_TRANSPORT_OFFER)

SPAN_COHORT_STEP = "cohort_step"
SPAN_LOCAL_TRAIN = "local_train"
SPAN_LOCAL_FORWARD = "local_forward"
SPAN_PROBE = "probe"
SPAN_SERVER_PASS = "server_pass"
SPAN_RESYNC = "resync"
SPAN_MOE_DISPATCH = "moe_dispatch"
SPAN_MOE_COMBINE = "moe_combine"
COHORT_SPAN_NAMES = (SPAN_COHORT_STEP, SPAN_LOCAL_TRAIN, SPAN_LOCAL_FORWARD,
                     SPAN_PROBE, SPAN_SERVER_PASS, SPAN_RESYNC,
                     SPAN_MOE_DISPATCH, SPAN_MOE_COMBINE)
SPAN_SSM_MIXER = "ssm_mixer"
SPAN_ATTN_MIXER = "attn_mixer"
SPAN_MOE_FFN = "moe_ffn"
LAYER_SPAN_NAMES = (SPAN_SSM_MIXER, SPAN_ATTN_MIXER, SPAN_MOE_FFN)
SPAN_KERNEL_LOAD = "kernel_load"
SPAN_KERNEL_BUILD = "kernel_build"


def _annotation(name: str):
    """A ``torch.profiler.record_function`` range named ``name``: it shows
    in a ``torch.profiler`` capture and costs one small host call when no
    capture is active."""
    import torch

    return torch.profiler.record_function(name)


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class SpanEdges:
    """One recorded span on the profiler's clock: ``start_ns`` and
    ``end_ns`` in Unix-epoch nanoseconds (``time.time_ns()``'s domain,
    which ``torch.profiler``'s events carry), ``thread`` the OS id of the
    thread that recorded it, and ``device_ms`` the device time between
    the CUDA events at its edges once ``Tracer.read_device`` has run (None
    for a span without them)."""

    __slots__ = ("name", "thread", "start_ns", "end_ns", "events",
                 "device_ms")

    def __init__(self, name: str, thread: int, start_ns: int, end_ns: int):
        self.name, self.thread = name, thread
        self.start_ns, self.end_ns = start_ns, end_ns
        self.events = None
        self.device_ms: Optional[float] = None


class _Span:
    __slots__ = ("tracer", "name", "cat", "args", "t0", "ann", "events")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 args: Dict[str, Any]):
        self.tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args

    def __enter__(self):
        self.ann = _annotation(self.name) if self.tracer.annotate else None
        if self.ann is not None:
            self.ann.__enter__()
        self.events = None
        if self.name in self.tracer.device_spans:
            import torch

            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        if self.events is not None:
            self.events[1].record()
        if self.ann is not None:
            self.ann.__exit__(*exc)
        edges = self.tracer.complete(self.name, self.t0, t1 - self.t0,
                                     cat=self.cat, **self.args)
        edges.events = self.events
        return False


class _Activation:
    __slots__ = ("tracer", "prev")

    def __init__(self, tracer: "Tracer"):
        self.tracer = tracer

    def __enter__(self):
        global _ACTIVE
        self.prev, _ACTIVE = _ACTIVE, self.tracer
        return self

    def __exit__(self, *exc):
        global _ACTIVE
        _ACTIVE = self.prev
        return False


class Tracer:
    """Collects Chrome trace events; host wall-clock, microsecond units.

    ``t0`` (the first construction instant) anchors the timeline so
    ``ts`` values stay small; every event carries ``pid`` (the OS pid)
    and a
    caller-chosen ``tid`` lane (default 0 — the runners are
    single-threaded host loops, so lanes separate *subsystems*, not
    threads).
    """

    def __init__(self, enabled: bool = True, annotate: bool = True,
                 tid: int = 0, device_spans: Collection[str] = ()):
        self.enabled = enabled
        self.annotate = annotate and enabled
        self.tid = tid
        self.events: List[Dict[str, Any]] = []
        self.edges: List[SpanEdges] = []
        self.pid = os.getpid()
        self.device_spans = frozenset(device_spans if enabled else ())
        if self.device_spans:
            import torch

            if not torch.cuda.is_available():
                raise ValueError("device_spans needs a CUDA device")
        # the epoch clock at the perf_counter origin, read between two
        # perf_counter reads
        self._t0 = time.perf_counter()
        epoch = time.time_ns()
        self._epoch0 = epoch - round((time.perf_counter() - self._t0) * 5e8)

    # -- recording ------------------------------------------------------
    def span(self, name: str, cat: str = "round", **args):
        """Context manager timing one phase; no-op when disabled. A name
        in ``device_spans`` also records a CUDA event at each edge."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, cat, args)

    def activate(self):
        """Context manager making this tracer ``active_tracer()`` until
        it exits (the previous one comes back); no-op when disabled."""
        if not self.enabled:
            return _NULL_SPAN
        return _Activation(self)

    def epoch_ns(self, t: float) -> int:
        """The tracer clock's reading ``t`` (``now()``) in Unix-epoch ns."""
        return self._epoch0 + round((t - self._t0) * 1e9)

    def now(self) -> float:
        """The tracer clock (perf_counter seconds) for retroactive events."""
        return time.perf_counter()

    def complete(self, name: str, t_start: float, duration: float,
                 cat: str = "round", **args) -> Optional[SpanEdges]:
        """Record a span retroactively from explicit clock readings —
        how the serving loop emits ``collect_window`` (its extent is only
        known once the K-th fold lands). Returns its ``edges`` entry."""
        if not self.enabled:
            return None
        self.events.append({
            "name": name, "cat": cat, "ph": "X",
            "ts": (t_start - self._t0) * 1e6, "dur": duration * 1e6,
            "pid": self.pid, "tid": self.tid,
            **({"args": args} if args else {})})
        edges = SpanEdges(name, threading.get_native_id(),
                          self.epoch_ns(t_start),
                          self.epoch_ns(t_start + duration))
        self.edges.append(edges)
        return edges

    def instant(self, name: str, cat: str = "round", **args) -> None:
        if not self.enabled:
            return
        self.events.append({
            "name": name, "cat": cat, "ph": "i", "s": "p",
            "ts": (time.perf_counter() - self._t0) * 1e6,
            "pid": self.pid, "tid": self.tid,
            **({"args": args} if args else {})})

    def read_device(self) -> None:
        """Fill ``device_ms`` of every span recorded with CUDA events and
        not read yet: one synchronize, after the traced work, so nothing
        inside a span waits for the device."""
        pending = [e for e in self.edges if e.events is not None]
        if not pending:
            return
        import torch

        torch.cuda.synchronize()
        for e in pending:
            e.device_ms = e.events[0].elapsed_time(e.events[1])
            e.events = None

    # -- export ---------------------------------------------------------
    def to_json(self) -> Dict[str, Any]:
        return {"traceEvents": list(self.events), "displayTimeUnit": "ms"}

    def write(self, path: str) -> str:
        doc = self.to_json()
        validate_trace(doc)
        with open(path, "w") as f:
            json.dump(doc, f)
        return path


NULL_TRACER = Tracer(enabled=False)
_ACTIVE = NULL_TRACER


def active_tracer() -> Tracer:
    """The tracer of the traced call in progress (``Tracer.activate``),
    else ``NULL_TRACER``."""
    return _ACTIVE


def validate_trace(doc: Dict[str, Any]) -> int:
    """Assert ``doc`` is loadable Chrome-trace-event JSON; returns the
    event count. The schema the CI smoke lane gates serve_fl's
    ``--trace-out`` against: the JSON-object form with a ``traceEvents``
    list where every complete event carries name/ph/ts/pid/tid and a
    non-negative ``dur``."""
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        raise ValueError("trace must be a JSON object with 'traceEvents'")
    events = doc["traceEvents"]
    if not isinstance(events, list):
        raise ValueError("'traceEvents' must be a list")
    for i, ev in enumerate(events):
        for field in ("name", "ph", "ts", "pid", "tid"):
            if field not in ev:
                raise ValueError(f"event {i} missing {field!r}: {ev}")
        if not isinstance(ev["ts"], (int, float)):
            raise ValueError(f"event {i}: non-numeric ts {ev['ts']!r}")
        if ev["ph"] == "X":
            if not isinstance(ev.get("dur"), (int, float)) or ev["dur"] < 0:
                raise ValueError(f"event {i}: complete event needs a "
                                 f"non-negative dur, got {ev.get('dur')!r}")
    return len(events)


def span_coverage(doc: Dict[str, Any], names=(SPAN_COLLECT, SPAN_APPLY),
                  cat: Optional[str] = "round") -> float:
    """Fraction of the round-lifecycle wall-span covered by the union of
    the named spans — the acceptance metric for serve_fl --trace-out
    (>= 0.95). The denominator runs from the first to the last named
    event, i.e. the measured round window, not process startup."""
    ivs = sorted(
        (ev["ts"], ev["ts"] + ev["dur"]) for ev in doc["traceEvents"]
        if ev.get("ph") == "X" and ev["name"] in names
        and (cat is None or ev.get("cat") == cat))
    if not ivs:
        return 0.0
    total = max(hi for _, hi in ivs) - ivs[0][0]
    if total <= 0:
        return 1.0
    covered, cur_lo, cur_hi = 0.0, ivs[0][0], ivs[0][0]
    for lo, hi in ivs:
        if lo > cur_hi:
            covered += cur_hi - cur_lo
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    covered += cur_hi - cur_lo
    return covered / total


class WindowedProfiler:
    """Windowed ``torch.profiler`` capture: a full device profile every
    ``every`` rounds, ``window`` rounds long, exported as a Chrome trace
    to ``profile_dir/round_<n>/trace.json``. Combined with the per-span
    ``record_function`` this lines device timelines up with the host
    spans; windowing keeps always-on services from growing unbounded
    profiles. ``every=0`` disables (the default)."""

    def __init__(self, profile_dir: Optional[str], every: int = 0,
                 window: int = 1):
        if every and window < 1:
            raise ValueError("profiler window must be >= 1 round")
        self.profile_dir = profile_dir
        self.every = every if profile_dir else 0
        self.window = window
        self._active_until: Optional[int] = None
        self._prof = None
        self._path: Optional[str] = None

    def on_round(self, round_idx: int) -> None:
        """Call once per completed round with its index."""
        if not self.every:
            return
        if self._active_until is None and round_idx % self.every == 0:
            from torch.profiler import ProfilerActivity, profile
            import torch

            self._path = os.path.join(self.profile_dir, f"round_{round_idx}")
            os.makedirs(self._path, exist_ok=True)
            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=activities)
            self._prof.start()
            self._active_until = round_idx + self.window
        elif self._active_until is not None \
                and round_idx >= self._active_until:
            self._stop()

    def _stop(self) -> None:
        self._prof.stop()
        self._prof.export_chrome_trace(os.path.join(self._path, "trace.json"))
        self._prof = None
        self._active_until = None

    def close(self) -> None:
        if self._active_until is not None:
            self._stop()
