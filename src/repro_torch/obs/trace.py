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

Overhead contract: a disabled tracer (``Tracer(enabled=False)``, or the
module ``NULL_TRACER``) returns one shared no-op context manager from
``span`` — no allocation, no clock read — so instrumented code paths
cost nothing when tracing is off.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional

SPAN_COLLECT = "collect_window"
SPAN_CONTRIBUTE = "contribute"
SPAN_APPLY = "apply"
SPAN_HOST_SYNC = "host_sync"
SPAN_CHECKPOINT = "checkpoint"
SPAN_TRANSPORT_DECODE = "transport_decode"
SPAN_TRANSPORT_OFFER = "transport_offer"
SPAN_NAMES = (SPAN_COLLECT, SPAN_CONTRIBUTE, SPAN_APPLY, SPAN_HOST_SYNC,
              SPAN_CHECKPOINT, SPAN_TRANSPORT_DECODE, SPAN_TRANSPORT_OFFER)


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


class _Span:
    __slots__ = ("tracer", "name", "cat", "args", "t0", "ann")

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
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        if self.ann is not None:
            self.ann.__exit__(*exc)
        self.tracer.complete(self.name, self.t0, t1 - self.t0,
                             cat=self.cat, **self.args)
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
                 tid: int = 0):
        self.enabled = enabled
        self.annotate = annotate and enabled
        self.tid = tid
        self.events: List[Dict[str, Any]] = []
        self.pid = os.getpid()
        self._t0 = time.perf_counter()

    # -- recording ------------------------------------------------------
    def span(self, name: str, cat: str = "round", **args):
        """Context manager timing one phase; no-op when disabled."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, cat, args)

    def now(self) -> float:
        """The tracer clock (perf_counter seconds) for retroactive events."""
        return time.perf_counter()

    def complete(self, name: str, t_start: float, duration: float,
                 cat: str = "round", **args) -> None:
        """Record a span retroactively from explicit clock readings —
        how the serving loop emits ``collect_window`` (its extent is only
        known once the K-th fold lands)."""
        if not self.enabled:
            return
        self.events.append({
            "name": name, "cat": cat, "ph": "X",
            "ts": (t_start - self._t0) * 1e6, "dur": duration * 1e6,
            "pid": self.pid, "tid": self.tid,
            **({"args": args} if args else {})})

    def instant(self, name: str, cat: str = "round", **args) -> None:
        if not self.enabled:
            return
        self.events.append({
            "name": name, "cat": cat, "ph": "i", "s": "p",
            "ts": (time.perf_counter() - self._t0) * 1e6,
            "pid": self.pid, "tid": self.tid,
            **({"args": args} if args else {})})

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
