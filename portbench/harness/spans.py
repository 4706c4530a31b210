"""The program's own spans over cohort rounds (``repro_torch.obs.trace``),
reduced to what a per-layer reader reads.

``measure`` steps the caller's state on through a step built with an
enabled tracer, in two passes of ``rounds`` rounds each:

(a) no profiler, a sync before each step call (as ``host_enqueue_ms.train``
    times a call): host ms a round in each span, and device ms a round
    between the CUDA events of the spans in ``device_spans``;
(b) a device-only ``torch.profiler`` capture, rounds back to back: each
    idle gap between the merged device intervals is put down to the
    spans that cover its middle on the host. The profiler's events and
    the tracer's edges are both Unix-epoch ns, so the host's side of the
    profile, which slows a host-bound loop, is not recorded.

The readers (``host_ms``, ``device_ms``, ``idle_ms``) take the facts
``measure`` returns and give None where there is nothing to read.
"""
from __future__ import annotations

import bisect
import time
from typing import Callable, Dict, List, Sequence, Tuple

import torch

NO_SPAN = "host (no span)"


def merge(intervals: Sequence[Tuple[int, int]]) -> List[List[int]]:
    """The union of ``(start, end)`` intervals, as sorted disjoint ones."""
    merged: List[List[int]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def attribute_idle(device: Sequence[Tuple[int, int]],
                   spans: Sequence[Tuple[str, int, int]]) -> Dict:
    """Idle ns between the merged ``device`` intervals, put down by the
    middle of each gap to the ``spans`` (name, start, end) covering it:
    ``inside`` adds a gap once to every name that covers it, ``innermost``
    to the shortest covering span alone (``NO_SPAN`` if none does)."""
    spans = sorted(spans, key=lambda s: s[1])
    starts = [s[1] for s in spans]
    longest = max((b - a for _, a, b in spans), default=0)
    inside: Dict[str, int] = {}
    innermost: Dict[str, int] = {}
    total = 0
    merged = merge(device)
    for (_, end), (start, _) in zip(merged, merged[1:]):
        gap, mid = start - end, (start + end) / 2
        total += gap
        lo = bisect.bisect_left(starts, mid - longest)
        hi = bisect.bisect_right(starts, mid)
        cover = [s for s in spans[lo:hi] if s[2] >= mid]
        for name in {s[0] for s in cover}:
            inside[name] = inside.get(name, 0) + gap
        best = min(cover, key=lambda s: s[2] - s[1])[0] if cover else NO_SPAN
        innermost[best] = innermost.get(best, 0) + gap
    return {"idle_ns": total, "inside": inside, "innermost": innermost}


def measure(run_round: Callable[[], None], tracer, rounds: int) -> Dict:
    """Pass (a) then pass (b), ``rounds`` calls of ``run_round`` each;
    ``run_round`` steps the caller's state one round through a step built
    with ``tracer`` (which records device edges for the names in
    ``tracer.device_spans``). The caller keeps no other reference to a
    state meanwhile: at the cells' widths one more cohort state pushes the
    caching allocator into retries. Returns the facts: per span name, host
    ns and device ms over pass (a), idle ns over pass (b), the rounds, and
    the host seconds of each step call in pass (a)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    first = len(tracer.edges)
    calls = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t = time.perf_counter()
        run_round()
        calls.append(time.perf_counter() - t)
    tracer.read_device()
    host_ns: Dict[str, int] = {}
    dev_ms: Dict[str, float] = {}
    for e in tracer.edges[first:]:
        host_ns[e.name] = host_ns.get(e.name, 0) + e.end_ns - e.start_ns
        if e.device_ms is not None:
            dev_ms[e.name] = dev_ms.get(e.name, 0.0) + e.device_ms

    second = len(tracer.edges)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(rounds):
            run_round()
        torch.cuda.synchronize()
    device = [(e.start_ns(), e.end_ns())
              for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA]
    tracer.read_device()
    idle = attribute_idle(device, [(e.name, e.start_ns, e.end_ns)
                                   for e in tracer.edges[second:]])
    return {"rounds": rounds, "host_ns": host_ns, "device_ms": dev_ms,
            "step_call_s": calls, **idle}


def host_ms(facts: Dict, name: str):
    """Host ms a round in the spans ``name``, pass (a)."""
    spans = facts.get("spans")
    if not spans or name not in spans["host_ns"]:
        return None
    return spans["host_ns"][name] * 1e-6 / spans["rounds"]


def device_ms(facts: Dict, *names: str):
    """Device ms a round between the edges of the spans ``names``."""
    spans = facts.get("spans")
    if not spans or not any(n in spans["device_ms"] for n in names):
        return None
    return sum(spans["device_ms"].get(n, 0.0) for n in names) \
        / spans["rounds"]


def idle_ms(facts: Dict, name: str):
    """Device idle ms a round in gaps inside a ``name`` span, pass (b)."""
    spans = facts.get("spans")
    if not spans or not spans["idle_ns"]:
        return None
    return spans["inside"].get(name, 0) * 1e-6 / spans["rounds"]
