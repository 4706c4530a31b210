"""A ``torch.profiler`` capture of a traced window, reduced to what the
per-layer metrics read: device time by operation name, the device's busy
seconds (the union of its operations' intervals), and the idle gaps
between them named by what the host was doing at the time.

Nothing is written to disk: the capture's events are read in memory.
"""
from __future__ import annotations

import bisect
import time
from typing import Callable, Dict, List, Tuple

import torch

TOP = 10


class Capture:
    """The reduced capture. ``ops``: name -> (count, device seconds);
    ``busy_s``: union of device intervals; ``window_s``: host wall time of
    the traced window; ``gaps``: host op name -> idle seconds."""

    def __init__(self, ops: Dict[str, Tuple[int, float]], busy_s: float,
                 window_s: float, gaps: Dict[str, float], units: int):
        self.ops, self.busy_s, self.window_s = ops, busy_s, window_s
        self.gaps, self.units = gaps, units

    def device_s(self, *parts: str) -> float:
        """Device seconds of the operations whose name holds any of
        ``parts``."""
        return sum(sec for name, (_, sec) in self.ops.items()
                   if any(p in name for p in parts))

    def breakdown(self) -> Dict[str, List[List]]:
        ops = sorted(self.ops.items(), key=lambda kv: -kv[1][1])[:TOP]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[n, s] for n, (_, s) in ops],
                "idle_gaps": [[n, s] for n, s in gaps]}


def _is_device(evt) -> bool:
    from torch.autograd import DeviceType
    return evt.device_type == DeviceType.CUDA


def reduce_events(device: List[Tuple[str, float, float]],
                  host: List[Tuple[str, float, float]], window_s: float,
                  units: int) -> Capture:
    """``device`` and ``host`` events as (name, start us, end us)."""
    ops: Dict[str, Tuple[int, float]] = {}
    for name, a, b in device:
        n, sec = ops.get(name, (0, 0.0))
        ops[name] = (n + 1, sec + (b - a) * 1e-6)
    spans = sorted((a, b) for _, a, b in device)
    merged: List[List[float]] = []
    for a, b in spans:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged) * 1e-6
    # host ops by start; a gap is named by the innermost host op that
    # covers its middle
    host = sorted(host, key=lambda e: e[1])
    starts = [e[1] for e in host]
    gaps: Dict[str, float] = {}
    for (_, end), (start, _) in zip(merged, merged[1:]):
        mid = 0.5 * (end + start)
        best, best_len = "host (no op recorded)", float("inf")
        i = bisect.bisect_right(starts, mid)
        for name, a, b in reversed(host[max(0, i - 2000):i]):
            if b >= mid and b - a < best_len:
                best, best_len = name, b - a
        gaps[best] = gaps.get(best, 0.0) + (start - end) * 1e-6
    return Capture(ops, busy, window_s, gaps, units)


def capture(run_units: Callable[[], int], with_host: bool = False
            ) -> Capture:
    """Profile ``run_units`` (which runs the traced units, synchronises,
    and returns how many it ran). By default only the device's activity
    is recorded, which costs the host little; ``with_host`` records the
    host's operations too, which the idle gaps are named by (and which
    slows a host-bound loop, so its busy share reads low)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if with_host
                                      else [])
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        units = run_units()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    device, host = [], []
    for evt in prof.events():
        rec = (evt.name, evt.time_range.start, evt.time_range.end)
        (device if _is_device(evt) else host).append(rec)
    return reduce_events(device, host, window_s, units)


def traced_window(run_units: Callable[[int], int], units: int) -> Capture:
    """The per-layer metrics' capture: ``units`` units with the device's
    activity alone, then one more with the host's too, whose idle gaps,
    named by host operation, replace the first capture's."""
    cap = capture(lambda: run_units(units))
    if not cap.ops:  # this profiler keeps no device records alone
        cap = capture(lambda: run_units(units), with_host=True)
    named = capture(lambda: run_units(1), with_host=True)
    cap.gaps = named.gaps
    return cap
