"""Population scale: the device event machine against the host walk.

The counterpart of the JAX package's ``benchmarks/bench_population_scale.py``
for the port. Events only, no training: for each population size N it runs
``collect_windows`` (``paper-fig1``, K = 64, max_staleness 8, 50 windows,
seed 0) on a cold population (statics and initial state included), one
warm-up run and then the median of three timed runs, and prints
events per second, the host's reads per window
(``engine_host_syncs_total``) and, on the card, the peak device memory.
The peak is read above what was allocated when the run began, so it is
the event machine's own. Then the host event walk (``host_walk_windows``
over the PCG64 ``ClientBehavior``: N generator pairs, a heap pop, a
duration draw and a reschedule per event) at N = 1e3 and 1e4, and the
device's speedup over it where both ran.

    python -m repro_torch.launch.population_scale [--device cuda|cpu]
        [--sizes 10000 100000 1000000] [--windows 50]

Times are host-clock seconds around work that ends in a synchronise. The
last line of standard output is the records as one JSON object.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time
from typing import Dict, List, Optional, Sequence

import torch

from repro_torch.configs.base import FLConfig
from repro_torch.obs import MetricsRegistry
from repro_torch.sim.population import collect_windows, host_walk_windows
from repro_torch.sim.scenarios import ClientBehavior, get_scenario
from repro_torch.utils.device import resolve_device

SCENARIO = "paper-fig1"  # heterogeneous speeds, no drops
WINDOWS = 50
BUFFER_K = 64
MAX_STALENESS = 8
SEED = 0
SIZES = (10_000, 100_000, 1_000_000)
HOST_SIZES = (1_000, 10_000)
REPEATS = 3


def _fl(n: int) -> FLConfig:
    return FLConfig(num_clients=n, buffer_size=BUFFER_K, local_steps=1,
                    local_lr=0.05, batch_size=8,
                    max_staleness=MAX_STALENESS)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def device_record(n: int, windows: int, dev: torch.device) -> Dict:
    """Median of ``REPEATS`` cold-population runs of ``collect_windows``;
    ``peak_device_bytes`` is the peak above what was live at its start."""
    sc = get_scenario(SCENARIO)
    collect_windows(sc, n, _fl(n), windows, seed=SEED, device=dev,
                    registry=MetricsRegistry())  # warm-up
    times, events, syncs, base = [], 0, 0.0, 0
    if dev.type == "cuda":
        _sync(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
    for _ in range(REPEATS):
        reg = MetricsRegistry()
        _sync(dev)
        t0 = time.perf_counter()
        out = collect_windows(sc, n, _fl(n), windows, seed=SEED, device=dev,
                              registry=reg)
        _sync(dev)
        times.append(time.perf_counter() - t0)
        events = out["num_events"]
        syncs = reg.snapshot()["engine_host_syncs_total"]
    dt = statistics.median(times)
    return {"n": n, "events": int(events), "seconds": dt,
            "events_per_s": events / dt,
            "host_reads_per_window": syncs / windows,
            "peak_device_bytes": (torch.cuda.max_memory_allocated(dev) - base
                                  if dev.type == "cuda" else None)}


def host_record(n: int, windows: int) -> Dict:
    """One cold host walk: behavior construction, schedule and walk."""
    t0 = time.perf_counter()
    behavior = ClientBehavior(get_scenario(SCENARIO), n, seed=SEED)
    out = host_walk_windows(behavior, _fl(n), windows)
    dt = time.perf_counter() - t0
    return {"n": n, "events": int(out["num_events"]), "seconds": dt,
            "events_per_s": out["num_events"] / dt}


def run(device="cuda", sizes: Sequence[int] = SIZES,
        windows: int = WINDOWS) -> Dict:
    dev = resolve_device(device)
    records: Dict = {"device": [], "host": [], "speedup": {},
                     "torch_device": (torch.cuda.get_device_name(dev)
                                      if dev.type == "cuda" else "cpu"),
                     "scenario": SCENARIO, "windows": windows,
                     "buffer_k": BUFFER_K}
    for n in sizes:
        rec = device_record(n, windows, dev)
        records["device"].append(rec)
        mem = ("not measured" if rec["peak_device_bytes"] is None
               else f"{rec['peak_device_bytes'] / 2 ** 20:.1f} MiB")
        print(f"  {dev.type} N={n:>9,}: {rec['events_per_s']:>12,.1f} "
              f"events/s ({rec['events']} events, {rec['seconds']:.4f} s), "
              f"{rec['host_reads_per_window']:.2f} host reads/window, "
              f"peak device memory {mem}")
    for n in HOST_SIZES:
        rec = host_record(n, windows)
        records["host"].append(rec)
        print(f"  host walk N={n:>9,}: {rec['events_per_s']:>12,.1f} "
              f"events/s ({rec['events']} events, {rec['seconds']:.4f} s)")
    dev_rate = {r["n"]: r["events_per_s"] for r in records["device"]}
    for rec in records["host"]:
        if rec["n"] in dev_rate:
            records["speedup"][rec["n"]] = dev_rate[rec["n"]] / \
                rec["events_per_s"]
            print(f"  speedup over the host walk at N={rec['n']:,}: "
                  f"{records['speedup'][rec['n']]:.2f}x")
    return records


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--sizes", type=int, nargs="+", default=list(SIZES))
    ap.add_argument("--windows", type=int, default=WINDOWS)
    args = ap.parse_args(argv)
    records = run(args.device, args.sizes, args.windows)
    print(json.dumps(records))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
