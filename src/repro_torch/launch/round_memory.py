"""Where the device memory of one cohort training round goes.

Runs ``launch/train.py``'s ``TrainLoop`` for an arch at full width at two
or more depths on the card. At each depth one warm-up round runs, then one
round with ``torch.cuda.memory``'s allocation history on. The history's
allocations and frees are replayed to find the round's peak, and the
blocks live there are grouped by the line of the port that allocated them
(the innermost frame under ``repro_torch``), with what was live before the
round (the cohort state) as a group of its own. The growth of each group
between two depths, over the params a layer adds, is its bytes a
parameter; their sum is the peak's growth a layer.

Example (on the card; prints a table and writes the JSON record):
  PYTHONPATH=src python -m repro_torch.launch.round_memory \\
      --arch hymba-1.5b --layers 2 3 --cohort 4 --out chiprun_out/mem.json
"""
from __future__ import annotations

import argparse
import json
from collections import defaultdict
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

# the round's shape: chip_smoke.py's training run (b sequences of S tokens,
# M local steps, a buffer of K), so its peaks read against that run's
BATCH, SEQ, LOCAL_STEPS, BUFFER_K = 1, 2048, 2, 3
TOP = 12  # sites printed a depth

STATE = "live before the round (cohort state, model)"
OTHER = "outside repro_torch"


def site(frames: Sequence[Dict[str, Any]]) -> str:
    """The innermost frame of the port that led to an allocation."""
    for f in frames:
        name = f.get("filename", "")
        if "repro_torch" in name:
            rel = name[name.rindex("repro_torch"):]
            return f"{rel}:{f.get('line')} ({f.get('name')})"
    return OTHER


def live_at_peak(events: Iterable[Dict[str, Any]], base: int
                 ) -> Tuple[int, Dict[str, int], Dict[str, Dict[int, int]]]:
    """Replay an allocator trace. ``base`` bytes were live when it began.
    Returns (peak bytes, bytes live at the peak by allocation site, the
    count of live blocks by site and size); the blocks from before the
    trace count under ``STATE``."""
    live: Dict[int, Tuple[int, str]] = {}
    pre_freed = 0
    total = peak = base
    at_peak: Dict[str, int] = {STATE: base}
    blocks: Dict[str, Dict[int, int]] = {}
    for ev in events:
        action = ev.get("action")
        if action == "alloc":
            live[ev["addr"]] = (ev["size"], site(ev.get("frames", ())))
            total += ev["size"]
            if total > peak:
                peak = total
                at_peak = defaultdict(int)
                at_peak[STATE] = base - pre_freed
                blocks = defaultdict(lambda: defaultdict(int))
                for size, where in live.values():
                    at_peak[where] += size
                    blocks[where][size] += 1
        elif action in ("free_requested", "free_completed"):
            hit = live.pop(ev["addr"], None)
            if hit is not None:
                total -= hit[0]
            elif action == "free_requested":  # a block from before
                pre_freed += ev["size"]
                total -= ev["size"]
    return peak, dict(at_peak), {k: dict(v) for k, v in blocks.items()}


def measure(arch: str, layers: int, cohort: int, device: str = "cuda"
            ) -> Dict[str, Any]:
    """One depth: params, the round's peak above what was live before the
    cohort state was made, and the bytes live at the peak by site."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.configs.base import FLConfig
    from repro_torch.launch.train import TrainLoop

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    floor = torch.cuda.memory_allocated()
    fl = FLConfig(buffer_size=BUFFER_K, local_steps=LOCAL_STEPS,
                  local_lr=5e-3, weighting="paper", server_pass_mode="fused")
    cfg = get_arch(arch).model.replace(num_layers=layers)
    loop = TrainLoop(cfg, fl, cohort=cohort, batch=BATCH, seq=SEQ, rounds=2,
                     seed=0, device=device)
    n_params = loop.model.param_count(loop.state.global_params)
    loop.round(0)  # warm-up
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated() - floor
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.memory._record_memory_history(max_entries=2_000_000,
                                             stacks="python")
    try:
        loop.round(1)
        torch.cuda.synchronize()
        snap = torch.cuda.memory._snapshot()
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    peak_stat = torch.cuda.max_memory_allocated() - floor
    dev = torch.device(device).index or 0
    peak, sites, blocks = live_at_peak(snap["device_traces"][dev], base)
    del loop, snap
    torch.cuda.empty_cache()
    return dict(layers=layers, params=n_params, base=base, peak=peak,
                peak_stat=peak_stat, sites=sites, blocks=blocks)


def per_param(a: Dict[str, Any], b: Dict[str, Any]) -> Dict[str, Any]:
    """Growth from depth a to depth b, over the params the layers add."""
    dp = b["params"] - a["params"]
    sites = set(a["sites"]) | set(b["sites"])
    grow = {s: (b["sites"].get(s, 0) - a["sites"].get(s, 0)) / dp
            for s in sites}
    return dict(params_a_layer=dp / (b["layers"] - a["layers"]),
                bytes_per_param=(b["peak"] - a["peak"]) / dp,
                stat_bytes_per_param=(b["peak_stat"] - a["peak_stat"]) / dp,
                sites=dict(sorted(grow.items(), key=lambda kv: -kv[1])))


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="hymba-1.5b")
    ap.add_argument("--layers", type=int, nargs="+", default=[2, 3])
    ap.add_argument("--cohort", type=int, default=4)
    ap.add_argument("--out", default=None, help="JSON record path")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("round_memory reads the card's allocator: it "
                           "needs a CUDA device")
    runs: List[Dict[str, Any]] = []
    for n in args.layers:
        r = measure(args.arch, n, args.cohort)
        runs.append(r)
        print(f"{args.arch} {n} layers, C={args.cohort}: {r['params']:,d} "
              f"params; live before the round {r['base'] / 2**30:.2f} GiB, "
              f"peak {r['peak'] / 2**30:.2f} GiB (allocator's peak "
              f"{r['peak_stat'] / 2**30:.2f} GiB)")
        for s, nbytes in sorted(r["sites"].items(),
                                key=lambda kv: -kv[1])[:TOP]:
            sizes = sorted(r["blocks"].get(s, {}).items(),
                           key=lambda kv: -kv[0] * kv[1])[:4]
            print(f"  {nbytes / 2**30:8.3f} GiB  {nbytes / r['params']:7.2f} "
                  f"B/param  {s}; largest blocks "
                  + ", ".join(f"{n} x {size:,d} B" for size, n in sizes))
    growth = [per_param(a, b) for a, b in zip(runs, runs[1:])]
    for (a, b), g in zip(zip(runs, runs[1:]), growth):
        print(f"{a['layers']} -> {b['layers']} layers: "
              f"{g['params_a_layer']:,.0f} params a layer, the peak grows "
              f"{g['bytes_per_param']:.2f} B a parameter (allocator's peak "
              f"{g['stat_bytes_per_param']:.2f}); by site:")
        for s, bpp in list(g["sites"].items())[:TOP]:
            if abs(bpp) >= 0.05:
                print(f"  {bpp:7.2f} B/param  {s}")
    out = dict(arch=args.arch, cohort=args.cohort, seq=SEQ, batch=BATCH,
               runs=runs, growth=growth)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
