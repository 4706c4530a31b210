"""K6's backward against an earlier checkout's, on one card.

Unpack the earlier tree's package into a place ``.gitignore`` lists and
name it:

    git archive <commit> src/repro_torch | tar -x -C build/base
    python -m repro_torch.launch.k6_compare --base-src build/base/src

Each side runs in a process of its own (both packages are named
``repro_torch``), importing the tree it is given, building its backward
library there and timing ``selective_scan_bwd`` through its public wrapper
on the same seeded f32 inputs, at Hymba-1.5B's widths (di 3200, N 16) and
the shapes of ``chip_smoke.py``'s ``SCAN_BWD_CASES``: the training round's
(B 4 = 4 slots x 1 sequence, S 2048, an A per slot), B 2, S 4096 with a
shared and a per-row A, and a ragged S (B 2, S 1001, shared A).

Per case: ``call``, the median of 30 single calls, one CUDA event pair
each (the host's dispatch counts, as in ``chip_smoke.py``); ``burst``, 20
back-to-back calls between two events, per call; "call" minus "burst" is
about the host's dispatch of one call, which a burst hides behind the
kernels. The sides run in the order base, new, new, base. Prints the card's
name and power limit first, then each run's readings and each side's
medians, and one JSON object of every reading last.

Self-contained, as ``k5_compare.py``: the worker runs against the earlier
tree, which has none of the helpers a later tree adds.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

DI, N = 3200, 16
CASES = ((4, 2048, 4), (2, 4096, 0), (2, 4096, 2), (2, 1001, 0))  # (B, S, A groups)
ORDER = ("base", "new", "new", "base")


def _time(torch, fn, calls: int = 30, burst: int = 20):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(True), torch.cuda.Event(True)
    times = []
    for _ in range(calls):
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    start.record()
    for _ in range(burst):
        fn()
    end.record()
    torch.cuda.synchronize()
    return {"call": times[len(times) // 2],
            "burst": start.elapsed_time(end) / burst}


def worker() -> dict:
    """Time the ``repro_torch`` on this process's path."""
    import torch

    from repro_torch.kernels.ssm_scan import kernel, ops

    kernel.BWD_LIBRARY.build()
    out = {}
    for b, s, groups in CASES:
        g = torch.Generator(device="cuda").manual_seed(b + s + groups)
        x = torch.randn(b, s, DI, device="cuda", generator=g)
        dt = torch.nn.functional.softplus(
            torch.randn(b, s, DI, device="cuda", generator=g) - 1.0)
        bb, c = (torch.randn(b, s, N, device="cuda", generator=g)
                 for _ in range(2))
        a = -torch.exp(0.5 * torch.randn(*((groups,) if groups else ()), DI,
                                         N, device="cuda", generator=g))
        dy = torch.randn(b, s, DI, device="cuda", generator=g)

        def fn():
            return ops.selective_scan_bwd(x, dt, bb, c, a, dy)

        a_name = f"per {b // groups} rows" if groups else "shared"
        out[f"B{b} S{s} di{DI} N{N} A {a_name}"] = _time(torch, fn)
        del x, dt, bb, c, a, dy
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base-src", type=Path,
                    help="the earlier checkout's src directory")
    ap.add_argument("--worker", action="store_true",
                    help="time the package on PYTHONPATH and print JSON")
    args = ap.parse_args(argv)
    if args.worker:
        print(json.dumps(worker()))
        return 0
    if args.base_src is None:
        ap.error("--base-src is required")
    import torch

    if not torch.cuda.is_available():
        print("k6_compare: needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    new_src = Path(__file__).resolve().parents[2]
    trees = {"base": args.base_src.resolve(), "new": new_src}
    readings = {"base": [], "new": []}
    for side in ORDER:
        proc = subprocess.run(  # -P: this file's directory stays off the path
            [sys.executable, "-P", str(Path(__file__).resolve()), "--worker"],
            env=dict(os.environ, PYTHONPATH=str(trees[side])),
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{side} worker exited {proc.returncode}:\n"
                               f"{proc.stderr[-3000:]}")
        run = json.loads(proc.stdout.strip().splitlines()[-1])
        readings[side].append(run)
        for case, r in run.items():
            print(f"{side:4s} {case}: call {r['call']:.4f} ms, burst "
                  f"{r['burst']:.4f} ms", flush=True)
    for case in readings["new"][0]:
        print(case + ": median of the runs, call / burst ms: " + "; ".join(
            f"{side} {statistics.median(r[case]['call'] for r in runs):.4f} / "
            f"{statistics.median(r[case]['burst'] for r in runs):.4f}"
            for side, runs in readings.items()))
    print(json.dumps(readings))
    return 0


if __name__ == "__main__":
    sys.exit(main())
