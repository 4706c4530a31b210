"""K5 and its backward against an earlier checkout's, on one card.

Unpack the earlier tree's package into a place ``.gitignore`` lists and
name it:

    git archive <commit> src/repro_torch | tar -x -C build/base
    python -m repro_torch.launch.k5_compare --base-src build/base/src

Each side runs in a process of its own (both packages are named
``repro_torch``), importing the tree it is given, building its kernels
there and timing, through its public wrappers, on the same seeded bf16
inputs:

- K5's forward (``flash_attention``) at the serving path's shape (Hymba-1.5B
  prefill: B 2, S 4096, 25 / 5 heads of 64, window 1024) and causal;
- K5's backward (``flash_attention_bwd``, fed the forward's output, and its
  lse where the wrapper takes one) at the training run's shape (B 4, S 2048,
  window 1024) and at deepseek-moe-16b's (B 2, S 4096, 16 / 16 heads of 128,
  causal).

Per case: ``call``, the median of 30 single calls, one CUDA event pair
each (the host's dispatch counts, as in ``chip_smoke.py``); ``burst``, 20
back-to-back calls between two events, per call. The sides run in the order
base, new, new, base, base, new: a call's time moves with the host's
dispatch, which varies from process to process. Prints the card's name and
power limit first, then each run's readings and each side's medians, and
one JSON object of every reading last.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

# (what, B, S, H, Hkv, D, window)
CASES = (("forward", 2, 4096, 25, 5, 64, 1024), ("forward", 2, 4096, 25, 5, 64, 0),
         ("backward", 4, 2048, 25, 5, 64, 1024),
         ("backward", 2, 4096, 16, 16, 128, 0))
ORDER = ("base", "new", "new", "base", "base", "new")


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

    from repro_torch.kernels.flash_attn import kernel, ops

    libraries = (kernel.LIBRARY, kernel.BWD_LIBRARY)
    with ThreadPoolExecutor(len(libraries)) as pool:  # one nvcc each, together
        list(pool.map(lambda lib: lib.build(), libraries))
    with_lse = hasattr(ops, "flash_attention_lse")
    out = {}
    for what, b, s, h, hkv, d, window in CASES:
        g = torch.Generator(device="cuda").manual_seed(s + h + d + window)
        q, k, v, do = (torch.randn(b, s, n, d, device="cuda", generator=g)
                       .to(torch.bfloat16) for n in (h, hkv, hkv, h))
        if what == "forward":
            def fn():
                return ops.flash_attention(q, k, v, window=window)
        elif with_lse:
            o, lse = ops.flash_attention_lse(q, k, v, window=window)

            def fn():
                return ops.flash_attention_bwd(q, k, v, o, do, lse,
                                               window=window)
        else:
            o = ops.flash_attention(q, k, v, window=window)

            def fn():
                return ops.flash_attention_bwd(q, k, v, o, do, window=window)
        out[f"{what} B{b} S{s} H{h}/{hkv} D{d} window {window}"] = \
            _time(torch, fn)
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
        print("k5_compare: needs a CUDA device", file=sys.stderr)
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
