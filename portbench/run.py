"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Finds the cell in ``BENCHMARK.json`` and everything it names by name
(``harness/bench.py``), makes the weights and the traffic from the seed,
warms up, measures for ``--seconds`` and checks what the timed path
produced against the plain reference (``reference/``). The last line of
standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device``, with ``--trace 1`` a
``breakdown``, and last ``checks``: each number compared with its limit,
also printed as the last lines of standard error.

Exits non-zero and prints no result without a CUDA card, or when JAX,
Flax or the JAX package is loaded in this process after the window.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# a full-width round fills most of the card in blocks of a few GiB: the
# allocator's expandable segments keep its cache from fragmenting (read at
# the first CUDA allocation, so set before torch starts)
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
os.environ["USE_FLAX"] = "0"
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the benchmark must not load,
    compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


class Context:
    """What a driver gets: the cell, the run's arguments and the device."""

    def __init__(self, cell, seed: int, seconds: float, trace: bool,
                 device: str, t_start: float):
        self.cell, self.seed, self.seconds = cell, seed, seconds
        self.trace, self.device, self.t_start = trace, device, t_start
        self.config, self.mix, self.limits = cell.config, cell.mix, cell.limits


def device_info(torch, device: str, peak: int) -> dict:
    if device == "cpu":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1, "memory_peak_bytes": peak}


def execute(cell, seed: int, seconds: float, trace: bool, device: str,
            t_start: float) -> dict:
    """Run the cell once; return the result object (not printed)."""
    import torch

    out = cell.driver().run(Context(cell, seed, seconds, trace, device,
                                    t_start))
    checks = {name: {"value": v, "limit": lim}
              for name, (v, lim) in out["checks"].items()}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values()) and out["failed"] == 0
    metrics = {}
    if trace:
        facts = out["facts"]
        for entry, reader in cell.readers():
            value = reader.read(facts)
            if value is not None:
                metrics[entry["name"]] = {"value": value,
                                          "unit": entry["unit"]}
    else:
        for entry in cell.end_to_end:
            metrics[entry["name"]] = {"value": out["e2e"][entry["name"]],
                                      "unit": entry["unit"]}
    dev = device_info(torch, device, out["memory_peak_bytes"])
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": dev}
    if trace and out.get("capture") is not None:
        cap = out["capture"]
        dev["busy_s"], dev["window_s"] = cap.busy_s, cap.window_s
        result["breakdown"] = cap.breakdown()
    result["checks"] = checks
    return result


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from portbench.harness.bench import Cell

    cell = Cell(args.workload)
    import torch

    need = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"portbench: {args.workload} needs {need} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = execute(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                     T_START)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: loaded in this process: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
