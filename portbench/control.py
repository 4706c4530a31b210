"""Readings that set a cell's limits: the program's numbers on many seeds,
and the control's (the reference in float8 in the program's place) and a
planted fault's on a few, in one process.

    python3 portbench/control.py --workload <cell> --seeds 1 2 3 \\
        [--kinds program,fp8,half] [--seconds 1] [--out FILE]

For each seed it runs the cell as ``run.py`` does (``program``: the
program against the reference), then, against that same reference,
``fp8``: the reference in float8 e4m3 (``reference/numerics.py``), and
``half``: the reference with half of each batch left out (training: each
sequence's first half, the mean over it; prefill: the first sequence's
answer given for every sequence). One JSON line a seed and kind. The
benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

import portbench.run as bench_run  # noqa: E402  (sets the allocator first)


def control_readings(cell, ctx, out: dict, kind: str) -> dict:
    from portbench.harness import compare
    from portbench.reference.numerics import Numerics

    driver = cell.driver()
    num = Numerics("fp8" if kind == "fp8" else "f32")
    detail = out["detail"]
    if cell.mix["driver"] == "cohort_round":
        got = driver.run_reference(ctx, num, half_batch=(kind == "half"))
        vals = driver.readings(got, detail["ref"])
        vals["norms"] = norms_of(got)
        return vals
    pick, want = detail["pick"], detail["want"]
    if kind == "half":
        got = driver.reference_logits(ctx, pick, num)
        b = cell.mix["batch"]
        got = got.reshape(-1, b, got.shape[-1])[:, :1].expand(
            -1, b, -1).reshape(-1, got.shape[-1])
    else:
        got = driver.reference_logits(ctx, pick, num)
    return {"logit_gap": compare.logit_gap(got, want)}


def norms_of(got: dict) -> dict:
    """Per-leaf norms, for readings worked out again later."""
    return {k: {".".join(map(str, p)): v for p, v in got[k].items()}
            for k in ("update", "change")}


def worst_leaves(out: dict) -> dict:
    """The leaf that sets each norm gap of a training run."""
    from portbench.harness import compare

    d = out["detail"]
    if "prog" not in d:
        return {}
    return {k: compare.worst_leaf(d["prog"][k], d["ref"][k])
            for k in ("update", "change")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--kinds", default="program,fp8,half")
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    from portbench.harness.bench import Cell

    import torch

    cell = Cell(args.workload)
    kinds = args.kinds.split(",")
    sink = open(args.out, "a") if args.out else None
    for seed in args.seeds:
        t = time.perf_counter()
        ctx = bench_run.Context(cell, seed, args.seconds, False, args.device,
                                t)
        out = cell.driver().run(ctx)
        if "prog" in out["detail"]:
            d = out["detail"]
            vals = cell.driver().readings(d["prog"], d["ref"])
            vals["norms"] = norms_of(d["prog"])
            vals["ref_norms"] = norms_of(d["ref"])
        else:
            vals = {k: v for k, (v, _) in out["checks"].items()}
        rows = [("program", vals)]
        for kind in kinds:
            if kind != "program":
                rows.append((kind, control_readings(cell, ctx, out, kind)))
        for kind, vals in rows:
            if kind not in kinds:
                continue
            line = {"workload": args.workload, "seed": seed, "kind": kind,
                    "readings": vals, "e2e": out["e2e"],
                    "worst": worst_leaves(out) if kind == "program" else None,
                    "seconds": time.perf_counter() - t}
            if args.device != "cpu":
                line["card"] = torch.cuda.get_device_name(0)
            print(json.dumps(line), flush=True)
            if sink:
                sink.write(json.dumps(line) + "\n")
                sink.flush()
        del out
    return 0


if __name__ == "__main__":
    sys.exit(main())
