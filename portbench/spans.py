"""The program's spans in a training cell, and what tracing costs, on the
card, in one process.

    python3 portbench/spans.py --workload hymba-train-c4-s2048 \\
        --seeds 1 2 3 [--rounds 6] [--out FILE]

For each seed it sets the cell up as ``drivers/cohort_round.py`` does
(weights and inputs from the seed, the checked rounds as warm-up, the
allocator's cache emptied and one more round), then steps the same state
on, ``--rounds`` rounds at a time, each step call timed on the host after
a sync (``host_enqueue_ms.train``'s way): untraced; traced with no device
edges; with edges on the MoE spans; with edges on every span; untraced
again; with the allocator's retries counted in each. Last,
``harness/spans.py``'s two passes of the mix's ``traced_rounds`` with
edges on the MoE spans, the numbers a reader of them gives, and how many
spans of each name were entered off the main thread (the autograd
engine's). One JSON line a seed, on standard output and appended to
``--out``. The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import threading
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

import portbench.run as bench_run  # noqa: E402,F401  (sets the allocator)

PHASES = ("local_train", "probe", "server_pass", "resync")
MOE = ("moe_dispatch", "moe_combine")


def one_seed(cell, seed: int, rounds: int) -> dict:
    import gc
    import time

    import torch

    from portbench.drivers import cohort_round as cr
    from portbench.harness import spans, weights
    from portbench.harness.model import model_config
    from repro_torch.core.cohort import init_cohort_state, make_cohort_step
    from repro_torch.models.model import build_model
    from repro_torch.obs import COHORT_SPAN_NAMES, Tracer

    cfg, mix, dev = cell.config, cell.mix, "cuda"
    mcfg = model_config(cfg, layers=cfg.get("train_layers")
                        or cfg["num_layers"])
    model = build_model(mcfg, dev)
    # the state lives in the box alone: a second reference to a cohort
    # state at these widths pushes the allocator into retries
    box = [init_cohort_state(weights.make_weights(
        build_model(mcfg, "meta").init(None), seed, torch.device(dev)),
        mix["cohort"])]
    pool, sched, sizes = cr.make_inputs(cfg, mix, seed, dev)
    sched, sizes = torch.as_tensor(sched).to(dev), torch.as_tensor(
        sizes).to(dev)
    r = [0]

    def run_round(step):
        box[0], _ = step(box[0], cr.round_batch(pool, sched, sizes, r[0]))
        r[0] += 1

    def timed_calls(step, n: int):
        calls = []
        for _ in range(n):
            torch.cuda.synchronize()
            t = time.perf_counter()
            run_round(step)
            calls.append(1e3 * (time.perf_counter() - t))
        torch.cuda.synchronize()
        return calls

    def make_step(tracer=None):
        kw = {} if tracer is None else {"tracer": tracer}
        return make_cohort_step(model.loss, cr.fl_config(mix), device=dev,
                                **kw)

    def retries():
        return torch.cuda.memory_stats().get("num_alloc_retries", 0)

    plain = make_step()
    timed_calls(plain, mix["checked_rounds"])
    gc.collect()
    torch.cuda.empty_cache()
    timed_calls(plain, 1)
    out = {"workload": cell.name, "seed": seed, "rounds": rounds,
           "device": torch.cuda.get_device_name(0), "enqueue_ms": {},
           "alloc_retries": {}}
    configs = (("off", None), ("on", ()), ("on_moe_edges", MOE),
               ("on_all_edges", COHORT_SPAN_NAMES), ("off_again", None))
    for name, edges in configs:
        step = plain if edges is None else make_step(
            Tracer(annotate=False, device_spans=edges))
        before = retries()
        out["enqueue_ms"][name] = timed_calls(step, rounds)
        out["alloc_retries"][name] = retries() - before

    rounds = mix["traced_rounds"]
    tracer = Tracer(annotate=False, device_spans=MOE)
    step = make_step(tracer)
    before = retries()
    facts = spans.measure(lambda: run_round(step), tracer, rounds)
    out["alloc_retries"]["measure"] = retries() - before
    f = {"spans": facts}
    out["metrics"] = {
        "local_train_host_ms.train": spans.host_ms(f, "local_train"),
        "probe_host_ms.train": spans.host_ms(f, "probe"),
        "server_pass_host_ms.train": spans.host_ms(f, "server_pass"),
        "local_train_idle_ms.train": spans.idle_ms(f, "local_train"),
        "moe_dispatch_device_ms.train": spans.device_ms(f, *MOE)}
    step_ms = spans.host_ms(f, "cohort_step")
    off = out["enqueue_ms"]["off"] + out["enqueue_ms"]["off_again"]
    out["checks"] = {
        "cohort_step_over_enqueue": step_ms / statistics.median(off),
        "phases_cover_step": sum(spans.host_ms(f, n) or 0.0
                                 for n in PHASES) / step_ms,
        "idle_in_a_span": (1.0 - facts["innermost"].get(spans.NO_SPAN, 0)
                           / facts["idle_ns"]) if facts["idle_ns"] else None}
    out["host_ms"] = {n: spans.host_ms(f, n) for n in facts["host_ns"]}
    out["device_ms"] = {n: v / rounds for n, v in facts["device_ms"].items()}
    out["idle_ms"] = {"total": facts["idle_ns"] * 1e-6 / rounds,
                      "inside": {n: v * 1e-6 / rounds
                                 for n, v in facts["inside"].items()},
                      "innermost": {n: v * 1e-6 / rounds
                                    for n, v in facts["innermost"].items()}}
    out["pass_a_call_ms"] = [1e3 * c for c in facts["step_call_s"]]
    main = threading.get_native_id()
    out["spans_off_the_main_thread"] = {
        n: sum(e.name == n and e.thread != main for e in tracer.edges)
        for n in facts["host_ns"]}
    box.clear()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import gc

    import torch

    from portbench.harness.bench import Cell

    if not torch.cuda.is_available():
        print("portbench/spans.py needs a CUDA card", file=sys.stderr)
        return 2
    cell = Cell(args.workload)
    for seed in args.seeds:
        line = json.dumps(one_seed(cell, seed, args.rounds))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
