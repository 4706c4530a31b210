"""Driver of the ``prefill_layered`` mixes: serving prefill of a model whose
layers differ (Jamba: Mamba-1 and attention mixers, MLP and MoE FFNs by a
layer period), as a closed loop with one client.

It follows ``drivers/prefill.py`` step for step (set-up, warm-up, the
window of ``Model.prefill_logits`` calls each waited for, the traced
requests, the check of ``checked_requests`` answers after the program's
state is freed) and returns the same result, so ``run.py`` and
``control.py`` take it unchanged. It differs where the model does:

* the configuration file holds transformers' ``JambaConfig`` keys (the
  catalog's), built into the port's config by
  ``repro_torch.configs.jamba2_mini.config_from_dict``: a program without
  it fails at once, before any weight is made;
* the reference is ``reference/jamba.py``, and it runs the program's
  routing: each checked request is served once more after the window
  (the program is deterministic) with ``repro_torch.models.moe.route_share``
  watched, and the reference runs the expert ids the program chose, with
  its own gates. ``logit_gap`` then holds the program's numerics, which a
  bf16 router tipping a near-tie the other way would otherwise swamp (the
  f32 reference's own routing differs from the program's in 2-10% of a
  layer's tokens and sets most of the gap), and ``route_flip_share``, the
  largest share of a MoE layer's tokens whose choices differ from the
  reference router's own on the same input, holds its routing;
* the facts come from ``flops/jamba.py``: model FLOPs with the held share
  of the experts, K5's bound over the attention layers and K6's over the
  Mamba layers;
* with ``--trace 1`` the profiled requests are followed by
  ``traced_requests`` more under an active tracer whose spans
  ``ssm_mixer``, ``attn_mixer`` and ``moe_ffn`` record CUDA events at
  their edges (the program's layered stack opens them): device ms a request
  in each, as ``facts["spans"]`` in ``harness/spans.py``'s form;
* the counters ``moe.pairs_held`` / ``moe.pairs_absent`` of the program's
  metrics registry, read once after the window, are printed with the
  allocator's counts.
"""
from __future__ import annotations

import gc
import sys
import time

import numpy as np
import torch

from portbench.drivers.prefill import make_pool
from portbench.flops import jamba as jamba_flops
from portbench.harness import compare, weights
from portbench.harness.device import allocator_note, sync
from portbench.harness.peaks import flops_peak
from portbench.harness.trace import traced_window
from portbench.reference import jamba as ref_jamba
from portbench.reference.numerics import Numerics

SPANS = ("ssm_mixer", "attn_mixer", "moe_ffn")
COUNTERS = ("moe.pairs_held", "moe.pairs_absent")


def model_config(cfg):
    from repro_torch.configs.jamba2_mini import config_from_dict

    return config_from_dict(cfg, name=cfg.get("name", "jamba"))


def counters() -> dict:
    from repro_torch.obs.metrics import default_registry

    reg = default_registry()
    return {name: reg.counter(name).value for name in COUNTERS}


def run(ctx) -> dict:
    from repro_torch.models.model import build_model

    cfg, mix, dev = ctx.config, ctx.mix, ctx.device
    mcfg = model_config(cfg)
    model = build_model(mcfg, dev)
    params = weights.make_weights(build_model(mcfg, "meta").init(None),
                                  ctx.seed, torch.device(dev))
    pool = make_pool({"vocab_size": cfg["vocab_size"]}, mix, ctx.seed, dev)

    def serve(i: int) -> torch.Tensor:
        out = model.prefill_logits(params, {"tokens": pool[i % len(pool)]})
        return out[:, -1].float()

    with torch.no_grad():
        serve(0)  # warm-up
        gc.collect()
        if dev != "cpu":
            torch.cuda.empty_cache()
        serve(1)  # maps again the memory a request holds
        sync(dev)
        if dev != "cpu":
            torch.cuda.reset_peak_memory_stats()
        before = counters()
        t0 = time.perf_counter()
        setup_s = t0 - ctx.t_start
        answers, latencies = [], []
        n = 0
        while time.perf_counter() - t0 < ctx.seconds or n == 0:
            t = time.perf_counter()
            answers.append(serve(n))
            sync(dev)
            latencies.append(time.perf_counter() - t)
            n += 1
        window_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() if dev != "cpu" else 0
        pairs = {k: v - before[k] for k, v in counters().items()}
        if dev != "cpu":
            allocator_note(n, "requests", window_s)
        print("portbench: MoE pairs over the window: %d held, %d absent"
              % (pairs["moe.pairs_held"], pairs["moe.pairs_absent"]),
              file=sys.stderr)

        cap, spans = None, None
        if ctx.trace and dev != "cpu":
            def traced(units: int) -> int:
                for i in range(units):
                    serve(n + i)
                    sync(dev)
                return units

            cap = traced_window(traced, mix["traced_requests"])
            spans = span_facts(serve, n, mix["traced_requests"])

    # the answers to check, drawn from the seed, their routing, then the
    # reference
    rng = np.random.default_rng([ctx.seed, 3])
    pick = sorted(rng.choice(n, size=min(n, mix["checked_requests"]),
                             replace=False).tolist())
    got = torch.cat([answers[i] for i in pick]).cpu()
    with torch.no_grad():
        routes = program_routes(serve, pick, answers)
    del model, params, answers
    gc.collect()
    if dev != "cpu":
        torch.cuda.empty_cache()
    flips = []
    want = reference_logits(ctx, pick, Numerics("f32"), routes, flips)
    for side, t in (("program", got), ("reference", want)):
        if not bool(torch.isfinite(t).all()):
            print(f"portbench: the {side}'s logits of requests {pick} are "
                  "not all finite", file=sys.stderr)
    checks = {"logit_gap": (compare.logit_gap(got, want),
                            ctx.limits["logit_gap"]),
              "route_flip_share": (max(flips, default=0.0),
                                   ctx.limits["route_flip_share"])}
    tokens = mix["batch"] * mix["seq"]
    facts = None
    if ctx.trace:
        facts = prefill_facts(ctx, cap, window_s / n)
        facts["spans"] = spans
    return {"e2e": {"prefill_tokens_per_s": n * tokens / window_s,
                    "peak_gib": peak / 2 ** 30, "setup_s": setup_s},
            "checks": checks, "attempted": n, "failed": 0,
            "memory_peak_bytes": peak, "capture": cap, "facts": facts,
            "detail": {"requests": n, "window_s": window_s, "pick": pick,
                       "got": got, "want": want, "pairs": pairs,
                       "flips": flips,
                       "latency_max_s": max(latencies)}}


def span_facts(serve, start: int, units: int):
    """Device ms of each span name over ``units`` requests under an active
    tracer with CUDA events at those spans' edges (None where the program
    opens none of them)."""
    from repro_torch.obs.trace import Tracer

    tracer = Tracer(annotate=False, device_spans=SPANS)
    with tracer.activate():
        for i in range(units):
            serve(start + i)
    tracer.read_device()
    host_ns, dev_ms = {}, {}
    for e in tracer.edges:
        host_ns[e.name] = host_ns.get(e.name, 0) + e.end_ns - e.start_ns
        if e.device_ms is not None:
            dev_ms[e.name] = dev_ms.get(e.name, 0.0) + e.device_ms
    if not dev_ms:
        return None
    return {"rounds": units, "host_ns": host_ns, "device_ms": dev_ms}


def program_routes(serve, pick, answers):
    """The program's expert ids for each picked request: per MoE layer,
    (B * S, k) on the CPU, read through ``repro_torch.models.moe.route_share``
    as the request is served again."""
    from repro_torch.models import moe

    real = moe.route_share
    routes = []
    for i in pick:
        ids = []

        def watched(cfg, p, xf):
            out = real(cfg, p, xf)
            ids.append(out[2].cpu())
            return out

        moe.route_share = watched
        try:
            again = serve(i)
        finally:
            moe.route_share = real
        if not torch.equal(again, answers[i]):
            print(f"portbench: request {i} served again gave other logits; "
                  "its routing may not be the checked answer's",
                  file=sys.stderr)
        routes.append(ids)
    return routes


@torch.no_grad()
def reference_logits(ctx, pick, num: Numerics, routes=None,
                     flips=None) -> torch.Tensor:
    """The reference's last-position logits of the picked requests; with
    ``routes`` (``program_routes``'), running those choices and appending
    each MoE layer's flip share to ``flips``."""
    from repro_torch.models.model import build_model  # the layout only

    cfg, mix, dev = ctx.config, ctx.mix, ctx.device
    layout = build_model(model_config(cfg), "meta").init(None)
    params = weights.make_weights(layout, ctx.seed, torch.device(dev))
    if num.kind != "f32":
        params = _stored(params, num)
    pool = make_pool({"vocab_size": cfg["vocab_size"]}, mix, ctx.seed, dev)
    rows = [ref_jamba.last_logits(
        cfg, params, pool[i % len(pool)], num,
        None if routes is None else routes[j], flips).cpu()
        for j, i in enumerate(pick)]
    return torch.cat(rows)


def _stored(tree, num: Numerics, stacked: bool = False):
    """Each parameter written back to its storage dtype through ``num``, in
    place, one matrix (or vector) at a time: a stacked leaf is a stack of
    tensors, one a layer (and an expert), each under its own scale; a
    whole stack at once would take several copies of it in f32."""
    if isinstance(tree, dict):
        for key, val in tree.items():
            _stored(val, num, stacked or key == "layers")
        return tree
    if stacked or tree.dim() > 2:
        for i in range(tree.shape[0]):
            _stored(tree[i], num)
    else:
        tree.copy_(num.store(tree, tree.dtype))
    return tree


def prefill_facts(ctx, cap, unit_wall_s: float) -> dict:
    cfg, mix = ctx.config, ctx.mix
    card = torch.cuda.get_device_name(0)
    return {"capture": cap, "units": cap.units if cap else 0,
            "unit_wall_s": unit_wall_s,
            "flops_per_unit": jamba_flops.prefill_request(cfg, mix),
            "peak_flops": flops_peak(card, "bfloat16"),
            "kernel_bounds": jamba_flops.kernel_bounds(cfg, mix, card)}
