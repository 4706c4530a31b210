"""Driver of the ``prefill`` mixes: serving prefill as a closed loop with
one client.

Set-up builds the program's model over weights the benchmark makes from
the seed and a pool of requests (B sequences of S tokens each, the copy of
the LM token stream) on the device, and serves the first request once to
warm its shapes up. The window calls ``Model.prefill_logits`` back to back,
each call waited for, until ``--seconds`` have passed; each request's
last-position logits are kept on the device. The rate is all prompt tokens
of the window over the time to its last completion.

With ``--trace 1`` the window is followed by ``traced_requests`` requests
under ``torch.profiler`` recording the device alone, and one more recording
the host too, which names the idle gaps.

Once the window has closed and the peak is read, the program's state is
freed, ``checked_requests`` requests of the window, drawn from the seed,
are computed again by the reference (``reference/lm.py``), and their
logits are compared.
"""
from __future__ import annotations

import gc
import sys
import time

import numpy as np
import torch

from portbench.flops import lm as lm_flops
from portbench.harness import compare, traffic, weights
from portbench.harness.device import allocator_note, sync
from portbench.harness.model import model_config
from portbench.harness.peaks import flops_peak
from portbench.harness.trace import traced_window
from portbench.reference import lm as ref_lm
from portbench.reference.numerics import Numerics
from portbench.rooflines import bound_s
from portbench.rooflines import kernels as rk


def make_pool(cfg, mix, seed: int, device: str):
    """``pool_requests`` requests of (B, S) int32 tokens on the device."""
    rng = np.random.default_rng([seed, 2])
    n, b, s = mix["pool_requests"], mix["batch"], mix["seq"]
    toks = traffic.lm_token_stream(cfg["vocab_size"], s, n * b,
                                   seed=int(rng.integers(1 << 30)))
    toks = torch.as_tensor(toks[:, :s].reshape(n, b, s)).to(device)
    return [toks[i] for i in range(n)]


def run(ctx) -> dict:
    from repro_torch.models.model import build_model

    cfg, mix, dev = ctx.config, ctx.mix, ctx.device
    mcfg = model_config(cfg)
    model = build_model(mcfg, dev)
    params = weights.make_weights(build_model(mcfg, "meta").init(None),
                                  ctx.seed, torch.device(dev))
    pool = make_pool(cfg, mix, ctx.seed, dev)

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
        if dev != "cpu":
            allocator_note(n, "requests", window_s)

        cap = None
        if ctx.trace and dev != "cpu":
            def traced(units: int) -> int:
                for i in range(units):
                    serve(n + i)
                    sync(dev)
                return units

            cap = traced_window(traced, mix["traced_requests"])

    # the answers to check, drawn from the seed, then the reference
    rng = np.random.default_rng([ctx.seed, 3])
    pick = sorted(rng.choice(n, size=min(n, mix["checked_requests"]),
                             replace=False).tolist())
    got = torch.cat([answers[i] for i in pick]).cpu()
    del model, params, answers
    gc.collect()
    if dev != "cpu":
        torch.cuda.empty_cache()
    want = reference_logits(ctx, pick, Numerics("f32"))
    for side, t in (("program", got), ("reference", want)):
        if not bool(torch.isfinite(t).all()):
            print(f"portbench: the {side}'s logits of requests {pick} are "
                  "not all finite", file=sys.stderr)
    checks = {"logit_gap": (compare.logit_gap(got, want),
                            ctx.limits["logit_gap"])}
    tokens = mix["batch"] * mix["seq"]
    facts = prefill_facts(ctx, cap, window_s / n) if ctx.trace else None
    return {"e2e": {"prefill_tokens_per_s": n * tokens / window_s,
                    "peak_gib": peak / 2 ** 30, "setup_s": setup_s},
            "checks": checks, "attempted": n, "failed": 0,
            "memory_peak_bytes": peak, "capture": cap, "facts": facts,
            "detail": {"requests": n, "window_s": window_s, "pick": pick,
                       "got": got, "want": want,
                       "latency_max_s": max(latencies)}}


@torch.no_grad()
def reference_logits(ctx, pick, num: Numerics) -> torch.Tensor:
    """The reference's last-position logits of the picked requests."""
    from repro_torch.models.model import build_model  # the layout only

    cfg, mix, dev = ctx.config, ctx.mix, ctx.device
    layout = build_model(model_config(cfg), "meta").init(None)
    params = weights.make_weights(layout, ctx.seed, torch.device(dev))
    if num.kind != "f32":
        params = _stored(params, num)
    pool = make_pool(cfg, mix, ctx.seed, dev)
    rows = [ref_lm.last_logits(cfg, params, pool[i % len(pool)], num).cpu()
            for i in pick]
    return torch.cat(rows)


def _stored(tree, num: Numerics):
    if isinstance(tree, dict):
        return {k: _stored(v, num) for k, v in tree.items()}
    return num.store(tree, tree.dtype)


def prefill_facts(ctx, cap, unit_wall_s: float) -> dict:
    cfg, mix = ctx.config, ctx.mix
    card = torch.cuda.get_device_name(0)
    layers = cfg["num_layers"]
    b, s = mix["batch"], mix["seq"]
    h, hkv = cfg["num_heads"], cfg["num_kv_heads"]
    hd = cfg.get("head_dim") or cfg["d_model"] // h
    window = cfg.get("attn_window") or 0
    facts = {"capture": cap, "units": cap.units if cap else 0,
             "unit_wall_s": unit_wall_s,
             "flops_per_unit": lm_flops.prefill_request(cfg, layers, mix),
             "peak_flops": flops_peak(card, "bfloat16"),
             "kernel_bounds": {
                 "k5_fwd": layers * bound_s(rk.k5_fwd(b, s, h, hkv, hd,
                                                      window), card)}}
    if cfg.get("ssm_state"):
        di = cfg.get("ssm_expand", 2) * cfg["d_model"]
        facts["kernel_bounds"]["k6_fwd"] = layers * bound_s(
            rk.k6_fwd(b, s, di, cfg["ssm_state"]), card)
    return facts
