"""Driver of the ``cohort_round`` mixes: federated LM training, one
contribution-aware cohort round after another, as a closed loop.

Set-up builds the program's model and its cohort step
(``repro_torch.core.cohort.make_cohort_step(model.loss, fl)``) over weights
the benchmark makes from the seed, makes a pool of round batches (the copy
of ``make_batches``), the arrival masks (the copy of ``arrival_schedule``
over ``LatencyModel.heterogeneous``) and the data sizes, all on the
device, and runs the first ``checked_rounds`` rounds on distinct batches
through the same step: they warm every shape up and are what the reference
checks. The same state goes on into the window, which calls the step back
to back until ``--seconds`` have passed (the next round is the server's
next version) and then waits for the last. The rate is all trained tokens
of the window (C M b S a round) over the time to its last completion.

With ``--trace 1`` the window is followed by ``traced_rounds`` rounds whose
host enqueue is timed alone (a sync before each step call), then as many
under ``torch.profiler`` recording the device alone, and one more
recording the host too, which names the idle gaps.

Once the window has closed and the peak is read, the program's state is
freed and the reference (``reference/fl_round.py``) replays the checked
rounds from the same inputs.
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
from portbench.reference import fl_round
from portbench.reference.numerics import Numerics
from portbench.rooflines import bound_s
from portbench.rooflines import kernels as rk


def make_inputs(cfg, mix, seed: int, device: str):
    """The pool of round batches (device tensors), the arrival masks and
    the data sizes, from the seed."""
    rng = np.random.default_rng([seed, 1])
    c = mix["cohort"]
    pool = []
    for _ in range(mix["pool_rounds"]):
        b = traffic.make_batches(cfg["vocab_size"], c, mix["local_steps"],
                                 mix["batch"], mix["probe_batch"], mix["seq"],
                                 rng)
        pool.append({part: {k: torch.as_tensor(v).to(device)
                            for k, v in b[part].items()}
                     for part in ("local", "probe")})
    latency = traffic.LatencyModel.heterogeneous(
        c, max_slowdown=mix["max_slowdown"], seed=seed % (1 << 32))
    sched = traffic.arrival_schedule(c, mix["buffer"], latency,
                                     mix["schedule_rounds"],
                                     seed=seed % (1 << 32))
    lo, hi = mix["data_sizes"]
    sizes = rng.integers(lo, hi, c).astype(np.float32)
    return pool, sched, sizes


def round_batch(pool, sched_dev, sizes_dev, r: int):
    b = dict(pool[r % len(pool)])
    b["arrival"] = sched_dev[r % sched_dev.shape[0]]
    b["data_sizes"] = sizes_dev
    return b


def fl_config(mix):
    from repro_torch.configs.base import FLConfig

    return FLConfig(buffer_size=mix["buffer"], local_steps=mix["local_steps"],
                    local_lr=mix["local_lr"], global_lr=mix["global_lr"],
                    s_min=mix["s_min"], weighting=mix["weighting"],
                    server_pass_mode=mix["server_pass_mode"],
                    ring_codec="f32")


def run(ctx) -> dict:
    from repro_torch.core.cohort import init_cohort_state, make_cohort_step
    from repro_torch.models.model import build_model

    cfg, mix, dev = ctx.config, ctx.mix, ctx.device
    layers = cfg.get("train_layers") or cfg["num_layers"]
    mcfg = model_config(cfg, layers=layers)
    model = build_model(mcfg, dev)
    params = weights.make_weights(build_model(mcfg, "meta").init(None),
                                  ctx.seed, torch.device(dev))
    n_params = weights.param_count(params)
    pool, sched, sizes = make_inputs(cfg, mix, ctx.seed, dev)
    sched_dev = torch.as_tensor(sched).to(dev)
    sizes_dev = torch.as_tensor(sizes).to(dev)
    step = make_cohort_step(model.loss, fl_config(mix), device=dev)
    state = init_cohort_state(params, mix["cohort"])

    # the checked rounds: warm-up, and what the reference replays
    checked = mix["checked_rounds"]
    prog_loss, prog_update = [], None
    for r in range(checked):
        state, met = step(state, round_batch(pool, sched_dev, sizes_dev, r))
        prog_loss.append(float(met["fresh_loss_mean"]))
        if r == 0:
            prog_update = compare.diff_norms(state.global_params, params)
    prog_change = compare.diff_norms(state.global_params, params)
    del params, met
    r = checked

    # the window, from a clean heap and allocator cache (what set-up made
    # and dropped, the weights' draw and the first model, is handed back)
    # and one more round that maps the memory the rounds hold again
    tokens = mix["cohort"] * mix["local_steps"] * mix["batch"] * mix["seq"]
    gc.collect()
    if dev != "cpu":
        torch.cuda.empty_cache()
    state, _ = step(state, round_batch(pool, sched_dev, sizes_dev, r))
    r += 1
    sync(dev)
    if dev != "cpu":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    setup_s = t0 - ctx.t_start
    n, calls = 0, []
    while time.perf_counter() - t0 < ctx.seconds or n == 0:
        t = time.perf_counter()
        state, _ = step(state, round_batch(pool, sched_dev, sizes_dev, r))
        calls.append(time.perf_counter() - t)
        r += 1
        n += 1
    sync(dev)
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if dev != "cpu" else 0
    if dev != "cpu":
        allocator_note(n, "rounds", window_s)
        print("portbench: host seconds a step call in the window: %s"
              % [round(c, 3) for c in calls], file=sys.stderr)

    cap, enqueue = None, []
    if ctx.trace:
        for _ in range(mix["traced_rounds"]):
            sync(dev)
            t = time.perf_counter()
            state, _ = step(state, round_batch(pool, sched_dev, sizes_dev, r))
            enqueue.append(time.perf_counter() - t)
            r += 1
        state_box = [state]

        def traced(units: int) -> int:
            nonlocal r
            for _ in range(units):
                state_box[0], _ = step(state_box[0], round_batch(
                    pool, sched_dev, sizes_dev, r))
                r += 1
            return units

        if dev != "cpu":
            cap = traced_window(traced, mix["traced_rounds"])
        state = state_box[0]
        del state_box

    # free the program's state, then the reference
    del state, step, model, pool
    gc.collect()
    if dev != "cpu":
        torch.cuda.empty_cache()
    ref = run_reference(ctx, Numerics("f32"))
    got = readings({"loss": prog_loss, "update": prog_update,
                    "change": prog_change}, ref)
    checks = {k: (v, ctx.limits[k]) for k, v in got.items()
              if k in ctx.limits}
    facts = None
    if ctx.trace:
        facts = train_facts(ctx, cap, enqueue, layers, n_params,
                            window_s / n)
    return {"e2e": {"train_tokens_per_s": n * tokens / window_s,
                    "peak_gib": peak / 2 ** 30, "setup_s": setup_s},
            "checks": checks, "attempted": n, "failed": 0,
            "memory_peak_bytes": peak, "capture": cap, "facts": facts,
            "detail": {"ref": ref, "prog": {"loss": prog_loss,
                                            "update": prog_update,
                                            "change": prog_change},
                       "rounds": n, "window_s": window_s}}


def readings(got: dict, ref: dict) -> dict:
    """The compared numbers of ``got`` against ``ref`` (both as
    ``run_reference`` returns them)."""
    return {"loss_gap": compare.loss_gap(got["loss"], ref["loss"]),
            "update_gap": compare.norm_gap(got["update"], ref["update"]),
            "change_gap": compare.norm_gap(got["change"], ref["change"]),
            "update_gap_median": compare.median_gap(got["update"],
                                                    ref["update"]),
            "change_gap_median": compare.median_gap(got["change"],
                                                    ref["change"])}


def run_reference(ctx, num: Numerics, half_batch: bool = False) -> dict:
    """The checked rounds, replayed by the reference from the seed."""
    cfg, mix, dev = ctx.config, ctx.mix, ctx.device
    layers = cfg.get("train_layers") or cfg["num_layers"]
    from repro_torch.models.model import build_model  # the layout only

    layout = build_model(model_config(cfg, layers=layers), "meta").init(None)
    params = weights.make_weights(layout, ctx.seed, torch.device(dev))
    if num.kind != "f32":
        params = fl_round.tree_map(lambda t: num.store(t, t.dtype), params)
    pool, sched, sizes = make_inputs(cfg, mix, ctx.seed, dev)
    rnd = fl_round.Round(cfg, mix, params, num, half_batch=half_batch)
    losses, update = [], None
    for r in range(mix["checked_rounds"]):
        b = dict(pool[r])
        b["arrival"] = sched[r]
        b["data_sizes"] = sizes
        losses.append(rnd.step(b)["fresh_loss_mean"])
        if r == 0:
            update = compare.diff_norms(rnd.glob, params)
    return {"loss": losses, "update": update,
            "change": compare.diff_norms(rnd.glob, params)}


def train_facts(ctx, cap, enqueue, layers: int, n_params: int,
                unit_wall_s: float) -> dict:
    """What the per-layer readers of a training cell read."""
    cfg, mix = ctx.config, ctx.mix
    card = torch.cuda.get_device_name(0)
    c, m, b, s = mix["cohort"], mix["local_steps"], mix["batch"], mix["seq"]
    h, hkv = cfg["num_heads"], cfg["num_kv_heads"]
    hd = cfg.get("head_dim") or cfg["d_model"] // h
    window = cfg.get("attn_window") or 0
    facts = {"capture": cap, "units": cap.units if cap else 0,
             "unit_wall_s": unit_wall_s, "host_enqueue_s": enqueue,
             "flops_per_unit": lm_flops.train_round(cfg, layers, mix),
             "peak_flops": flops_peak(card, "bfloat16"),
             "kernel_bounds": {}}
    bounds = facts["kernel_bounds"]
    # K1: one launch a round over the flat vector, C base rows, K arrived
    bounds["k1"] = bound_s(rk.k1(n_params, c, mix["buffer"]), card)
    # K5 / K6 backward: one launch a local step and layer, the C slots'
    # b rows folded into the batch
    bounds["k5_bwd"] = m * layers * bound_s(
        rk.k5_bwd(c * b, s, h, hkv, hd, window), card)
    if cfg.get("ssm_state"):
        di = cfg.get("ssm_expand", 2) * cfg["d_model"]
        bounds["k6_bwd"] = m * layers * bound_s(
            rk.k6_bwd(c * b, s, di, cfg["ssm_state"], a_rows=c), card)
    return facts
