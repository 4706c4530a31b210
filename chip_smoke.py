#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) end to end on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

1. Device line: the card's name and power limit from ``nvidia-smi``; TF32
   is switched off for cuDNN convolutions and for matmuls.
2. Build: compile ``src/repro_torch/csrc/{weighted_agg,ring_codec,
   flash_attn,ssm_scan}.cu`` for sm_90a, the four nvcc runs at once; print
   ptxas's registers, shared memory and spills of the instances of K3, K5
   and K6.
3. Kernel phases: K1 (fused server pass), K2 (squared distances) and K3
   (weighted sum) against their plain PyTorch versions on the card, at the
   LeNet width (K=10, N=44,426), the engine's padded LeNet row (K=10,
   N=49,152), a ragged N (K=32, N=130,007) and a memory-bound N (K=16,
   N=16,777,219). K1 runs all 8 policies x normalize {mean, none} x with
   and without an arrival mask. Each phase checks that two launches give
   bit-identical distances and times kernel, plain version and library
   yardstick with CUDA events (median of 30 calls after 5 warm-up calls)
   beside the bytes bound. At the main-path shape kernel and yardstick are
   also timed as a burst (100 back-to-back calls between one event pair,
   divided by 100; still the host's rate where a call's dispatch outlasts
   its kernels) and by ``torch.profiler`` (the kernels' own device time per
   call, without the gaps in which the card waits for the host; reported
   only if every call left the same number of device operations). K3 and
   its yardstick are also profiled at the ragged N (K=32, N=130,007).
   K4 (int8 dequantize-distance) against its plain version at the engine's
   int8 ring (K=10, N=49,152, qblock 256), a ragged N (K=32, N=130,048,
   qblock 128), a single ragged tile (K=4, N=640, qblock 64) and a
   memory-bound N (K=16, N=16,777,216, qblock 256), with scale-0 blocks;
   bit-identical across launches; timed beside its bytes bound and, for
   reference, K2's time on f32 rows of the same (K, N); a burst and the
   profiled device time at the main-path shape.
4. Main path: ``repro_torch.core.run_async(engine="vectorized")`` at the
   paper's config (LeNet, 30 clients x 1500 samples, K=10, M=4, B=32,
   scenario paper-fig1, seed 0) for 10 rounds on the card in fused,
   batched and reference modes, with launch counts read around each run;
   the three agree, and the fused run agrees with the same run on the CPU.
5. FedAvg rows: ``run_sync`` for 3 rounds on the card.
6. Version store: each codec's ring bytes on the card (f32, int8, delta at
   the paper config, R = 33) equal ``ring_device_bytes``. The same 10-round
   run with ``ring_codec="int8"`` (launches K4 and K3 once per round, K1
   and K2 never) against the same run on the CPU, and against the f32 run
   (``scripts/codec_drift.py``'s measures: the final model's drift and the
   eval accuracy, each within a limit set from CPU readings of both
   packages). ``ring_codec="delta"`` for 34 rounds, one ring lap and past
   it, so the base refresh runs on the card (K3 once per round, nothing
   else), against the same run on the CPU; then one delta write and one
   refresh write timed at the paper width. Checkpoint: int8 to round 5
   with ``capture_state``, ``save_checkpoint``/``load_checkpoint``,
   resumed to 10, bit-identical to the uninterrupted run (cuDNN
   deterministic).
7. K5 (flash attention) against its plain version at Hymba-1.5B's shapes
   (B=2, S=4096, 25 query and 5 kv heads, D=64) in bf16 and f32, window
   1024 and 0 (causal), a ragged S (3001) and an S shorter than the window
   (700); K6 (selective scan) at Hymba's widths (B=2, S=4096, di=3200,
   N=16) and a ragged S (1001). Each timed beside its bound and its plain
   version; K5 also beside ``scaled_dot_product_attention`` (enable_gqa, a
   boolean band mask), the port never calls it. K5's bf16 instance runs on
   the tensor cores (wgmma fed by TMA), its f32 instance on the CUDA cores.
   At the prefill's shapes K5, SDPA and K6 are also timed as a burst of
   back-to-back calls (device time: these kernels outlast their dispatch);
   K6 also at the ragged S.
8. LM serving path, Hymba-1.5B at full width: ``Model.prefill_logits`` at
   full depth (32 layers, bf16, port init from a seeded generator on the
   card), B=2, S=4096, launching K5 and K6 exactly 32 times each, finite
   logits, prefill tokens/s and peak memory, and a ``torch.profiler``
   capture of one warm prefill (its ten largest device operations, K5's
   and K6's share, K6's device time per launch); the same weights at 2
   layers, S=512, on the card against the CPU (f32 and bf16); decode
   against the full forward at 4 layers, f32, S=1536 (the 1024-slot ring
   cache wraps); ``launch/serve.py`` at full depth (batch 4, prompt 32,
   gen 16).

The last two lines of standard output are the kernels' JSON record and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# tolerances, with their reasons
# kernel vs plain version on the same inputs: both sum in f32, in different
# orders (blocked tree vs PyTorch's reduction), so distances agree to a few
# f32 ulps of the sum over N terms; weights inherit that relative error.
KERNEL_RTOL = 1e-4
# weighted sums: error bound relative to sum_k |w_k| * max|d|
SUM_RTOL = 1e-5
# main path, modes against each other and card against CPU: the same maths
# through different summation orders (and cuDNN vs CPU convolutions) for
# 10 rounds x 4 local steps; differences stay near f32 rounding, far below
# these bounds, while a wrong weight or row would miss them by orders.
PATH_RTOL = 1e-3
PATH_ATOL = 1e-5
PARAM_ATOL = 1e-4
# int8 ring vs f32 ring, 10 rounds at the paper config. The eq. 3 weights
# are not held to a tolerance: with an f32 ring a fresh client's distance
# is exactly 0, so eq. 3's min_j d_j is 0 and every stale client's degree
# is ~eps/d; an int8 base is never exactly the current model, so the min
# becomes the quantization error and the stale degrees rise by orders of
# magnitude. Both packages show it on the CPU (scripts/codec_drift.py:
# largest weight deviation 312x in the JAX package, 351x in the port).
# What is held: ||p_int8 - p_f32|| / ||p_f32 - p_0|| of the final model
# (CPU readings 0.02 in both packages) and the eval accuracy at each eval
# (CPU readings within 0.022 of the f32 run's).
CODEC_DRIFT = 0.1
CODEC_ACC = 0.05
DELTA_ROUNDS = 34  # past one ring lap (R = 33): the base refresh runs

# K5 vs its plain version: f32 sums in other orders (rtol 1e-4); bf16: the
# plain version computes in f32 and rounds the output once; the kernel runs
# Q.K and P.V on the tensor cores with f32 sums and P carried as two bf16
# terms, P_hi + P_lo (within 2^-16 relative; one bf16 P would not hold this
# tolerance, tests/test_torch_flash_attn.py), so an element differs by at
# most one bf16 ulp of the output (2^-8 relative, 2^-7 just above a power of
# two)
ATTN_TOL = {"float32": (1e-4, 1e-5), "bfloat16": (8e-3, 1e-5)}
# K6 vs its plain version: the same f32 recurrence, exp and the 16-term sums
# in other orders; atol relative to the largest |y|
SCAN_RTOL, SCAN_ATOL_REL = 1e-4, 1e-5
# LM path, in units of the largest |logit|: card vs CPU at f32 (the same f32
# maths, cuBLAS vs CPU matmuls, 2 layers); at bf16 (two chains of bf16
# roundings: the port's bf16 prefill differs from its f32 prefill of the same
# weights by 0.9% of the largest logit on the CPU at full width, 2 layers);
# decode vs the full forward at f32 over 4 layers and 1536 positions
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
DECODE_TOL = 1e-4

# HBM bandwidth by card name (NVIDIA data sheets); f32 CUDA-core and bf16
# dense tensor-core peaks (H100 SXM data sheet)
HBM_BYTES_PER_S = (("H200", 4.8e12), ("H100 NVL", 3.9e12),
                   ("H100 PCIe", 2.0e12), ("H100", 3.35e12))
F32_FLOPS = 67e12
BF16_FLOPS = 989e12

# Hymba-1.5B serving shapes (configs/hymba_1p5b.py): the prefill's K5 and K6
HYMBA_B, HYMBA_S, HYMBA_H, HYMBA_HKV, HYMBA_D, HYMBA_WINDOW = \
    2, 4096, 25, 5, 64, 1024
HYMBA_DI, HYMBA_N = 3200, 16
# (S, window, dtype); the first is the prefill's
ATTN_CASES = ((4096, 1024, "bfloat16"), (4096, 1024, "float32"),
              (4096, 0, "bfloat16"), (4096, 0, "float32"),
              (3001, 1024, "bfloat16"), (700, 1024, "float32"))
SCAN_SEQS = (4096, 1001)  # the first is the prefill's

SOURCES = {"fused_server": "src/repro_torch/csrc/weighted_agg.cu",
           "sq_dists": "src/repro_torch/csrc/weighted_agg.cu",
           "weighted_sum": "src/repro_torch/csrc/weighted_agg.cu",
           "int8_sq_dists": "src/repro_torch/csrc/ring_codec.cu",
           "flash_attention": "src/repro_torch/csrc/flash_attn.cu",
           "selective_scan": "src/repro_torch/csrc/ssm_scan.cu"}
TPU_KERNELS = {
    "fused_server": "src/repro/kernels/weighted_agg/kernel.py:131",
    "sq_dists": "src/repro/kernels/weighted_agg/kernel.py:208",
    "weighted_sum": "src/repro/kernels/weighted_agg/kernel.py:41",
    "int8_sq_dists": "src/repro/kernels/ring_codec/kernel.py:51",
    "flash_attention": "src/repro/kernels/flash_attn/kernel.py:70",
    "selective_scan": "src/repro/kernels/ssm_scan/kernel.py:51",
}
POLICIES = ("paper", "multiplicative", "fedbuff", "polynomial", "fedasync",
            "fedasync_constant", "fedasync_hinge", "fedasync_poly")
SHAPES = ((10, 44_426), (10, 49_152), (32, 130_007), (16, 16_777_219))
MAIN_SHAPE = (10, 49_152)  # what the main path gives the kernels
# profiled beside the main-path shape: K3 where K = 32 takes two row groups
PROFILED_TOO = {("weighted_sum", 32, 130_007)}
# K4 shapes (K, N, qblock); the first is the int8 main path's
INT8_SHAPES = ((10, 49_152, 256), (32, 130_048, 128), (4, 640, 64),
               (16, 16_777_216, 256))
# ring bytes of the paper config (LeNet, n_padded 49,152, R = 33)
RING_BYTES = {"f32": 6_488_064, "int8": 1_672_704, "delta": 845_524}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def hbm_rate(name: str) -> float:
    for key, rate in HBM_BYTES_PER_S:
        if key in name:
            return rate
    raise RuntimeError(f"no HBM bandwidth on record for {name!r}")


def time_ms(torch, fn, reps: int = 30, warmup: int = 5) -> float:
    """Median milliseconds of one call, from CUDA events around each call."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def time_burst(torch, fn, n: int = 100, warmup: int = 5) -> float:
    """Milliseconds per call of ``n`` back-to-back calls between one event
    pair: device time, where one call alone is the host's dispatch."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def device_events(torch, averages):
    """(name, count, device us) of the device-side operations (kernels,
    copies, sets) of a ``torch.profiler`` capture's ``key_averages()``,
    largest first."""
    from torch.autograd import DeviceType

    rows = [(e.key, e.count, getattr(e, "self_device_time_total", None)
             or getattr(e, "self_cuda_time_total", 0.0))
            for e in averages if e.device_type == DeviceType.CUDA]
    return sorted((r for r in rows if r[2] > 0), key=lambda r: -r[2])


def profiled(torch, fn):
    """``key_averages()`` of a ``torch.profiler`` capture (CPU + CUDA) of
    ``fn`` after one warm-up call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return prof.key_averages()


def profiled_ms(torch, fn, n: int = 20):
    """Device milliseconds per call from ``torch.profiler``: the device
    operations' own durations over ``n`` back-to-back calls, divided by
    ``n``; the gaps in which the card waits for the host are not counted.
    For calls whose kernels take microseconds and whose dispatch takes
    longer (K1-K4 and their yardsticks at LeNet width); of millisecond
    kernels in such a loop the capture kept only some records. Returns it
    (None unless every call left the same number of device operations) and
    the device operations recorded per call."""
    def calls():
        for _ in range(n):
            fn()

    rows = device_events(torch, profiled(torch, calls))
    total = sum(us for _, _, us in rows)
    count = sum(c for _, c, _ in rows)
    whole = total > 0 and count % n == 0
    return (total / 1e3 / n if whole else None), count / n


def ptxas_lines(report, part: str):
    """The lines of a ptxas report (``CudaLibrary.ptxas_info``) that belong
    to the kernels whose mangled names contain ``part``."""
    keep, out = False, []
    for line in report:
        if "Compiling entry function" in line:
            keep = part in line
        if keep:
            out.append(line)
    return out


def fmt_ms(x) -> str:
    return "n/a" if x is None else f"{x:.4f}"


def make_inputs(torch, k: int, n: int, seed: int):
    """Flat server-pass inputs: row 0 of bases is x itself (a fresh client,
    distance exactly 0), the others at growing distances; taus straddle the
    hinge knee; the mask drops two slots, one of them the fresh one."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(n, device="cuda", generator=g)
    scale = torch.linspace(0.0, 0.05, k, device="cuda")[:, None]
    bases = x[None] + scale * torch.randn(k, n, device="cuda", generator=g)
    deltas = 0.01 * torch.randn(k, n, device="cuda", generator=g)
    p = 100.0 + 50.0 * torch.rand(k, device="cuda", generator=g)
    taus = torch.arange(k, device="cuda", dtype=torch.float32) % 9
    mask = torch.ones(k, device="cuda")
    mask[0] = 0.0
    mask[k // 2] = 0.0
    return x, bases, deltas, p, taus, mask


def kernel_phases(torch, ops, ref, rate: float):
    """Hold K1-K3 against their plain versions; returns per-kernel records."""
    records = {}
    for k, n in SHAPES:
        x, bases, deltas, p, taus, mask = make_inputs(torch, k, n, seed=k + n)
        w = torch.rand(k, device="cuda") * 2.0 - 0.5
        row_bytes = n * 4

        # K2: squared distances
        d1, d2 = ops.sq_dists(x, bases), ops.sq_dists(x, bases)
        check(torch.equal(d1, d2), f"K2 dists not bit-identical at {(k, n)}")
        d_ref = ref.sq_dists_ref(x, bases)
        err2 = float((d1 - d_ref).abs().max())
        check(torch.allclose(d1, d_ref, rtol=KERNEL_RTOL, atol=0.0),
              f"K2 vs plain at {(k, n)}: max abs err {err2}")
        check(float(d1[0]) == 0.0, "K2: distance of x to itself is not 0")

        # K3: weighted sum
        s1, s2 = ops.weighted_sum(deltas, w), ops.weighted_sum(deltas, w)
        check(torch.equal(s1, s2), f"K3 not bit-identical at {(k, n)}")
        s_ref = ref.weighted_sum_ref(deltas, w)
        err3 = float((s1 - s_ref).abs().max())
        bound3 = float(w.abs().sum() * deltas.abs().max())
        check(err3 <= SUM_RTOL * bound3, f"K3 vs plain at {(k, n)}: {err3}")

        # K1: fused pass, every policy x normalize x mask
        err1 = 0.0
        for policy in POLICIES:
            for normalize in ("mean", "none"):
                for m in (None, mask):
                    cfg = dict(policy=policy, normalize=normalize, eta_g=1.0)
                    u, dk, wk = ops.server_update(x, bases, deltas, p, taus,
                                                  m, **cfg)
                    _, dk2, wk2 = ops.server_update(x, bases, deltas, p, taus,
                                                    m, **cfg)
                    check(torch.equal(dk, dk2) and torch.equal(wk, wk2),
                          f"K1 not bit-identical: {policy}/{normalize}")
                    u_r, d_r, w_r = ref.server_update_ref(x, bases, deltas, p,
                                                          taus, m, **cfg)
                    tag = f"K1 {policy}/{normalize}/mask={m is not None} {(k, n)}"
                    check(torch.allclose(dk, d_r, rtol=KERNEL_RTOL, atol=0.0),
                          f"{tag}: dists")
                    check(torch.allclose(wk, w_r, rtol=KERNEL_RTOL,
                                         atol=1e-6 * float(w_r.abs().max())),
                          f"{tag}: weights {wk.tolist()} vs {w_r.tolist()}")
                    bound1 = float(w_r.abs().sum() * deltas.abs().max())
                    eu = float((u - u_r).abs().max())
                    check(eu <= SUM_RTOL * max(bound1, 1e-30),
                          f"{tag}: upd err {eu}")
                    err1 = max(err1, eu, float((dk - d_r).abs().max()),
                               float((wk - w_r).abs().max()))

        cfg = dict(policy="paper", normalize="mean", eta_g=1.0)
        # (kernel, plain version, library yardstick or None) per kernel
        calls = {
            "fused_server": (
                lambda: ops.server_update(x, bases, deltas, p, taus, None,
                                          **cfg),
                lambda: ref.server_update_ref(x, bases, deltas, p, taus, None,
                                              **cfg), None),
            "sq_dists": (lambda: ops.sq_dists(x, bases),
                         lambda: ref.sq_dists_ref(x, bases),
                         lambda: ((bases - x) ** 2).sum(1)),
            "weighted_sum": (lambda: ops.weighted_sum(deltas, w),
                             lambda: ref.weighted_sum_ref(deltas, w),
                             lambda: torch.matmul(w, deltas)),
        }
        rows = {
            "fused_server": dict(bytes=(2 * k + 2) * row_bytes,
                                 ops=5 * k * n, max_abs_err=err1),
            "sq_dists": dict(bytes=(k + 1) * row_bytes, ops=3 * k * n,
                             max_abs_err=err2),
            "weighted_sum": dict(bytes=(k + 1) * row_bytes, ops=2 * k * n,
                                 max_abs_err=err3),
        }
        main = (k, n) == MAIN_SHAPE
        for name, r in rows.items():
            kern, plain, lib = calls[name]
            prof = main or (name, k, n) in PROFILED_TOO
            r["ms"] = time_ms(torch, kern)
            r["plain_ms"] = time_ms(torch, plain)
            r["library_ms"] = time_ms(torch, lib) if lib else None
            r["burst_ms"] = time_burst(torch, kern) if main else None
            r["library_burst_ms"] = time_burst(torch, lib) \
                if main and lib else None
            r["device_ms"], r["device_ops"] = profiled_ms(torch, kern) \
                if prof else (None, None)
            r["library_device_ms"], r["library_device_ops"] = \
                profiled_ms(torch, lib) if prof and lib else (None, None)
            bytes_ms = r["bytes"] / rate * 1e3
            ops_ms = r["ops"] / F32_FLOPS * 1e3
            r["bound_ms"] = max(bytes_ms, ops_ms)
            r["bound_by"] = "bytes" if bytes_ms >= ops_ms else "operations"
            lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
            print(f"  {name:13s} K={k:3d} N={n:>10,d}: kernel {r['ms']:.4f} ms"
                  f"  plain {r['plain_ms']:.4f} ms  library {lib} ms"
                  f"  bound {r['bound_ms']:.4f} ms ({r['bound_by']})"
                  f"  max_abs_err {r['max_abs_err']:.3g}")
            if main:
                print(f"    burst of 100: kernel {r['burst_ms']:.4f} ms  "
                      f"library {fmt_ms(r['library_burst_ms'])} ms")
            if prof:
                lib_ops = r["library_device_ops"]
                print(f"    profiled device time: kernel "
                      f"{fmt_ms(r['device_ms'])} ms ({r['device_ops']:g} device"
                      f" ops per call)  library "
                      f"{fmt_ms(r['library_device_ms'])} ms "
                      f"({'n/a' if lib_ops is None else f'{lib_ops:g}'})")
            records[(name, k, n)] = r
        del x, bases, deltas
        torch.cuda.empty_cache()
    return records


def int8_kernel_phase(torch, rc_ops, rc_ref, ops, rate: float):
    """Hold K4 against its plain version; returns per-shape records."""
    records = {}
    for k, n, qblock in INT8_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(k + n + qblock)
        nb = n // qblock
        codes = torch.randint(-127, 128, (k, n), device="cuda", generator=g,
                              dtype=torch.int32).to(torch.int8)
        scales = 1e-4 + 2e-2 * torch.rand(k, nb, device="cuda", generator=g)
        scales[:, ::5] = 0.0  # constant blocks decode to their zero exactly
        zeros = torch.randn(k, nb, device="cuda", generator=g)
        x = torch.randn(n, device="cuda", generator=g)
        d1 = rc_ops.int8_sq_dists(x, codes, scales, zeros, qblock=qblock)
        d2 = rc_ops.int8_sq_dists(x, codes, scales, zeros, qblock=qblock)
        check(torch.equal(d1, d2), f"K4 not bit-identical at {(k, n, qblock)}")
        d_ref = rc_ref.int8_sq_dists_ref(x, codes, scales, zeros, qblock)
        err = float((d1 - d_ref).abs().max())
        check(torch.allclose(d1, d_ref, rtol=KERNEL_RTOL, atol=0.0),
              f"K4 vs plain at {(k, n, qblock)}: max abs err {err}")
        nbytes = k * n + 8 * k * nb + 4 * n + 4 * k
        bytes_ms = nbytes / rate * 1e3
        ops_ms = 5 * k * n / F32_FLOPS * 1e3
        r = dict(
            ms=time_ms(torch, lambda: rc_ops.int8_sq_dists(
                x, codes, scales, zeros, qblock=qblock)),
            plain_ms=time_ms(torch, lambda: rc_ref.int8_sq_dists_ref(
                x, codes, scales, zeros, qblock)),
            library_ms=None, max_abs_err=err, bytes=nbytes,
            bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
            burst_ms=None, library_burst_ms=None, device_ms=None,
            library_device_ms=None)
        if (k, n) == MAIN_SHAPE:
            r["burst_ms"] = time_burst(torch, lambda: rc_ops.int8_sq_dists(
                x, codes, scales, zeros, qblock=qblock))
            r["device_ms"], ops_per_call = profiled_ms(
                torch, lambda: rc_ops.int8_sq_dists(x, codes, scales, zeros,
                                                    qblock=qblock))
        bases = torch.randn(k, n, device="cuda", generator=g)
        k2_ms = time_ms(torch, lambda: ops.sq_dists(x, bases))
        print(f"  int8_sq_dists K={k:3d} N={n:>10,d} qblock={qblock:3d}: "
              f"kernel {r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms  "
              f"library n/a  bound {r['bound_ms']:.4f} ms ({r['bound_by']}, "
              f"{nbytes:,d} B)  max_abs_err {err:.3g}; "
              f"K2 on f32 rows {k2_ms:.4f} ms")
        if r["burst_ms"] is not None:
            print(f"    burst of 100: kernel {r['burst_ms']:.4f} ms; profiled "
                  f"device time {fmt_ms(r['device_ms'])} ms ({ops_per_call:g} "
                  f"device ops per call)")
        records[(k, n)] = r
        del codes, scales, zeros, x, bases
        torch.cuda.empty_cache()
    return records

def attn_pairs(s: int, window: int) -> int:
    """Visible (query, key) pairs of one (b, h) under the causal band."""
    if not window:
        return s * (s + 1) // 2
    w = min(window, s)
    return w * (w + 1) // 2 + (s - w) * w


def flash_kernel_phase(torch, fa_ops, fa_ref, rate: float):
    """Hold K5 against its plain version; returns per-case records."""
    F = torch.nn.functional
    b, h, hkv, d = HYMBA_B, HYMBA_H, HYMBA_HKV, HYMBA_D
    records = {}
    for s, window, dtype_name in ATTN_CASES:
        dtype = getattr(torch, dtype_name)
        g = torch.Generator(device="cuda").manual_seed(s + window)
        q, k, v = (torch.randn(b, s, n, d, device="cuda", generator=g)
                   .to(dtype) for n in (h, hkv, hkv))
        out = fa_ops.flash_attention(q, k, v, window=window)
        check(torch.equal(out, fa_ops.flash_attention(q, k, v, window=window)),
              f"K5 not bit-identical at S={s} window={window} {dtype_name}")
        want = fa_ref.flash_attention_ref(q, k, v, window=window)
        rtol, atol = ATTN_TOL[dtype_name]
        err = float((out.float() - want.float()).abs().max())
        check(torch.allclose(out.float(), want.float(), rtol=rtol, atol=atol),
              f"K5 vs plain at S={s} window={window} {dtype_name}: max abs "
              f"err {err}")
        del want
        # yardstick: one PyTorch call for the same function, (B, H, S, D)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        mask = fa_ref.band_mask(s, s, True, window, q.device)

        def library():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                  enable_gqa=True)

        lib_err = float((library().transpose(1, 2).float() - out.float())
                        .abs().max())
        flops = 4 * d * attn_pairs(s, window) * b * h
        nbytes = (2 * b * s * h + 2 * b * s * hkv) * d * q.element_size()
        bytes_ms = nbytes / rate * 1e3
        ops_ms = flops / (BF16_FLOPS if dtype == torch.bfloat16
                          else F32_FLOPS) * 1e3
        r = dict(
            ms=time_ms(torch, lambda: fa_ops.flash_attention(
                q, k, v, window=window), reps=10, warmup=2),
            plain_ms=time_ms(torch, lambda: fa_ref.flash_attention_ref(
                q, k, v, window=window), reps=3, warmup=1),
            library_ms=time_ms(torch, library, reps=10, warmup=2),
            max_abs_err=err, bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
            burst_ms=None, library_burst_ms=None, device_ms=None,
            library_device_ms=None)
        if (s, window, dtype_name) == ATTN_CASES[0]:
            r["burst_ms"] = time_burst(torch, lambda: fa_ops.flash_attention(
                q, k, v, window=window), n=20, warmup=2)
            r["library_burst_ms"] = time_burst(torch, library, n=20, warmup=2)
            print(f"    burst of 20: kernel {r['burst_ms']:.4f} ms  library "
                  f"{r['library_burst_ms']:.4f} ms")
        print(f"  flash_attention B={b} S={s:5d} H={h} Hkv={hkv} D={d} "
              f"window={window:4d} {dtype_name:8s}: kernel {r['ms']:.4f} ms  "
              f"plain {r['plain_ms']:.4f} ms  library {r['library_ms']:.4f} "
              f"ms (vs kernel {lib_err:.3g})  bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}, {flops / 1e9:.2f} GFLOP, {nbytes:,d} B)  "
              f"max_abs_err {err:.3g}")
        records[(s, window, dtype_name)] = r
        del q, k, v, out, qt, kt, vt, mask
        torch.cuda.empty_cache()
    return records


def scan_kernel_phase(torch, ss_ops, ss_ref, rate: float):
    """Hold K6 against its plain version; returns per-S records."""
    b, di, n = HYMBA_B, HYMBA_DI, HYMBA_N
    records = {}
    for s in SCAN_SEQS:
        g = torch.Generator(device="cuda").manual_seed(s)
        x = torch.randn(b, s, di, device="cuda", generator=g)
        dt = torch.nn.functional.softplus(
            torch.randn(b, s, di, device="cuda", generator=g) - 1.0)
        bb, c = (torch.randn(b, s, n, device="cuda", generator=g)
                 for _ in range(2))
        a = -torch.exp(0.5 * torch.randn(di, n, device="cuda", generator=g))
        args = (x, dt, bb, c, a)
        y = ss_ops.selective_scan(*args)
        check(torch.equal(y, ss_ops.selective_scan(*args)),
              f"K6 not bit-identical at S={s}")
        want = ss_ref.selective_scan_ref(*args)
        err = float((y - want).abs().max())
        check(torch.allclose(y, want, rtol=SCAN_RTOL,
                             atol=SCAN_ATOL_REL * float(want.abs().max())),
              f"K6 vs plain at S={s}: max abs err {err}")
        nbytes = (3 * b * s * di + 2 * b * s * n + di * n) * 4
        flops = 6 * b * s * di * n
        bytes_ms = nbytes / rate * 1e3
        ops_ms = flops / F32_FLOPS * 1e3
        r = dict(
            ms=time_ms(torch, lambda: ss_ops.selective_scan(*args), reps=10,
                       warmup=2),
            plain_ms=time_ms(torch, lambda: ss_ref.selective_scan_ref(*args),
                             reps=2, warmup=1),
            library_ms=None, max_abs_err=err, bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
            burst_ms=time_burst(torch, lambda: ss_ops.selective_scan(*args),
                                n=10, warmup=2),
            library_burst_ms=None,
            device_ms=None, library_device_ms=None)
        print(f"  selective_scan B={b} S={s:5d} di={di} N={n}: kernel "
              f"{r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms  library n/a  "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}, {nbytes:,d} B, "
              f"{flops / 1e9:.2f} GFLOP)  max_abs_err {err:.3g}")
        print(f"    burst of 10: kernel {r['burst_ms']:.4f} ms")
        records[s] = r
        del x, dt, bb, c, a, y, want
        torch.cuda.empty_cache()
    return records


def to_cpu(tree):
    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    return tree.cpu()


def lm_phase(torch, np, fa_ops, ss_ops, serve, get_arch, Model):
    """The Hymba-1.5B serving path at full width; returns the prefill's K5
    and K6 launch counts and its time."""
    cfg = get_arch("hymba-1.5b").model
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (HYMBA_B, HYMBA_S))).cuda()

    # (a) prefill_logits at full width and depth, bf16
    t = time.perf_counter()
    model = Model(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = model.param_count(params)
    check(n_params == 1_662_264_000, f"Hymba param count {n_params}")
    print(f"  Hymba-1.5B init on the card: {n_params:,d} params, "
          f"{time.perf_counter() - t:.2f} s")
    batch = {"tokens": tokens}
    with torch.no_grad():
        model.prefill_logits(params, batch)  # first call pays cuBLAS set-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa_ops.reset_launches()
        ss_ops.reset_launches()
        t = time.perf_counter()
        logits = model.prefill_logits(params, batch)
        torch.cuda.synchronize()
        prefill_s = [time.perf_counter() - t]
        counts = {"flash_attention": fa_ops.flash_attention.launches,
                  "selective_scan": ss_ops.selective_scan.launches}
        peak = torch.cuda.max_memory_allocated()
        for _ in range(2):
            t = time.perf_counter()
            model.prefill_logits(params, batch)
            torch.cuda.synchronize()
            prefill_s.append(time.perf_counter() - t)
    check(counts == {"flash_attention": cfg.num_layers,
                     "selective_scan": cfg.num_layers},
          f"prefill launches {counts}")
    check(tuple(logits.shape) == (HYMBA_B, 1, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()), "prefill logits")
    toks = HYMBA_B * HYMBA_S
    print(f"  prefill_logits B={HYMBA_B} S={HYMBA_S}, 32 layers, bf16: "
          f"{', '.join(f'{x:.4f}' for x in prefill_s)} s -> "
          f"{', '.join(f'{toks / x:,.0f}' for x in prefill_s)} tokens/s; "
          f"peak device memory {peak / 2**30:.2f} GiB "
          f"(params {n_params * 2 / 2**30:.2f} GiB); launches {counts}")
    profile = profile_prefill(torch, model, params, batch)
    del model, params, logits
    torch.cuda.empty_cache()

    # (b) the same weights on the card and on the CPU: 2 layers, S = 512
    for dtype in ("float32", "bfloat16"):
        cfg2 = cfg.replace(num_layers=2, param_dtype=dtype,
                           compute_dtype=dtype)
        card = Model(cfg2, device="cuda")
        p2 = card.init(torch.Generator(device="cuda").manual_seed(1))
        with torch.no_grad():
            got = card.prefill_logits(p2, {"tokens": tokens[:, :512]})
            want = Model(cfg2, device="cpu").prefill_logits(
                to_cpu(p2), {"tokens": tokens[:, :512].cpu()})
        err = float((got.cpu().float() - want.float()).abs().max())
        scale = float(want.float().abs().max())
        print(f"  card vs CPU, 2 layers, S=512, {dtype}: max abs diff "
              f"{err:.4g} of max |logit| {scale:.4g} (limit "
              f"{LOGIT_TOL[dtype]} x max)")
        check(err <= LOGIT_TOL[dtype] * scale, f"card vs CPU {dtype}: {err}")
        del card, p2, got
    torch.cuda.empty_cache()

    # (c) decode against the full forward, 4 layers, f32, past the window
    s_dec = 1536
    cfg4 = cfg.replace(num_layers=4, param_dtype="float32",
                       compute_dtype="float32")
    m4 = Model(cfg4, device="cuda")
    p4 = m4.init(torch.Generator(device="cuda").manual_seed(2))
    tok = tokens[:1, :s_dec]
    t = time.perf_counter()
    with torch.no_grad():
        full, _ = m4.apply(p4, {"tokens": tok})
        cache = m4.init_cache(1, s_dec)
        check(cache["kv"]["k"].shape[2] == cfg.attn_window, "ring length")
        errs = []
        for i in range(s_dec):
            lg, cache = m4.decode_step(p4, cache, tok[:, i:i + 1], i)
            errs.append((lg[:, 0] - full[:, i]).abs().max())
        err = float(torch.stack(errs).max())
    scale = float(full.abs().max())
    print(f"  decode vs forward, 4 layers, f32, S={s_dec} (ring of "
          f"{cfg.attn_window} wraps): max abs diff {err:.4g} of max |logit| "
          f"{scale:.4g} (limit {DECODE_TOL} x max), "
          f"{time.perf_counter() - t:.2f} s")
    check(err <= DECODE_TOL * scale, f"decode vs forward: {err}")
    del m4, p4, full, cache
    torch.cuda.empty_cache()

    # (d) the serving launcher at full depth, JAX's defaults
    res = serve.main(["--arch", "hymba-1.5b", "--device", "cuda"])
    ids = res["tokens"]
    check(ids.shape == (4, 17) and ids.min() >= 0
          and ids.max() < cfg.vocab_size, f"served ids {ids.shape}")
    print(f"  serve.py (batch 4, prompt 32, gen 16): prefill "
          f"{res['prefill_s']:.4f} s, decode {res['decode_tok_s']:.2f} "
          f"tokens/s")
    return counts, prefill_s, profile


def profile_prefill(torch, model, params, batch, top: int = 10):
    """One warm ``prefill_logits`` under ``torch.profiler`` (CPU + CUDA):
    prints its largest device operations by device time and returns the
    device milliseconds of K5, K6 and of all device operations, and K6's
    launches in the capture."""
    with torch.no_grad():
        rows = device_events(torch, profiled(
            torch, lambda: model.prefill_logits(params, batch)))
    total = sum(us for _, _, us in rows) / 1e3
    if not total:
        print("  profile of one prefill: the profiler recorded no device time")
        return None
    print(f"  profile of one prefill: {total:.3f} ms of device time in "
          f"{sum(c for _, c, _ in rows)} device operations; the {top} "
          f"largest:")
    for name, count, us in rows[:top]:
        print(f"    {us / 1e3:9.3f} ms {100 * us / 1e3 / total:5.1f}%  "
              f"x{count:<5d} {name[:90]}")

    def named(part):
        return sum(us for name, _, us in rows if part in name) / 1e3

    return {"device_ms": total, "flash_attention_ms": named("flash_fwd"),
            "selective_scan_ms": named("selective_scan"),
            "selective_scan_count": sum(c for name, c, _ in rows
                                        if "selective_scan" in name)}


def compare_runs(np, a, b, what: str) -> None:
    check(len(a.round_log) == len(b.round_log), f"{what}: round counts")
    for ra, rb in zip(a.round_log, b.round_log):
        check(ra["clients"] == rb["clients"] and ra["tau"] == rb["tau"],
              f"{what}: event timeline differs at v{ra['version']}")
        for f in ("sq_dists", "staleness_deg", "stat_effect", "weights"):
            x, y = np.asarray(ra[f]), np.asarray(rb[f])
            check(np.all(np.isfinite(x)) and x.shape == (len(ra["clients"]),),
                  f"{what}: {f} shape/finite at v{ra['version']}")
            check(np.allclose(x, y, rtol=PATH_RTOL, atol=PATH_ATOL),
                  f"{what}: {f} at v{ra['version']}: {x} vs {y}")
    pa, pb = a.final_params, b.final_params
    err = max(float((pa[l][k].cpu() - pb[l][k].cpu()).abs().max())
              for l in pa for k in pa[l])
    check(err <= PARAM_ATOL, f"{what}: final params differ by {err}")
    print(f"  {what}: round log within rtol {PATH_RTOL}, atol {PATH_ATOL}; "
          f"final params max abs diff {err:.3g} (limit {PARAM_ATOL})")


def main() -> int:
    started = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a GPU",
              file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT / "scripts"))
    import codec_drift
    import numpy as np

    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.configs import PAPER_FL, get_arch
    from repro_torch.configs.base import FLConfig
    from repro_torch.core import run_async, run_sync
    from repro_torch.core import version_store
    from repro_torch.core.server_pass import flatten_tree
    from repro_torch.kernels.flash_attn import kernel as fa_kernel
    from repro_torch.kernels.flash_attn import ops as fa_ops
    from repro_torch.kernels.flash_attn import ref as fa_ref
    from repro_torch.kernels.ring_codec import kernel as rc_kernel
    from repro_torch.kernels.ring_codec import ops as rc_ops
    from repro_torch.kernels.ring_codec import ref as rc_ref
    from repro_torch.kernels.ssm_scan import kernel as ss_kernel
    from repro_torch.kernels.ssm_scan import ops as ss_ops
    from repro_torch.kernels.ssm_scan import ref as ss_ref
    from repro_torch.kernels.weighted_agg import kernel, ops, ref
    from repro_torch.launch import serve
    from repro_torch.models import Model, apply_lenet, init_lenet, lenet_loss
    from repro_torch.sim import get_scenario
    from repro_torch.sim.engine import (
        engine_state_from_tree,
        engine_state_to_tree,
        init_version_ring,
    )

    # 1. device line
    line = device_line()
    print(line)
    name = torch.cuda.get_device_name(0)
    rate = hbm_rate(name)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}; "
          f"HBM {rate / 1e12:.2f} TB/s")

    # 2. build: one nvcc per source, all started together
    t0 = time.perf_counter()
    libraries = (kernel.LIBRARY, rc_kernel.LIBRARY, fa_kernel.LIBRARY,
                 ss_kernel.LIBRARY)
    with ThreadPoolExecutor(len(libraries)) as pool:
        built = list(pool.map(lambda lib: lib.build(), libraries))
    for lib in libraries:
        lib.load()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"({', '.join(str(p) for p in built)})")
    for lib, part in ((kernel.LIBRARY, "weighted_sum_kernel"),
                      (fa_kernel.LIBRARY, "flash_fwd"),
                      (ss_kernel.LIBRARY, "selective_scan_kernel")):
        for line in ptxas_lines(lib.ptxas_info, part):
            print(f"  {line}")

    # 3. kernel phases
    print("kernel phases (median of 30 calls, CUDA events):")
    records = kernel_phases(torch, ops, ref, rate)
    int8_records = int8_kernel_phase(torch, rc_ops, rc_ref, ops, rate)

    # 4. main path: the paper's Fig. 1 config on the card
    sc = get_scenario("paper-fig1")
    rounds = 10

    def dataset():
        return sc.make_dataset(PAPER_FL.num_clients, samples_per_client=1500,
                               seed=0, noise=1.2)

    _, (xt, yt) = dataset()
    init = init_lenet(torch.Generator().manual_seed(0))

    def eval_fn_for(device):
        x = torch.from_numpy(xt[:1024]).to(device)
        y = torch.from_numpy(yt[:1024]).to(device)
        return lambda p: {"acc": float(
            (apply_lenet(p, x).argmax(-1) == y).float().mean())}

    def run(mode, device, codec="f32", total=rounds, **kw):
        clients, _ = dataset()  # fresh per run: batch streams are stateful
        fl = dataclasses.replace(PAPER_FL, server_pass_mode=mode,
                                 ring_codec=codec)
        ops.reset_launches()
        rc_ops.reset_launches()
        t = time.perf_counter()
        res = run_async(lenet_loss, init, clients, fl, total,
                        eval_fn=eval_fn_for(device), eval_every=5, seed=0,
                        scenario=sc, engine="vectorized", device=device, **kw)
        if device == "cuda":
            torch.cuda.synchronize()
        dt = time.perf_counter() - t
        counts = {"fused_server": ops.server_update.launches,
                  "sq_dists": ops.sq_dists.launches,
                  "weighted_sum": ops.weighted_sum.launches,
                  "int8_sq_dists": rc_ops.int8_sq_dists.launches}
        done = total - (kw["init_state"].version if "init_state" in kw else 0)
        print(f"  run_async {mode:9s} {codec:5s} on {device}: "
              f"{done / dt:.2f} rounds/s ({dt:.2f} s incl. evals), acc "
              f"{[round(h['acc'], 4) for h in res.history]}, launches {counts}")
        check(res.server_rounds == total and len(res.round_log) == total,
              f"{mode}/{codec}: {res.server_rounds} rounds")
        return res, counts

    print("main path: paper-fig1, 30 clients x 1500, K=10, M=4, B=32, "
          f"{rounds} rounds")
    warm, _ = run("fused", "cuda")  # first run pays one-time CUDA/cuDNN set-up
    fused, fused_counts = run("fused", "cuda")
    check(fused_counts == {"fused_server": rounds, "sq_dists": 0,
                           "weighted_sum": 0, "int8_sq_dists": 0},
          f"fused launches {fused_counts}")
    batched, batched_counts = run("batched", "cuda")
    check(batched_counts == {"fused_server": 0, "sq_dists": rounds,
                             "weighted_sum": rounds, "int8_sq_dists": 0},
          f"batched launches {batched_counts}")
    reference, ref_counts = run("reference", "cuda")
    check(sum(ref_counts.values()) == 0, f"reference launches {ref_counts}")
    compare_runs(np, warm, fused, "fused vs fused (repeat)")
    compare_runs(np, fused, batched, "fused vs batched")
    compare_runs(np, fused, reference, "fused vs reference")
    cpu, _ = run("fused", "cpu")
    compare_runs(np, fused, cpu, "fused on cuda vs fused on cpu")
    check(fused.history[-1]["acc"] > fused.history[0]["acc"],
          "accuracy did not rise over the run")

    # 5. FedAvg rows on the card
    base = dict(num_clients=30, local_steps=4, local_lr=0.05, batch_size=32,
                global_lr=1.0)
    for label, fl in (
            ("fedavg(sync)", FLConfig(buffer_size=30, weighting="fedbuff",
                                      **base)),
            ("fedavg(sync,C=K)", FLConfig(buffer_size=10, clients_per_round=10,
                                          weighting="fedbuff", **base))):
        clients, _ = dataset()
        t = time.perf_counter()
        res = run_sync(lenet_loss, init, clients, fl, 3,
                       eval_fn=eval_fn_for("cuda"), eval_every=1, seed=0,
                       scenario=sc, device="cuda")
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        accs = [round(h["acc"], 4) for h in res.history]
        check(all(np.isfinite(accs)) and res.server_rounds == 3, label)
        print(f"  run_sync {label}: {3 / dt:.2f} rounds/s, acc {accs}")

    # 6. version store: ring bytes, the int8 and delta paths, checkpoint
    print("version store: paper config, R = 33")
    params_cuda = {l: {k: v.cuda() for k, v in p.items()}
                   for l, p in init.items()}
    for codec, want in RING_BYTES.items():
        fl = dataclasses.replace(PAPER_FL, ring_codec=codec)
        spec, state = init_version_ring(params_cuda, fl)
        tensors = version_store.state_tensors(state)
        check(all(t.is_cuda for t in tensors), f"{codec} ring not on the card")
        got = sum(t.numel() * t.element_size() for t in tensors)
        quote = version_store.ring_device_bytes(fl, spec)
        print(f"  ring bytes {codec}: {got:,d} B on the card "
              f"(device_bytes {quote:,d} B)")
        check(got == quote == want, f"{codec} ring bytes {got} vs {quote}, "
              f"expected {want}")
        del state

    print(f"main path, int8 and delta rings, {rounds} rounds, auto mode")
    int8_run, int8_counts = run("auto", "cuda", "int8")
    check(int8_counts == {"fused_server": 0, "sq_dists": 0,
                          "weighted_sum": rounds, "int8_sq_dists": rounds},
          f"int8 launches {int8_counts}")
    int8_cpu, _ = run("auto", "cpu", "int8")
    compare_runs(np, int8_run, int8_cpu, "int8 on cuda vs int8 on cpu")
    check(int8_run.history[-1]["acc"] > int8_run.history[0]["acc"],
          "int8: accuracy did not rise over the run")

    def host(p):
        return {l: {k: v.cpu() for k, v in d.items()} for l, d in p.items()}

    drift = codec_drift.compare(fused, host(fused.final_params), int8_run,
                                host(int8_run.final_params), init)
    acc_gap = max(abs(a - b) for a, b in zip(drift["acc"]["codec"],
                                             drift["acc"]["f32"]))
    print(f"  int8 vs f32 ring: eq. 3 weights max rel deviation "
          f"{drift['weights_max_rel_dev']:.6g}, max abs "
          f"{drift['weights_max_abs_dev']:.6g}, {drift['weights_outside']} "
          f"of {drift['weights_n']} outside 5e-3 + 5% (not held); final "
          f"model drift {drift['drift']:.6g} (limit {CODEC_DRIFT}), largest "
          f"leaf {drift['leaf_drift_max']:.6g}; acc {drift['acc']['codec']} "
          f"vs {drift['acc']['f32']} (gap {acc_gap:.6g}, limit {CODEC_ACC})")
    check(drift["drift"] <= CODEC_DRIFT,
          f"int8 final model drifted from f32 by {drift['drift']}")
    check(acc_gap <= CODEC_ACC, f"int8 accuracy off f32's by {acc_gap}")

    delta_run, delta_counts = run("auto", "cuda", "delta", total=DELTA_ROUNDS,
                                  capture_state=True)
    check(delta_counts == {"fused_server": 0, "sq_dists": 0,
                           "weighted_sum": DELTA_ROUNDS, "int8_sq_dists": 0},
          f"delta launches {delta_counts}")
    check(int(delta_run.final_state.ring["writes"]) == DELTA_ROUNDS,
          "delta write counter")
    delta_cpu, _ = run("auto", "cpu", "delta", total=DELTA_ROUNDS)
    compare_runs(np, delta_run, delta_cpu, "delta on cuda vs delta on cpu")
    check(delta_run.history[-1]["acc"] > delta_run.history[0]["acc"],
          "delta: accuracy did not rise over the run")

    # one delta write and one base-refresh write (33 row re-encodes) at the
    # paper width, on the run's own ring and final model
    fl_delta = dataclasses.replace(PAPER_FL, ring_codec="delta")
    codec = version_store.resolve_codec(fl_delta)
    spec, st = init_version_ring(params_cuda, fl_delta,
                                 rows=delta_run.final_state.ring)
    row = flatten_tree(spec, delta_run.final_params)
    depth = PAPER_FL.max_staleness + 1
    write_ms = time_ms(torch, lambda: codec.encode(
        spec, st._replace(host_writes=0), 0, row), reps=10, warmup=2)
    refresh_ms = time_ms(torch, lambda: codec.encode(
        spec, st._replace(host_writes=depth - 1), 0, row), reps=10, warmup=2)
    print(f"  delta encode at n_padded {spec.n_padded:,d}, R = {depth}: "
          f"write {write_ms:.4f} ms, refresh write {refresh_ms:.4f} ms "
          f"(median of 10, CUDA events)")

    print("checkpoint: int8 to round 5, save, load, resume to 10 "
          "(cudnn.deterministic)")
    torch.backends.cudnn.deterministic = True
    full, _ = run("auto", "cuda", "int8", capture_state=True)
    half, _ = run("auto", "cuda", "int8", total=5, capture_state=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        path = str(Path(tmp) / "engine.npz")
        tree = engine_state_to_tree(half.final_state)
        save_checkpoint(path, tree, step=half.final_state.version)
        loaded, step = load_checkpoint(path, like=tree)
    check(step == 5, f"checkpoint step {step}")
    resumed, _ = run("auto", "cuda", "int8",
                     init_state=engine_state_from_tree(loaded),
                     capture_state=True)
    torch.backends.cudnn.deterministic = False
    check(resumed.round_log == full.round_log, "resumed round log differs")
    check(resumed.history == full.history, "resumed history differs")
    check(all(torch.equal(resumed.final_params[l][k], v)
              for l, p in full.final_params.items() for k, v in p.items()),
          "resumed final params differ")
    ring_a, ring_b = resumed.final_state.ring, full.final_state.ring
    check(ring_a.keys() == ring_b.keys()
          and all(np.array_equal(ring_a[f], ring_b[f]) for f in ring_a),
          "resumed ring differs")
    print("  resumed run == uninterrupted run: round log, history, final "
          "params and ring bit-identical")

    # 7. K5 and K6 against their plain versions
    t = time.perf_counter()
    print("K5 / K6 phases (median of 10 kernel calls, CUDA events):")
    attn_records = flash_kernel_phase(torch, fa_ops, fa_ref, rate)
    scan_records = scan_kernel_phase(torch, ss_ops, ss_ref, rate)
    print(f"  phase: {time.perf_counter() - t:.1f} s")

    # 8. LM serving path, Hymba-1.5B at full width
    t = time.perf_counter()
    print("LM serving path: Hymba-1.5B")
    lm_counts, prefill_s, profile = lm_phase(torch, np, fa_ops, ss_ops,
                                             serve, get_arch, Model)
    k5 = attn_records[ATTN_CASES[0]]
    k6 = scan_records[SCAN_SEQS[0]]
    layers = lm_counts["flash_attention"]
    print(f"  prefill share: K5 {layers} x {k5['burst_ms']:.4f} ms, K6 {layers} "
          f"x {k6['burst_ms']:.4f} ms (bursts) = "
          f"{layers * (k5['burst_ms'] + k6['burst_ms']) / 1e3:.4f} s of "
          f"{min(prefill_s):.4f} s")
    if profile:
        print(f"  in the profile: K5 {profile['flash_attention_ms']:.3f} ms, "
              f"K6 {profile['selective_scan_ms']:.3f} ms of "
              f"{profile['device_ms']:.3f} ms of device time")
        if profile["selective_scan_count"]:
            k6["device_ms"] = (profile["selective_scan_ms"]
                               / profile["selective_scan_count"])
            print(f"  K6 in the profile: {profile['selective_scan_count']} "
                  f"launches, {k6['device_ms']:.4f} ms per launch (burst "
                  f"{k6['burst_ms']:.4f} ms)")
    print(f"  phase: {time.perf_counter() - t:.1f} s")

    # 9. records
    launches = {"fused_server": fused_counts["fused_server"],
                "sq_dists": batched_counts["sq_dists"],
                "weighted_sum": batched_counts["weighted_sum"],
                "int8_sq_dists": int8_counts["int8_sq_dists"], **lm_counts}
    main_records = {name_k: records[(name_k,) + MAIN_SHAPE]
                    for name_k in ("fused_server", "sq_dists", "weighted_sum")}
    main_records.update(int8_sq_dists=int8_records[MAIN_SHAPE],
                        flash_attention=k5, selective_scan=k6)
    kernels = []
    for name_k, r in main_records.items():
        kernels.append({
            "name": name_k, "route": "cuda", "source": SOURCES[name_k],
            "replaces": TPU_KERNELS[name_k], "launches": launches[name_k],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "burst_ms": r["burst_ms"],
            "library_burst_ms": r["library_burst_ms"],
            "device_ms": r["device_ms"],
            "library_device_ms": r["library_device_ms"]})
    print(f"chip_smoke: {time.perf_counter() - started:.1f} s in all")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
