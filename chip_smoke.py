#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) end to end on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

1. Device line: the card's name and power limit from ``nvidia-smi``; TF32
   is switched off for cuDNN convolutions and for matmuls.
2. Build: compile ``src/repro_torch/csrc/{weighted_agg,ring_codec,
   flash_attn,ssm_scan}.cu`` for sm_90a, the four nvcc runs at once; print
   ptxas's registers, shared memory and spills of the instances of K1-K6,
   and the co-resident blocks that bound the cooperative grids of K1 and
   K4 (one launch each, with a grid-wide barrier inside).
3. Kernel phases: K1 (fused server pass), K2 (squared distances) and K3
   (weighted sum) against their plain PyTorch versions on the card, at the
   LeNet width (K=10, N=44,426), the engine's padded LeNet row (K=10,
   N=49,152), a ragged N (K=32, N=130,007) and a memory-bound N (K=16,
   N=16,777,219). K1 runs all 8 policies x normalize {mean, none} x with
   and without an arrival mask; its distances must equal K2's bit for bit
   and its update K3's on ``w * eta_g / k_eff`` bit for bit. Each phase
   checks that two launches give
   bit-identical distances and times kernel, plain version and library
   yardstick with CUDA events (median of 30 calls after 5 warm-up calls)
   beside the bytes bound. At the main-path shape kernel and yardstick are
   also timed as a burst (100 back-to-back calls between one event pair,
   divided by 100; still the host's rate where a call's dispatch outlasts
   its kernels) and by ``torch.profiler`` (the kernels' own device time per
   call, without the gaps in which the card waits for the host; reported
   only if every call left the same number of device operations). K1 and
   K4 must leave one device operation per call, their own kernel. K3 and
   its yardstick are also profiled at the ragged N (K=32, N=130,007), K1
   (and K4 below) also at the memory-bound N.
   K4 (int8 dequantize-distance) against its plain version at the engine's
   int8 ring (K=10, N=49,152, qblock 256), a ragged N (K=32, N=130,048,
   qblock 128), a single ragged tile (K=4, N=640, qblock 64) and a
   memory-bound N (K=16, N=16,777,216, qblock 256), with scale-0 blocks;
   bit-identical across launches; timed beside its bytes bound and, for
   reference, K2's time on f32 rows of the same (K, N); a burst and the
   profiled device time at the main-path shape and the memory-bound N.
   K2 is one launch a call (arrival tickets, one device operation); its
   distances equal K1's bit for bit at every shape, and two calls on
   another stream give the same bits.
4. Main path: ``repro_torch.core.run_async(engine="vectorized")`` at the
   paper's config (LeNet, 30 clients x 1500 samples, K=10, M=4, B=32,
   scenario paper-fig1, seed 0) for 10 rounds on the card in fused,
   batched and reference modes, with launch counts read around each run;
   the three agree, and the fused run agrees with the same run on the CPU.
   Then ``engine="legacy"`` (``AsyncServer`` + ``make_server_pass``, one
   local update per upload) at the same config on the card in fused (K1
   once a round) and batched (K2 and K3 once a round) modes and on the
   CPU: card against CPU, and legacy against vectorized round for round
   (versions, clients, tau exact; the float fields within the main path's
   tolerances); rounds/s of each run.
5. FedAvg rows: ``run_sync`` for 3 rounds on the card. The quickstart
   driver (``launch/quickstart.py``: 8 clients x 300, K=4, 20 rounds,
   paper and fedbuff) on the card: accuracy at r5/r10/r15/r20, its
   vectorized runs with an ``obs`` registry (dispatches, host syncs) and
   tracer (span names), and its legacy runs against them.
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
6b. Slice C. The cohort step (``make_cohort_step``) at the paper config
   (C = K = 10 slots, M = 4, B = 32) for 10 rounds of seeded arrival masks
   (stragglers; a round without the fresh slots; every slot arrived) in
   fused (K1 once a round), batched (K2 and K3 once a round) and reference
   modes on the card and reference on the CPU, params and telemetry round
   for round; ``make_dist_step`` for 2 x K contributions, card against CPU;
   ``aggregate_fused`` (one K3 launch) against ``aggregate``. Every
   kernel's counter is read after each of these runs, so the cohort's
   launches of K4-K6 (none) are measured too. Then, with cuDNN
   deterministic: ``serve_fl --transport inproc`` at the JAX launcher's
   defaults on the card, in a process of its own under the launcher's own
   backend flags, and in process on the CPU (the same counters, K
   trajectory, version and fold journal; params within the path
   tolerances); the fold and apply wall times; the serving-vs-exact gate
   for every policy with the exact side in fused mode (K1); ``serve_fl
   --transport tcp`` with three ``client_fl`` processes and its journal
   replayed by ``serve_fl --replay-journal`` (the same ``params_sha256``;
   a client may exit non-zero only with the transport error of the
   shutdown race, and one at least must exit 0); the http twin (served
   params byte-identical). Prints uploads folded per
   wall second, the round-latency p50/p99 on the sim clock, fold and apply
   ms and the cohort's rounds/s per mode beside the card's name and power
   limit.
6c. Slice D, the population engine. Draws: ``fold_in``, ``random_bits32``,
   ``randint`` (spans 7, 1500, 70000, 2^31-1) and ``uniform`` over 2^20
   (cid, k) pairs bit-identical card vs CPU, ``normal`` within 4 ulp (the
   largest gap printed). Windows: ``collect_windows`` on the card equal
   ``host_walk_windows(CounterBehavior(device="cuda"))`` exactly (clients,
   tau, slots, event count, times bit for bit) at N = 10,000, K = 64, 50
   windows (``paper-fig1`` and ``dropout-bernoulli``), in the re-entry
   case (N = 4, K = 3) and the forced-exact case (K > N); the events that
   differ from the CPU's windows are counted (not held). Scale:
   ``collect_windows`` at N = 1e4, 1e5, 1e6 (events/s cold, host reads per
   window, peak device memory above what was live before the sweep).
   Training: ``run_population`` at the paper config (30 clients) in fused
   (K1 = 10 launches), batched (K2 = K3 = 10) and reference (none) against
   ``run_vectorized`` over ``make_counter_clients`` + ``CounterBehavior``
   round for round and against the CPU; with the int8 ring fused (K4 = K3
   = 10) against int8 reference (none) round for round; at N = 1e6 over
   ``DevicePool.shared`` (the 45,000 paper samples, 1,500 a client), 10
   fused rounds: rounds/s after a warm-up run, host reads per round, peak
   memory above the pool and what else was live at the run's start, and a
   resume from round 5 bit-identical to the uninterrupted run (round log,
   params, ``PopState``) at the entry point's own cuDNN/TF32 flags, the
   caller's flags restored after each run.
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

The last two lines of standard output are the kernels' JSON record (with
each kernel's launches in the cohort runs and in the population runs beside
the main path's) and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
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
# profiled beside the main-path shape: K3 where K = 32 takes two row groups,
# K1 at the memory-bound N, K2 at both
PROFILED_TOO = {("weighted_sum", 32, 130_007), ("fused_server", 16, 16_777_219),
                ("sq_dists", 32, 130_007), ("sq_dists", 16, 16_777_219)}
# the quickstart driver (launch/quickstart.py): 20 rounds, evals every 5
QUICKSTART_EVALS = [0, 5, 10, 15, 20]
# K4 shapes (K, N, qblock); the first is the int8 main path's
INT8_SHAPES = ((10, 49_152, 256), (32, 130_048, 128), (4, 640, 64),
               (16, 16_777_216, 256))
# ring bytes of the paper config (LeNet, n_padded 49,152, R = 33)
RING_BYTES = {"f32": 6_488_064, "int8": 1_672_704, "delta": 845_524}
# Slice C. The cohort step at the paper config (C = K = 10 slots, M = 4,
# B = 32) for 10 rounds of seeded arrival masks; the dist step for 2 x K
# contributions. serve_fl at the JAX launcher's defaults (paper-fig1, 32
# clients x 64, K0 = 8 adaptive, M = 1, B = 8, 20 rounds); over sockets a
# fixed K = 8 for 4 rounds with 3 client processes, each offering at most 16
# uploads. The serving-vs-exact gate holds the served aggregate to
# apply_server_round within rtol 2e-5 / atol 1e-6 (the JAX package's
# tests/test_serving.py), on the 4-parameter quadratic problem.
COHORT_ROUNDS = 10
SERVE_ARGS = ["--scenario", "paper-fig1", "--clients", "32",
              "--samples-per-client", "64", "--log-level", "warning"]
SOCKET_ROUNDS, SOCKET_CLIENTS = 4, 3
# how a client_fl that pulls after the server shut down ends (the shutdown
# race): its last stderr line names the transport's connection error
SHUTDOWN_RACE = re.compile(
    r"^(repro_torch\.transport\.client\.TransportError|ConnectionError|"
    r"ConnectionRefusedError|ConnectionResetError|BrokenPipeError): ")
# serve_fl.run in a process of its own, as `python -m
# repro_torch.launch.serve_fl ARGS` runs it, saving the served params
SERVE_AND_SAVE = """\
import sys
import numpy as np
from repro_torch.core.serving import tree_to_wire
from repro_torch.launch import serve_fl
args = serve_fl.build_parser().parse_args(sys.argv[2:])
ctrl, _ = serve_fl.run(args)
assert ctrl.params["f3"]["w"].device.type == args.device, "params moved"
tensors = {}
tree_to_wire("params", ctrl.params, tensors)
np.savez(sys.argv[1], **tensors)
"""
GATE_RTOL, GATE_ATOL = 2e-5, 1e-6


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


def profiled_ms(torch, fn, n: int = 20, tries: int = 3):
    """Device milliseconds per call from ``torch.profiler``: the device
    operations' own durations over ``n`` back-to-back calls, divided by
    ``n``; the gaps in which the card waits for the host are not counted.
    For calls whose kernels take microseconds and whose dispatch takes
    longer (K1-K4 and their yardsticks at LeNet width); of millisecond
    kernels in such a loop the capture kept only some records, so a capture
    whose operations do not come to a whole number per call is taken again,
    up to ``tries`` times. Returns the time (None unless every call left the
    same number of device operations), the device operations recorded per
    call and the names of the device operations."""
    def calls():
        for _ in range(n):
            fn()

    for _ in range(tries):
        rows = device_events(torch, profiled(torch, calls))
        total = sum(us for _, _, us in rows)
        count = sum(c for _, c, _ in rows)
        whole = total > 0 and count % n == 0
        if whole:
            break
    names = {name for name, _, _ in rows}
    return (total / 1e3 / n if whole else None), count / n, names


def check_one_op(name: str, ops_per_call, names, kernel_part: str) -> None:
    """A kernel that must be one device operation per call: every recorded
    operation is its kernel, and no call left more than one."""
    check(len(names) == 1 and kernel_part in next(iter(names))
          and ops_per_call <= 1,
          f"{name}: {ops_per_call:g} device operations per call ({names})")


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


def bound_share(r) -> str:
    """The bound over the profiled device time, or n/a."""
    return "n/a" if not r["device_ms"] else \
        f"{100 * r['bound_ms'] / r['device_ms']:.0f}%"


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
        # a second stream keeps its own arrival tickets: the same bits
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            d3 = [ops.sq_dists(x, bases) for _ in range(2)]
        torch.cuda.current_stream().wait_stream(side)
        check(all(torch.equal(d1, d) for d in d3),
              f"K2 on a second stream differs at {(k, n)}")
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
        ones = torch.ones(k, device="cuda")
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
                    # K1 runs K2's and K3's code: the same bits as they give
                    check(torch.equal(dk, d1), f"{tag}: dists != K2's")
                    scale = (torch.tensor(cfg["eta_g"], dtype=torch.float32,
                                          device="cuda")
                             / torch.clamp((ones if m is None else m).sum(),
                                           min=1.0))
                    check(torch.equal(u, ops.weighted_sum(deltas, wk * scale)),
                          f"{tag}: upd != K3's on w * eta_g / k_eff")
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
            r["burst_ms"] = time_burst(torch, kern) if prof else None
            r["library_burst_ms"] = time_burst(torch, lib) \
                if main and lib else None
            # a capture of 20 millisecond calls loses records: take 5 there
            calls_n = 20 if k * n < 10**8 else 5
            r["device_ms"], r["device_ops"], names = profiled_ms(
                torch, kern, calls_n) if prof else (None, None, None)
            r["library_device_ms"], r["library_device_ops"], _ = \
                profiled_ms(torch, lib) if prof and lib else (None, None, None)
            if main and name == "sq_dists":
                check_one_op(f"K2 at {(k, n)}", r["device_ops"], names,
                             "sq_dist_kernel")
            if main and name == "fused_server":
                check_one_op(f"K1 at {(k, n)}", r["device_ops"], names,
                             "fused_server_kernel")
                _, masked_ops, masked_names = profiled_ms(
                    torch, lambda: ops.server_update(x, bases, deltas, p, taus,
                                                     mask, **cfg))
                check_one_op(f"K1 with a mask at {(k, n)}", masked_ops,
                             masked_names, "fused_server_kernel")
            bytes_ms = r["bytes"] / rate * 1e3
            ops_ms = r["ops"] / F32_FLOPS * 1e3
            r["bound_ms"] = max(bytes_ms, ops_ms)
            r["bound_by"] = "bytes" if bytes_ms >= ops_ms else "operations"
            lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
            print(f"  {name:13s} K={k:3d} N={n:>10,d}: kernel {r['ms']:.4f} ms"
                  f"  plain {r['plain_ms']:.4f} ms  library {lib} ms"
                  f"  bound {r['bound_ms']:.4f} ms ({r['bound_by']})"
                  f"  max_abs_err {r['max_abs_err']:.3g}")
            if r["burst_ms"] is not None:
                print(f"    burst of 100: kernel {r['burst_ms']:.4f} ms  "
                      f"library {fmt_ms(r['library_burst_ms'])} ms")
            if prof:
                lib_ops = r["library_device_ops"]
                print(f"    profiled device time: kernel "
                      f"{fmt_ms(r['device_ms'])} ms ({r['device_ops']:g} device"
                      f" ops per call, {bound_share(r)} of the bound)  library "
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
        if (k, n, qblock) in (INT8_SHAPES[0], INT8_SHAPES[-1]):
            r["burst_ms"] = time_burst(torch, lambda: rc_ops.int8_sq_dists(
                x, codes, scales, zeros, qblock=qblock))
            r["device_ms"], ops_per_call, names = profiled_ms(
                torch, lambda: rc_ops.int8_sq_dists(x, codes, scales, zeros,
                                                    qblock=qblock),
                20 if k * n < 10**8 else 5)
            r["device_ops"] = ops_per_call
            if (k, n, qblock) == INT8_SHAPES[0]:
                check_one_op(f"K4 at {(k, n, qblock)}", ops_per_call, names,
                             "int8_sq_dist_kernel")
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
                  f"device ops per call); {bound_share(r)} of the bound")
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
        check(ra["version"] == rb["version"] and ra["clients"] == rb["clients"]
              and ra["tau"] == rb["tau"],
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


def cohort_inputs(np, clients, c: int, m: int, b: int, seed: int = 0):
    """Host batches of ``COHORT_ROUNDS`` cohort rounds. Slot s serves one
    client until it arrives, then the next client in turn. Masks from a
    seeded generator: round 0 and the last round every slot arrives; round
    1 has stragglers; round 2 drops the slots that arrived in round 1 (its
    fresh, tau = 0 slots), so eq. 3's min runs over stale slots only."""
    rng = np.random.default_rng(seed)
    masks = []
    for r in range(COHORT_ROUNDS):
        if r in (0, COHORT_ROUNDS - 1):
            mask = np.ones(c, np.float32)
        elif r == 2:
            mask = 1.0 - masks[1]
        else:
            mask = np.zeros(c, np.float32)
            while not 0 < mask.sum() < c:
                mask = (rng.random(c) < 0.6).astype(np.float32)
        masks.append(mask)
    slot_client, nxt, rounds = list(range(c)), c, []
    for mask in masks:
        local = [clients[cid].batches(b, m) for cid in slot_client]
        probe = [clients[cid].batch(b) for cid in slot_client]
        rounds.append({
            "local": tuple(np.stack([x[i] for x in local]) for i in (0, 1)),
            "probe": tuple(np.stack([x[i] for x in probe]) for i in (0, 1)),
            "arrival": mask,
            "data_sizes": np.asarray([clients[cid].size
                                      for cid in slot_client], np.float32)})
        for slot in np.flatnonzero(mask):
            slot_client[slot] = nxt % len(clients)
            nxt += 1
    return rounds


def trees_close(np, a, b, rtol: float, atol: float) -> float:
    """Max abs difference of two nested dicts of tensors; checks allclose."""
    err = 0.0
    for layer in b:
        for key in b[layer]:
            x, y = a[layer][key].cpu().numpy(), b[layer][key].cpu().numpy()
            check(np.allclose(x, y, rtol=rtol, atol=atol),
                  f"{layer}/{key} differs by {np.abs(x - y).max()}")
            err = max(err, float(np.abs(x - y).max()))
    return err


def slice_c_phase(torch, np, kernel_ops, dataset, init, device: str):
    """The cohort step, the dist step, aggregate_fused, the serving loop in
    process and over sockets; returns the cohort's launch counts of every
    kernel (``kernel_ops``: the ops modules of weighted_agg, ring_codec,
    flash_attn and ssm_scan)."""
    from repro_torch.configs import PAPER_FL
    from repro_torch.core import (
        aggregate,
        aggregate_fused,
        init_cohort_state,
        init_dist_state,
        make_cohort_step,
        make_dist_step,
    )
    from repro_torch.models import lenet_loss

    ops, rc_ops, fa_ops, ss_ops = kernel_ops

    def reset_launches():
        for module in kernel_ops:
            module.reset_launches()

    def launches():
        return {"fused_server": ops.server_update.launches,
                "sq_dists": ops.sq_dists.launches,
                "weighted_sum": ops.weighted_sum.launches,
                "int8_sq_dists": rc_ops.int8_sq_dists.launches,
                "flash_attention": fa_ops.flash_attention.launches,
                "selective_scan": ss_ops.selective_scan.launches}

    none = dict.fromkeys(SOURCES, 0)

    # cohort step: fused, batched and reference on the card, reference on
    # the CPU, round for round
    clients, _ = dataset()
    c, m, b = PAPER_FL.buffer_size, PAPER_FL.local_steps, PAPER_FL.batch_size
    rounds = cohort_inputs(np, clients, c, m, b)
    arrivals = [int(r["arrival"].sum()) for r in rounds]
    print(f"cohort step: paper config, C = K = {c}, M = {m}, B = {b}, "
          f"{COHORT_ROUNDS} rounds, arrivals per round {arrivals}")

    def cohort(mode, dev):
        fl = dataclasses.replace(PAPER_FL, server_pass_mode=mode)
        step = make_cohort_step(lenet_loss, fl, device=dev)
        state = init_cohort_state({l: {k: v.to(dev) for k, v in p.items()}
                                   for l, p in init.items()}, c)
        reset_launches()
        t = time.perf_counter()
        out = []
        for batch in rounds:
            state, mets = step(state, batch)
            out.append((state.global_params, mets))
        if dev == "cuda":
            torch.cuda.synchronize()
        dt = time.perf_counter() - t
        counts = launches()
        out = [(p, {k: float(v) for k, v in mets.items()}) for p, mets in out]
        print(f"  cohort {mode:9s} on {dev}: {COHORT_ROUNDS / dt:.2f} "
              f"rounds/s ({dt:.3f} s), launches {counts}")
        check(all(np.isfinite(list(mets.values())).all() for _, mets in out),
              f"cohort {mode}: telemetry not finite")
        return out, counts, COHORT_ROUNDS / dt

    cohort("fused", device)  # warm-up
    runs = {mode: cohort(mode, device)
            for mode in ("fused", "batched", "reference")}
    cpu_run = cohort("reference", "cpu")
    counts = {mode: run[1] for mode, run in runs.items()}
    check(counts["fused"] == {**none, "fused_server": COHORT_ROUNDS},
          f"cohort fused {counts}")
    check(counts["batched"] == {**none, "sq_dists": COHORT_ROUNDS,
                                "weighted_sum": COHORT_ROUNDS},
          f"cohort batched {counts}")
    check(counts["reference"] == none and cpu_run[1] == none,
          f"cohort reference {counts}, on the CPU {cpu_run[1]}")
    # the cohort's launches of each kernel: its three runs on the card
    cohort_launches = {k: sum(c[k] for c in counts.values()) for k in none}
    for name, (other, _, _) in list(runs.items())[1:] + [("cpu", cpu_run)]:
        err = 0.0
        for r, ((pa, ma), (pb, mb)) in enumerate(zip(runs["fused"][0],
                                                     other)):
            for key in ma:
                check(np.isclose(ma[key], mb[key], rtol=PATH_RTOL,
                                 atol=PATH_ATOL),
                      f"cohort fused vs {name}, round {r}: {key} "
                      f"{ma[key]} vs {mb[key]}")
            err = max(err, trees_close(np, pa, pb, PATH_RTOL, PATH_ATOL))
        print(f"  cohort fused vs {name}: params and telemetry within rtol "
              f"{PATH_RTOL}, atol {PATH_ATOL} every round; params max abs "
              f"diff {err:.3g}")
    last = runs["fused"][0][-1][1]
    print(f"  last round: {last}")
    cohort_rates = {mode: run[2] for mode, run in runs.items()}

    # dist step: 2 x K contributions, card against CPU
    rng = np.random.default_rng(1)
    contributions = [{"local": clients[i % len(clients)].batches(b, m),
                      "probe": clients[i % len(clients)].batch(b),
                      "tau": int(rng.integers(0, 4)),
                      "data_size": float(clients[i % len(clients)].size)}
                     for i in range(2 * c)]
    dist = {}
    for dev in (device, "cpu"):
        step = make_dist_step(lenet_loss, PAPER_FL, device=dev)
        state = init_dist_state({l: {k: v.to(dev) for k, v in p.items()}
                                 for l, p in init.items()}, PAPER_FL)
        reset_launches()
        vs = []
        for batch in contributions:
            state, mets = step(state, batch)
            vs.append(float(mets["v_weight"]))
        check(launches() == none,
              f"dist step: the streaming round reaches no kernel, "
              f"{launches()}")
        dist[dev] = (state, np.asarray(vs))
    (st, vs), (st_cpu, vs_cpu) = dist[device], dist["cpu"]
    check(st.version == st_cpu.version == 2 and st.count == 0,
          f"dist step: version {st.version}, count {st.count}")
    check(np.allclose(vs, vs_cpu, rtol=PATH_RTOL, atol=PATH_ATOL),
          f"dist step weights {vs} vs {vs_cpu}")
    err = trees_close(np, st.global_params, st_cpu.global_params, PATH_RTOL,
                      PATH_ATOL)
    print(f"  dist step, {2 * c} contributions: 2 applies; card vs CPU "
          f"weights and params within rtol {PATH_RTOL}, atol {PATH_ATOL} "
          f"(params max abs diff {err:.3g})")

    # aggregate_fused: one K3 launch against aggregate
    g = torch.Generator().manual_seed(2)
    params = {l: {k: v.to(device) for k, v in p.items()}
              for l, p in init.items()}
    deltas = {l: {k: (0.01 * torch.randn((c,) + tuple(v.shape),
                                         generator=g)).to(device)
                  for k, v in p.items()} for l, p in init.items()}
    w = (0.5 + torch.rand(c, generator=g)).to(device)
    reset_launches()
    new_f, upd_f = aggregate_fused(params, deltas, w, PAPER_FL.global_lr, c)
    check(launches() == {**none, "weighted_sum": 1},
          f"aggregate_fused: one K3 launch, {launches()}")
    new_a, upd_a = aggregate(params, deltas, w, PAPER_FL.global_lr, c)
    err = trees_close(np, upd_f, upd_a, KERNEL_RTOL, 1e-7)
    trees_close(np, new_f, new_a, SUM_RTOL, 1e-7)
    print(f"  aggregate_fused: 1 K3 launch, update within rtol {KERNEL_RTOL} "
          f"of aggregate's (max abs diff {err:.3g})")

    # deterministic cuDNN, as serve_fl sets it for a journaled run (the
    # http twin compares two controllers of this process bit for bit);
    # the previous flags go back afterwards
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        serving = serving_phase(torch, np, ops, device)
    finally:
        cudnn.deterministic, cudnn.benchmark = saved
    return {"launches": cohort_launches, "rates": cohort_rates, **serving}


def serving_phase(torch, np, ops, device: str):
    """serve_fl on the card in a process of its own and on the CPU in
    this one, the serving-vs-exact gate in fused mode, fold and apply
    times, serve_fl/client_fl over tcp with a journal replay, and the http
    twin."""
    from repro_torch.configs.base import FLConfig
    from repro_torch.core import ServeConfig, ServingController
    from repro_torch.core.serving import tree_to_wire
    from repro_torch.core.weighting import POLICIES
    from repro_torch.launch import serve_fl
    from repro_torch.models import init_lenet, lenet_loss
    from repro_torch.sim import draw_upload, get_scenario
    from repro_torch.transport import wire
    from repro_torch.transport.client import RemoteAggregator
    from repro_torch.transport.server import AggregatorServer

    print("serving: serve_fl --transport inproc at the launcher's defaults "
          "(paper-fig1, 32 clients x 64, K0 = 8 adaptive, M = 1, B = 8, "
          "20 rounds; journaled, so cudnn.deterministic), on the card in a "
          "process of its own, on the CPU in this one")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    (ROOT / "build").mkdir(exist_ok=True)

    def folds_of(path):
        with open(path) as f:
            return [(e["cid"], e["seq"], e["tau"])
                    for e in map(json.loads, f)]

    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        path, saved = Path(tmp) / "folds_card.jsonl", Path(tmp) / "card.npz"
        proc = subprocess.run(
            [sys.executable, "-c", SERVE_AND_SAVE, str(saved), *SERVE_ARGS,
             "--device", device, "--journal-out", str(path), "--json"],
            env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
        check(proc.returncode == 0,
              f"serve_fl on {device}: exit {proc.returncode}, "
              f"{proc.stderr[-2000:]}")
        out, folds = json.loads(proc.stdout), folds_of(path)
        with np.load(saved) as z:
            card_params = {k: z[k] for k in z.files}
        path = Path(tmp) / "folds_cpu.jsonl"
        cpu_ctrl, cpu_out = serve_fl.run(serve_fl.build_parser().parse_args(
            SERVE_ARGS + ["--device", "cpu", "--journal-out", str(path)]))
        cpu_folds = folds_of(path)
    cpu_out = json.loads(json.dumps(cpu_out))  # as the card's run printed it
    for key in ("admitted", "rejected_queue_full", "dropped_stale_ingress",
                "dropped_stale_queue", "folded", "rounds", "version",
                "k_history", "round_latency_p50", "round_latency_p99"):
        check(out[key] == cpu_out[key],
              f"serving {key}: {out[key]} vs {cpu_out[key]}")
    check(folds == cpu_folds and len(folds) == out["folded"],
          "serving fold journals differ")
    cpu_params = {}
    tree_to_wire("params", cpu_ctrl.params, cpu_params)
    check(card_params.keys() == cpu_params.keys(), "serving params' names")
    err = 0.0
    for k, x in cpu_params.items():
        check(np.allclose(card_params[k], x, rtol=PATH_RTOL, atol=PATH_ATOL),
              f"serving params {k} differ by "
              f"{np.abs(card_params[k] - x).max()}")
        err = max(err, float(np.abs(card_params[k] - x).max()))
    print(f"  card vs CPU: counters, K trajectory {out['k_history']}, "
          f"version {out['version']} and the journal of {len(folds)} folds "
          f"identical; params max abs diff {err:.3g} (rtol {PATH_RTOL}, "
          f"atol {PATH_ATOL})")
    serve = {"uploads_per_s": out["uploads_per_sec"],
             "cpu_uploads_per_s": cpu_out["uploads_per_sec"],
             "p50": out["round_latency_p50"], "p99": out["round_latency_p99"]}

    # fold and apply wall time on the card: K - 1 folds, then one fold and
    # the apply, each pump between synchronisations
    sc = get_scenario("paper-fig1")
    clients, _ = sc.make_dataset(32, samples_per_client=64, seed=0)
    fl = FLConfig(num_clients=32, buffer_size=8, max_staleness=12,
                  local_steps=1, batch_size=8)
    timed = ServingController(lenet_loss, init_lenet(
        torch.Generator().manual_seed(0)), fl, ServeConfig(adapt_every=0),
        device=device)
    fold_ms, apply_ms = [], []
    for rnd in range(4):
        ups = [draw_upload(clients[i], i, fl, base_version=timed.version,
                           t=0.0) for i in range(8 * rnd, 8 * rnd + 8)]
        for up in ups[:-1]:
            timed.offer(up, 0.0)
        torch.cuda.synchronize()
        t = time.perf_counter()
        timed.pump(0.0)
        torch.cuda.synchronize()
        fold = (time.perf_counter() - t) / 7 * 1e3
        timed.offer(ups[-1], 0.0)
        t = time.perf_counter()
        timed.pump(0.0)
        torch.cuda.synchronize()
        if rnd:  # round 0 warms up
            fold_ms.append(fold)
            apply_ms.append((time.perf_counter() - t) * 1e3 - fold)
    check(timed.version == 4, f"timed controller version {timed.version}")
    serve["fold_ms"] = statistics.median(fold_ms)
    serve["apply_ms"] = statistics.median(apply_ms)

    # the serving-vs-exact gate with the exact side in fused mode (K1)
    ops.reset_launches()
    for policy in POLICIES:
        serving_gate(torch, np, policy, device)
    check(ops.server_update.launches == 3 * len(POLICIES),
          f"gate K1 launches {ops.server_update.launches}")
    print(f"  serving vs apply_server_round (fused, K1 {3 * len(POLICIES)} "
          f"launches): every policy, 3 rounds, within rtol {GATE_RTOL}, "
          f"atol {GATE_ATOL}")

    # over sockets: serve_fl tcp + client_fl processes, then the replay
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        port_file, journal = Path(tmp) / "port", Path(tmp) / "folds.jsonl"
        cmd = [sys.executable, "-m"]
        procs = [subprocess.Popen(
            cmd + ["repro_torch.launch.serve_fl", *SERVE_ARGS, "--device",
                   device, "--transport", "tcp", "--port", "0",
                   "--port-file", str(port_file), "--adapt-every", "0",
                   "--rounds", str(SOCKET_ROUNDS), "--journal-out",
                   str(journal), "--max-wall-time", "240", "--json"],
            env=env, cwd=ROOT, stdout=subprocess.PIPE, text=True)]
        # clients draw numpy batches and never touch a device: they run
        # with no card visible
        procs += [subprocess.Popen(
            cmd + ["repro_torch.launch.client_fl", *SERVE_ARGS, "--cid",
                   str(cid), "--port-file", str(port_file), "--port-wait",
                   "180", "--uploads", "16", "--stop-at-version",
                   str(SOCKET_ROUNDS)],
            env=dict(env, CUDA_VISIBLE_DEVICES=""), cwd=ROOT,
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
            for cid in range(SOCKET_CLIENTS)]
        try:
            outs, errs = zip(*[p.communicate(timeout=300) for p in procs])
        finally:
            for p in procs:
                p.kill()
                p.wait()
        check(procs[0].returncode == 0,
              f"tcp server exit code {procs[0].returncode}")
        live = json.loads(outs[0])
        check(live["version"] >= SOCKET_ROUNDS,
              f"tcp server stopped at version {live['version']}")
        # a client that pulls after the server reached its rounds and shut
        # down loses the race and exits non-zero with the transport's
        # connection error: fine; any other exit, or a hung client, is not
        admitted = []
        for p, o, e in zip(procs[1:], outs[1:], errs[1:]):
            if p.returncode == 0:
                admitted.append(json.loads(o)["admitted"])
                continue
            last = (e.strip().splitlines() or [""])[-1]
            check(SHUTDOWN_RACE.match(last) is not None,
                  f"client_fl exit {p.returncode}: {e[-2000:]}")
            admitted.append(f"lost the shutdown race: {last[:100]}")
        check(any(p.returncode == 0 for p in procs[1:]),
              f"no client_fl exited 0: {admitted}")
        replay = json.loads(subprocess.run(
            cmd + ["repro_torch.launch.serve_fl", *SERVE_ARGS, "--device",
                   device, "--replay-journal", str(journal), "--json"],
            env=env, cwd=ROOT, capture_output=True, text=True, timeout=300,
            check=True).stdout)
    check(replay["replayed"] == live["folded"]
          and replay["params_sha256"] == live["params_sha256"],
          f"tcp run vs replay: {live['params_sha256']} vs "
          f"{replay['params_sha256']}")
    print(f"  tcp: serve_fl on {device} + {SOCKET_CLIENTS} client_fl "
          f"processes (no card visible), {live['folded']} folds to version {live['version']} "
          f"in {live['seconds']:.2f} s (clients admitted {admitted}); "
          f"replay of the journal on {device}: params_sha256 "
          f"{replay['params_sha256'][:16]} equal")

    # the http twin: in-process controller against RemoteAggregator
    def drive(service, pump, ds):
        for seq in range(16):
            version, _ = service.pull()
            up = draw_upload(ds[seq % 4], seq % 4, fl, base_version=version,
                             t=float(seq), seq=seq // 4)
            check(service.offer(up, float(seq)).accepted, "http offer")
            pump()
        return service.pull()

    def controller():
        return ServingController(lenet_loss, init_lenet(
            torch.Generator().manual_seed(0)), fl, ServeConfig(adapt_every=0),
            device=device)

    twin = controller()
    v_twin, p_twin = drive(twin, lambda: twin.pump(1e9), sc.make_dataset(
        32, samples_per_client=64, seed=0)[0])
    ctrl = controller()
    srv = AggregatorServer(ctrl, transport="http")
    srv.start()
    try:
        client = RemoteAggregator("127.0.0.1", srv.port, transport="http")
        v_sock, p_sock = drive(client, lambda: ctrl.pump(srv.clock()),
                               sc.make_dataset(32, samples_per_client=64,
                                               seed=0)[0])
        client.close()
    finally:
        srv.shutdown()
    twin_tensors = {}
    tree_to_wire("params", p_twin, twin_tensors)
    sock_tensors = {}
    tree_to_wire("params", p_sock, sock_tensors)
    check(v_twin == v_sock == 2 and all(
        twin_tensors[k].tobytes() == sock_tensors[k].tobytes()
        for k in twin_tensors) and wire.params_sha256(v_twin, p_twin)
        == wire.params_sha256(v_sock, p_sock), "http twin differs")
    print("  http twin: 16 uploads through RemoteAggregator over http == "
          "the in-process controller, served params byte-identical")
    return serve


def serving_gate(torch, np, policy: str, device: str) -> None:
    """tests/test_serving.py's acceptance gate on the card: 3 rounds of K = 4
    uploads at tau 0..3 through the controller, against apply_server_round
    in fused mode on bases whose eq. 3 distances are the ring's."""
    from repro_torch.configs.base import FLConfig
    from repro_torch.core import (
        ServeConfig,
        ServingController,
        Upload,
        apply_server_round,
        flatten_stacked,
        flatten_tree,
        make_flat_spec,
        make_local_update_fn,
        unflatten_like,
    )

    def quad_loss(params, batch):
        x, y = batch
        return torch.mean((x @ params["w"] - y) ** 2), {}

    k = 4
    fl = FLConfig(buffer_size=k, local_steps=1, local_lr=0.1,
                  weighting=policy, normalize="mean", global_lr=1.0,
                  max_staleness=k)
    ctrl = ServingController(quad_loss, {"w": np.array(
        [1.0, -1.0, 0.5, 2.0], np.float32)}, fl,
        ServeConfig(adapt_every=0, k_max=8), device=device)
    ctrl.update_norm_ring = torch.tensor([0.3, 0.2, 0.1, 0.05],
                                         device=device)
    local_update = make_local_update_fn(quad_loss, 1, 0.1)
    taus, sizes = [0, 1, 2, 3], [10.0, 20.0, 30.0, 40.0]
    rng = np.random.default_rng(0)

    def batch():
        x = rng.normal(size=(8, 4)).astype(np.float32)
        return x, (x @ np.arange(1.0, 5.0) + 0.01 * rng.normal(
            size=8)).astype(np.float32)

    def dev(tree):
        return tuple(torch.from_numpy(a).to(device) for a in tree)

    t = 0.0
    for rnd in range(3):
        x_tree, ring = ctrl.params, ctrl.update_norm_ring.clone()
        uploads, deltas, losses = [], [], []
        for i in range(k):
            stacked, probe = tuple(a[None] for a in batch()), batch()
            deltas.append(local_update(x_tree, dev(stacked))[0]["w"])
            losses.append(quad_loss(x_tree, dev(probe))[0])
            uploads.append((stacked, probe))
        for i, (stacked, probe) in enumerate(uploads):
            t += 0.1
            up = Upload(client_id=i, base_version=ctrl.version - taus[i],
                        data_size=sizes[i], batch=stacked, probe=probe,
                        sent_at=t)
            check(ctrl.offer(up, t).accepted, "gate offer")
            ctrl.pump(t)
        check(ctrl.version == rnd + 1, "gate: the K-th fold applied")
        dists = torch.stack([ring[:tt].sum() for tt in taus])
        spec = make_flat_spec(x_tree)
        x = flatten_tree(spec, x_tree)
        bases = x[None] - torch.sqrt(dists)[:, None] * torch.eye(
            spec.n_padded, device=device)[:k]
        new_x, _ = apply_server_round(
            x, bases, flatten_stacked(spec, {"w": torch.stack(deltas)}),
            torch.stack(losses), torch.tensor(sizes, device=device),
            torch.tensor(taus, dtype=torch.float32, device=device), fl,
            mode="fused")
        got = ctrl.params["w"].cpu().numpy()
        want = unflatten_like(spec, new_x)["w"].cpu().numpy()
        check(np.allclose(got, want, rtol=GATE_RTOL, atol=GATE_ATOL),
              f"gate {policy} round {rnd}: {got} vs {want}")


# Slice D. Draws: ~1e6 (cid, k) pairs, card against CPU. Events: N = 10,000
# clients, K = 64, 50 windows (bench_population_scale.py's sweep config:
# max_staleness 8) in paper-fig1 and dropout-bernoulli; the re-entry case (N =
# 4, K = 3) and the forced-exact case (K > N). Scale: collect_windows at N =
# 1e4, 1e5, 1e6. Training: the paper's 30 clients (DevicePool.from_clients),
# and N = 1e6 clients over DevicePool.shared of the paper's 45,000 samples,
# 1,500 a client (DESIGN.md section 10's scale), 10 rounds each.
POP_DRAWS = 1 << 20
NORMAL_ULPS = 4
POP_WINDOW_N, POP_K, POP_WINDOWS, POP_STALENESS = 10_000, 64, 50, 8
POP_SCALE_N = (10_000, 100_000, 1_000_000)
POP_BIG_N, POP_PER_CLIENT, POP_RESUME_AT = 1_000_000, 1_500, 5


def slice_d_phase(torch, np, kernel_ops, dataset, init, device: str):
    """The population engine: draws, windows, scale and training on the
    card; returns the population runs' launch counts of every kernel and the
    numbers the summary prints."""
    from repro_torch.configs import PAPER_FL
    from repro_torch.configs.base import FLConfig
    from repro_torch.launch import population_scale
    from repro_torch.models import lenet_loss
    from repro_torch.obs import MetricsRegistry
    from repro_torch.sim import get_scenario
    from repro_torch.sim.engine import run_vectorized
    from repro_torch.sim.population import (
        CounterBehavior,
        DevicePool,
        collect_windows,
        host_walk_windows,
        init_population,
        make_counter_clients,
        run_population,
    )
    from repro_torch.utils import threefry

    ops, rc_ops, fa_ops, ss_ops = kernel_ops
    out = {}

    def launches():
        return {"fused_server": ops.server_update.launches,
                "sq_dists": ops.sq_dists.launches,
                "weighted_sum": ops.weighted_sum.launches,
                "int8_sq_dists": rc_ops.int8_sq_dists.launches,
                "flash_attention": fa_ops.flash_attention.launches,
                "selective_scan": ss_ops.selective_scan.launches}

    def reset_launches():
        for module in kernel_ops:
            module.reset_launches()

    none = dict.fromkeys(SOURCES, 0)
    population_launches = dict(none)

    # draws: the card's against the CPU's over ~1e6 (cid, k) pairs
    t = time.perf_counter()
    g = torch.Generator().manual_seed(19)
    cid = torch.randint(0, 2 ** 31 - 1, (POP_DRAWS,), generator=g,
                        dtype=torch.int32)
    kk = torch.randint(0, 1 << 16, (POP_DRAWS,), generator=g,
                       dtype=torch.int32)

    def keys(dev):
        return threefry.fold_in(threefry.fold_in(threefry.fold_in(
            threefry.prng_key(0, dev), 101), cid.to(dev)), kk.to(dev))

    card, host = keys(device), keys("cpu")
    check(torch.equal(card.k0.cpu(), host.k0)
          and torch.equal(card.k1.cpu(), host.k1), "fold_in card vs CPU")
    check(torch.equal(threefry.random_bits32(card, (2,)).cpu(),
                      threefry.random_bits32(host, (2,))),
          "random_bits32 card vs CPU")
    for hi in (7, 1_500, 70_000, 2 ** 31 - 1):
        check(torch.equal(threefry.randint(card, (), 0, hi).cpu(),
                          threefry.randint(host, (), 0, hi)),
              f"randint span {hi}: card vs CPU")
    check(torch.equal(threefry.uniform(card, (), 0.0, 24.0).cpu(),
                      threefry.uniform(host, (), 0.0, 24.0)),
          "uniform card vs CPU")
    a = threefry.normal(card).cpu().numpy().view(np.int32).astype(np.int64)
    b = threefry.normal(host).numpy().view(np.int32).astype(np.int64)
    ulps = int(np.abs(a - b).max())
    check(ulps <= NORMAL_ULPS, f"normal card vs CPU: {ulps} ulp")
    print(f"draws: {POP_DRAWS:,} (cid, k) pairs; fold_in, random_bits32, "
          f"randint (spans 7, 1500, 70000, 2^31-1) and uniform bit-identical "
          f"card vs CPU; normal largest gap {ulps} ulp (limit {NORMAL_ULPS}); "
          f"{time.perf_counter() - t:.1f} s")

    # windows: the card's collect_windows against the host twin on the
    # card's own draws, exactly; and against the CPU's collect_windows
    def fl_for(n, k):
        return FLConfig(num_clients=n, buffer_size=k, local_steps=1,
                        batch_size=8, max_staleness=POP_STALENESS)

    def windows_equal(a, b):
        return (all(np.array_equal(a[f], b[f])
                    for f in ("clients", "tau", "slots", "t"))
                and a["num_events"] == b["num_events"])

    cases = [("paper-fig1", POP_WINDOW_N, POP_K, POP_WINDOWS, 0),
             ("dropout-bernoulli", POP_WINDOW_N, POP_K, POP_WINDOWS, 0),
             ("paper-fig1", 4, 3, 12, 5), ("dropout-bernoulli", 4, 3, 12, 5),
             ("paper-fig1", 3, 5, 6, 1)]
    for preset, n, k, windows, seed in cases:
        t = time.perf_counter()
        sc = get_scenario(preset)
        reg = MetricsRegistry()
        dev_w = collect_windows(sc, n, fl_for(n, k), windows, seed=seed,
                                device=device, registry=reg)
        host_w = host_walk_windows(CounterBehavior(sc, n, seed=seed,
                                                   device=device),
                                   fl_for(n, k), windows)
        check(windows_equal(dev_w, host_w),
              f"{preset} N={n} K={k}: card windows differ from the host twin")
        cpu_w = collect_windows(sc, n, fl_for(n, k), windows, seed=seed,
                                device="cpu")
        differ = int(np.sum((dev_w["clients"] != cpu_w["clients"])
                            | (dev_w["t"] != cpu_w["t"])))
        reads = reg.snapshot()["engine_host_syncs_total"]
        print(f"  windows {preset} N={n:,} K={k} x {windows}: card == host "
              f"twin (clients, tau, slots, t bit for bit, "
              f"{dev_w['num_events']} events); events differing card vs "
              f"CPU {differ}; host reads {reads:g} "
              f"({time.perf_counter() - t:.1f} s)")

    # scale: the events-only sweep of launch/population_scale.py
    out["scale"] = []
    for n in POP_SCALE_N:
        rec = population_scale.device_record(n, POP_WINDOWS,
                                             torch.device(device))
        rec["peak_mib"] = rec["peak_device_bytes"] / 2 ** 20
        out["scale"].append(rec)
        print(f"  collect_windows paper-fig1 N={n:>9,}: "
              f"{rec['events_per_s']:,.1f} events/s ({rec['events']} "
              f"events, median {rec['seconds']:.3f} s of 3 cold runs after "
              f"a warm-up run), "
              f"{rec['host_reads_per_window']:.2f} host reads/window, peak "
              f"device memory {rec['peak_mib']:.1f} MiB")

    # where a window's time goes at N = 1e6: device time and device
    # operations of 10 windows from a fixed state, against their wall time
    sc = get_scenario("paper-fig1")
    n = POP_SCALE_N[-1]
    fl_big = fl_for(n, POP_K)
    statics0, state0 = init_population(sc, n, fl_big, device=device)

    def ten_windows():
        return collect_windows(sc, n, fl_big, 10, device=device,
                               statics=statics0, state=state0,
                               registry=MetricsRegistry())

    ten_windows()
    torch.cuda.synchronize()
    t = time.perf_counter()
    ten_windows()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t) * 1e3 / 10
    rows = device_events(torch, profiled(torch, ten_windows))
    dev_ms = sum(r[2] for r in rows) / 1e3 / 10
    n_ops = sum(r[1] for r in rows) / 10
    top = ", ".join(f"{k[:40]} {us / 1e3 / 10:.3f} ms" for k, _, us in rows[:3])
    out["window_profile"] = {"wall_ms": wall_ms, "device_ms": dev_ms,
                             "ops": n_ops}
    print(f"  a window at N = {n:,}: {wall_ms:.3f} ms wall, {dev_ms:.3f} ms "
          f"of device time ({100 * dev_ms / wall_ms:.1f}% busy) in "
          f"{n_ops:.0f} device operations; largest: {top}")

    # training at the paper's 30 clients: run_population against
    # run_vectorized over the counter twins, and card against CPU
    rounds = 10

    def pop_run(mode, dev, codec="f32", data=None, total=rounds, **kw):
        clients, _ = dataset()
        fl = dataclasses.replace(PAPER_FL, server_pass_mode=mode,
                                 ring_codec=codec)
        reg = MetricsRegistry()
        reset_launches()
        t = time.perf_counter()
        res = run_population(lenet_loss, init,
                             clients if data is None else data, fl, total,
                             scenario=sc, seed=0, device=dev, registry=reg,
                             **kw)
        if dev == "cuda":
            torch.cuda.synchronize()
        dt = time.perf_counter() - t
        counts = launches()
        if dev == "cuda":
            for name_k, c in counts.items():
                population_launches[name_k] += c
        done = total - (kw["init_state"].version if "init_state" in kw
                        else 0)
        syncs = reg.snapshot()["engine_host_syncs_total"]
        return res, counts, done / dt, syncs / done

    print(f"population training: paper-fig1, 30 clients x 1500, K=10, M=4, "
          f"B=32, {rounds} rounds")
    pop_run("fused", device)  # warm-up
    runs, out["rates_30"] = {}, {}
    for mode, codec, want in (
            ("fused", "f32", {**none, "fused_server": rounds}),
            ("batched", "f32", {**none, "sq_dists": rounds,
                                "weighted_sum": rounds}),
            ("reference", "f32", none),
            ("fused", "int8", {**none, "int8_sq_dists": rounds,
                               "weighted_sum": rounds}),
            ("reference", "int8", none)):
        res, counts, rate, reads = pop_run(mode, device, codec)
        check(counts == want, f"population {mode}/{codec} launches {counts}")
        check(res.server_rounds == rounds, f"population {mode}/{codec}")
        runs[mode, codec] = res
        out["rates_30"][f"{mode}/{codec}"] = rate
        print(f"  run_population {mode:9s} {codec:4s} on {device}: "
              f"{rate:.2f} rounds/s, {reads:.2f} host reads/round, "
              f"launches {counts}")
    clients, _ = dataset()
    reset_launches()
    twin = run_vectorized(lenet_loss, init,
                          make_counter_clients(clients, seed=0),
                          dataclasses.replace(PAPER_FL,
                                              server_pass_mode="fused"),
                          rounds, seed=0, device=device,
                          behavior=CounterBehavior(sc, PAPER_FL.num_clients,
                                                   seed=0, device=device))
    for mode in ("fused", "batched", "reference"):
        compare_runs(np, runs[mode, "f32"], twin,
                     f"population {mode} vs run_vectorized over the twins")
        check(runs[mode, "f32"].num_events == twin.num_events
              and runs[mode, "f32"].sim_time == twin.sim_time,
              f"population {mode}: events or sim time differ from the twin")
    compare_runs(np, runs["fused", "int8"], runs["reference", "int8"],
                 "population int8 ring fused (K4 + K3) vs reference")
    cpu, _, _, _ = pop_run("fused", "cpu")
    compare_runs(np, runs["fused", "f32"], cpu,
                 "population fused on cuda vs on cpu")

    # training at N = 1e6: DevicePool.shared over the paper's 45,000 samples
    clients, _ = dataset()
    x = np.concatenate([c.x for c in clients])
    y = np.concatenate([c.y for c in clients])
    pool = DevicePool.shared(x, y, POP_BIG_N, POP_PER_CLIENT).to(device)
    print(f"population training at N = {POP_BIG_N:,}: DevicePool.shared over "
          f"{len(x):,} samples, {POP_PER_CLIENT} a client, fused, {rounds} "
          f"rounds")
    pop_run("fused", device, data=pool)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    live = torch.cuda.memory_allocated()
    _, counts, rate, reads = pop_run("fused", device, data=pool)
    peak = (torch.cuda.max_memory_allocated() - live) / 2 ** 20
    pool_mib = sum(t.numel() * t.element_size() for t in pool) / 2 ** 20
    check(counts == {**none, "fused_server": rounds},
          f"N = 1e6 launches {counts}")
    # the resume at run_population's own flags, not the smoke's: it sets
    # its own cuDNN/TF32 flags and puts these back
    cudnn = torch.backends.cudnn
    flags = (cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    full, _, _, _ = pop_run("fused", device, data=pool, capture_state=True)
    half, _, _, _ = pop_run("fused", device, data=pool, total=POP_RESUME_AT,
                            capture_state=True)
    resumed, _, _, _ = pop_run("fused", device, data=pool,
                               init_state=half.final_state, capture_state=True)
    check((cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32) == flags,
          "run_population did not restore the backend flags")
    check(resumed.round_log == full.round_log, "N = 1e6: resumed round log")
    check(all(torch.equal(resumed.final_params[l][k], v)
              for l, p in full.final_params.items() for k, v in p.items()),
          "N = 1e6: resumed final params")
    check(all(np.array_equal(getattr(resumed.final_state, f),
                             getattr(full.final_state, f))
              for f in ("t_next", "k_next", "batch_k", "base_version"))
          and resumed.num_events == full.num_events
          and resumed.sim_time == full.sim_time,
          "N = 1e6: resumed PopState differs")
    check(all(np.isfinite(r["weights"]).all() for r in full.round_log),
          "N = 1e6: weights not finite")
    out.update(rate_1e6=rate, reads_1e6=reads, peak_1e6=peak,
               events_1e6=full.num_events)
    print(f"  N = {POP_BIG_N:,}: {rate:.2f} rounds/s (after a warm-up run), "
          f"{reads:.2f} host reads/round, peak device memory {peak:.1f} MiB "
          f"above the {pool_mib:.1f} MiB pool and the rest live at its "
          f"start, {full.num_events} events; resume (run_population's own "
          f"flags) at round {POP_RESUME_AT} to {rounds}: round log, params "
          f"and PopState bit-identical")
    out["launches"] = population_launches
    return out


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
    from repro_torch.launch import quickstart, serve
    from repro_torch.obs import MetricsRegistry, Tracer
    from repro_torch.models import Model, apply_lenet, init_lenet, lenet_loss
    from repro_torch.sim import get_scenario
    from repro_torch.sim.engine import (
        engine_state_from_tree,
        engine_state_to_tree,
        init_version_ring,
    )

    # 1. device line
    line = card = device_line()
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
    for lib, part in ((kernel.LIBRARY, "fused_server_kernel"),
                      (kernel.LIBRARY, "sq_dist"),
                      (kernel.LIBRARY, "weighted_sum_kernel"),
                      (rc_kernel.LIBRARY, "int8_sq_dist_kernel"),
                      (fa_kernel.LIBRARY, "flash_fwd"),
                      (ss_kernel.LIBRARY, "selective_scan_kernel")):
        for line in ptxas_lines(lib.ptxas_info, part):
            print(f"  {line}")
    # the cooperative grids: min(work, co-resident blocks)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for what, blocks in (
            ("K1 float4 instance, K=10",
             kernel.fused_resident_blocks(MAIN_SHAPE[0], True)),
            ("K1 scalar instance, K=10",
             kernel.fused_resident_blocks(MAIN_SHAPE[0], False)),
            ("K4 16-byte instance", rc_kernel.resident_blocks(True)),
            ("K4 element instance", rc_kernel.resident_blocks(False))):
        print(f"  co-resident blocks, {what}: {blocks} ({blocks / sms:g} "
              f"per SM of {sms})")

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

    def run(mode, device, codec="f32", total=rounds, engine="vectorized",
            **kw):
        clients, _ = dataset()  # fresh per run: batch streams are stateful
        fl = dataclasses.replace(PAPER_FL, server_pass_mode=mode,
                                 ring_codec=codec)
        ops.reset_launches()
        rc_ops.reset_launches()
        t = time.perf_counter()
        res = run_async(lenet_loss, init, clients, fl, total,
                        eval_fn=eval_fn_for(device), eval_every=5, seed=0,
                        scenario=sc, engine=engine, device=device, **kw)
        if device == "cuda":
            torch.cuda.synchronize()
        dt = time.perf_counter() - t
        counts = {"fused_server": ops.server_update.launches,
                  "sq_dists": ops.sq_dists.launches,
                  "weighted_sum": ops.weighted_sum.launches,
                  "int8_sq_dists": rc_ops.int8_sq_dists.launches}
        done = total - (kw["init_state"].version if "init_state" in kw else 0)
        print(f"  run_async {engine:10s} {mode:9s} {codec:5s} on {device}: "
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

    # 4b. the per-event legacy engine (AsyncServer + make_server_pass) at
    # the same config: on the card in fused and batched modes, on the CPU
    print(f"legacy engine: paper-fig1, 30 clients x 1500, K=10, M=4, B=32, "
          f"{rounds} rounds")
    legacy_fused, legacy_fused_counts = run("fused", "cuda", engine="legacy")
    check(legacy_fused_counts == {"fused_server": rounds, "sq_dists": 0,
                                  "weighted_sum": 0, "int8_sq_dists": 0},
          f"legacy fused launches {legacy_fused_counts}")
    legacy_batched, legacy_batched_counts = run("batched", "cuda",
                                                engine="legacy")
    check(legacy_batched_counts == {"fused_server": 0, "sq_dists": rounds,
                                    "weighted_sum": rounds,
                                    "int8_sq_dists": 0},
          f"legacy batched launches {legacy_batched_counts}")
    legacy_cpu, _ = run("fused", "cpu", engine="legacy")
    compare_runs(np, legacy_fused, legacy_cpu,
                 "legacy fused on cuda vs legacy on cpu")
    compare_runs(np, legacy_fused, legacy_batched,
                 "legacy fused vs legacy batched")
    compare_runs(np, fused, legacy_fused, "vectorized vs legacy (fused)")
    compare_runs(np, batched, legacy_batched, "vectorized vs legacy (batched)")
    # the same evals at the same times; accuracy within one test sample of
    # 1,024 (params equal to PARAM_ATOL can flip a borderline sample)
    check(legacy_fused.num_events == fused.num_events
          and legacy_fused.sim_time == fused.sim_time
          and [(h["round"], h["time"]) for h in legacy_fused.history]
          == [(h["round"], h["time"]) for h in fused.history]
          and all(abs(a["acc"] - b["acc"]) <= 1 / 1024 + 1e-7
                  for a, b in zip(legacy_fused.history, fused.history)),
          "legacy vs vectorized: events, sim time or evals differ")

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

    # 5b. the quickstart driver, both weightings; the vectorized run with
    # an obs registry and a tracer
    print("quickstart driver: 8 clients x 300, K=4, M=4, B=32, paper-fig1, "
          "20 rounds")
    registry, tracer = MetricsRegistry(), Tracer()
    t = time.perf_counter()
    qs = quickstart.run(device="cuda", registry=registry, tracer=tracer)
    qs_s = time.perf_counter() - t
    launches_qs = 0
    for weighting, out in qs.items():
        res = out["result"]
        launches_qs += res.num_launches
        accs = [h["acc"] for h in res.history]
        check([h["round"] for h in res.history] == QUICKSTART_EVALS
              and all(0.0 <= a <= 1.0 for a in accs) and accs[-1] > accs[0],
              f"quickstart {weighting}: evals {res.history}")
        print(f"  {weighting}: acc at r5/r10/r15/r20 "
              f"{[round(a, 4) for a in accs[1:]]} (r0 {accs[0]:.4f}); "
              f"telemetry {out['telemetry']}")
    snap = registry.snapshot()
    names = sorted({e["name"] for e in tracer.to_json()["traceEvents"]})
    check(snap["engine_dispatches_total"] == launches_qs
          and snap["engine_host_syncs_total"] == len(qs)
          and names == ["apply", "collect_window", "host_sync"],
          f"quickstart obs: {snap} {names}")
    print(f"  obs registry: dispatches {snap['engine_dispatches_total']:g}, "
          f"host syncs {snap['engine_host_syncs_total']:g}, launch seconds "
          f"sum {snap['engine_launch_seconds_sum']:.4f} over "
          f"{snap['engine_launch_seconds_count']:g}; spans {names} "
          f"({len(tracer.events)} events); {qs_s:.1f} s for both runs")
    qs_legacy = quickstart.run(device="cuda", engine="legacy")
    for weighting in qs:
        compare_runs(np, qs[weighting]["result"],
                     qs_legacy[weighting]["result"],
                     f"quickstart {weighting}: vectorized vs legacy")

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

    # 6b. Slice C: the cohort step, the dist step, aggregate_fused and the
    # serving loop (in process, over tcp with a journal replay, http twin)
    t = time.perf_counter()
    slice_c = slice_c_phase(torch, np, (ops, rc_ops, fa_ops, ss_ops),
                            dataset, init, "cuda")
    rates = slice_c["rates"]
    print(f"  Slice C numbers ({card}): cohort rounds/s fused "
          f"{rates['fused']:.2f}, batched {rates['batched']:.2f}, reference "
          f"{rates['reference']:.2f}; serve_fl inproc uploads folded per "
          f"wall second {slice_c['uploads_per_s']:.2f} (CPU "
          f"{slice_c['cpu_uploads_per_s']:.2f}), round latency on the sim "
          f"clock p50 {slice_c['p50']:.4f} s, p99 {slice_c['p99']:.4f} s; "
          f"fold {slice_c['fold_ms']:.3f} ms, apply {slice_c['apply_ms']:.3f}"
          f" ms (wall, synchronised, median of 3 rounds)")
    print(f"  phase: {time.perf_counter() - t:.1f} s")

    # 6c. Slice D: the population engine (draws, windows, scale, training
    # at N = 30 and N = 1e6 with a bit-identical resume)
    t = time.perf_counter()
    slice_d = slice_d_phase(torch, np, (ops, rc_ops, fa_ops, ss_ops),
                            dataset, init, "cuda")
    scale = ", ".join(f"N={r['n']:,} {r['events_per_s']:,.0f} events/s "
                      f"{r['host_reads_per_window']:.2f} reads/window "
                      f"{r['peak_mib']:.1f} MiB" for r in slice_d["scale"])
    print(f"  Slice D numbers ({card}): collect_windows {scale}; "
          f"run_population rounds/s at N = 30 "
          f"{', '.join(f'{k} {v:.2f}' for k, v in slice_d['rates_30'].items())}"
          f"; at N = {POP_BIG_N:,} {slice_d['rate_1e6']:.2f} rounds/s, "
          f"{slice_d['reads_1e6']:.2f} host reads/round, peak "
          f"{slice_d['peak_1e6']:.1f} MiB above the pool")
    print(f"  phase: {time.perf_counter() - t:.1f} s")

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
            "library_device_ms": r["library_device_ms"],
            "cohort_launches": slice_c["launches"][name_k],
            "population_launches": slice_d["launches"][name_k]})
    print(f"chip_smoke: {time.perf_counter() - started:.1f} s in all")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
