#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) end to end on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

1. Device line: the card's name and power limit from ``nvidia-smi``; TF32
   is switched off for cuDNN convolutions and for matmuls.
2. Build: compile ``src/repro_torch/csrc/{weighted_agg,ring_codec,
   flash_attn,ssm_scan,flash_attn_bwd,ssm_scan_bwd}.cu`` for sm_90a, the
   six nvcc runs at once; print ptxas's registers, shared memory and spills
   of the instances of K1-K6 (K5 at D = 32, 64, 128, 160, 256) and of the
   two backward kernels,
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
6d. Slice E, the distributed round substrate. Worlds of ranks that share
   the card over gloo (``launch/multihost.spawn_world``; the kernels were
   built before the spawn; the world is killed on the first rank failure or
   at a timeout), paper config, 10 rounds after a warm-up, TF32 off and
   cuDNN deterministic in every rank: (data=1, model=2) f32 batched and
   fused (K2 = K3 = 10 a rank, K1 none), fused with a replicated ring (bit-
   identical to the sharded ring), int8 fused (K4 = K3 = 10 a rank), the
   ring bytes a rank equal to ``ring_device_bytes``; (2, 2) f32 fused, a
   checkpoint at round 5 written by rank 0 and resumed bit-identically on
   every rank, the cohort step against the single-rank cohort step, only
   rank 0's sink file; (2, 1) fused (K1 = 10 a rank); (2, 2) on the CPU
   against (2, 2) on the card within the path tolerances. Every rank's
   round log, history, params and launch counts equal rank 0's bit for
   bit; each card world's round log is within the JAX package's sharding
   tolerances of the single-rank card run. Prints rounds/s, launches a
   rank, the collectives' count, host ms and bytes a round per world, and
   whether gloo's ``all_gather`` took CUDA tensors as they are.
7. K5 (flash attention) against its plain version at Hymba-1.5B's shapes
   (B=2, S=4096, 25 query and 5 kv heads, D=64) in bf16 and f32, window
   1024 and 0 (causal), a ragged S (3001) and an S shorter than the window
   (700); K6 (selective scan) at Hymba's widths (B=2, S=4096, di=3200,
   N=16), a ragged S (1001) and the Jamba2-Mini prefill cell's shape (B=2,
   S=65,536, di=8,192: 2^30 elements, every channel against the plain
   scan). Each timed beside its bound and its plain
   version; K5 also beside ``scaled_dot_product_attention`` (enable_gqa, a
   boolean band mask), the port never calls it. K5's bf16 instance runs on
   the tensor cores (wgmma fed by TMA), its f32 instance on the CUDA cores;
   the rows' lse each writes for the backward against the plain lse.
   At the prefill's shapes K5, SDPA and K6 are also timed as a burst of
   back-to-back calls (device time: these kernels outlast their dispatch);
   K6 also at the ragged S. The RMSNorm kernels (``csrc/rms_norm.cu``,
   forward and backward) against the plain chain at the prefill cell's
   rows (2 x 32,768 x 1,600, bf16, one weight), the Hymba training cell's
   (4 slots x 2,048 x 1,600, bf16, a weight a slot) and the DeepSeekMoE
   training cell's (2 slots x 2,048 x 2,048, a weight a slot: the 8-vector
   instances) and the Jamba2-Mini prefill cell's (2 x 65,536 rows: d 4,096
   bf16 on the block kernels; the f32 dt and C norms, d 256 and 16, read at
   the 288-float row stride of their ``x_proj`` output), bit-identical over
   two launches, timed per call and as a
   burst beside their bytes bound and the plain chain; ptxas's registers
   and spills of each instance, and of the instances each case runs.
8. LM serving path, Hymba-1.5B at full width: ``Model.prefill_logits`` at
   full depth (32 layers, bf16, port init from a seeded generator on the
   card), B=2, S=4096, launching K5 and K6 exactly 32 times each and the
   RMSNorm forward 4 x 32 + 1 times, finite
   logits, prefill tokens/s and peak memory, and a ``torch.profiler``
   capture of one warm prefill (its ten largest device operations, K5's
   and K6's share, K6's device time per launch); the same weights at 2
   layers, S=512, on the card against the CPU (f32 and bf16); decode
   against the full forward at 4 layers, f32, S=1536 (the 1024-slot ring
   cache wraps); ``launch/serve.py`` at full depth (batch 4, prompt 32,
   gen 16).
8a. Jamba2-Mini's layered stack at the prefill cell's configuration (16
   layers, 8 of 16 experts held, bf16, B=2, S=65,536): one warm
   ``prefill_logits`` with the counters zeroed launches K5 once a NoPE
   attention layer (2), K6 once a Mamba layer (14) and the RMSNorm forward
   2 x 16 + 3 x 14 + 1 times, routes 2 x 131,072 pairs (``moe.pairs_held``
   + ``moe.pairs_absent``) in each of its 8 MoE layers, and gives finite
   logits; its time and peak memory are printed.
9. Slice F2, the serving path of the other archs (bf16 unless named):
   (f) K5 at the seven archs' prefill shapes (deepseek-moe-16b D=128,
   stablelm-12b D=160, gemma-7b D=256, pixtral-12b S=4352, qwen1.5-110b
   H=64/8, arctic-480b H=56/8, whisper-tiny S=448) in bf16 and f32 against
   its plain version, timed per call and as a burst beside its bound and
   SDPA (causal, GQA); (a) deepseek-moe-16b at full width and depth: init
   on the card (its peak below params + one layer), ``prefill_logits`` at
   B=2, S=4096 (28 K5 launches and no other kernel's, finite logits,
   tokens/s, peak memory), the share of token-choices dropped per layer at
   cf 1.25 and a profile of one prefill; (b) each new arch on the card
   against the CPU at full width, 1-2 layers, S=256, f32 and bf16 (the MoE
   archs and qwen1.5-110b layer by layer on one input shared by both
   sides: the MoE's routing compared first, a flip allowed only at a
   near-tie, then its combine under the card's routing); (c) decode
   against the full forward, f32: deepseek-moe-16b at 2 layers (dropless)
   and whisper-tiny at full size through ``prefill_cross``; (d)
   ``serve.py`` at full depth for deepseek-moe-16b and whisper-tiny; (e)
   ``prefill_logits`` at full width: pixtral-12b, stablelm-12b and gemma-7b
   at full depth, qwen1.5-110b at 2 layers and arctic-480b at 1 (the card
   holds neither whole), whisper-tiny at S=448; K5 launches = layers. Each
   model is freed before the next, and the card's allocated memory must
   return to where it was.

10. Slice F3, LM training: (a) K5's backward kernel (bf16: the wgmma
   instance; f32: the CUDA-core one), on the forward kernel's o and lse,
   against its plain backward formula on the same o and lse at the
   training run's shape (B = 4, S = 2048), at
   Hymba's prefill shapes (B=2, S=4096, 25/5 heads, D=64; window 1024 and
   0; bf16 and f32), a ragged S (3001) and deepseek-moe-16b's D = 128,
   two launches bit-identical, timed per call and as a burst beside its
   bound (10 D FLOP a visible pair) and SDPA's backward (band mask, GQA);
   each record names its instance, its share of the bound, its ratio to
   SDPA's backward and ptxas's registers and spills of its kernels;
   (b) K6's backward at the training shape (an A per slot), Hymba's widths
   with a shared and a per-row A and a ragged S (1001), the per-row-A
   forward against its plain version, bit-identical twice, beside its
   bytes bound, each record with ptxas's registers and spills of both its
   kernels (every instance, N 4 to 32, at 0 spills: checked), the walk's
   resident blocks an SM, the grid's waves and the share of the bound;
   (c) ``torch.func.grad`` of ``Model.loss`` at Hymba's full width, 2
   layers, S=512, f32: card against CPU, under ``vmap`` over 3
   clients against 3 calls (one launch a pass), ``ce_chunk`` and
   ``remat_block`` against the plain run; (d) the training run through
   ``launch/train.py``'s ``TrainLoop``: Hymba-1.5B at full width in bf16,
   6 of 32 layers, cohort C=4, K=3, M=2, b=1, S=2048, fused, 1 warm-up and
   3 timed rounds, every round's launches exact (K5 and K6 forward 5L,
   backward 2L, K1 1, K2-K4 0), finite fresh losses, the version one up a
   round; rounds/s, trained tokens/s, the host's batch seconds and peak
   memory; then ``launch/train.py --arch hymba-1.5b --smoke --rounds 3``
   in a process of its own.

11. Slice F4, training of the MoE, encoder-decoder and patch archs: (a)
   K5's backward at D 160 and 256 (stablelm-12b's and gemma-7b's training
   shapes, bf16 and f32) against its plain backward, bit-identical twice,
   timed beside its bound and SDPA's backward; (b) ``grad`` of
   ``Model.loss`` at full width, 1 layer (whisper-tiny: all 4 + 4), f32,
   S=256: card against CPU (the MoE's routing compared first, then its
   gradients under the card's routing) and, through the layers' remat as
   the round runs them, ``vmap`` over 2 slots against separate calls (the
   MoE's vmapped routing equal to the calls' first); (c) ``TrainLoop`` at
   full width in bf16: whisper-tiny at full size (C=4), deepseek-moe-16b
   at the deepest depth a 1-layer probe says fits 72 GiB (C=2; one round
   twice from one state the same bits, a profile, the drop share),
   stablelm-12b, gemma-7b and pixtral-12b at 1 layer (C=2), launches exact
   every round; (d) the Hymba peak of phase 10 beside the one before the
   memory repair; (e) ``launch/train.py --arch deepseek-moe-16b --smoke``
   in a process of its own.

12. Slice G, the Program builders of ``launch/program.py`` on the card at
   full width in bf16, each on a 1 x 1 shape-only mesh, the batch one data
   rank's share of the production shape (global_batch / 16): (a)
   hymba-1.5b prefill_32k at full depth (B 2, S 32,768): exactly 32
   launches each of K5 and K6, logits bit-identical to a direct
   ``Model.prefill_logits`` call, tokens/s after a warm-up, peak memory;
   (b) decode_32k (B 8, a 1,024-slot ring, 16 tokens): each token
   bit-identical to a direct ``Model.decode_step``, tokens/s; (c) train_4k
   through the cohort builder, 6 of 32 layers, cohort 1, b 1 (cut from
   16), S 4096, ``DRYRUN_FL`` (M 2), fused, 1 warm-up + 2 timed rounds,
   launches exact every round (K5 and K6 forward 5L, backward 2L, K1 1);
   (d) K5's backward at qwen1.5-110b's training shape (B 1, S 4096, H
   64/8, D 128, causal, bf16) against its plain backward and beside SDPA's
   backward and its bound, then qwen1.5-110b train_4k through the dist
   builder at full width, 1 of 80 layers, b 1, S 4096, buffer 2: two
   contributions (the second applies), K5's launches exact, applied 0 then
   1, version 0 -> 1, the peak within 72 GiB, the same bits from one state
   twice, contributions/s; (e) ``python -m repro_torch.launch.dryrun``
   for hymba-1.5b and qwen1.5-110b, four shapes each on the single-pod
   mesh, one process an arch: every record ``ok``. Every Program's real
   arguments are held to its ``arg_sds`` shapes and dtypes.

The last two lines of standard output are the kernels' JSON record (with
each kernel's launches in the cohort runs, in the population runs, a rank
in each Slice E run, the Slice F2 prefill and the Slice F3 training run
beside the main path's, and in each of phase 12's Programs; K5's record
lists its F2 shapes; the two backward kernels' records their launches in
the training run and their other shapes, K5's its phase 12 shape) and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import math
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
# K5's lse (the rows' log-sum-exps it writes for the backward) vs the plain
# lse: f32 sums in other orders and the tensor cores' exp2 (rtol); an lse
# 1e-4 off moves the backward's p by 1e-4 relative, far inside its tolerance
LSE_RTOL, LSE_ATOL = 1e-5, 1e-4
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
# Jamba2-Mini's prefill cell (portbench's jamba2-mini-prefill-b2-s64k):
# its 16 layers (2 NoPE attention, 14 Mamba-1, 8 MoE) over B 2 x S 65,536
JAMBA_B, JAMBA_S, JAMBA_DI, JAMBA_LAYERS = 2, 65536, 8192, 16
JAMBA_DT_RANK, JAMBA_XPROJ = 256, 256 + 2 * 16  # x_proj's output: dt, B, C
# K6's (B, S, d_inner), N 16: the Hymba prefill's (first), a ragged S, and
# Jamba's 2^30 elements
SCAN_CASES = ((HYMBA_B, 4096, HYMBA_DI), (HYMBA_B, 1001, HYMBA_DI),
              (JAMBA_B, JAMBA_S, JAMBA_DI))
# RMSNorm rows (label, rows, weight groups, d, dtype, column): the Hymba
# prefill cell's B 2 x S 32,768 with one weight, the Hymba training cell's C
# 4 slots x b 1 x S 2,048 with a weight a slot (d 1,600: 7 vectors a lane),
# the DeepSeekMoE training cell's C 2 slots at d 2,048 (8 vectors a lane),
# all bf16 and contiguous; the Jamba prefill cell's residual norms (d 4,096:
# the block kernels) and its f32 dt and C norms, read as the columns from
# ``column`` of an (rows, 288) ``x_proj`` output
NORM_CASES = (("prefill", 2 * 32768, 1, 1600, "bfloat16", None),
              ("train", 4 * 2048, 4, 1600, "bfloat16", None),
              ("dsmoe-train", 2 * 2048, 2, 2048, "bfloat16", None),
              ("jamba-prefill", JAMBA_B * JAMBA_S, 1, 4096, "bfloat16", None),
              ("jamba-dt", JAMBA_B * JAMBA_S, 1, JAMBA_DT_RANK, "float32", 0),
              ("jamba-c", JAMBA_B * JAMBA_S, 1, 16, "float32",
               JAMBA_DT_RANK + 16))

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


def ptxas_usage(report, part: str):
    """{mangled name: (registers, spill store bytes, spill load bytes)} of
    the kernels of a ptxas report whose mangled names contain ``part``."""
    out, name = {}, None
    for line in ptxas_lines(report, part):
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            out[name] = [None, None, None]
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            out[name][1:] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name][0] = int(m.group(1))
    return {k: tuple(v) for k, v in out.items()}


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
        out, lse = fa_ops.flash_attention_lse(q, k, v, window=window)
        check(torch.equal(out, fa_ops.flash_attention(q, k, v, window=window)),
              f"K5 not bit-identical at S={s} window={window} {dtype_name}")
        want, want_lse = fa_ref.flash_attention_ref(q, k, v, window=window,
                                                    with_lse=True)
        rtol, atol = ATTN_TOL[dtype_name]
        err = float((out.float() - want.float()).abs().max())
        check(torch.allclose(out.float(), want.float(), rtol=rtol, atol=atol),
              f"K5 vs plain at S={s} window={window} {dtype_name}: max abs "
              f"err {err}")
        lse_err = float((lse - want_lse).abs().max())
        check(torch.allclose(lse, want_lse, rtol=LSE_RTOL, atol=LSE_ATOL),
              f"K5's lse vs plain at S={s} window={window} {dtype_name}: max "
              f"abs err {lse_err}")
        del want, want_lse, lse
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
              f"max_abs_err {err:.3g}  lse max_abs_err {lse_err:.3g}")
        records[(s, window, dtype_name)] = r
        del q, k, v, out, qt, kt, vt, mask
        torch.cuda.empty_cache()
    return records


def scan_kernel_phase(torch, ss_ops, ss_ref, rate: float):
    """Hold K6 against its plain version at ``SCAN_CASES``; returns
    per-case records."""
    n = HYMBA_N
    records = {}
    for b, s, di in SCAN_CASES:
        # the plain scan walks S steps from Python: once at Jamba's S
        plain_reps = (2, 1) if s <= 4096 else (1, 0)
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
              f"K6 not bit-identical at B={b} S={s} di={di}")
        want = ss_ref.selective_scan_ref(*args)
        err = float((y - want).abs().max())
        check(torch.allclose(y, want, rtol=SCAN_RTOL,
                             atol=SCAN_ATOL_REL * float(want.abs().max())),
              f"K6 vs plain at B={b} S={s} di={di}: max abs err {err}")
        del want
        nbytes = (3 * b * s * di + 2 * b * s * n + di * n) * 4
        flops = 6 * b * s * di * n
        bytes_ms = nbytes / rate * 1e3
        ops_ms = flops / F32_FLOPS * 1e3
        r = dict(
            ms=time_ms(torch, lambda: ss_ops.selective_scan(*args), reps=10,
                       warmup=2),
            plain_ms=time_ms(torch, lambda: ss_ref.selective_scan_ref(*args),
                             reps=plain_reps[0], warmup=plain_reps[1]),
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
        records[(b, s, di)] = r
        del x, dt, bb, c, a, y
        torch.cuda.empty_cache()
    return records


def norm_launches(cfg, grads: int = 0, forwards: int = 1):
    """(forward, backward) RMSNorm launches of ``forwards`` forwards
    (prefill, probe, decode step) and ``grads`` gradients of ``Model.loss``
    of ``cfg``, the vmapped calls of a pass folded into one launch: a
    gradient runs each layer's norms twice (the layer's remat recompute)
    and the final norm once, and backward each once."""
    if cfg.norm != "rmsnorm":
        return 0, 0
    per_layer = (4 if cfg.is_hybrid else 1 if cfg.is_ssm_only else 2) \
        + 2 * bool(cfg.qk_norm)
    n = per_layer * cfg.num_layers
    return forwards * (n + 1) + grads * (2 * n + 1), grads * (n + 1)


def norm_kernel_phase(torch, rn_kernel, rn_ops, rn_ref, rate: float):
    """Hold the RMSNorm kernels against their plain versions at
    ``NORM_CASES``; returns per-case records."""
    # registers and spills of every instance, printed at the end; each case
    # also prints those of the bf16 "rows" instances it runs
    usage = ptxas_usage(rn_kernel.LIBRARY.ptxas_info, "rms_")
    records = {}
    for label, rows, groups, d, dtype_name, column in NORM_CASES:
        dtype = getattr(torch, dtype_name)
        bf16 = dtype == torch.bfloat16
        size = 2 if bf16 else 4
        g = torch.Generator(device="cuda").manual_seed(rows + groups)
        if column is None:
            x = (3 * torch.randn(rows, d, device="cuda", generator=g)).to(
                dtype)
        else:  # d columns of an x_proj output, at its row stride
            x = (3 * torch.randn(rows, JAMBA_XPROJ, device="cuda",
                                 generator=g)).to(dtype)[:, column:column + d]
        dy = torch.randn(rows, d, device="cuda", generator=g).to(dtype)
        w = 0.1 * torch.randn((groups, d) if groups > 1 else (d,),
                              device="cuda", generator=g)
        rn_ops.reset_launches()
        y, rstd = rn_ops.rms_norm_rstd(x, w)
        dx, dw = rn_ops.rms_norm_bwd(x, w, rstd, dy)
        again = rn_ops.rms_norm_rstd(x, w) + rn_ops.rms_norm_bwd(x, w, rstd,
                                                                  dy)
        torch.cuda.synchronize()
        check((rn_ops.rms_norm.launches, rn_ops.rms_norm_bwd.launches)
              == (2, 2), "RMSNorm launches")
        check(all(torch.equal(a, b) for a, b in zip((y, rstd, dx, dw), again)),
              f"RMSNorm not bit-identical ({label})")
        want_y, _ = rn_ref.rms_norm_ref(x, w)
        if bf16:
            ulps = int((y.view(torch.int16).int()
                        - want_y.view(torch.int16).int()).abs().max())
            check(ulps <= 1,
                  f"RMSNorm y vs plain ({label}): {ulps} bf16 ulps")
            y_note = f"y within {ulps} bf16 ulp"
        else:  # f32: only the row sum's order differs
            ulps = None
            y_err = float(((y - want_y).abs()
                           - 1e-5 * want_y.abs()).max())
            check(y_err <= 1e-6, f"RMSNorm y vs plain ({label}): {y_err:.3g} "
                  f"past rtol 1e-5")
            y_note = f"y within rtol 1e-5 (+{max(y_err, 0.0):.3g})"
        want_dx, want_dw = rn_ref.rms_norm_bwd_ref(x, w, dy)
        dx_err = float((dx.float() - want_dx.float()).abs().max()) / float(
            want_dx.float().abs().max())
        dw_err = float((dw - want_dw).abs().max()) / float(
            want_dw.abs().max())
        check(dx_err <= (2.0 ** -8 if bf16 else 1e-5) and dw_err <= 1e-4,
              f"RMSNorm backward vs plain ({label}): dx {dx_err:.3g}, dw "
              f"{dw_err:.3g} of the largest")
        del want_y, want_dx, want_dw
        fwd_bytes = 2 * rows * d * size + groups * d * 4 + rows * 4
        bwd_bytes = 3 * rows * d * size + rows * 4 + 2 * groups * d * 4
        # the instance of a bf16 row up to d 2,048: 8 elements a vector, a
        # warp a row (the other cases' instances are in the list at the end)
        nv = -(-(d // 8) // 32) if bf16 and d <= 2048 else None
        ptxas = {kind: v for kind in ("fwd", "bwd") for k, v in usage.items()
                 if nv and f"rms_{kind}_rowsI13__nv_bfloat16Li{nv}E" in k}
        r = dict(
            rows=rows, d=d, groups=groups, dtype=dtype_name, column=column,
            y_ulps=ulps, dx_err=dx_err,
            dw_err=dw_err, vectors_a_lane=nv, ptxas=ptxas,
            ms=time_ms(torch, lambda: rn_ops.rms_norm(x, w)),
            burst_ms=time_burst(torch, lambda: rn_ops.rms_norm(x, w), n=50),
            plain_ms=time_ms(torch, lambda: rn_ref.rms_norm_ref(x, w),
                             reps=10),
            bound_ms=fwd_bytes / rate * 1e3,
            bwd_ms=time_ms(torch, lambda: rn_ops.rms_norm_bwd(x, w, rstd, dy)),
            bwd_burst_ms=time_burst(
                torch, lambda: rn_ops.rms_norm_bwd(x, w, rstd, dy), n=50),
            bwd_plain_ms=time_ms(
                torch, lambda: rn_ref.rms_norm_bwd_ref(x, w, dy), reps=10),
            bwd_bound_ms=bwd_bytes / rate * 1e3)
        # device time alone (at the training shape a call's dispatch
        # outlasts its kernel, so the burst is the host's rate there)
        r["device_ms"], ops_fwd, _ = profiled_ms(
            torch, lambda: rn_ops.rms_norm(x, w))
        r["bwd_device_ms"], ops_bwd, _ = profiled_ms(
            torch, lambda: rn_ops.rms_norm_bwd(x, w, rstd, dy))
        check(ops_fwd == 1 and ops_bwd == 2,
              f"RMSNorm device operations a call: {ops_fwd}, {ops_bwd}")
        print(f"  rms_norm {label}: {rows:,d} x {d} {dtype_name}"
              f"{'' if column is None else f' (columns of {JAMBA_XPROJ})'}, "
              f"{groups} weight(s): forward kernel {r['ms']:.4f} ms, burst "
              f"{r['burst_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({fwd_bytes:,d} B); backward kernel "
              f"{r['bwd_ms']:.4f} ms, burst {r['bwd_burst_ms']:.4f} ms, plain "
              f"{r['bwd_plain_ms']:.4f} ms, bound {r['bwd_bound_ms']:.4f} ms "
              f"({bwd_bytes:,d} B); profiled device ms forward "
              f"{fmt_ms(r['device_ms'])}, backward "
              f"{fmt_ms(r['bwd_device_ms'])}; {y_note}, dx "
              f"{dx_err:.3g}, dw {dw_err:.3g} of the largest; ptxas of the "
              f"{nv}-vector instances (registers, spill stores, spill loads) "
              f"{ptxas}")
        records[label] = r
        del x, dy, w, y, rstd, dx, dw, again
        torch.cuda.empty_cache()
    print("  ptxas (registers, spill stores, spill loads): " + "; ".join(
        f"{k} {v}" for k, v in usage.items()))
    return records


def jamba_phase(torch, fa_ops, ss_ops, rn_ops, get_arch):
    """Jamba2-Mini's layered stack at the prefill cell's configuration: one
    warm ``prefill_logits`` with the counters zeroed; returns its K5, K6 and
    RMSNorm launches, its routed pairs, its time and its peak."""
    from repro_torch.models.model import build_model
    from repro_torch.obs.metrics import default_registry

    cfg = get_arch("jamba2-mini").model.replace(num_layers=JAMBA_LAYERS,
                                                 experts_held=8)
    kinds = cfg.layer_counts()
    check(kinds == {"attn": 2, "ssm": 14, "mlp": 8, "moe": 8},
          f"Jamba layer kinds {kinds}")
    t = time.perf_counter()
    model = build_model(cfg, "cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    batch = {"tokens": torch.randint(
        0, cfg.vocab_size, (JAMBA_B, JAMBA_S), device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(1))}
    reg = default_registry()
    names = ("moe.pairs_held", "moe.pairs_absent")
    with torch.no_grad():
        model.prefill_logits(params, batch)  # first call pays the set-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa_ops.reset_launches()
        ss_ops.reset_launches()
        rn_ops.reset_launches()
        before = {k: reg.counter(k).value for k in names}
        t = time.perf_counter()
        logits = model.prefill_logits(params, batch)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t
        counts = {"flash_attention": fa_ops.flash_attention.launches,
                  "selective_scan": ss_ops.selective_scan.launches,
                  "rms_norm": rn_ops.rms_norm.launches}
        pairs = {k: int(reg.counter(k).value - before[k]) for k in names}
        peak = torch.cuda.max_memory_allocated()
    # norm1 and norm2 a layer, dt / B / C a Mamba layer, the final norm
    want = {"flash_attention": kinds["attn"], "selective_scan": kinds["ssm"],
            "rms_norm": 2 * cfg.num_layers + 3 * kinds["ssm"] + 1}
    check(counts == want, f"Jamba prefill launches {counts}, want {want}")
    routed = cfg.experts_per_token * JAMBA_B * JAMBA_S * kinds["moe"]
    check(sum(pairs.values()) == routed and min(pairs.values()) > 0,
          f"Jamba routed pairs {pairs}, want {routed} in all")
    check(tuple(logits.shape) == (JAMBA_B, 1, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()), "Jamba prefill logits")
    toks = JAMBA_B * JAMBA_S
    print(f"  Jamba2-Mini prefill_logits B={JAMBA_B} S={JAMBA_S}, "
          f"{cfg.num_layers} layers, 8 of 16 experts held, bf16: "
          f"{prefill_s:.4f} s -> {toks / prefill_s:,.0f} tokens/s; peak "
          f"device memory {peak / 2**30:.2f} GiB; init {init_s:.2f} s; "
          f"launches {counts}; routed pairs {pairs}")
    del model, params, logits, batch
    torch.cuda.empty_cache()
    return dict(counts=counts, pairs=pairs, prefill_s=prefill_s,
                peak_gib=peak / 2**30)


def to_cpu(tree):
    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    return tree.cpu()


def lm_phase(torch, np, fa_ops, ss_ops, rn_ops, serve, get_arch, Model):
    """The Hymba-1.5B serving path at full width; returns the prefill's K5,
    K6 and RMSNorm launch counts and its time."""
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
        rn_ops.reset_launches()
        t = time.perf_counter()
        logits = model.prefill_logits(params, batch)
        torch.cuda.synchronize()
        prefill_s = [time.perf_counter() - t]
        counts = {"flash_attention": fa_ops.flash_attention.launches,
                  "selective_scan": ss_ops.selective_scan.launches,
                  "rms_norm": rn_ops.rms_norm.launches}
        peak = torch.cuda.max_memory_allocated()
        for _ in range(2):
            t = time.perf_counter()
            model.prefill_logits(params, batch)
            torch.cuda.synchronize()
            prefill_s.append(time.perf_counter() - t)
    check(counts == {"flash_attention": cfg.num_layers,
                     "selective_scan": cfg.num_layers,
                     "rms_norm": norm_launches(cfg)[0]},
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

    ops, rc_ops, fa_ops, ss_ops, rn_ops = kernel_ops

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

    ops, rc_ops, fa_ops, ss_ops, rn_ops = kernel_ops
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
    # Slice E2's single-rank references (run_population sets its own flags)
    out["ref_1e6"], out["ref_30_batched"] = full, runs["batched", "f32"]
    return out


# Slice E: the sharded round substrate in worlds of ranks sharing the card
# (gloo; NCCL refuses two ranks on one device). Each world runs the paper
# config for 10 rounds after a 2-round warm-up (a rank's first run pays the
# CUDA set-up). The round log is held to the single-rank card run at the JAX
# package's own sharding tolerances (tests/test_round_body.py:326: weights
# 1e-5, sq_dists 1e-3): the model-axis sum changes the order of eq. 3's sum.
# The eval history holds the params' squared norm to 1e-5 relative (JAX's
# 1e-5 is absolute on the quadratic problem's norm of ~10; LeNet's is ~10^2,
# where one f32 ulp is ~1e-5) and the accuracy to one test sample of 1,024.
# The params are held to PARAM_ATOL, the card-vs-CPU bound, for the same
# reason: a data row trains K/d clients in one batch, and cuDNN's algorithm
# (and rounding) depends on the batch (the (2, 1) mesh, with no model-axis
# sum, moved the final params by 3.6e-6 on the card, 0 on the CPU).
E_ROUNDS = 10
E_TOL = {"weights": 1e-5, "sq_dists": 1e-3, "history": 1e-5,
         "params": PARAM_ATOL}
E_WORLD_TIMEOUT = 300.0
E_KERNELS = ("fused_server", "sq_dists", "weighted_sum", "int8_sq_dists")
# Slice E2 in the same worlds: the delta ring at (1, 2), batched, 34 rounds
# (the base refresh runs at write 33); the population engine at (2, 1) over
# N = 1e6 clients (fused: K1) and at (2, 2) over the paper's 30 (batched:
# K2 + K3 on each rank's model slice). The delta ring's m = round(0.05 *
# n_padded) depends on the padding, so its single-rank reference takes
# server_pass_block_n = 2 x the default tile: both pad LeNet to 65,536.
E2_POP_WINDOWS = 10
PAPER_FL_DEPTH = 33  # the paper config's ring, max_staleness + 1


def slice_e_rank(shape, device: str, work: str):
    """One rank of a Slice E world (``launch/multihost.spawn_world``)."""
    import dataclasses as dc

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.configs import PAPER_FL
    from repro_torch.core import init_cohort_state, make_cohort_step
    from repro_torch.core import version_store
    from repro_torch.kernels.ring_codec import ops as rc_ops
    from repro_torch.kernels.weighted_agg import ops
    from repro_torch.launch import multihost
    from repro_torch.models import apply_lenet, init_lenet, lenet_loss
    from repro_torch.obs import JsonlSink
    from repro_torch.sim import get_scenario
    from repro_torch.sim.engine import (
        engine_state_from_tree,
        engine_state_to_tree,
        init_version_ring,
        run_vectorized,
    )
    from repro_torch.obs import MetricsRegistry
    from repro_torch.sim.population import (
        DevicePool,
        collect_windows,
        run_population,
    )

    data, model = shape
    rank = dist.get_rank()
    if device == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.deterministic = True  # ranks agree bit for bit
    mesh = multihost.make_round_mesh(data, model, device=device)
    dev = multihost.mesh_device(mesh)
    sc = get_scenario("paper-fig1")
    clients, (xt, yt) = sc.make_dataset(PAPER_FL.num_clients,
                                        samples_per_client=1500, seed=0,
                                        noise=1.2)
    streams = [c.rng_state() for c in clients]
    init = init_lenet(torch.Generator().manual_seed(0))
    x_ev = torch.from_numpy(xt[:1024]).to(dev)
    y_ev = torch.from_numpy(yt[:1024]).to(dev)

    def eval_fn(p):
        return {"acc": float((apply_lenet(p, x_ev).argmax(-1) == y_ev)
                             .float().mean()),
                "wnorm": float(sum(torch.sum(v.double() ** 2)
                                   for d in p.values() for v in d.values()))}

    def counts():
        return {"fused_server": ops.server_update.launches,
                "sq_dists": ops.sq_dists.launches,
                "weighted_sum": ops.weighted_sum.launches,
                "int8_sq_dists": rc_ops.int8_sq_dists.launches}

    def run(mode, codec="f32", total=E_ROUNDS, **kw):
        for c, s in zip(clients, streams):  # fresh batch streams
            c.set_rng_state(s)
        fl = dc.replace(PAPER_FL, server_pass_mode=mode, ring_codec=codec)
        ops.reset_launches()
        rc_ops.reset_launches()
        multihost.reset_collective_stats()
        multihost.barrier()
        t0 = time.perf_counter()
        res = run_vectorized(lenet_loss, init, clients, fl, total,
                             eval_fn=eval_fn, eval_every=5, seed=0, mesh=mesh,
                             device=device, **kw)
        if device == "cuda":
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        done = total - (kw["init_state"].version if "init_state" in kw else 0)
        stats = dict(multihost.COLLECTIVE_STATS)
        return {"round_log": res.round_log, "history": res.history,
                "params": multihost.fetch_replicated(res.final_params),
                "launches": counts(), "rounds_per_s": done / dt,
                "collective_ms_per_round": stats["seconds"] / done * 1e3,
                "collectives_per_round": stats["calls"] / done,
                "collective_bytes_per_round": stats["bytes"] / done,
                "state": res.final_state}

    def pop(mode, data, total=E_ROUNDS, **kw):
        """run_population on the mesh, recorded as ``run`` records."""
        fl = dc.replace(PAPER_FL, server_pass_mode=mode)
        reg = MetricsRegistry()
        ops.reset_launches()
        rc_ops.reset_launches()
        multihost.reset_collective_stats()
        multihost.barrier()
        t0 = time.perf_counter()
        res = run_population(lenet_loss, init, data, fl, total, scenario=sc,
                             seed=0, mesh=mesh, device=device, registry=reg,
                             **kw)
        if device == "cuda":
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        stats = dict(multihost.COLLECTIVE_STATS)
        snap = reg.snapshot()
        st = res.final_state
        return {"round_log": res.round_log, "history": res.history,
                "params": multihost.fetch_replicated(res.final_params),
                "launches": counts(), "rounds_per_s": total / dt,
                "collective_ms_per_round": stats["seconds"] / total * 1e3,
                "collectives_per_round": stats["calls"] / total,
                "collective_bytes_per_round": stats["bytes"] / total,
                "exact_windows": snap.get("engine_exact_windows_total", 0.0),
                "host_reads_per_round":
                    snap["engine_host_syncs_total"] / total,
                "num_events": res.num_events, "sim_time": res.sim_time,
                "pop_state_sha256": None if st is None else pop_digest(st),
                "state": None}

    def ring_bytes(codec):
        fl = dc.replace(PAPER_FL, ring_codec=codec)
        spec, state = init_version_ring(init, fl, mesh=mesh)
        got = sum(t.numel() * t.element_size()
                  for t in version_store.state_tensors(state))
        return got, version_store.ring_device_bytes(
            fl, spec, getattr(spec, "model_shards", 1))

    out = {"rank": rank, "runs": {}}
    runs = out["runs"]
    if device == "cuda":
        run("fused", total=2)  # warm-up: CUDA and cuDNN set-up
    if device == "cpu":  # the card run's counterpart only
        runs["fused"] = run("fused")
    elif shape == (1, 2):
        out["gloo_cuda_all_gather"] = _probe_gloo_cuda(torch, dist, device)
        runs["batched"] = run("batched")
        runs["fused"] = run("fused")
        runs["fused_replicated_ring"] = run("fused", shard_ring=False)
        runs["int8_fused"] = run("fused", "int8")
        runs["delta_batched"] = run("batched", "delta", total=DELTA_ROUNDS)
        out["ring_bytes"] = {c: ring_bytes(c)
                             for c in ("f32", "int8", "delta")}
    elif shape == (2, 2):
        runs["fused"] = run("fused", capture_state=True)
        half = run("fused", total=5, capture_state=True)
        tree = engine_state_to_tree(half["state"])
        path = str(Path(work) / "engine.npz")
        save_checkpoint(path, tree, step=5)
        multihost.barrier()
        loaded, step = load_checkpoint(path, like=tree)
        resumed = run("fused", init_state=engine_state_from_tree(loaded),
                      capture_state=True)
        full = runs["fused"]
        ring_a, ring_b = resumed["state"].ring, full["state"].ring
        out["resume_identical"] = (
            step == 5 and resumed["round_log"] == full["round_log"]
            and resumed["history"] == full["history"]
            and _same_tree(np, resumed["params"], full["params"])
            and np.array_equal(ring_a, ring_b))
        out["ring_bytes"] = {"f32": ring_bytes("f32")}
        # the cohort step at the paper config: C = K = 10 slots, 5 a row
        for c, s in zip(clients, streams):
            c.set_rng_state(s)
        rounds = cohort_inputs(np, clients, PAPER_FL.buffer_size,
                               PAPER_FL.local_steps, PAPER_FL.batch_size)
        fl = dc.replace(PAPER_FL, server_pass_mode="fused")
        cohort = {}
        for name, m in (("mesh", mesh), ("single", None)):
            step_fn = make_cohort_step(lenet_loss, fl, mesh=m, device=device)
            state = init_cohort_state(
                {l: {k: v.to(dev) for k, v in p.items()}
                 for l, p in init.items()}, PAPER_FL.buffer_size)
            ops.reset_launches()
            traj = []
            for batch in rounds:
                state, mets = step_fn(state, batch)
                traj.append((multihost.fetch_replicated(state.global_params),
                             {k: float(v) for k, v in mets.items()}))
            cohort[name] = {"traj": traj, "launches": counts()}
        out["cohort"] = cohort
        sink = JsonlSink(str(Path(work) / f"sink_rank{rank}.jsonl"))
        sink.emit({"event": "slice_e", "rank": rank})
        sink.close()
        runs["population_batched"] = pop("batched", clients)
    else:
        runs["fused"] = run("fused")
        # the population engine at N = 1e6: the (N,) state split over data
        xs = np.concatenate([c.x for c in clients])
        ys = np.concatenate([c.y for c in clients])
        pool = DevicePool.shared(xs, ys, POP_BIG_N, POP_PER_CLIENT).to(dev)
        t0 = time.perf_counter()
        wins = collect_windows(sc, POP_BIG_N, PAPER_FL, E2_POP_WINDOWS,
                               seed=0, mesh=mesh, device=device,
                               registry=MetricsRegistry())
        out["windows_1e6"] = {f: wins[f] for f in (
            "clients", "tau", "slots", "t", "num_events", "now", "agreed")}
        out["windows_1e6_s"] = time.perf_counter() - t0
        runs["population_fused_1e6"] = pop("fused", pool, capture_state=True)
    for r in runs.values():
        r.pop("state")
    return out


def pop_digest(state) -> str:
    """SHA-256 of a ``PopulationEngineState``'s four (N,) arrays."""
    import hashlib

    h = hashlib.sha256()
    for f in ("t_next", "k_next", "batch_k", "base_version"):
        h.update(getattr(state, f).tobytes())
    return h.hexdigest()


def _probe_gloo_cuda(torch, dist, device):
    """Whether gloo's all_gather takes CUDA tensors as they are (the port
    stages them through the host either way)."""
    if device != "cuda":
        return None
    t = torch.arange(4, dtype=torch.float32, device="cuda")
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    try:
        dist.all_gather(parts, t)
        return "ok: " + str([p.device.type for p in parts])
    except (RuntimeError, ValueError) as e:
        return f"refused: {type(e).__name__}: {str(e).splitlines()[0][:160]}"


def _same_tree(np, a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same_tree(np, a[k], b[k])
                                            for k in a)
    return a.dtype == b.dtype and a.tobytes() == b.tobytes()


def _max_param_err(np, a, b) -> float:
    return max(float(np.max(np.abs(np.asarray(a[l][k], np.float64)
                                   - np.asarray(b[l][k], np.float64))))
               for l in b for k in b[l])


def _as_run(torch, rec):
    """A Slice E record in the shape ``compare_runs`` reads."""
    from types import SimpleNamespace

    return SimpleNamespace(round_log=rec["round_log"], final_params={
        l: {k: torch.from_numpy(np_) for k, np_ in p.items()}
        for l, p in rec["params"].items()})


def e_check_close(np, got, ref, what: str) -> None:
    """A sharded run against the single-rank card run, at the JAX package's
    sharding tolerances (E_TOL)."""
    check(len(got["round_log"]) == len(ref.round_log), f"{what}: rounds")
    worst = dict.fromkeys(("weights", "sq_dists"), 0.0)
    for a, b in zip(got["round_log"], ref.round_log):
        check((a["version"], a["clients"], a["tau"])
              == (b["version"], b["clients"], b["tau"]),
              f"{what}: event timeline differs at v{a['version']}")
        for f in worst:
            err = float(np.max(np.abs(np.asarray(a[f], np.float64)
                                      - np.asarray(b[f], np.float64))))
            worst[f] = max(worst[f], err)
    check(len(got["history"]) == len(ref.history), f"{what}: evals")
    hist = max((abs(a["wnorm"] - b["wnorm"]) / max(1.0, abs(b["wnorm"]))
                for a, b in zip(got["history"], ref.history)), default=0.0)
    acc = max((abs(a["acc"] - b["acc"]) for a, b in zip(got["history"],
                                                         ref.history)),
              default=0.0)
    params = _max_param_err(np, got["params"], {
        l: {k: v.cpu().numpy() for k, v in p.items()}
        for l, p in ref.final_params.items()})
    print(f"  {what}: weights {worst['weights']:.3g} (limit "
          f"{E_TOL['weights']}), sq_dists {worst['sq_dists']:.3g} (limit "
          f"{E_TOL['sq_dists']}), history wnorm rel {hist:.3g} (limit "
          f"{E_TOL['history']}), acc {acc:.3g}, final params {params:.3g} "
          f"(limit {E_TOL['params']})")
    check(worst["weights"] <= E_TOL["weights"]
          and worst["sq_dists"] <= E_TOL["sq_dists"]
          and hist <= E_TOL["history"] and acc <= 1 / 1024 + 1e-7
          and params <= E_TOL["params"], f"{what}: outside the tolerances")


def slice_e_phase(torch, np, singles, card: str, e2_refs):
    """The Slice E worlds on the card (and one on the CPU); ``singles`` are
    single-rank card runs at the ranks' flags (fused, batched, int8);
    ``e2_refs`` the single-rank references of the Slice E2 parts (the delta
    run at the mesh's n_padded, the N = 1e6 windows and population run, the
    30-client batched population run)."""
    from concurrent.futures import ThreadPoolExecutor as Pool

    from repro_torch.launch.multihost import spawn_world

    target = f"{Path(__file__).resolve()}:slice_e_rank"
    root = ROOT / "build" / "slice_e"
    root.mkdir(parents=True, exist_ok=True)

    def world(shape, device):
        work = tempfile.mkdtemp(prefix=f"{shape[0]}x{shape[1]}_{device}_",
                                dir=root)
        t = time.perf_counter()
        ranks = spawn_world(target, shape[0] * shape[1],
                            {"shape": shape, "device": device, "work": work},
                            timeout=E_WORLD_TIMEOUT, workdir=work)
        print(f"  world {shape[0]}x{shape[1]} on {device}: "
              f"{time.perf_counter() - t:.1f} s, {len(ranks)} ranks")
        return ranks, Path(work)

    out = {"launches": {}, "rates": {}}
    w12, _ = world((1, 2), "cuda")
    w22, work22 = world((2, 2), "cuda")
    with Pool(1) as pool:  # the CPU world beside the last card world
        cpu_future = pool.submit(world, (2, 2), "cpu")
        w21, _ = world((2, 1), "cuda")
        w22_cpu, _ = cpu_future.result()
    print(f"  gloo all_gather on CUDA tensors: "
          f"{w12[0]['gloo_cuda_all_gather']}")

    for name, ranks in (("1x2", w12), ("2x2", w22), ("2x1", w21),
                        ("2x2 cpu", w22_cpu)):
        first = ranks[0]
        for r in ranks[1:]:
            check(r["runs"].keys() == first["runs"].keys()
                  and all(r["runs"][k]["round_log"]
                          == first["runs"][k]["round_log"]
                          and r["runs"][k]["history"]
                          == first["runs"][k]["history"]
                          and _same_tree(np, r["runs"][k]["params"],
                                         first["runs"][k]["params"])
                          and r["runs"][k]["launches"]
                          == first["runs"][k]["launches"]
                          for k in first["runs"]),
                  f"{name}: rank {r['rank']} differs from rank 0")
        for run_name, rec in first["runs"].items():
            key = f"{name} {run_name}"
            out["launches"][key] = rec["launches"]
            out["rates"][key] = rec["rounds_per_s"]
            print(f"  {key}: {rec['rounds_per_s']:.2f} rounds/s, launches "
                  f"a rank {rec['launches']}, collectives "
                  f"{rec['collectives_per_round']:g} a round, "
                  f"{rec['collective_ms_per_round']:.3f} ms a round, "
                  f"{rec['collective_bytes_per_round']:,.0f} B a round "
                  f"(gathered, a rank)")
        print(f"  {name}: every rank's round log, history, params and "
              f"launches bit-identical to rank 0's")
    none = dict.fromkeys(E_KERNELS, 0)
    ten = E_ROUNDS
    want = {("1x2", "batched"): {**none, "sq_dists": ten, "weighted_sum": ten},
            ("1x2", "fused"): {**none, "sq_dists": ten, "weighted_sum": ten},
            ("1x2", "fused_replicated_ring"):
                {**none, "sq_dists": ten, "weighted_sum": ten},
            ("1x2", "int8_fused"):
                {**none, "int8_sq_dists": ten, "weighted_sum": ten},
            ("2x2", "fused"): {**none, "sq_dists": ten, "weighted_sum": ten},
            ("2x1", "fused"): {**none, "fused_server": ten},
            ("1x2", "delta_batched"): {**none, "weighted_sum": DELTA_ROUNDS},
            ("2x1", "population_fused_1e6"): {**none, "fused_server": ten},
            ("2x2", "population_batched"):
                {**none, "sq_dists": ten, "weighted_sum": ten}}
    for (name, run_name), counts in want.items():
        got = out["launches"][f"{name} {run_name}"]
        check(got == counts, f"{name} {run_name}: launches {got}, "
              f"expected {counts}")
    fused, batched, int8 = singles
    e_check_close(np, w12[0]["runs"]["batched"], batched,
                  "1x2 batched vs single-rank batched")
    e_check_close(np, w12[0]["runs"]["fused"], fused,
                  "1x2 fused vs single-rank fused")
    e_check_close(np, w12[0]["runs"]["int8_fused"], int8,
                  "1x2 int8 fused vs single-rank int8")
    e_check_close(np, w22[0]["runs"]["fused"], fused,
                  "2x2 fused vs single-rank fused")
    e_check_close(np, w21[0]["runs"]["fused"], fused,
                  "2x1 fused vs single-rank fused")
    compare_runs(np, _as_run(torch, w22[0]["runs"]["fused"]),
                 _as_run(torch, w22_cpu[0]["runs"]["fused"]),
                 "2x2 fused on cuda vs 2x2 on cpu (gloo)")
    a, b = w12[0]["runs"]["fused"], w12[0]["runs"]["fused_replicated_ring"]
    check(a["round_log"] == b["round_log"] and a["history"] == b["history"]
          and _same_tree(np, a["params"], b["params"]),
          "1x2: sharded ring differs from the replicated ring")
    print("  1x2: sharded ring == replicated ring: round log, history and "
          "params bit-identical")
    for name, ranks in (("1x2", w12), ("2x2", w22)):
        for r in ranks:
            for codec, (got, quoted) in r["ring_bytes"].items():
                check(got == quoted, f"{name} rank {r['rank']} {codec} ring "
                      f"bytes {got} vs ring_device_bytes {quoted}")
        print(f"  {name}: ring bytes a rank "
              f"{ {c: v[0] for c, v in ranks[0]['ring_bytes'].items()} } "
              f"== ring_device_bytes")
    check(all(r["resume_identical"] for r in w22),
          "2x2: the resumed run differs from the uninterrupted one")
    print("  2x2: checkpoint at round 5 (rank 0 wrote it), resumed to "
          f"{E_ROUNDS} on every rank: round log, history, params and ring "
          "bit-identical")
    cohort = w22[0]["cohort"]
    check(cohort["mesh"]["launches"] == {**none, "sq_dists": ten,
                                         "weighted_sum": ten}
          and cohort["single"]["launches"] == {**none, "fused_server": ten},
          f"2x2 cohort launches {cohort['mesh']['launches']} / "
          f"{cohort['single']['launches']}")
    perr = merr = 0.0
    for (pa, ma), (pb, mb) in zip(cohort["mesh"]["traj"],
                                  cohort["single"]["traj"]):
        perr = max(perr, _max_param_err(np, pa, pb))
        merr = max(merr, max(abs(ma[k] - mb[k]) / max(1.0, abs(mb[k]))
                             for k in mb))
    check(perr <= E_TOL["params"] and merr <= E_TOL["weights"],
          f"2x2 cohort vs single-rank cohort: params {perr}, metrics {merr}")
    print(f"  2x2 cohort step (fused, {COHORT_ROUNDS} rounds of straggler "
          f"masks) vs single-rank: params {perr:.3g}, metrics rel {merr:.3g};"
          f" launches a rank {cohort['mesh']['launches']}")
    sinks = sorted(p.name for p in work22.glob("sink_rank*.jsonl"))
    check(sinks == ["sink_rank0.jsonl"], f"2x2 sink files {sinks}")
    print(f"  2x2: only rank 0 wrote its sink file ({sinks}) ({card})")
    slice_e2_checks(np, w12, w21, w22, e2_refs, out, card)
    return out


def slice_e2_checks(np, w12, w21, w22, refs, out, card: str) -> None:
    """The Slice E2 parts of the worlds against their single-rank runs."""
    t = time.perf_counter()
    print("Slice E2: the delta ring and the population engine on a mesh")
    delta = w12[0]["runs"]["delta_batched"]
    e_check_close(np, delta, refs["delta"],
                  f"1x2 delta batched ({DELTA_ROUNDS} rounds, n_padded "
                  f"{refs['delta_n_padded']:,}) vs single-rank delta at "
                  f"server_pass_block_n {refs['delta_block_n']:,} (n_padded "
                  f"{refs['delta_n_padded']:,})")
    ref_params = {l: {k: v.cpu().numpy() for k, v in p.items()}
                  for l, p in refs["delta"].final_params.items()}
    same = (delta["round_log"] == refs["delta"].round_log
            and _same_tree(np, delta["params"], ref_params))
    print(f"  1x2 delta: round log and final params "
          f"{'bit-identical to' if same else 'differ from'} the single "
          f"rank's (every step of the sharded delta ring is the single "
          f"device's)")
    m = round(0.05 * refs["delta_n_padded"])
    quote = refs["delta_n_padded"] // 2 * 4 + PAPER_FL_DEPTH * m * 8 + 4
    for r in w12:
        got, quoted = r["ring_bytes"]["delta"]
        check(got == quoted == quote, f"1x2 rank {r['rank']} delta ring "
              f"bytes {got}, ring_device_bytes {quoted}, expected {quote}")
    print(f"  1x2 delta ring: {quote:,} B a rank (the base's half, {m:,} "
          f"sparse entries a row x {PAPER_FL_DEPTH}) == ring_device_bytes; "
          f"K3 launches a rank {delta['launches']['weighted_sum']} in "
          f"{DELTA_ROUNDS} rounds, K1 = K2 = K4 = 0")
    wins, ref_w = w21[0]["windows_1e6"], refs["windows_1e6"]
    check(all(np.array_equal(wins[f], ref_w[f])
              for f in ("clients", "tau", "slots", "t"))
          and wins["num_events"] == ref_w["num_events"]
          and all(r["windows_1e6"]["agreed"] == wins["agreed"]
                  for r in w21),
          "2x1 N = 1e6: windows differ from the single rank's")
    print(f"  2x1 N = {POP_BIG_N:,}: {E2_POP_WINDOWS} windows (cids, taus, "
          f"slots, t, {wins['num_events']} events) == the single rank's; "
          f"host reads agreed {wins['agreed']}; "
          f"{w21[0]['windows_1e6_s']:.2f} s")
    for name, key, ranks, ref in (
            ("2x1", "population_fused_1e6", w21, refs["pop_1e6"]),
            ("2x2", "population_batched", w22, refs["pop_30"])):
        rec = ranks[0]["runs"][key]
        name = f"{name} {key}"
        e_check_close(np, rec, ref, f"{name} vs single-rank")
        check(rec["num_events"] == ref.num_events
              and rec["sim_time"] == ref.sim_time,
              f"{name}: events or sim time differ from the single rank's")
        if rec["pop_state_sha256"] is not None:
            check(rec["pop_state_sha256"] == pop_digest(ref.final_state),
                  f"{name}: PopState differs from the single rank's")
        print(f"  {name}: {rec['rounds_per_s']:.2f} rounds/s, "
              f"{rec['collectives_per_round']:g} collectives a round, "
              f"{rec['collective_ms_per_round']:.3f} host ms in them a round, "
              f"{rec['exact_windows']:g} exact windows, "
              f"{rec['host_reads_per_round']:.2f} host reads a round, "
              f"{rec['num_events']} events == the single rank's"
              + (", PopState bit-identical" if rec["pop_state_sha256"]
                 else ""))
    out["e2_s"] = time.perf_counter() - t
    print(f"  Slice E2 checks ({card}): {out['e2_s']:.1f} s")


# ---------------------------------------------------------------------------
# Slice F2: the serving path of the other architectures
# ---------------------------------------------------------------------------

F2_B, F2_S = 2, 4096  # the prefill shape of every F2 row
DEEPSEEK_PARAMS = 16_879_568_896  # tests/test_torch_lm.py pins it to JAX
# K5's shapes on the F2 prefills: (arch, B, S, H, Hkv, D); pixtral's S is
# its 256 patches + 4096 tokens, whisper-tiny's its decoder's 448 positions
F2_ATTN = (("deepseek-moe-16b", 2, 4096, 16, 16, 128),
           ("stablelm-12b", 2, 4096, 32, 8, 160),
           ("gemma-7b", 2, 4096, 16, 16, 256),
           ("pixtral-12b", 2, 4352, 32, 8, 128),
           ("qwen1.5-110b", 2, 4096, 64, 8, 128),
           ("arctic-480b", 2, 4096, 56, 8, 128),
           ("whisper-tiny", 2, 448, 6, 6, 64))
# (e): prefill_logits at full width, B = 2: (arch, depth, S); depth None =
# full, else the cut; whisper-tiny at its decoder's 448 positions
F2_PREFILLS = (("pixtral-12b", None, 4096), ("stablelm-12b", None, 4096),
               ("gemma-7b", None, 4096), ("qwen1.5-110b", 2, 4096),
               ("arctic-480b", 1, 4096), ("whisper-tiny", None, 448))
# (b): card against CPU at full width, B = 1, S = 256 (pixtral: + its 256
# patches). "model": prefill_logits. "layers": each layer on one input
# shared by card and CPU (the card's output feeds the next layer), the MoE
# routed on both sides and then combined under the card's routing; for the
# configs whose embedding and head alone pass 8 GB in f32 on the CPU
# (qwen1.5-110b), or whose one layer does (arctic-480b: 128 experts, 54 GB;
# cut to 8 experts for this check only)
F2_CPU_S = 256
F2_CPU = (("deepseek-moe-16b", dict(num_layers=2), "layers"),
          ("arctic-480b", dict(num_layers=1, num_experts=8), "layers"),
          ("qwen1.5-110b", dict(num_layers=1), "layers"),
          ("whisper-tiny", {}, "model"),
          ("pixtral-12b", dict(num_layers=1), "model"),
          ("stablelm-12b", dict(num_layers=2), "model"),
          ("gemma-7b", dict(num_layers=2), "model"))
# a routing flip between card and CPU is a near-tie when a margin between
# neighbouring router probabilities among the first k + 1 is below this: the
# router sees the same input on both sides (f32 logits from cuBLAS vs the
# CPU's matmul), so its probabilities differ by f32 rounding alone
ROUTE_TIE = 1e-5
F2_DECODE_S = 64
F2_MEM_SLACK = 64 << 20  # device bytes a freed model may leave behind


def f2_batch(torch, cfg, b: int, s: int, dtype, seed: int):
    """tokens (and patches / frames) for ``cfg`` on the card, from a seed."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s), device="cuda",
                                     generator=g)}
    if cfg.num_patches:
        batch["patches"] = torch.randn(b, cfg.num_patches, cfg.d_model,
                                       device="cuda", generator=g).to(dtype)
    if cfg.is_encdec:
        batch["frames"] = torch.randn(b, cfg.encoder_seq_len, cfg.d_model,
                                      device="cuda", generator=g)
    return batch


def tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def freed(torch, base: int, what: str) -> None:
    """After ``del``: the card's allocated memory is back near ``base``."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    now = torch.cuda.memory_allocated()
    check(now - base <= F2_MEM_SLACK,
          f"{what}: {now - base:,d} B still allocated after freeing")


def flash_wide_phase(torch, fa_ops, fa_ref, rate: float):
    """K5 at the F2 prefills' shapes, bf16 and f32, against its plain
    version, beside its bound and SDPA (causal, GQA); returns records by
    (arch, dtype)."""
    F = torch.nn.functional
    records = {}
    for arch, b, s, h, hkv, d in F2_ATTN:
        for dtype_name in ("bfloat16", "float32"):
            dtype = getattr(torch, dtype_name)
            g = torch.Generator(device="cuda").manual_seed(s + h + d)
            q, k, v = (torch.randn(b, s, n, d, device="cuda", generator=g)
                       .to(dtype) for n in (h, hkv, hkv))
            out = fa_ops.flash_attention(q, k, v)
            check(torch.equal(out, fa_ops.flash_attention(q, k, v)),
                  f"K5 not bit-identical at {arch} {dtype_name}")
            want = fa_ref.flash_attention_ref(q, k, v)
            rtol, atol = ATTN_TOL[dtype_name]
            err = float((out.float() - want.float()).abs().max())
            check(torch.allclose(out.float(), want.float(), rtol=rtol,
                                 atol=atol),
                  f"K5 vs plain at {arch} D={d} {dtype_name}: {err}")
            del want
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))

            def library():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True)

            flops = 4 * d * attn_pairs(s, 0) * b * h
            nbytes = (2 * b * s * h + 2 * b * s * hkv) * d * q.element_size()
            bytes_ms = nbytes / rate * 1e3
            ops_ms = flops / (BF16_FLOPS if dtype == torch.bfloat16
                              else F32_FLOPS) * 1e3
            r = dict(arch=arch, shape=[b, s, h, hkv, d], dtype=dtype_name,
                     ms=time_ms(torch, lambda: fa_ops.flash_attention(q, k, v),
                                reps=5, warmup=1),
                     burst_ms=time_burst(torch, lambda: fa_ops.flash_attention(
                         q, k, v), n=10, warmup=1),
                     plain_ms=time_ms(torch, lambda: fa_ref.flash_attention_ref(
                         q, k, v), reps=2, warmup=1),
                     library_ms=time_ms(torch, library, reps=5, warmup=1),
                     max_abs_err=err, bound_ms=max(bytes_ms, ops_ms),
                     bound_by="bytes" if bytes_ms >= ops_ms else "operations")
            print(f"  flash_attention {arch:16s} B={b} S={s} H={h} Hkv={hkv} "
                  f"D={d} {dtype_name:8s}: kernel {r['ms']:.4f} ms (burst "
                  f"{r['burst_ms']:.4f})  plain {r['plain_ms']:.4f} ms  SDPA "
                  f"{r['library_ms']:.4f} ms  bound {r['bound_ms']:.4f} ms "
                  f"({r['bound_by']}, {flops / 1e9:.2f} GFLOP)  max_abs_err "
                  f"{err:.3g}")
            records[(arch, dtype_name)] = r
            del q, k, v, out, qt, kt, vt
            torch.cuda.empty_cache()
    return records


def route_flips(torch, cfg, probs_cpu, ids_card, ids_cpu):
    """(flips, choices, unexplained): rows whose expert ids differ between
    card and CPU, and those of them with no near-tie (``ROUTE_TIE``) among
    the CPU's first k + 1 sorted probabilities."""
    k = cfg.experts_per_token
    rows = (ids_card.cpu() != ids_cpu).any(-1)
    top = torch.sort(probs_cpu[rows], dim=-1, descending=True).values
    gaps = (top[:, :k] - top[:, 1:k + 1]).amin(-1)
    return int(rows.sum()), ids_cpu.numel(), int((gaps >= ROUTE_TIE).sum())


def layers_card_vs_cpu(torch, cfg, blocks, moe, apply_norm, apply_mlp, Init,
                       seed: int):
    """Each layer of a ``num_layers`` stack at full width on one input
    shared by card and CPU. Returns (worst error over the output's largest
    |x|, flips, choices)."""
    dtype = getattr(torch, cfg.compute_dtype)
    stack = blocks.init_stack(Init(torch.Generator(device="cuda").manual_seed(
        seed), torch.device("cuda")), cfg, cfg.num_layers)
    cpu_stack = to_cpu(stack)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    x = torch.randn(1, F2_CPU_S, cfg.d_model, device="cuda",
                    generator=g).to(dtype)
    worst, flips, choices = 0.0, 0, 0
    d = cfg.d_model

    def rel(a, b):
        return float((a.cpu().float() - b.float()).abs().max()) / \
            float(b.float().abs().max())

    with torch.no_grad():
        for i in range(cfg.num_layers):
            p, pc = blocks.layer_view(stack, i), blocks.layer_view(cpu_stack, i)
            h = blocks._mixer_train(cfg, p, x, None)
            worst = max(worst, rel(h, blocks._mixer_train(cfg, pc, x.cpu(),
                                                          None)))
            hn = apply_norm(cfg, p["norm2"], h)
            hnc = hn.cpu()
            if cfg.is_moe:
                xf, xfc = hn.reshape(-1, d), hnc.reshape(-1, d)
                _, gates, ids = moe.route(cfg, p["moe"], xf)
                probs_c, _, ids_c = moe.route(cfg, pc["moe"], xfc)
                n, c, bad = route_flips(torch, cfg, probs_c, ids, ids_c)
                check(bad == 0, f"{cfg.name} layer {i}: {bad} of {n} routing "
                      f"flips are not near-ties")
                flips, choices = flips + n, choices + c
                cap = moe.capacity(cfg, xf.shape[0], cfg.moe_capacity_factor)
                y = moe.dispatch_combine(cfg, p["moe"], xf, gates, ids, cap)
                yc = moe.dispatch_combine(cfg, pc["moe"], xfc, gates.cpu(),
                                          ids.cpu(), cap)
                if cfg.num_shared_experts:
                    y = y + moe.shared_ffn(p["moe"], xf)
                    yc = yc + moe.shared_ffn(pc["moe"], xfc)
                y, yc = y.reshape(hn.shape), yc.reshape(hnc.shape)
                if cfg.dense_residual_ff:
                    y = y + apply_mlp(cfg, p["mlp"], hn)
                    yc = yc + apply_mlp(cfg, pc["mlp"], hnc)
            else:
                y, yc = apply_mlp(cfg, p["mlp"], hn), apply_mlp(cfg, pc["mlp"],
                                                                hnc)
            worst = max(worst, rel(h + y, h.cpu() + yc))
            x = h + y
    return worst, flips, choices


def slice_f2_phase(torch, np, kernel_ops, fa_ref, serve, get_arch, Model,
                   rate: float, card: str):
    """Slice F2: the serving path of deepseek-moe-16b, arctic-480b,
    whisper-tiny, pixtral-12b, stablelm-12b, gemma-7b and qwen1.5-110b."""
    from repro_torch.models import blocks
    from repro_torch.models import moe
    from repro_torch.models.layers import Init, apply_mlp, apply_norm

    ops, rc_ops, fa_ops, ss_ops, rn_ops = kernel_ops
    out = {}

    def reset():
        for o in kernel_ops:
            o.reset_launches()

    def launches():
        return {"fused_server": ops.server_update.launches,
                "sq_dists": ops.sq_dists.launches,
                "weighted_sum": ops.weighted_sum.launches,
                "int8_sq_dists": rc_ops.int8_sq_dists.launches,
                "flash_attention": fa_ops.flash_attention.launches,
                "selective_scan": ss_ops.selective_scan.launches,
                "rms_norm": rn_ops.rms_norm.launches}

    # (f) K5 at the new shapes, before any model takes the card's memory
    t = time.perf_counter()
    print("  (f) K5 at the F2 prefill shapes (median of 5 calls; burst of 10):")
    out["attn"] = flash_wide_phase(torch, fa_ops, fa_ref, rate)
    print(f"  (f): {time.perf_counter() - t:.1f} s")

    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()

    # (a) deepseek-moe-16b at full width and depth, bf16
    t = time.perf_counter()
    cfg = get_arch("deepseek-moe-16b").model
    torch.cuda.reset_peak_memory_stats()
    model = Model(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    init_peak = torch.cuda.max_memory_allocated() - base
    n_params = model.param_count(params)
    p_bytes = tree_bytes(params)
    layer_bytes = tree_bytes(params["layers"]) // cfg.num_layers
    check(n_params == DEEPSEEK_PARAMS, f"deepseek param count {n_params}")
    print(f"  (a) deepseek-moe-16b init on the card: {n_params:,d} params "
          f"({p_bytes / 2**30:.2f} GiB), {init_s:.2f} s; init peak "
          f"{init_peak / 2**30:.3f} GiB (limit params + one layer = "
          f"{(p_bytes + layer_bytes) / 2**30:.3f} GiB)")
    check(init_peak < p_bytes + layer_bytes, f"init peak {init_peak:,d} B")
    batch = {"tokens": torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (F2_B, F2_S))).cuda()}
    toks = F2_B * F2_S
    with torch.no_grad():
        model.prefill_logits(params, batch)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset()
        t0 = time.perf_counter()
        logits = model.prefill_logits(params, batch)
        torch.cuda.synchronize()
        prefill_s = [time.perf_counter() - t0]
        counts = launches()
        peak = torch.cuda.max_memory_allocated() - base
        for _ in range(2):
            t0 = time.perf_counter()
            model.prefill_logits(params, batch)
            torch.cuda.synchronize()
            prefill_s.append(time.perf_counter() - t0)
        # the share of token-choices dropped at cf 1.25, per layer
        shares, plan = [], moe.dispatch_plan

        def spy(cfg_, ids, cap):
            got = plan(cfg_, ids, cap)
            shares.append((~got.keep).float().mean())
            return got

        moe.dispatch_plan = spy
        try:
            model.prefill_logits(params, batch)
        finally:
            moe.dispatch_plan = plan
        shares = [float(x) for x in shares]
    check(counts == {"fused_server": 0, "sq_dists": 0, "weighted_sum": 0,
                     "int8_sq_dists": 0, "flash_attention": cfg.num_layers,
                     "selective_scan": 0,
                     "rms_norm": norm_launches(cfg)[0]},
          f"deepseek prefill launches {counts}")
    check(tuple(logits.shape) == (F2_B, 1, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()), "deepseek prefill logits")
    check(len(shares) == cfg.num_layers, f"{len(shares)} dispatches")
    out["deepseek"] = dict(prefill_s=prefill_s, peak=peak, counts=counts,
                           drop_shares=shares, init_peak=init_peak)
    print(f"  prefill_logits B={F2_B} S={F2_S}, 28 layers, bf16: "
          f"{', '.join(f'{x:.4f}' for x in prefill_s)} s -> "
          f"{', '.join(f'{toks / x:,.0f}' for x in prefill_s)} tokens/s; "
          f"peak {peak / 2**30:.2f} GiB; launches {counts}")
    print(f"  token-choices dropped at cf {cfg.moe_capacity_factor}, per "
          f"layer: {', '.join(f'{x:.4f}' for x in shares)} (mean "
          f"{sum(shares) / len(shares):.4f})")
    out["profile"] = profile_prefill(torch, model, params, batch)
    del model, params, logits, batch
    freed(torch, base, "deepseek-moe-16b")
    print(f"  (a): {time.perf_counter() - t:.1f} s")

    # (b) card against CPU at full width
    t = time.perf_counter()
    out["cpu"] = {}
    for arch, cut, how in F2_CPU:
        for dtype in ("float32", "bfloat16"):
            cfg2 = get_arch(arch).model.replace(param_dtype=dtype,
                                                compute_dtype=dtype, **cut)
            t1 = time.perf_counter()
            if how == "layers":
                err, flips, choices = layers_card_vs_cpu(
                    torch, cfg2, blocks, moe, apply_norm, apply_mlp, Init,
                    seed=len(arch))
                note = (f", routing flips {flips} of {choices} token rows "
                        f"(all near-ties)") if cfg2.is_moe else ""
            else:
                m2 = Model(cfg2, device="cuda")
                p2 = m2.init(torch.Generator(device="cuda").manual_seed(1))
                b2 = f2_batch(torch, cfg2, 1, F2_CPU_S, getattr(torch, dtype),
                              seed=3)
                with torch.no_grad():
                    got = m2.prefill_logits(p2, b2)
                    want = Model(cfg2, device="cpu").prefill_logits(
                        to_cpu(p2), to_cpu(b2))
                err = float((got.cpu().float() - want.float()).abs().max()) \
                    / float(want.float().abs().max())
                flips, note = 0, ""
                del m2, p2, b2, got, want
            out["cpu"][(arch, dtype)] = dict(err=err, flips=flips)
            print(f"  (b) {arch} {how} {cut or 'full'} {dtype}: max abs diff "
                  f"{err:.3g} of the largest |output| (limit "
                  f"{LOGIT_TOL[dtype]}){note}; {time.perf_counter() - t1:.1f} s")
            check(err <= LOGIT_TOL[dtype], f"{arch} card vs CPU {dtype}: {err}")
            freed(torch, base, f"{arch} card vs CPU")
    print(f"  (b): {time.perf_counter() - t:.1f} s")

    # (c) decode against the full forward, f32
    t = time.perf_counter()
    ds = get_arch("deepseek-moe-16b").model
    for arch, cfg3 in (
            ("deepseek-moe-16b", ds.replace(
                num_layers=2, param_dtype="float32", compute_dtype="float32",
                moe_capacity_factor=ds.num_experts / ds.experts_per_token)),
            ("whisper-tiny", get_arch("whisper-tiny").model.replace(
                param_dtype="float32", compute_dtype="float32"))):
        m3 = Model(cfg3, device="cuda")
        p3 = m3.init(torch.Generator(device="cuda").manual_seed(2))
        b3 = f2_batch(torch, cfg3, 1, F2_DECODE_S, torch.float32, seed=4)
        with torch.no_grad():
            full, _ = m3.apply(p3, b3)
            cache = m3.init_cache(1, F2_DECODE_S)
            if cfg3.is_encdec:
                cache = m3.prefill_cross(p3, cache, b3["frames"])
            errs = []
            for i in range(F2_DECODE_S):
                lg, cache = m3.decode_step(p3, cache,
                                           b3["tokens"][:, i:i + 1], i)
                errs.append((lg[:, 0] - full[:, i]).abs().max())
            err = float(torch.stack(errs).max())
        scale = float(full.abs().max())
        print(f"  (c) decode vs forward, {arch} {cfg3.num_layers} layers, f32,"
              f" S={F2_DECODE_S}: max abs diff {err:.4g} of max |logit| "
              f"{scale:.4g} (limit {DECODE_TOL} x max)")
        check(err <= DECODE_TOL * scale, f"{arch} decode vs forward: {err}")
        del m3, p3, b3, full, cache
        freed(torch, base, f"{arch} decode")
    print(f"  (c): {time.perf_counter() - t:.1f} s")

    # (d) the serving launcher at full depth, JAX's defaults
    t = time.perf_counter()
    out["serve"] = {}
    for arch in ("deepseek-moe-16b", "whisper-tiny"):
        res = serve.main(["--arch", arch, "--device", "cuda"])
        ids = res["tokens"]
        vocab = get_arch(arch).model.vocab_size
        check(ids.shape == (4, 17) and ids.min() >= 0 and ids.max() < vocab,
              f"{arch} served ids {ids.shape}")
        out["serve"][arch] = res["decode_tok_s"]
        print(f"  (d) serve.py {arch} (batch 4, prompt 32, gen 16): prefill "
              f"{res['prefill_s']:.4f} s, decode {res['decode_tok_s']:.2f} "
              f"tokens/s")
        del res
        freed(torch, base, f"{arch} serve")
    print(f"  (d): {time.perf_counter() - t:.1f} s")

    # (e) prefill_logits at full width, bf16
    t = time.perf_counter()
    out["prefill"] = {}
    for arch, depth, s5 in F2_PREFILLS:
        cfg5 = get_arch(arch).model
        if depth:
            cfg5 = cfg5.replace(num_layers=depth)
        m5 = Model(cfg5, device="cuda")
        p5 = m5.init(torch.Generator(device="cuda").manual_seed(5))
        b5 = f2_batch(torch, cfg5, F2_B, s5, torch.bfloat16, seed=6)
        with torch.no_grad():
            m5.prefill_logits(p5, b5)  # warm-up
            torch.cuda.synchronize()
            reset()
            t0 = time.perf_counter()
            lg = m5.prefill_logits(p5, b5)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
        n5 = fa_ops.flash_attention.launches
        check(n5 == cfg5.num_layers and bool(torch.isfinite(lg).all())
              and tuple(lg.shape) == (F2_B, 1, cfg5.vocab_size),
              f"{arch} prefill: {n5} K5 launches, logits {tuple(lg.shape)}")
        out["prefill"][arch] = dict(s=sec, layers=cfg5.num_layers,
                                    launches=n5)
        cut = f" (reduced: {get_arch(arch).model.num_layers} -> {depth})" \
            if depth else ""
        print(f"  (e) {arch} prefill_logits B={F2_B} S={s5}, "
              f"{cfg5.num_layers} layers{cut}: {sec:.4f} s -> "
              f"{F2_B * s5 / sec:,.0f} tokens/s; K5 launches {n5}")
        del m5, p5, b5, lg
        freed(torch, base, f"{arch} prefill")
    print(f"  (e): {time.perf_counter() - t:.1f} s")
    return out


# Slice F3: LM training. The backward kernels of K5 and K6 (no TPU kernel:
# the JAX package differentiates its jnp paths, which these stand for)
BWD_SOURCES = {"flash_attention_bwd": "src/repro_torch/csrc/flash_attn_bwd.cu",
               "selective_scan_bwd": "src/repro_torch/csrc/ssm_scan_bwd.cu"}
BWD_REPLACES = {"flash_attention_bwd": "src/repro/models/attention.py:168",
                "selective_scan_bwd": "src/repro/models/ssm.py:63"}
# K5's backward: (B, S, H, Hkv, D, window, dtype); the first is the training
# run's (4 slots x b = 1 folded into B, S = 2048), then Hymba's prefill
# shapes, a ragged S, and deepseek-moe-16b's D = 128
ATTN_BWD_CASES = ((4, 2048, 25, 5, 64, 1024, "bfloat16"),
                  (2, 4096, 25, 5, 64, 1024, "bfloat16"),
                  (2, 4096, 25, 5, 64, 1024, "float32"),
                  (2, 4096, 25, 5, 64, 0, "bfloat16"),
                  (2, 4096, 25, 5, 64, 0, "float32"),
                  (2, 3001, 25, 5, 64, 1024, "bfloat16"),
                  (2, 4096, 16, 16, 128, 0, "bfloat16"))
# K5's backward vs its plain backward (rtol, atol in units of the largest
# |gradient|): both sum in f32, in other orders; bf16 outputs are the f32
# sums rounded once, so they differ by one bf16 ulp of an element at most
ATTN_BWD_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (8e-3, 4e-3)}
# K6's backward: (B, S, groups of a; 0 = one shared a); the first is the
# training run's (4 slots, each with its own A), then Hymba's widths with a
# shared and a per-row a, and a ragged S
SCAN_BWD_CASES = ((4, 2048, 4), (2, 4096, 0), (2, 4096, 2), (2, 1001, 0))
SCAN_BWD_RTOL, SCAN_BWD_ATOL_REL = 1e-4, 1e-5
# torch.func.grad of Model.loss, card vs CPU, f32, TF32 off: cuBLAS vs the
# CPU's matmuls over 2 layers at full width; in units of the largest |grad|
GRAD_TOL = 1e-4
GRAD_S, GRAD_LAYERS, GRAD_CLIENTS, GRAD_CE_CHUNK = 512, 2, 3, 200
# (d) the training run: Hymba-1.5B at full width, bf16, cohort C, buffer K,
# M local steps of b sequences of S tokens; 1 warm-up round, then the timed
# ones. Depth cut to TRAIN_LAYERS of 32 so the cohort state fits the card
TRAIN_C, TRAIN_K, TRAIN_M, TRAIN_B, TRAIN_S = 4, 3, 2, 1, 2048
TRAIN_LAYERS, TRAIN_ROUNDS = 6, 3
TRAIN_PEAK_LIMIT = 72 << 30
TRAIN_PROBE_LAYERS = 2  # a short run here gives the peak's bytes a layer


def tree_err(torch, got, want) -> float:
    """Largest |got - want| over a tree's leaves, over the largest |want|."""
    from repro_torch.utils.tree import tree_leaves

    pairs = list(zip(tree_leaves(got), tree_leaves(want)))
    err = max(float((a.float().cpu() - b.float().cpu()).abs().max())
              for a, b in pairs)
    return err / max(float(b.float().abs().max()) for _, b in pairs)


def bwd_instance(fa_kernel, d: int, dtype_name: str):
    """K5's backward instance at (D, dtype): its name and ptxas's registers
    and spills (store / load bytes) for each of its kernels."""
    if dtype_name == "bfloat16":
        name, parts = "wgmma", (f"fa_bwd_dq_sm90ILi{d}E",
                                f"fa_bwd_dkdv_sm90ILi{d}E")
    else:
        name, parts = "CUDA cores", (f"fa_bwd_dq_kernelILi{d}E",
                                     f"fa_bwd_dkdv_kernelILi{d}E")
    usage = {}
    for part in parts:
        for kname, (regs, st, ld) in ptxas_usage(
                fa_kernel.BWD_LIBRARY.ptxas_info, part).items():
            mode = re.search(r"ILi\d+ELi(\d)E", kname)
            label = part.split("ILi")[0] + (f"<{d}, {mode.group(1)}>" if mode
                                             else f"<{d}>")
            usage[label] = dict(registers=regs, spill_stores=st,
                                spill_loads=ld)
    return name, usage


def attn_bwd_phase(torch, fa_ops, fa_ref, rate: float,
                   cases=ATTN_BWD_CASES):
    """(a) K5's backward against its plain backward, both on the forward
    kernel's o and lse; per-case records."""
    from repro_torch.kernels.flash_attn import kernel as fa_kernel

    F = torch.nn.functional
    records = {}
    for b, s, h, hkv, d, window, dtype_name in cases:
        dtype = getattr(torch, dtype_name)
        g = torch.Generator(device="cuda").manual_seed(s + h + d + window)
        q, k, v, do = (torch.randn(b, s, n, d, device="cuda", generator=g)
                       .to(dtype) for n in (h, hkv, hkv, h))
        o, lse = fa_ops.flash_attention_lse(q, k, v, window=window)

        def kernel():
            return fa_ops.flash_attention_bwd(q, k, v, o, do, lse,
                                              window=window)

        got = kernel()
        again = kernel()
        check(all(torch.equal(x, y) for x, y in zip(got, again)),
              f"K5 backward not bit-identical at {(b, s, h, d, window)}")
        want = fa_ref.flash_attention_bwd_ref(q, k, v, o, do, window=window,
                                              lse=lse)
        rtol, atol = ATTN_BWD_TOL[dtype_name]
        err = 0.0
        for name, x, y in zip(("dq", "dk", "dv"), got, want):
            scale = float(y.float().abs().max())
            e = float((x.float() - y.float()).abs().max())
            err = max(err, e)
            check(torch.allclose(x.float(), y.float(), rtol=rtol,
                                 atol=atol * scale),
                  f"K5 backward {name} vs plain at {(b, s, h, d, window)} "
                  f"{dtype_name}: max abs err {e} of max {scale}")
        del got, again, want
        # yardstick: SDPA's backward on the same band (B, H, S, D)
        qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                      for t in (q, k, v))
        dot = do.transpose(1, 2).contiguous()
        mask = fa_ref.band_mask(s, s, True, window, q.device)
        out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                             enable_gqa=True)

        def library():
            return torch.autograd.grad(out, (qt, kt, vt), dot,
                                       retain_graph=True)

        pairs = attn_pairs(s, window)
        flops = 10 * d * pairs * b * h
        nbytes = (4 * b * s * h + 4 * b * s * hkv) * d * q.element_size()
        bytes_ms = nbytes / rate * 1e3
        ops_ms = flops / (BF16_FLOPS if dtype == torch.bfloat16
                          else F32_FLOPS) * 1e3
        r = dict(
            ms=time_ms(torch, kernel, reps=10, warmup=2),
            burst_ms=time_burst(torch, kernel, n=20, warmup=2),
            plain_ms=time_ms(torch, lambda: fa_ref.flash_attention_bwd_ref(
                q, k, v, o, do, window=window, lse=lse), reps=2, warmup=1),
            library_ms=time_ms(torch, library, reps=10, warmup=2),
            library_burst_ms=None, device_ms=None, library_device_ms=None,
            max_abs_err=err, bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
            shape=dict(b=b, s=s, h=h, hkv=hkv, d=d, window=window,
                       dtype=dtype_name))
        r["instance"], r["ptxas"] = bwd_instance(fa_kernel, d, dtype_name)
        r["bound_share"] = r["bound_ms"] / r["ms"]
        r["vs_sdpa"] = r["ms"] / r["library_ms"]
        print(f"    K5 backward B={b} S={s:5d} H={h} Hkv={hkv} D={d} "
              f"window={window:4d} {dtype_name:8s} ({r['instance']}): kernel "
              f"{r['ms']:.4f} ms (burst {r['burst_ms']:.4f})  plain "
              f"{r['plain_ms']:.4f} ms  SDPA backward {r['library_ms']:.4f} ms "
              f"(kernel / SDPA {r['vs_sdpa']:.3f})  bound {r['bound_ms']:.4f} "
              f"ms ({r['bound_by']}, {flops / 1e9:.2f} GFLOP, {nbytes:,d} B; "
              f"{100 * r['bound_share']:.1f}% of it)  max_abs_err {err:.3g}; "
              + "; ".join(f"{k_} {u['registers']} registers, "
                          f"{u['spill_stores']} / {u['spill_loads']} B spilled"
                          for k_, u in r["ptxas"].items()))
        records[(b, s, h, hkv, d, window, dtype_name)] = r
        del q, k, v, o, lse, do, qt, kt, vt, dot, out, mask
        torch.cuda.empty_cache()
    return records


def scan_bwd_usage(ss_kernel):
    """ptxas's registers and spills (store / load bytes) of K6's backward
    kernels, {label: {...}}: the walk at every N and the reduce kernel;
    empty where this process did not build the library."""
    usage = {}
    for kname, (regs, st, ld) in ptxas_usage(
            ss_kernel.BWD_LIBRARY.ptxas_info, "ss_bwd").items():
        m = re.search(r"ss_bwd_kernelILi(\d+)E", kname)
        label = f"ss_bwd_kernel<{m.group(1)}>" if m else "ss_bwd_reduce_kernel"
        usage[label] = dict(registers=regs, spill_stores=st, spill_loads=ld)
    return usage


def scan_bwd_phase(torch, ss_ops, ss_ref, rate: float):
    """(b) K6's backward (and the per-row-a forward) against their plain
    versions; per-case records, each with ptxas's registers and spills of
    both kernels, the walk's resident blocks an SM, the grid's waves and the
    share of the bound."""
    from repro_torch.kernels.ssm_scan import kernel as ss_kernel

    di, n = HYMBA_DI, HYMBA_N
    usage = scan_bwd_usage(ss_kernel)
    if usage:  # every instance at 0 spills
        check(len(usage) == len(ss_ops.STATE_SIZES) + 1,
              f"K6 backward: ptxas reported {sorted(usage)}")
        for label, u in usage.items():
            check(u["spill_stores"] == 0 and u["spill_loads"] == 0,
                  f"K6 backward {label} spills: {u}")
        print("    K6 backward ptxas: " + "; ".join(
            f"{k} {u['registers']} registers, {u['spill_stores']} / "
            f"{u['spill_loads']} B spilled" for k, u in sorted(usage.items())))
    else:
        print("    K6 backward ptxas: no report (the library was built by an "
              "earlier process)")
    resident = ss_kernel.backward_resident_blocks(n)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    records = {}
    for b, s, groups in SCAN_BWD_CASES:
        g = torch.Generator(device="cuda").manual_seed(b + s + groups)
        x = torch.randn(b, s, di, device="cuda", generator=g)
        dt = torch.nn.functional.softplus(
            torch.randn(b, s, di, device="cuda", generator=g) - 1.0)
        bb, c = (torch.randn(b, s, n, device="cuda", generator=g)
                 for _ in range(2))
        a = -torch.exp(0.5 * torch.randn(*((groups,) if groups else ()), di,
                                         n, device="cuda", generator=g))
        dy = torch.randn(b, s, di, device="cuda", generator=g)
        args = (x, dt, bb, c, a, dy)
        if groups:  # the forward with one a per group of rows
            y = ss_ops.selective_scan(*args[:5])
            want_y = ss_ref.selective_scan_ref(*args[:5])
            check(torch.allclose(y, want_y, rtol=SCAN_RTOL,
                                 atol=SCAN_ATOL_REL * float(
                                     want_y.abs().max())),
                  f"K6 per-row-a forward vs plain at {(b, s, groups)}")
            del y, want_y

        def kernel():
            return ss_ops.selective_scan_bwd(*args)

        got = kernel()
        check(all(torch.equal(p, q) for p, q in zip(got, kernel())),
              f"K6 backward not bit-identical at {(b, s, groups)}")
        want = ss_ref.selective_scan_bwd_ref(*args)
        err = 0.0
        for name, p, q in zip(("dx", "ddt", "db", "dc", "da"), got, want):
            scale = float(q.abs().max())
            e = float((p - q).abs().max())
            err = max(err, e)
            check(torch.allclose(p, q, rtol=SCAN_BWD_RTOL,
                                 atol=SCAN_BWD_ATOL_REL * scale),
                  f"K6 backward {name} vs plain at {(b, s, groups)}: max abs "
                  f"err {e} of max {scale}")
        del got, want
        a_mats = groups or 1
        nbytes = (5 * b * s * di + 4 * b * s * n + 2 * a_mats * di * n) * 4
        flops = 20 * b * s * di * n
        bytes_ms = nbytes / rate * 1e3
        ops_ms = flops / F32_FLOPS * 1e3
        first = (b, s, groups) == SCAN_BWD_CASES[0]
        r = dict(
            ms=time_ms(torch, kernel, reps=10, warmup=2),
            burst_ms=time_burst(torch, kernel, n=10, warmup=2),
            plain_ms=(time_ms(torch, lambda: ss_ref.selective_scan_bwd_ref(
                *args), reps=1, warmup=0) if first else None),
            library_ms=None, library_burst_ms=None, device_ms=None,
            library_device_ms=None, max_abs_err=err,
            bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
            shape=dict(b=b, s=s, di=di, n=n, a_groups=groups),
            ptxas={k: u for k, u in usage.items()
                   if k in (f"ss_bwd_kernel<{n}>", "ss_bwd_reduce_kernel")},
            resident_blocks_per_sm=resident,
            grid_blocks=b * -(-di // 32))
        r["waves"] = r["grid_blocks"] / (resident * sms)
        r["bound_share"] = r["bound_ms"] / r["ms"]
        r["burst_bound_share"] = r["bound_ms"] / r["burst_ms"]
        print(f"    K6 backward B={b} S={s:5d} di={di} N={n} a "
              f"{'per ' + str(b // groups) + ' rows' if groups else 'shared'}"
              f": kernel {r['ms']:.4f} ms (burst {r['burst_ms']:.4f})  plain "
              f"{fmt_ms(r['plain_ms'])} ms  library n/a  bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}, {nbytes:,d} B; "
              f"{100 * r['bound_share']:.1f}% of it, burst "
              f"{100 * r['burst_bound_share']:.1f}%)  max_abs_err {err:.3g}; "
              f"{r['grid_blocks']} blocks, {resident} an SM on {sms} SMs: "
              f"{r['waves']:.2f} waves")
        records[(b, s, groups)] = r
        del x, dt, bb, c, a, dy, args
        torch.cuda.empty_cache()
    return records


def grads_phase(torch, np, fa_ops, ss_ops, rn_ops, get_arch, Model):
    """(c) torch.func.grad of Model.loss at Hymba's full width, 2 layers,
    f32: card vs CPU, vmap over clients vs separate calls, ce_chunk and
    remat_block vs the plain run."""
    from torch.func import grad, vmap

    from repro_torch.utils.tree import tree_map

    base = get_arch("hymba-1.5b").model.replace(
        num_layers=GRAD_LAYERS, param_dtype="float32", compute_dtype="float32")

    def loss_grad(cfg, device):
        model = Model(cfg, device=device)
        return grad(lambda p, b: model.loss(p, b)[0])

    card = Model(base, device="cuda")
    params = card.init(torch.Generator(device="cuda").manual_seed(3))
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, base.vocab_size, (GRAD_CLIENTS, 1, GRAD_S + 1)))
    batches = [{"tokens": toks[i, :, :GRAD_S], "labels": toks[i, :, 1:]}
               for i in range(GRAD_CLIENTS)]
    on_card = [{k: v.cuda() for k, v in b.items()} for b in batches]

    def counts():
        return (fa_ops.flash_attention.launches,
                ss_ops.selective_scan.launches,
                fa_ops.flash_attention_bwd.launches,
                ss_ops.selective_scan_bwd.launches,
                rn_ops.rms_norm.launches, rn_ops.rms_norm_bwd.launches)

    for o in (fa_ops, ss_ops, rn_ops):
        o.reset_launches()
    g_card = loss_grad(base, "cuda")(params, on_card[0])
    torch.cuda.synchronize()
    n = GRAD_LAYERS
    want = (2 * n, 2 * n, n, n) + norm_launches(base, grads=1, forwards=0)
    check(counts() == want, f"grad launches {counts()}")
    t = time.perf_counter()
    g_cpu = loss_grad(base, "cpu")(to_cpu(params), batches[0])
    err = tree_err(torch, g_card, g_cpu)
    print(f"    grad of Model.loss, {n} layers, S={GRAD_S}, f32: card vs CPU "
          f"{err:.3g} of max |grad| (limit {GRAD_TOL}); K5/K6 forward, "
          f"backward, RMSNorm forward, backward launches {counts()}; "
          f"CPU {time.perf_counter() - t:.1f} s")
    check(err <= GRAD_TOL, f"grad card vs CPU {err}")
    del g_cpu

    # vmap over clients, each with its own params: one launch a pass
    g = torch.Generator(device="cuda").manual_seed(4)
    clients = tree_map(lambda p: p[None] + 1e-3 * torch.randn(
        (GRAD_CLIENTS,) + tuple(p.shape), device="cuda", generator=g), params)
    stacked = {k: torch.stack([b[k] for b in on_card]) for k in on_card[0]}
    for o in (fa_ops, ss_ops, rn_ops):
        o.reset_launches()
    together = vmap(loss_grad(base, "cuda"))(clients, stacked)
    torch.cuda.synchronize()
    check(counts() == want, f"vmapped launches {counts()}")
    errs = [tree_err(torch, tree_map(lambda t: t[i], together),
                     loss_grad(base, "cuda")(tree_map(lambda t: t[i], clients),
                                             on_card[i]))
            for i in range(GRAD_CLIENTS)]
    print(f"    vmap over {GRAD_CLIENTS} clients vs separate calls: "
          f"{max(errs):.3g} of max |grad|")
    check(max(errs) <= GRAD_TOL, f"vmap vs separate {errs}")
    del clients, together

    # ce_chunk (ragged last chunk) and grouped remat: the same gradients
    for what, cfg in (("ce_chunk", base.replace(ce_chunk=GRAD_CE_CHUNK)),
                      ("remat_block", base.replace(remat_block=2))):
        e = tree_err(torch, loss_grad(cfg, "cuda")(params, on_card[0]),
                     g_card)
        print(f"    {what} vs the plain run: {e:.3g} of max |grad|")
        check(e <= GRAD_TOL, f"{what} vs plain {e}")
    del params, g_card
    torch.cuda.empty_cache()


def train_phase(torch, kernel_ops, get_arch, card: str, layers: int):
    """(d) The training run at Hymba-1.5B's full width, through
    ``launch/train.py``'s ``TrainLoop``; then the launcher in a process of
    its own."""
    from repro_torch.configs.base import FLConfig
    from repro_torch.launch import train

    ops, rc_ops, fa_ops, ss_ops, rn_ops = kernel_ops

    def reset():
        for o in kernel_ops:
            o.reset_launches()

    def counts():
        return {"fused_server": ops.server_update.launches,
                "sq_dists": ops.sq_dists.launches,
                "weighted_sum": ops.weighted_sum.launches,
                "int8_sq_dists": rc_ops.int8_sq_dists.launches,
                "flash_attention": fa_ops.flash_attention.launches,
                "selective_scan": ss_ops.selective_scan.launches,
                "flash_attention_bwd": fa_ops.flash_attention_bwd.launches,
                "selective_scan_bwd": ss_ops.selective_scan_bwd.launches,
                "rms_norm": rn_ops.rms_norm.launches,
                "rms_norm_bwd": rn_ops.rms_norm_bwd.launches}

    fl = FLConfig(buffer_size=TRAIN_K, local_steps=TRAIN_M, local_lr=5e-3,
                  weighting="paper", server_pass_mode="fused")

    def make_loop(depth: int, rounds: int):
        cfg = get_arch("hymba-1.5b").model.replace(num_layers=depth)
        return train.TrainLoop(cfg, fl, cohort=TRAIN_C, batch=TRAIN_B,
                               seq=TRAIN_S, rounds=rounds, seed=0,
                               device="cuda")

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    # the depth: the peak of 2 rounds at TRAIN_PROBE_LAYERS, against the
    # run's, gives the bytes a layer adds
    torch.cuda.reset_peak_memory_stats()
    probe = make_loop(TRAIN_PROBE_LAYERS, 2)
    probe_params = probe.model.param_count(probe.state.global_params)
    for r in range(2):
        probe.round(r)
    torch.cuda.synchronize()
    probe_peak = torch.cuda.max_memory_allocated() - base
    del probe
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    # the timed rounds, then one more under torch.profiler
    loop = make_loop(layers, TRAIN_ROUNDS + 2)
    n_params = loop.model.param_count(loop.state.global_params)
    torch.cuda.synchronize()
    print(f"    Hymba-1.5B at full width, {layers} of 32 layers, bf16: "
          f"{n_params:,d} params; cohort state "
          f"{(torch.cuda.memory_allocated() - base) / 2**30:.2f} GiB; init "
          f"{time.perf_counter() - t:.1f} s")
    norms = norm_launches(loop.model.cfg, grads=TRAIN_M)
    want = {"fused_server": 1, "sq_dists": 0, "weighted_sum": 0,
            "int8_sq_dists": 0,
            "flash_attention": (2 * TRAIN_M + 1) * layers,
            "selective_scan": (2 * TRAIN_M + 1) * layers,
            "flash_attention_bwd": TRAIN_M * layers,
            "selective_scan_bwd": TRAIN_M * layers,
            "rms_norm": norms[0], "rms_norm_bwd": norms[1]}
    times, batch_times, losses = [], [], []
    reset()  # the run's counts: set to 0 here, read after its last round
    before = counts()
    for r in range(TRAIN_ROUNDS + 1):
        t = time.perf_counter()
        mets = loop.round(r)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        now = counts()
        got = {k: now[k] - before[k] for k in now}
        before = now
        check(got == want, f"training round {r}: launches {got}, want {want}")
        loss = float(mets["fresh_loss_mean"])
        check(math.isfinite(loss), f"round {r} loss {loss}")
        check(int(loop.state.version) == r + 1,
              f"version {int(loop.state.version)} after round {r}")
        losses.append(loss)
        if r:  # round 0 is the warm-up
            times.append(dt)
            batch_times.append(loop.batch_s)
    peak = torch.cuda.max_memory_allocated()
    check(peak - base <= TRAIN_PEAK_LIMIT,
          f"training peak {peak / 2**30:.2f} GiB")
    per_layer = (peak - base - probe_peak) / (layers - TRAIN_PROBE_LAYERS)
    print(f"    depth: peak {probe_peak / 2**30:.2f} GiB at "
          f"{TRAIN_PROBE_LAYERS} layers, {(peak - base) / 2**30:.2f} GiB at "
          f"{layers}: {per_layer / 2**30:.2f} GiB a layer "
          f"({(peak - base - probe_peak) / (n_params - probe_params):.2f} B a "
          f"parameter at C = {TRAIN_C}), so "
          f"{(peak - base + per_layer) / 2**30:.2f} GiB at {layers + 1} "
          f"(limit {TRAIN_PEAK_LIMIT / 2**30:.0f} GiB)")
    total = sum(times)
    tokens = TRAIN_C * TRAIN_M * TRAIN_B * TRAIN_S
    out = dict(layers=layers, params=n_params, round_s=times,
               batch_s=batch_times, per_layer_gib=per_layer / 2**30,
               bytes_per_param_a_layer=(peak - base - probe_peak)
               / (n_params - probe_params),
               rounds_per_s=len(times) / total,
               tokens_per_s=tokens * len(times) / total,
               peak_gib=(peak - base) / 2**30, losses=losses,
               per_round=want, counts=counts())
    print(f"    training ({card}): C={TRAIN_C} K={TRAIN_K} M={TRAIN_M} "
          f"b={TRAIN_B} S={TRAIN_S}, {layers} layers, fused: "
          f"{out['rounds_per_s']:.4f} rounds/s, {out['tokens_per_s']:,.0f} "
          f"trained tokens/s (rounds {', '.join(f'{x:.3f}' for x in times)} "
          f"s after a warm-up of 1; of which the host made the batches in "
          f"{', '.join(f'{x:.3f}' for x in batch_times)} s), peak "
          f"{out['peak_gib']:.2f} GiB; "
          f"fresh loss by round {[round(x, 4) for x in losses]}; launches "
          f"a round {want}")
    # one more round under torch.profiler (outside the counted run)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        loop.round(TRAIN_ROUNDS + 1)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    rows = device_events(torch, prof.key_averages())
    busy_ms = sum(us for _, _, us in rows) / 1e3
    out.update(profile_wall_ms=wall_ms, profile_busy_ms=busy_ms,
               profile_batch_ms=loop.batch_s * 1e3)
    print(f"    one round under torch.profiler: {wall_ms:.1f} ms wall (the "
          f"host's batch {loop.batch_s * 1e3:.1f} ms), device busy "
          f"{busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.0f}%) in "
          f"{sum(c for _, c, _ in rows)} device operations; largest:")
    for name, count, us in rows[:10]:
        print(f"      {us / 1e3:9.3f} ms  x{count:5d}  {name[:100]}")
    for what, part in (("K5 forward", "flash_fwd"), ("K5 backward", "fa_bwd"),
                       ("K6 forward", "selective_scan_kernel"),
                       ("K6 backward", "ss_bwd")):
        ms = sum(us for name, _, us in rows if part in name) / 1e3
        out[f"profile_{part}_ms"] = ms
        print(f"      {what}: {ms:.3f} ms ({100 * ms / busy_ms:.1f}% of busy)")
    del loop, mets, prof
    torch.cuda.empty_cache()

    # the launcher, as a user runs it, in a process of its own
    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "hymba-1.5b", "--smoke", "--rounds", "3"], cwd=str(ROOT),
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0,
          f"launch/train.py exited {proc.returncode}: {proc.stderr[-2000:]}")
    print(f"    launch/train.py --arch hymba-1.5b --smoke --rounds 3 on the "
          f"card: exit 0, {time.perf_counter() - t:.1f} s; "
          f"{(proc.stderr.strip().splitlines() or [''])[-1]}")
    return out


def slice_f3_phase(torch, np, kernel_ops, fa_ref, ss_ref, get_arch, Model,
                   rate: float, card: str):
    """Slice F3: LM training on the card."""
    _, _, fa_ops, ss_ops, rn_ops = kernel_ops
    out = {}
    t = time.perf_counter()
    print("  (a) K5's backward (median of 10 calls; burst of 20):")
    out["attn"] = attn_bwd_phase(torch, fa_ops, fa_ref, rate)
    print("  (b) K6's backward (median of 10 calls; burst of 10):")
    out["scan"] = scan_bwd_phase(torch, ss_ops, ss_ref, rate)
    print(f"  (a), (b): {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    print("  (c) gradients of Model.loss:")
    grads_phase(torch, np, fa_ops, ss_ops, rn_ops, get_arch, Model)
    print(f"  (c): {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    print("  (d) the training run:")
    out["train"] = train_phase(torch, kernel_ops, get_arch, card,
                               TRAIN_LAYERS)
    print(f"  (d): {time.perf_counter() - t:.1f} s")
    return out


# Slice F4 (phase 11): training of the MoE, encoder-decoder and patch archs,
# K5's backward at D 160 and 256, and the lean cohort round
# (a) K5's backward at stablelm-12b's and gemma-7b's training shapes: two
# slots x b = 1 folded into B, S = 2048, causal
F4_ATTN_BWD_CASES = ((2, 2048, 32, 8, 160, 0, "bfloat16"),
                     (2, 2048, 32, 8, 160, 0, "float32"),
                     (2, 2048, 16, 16, 256, 0, "bfloat16"),
                     (2, 2048, 16, 16, 256, 0, "float32"))
# (b) grad of Model.loss at full width, f32, S = 256 tokens (pixtral: and
# its 256 patches), card vs CPU and vmap over F4_GRAD_SLOTS slots vs
# separate calls, at GRAD_TOL; the MoE compared under the card's routing
F4_GRAD_S, F4_GRAD_SLOTS = 256, 2
F4_GRAD = (("deepseek-moe-16b", dict(num_layers=1)),
           ("whisper-tiny", {}),
           ("pixtral-12b", dict(num_layers=1)),
           ("stablelm-12b", dict(num_layers=1)),
           ("gemma-7b", dict(num_layers=1)))
# (c) TrainLoop runs at full width, bf16, fused: (label, arch, depth, C, S);
# depth None = full, 0 = the deepest that fits F4_PEAK_LIMIT
F4_TRAIN = (("whisper-tiny", "whisper-tiny", None, 4, 448),
            ("deepseek-moe-16b", "deepseek-moe-16b", 0, 2, 2048),
            ("stablelm-12b", "stablelm-12b", 1, 2, 2048),
            ("gemma-7b", "gemma-7b", 1, 2, 2048),
            ("pixtral-12b", "pixtral-12b", 1, 2, 2048))
F4_M, F4_B, F4_ROUNDS = 2, 1, 3
F4_PEAK_LIMIT = 72 << 30
F4_BYTES_TARGET = 50.0  # bytes a parameter a layer adds at C = 2
HYMBA_PEAK_BEFORE_GIB = 63.11  # PERF.md §4: 6 layers before the memory repair


class RouteHook:
    """Wraps ``moe.route`` while active. Records each call's router
    probabilities and expert ids (under ``vmap``, stacked with the vmapped
    dim first); with ``forced`` (a list, one (T, k) id tensor per call in
    order) the ids are replaced by the forced ones and the gates taken from
    the call's own probabilities at those ids, renormalised as ``route``
    does (the same bits where the ids agree)."""

    def __init__(self, torch, moe, forced=None):
        self.torch, self.moe, self.forced = torch, moe, forced
        self.probs, self.ids, self.calls = [], [], 0

    def __enter__(self):
        torch, inner = self.torch, self.moe.route
        self.inner = inner

        def route(cfg, p, xf):
            probs, gates, ids = inner(cfg, p, xf)
            self.probs.append(self.plain(probs).detach())
            self.ids.append(self.plain(ids))
            if self.forced is not None:
                ids = self.forced[self.calls]
                gates = torch.gather(probs, 1, ids)
                gates = gates / torch.clamp(gates.sum(-1, keepdim=True),
                                            min=1e-9)
            self.calls += 1
            return probs, gates, ids

        self.moe.route = route
        return self

    def __exit__(self, *exc):
        self.moe.route = self.inner

    def plain(self, t):
        """``t`` out of ``torch.func``'s wrappers, each vmapped dim moved
        to the front (the outermost vmap's first)."""
        f = self.torch._C._functorch
        while f.is_functorch_wrapped_tensor(t):
            bdim = f.maybe_get_bdim(t) if f.is_batchedtensor(t) else -1
            t = f.get_unwrapped(t)
            if bdim >= 0:
                t = t.movedim(bdim, 0)
        return t


def f4_loss_batches(np, cfg, slots: int, s: int, seed: int):
    """Each slot's loss batch (tokens, labels and the frontends' inputs),
    numpy, from a seed."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(slots):
        toks = rng.integers(0, cfg.vocab_size, (1, s + 1))
        b = {"tokens": toks[:, :s], "labels": toks[:, 1:]}
        if cfg.num_patches:
            b["patches"] = rng.normal(
                size=(1, cfg.num_patches, cfg.d_model)).astype(np.float32)
        if cfg.is_encdec:
            b["frames"] = rng.normal(
                size=(1, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)
        out.append(b)
    return out


def f4_grads_phase(torch, np, fa_ops, get_arch, Model):
    """(b) grad of Model.loss at full width, f32: card vs CPU, and vmap over
    slots vs separate calls; the MoE's routing compared first (flips only
    at near-ties), its gradients then held under the card's routing."""
    from torch.func import grad, vmap

    from repro_torch.models import moe
    from repro_torch.utils.tree import tree_map

    out = {}
    for arch, kw in F4_GRAD:
        t = time.perf_counter()
        cfg = get_arch(arch).model.replace(param_dtype="float32",
                                           compute_dtype="float32", **kw)
        card, cpu = Model(cfg, device="cuda"), Model(cfg, device="cpu")
        params = card.init(torch.Generator(device="cuda").manual_seed(5))
        host = f4_loss_batches(np, cfg, F4_GRAD_SLOTS, F4_GRAD_S, seed=5)
        cpu_b = [{k: torch.from_numpy(v) for k, v in b.items()} for b in host]
        card_b = [{k: v.cuda() for k, v in b.items()} for b in cpu_b]
        n = cfg.num_layers

        def loss_grad(model):
            return grad(lambda p, b: model.loss(p, b)[0])

        fa_ops.reset_launches()
        with RouteHook(torch, moe) as rec:
            g_card = loss_grad(card)(params, card_b[0])
        torch.cuda.synchronize()
        attn = n  # whisper-tiny: its decoder's (the encoder's is plain)
        check((fa_ops.flash_attention.launches,
               fa_ops.flash_attention_bwd.launches) == (2 * attn, attn),
              f"{arch} grad launches {fa_ops.flash_attention.launches}, "
              f"{fa_ops.flash_attention_bwd.launches}")
        flips = choices = 0
        with RouteHook(torch, moe, forced=[i.cpu() for i in rec.ids]) as hc:
            g_cpu = loss_grad(cpu)(to_cpu(params), cpu_b[0])
        for probs_c, ids_c, ids in zip(hc.probs, hc.ids, rec.ids):
            f, c, bad = route_flips(torch, cfg, probs_c, ids, ids_c)
            check(bad == 0, f"{arch}: {bad} of {f} routing flips card vs CPU "
                  f"are not near-ties")
            flips, choices = flips + f, choices + c
        err = tree_err(torch, g_card, g_cpu)
        check(err <= GRAD_TOL, f"{arch} grad card vs CPU {err}")
        del g_cpu

        # vmap over slots, each with its own params, vs separate calls, all
        # through the remat of the layers as the round runs them; the MoE's
        # routing compared first: the gradients compare under one routing
        g = torch.Generator(device="cuda").manual_seed(6)
        slots = tree_map(lambda p: p[None] + 1e-3 * torch.randn(
            (F4_GRAD_SLOTS,) + tuple(p.shape), device="cuda", generator=g),
            params)
        del params, g_card
        alone, routes = [], []
        for i in range(F4_GRAD_SLOTS):
            with RouteHook(torch, moe) as r:
                alone.append(loss_grad(card)(tree_map(lambda p: p[i], slots),
                                             card_b[i]))
            routes.append(r)
        stacked = {k: torch.stack([b[k] for b in card_b]) for k in card_b[0]}
        fa_ops.reset_launches()
        with RouteHook(torch, moe) as rv:
            together = vmap(loss_grad(card))(slots, stacked)
        torch.cuda.synchronize()
        check((fa_ops.flash_attention.launches,
               fa_ops.flash_attention_bwd.launches) == (2 * attn, attn),
              f"{arch} vmapped launches {fa_ops.flash_attention.launches}")
        check(len(rv.ids) == len(routes[0].ids),
              f"{arch}: {len(rv.ids)} routings under vmap, "
              f"{len(routes[0].ids)} a separate call")
        vflips = vbad = 0
        for j, ids in enumerate(rv.ids):
            for i, r in enumerate(routes):
                f, _, bad = route_flips(torch, cfg, r.probs[j].cpu(), ids[i],
                                        r.ids[j].cpu())
                vflips, vbad = vflips + f, vbad + bad
        check(vflips == 0, f"{arch}: the vmapped routing differs from the "
              f"separate calls' in {vflips} token rows ({vbad} not near-ties)")
        errs = [tree_err(torch, tree_map(lambda t: t[i], together), alone[i])
                for i in range(F4_GRAD_SLOTS)]
        check(max(errs) <= GRAD_TOL, f"{arch} vmap vs separate {errs}")
        out[arch] = dict(card_vs_cpu=err, vmap_vs_calls=max(errs),
                         flips=flips, choices=choices,
                         s=time.perf_counter() - t)
        print(f"    {arch:16s} {n} layer(s), f32, S={F4_GRAD_S}: grad card vs "
              f"CPU {err:.3g} of max |grad|, vmap over {F4_GRAD_SLOTS} slots "
              f"vs separate calls {max(errs):.3g} (limit {GRAD_TOL})"
              + (f"; routing flips card vs CPU {flips} of {choices} choices "
                 f"(near-ties), gradients under the card's routing; vmapped "
                 f"routing = the separate calls'" if cfg.is_moe else "")
              + f"; {out[arch]['s']:.1f} s")
        del slots, alone, together, stacked, card_b, card
        torch.cuda.empty_cache()
    return out


def state_digest(torch, state):
    """Two int64 sums of the bits of every leaf of a cohort state: equal
    digests where two runs gave the same bits (a differing bit moves both
    by a different amount)."""
    from repro_torch.utils.tree import tree_leaves

    out, chunk = [], 1 << 24  # int64 scratch of 128 MiB at most
    for tree in state:
        for leaf in (tree_leaves(tree) if isinstance(tree, dict) else [tree]):
            bits = leaf.contiguous().reshape(-1).view(
                {1: torch.uint8, 2: torch.int16, 4: torch.int32}[
                    leaf.element_size()])
            s1 = s2 = 0
            for lo in range(0, bits.numel(), chunk):
                b = bits[lo:lo + chunk].to(torch.int64)
                w = torch.arange(lo, lo + b.numel(), device=b.device) \
                    % 65521 + 1
                s1 += int(b.sum())
                s2 += int((b * w).sum())
            out.append((s1, s2))
    return out


def f4_train_run(torch, kernel_ops, cfg, cohort: int, seq: int, card: str,
                 label: str, *, rounds: int = F4_ROUNDS, repeat=False,
                 profile=False, drops=False):
    """One TrainLoop run: 1 warm-up round, then ``rounds`` timed ones, each
    round's launches exact and its fresh loss finite; returns its numbers.
    ``repeat``: one more round twice from one state (same bits).
    ``profile``: one round under torch.profiler. ``drops``: the share of
    token-choices an eager loss drops at the end."""
    from repro_torch.configs.base import FLConfig
    from repro_torch.launch import train
    from repro_torch.models import moe

    ops, rc_ops, fa_ops, ss_ops, rn_ops = kernel_ops
    fl = FLConfig(buffer_size=max(1, cohort - 1), local_steps=F4_M,
                  local_lr=5e-3, weighting="paper", server_pass_mode="fused")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    loop = train.TrainLoop(cfg, fl, cohort=cohort, batch=F4_B, seq=seq,
                           rounds=rounds + 3, seed=0, device="cuda")
    n_params = loop.model.param_count(loop.state.global_params)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    state_gib = (torch.cuda.memory_allocated() - base) / 2**30
    layers = cfg.num_layers
    norms = norm_launches(cfg, grads=F4_M)
    want = {"fused_server": 1, "sq_dists": 0, "weighted_sum": 0,
            "int8_sq_dists": 0, "flash_attention": (2 * F4_M + 1) * layers,
            "selective_scan": 0, "flash_attention_bwd": F4_M * layers,
            "selective_scan_bwd": 0, "rms_norm": norms[0],
            "rms_norm_bwd": norms[1]}

    def counts():
        return {"fused_server": ops.server_update.launches,
                "sq_dists": ops.sq_dists.launches,
                "weighted_sum": ops.weighted_sum.launches,
                "int8_sq_dists": rc_ops.int8_sq_dists.launches,
                "flash_attention": fa_ops.flash_attention.launches,
                "selective_scan": ss_ops.selective_scan.launches,
                "flash_attention_bwd": fa_ops.flash_attention_bwd.launches,
                "selective_scan_bwd": ss_ops.selective_scan_bwd.launches,
                "rms_norm": rn_ops.rms_norm.launches,
                "rms_norm_bwd": rn_ops.rms_norm_bwd.launches}

    for o in kernel_ops:
        o.reset_launches()
    before = counts()
    times, batch_times, losses = [], [], []
    for r in range(rounds + 1):
        t = time.perf_counter()
        mets = loop.round(r)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        now = counts()
        got = {k: now[k] - before[k] for k in now}
        before = now
        check(got == want, f"{label} round {r}: launches {got}, want {want}")
        loss = float(mets["fresh_loss_mean"])
        check(math.isfinite(loss), f"{label} round {r} loss {loss}")
        losses.append(loss)
        if r:  # round 0 is the warm-up
            times.append(dt)
            batch_times.append(loop.batch_s)
    peak = torch.cuda.max_memory_allocated() - base
    check(peak <= F4_PEAK_LIMIT, f"{label} peak {peak / 2**30:.2f} GiB")
    total = sum(times)
    tokens = cohort * F4_M * F4_B * seq
    out = dict(label=label, layers=layers, cohort=cohort, seq=seq,
               params=n_params, rounds_per_s=len(times) / total,
               tokens_per_s=tokens * len(times) / total, round_s=times,
               batch_s=batch_times, peak=peak, peak_gib=peak / 2**30,
               bytes_per_param=peak / n_params, losses=losses,
               per_round=want, counts=counts(), init_s=init_s)
    print(f"    {label} ({card}): {layers} layers, {n_params:,d} params, "
          f"C={cohort} K={fl.buffer_size} M={F4_M} b={F4_B} S={seq}, bf16, "
          f"fused: {out['rounds_per_s']:.4f} rounds/s, "
          f"{out['tokens_per_s']:,.0f} trained tokens/s (rounds "
          f"{', '.join(f'{x:.3f}' for x in times)} s after a warm-up of 1; "
          f"host batches {', '.join(f'{x:.3f}' for x in batch_times)} s); "
          f"state {state_gib:.2f} GiB, peak {out['peak_gib']:.2f} GiB, "
          f"{out['bytes_per_param']:.2f} B a parameter; init {init_s:.1f} s; "
          f"fresh loss by round {[round(x, 4) for x in losses]}; launches a "
          f"round {dict((k, v) for k, v in want.items() if v)}")
    r = rounds + 1
    if repeat:  # the same round twice from one state: the same bits
        state, batch = loop.state, loop.next_batch(r)
        first, m1 = loop.step(state, batch)
        d1 = state_digest(torch, first)
        m1 = {k: float(v) for k, v in m1.items()}
        del first
        torch.cuda.empty_cache()  # the round's peak again, unfragmented
        second, m2 = loop.step(state, batch)
        same = (state_digest(torch, second) == d1
                and m1 == {k: float(v) for k, v in m2.items()})
        check(same, f"{label}: two rounds from one state differ")
        out["repeat_same_bits"] = same
        print(f"    {label}: one round twice from one state: the same bits "
              f"({len(d1)} leaves of the new state, and the metrics)")
        loop.state = second
        del state, second
        r += 1
    if profile:
        from torch.profiler import ProfilerActivity, profile as prof_ctx

        with prof_ctx(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            loop.round(r)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3
        rows = device_events(torch, prof.key_averages())
        busy_ms = sum(us for _, _, us in rows) / 1e3
        out.update(profile_wall_ms=wall_ms, profile_busy_ms=busy_ms,
                   profile_top=[(n, c, us) for n, c, us in rows[:10]])
        print(f"    {label}: one round under torch.profiler: {wall_ms:.1f} ms "
              f"wall, device busy {busy_ms:.1f} ms "
              f"({100 * busy_ms / wall_ms:.0f}%) in "
              f"{sum(c for _, c, _ in rows)} device operations; largest:")
        for name, count, us in rows[:10]:
            print(f"      {us / 1e3:9.3f} ms  x{count:5d}  {name[:100]}")
        ms = sum(us for name, _, us in rows if "fa_bwd" in name) / 1e3
        out["profile_fa_bwd_ms"] = ms
        print(f"      K5 backward: {ms:.3f} ms ({100 * ms / busy_ms:.1f}% of "
              f"busy)")
        del prof
    if drops:  # the routing of the trained global model on a fresh batch
        batch = loop.next_batch(r)["local"]
        one = {k: torch.as_tensor(v[0, 0]).cuda() for k, v in batch.items()}
        kept, total_c = [], []
        inner = moe.dispatch_plan

        def recorded(cfg_, expert_ids, cap):
            plan = inner(cfg_, expert_ids, cap)
            kept.append(int(plan.keep.sum()))
            total_c.append(plan.keep.numel())
            return plan

        moe.dispatch_plan = recorded
        try:
            with torch.no_grad():
                loop.model.loss(loop.state.global_params, one)
        finally:
            moe.dispatch_plan = inner
        out["drop_share"] = 1.0 - sum(kept) / sum(total_c)
        print(f"    {label}: share of token-choices dropped at cf "
              f"{cfg.moe_capacity_factor} by the trained model on a fresh "
              f"batch of {seq} tokens: {out['drop_share']:.4f} (per layer "
              f"{', '.join(f'{1 - k / c:.3f}' for k, c in zip(kept, total_c))})")
    del loop
    torch.cuda.empty_cache()
    return out


def f4_train_phase(torch, kernel_ops, get_arch, smoke_variant, card: str):
    """(c) the TrainLoop runs of Slice F4 at full width."""
    from repro_torch.models.model import build_model
    from repro_torch.utils.tree import tree_leaves

    def n_params(cfg) -> int:  # from meta tensors: nothing allocated
        return sum(t.numel() for t in tree_leaves(build_model(
            cfg, "cpu").init(None)))

    out = {}
    for label, arch, depth, cohort, seq in F4_TRAIN:
        full = get_arch(arch).model
        if depth == 0:
            # the deepest that fits: a 1-layer run, then the depth whose
            # peak at the 1-layer run's bytes a parameter fits the limit
            probe = f4_train_run(torch, kernel_ops, full.replace(num_layers=1),
                                 cohort, seq, card, f"{label} (1-layer probe)",
                                 rounds=1)
            per = probe["bytes_per_param"]
            depth = 1
            while n_params(full.replace(num_layers=depth + 1)) * per \
                    <= F4_PEAK_LIMIT:
                depth += 1
            print(f"    {label}: {per:.2f} B a parameter at 1 layer, so "
                  f"{depth} layer(s) fit {F4_PEAK_LIMIT / 2**30:.0f} GiB")
            out[label + "-probe"] = probe
            cfg = full.replace(num_layers=depth)
            r = f4_train_run(torch, kernel_ops, cfg, cohort, seq, card, label,
                             repeat=True, profile=True, drops=True)
            if depth > 1:
                r["bytes_per_param_a_layer"] = (r["peak"] - probe["peak"]) / (
                    r["params"] - probe["params"])
                print(f"    {label}: the peak grows "
                      f"{r['bytes_per_param_a_layer']:.2f} B a parameter a "
                      f"layer (1 -> {depth} layers; target "
                      f"{F4_BYTES_TARGET:.0f})")
            out[label] = r
            continue
        cfg = full if depth is None else full.replace(num_layers=depth)
        if label == "pixtral-12b":  # run at full width only where it fits
            n = n_params(cfg)
            per = out["stablelm-12b"]["bytes_per_param"]
            print(f"    pixtral-12b: {n:,d} params at {depth} layer; at "
                  f"stablelm-12b's {per:.2f} B a parameter its round would "
                  f"peak at {n * per / 2**30:.2f} GiB (limit "
                  f"{F4_PEAK_LIMIT / 2**30:.0f} GiB)")
            if n * per > F4_PEAK_LIMIT:
                cfg = smoke_variant(full)
                label = "pixtral-12b (smoke width)"
        out[label] = f4_train_run(torch, kernel_ops, cfg, cohort, seq, card,
                                  label)
    return out


def slice_f4_phase(torch, np, kernel_ops, fa_ref, get_arch, smoke_variant,
                   Model, rate: float, card: str, hymba_train):
    """Slice F4: K5's backward at D 160 / 256, gradients of the MoE, the
    encoder-decoder, the patch and the D 160 / 256 archs, their training
    runs, the Hymba run's memory against its peak before the memory
    repair, the launcher."""
    _, _, fa_ops, _, _ = kernel_ops
    out = {}
    t = time.perf_counter()
    print("  (a) K5's backward at D 160 and 256 (median of 10 calls; burst "
          "of 20):")
    out["attn"] = attn_bwd_phase(torch, fa_ops, fa_ref, rate,
                                 cases=F4_ATTN_BWD_CASES)
    print(f"  (a): {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    print("  (b) gradients of Model.loss at full width:")
    out["grads"] = f4_grads_phase(torch, np, fa_ops, get_arch, Model)
    print(f"  (b): {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    print("  (c) training runs:")
    out["train"] = f4_train_phase(torch, kernel_ops, get_arch, smoke_variant,
                                  card)
    print(f"  (c): {time.perf_counter() - t:.1f} s")
    if hymba_train is not None:
        print(f"  (d) Hymba-1.5B, {hymba_train['layers']} layers, C = "
              f"{TRAIN_C} (phase 10(d), after the memory repair): peak "
              f"{hymba_train['peak_gib']:.2f} GiB (before the memory repair: "
              f"{HYMBA_PEAK_BEFORE_GIB} GiB), {hymba_train['per_layer_gib']:.2f} "
              f"GiB a layer ({hymba_train['bytes_per_param_a_layer']:.2f} B a "
              f"parameter; before: 8.88 GiB, 196 B), launches exact every "
              f"round")
    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "deepseek-moe-16b", "--smoke", "--rounds", "3"], cwd=str(ROOT),
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0,
          f"launch/train.py exited {proc.returncode}: {proc.stderr[-2000:]}")
    print(f"  (e) launch/train.py --arch deepseek-moe-16b --smoke --rounds 3 "
          f"on the card: exit 0, {time.perf_counter() - t:.1f} s; "
          f"{(proc.stderr.strip().splitlines() or [''])[-1]}")
    return out


# Slice G (phase 12): the Program builders of launch/program.py on the card,
# at full width in bf16, each built on a 1 x 1 shape-only mesh (the port's
# LM is not tensor-parallel, nor is the JAX package's executed training), the
# batch one data rank's share of the production shape (global_batch / 16)
G_DATA_RANKS = 16
G_DECODE_TOKENS = 16
# (c) hymba-1.5b train_4k through the cohort builder: 6 of 32 layers (phase
# 10(d)'s depth), b cut from 16 to 1, DRYRUN_FL (M = 2); 1 warm-up round
G_COHORT_LAYERS, G_COHORT_ROUNDS, G_TRAIN_B = 6, 2, 1
# (d) qwen1.5-110b train_4k through the dist builder: 1 of 80 layers at full
# width (~3.85 B params, embed and head untied), buffer 2, so 2 steps apply
G_DIST_LAYERS, G_DIST_BUFFER = 1, 2
# (d) K5's backward at the dist run's shape: (B, S, H, Hkv, D, window, dtype)
G_BWD_CASE = (1, 4096, 64, 8, 128, 0, "bfloat16")
G_DRYRUN_ARCHS = ("hymba-1.5b", "qwen1.5-110b")


def g_share(name: str, batch: int = 0):
    """The production shape ``name`` at one data rank's share of its batch
    (or at ``batch``)."""
    from repro_torch.configs.base import INPUT_SHAPES, ShapeConfig

    s = INPUT_SHAPES[name]
    return ShapeConfig(s.name, s.seq_len, batch or s.global_batch
                       // G_DATA_RANKS, s.kind)


def g_flat(torch, tree, prefix=()):
    """{path: (shape, dtype)} of a tree of tensors (dicts, named tuples,
    tuples); a host int reads as () int32, as the Programs' specs do."""
    if isinstance(tree, dict):
        items = sorted(tree.items())
    elif isinstance(tree, tuple):
        items = (list(zip(tree._fields, tree)) if hasattr(tree, "_fields")
                 else list(enumerate(tree)))
    elif isinstance(tree, int):
        return {prefix: ((), torch.int32)}
    else:
        return {prefix: (tuple(tree.shape), tree.dtype)}
    out = {}
    for k, v in items:
        out.update(g_flat(torch, v, prefix + (k,)))
    return out


def g_check_args(torch, prog, args) -> None:
    """The real arguments have the Program's argument shapes and dtypes."""
    got, want = g_flat(torch, tuple(args)), g_flat(torch, prog.arg_sds)
    check(got == want, f"{prog.name}: arguments differ from arg_sds: "
          f"{[k for k in want if got.get(k) != want[k]][:5]}")


def g_batch(np, sds, vocab: int, rng):
    """Host arrays shaped like the Program's batch: int32 tokens in the
    vocabulary, f32 normals for the stub frontends."""
    if isinstance(sds, dict):
        return {k: g_batch(np, v, vocab, rng) for k, v in sds.items()}
    shape = tuple(sds.shape)
    if str(sds.dtype) == "torch.int32":
        return rng.integers(0, vocab, shape).astype(np.int32)
    return rng.normal(size=shape).astype(np.float32)


def slice_g_phase(torch, np, kernel_ops, fa_ref, get_arch, Model,
                  rate: float, card: str):
    """Phase 12: the Program builders' steps on the card."""
    import dataclasses as dc

    from repro_torch.core.cohort import init_cohort_state, init_dist_state
    from repro_torch.launch.mesh import ShapeMesh
    from repro_torch.launch.program import DRYRUN_FL, build_program

    ops, rc_ops, fa_ops, ss_ops, rn_ops = kernel_ops
    mesh = ShapeMesh((1, 1), ("data", "model"))

    def reset():
        for o in kernel_ops:
            o.reset_launches()

    def counts():
        return {"fused_server": ops.server_update.launches,
                "sq_dists": ops.sq_dists.launches,
                "weighted_sum": ops.weighted_sum.launches,
                "int8_sq_dists": rc_ops.int8_sq_dists.launches,
                "flash_attention": fa_ops.flash_attention.launches,
                "selective_scan": ss_ops.selective_scan.launches,
                "flash_attention_bwd": fa_ops.flash_attention_bwd.launches,
                "selective_scan_bwd": ss_ops.selective_scan_bwd.launches,
                "rms_norm": rn_ops.rms_norm.launches,
                "rms_norm_bwd": rn_ops.rms_norm_bwd.launches}

    def only(**want):
        return {k: want.get(k, 0) for k in counts()}

    out = {"launches": {}}
    gen = torch.Generator(device="cuda")

    # (a) prefill: hymba-1.5b prefill_32k at full width and depth
    t = time.perf_counter()
    cfg = get_arch("hymba-1.5b").model
    shape = g_share("prefill_32k")
    prog = build_program("hymba-1.5b", "prefill_32k", mesh, shape=shape,
                         device="cuda")
    model = Model(cfg, device="cuda")
    params = model.init(gen.manual_seed(0))
    batch = {"tokens": torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (shape.global_batch, shape.seq_len)).astype(
            np.int32)).cuda()}
    g_check_args(torch, prog, (params, batch))
    with torch.no_grad():
        prog.step_fn(params, batch)  # warm-up
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset()
        t1 = time.perf_counter()
        logits = prog.step_fn(params, batch)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t1
        got = counts()
        peak = torch.cuda.max_memory_allocated()
        direct = model.prefill_logits(params, batch)
    want = only(flash_attention=cfg.num_layers, selective_scan=cfg.num_layers,
                rms_norm=norm_launches(cfg)[0])
    check(got == want, f"(a) prefill launches {got}, want {want}")
    check(tuple(logits.shape) == (shape.global_batch, 1, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()), "(a) prefill logits")
    check(torch.equal(logits, direct),
          "(a) the Program's prefill differs from Model.prefill_logits")
    tokens = shape.global_batch * shape.seq_len
    out["launches"]["prefill"] = got
    out["prefill"] = dict(seconds=prefill_s, tokens_per_s=tokens / prefill_s,
                          peak_gib=peak / 2**30,
                          above_params_gib=(peak - base) / 2**30)
    print(f"  (a) prefill Program, hymba-1.5b prefill_32k, B={shape.global_batch}"
          f" S={shape.seq_len}, {cfg.num_layers} layers, bf16 ({card}): "
          f"{prefill_s:.4f} s "
          f"-> {tokens / prefill_s:,.0f} tokens/s (host clock, after a "
          f"warm-up); peak {peak / 2**30:.2f} GiB ({(peak - base) / 2**30:.2f}"
          f" GiB above the params and tokens); launches K5 "
          f"{got['flash_attention']}, K6 {got['selective_scan']}; logits "
          f"== Model.prefill_logits bit for bit; {time.perf_counter() - t:.1f}"
          " s")
    del logits, direct, batch

    # (b) decode: hymba-1.5b decode_32k at full depth, B 8, 16 tokens
    t = time.perf_counter()
    shape = g_share("decode_32k")
    prog = build_program("hymba-1.5b", "decode_32k", mesh, shape=shape,
                         device="cuda")
    check(prog.meta["cache_len"] == min(shape.seq_len, cfg.attn_window),
          f"(b) cache_len {prog.meta['cache_len']}")
    b = shape.global_batch
    cache = model.init_cache(b, shape.seq_len)
    check(cache["kv"]["k"].shape[2] == prog.meta["cache_len"],
          "(b) ring length")
    g_check_args(torch, prog, (params, cache, torch.zeros(
        (b, 1), dtype=torch.int32, device="cuda"),
        torch.zeros((), dtype=torch.int32)))
    direct_cache = model.init_cache(b, shape.seq_len)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (G_DECODE_TOKENS, b, 1)).astype(np.int32)).cuda()
    reset()
    got_logits = []
    with torch.no_grad():
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for i in range(G_DECODE_TOKENS):
            lg, cache = prog.step_fn(params, cache, toks[i], i)
            got_logits.append(lg)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t1
        got = counts()
        for i in range(G_DECODE_TOKENS):
            lg, direct_cache = model.decode_step(params, direct_cache,
                                                 toks[i], i)
            check(torch.equal(got_logits[i], lg),
                  f"(b) token {i}: the Program's decode differs from "
                  "Model.decode_step")
    check(all(bool(torch.isfinite(x).all()) for x in got_logits),
          "(b) decode logits not finite")
    check(all(got[k] == 0 for k in ("fused_server", "sq_dists",
                                    "weighted_sum", "int8_sq_dists",
                                    "flash_attention_bwd",
                                    "selective_scan_bwd", "rms_norm_bwd"))
          and got["rms_norm"] == norm_launches(
              cfg, forwards=G_DECODE_TOKENS)[0],
          f"(b) decode launches {got}")
    out["launches"]["decode"] = got
    out["decode"] = dict(seconds=decode_s,
                         tokens_per_s=b * G_DECODE_TOKENS / decode_s)
    print(f"  (b) decode Program, hymba-1.5b decode_32k, B={b}, cache of "
          f"{prog.meta['cache_len']} slots, {G_DECODE_TOKENS} tokens ({card})"
          f": {b * G_DECODE_TOKENS / decode_s:.2f} tokens/s "
          f"({decode_s:.4f} s, host clock); every token == Model.decode_step "
          f"bit for bit; {time.perf_counter() - t:.1f} s")
    del model, params, cache, direct_cache, got_logits, lg
    torch.cuda.empty_cache()

    # (c) cohort train: hymba-1.5b train_4k, 6 layers, cohort 1, b 1
    t = time.perf_counter()
    layers = G_COHORT_LAYERS
    cfg = get_arch("hymba-1.5b").model.replace(num_layers=layers)
    shape = g_share("train_4k", G_TRAIN_B)
    prog = build_program("hymba-1.5b", "train_4k", mesh, fl=DRYRUN_FL,
                         model_overrides={"num_layers": layers}, shape=shape,
                         device="cuda")
    check(prog.step_mesh is None and prog.meta["cohort"] == 1
          and prog.meta["local_batch"] == G_TRAIN_B
          and prog.meta["local_steps"] == DRYRUN_FL.local_steps,
          f"(c) Program meta {prog.meta}")
    params = Model(cfg, device="cuda").init(gen.manual_seed(1))
    state = init_cohort_state(params, 1)
    del params
    m = DRYRUN_FL.local_steps
    norms = norm_launches(cfg, grads=m)
    want = only(fused_server=1, flash_attention=(2 * m + 1) * layers,
                selective_scan=(2 * m + 1) * layers,
                flash_attention_bwd=m * layers,
                selective_scan_bwd=m * layers, rms_norm=norms[0],
                rms_norm_bwd=norms[1])
    rng = np.random.default_rng(2)
    times, losses = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for r in range(G_COHORT_ROUNDS + 1):
        batch = {"local": g_batch(np, prog.arg_sds[1]["local"],
                                  cfg.vocab_size, rng),
                 "probe": g_batch(np, prog.arg_sds[1]["probe"],
                                  cfg.vocab_size, rng),
                 "arrival": np.ones((1,), np.float32),
                 "data_sizes": np.full((1,), 1000.0, np.float32)}
        if r == 0:
            g_check_args(torch, prog, (state, {
                k: (torch.from_numpy(v) if not isinstance(v, dict) else
                    {kk: torch.from_numpy(vv) for kk, vv in v.items()})
                for k, v in batch.items()}))
        reset()
        t1 = time.perf_counter()
        state, mets = prog.step_fn(state, batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t1
        got = counts()
        check(got == want, f"(c) round {r}: launches {got}, want {want}")
        loss = float(mets["fresh_loss_mean"])
        check(math.isfinite(loss), f"(c) round {r} loss {loss}")
        check(int(state.version) == r + 1, f"(c) version after round {r}")
        losses.append(loss)
        if r:
            times.append(dt)
    peak = torch.cuda.max_memory_allocated()
    trained = m * G_TRAIN_B * shape.seq_len
    out["launches"]["cohort_train"] = want
    out["cohort_train"] = dict(round_s=times,
                               rounds_per_s=len(times) / sum(times),
                               tokens_per_s=trained * len(times) / sum(times),
                               peak_gib=peak / 2**30, losses=losses)
    print(f"  (c) cohort-train Program, hymba-1.5b train_4k, {layers} of 32 "
          f"layers, cohort 1, b={G_TRAIN_B}, S={shape.seq_len}, M={m}, fused "
          f"({card}): rounds {', '.join(f'{x:.4f}' for x in times)} s after "
          f"a warm-up of 1 -> {len(times) / sum(times):.4f} rounds/s, "
          f"{trained * len(times) / sum(times):,.0f} trained tokens/s; peak "
          f"{peak / 2**30:.2f} GiB; fresh loss {[round(x, 4) for x in losses]}"
          f"; launches a round {want}; {time.perf_counter() - t:.1f} s")
    del state, mets
    torch.cuda.empty_cache()

    # (d) K5's backward at qwen1.5-110b's training shape, then the dist step
    t = time.perf_counter()
    print("  (d) K5's backward at qwen1.5-110b's training shape:")
    out["attn_bwd"] = attn_bwd_phase(torch, fa_ops, fa_ref, rate,
                                     cases=(G_BWD_CASE,))[G_BWD_CASE]
    torch.cuda.empty_cache()
    layers = G_DIST_LAYERS
    cfg = get_arch("qwen1.5-110b").model.replace(num_layers=layers)
    shape = g_share("train_4k", G_TRAIN_B)
    fl = dc.replace(DRYRUN_FL, buffer_size=G_DIST_BUFFER)
    prog = build_program("qwen1.5-110b", "train_4k", mesh, fl=fl,
                         model_overrides={"num_layers": layers}, shape=shape,
                         device="cuda")
    check(prog.meta["fl_mode"] == "distributed"
          and prog.meta["local_batch"] == G_TRAIN_B, f"(d) meta {prog.meta}")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    model = Model(cfg, device="cuda")
    params = model.init(gen.manual_seed(3))
    n_params = model.param_count(params)
    rng = np.random.default_rng(3)
    batches = [{"local": g_batch(np, prog.arg_sds[1]["local"],
                                 cfg.vocab_size, rng),
                "probe": g_batch(np, prog.arg_sds[1]["probe"],
                                 cfg.vocab_size, rng),
                "tau": np.int32(tau), "data_size": np.float32(size)}
               for tau, size in ((0, 900.0), (1, 1300.0))]
    m = fl.local_steps
    norms = norm_launches(cfg, grads=m)
    want = only(flash_attention=(2 * m + 1) * layers,
                flash_attention_bwd=m * layers, rms_norm=norms[0],
                rms_norm_bwd=norms[1])

    def dist_run():
        state = init_dist_state(params, fl)
        times, mets_all = [], []
        for i, batch in enumerate(batches):
            reset()
            t1 = time.perf_counter()
            state, mets = prog.step_fn(state, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t1)
            got = counts()
            check(got == want, f"(d) step {i}: launches {got}, want {want}")
            check((mets["buffered"], mets["applied"]) == (i + 1, i),
                  f"(d) step {i}: buffered {mets['buffered']}, applied "
                  f"{mets['applied']}")
            check(math.isfinite(float(mets["fresh_loss"])),
                  f"(d) step {i} loss")
            mets_all.append({k: float(v) for k, v in mets.items()})
        check(state.version == 1 and state.count == 0,
              f"(d) version {state.version}, count {state.count}")
        return (state_digest(torch, (state.global_params,
                                     state.update_norm_ring)),
                mets_all, times)

    state0 = init_dist_state(params, fl)
    g_check_args(torch, prog, (state0._replace(count=G_DIST_BUFFER - 1), {
        k: (torch.from_numpy(np.asarray(v)) if not isinstance(v, dict) else
            {kk: torch.from_numpy(vv) for kk, vv in v.items()})
        for k, v in batches[0].items()}))
    del state0
    torch.cuda.reset_peak_memory_stats()
    first = dist_run()
    peak = torch.cuda.max_memory_allocated()
    check(peak - base <= TRAIN_PEAK_LIMIT,
          f"(d) dist-train peak {(peak - base) / 2**30:.2f} GiB")
    second = dist_run()
    check(first[0] == second[0] and first[1] == second[1],
          "(d) two runs from one state differ")
    times = first[2] + second[2]
    out["launches"]["dist_train"] = {k: 2 * v for k, v in want.items()}
    out["dist_train"] = dict(params=n_params, step_s=times,
                             contributions_per_s=len(times) / sum(times),
                             peak_gib=peak / 2**30,
                             above_base_gib=(peak - base) / 2**30,
                             metrics=first[1])
    print(f"  (d) dist-train Program, qwen1.5-110b train_4k at full width, "
          f"{layers} of 80 layers ({n_params:,d} params), b={G_TRAIN_B}, "
          f"S={shape.seq_len}, M={m}, buffer {G_DIST_BUFFER}, f32 "
          f"accumulator ({card}): steps "
          f"{', '.join(f'{x:.4f}' for x in times)} s -> "
          f"{len(times) / sum(times):.4f} contributions/s (the first step "
          f"of the first run pays cuBLAS set-up); peak {peak / 2**30:.2f} "
          f"GiB; applied 0 then 1, version 0 -> 1; two runs from one state "
          f"bit-identical; metrics {first[1]}; launches a step {want}; "
          f"{time.perf_counter() - t:.1f} s")
    del model, params
    torch.cuda.empty_cache()

    # (e) the dry run, one process an arch, both at once
    t = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        procs = {arch: subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--mesh", "single", "--out", tmp], cwd=str(ROOT),
            env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for arch in G_DRYRUN_ARCHS}
        logs = {}
        try:
            for arch, proc in procs.items():
                logs[arch] = proc.communicate(timeout=600)[0]
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        for arch, proc in procs.items():
            check(proc.returncode == 0, f"(e) dryrun --arch {arch} exited "
                  f"{proc.returncode}: {logs[arch][-2000:]}")
        recs = [json.loads(p.read_text()) for p in sorted(Path(tmp).glob(
            "*.json"))]
    check(len(recs) == 4 * len(G_DRYRUN_ARCHS)
          and all(r["ok"] and "error" not in r and not r.get("skipped")
                  for r in recs), "(e) dry-run records")
    out["dryrun"] = [{k: r[k] for k in ("arch", "shape", "trace_s", "flops",
                                         "memory")} for r in recs]
    print(f"  (e) dry run (meta tensors, {', '.join(G_DRYRUN_ARCHS)} x 4 "
          f"shapes, 16x16): every record ok; "
          + "; ".join(f"{r['arch']} {r['shape']} {r['trace_s']} s, "
                      f"{r['flops']:.3e} FLOP, "
                      f"{r['memory']['argument_size_in_bytes'] / 2**30:.3f} "
                      "GiB args a rank" for r in recs)
          + f"; {time.perf_counter() - t:.1f} s")
    return out


def main() -> int:
    started = time.perf_counter()
    # a full-width training round fills most of the card in blocks of a few
    # GiB; without expandable segments the cache fragments and a later
    # round's flat vector may find no free block (launch/train.py sets it
    # too)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
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
    from repro_torch.configs import PAPER_FL, get_arch, smoke_variant
    from repro_torch.configs.base import FLConfig
    from repro_torch.core import run_async, run_sync
    from repro_torch.core import version_store
    from repro_torch.core.server_pass import flatten_tree, make_flat_spec
    from repro_torch.kernels.flash_attn import kernel as fa_kernel
    from repro_torch.kernels.flash_attn import ops as fa_ops
    from repro_torch.kernels.flash_attn import ref as fa_ref
    from repro_torch.kernels.ring_codec import kernel as rc_kernel
    from repro_torch.kernels.ring_codec import ops as rc_ops
    from repro_torch.kernels.ring_codec import ref as rc_ref
    from repro_torch.kernels.rms_norm import kernel as rn_kernel
    from repro_torch.kernels.rms_norm import ops as rn_ops
    from repro_torch.kernels.rms_norm import ref as rn_ref
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
    from repro_torch.sim.population import collect_windows
    kernel_ops = (ops, rc_ops, fa_ops, ss_ops, rn_ops)

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
                 ss_kernel.LIBRARY, fa_kernel.BWD_LIBRARY,
                 ss_kernel.BWD_LIBRARY, rn_kernel.LIBRARY)
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
                      (ss_kernel.LIBRARY, "selective_scan_kernel"),
                      (fa_kernel.BWD_LIBRARY, "fa_bwd"),
                      (ss_kernel.BWD_LIBRARY, "ss_bwd"),
                      (rn_kernel.LIBRARY, "rms_")):
        for line in ptxas_lines(lib.ptxas_info, part):
            print(f"  {line}")
    optin = getattr(torch.cuda.get_device_properties(0),
                    "shared_memory_per_block_optin", None)
    for dtype in (torch.float32, torch.bfloat16):
        print(f"  K5 backward's dynamic shared memory a block (dQ, dK/dV), "
              f"{dtype}, of {optin if optin is None else format(optin, ',d')} "
              "B opt-in: " + ", ".join(
                  f"D={d} {a:,d} / {b:,d} B" for d in fa_ops.HEAD_DIMS
                  for a, b in [fa_kernel.bwd_smem_bytes(d, dtype)]))
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
        return lambda p: {
            "acc": float((apply_lenet(p, x).argmax(-1) == y).float().mean()),
            "wnorm": float(sum(torch.sum(v.double() ** 2)
                               for d in p.values() for v in d.values()))}

    def run(mode, device, codec="f32", total=rounds, engine="vectorized",
            block_n=0, **kw):
        clients, _ = dataset()  # fresh per run: batch streams are stateful
        fl = dataclasses.replace(PAPER_FL, server_pass_mode=mode,
                                 ring_codec=codec,
                                 server_pass_block_n=block_n)
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
    slice_c = slice_c_phase(torch, np, kernel_ops,
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
    slice_d = slice_d_phase(torch, np, kernel_ops,
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

    # 6d. Slice E: the sharded round substrate in worlds of ranks on the
    # card; the single-rank references at the ranks' flags (deterministic
    # cuDNN, so that ranks agree bit for bit)
    t = time.perf_counter()
    print(f"Slice E: worlds of ranks on one card (gloo), paper config, "
          f"{E_ROUNDS} rounds")
    torch.backends.cudnn.deterministic = True
    singles = (run("fused", "cuda")[0], run("batched", "cuda")[0],
               run("auto", "cuda", "int8")[0])
    # Slice E2's: the delta ring at the (1, 2) mesh's n_padded (twice the
    # default tile), and the windows at N = 1e6
    block = make_flat_spec(params_cuda).block_n
    e2_refs = {"delta": run("batched", "cuda", "delta", total=DELTA_ROUNDS,
                            block_n=2 * block)[0],
               "delta_block_n": 2 * block,
               "delta_n_padded": make_flat_spec(params_cuda,
                                                2 * block).n_padded,
               "windows_1e6": collect_windows(
                   sc, POP_BIG_N, PAPER_FL, E2_POP_WINDOWS, seed=0,
                   device="cuda", registry=MetricsRegistry()),
               "pop_1e6": slice_d["ref_1e6"],
               "pop_30": slice_d["ref_30_batched"]}
    torch.backends.cudnn.deterministic = False
    slice_e = slice_e_phase(torch, np, singles, card, e2_refs)
    print(f"  Slice E numbers ({card}): rounds/s "
          + ", ".join(f"{k} {v:.2f}" for k, v in slice_e["rates"].items()))
    print(f"  phase: {time.perf_counter() - t:.1f} s")

    # 7. K5 and K6 against their plain versions
    t = time.perf_counter()
    print("K5 / K6 phases (median of 10 kernel calls, CUDA events):")
    attn_records = flash_kernel_phase(torch, fa_ops, fa_ref, rate)
    scan_records = scan_kernel_phase(torch, ss_ops, ss_ref, rate)
    norm_records = norm_kernel_phase(torch, rn_kernel, rn_ops, rn_ref, rate)
    print(f"  phase: {time.perf_counter() - t:.1f} s")

    # 8. LM serving path, Hymba-1.5B at full width
    t = time.perf_counter()
    print("LM serving path: Hymba-1.5B")
    lm_counts, prefill_s, profile = lm_phase(torch, np, fa_ops, ss_ops,
                                             rn_ops, serve, get_arch, Model)
    k5 = attn_records[ATTN_CASES[0]]
    k6 = scan_records[SCAN_CASES[0]]
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

    # 8a. Jamba2-Mini's layered stack at its prefill cell's configuration
    t = time.perf_counter()
    print("Layered stack: Jamba2-Mini")
    jamba = jamba_phase(torch, fa_ops, ss_ops, rn_ops, get_arch)
    print(f"  phase: {time.perf_counter() - t:.1f} s")

    # 8b. Slice F2: the serving path of the other architectures
    t = time.perf_counter()
    print(f"Slice F2 ({card}): deepseek-moe-16b, arctic-480b, whisper-tiny, "
          f"pixtral-12b, stablelm-12b, gemma-7b, qwen1.5-110b")
    f2 = slice_f2_phase(torch, np, kernel_ops, fa_ref,
                        serve, get_arch, Model, rate, card)
    ds = f2["deepseek"]
    print(f"  Slice F2 numbers ({card}): deepseek-moe-16b prefill "
          f"{F2_B * F2_S / min(ds['prefill_s']):,.0f} tokens/s at best, peak "
          f"{ds['peak'] / 2**30:.2f} GiB, init peak "
          f"{ds['init_peak'] / 2**30:.2f} GiB, dropped "
          f"{sum(ds['drop_shares']) / len(ds['drop_shares']):.4f} of "
          f"token-choices; decode tokens/s "
          + ", ".join(f"{k} {v:.2f}" for k, v in f2["serve"].items()))
    print(f"  phase: {time.perf_counter() - t:.1f} s")

    # 10. Slice F3: LM training on the card
    t = time.perf_counter()
    print(f"Slice F3 ({card}): K5 and K6 backward, Model.loss gradients, "
          f"Hymba-1.5B training")
    f3 = slice_f3_phase(torch, np, kernel_ops, fa_ref,
                        ss_ref, get_arch, Model, rate, card)
    tr = f3["train"]
    print(f"  Slice F3 numbers ({card}): Hymba-1.5B at full width, "
          f"{tr['layers']} layers: {tr['rounds_per_s']:.4f} rounds/s, "
          f"{tr['tokens_per_s']:,.0f} trained tokens/s, peak "
          f"{tr['peak_gib']:.2f} GiB")
    print(f"  phase: {time.perf_counter() - t:.1f} s")

    # 11. Slice F4: training of the MoE, encoder-decoder, patch and
    # D 160 / 256 archs
    t = time.perf_counter()
    print(f"Slice F4 ({card}): K5's backward at D 160 / 256, gradients and "
          f"training of deepseek-moe-16b, whisper-tiny, pixtral-12b, "
          f"stablelm-12b, gemma-7b")
    f4 = slice_f4_phase(torch, np, kernel_ops, fa_ref,
                        get_arch, smoke_variant, Model, rate, card, tr)
    print(f"  Slice F4 numbers ({card}): "
          + "; ".join(f"{r['label']} {r['layers']} layers C={r['cohort']}: "
                      f"{r['rounds_per_s']:.4f} rounds/s, "
                      f"{r['tokens_per_s']:,.0f} tokens/s, peak "
                      f"{r['peak_gib']:.2f} GiB, "
                      f"{r['bytes_per_param']:.2f} B/param"
                      for k, r in f4["train"].items() if "probe" not in k))
    print(f"  phase: {time.perf_counter() - t:.1f} s")

    # 12. Slice G: the Program builders' steps on the card
    t = time.perf_counter()
    print(f"Slice G ({card}): the Program builders at full width, bf16, on a "
          f"1 x 1 mesh: prefill, decode, cohort train, dist train; the dry "
          f"run")
    g = slice_g_phase(torch, np, kernel_ops, fa_ref,
                      get_arch, Model, rate, card)
    print(f"  Slice G numbers ({card}): prefill "
          f"{g['prefill']['tokens_per_s']:,.0f} tokens/s, peak "
          f"{g['prefill']['peak_gib']:.2f} GiB; decode "
          f"{g['decode']['tokens_per_s']:.2f} tokens/s; cohort train "
          f"{g['cohort_train']['rounds_per_s']:.4f} rounds/s; dist train "
          f"{g['dist_train']['contributions_per_s']:.4f} contributions/s, peak "
          f"{g['dist_train']['peak_gib']:.2f} GiB; K5 backward at the qwen "
          f"shape {g['attn_bwd']['ms']:.4f} ms (SDPA "
          f"{g['attn_bwd']['library_ms']:.4f} ms, bound "
          f"{g['attn_bwd']['bound_ms']:.4f} ms)")
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
            "population_launches": slice_d["launches"][name_k],
            "slice_e_launches_per_rank": {
                key: counts.get(name_k, 0)
                for key, counts in slice_e["launches"].items()},
            "slice_f2_launches": ds["counts"][name_k],
            "slice_f3_launches": tr["counts"][name_k],
            "slice_f4_launches": {k: rr["counts"][name_k]
                                  for k, rr in f4["train"].items()},
            "slice_g_launches": {k: c[name_k]
                                 for k, c in g["launches"].items()}})
        if name_k in jamba["counts"]:
            kernels[-1]["jamba_prefill_launches"] = jamba["counts"][name_k]
        if name_k == "flash_attention":
            kernels[-1]["f2_shapes"] = [
                dict(r, prefill_launches=(ds["counts"][name_k]
                                          if r["arch"] == "deepseek-moe-16b"
                                          else f2["prefill"].get(
                                              r["arch"], {}).get("launches")))
                for r in f2["attn"].values()]
    bwd_main = {"flash_attention_bwd": f3["attn"][ATTN_BWD_CASES[0]],
                "selective_scan_bwd": f3["scan"][SCAN_BWD_CASES[0]]}
    for name_k, r in bwd_main.items():
        kernels.append({
            "name": name_k, "route": "cuda", "source": BWD_SOURCES[name_k],
            "replaces": BWD_REPLACES[name_k],
            "launches": tr["counts"][name_k],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "burst_ms": r["burst_ms"], "shape": r["shape"],
            "bound_share": r["bound_ms"] / r["ms"],
            "launches_per_round": tr["per_round"][name_k],
            "other_shapes": [dict(rr, key=list(k)) for k, rr in (
                f3["attn"] if name_k == "flash_attention_bwd"
                else f3["scan"]).items() if rr is not r]})
        kernels[-1]["slice_g_launches"] = {k: c[name_k]
                                           for k, c in g["launches"].items()}
        if name_k == "selective_scan_bwd":
            kernels[-1].update({k: r[k] for k in (
                "ptxas", "resident_blocks_per_sm", "grid_blocks", "waves")})
        if name_k == "flash_attention_bwd":
            kernels[-1]["f4_shapes"] = [dict(rr, key=list(k)) for k, rr in
                                        f4["attn"].items()]
            kernels[-1]["g_shape"] = g["attn_bwd"]
            kernels[-1]["slice_f4_launches"] = {
                k: rr["counts"][name_k] for k, rr in f4["train"].items()}
    kernels.append({
        "name": "rms_norm", "route": "cuda",
        "source": "src/repro_torch/csrc/rms_norm.cu", "replaces": None,
        "records": norm_records,
        "prefill_launches": lm_counts["rms_norm"],
        "jamba_prefill_launches": jamba["counts"]["rms_norm"],
        "slice_f3_launches": {k: tr["counts"][k]
                              for k in ("rms_norm", "rms_norm_bwd")},
        "slice_g_launches": {k: {n: c[n] for n in ("rms_norm", "rms_norm_bwd")
                                 if n in c}
                             for k, c in g["launches"].items()}})
    print(f"chip_smoke: {time.perf_counter() - started:.1f} s in all")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
