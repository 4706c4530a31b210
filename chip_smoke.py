#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) end to end on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

1. Device line: the card's name and power limit from ``nvidia-smi``; TF32
   is switched off for cuDNN convolutions and for matmuls.
2. Build: compile ``src/repro_torch/csrc/weighted_agg.cu`` and
   ``src/repro_torch/csrc/ring_codec.cu`` for sm_90a, both nvcc runs at once.
3. Kernel phases: K1 (fused server pass), K2 (squared distances) and K3
   (weighted sum) against their plain PyTorch versions on the card, at the
   LeNet width (K=10, N=44,426), the engine's padded LeNet row (K=10,
   N=49,152), a ragged N (K=32, N=130,007) and a memory-bound N (K=16,
   N=16,777,219). K1 runs all 8 policies x normalize {mean, none} x with
   and without an arrival mask. Each phase checks that two launches give
   bit-identical distances and times kernel, plain version and library
   yardstick with CUDA events (median of 30 calls after 5 warm-up calls)
   beside the bytes bound.
   K4 (int8 dequantize-distance) against its plain version at the engine's
   int8 ring (K=10, N=49,152, qblock 256), a ragged N (K=32, N=130,048,
   qblock 128), a single ragged tile (K=4, N=640, qblock 64) and a
   memory-bound N (K=16, N=16,777,216, qblock 256), with scale-0 blocks;
   bit-identical across launches; timed beside its bytes bound and, for
   reference, K2's time on f32 rows of the same (K, N).
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

# HBM bandwidth by card name (NVIDIA data sheets); f32 CUDA-core peak
HBM_BYTES_PER_S = (("H200", 4.8e12), ("H100 NVL", 3.9e12),
                   ("H100 PCIe", 2.0e12), ("H100", 3.35e12))
F32_FLOPS = 67e12

SOURCES = {"fused_server": "src/repro_torch/csrc/weighted_agg.cu",
           "sq_dists": "src/repro_torch/csrc/weighted_agg.cu",
           "weighted_sum": "src/repro_torch/csrc/weighted_agg.cu",
           "int8_sq_dists": "src/repro_torch/csrc/ring_codec.cu"}
TPU_KERNELS = {
    "fused_server": "src/repro/kernels/weighted_agg/kernel.py:131",
    "sq_dists": "src/repro/kernels/weighted_agg/kernel.py:208",
    "weighted_sum": "src/repro/kernels/weighted_agg/kernel.py:41",
    "int8_sq_dists": "src/repro/kernels/ring_codec/kernel.py:51",
}
POLICIES = ("paper", "multiplicative", "fedbuff", "polynomial", "fedasync",
            "fedasync_constant", "fedasync_hinge", "fedasync_poly")
SHAPES = ((10, 44_426), (10, 49_152), (32, 130_007), (16, 16_777_219))
MAIN_SHAPE = (10, 49_152)  # what the main path gives the kernels
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
        rows = {
            "fused_server": dict(
                ms=time_ms(torch, lambda: ops.server_update(
                    x, bases, deltas, p, taus, None, **cfg)),
                plain_ms=time_ms(torch, lambda: ref.server_update_ref(
                    x, bases, deltas, p, taus, None, **cfg)),
                library_ms=None, bytes=(2 * k + 2) * row_bytes,
                ops=5 * k * n, max_abs_err=err1),
            "sq_dists": dict(
                ms=time_ms(torch, lambda: ops.sq_dists(x, bases)),
                plain_ms=time_ms(torch, lambda: ref.sq_dists_ref(x, bases)),
                library_ms=time_ms(torch, lambda: ((bases - x) ** 2).sum(1)),
                bytes=(k + 1) * row_bytes, ops=3 * k * n, max_abs_err=err2),
            "weighted_sum": dict(
                ms=time_ms(torch, lambda: ops.weighted_sum(deltas, w)),
                plain_ms=time_ms(torch, lambda: ref.weighted_sum_ref(deltas, w)),
                library_ms=time_ms(torch, lambda: torch.matmul(w, deltas)),
                bytes=(k + 1) * row_bytes, ops=2 * k * n, max_abs_err=err3),
        }
        for name, r in rows.items():
            bytes_ms = r["bytes"] / rate * 1e3
            ops_ms = r["ops"] / F32_FLOPS * 1e3
            r["bound_ms"] = max(bytes_ms, ops_ms)
            r["bound_by"] = "bytes" if bytes_ms >= ops_ms else "operations"
            lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
            print(f"  {name:13s} K={k:3d} N={n:>10,d}: kernel {r['ms']:.4f} ms"
                  f"  plain {r['plain_ms']:.4f} ms  library {lib} ms"
                  f"  bound {r['bound_ms']:.4f} ms ({r['bound_by']})"
                  f"  max_abs_err {r['max_abs_err']:.3g}")
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
            bound_by="bytes" if bytes_ms >= ops_ms else "operations")
        bases = torch.randn(k, n, device="cuda", generator=g)
        k2_ms = time_ms(torch, lambda: ops.sq_dists(x, bases))
        print(f"  int8_sq_dists K={k:3d} N={n:>10,d} qblock={qblock:3d}: "
              f"kernel {r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms  "
              f"library n/a  bound {r['bound_ms']:.4f} ms ({r['bound_by']}, "
              f"{nbytes:,d} B)  max_abs_err {err:.3g}; "
              f"K2 on f32 rows {k2_ms:.4f} ms")
        records[(k, n)] = r
        del codes, scales, zeros, x, bases
        torch.cuda.empty_cache()
    return records


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
    from repro_torch.configs import PAPER_FL
    from repro_torch.configs.base import FLConfig
    from repro_torch.core import run_async, run_sync
    from repro_torch.core import version_store
    from repro_torch.core.server_pass import flatten_tree
    from repro_torch.kernels.ring_codec import kernel as rc_kernel
    from repro_torch.kernels.ring_codec import ops as rc_ops
    from repro_torch.kernels.ring_codec import ref as rc_ref
    from repro_torch.kernels.weighted_agg import kernel, ops, ref
    from repro_torch.models import apply_lenet, init_lenet, lenet_loss
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

    # 2. build: one nvcc per source, started together
    t0 = time.perf_counter()
    libraries = (kernel.LIBRARY, rc_kernel.LIBRARY)
    with ThreadPoolExecutor(len(libraries)) as pool:
        built = list(pool.map(lambda lib: lib.build(), libraries))
    for lib in libraries:
        lib.load()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"({', '.join(str(p) for p in built)})")

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

    # 7. records
    launches = {"fused_server": fused_counts["fused_server"],
                "sq_dists": batched_counts["sq_dists"],
                "weighted_sum": batched_counts["weighted_sum"],
                "int8_sq_dists": int8_counts["int8_sq_dists"]}
    records[("int8_sq_dists",) + MAIN_SHAPE] = int8_records[MAIN_SHAPE]
    kernels = []
    for name_k in ("fused_server", "sq_dists", "weighted_sum",
                   "int8_sq_dists"):
        r = records[(name_k,) + MAIN_SHAPE]
        kernels.append({
            "name": name_k, "route": "cuda", "source": SOURCES[name_k],
            "replaces": TPU_KERNELS[name_k], "launches": launches[name_k],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
