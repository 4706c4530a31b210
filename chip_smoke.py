#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) end to end on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

1. Device line: the card's name and power limit from ``nvidia-smi``; TF32
   is switched off for cuDNN convolutions and for matmuls.
2. Build: compile ``src/repro_torch/csrc/weighted_agg.cu`` for sm_90a.
3. Kernel phases: K1 (fused server pass), K2 (squared distances) and K3
   (weighted sum) against their plain PyTorch versions on the card, at the
   LeNet width (K=10, N=44,426), the engine's padded LeNet row (K=10,
   N=49,152), a ragged N (K=32, N=130,007) and a memory-bound N (K=16,
   N=16,777,219). K1 runs all 8 policies x normalize {mean, none} x with
   and without an arrival mask. Each phase checks that two launches give
   bit-identical distances and times kernel, plain version and library
   yardstick with CUDA events (median of 30 calls after 5 warm-up calls)
   beside the bytes bound.
4. Main path: ``repro_torch.core.run_async(engine="vectorized")`` at the
   paper's config (LeNet, 30 clients x 1500 samples, K=10, M=4, B=32,
   scenario paper-fig1, seed 0) for 10 rounds on the card in fused,
   batched and reference modes, with launch counts read around each run;
   the three agree, and the fused run agrees with the same run on the CPU.
5. FedAvg rows: ``run_sync`` for 3 rounds on the card.

The last two lines of standard output are the kernels' JSON record and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
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

# HBM bandwidth by card name (NVIDIA data sheets); f32 CUDA-core peak
HBM_BYTES_PER_S = (("H200", 4.8e12), ("H100 NVL", 3.9e12),
                   ("H100 PCIe", 2.0e12), ("H100", 3.35e12))
F32_FLOPS = 67e12

SOURCE = "src/repro_torch/csrc/weighted_agg.cu"
TPU_KERNELS = {
    "fused_server": "src/repro/kernels/weighted_agg/kernel.py:131",
    "sq_dists": "src/repro/kernels/weighted_agg/kernel.py:208",
    "weighted_sum": "src/repro/kernels/weighted_agg/kernel.py:41",
}
POLICIES = ("paper", "multiplicative", "fedbuff", "polynomial", "fedasync",
            "fedasync_constant", "fedasync_hinge", "fedasync_poly")
SHAPES = ((10, 44_426), (10, 49_152), (32, 130_007), (16, 16_777_219))
MAIN_SHAPE = (10, 49_152)  # what the main path gives the kernels


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
    import numpy as np

    from repro_torch.configs import PAPER_FL
    from repro_torch.configs.base import FLConfig
    from repro_torch.core import run_async, run_sync
    from repro_torch.kernels.weighted_agg import kernel, ops, ref
    from repro_torch.models import apply_lenet, init_lenet, lenet_loss
    from repro_torch.sim import get_scenario

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

    # 2. build
    t0 = time.perf_counter()
    kernel.load_library()
    print(f"build: {time.perf_counter() - t0:.1f} s ({kernel.library_path()})")

    # 3. kernel phases
    print("kernel phases (median of 30 calls, CUDA events):")
    records = kernel_phases(torch, ops, ref, rate)

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

    def run(mode, device):
        clients, _ = dataset()  # fresh per run: batch streams are stateful
        fl = dataclasses.replace(PAPER_FL, server_pass_mode=mode)
        ops.reset_launches()
        t = time.perf_counter()
        res = run_async(lenet_loss, init, clients, fl, rounds,
                        eval_fn=eval_fn_for(device), eval_every=5, seed=0,
                        scenario=sc, engine="vectorized", device=device)
        if device == "cuda":
            torch.cuda.synchronize()
        dt = time.perf_counter() - t
        counts = {"fused_server": ops.server_update.launches,
                  "sq_dists": ops.sq_dists.launches,
                  "weighted_sum": ops.weighted_sum.launches}
        print(f"  run_async {mode:9s} on {device}: {rounds / dt:.2f} rounds/s "
              f"({dt:.2f} s incl. evals), acc "
              f"{[round(h['acc'], 4) for h in res.history]}, launches {counts}")
        check(res.server_rounds == rounds and len(res.round_log) == rounds,
              f"{mode}: {res.server_rounds} rounds")
        return res, counts

    print("main path: paper-fig1, 30 clients x 1500, K=10, M=4, B=32, "
          f"{rounds} rounds")
    warm, _ = run("fused", "cuda")  # first run pays one-time CUDA/cuDNN set-up
    fused, fused_counts = run("fused", "cuda")
    check(fused_counts == {"fused_server": rounds, "sq_dists": 0,
                           "weighted_sum": 0}, f"fused launches {fused_counts}")
    batched, batched_counts = run("batched", "cuda")
    check(batched_counts == {"fused_server": 0, "sq_dists": rounds,
                             "weighted_sum": rounds},
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

    # 6. records
    launches = {"fused_server": fused_counts["fused_server"],
                "sq_dists": batched_counts["sq_dists"],
                "weighted_sum": batched_counts["weighted_sum"]}
    kernels = []
    for name_k in ("fused_server", "sq_dists", "weighted_sum"):
        r = records[(name_k,) + MAIN_SHAPE]
        kernels.append({
            "name": name_k, "route": "cuda", "source": SOURCE,
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
