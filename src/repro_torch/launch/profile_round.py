"""Where the time of the paper's async rounds goes on the card.

Runs ``run_async(engine="vectorized")`` at the paper's config (LeNet, 30
clients x 1500 samples, K=10, M=4, B=32, scenario paper-fig1, seed 0):
first 3 rounds untimed (one-time CUDA/cuDNN set-up), then
``--rounds`` rounds timed on the host clock, then the same rounds again
under ``torch.profiler``. Prints rounds/s, the device-busy share of the
profiled wall time (sum of device-side kernel and copy time over wall
time; one stream, so nothing overlaps), and the device time by kernel.

    python -m repro_torch.launch.profile_round [--rounds 5] [--mode fused]
        [--ring-codec f32|int8|delta]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import PAPER_FL
from repro_torch.core import run_async
from repro_torch.models import init_lenet, lenet_loss
from repro_torch.sim import get_scenario
from repro_torch.utils.device import resolve_device

WARMUP_ROUNDS = 3  # untimed: one-time CUDA/cuDNN set-up
TOP = 12  # kernels listed
# kernels of csrc/weighted_agg.cu and csrc/ring_codec.cu, by the names the
# profiler reports
OWN_KERNELS = ("fused_server_kernel", "sq_dist_kernel", "weighted_sum_kernel",
               "int8_sq_dist_kernel")


def _run(fl, rounds, init, sc, device):
    clients, _ = sc.make_dataset(fl.num_clients, samples_per_client=1500,
                                 seed=0, noise=1.2)
    t = time.perf_counter()
    res = run_async(lenet_loss, init, clients, fl, rounds, seed=0,
                    scenario=sc, device=device)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--mode", default="fused",
                    choices=["fused", "batched", "reference"])
    ap.add_argument("--ring-codec", default="f32",
                    choices=["f32", "int8", "delta"])
    a = ap.parse_args(argv)
    dev = resolve_device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    fl = dataclasses.replace(PAPER_FL, server_pass_mode=a.mode,
                             ring_codec=a.ring_codec)
    sc = get_scenario("paper-fig1")
    init = init_lenet(torch.Generator().manual_seed(0))

    _run(fl, WARMUP_ROUNDS, init, sc, dev)
    _, wall = _run(fl, a.rounds, init, sc, dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall_prof = _run(fl, a.rounds, init, sc, dev)
    # device-side events only (kernels, copies): a CPU op's own
    # self_device_time_total repeats the time of the kernels it launched
    rows = [(e.key, e.count, e.self_device_time_total / 1e3)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[2])
    device_ms = sum(r[2] for r in rows)
    own_ms = sum(r[2] for r in rows if any(k in r[0] for k in OWN_KERNELS))
    out = {
        "device": torch.cuda.get_device_name(0), "mode": a.mode,
        "ring_codec": a.ring_codec,
        "rounds": a.rounds, "rounds_per_s": a.rounds / wall,
        "round_ms": wall / a.rounds * 1e3,
        "profiled_round_ms": wall_prof / a.rounds * 1e3,
        "device_ms_per_round": device_ms / a.rounds,
        "device_busy_share": device_ms / (wall_prof * 1e3),
        "server_kernels_ms_per_round": own_ms / a.rounds,
        "top": [{"name": k[:90], "calls": c, "ms_per_round": ms / a.rounds}
                for k, c, ms in rows[:TOP]],
    }
    print(f"{out['device']}  mode={a.mode} ring_codec={a.ring_codec}: "
          f"{out['rounds_per_s']:.2f} rounds/s"
          f" ({out['round_ms']:.2f} ms/round; {out['profiled_round_ms']:.2f}"
          f" under the profiler)")
    print(f"device busy {out['device_ms_per_round']:.3f} ms/round = "
          f"{out['device_busy_share']:.1%} of the profiled wall time; "
          f"server-pass kernels {out['server_kernels_ms_per_round']:.4f} "
          f"ms/round")
    for r in out["top"]:
        print(f"  {r['ms_per_round']:9.4f} ms/round  {r['calls']:6d} calls  "
              f"{r['name']}")
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
