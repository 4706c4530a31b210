"""K2 (eq. 3 distances) against the two-launch K2 it replaced, on one card.

The two-launch K2 (a partials kernel, then a row-sum kernel: the C entry
points ``wa_sq_dist_partials`` and ``wa_reduce_partials``) is the one in
``src/repro_torch/csrc/weighted_agg.cu`` of commit 119fb8f and earlier.
Unpack that directory into a place ``.gitignore`` lists and name it:

    git archive 119fb8f src/repro_torch/csrc | tar -x -C build/base
    python -m repro_torch.launch.k2_compare \\
        --base-csrc build/base/src/repro_torch/csrc

At the main path's shape (K=10, N=49,152), a ragged one (32, 130,007) and a
memory-bound one (16, 16,777,219) it checks that both forms give K1's bits,
then times each in the order base, new, new, base:

- ``profiled``: ``torch.profiler``'s device time per call over back-to-back
  calls, and the device operations per call;
- ``graph``: per call of back-to-back calls captured in one CUDA graph and
  replayed, median of several replays: the gaps between launches count, the
  host's dispatch does not;
- ``call``: the median of 30 single calls through each form's wrapper, one
  CUDA event pair each: the host's dispatch counts.

Each launch in the graph gets buffers made before the capture; the new
form's ticket counters there are this script's own, used by the one stream
that replays the graph. Prints the card's name and power limit first and
one JSON object of every reading last.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import statistics
import subprocess
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.kernels import cuda_build
from repro_torch.kernels.cuda_build import stream as _stream
from repro_torch.kernels.weighted_agg import kernel, ops
from repro_torch.utils.device import resolve_device

SHAPES = ((10, 49_152), (32, 130_007), (16, 16_777_219))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
ORDER = ("base", "new", "new", "base")


def _base_library(csrc: Path) -> ctypes.CDLL:
    """Build the base checkout's ``weighted_agg.cu`` and bind its K2."""
    source = csrc / "weighted_agg.cu"
    digest = hashlib.sha256(source.read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        digest.update(header.read_bytes())
    out = cuda_build.BUILD_DIR / f"libk2_base_{digest.hexdigest()[:16]}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run([cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, "-I",
                        str(csrc), "-o", str(out), str(source)], check=True)
    lib = ctypes.CDLL(str(out))
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.wa_dist_tiles.restype, lib.wa_dist_tiles.argtypes = i64, [i64]
    lib.wa_sq_dist_partials.restype = ctypes.c_int
    lib.wa_sq_dist_partials.argtypes = [p, p, p, i64, i64, p]
    lib.wa_reduce_partials.restype = ctypes.c_int
    lib.wa_reduce_partials.argtypes = [p, p, i64, i64, p]
    return lib


def _base_launch(lib, x, bases, partials, out) -> None:
    k, n = bases.shape
    s = _stream(bases)
    for rc in (lib.wa_sq_dist_partials(x.data_ptr(), bases.data_ptr(),
                                       partials.data_ptr(), k, n, s),
               lib.wa_reduce_partials(partials.data_ptr(), out.data_ptr(), k,
                                      partials.shape[1], s)):
        if rc:
            raise RuntimeError(f"base K2 launch failed: cudaError {rc}")


def _base_call(lib, x, bases):
    """The base form as its own wrapper ran it: fresh partials and output."""
    k, n = bases.shape
    partials = torch.empty((k, lib.wa_dist_tiles(n)), device=bases.device)
    out = torch.empty((k,), device=bases.device)
    _base_launch(lib, x, bases, partials, out)
    return out


def _new_launch(lib, x, bases, partials, tickets, out) -> None:
    k, n = bases.shape
    group = kernel._dist_group(k, partials.shape[1], bases.device)
    kernel.LIBRARY.check(lib, lib.wa_sq_dists(
        x.data_ptr(), bases.data_ptr(), partials.data_ptr(),
        tickets.data_ptr(), out.data_ptr(), k, n, group, _stream(bases)),
        "sq_dists")


def profiled_ms(fn, calls: int):
    """Device ms per call of ``calls`` back-to-back calls, and the device
    operations per call, from one ``torch.profiler`` capture."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = [(e.count, getattr(e, "self_device_time_total", None)
             or getattr(e, "self_cuda_time_total", 0.0))
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    rows = [r for r in rows if r[1] > 0]
    return (sum(us for _, us in rows) / 1e3 / calls,
            sum(c for c, _ in rows) / calls)


def graph_ms(launch, calls: int, reps: int) -> float:
    """Median ms per call of ``calls`` launches captured in one CUDA graph."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            launch()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(calls):
            launch()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def call_ms(fn, reps: int = 30, warmup: int = 5) -> float:
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


def compare(base_csrc: Path) -> dict:
    base_lib = _base_library(base_csrc)
    new_lib = kernel.LIBRARY.load()
    readings = []
    for k, n in SHAPES:
        g = torch.Generator(device="cuda").manual_seed(k + n)
        x = torch.randn(n, device="cuda", generator=g)
        bases = x[None] + 0.05 * torch.randn(k, n, device="cuda", generator=g)
        p = torch.ones(k, device="cuda")
        _, want, _ = ops.server_update(x, bases, 0 * bases, p, 0 * p)
        tiles = new_lib.wa_dist_tiles(n)
        partials = torch.empty((k, tiles), device="cuda")
        out = torch.empty((k,), device="cuda")
        tickets = torch.zeros((k,), dtype=torch.int32, device="cuda")
        forms = {
            "base": (lambda: _base_call(base_lib, x, bases),
                     lambda: _base_launch(base_lib, x, bases, partials, out)),
            "new": (lambda: kernel.sq_dists(x, bases),
                    lambda: _new_launch(new_lib, x, bases, partials, tickets,
                                        out)),
        }
        for name, (call, launch) in forms.items():
            if not torch.equal(call(), want):
                raise RuntimeError(f"{name} K2 bits differ from K1's at "
                                   f"{(k, n)}")
            launch()
            if not torch.equal(out, want):
                raise RuntimeError(f"{name} K2 launch bits differ at {(k, n)}")
        big = k * n >= 10**8
        bound = (k + 1) * n * 4 / HBM_BYTES_PER_S * 1e3
        for i, name in enumerate(ORDER):
            call, launch = forms[name]
            dev_ms, ops_per_call = profiled_ms(call, 5 if big else 20)
            r = {"form": name, "pass": i, "k": k, "n": n,
                 "profiled_ms": dev_ms, "ops_per_call": ops_per_call,
                 "graph_ms": graph_ms(launch, 10 if big else 100,
                                      3 if big else 10),
                 "call_ms": call_ms(call), "bound_ms": bound}
            readings.append(r)
            print(f"{name:4s} K={k:2d} N={n:>10,d}: profiled "
                  f"{r['profiled_ms']:.5f} ms ({ops_per_call:g} ops), graph "
                  f"{r['graph_ms']:.5f} ms, call {r['call_ms']:.5f} ms; "
                  f"bound {bound:.5f} ms", flush=True)
        if not torch.equal(out, want):
            raise RuntimeError(f"graph replays changed the bits at {(k, n)}")
        del x, bases, partials
        torch.cuda.empty_cache()
    return {"readings": readings}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base-csrc", type=Path, required=True,
                    help="csrc/ of a checkout with the two-launch K2")
    a = ap.parse_args(argv)
    resolve_device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    result = compare(a.base_csrc)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
