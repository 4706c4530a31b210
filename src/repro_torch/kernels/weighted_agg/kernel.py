"""Build, load and launch the CUDA kernels of ``csrc/weighted_agg.cu``.

The source is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, at first use, and loaded with ``ctypes``. The
build lands in ``build/repro_torch/`` at the root of the checkout (listed in
``.gitignore``), named by a hash of the source and flags, so a changed
source rebuilds and concurrent first uses (``pytest -n 6``) never see a
half-written library: each builds to a private temp name, then renames it
into place atomically.

Nothing here runs at import time: the CPU tests import this module on
machines without ``nvcc`` or a card. Every function that launches takes
CUDA tensors that the ``ops`` wrappers have already checked, launches on
PyTorch's current stream, and raises if the launch was refused.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Tuple

import torch

_PKG = Path(__file__).resolve().parents[2]  # src/repro_torch
SOURCE = _PKG / "csrc" / "weighted_agg.cu"
BUILD_DIR = _PKG.parents[1] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

# policy name -> the Policy enum of weighted_agg.cu
POLICY_CODES = {"paper": 0, "multiplicative": 1, "fedbuff": 2,
                "fedasync_constant": 2, "fedasync_hinge": 3, "polynomial": 4,
                "fedasync": 4, "fedasync_poly": 4}

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(f"nvcc not found on PATH or under {cuda_home}; the "
                           "weighted_agg CUDA kernels cannot be built")
    return str(path)


def library_path() -> Path:
    """Where the built library for the current source and flags lives."""
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libweighted_agg_{digest}.so"


def build() -> Path:
    """Compile the library if it is not built yet; return its path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=out.stem + ".", suffix=".tmp",
                               dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) on {SOURCE}:\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i64, i32, f32 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                        ctypes.c_float)
    sigs = {
        "wa_dist_tiles": (i64, [i64]),
        "wa_error_string": (ctypes.c_char_p, [i32]),
        "wa_sq_dist_partials": (i32, [p, p, p, i64, i64, p]),
        "wa_reduce_partials": (i32, [p, p, i64, i64, p]),
        "wa_fused_weights": (i32, [p, p, p, p, p, p, p, i32, i64, i32, i32,
                                   f32, f32, f32, f32, f32, f32, p]),
        "wa_weighted_sum": (i32, [p, p, p, i64, i64, p]),
    }
    for name, (restype, argtypes) in sigs.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def load_library() -> ctypes.CDLL:
    """Build (once per process) and load the kernel library."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _bind(ctypes.CDLL(str(build())))
        return _lib


def _check(lib: ctypes.CDLL, code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what} launch failed: "
                           f"{lib.wa_error_string(code).decode()} ({code})")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _dist_partials(lib, x: torch.Tensor, bases: torch.Tensor) -> torch.Tensor:
    k, n = bases.shape
    partials = torch.empty((k, lib.wa_dist_tiles(n)), dtype=torch.float32,
                           device=bases.device)
    _check(lib, lib.wa_sq_dist_partials(x.data_ptr(), bases.data_ptr(),
                                        partials.data_ptr(), k, n,
                                        _stream(bases)), "sq_dist_partials")
    return partials


def sq_dists(x: torch.Tensor, bases: torch.Tensor) -> torch.Tensor:
    """K2: (K,) ||x - b_k||^2. Two launches: tile partials, fixed-order sum."""
    lib = load_library()
    with torch.cuda.device(bases.device):
        partials = _dist_partials(lib, x, bases)
        out = torch.empty((bases.shape[0],), dtype=torch.float32,
                          device=bases.device)
        _check(lib, lib.wa_reduce_partials(partials.data_ptr(), out.data_ptr(),
                                           partials.shape[0], partials.shape[1],
                                           _stream(bases)), "reduce_partials")
    return out


def _weighted_sum_into(lib, deltas: torch.Tensor, w: torch.Tensor,
                       out: torch.Tensor) -> None:
    k, n = deltas.shape
    _check(lib, lib.wa_weighted_sum(deltas.data_ptr(), w.data_ptr(),
                                    out.data_ptr(), k, n, _stream(deltas)),
           "weighted_sum")


def weighted_sum(deltas: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """K3: (N,) sum_k w_k * deltas[k], summed over k in order."""
    lib = load_library()
    with torch.cuda.device(deltas.device):
        out = torch.empty((deltas.shape[1],), dtype=torch.float32,
                          device=deltas.device)
        _weighted_sum_into(lib, deltas, w, out)
    return out


def fused_server(x: torch.Tensor, bases: torch.Tensor, deltas: torch.Tensor,
                 p_stat: torch.Tensor, taus: torch.Tensor, mask: torch.Tensor,
                 *, policy: str, eta_g: float, s_min: float, poly_a: float,
                 hinge_a: float, hinge_b: float, normalize: str,
                 eps: float = 1e-12
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1: eq. 3 + weighting + eq. 5 in one call, three launches, no sync.

    Returns ``(upd (N,), sq_dists (K,), weights (K,))`` with ``upd`` carrying
    eq. 5's ``eta_g / k_eff`` scale.
    """
    lib = load_library()
    k, n = bases.shape
    dev = bases.device
    with torch.cuda.device(dev):
        partials = _dist_partials(lib, x, bases)
        vec = torch.empty((3, k), dtype=torch.float32, device=dev)
        dists, w, w_scaled = vec[0], vec[1], vec[2]
        _check(lib, lib.wa_fused_weights(
            partials.data_ptr(), p_stat.data_ptr(), taus.data_ptr(),
            mask.data_ptr(), dists.data_ptr(), w.data_ptr(),
            w_scaled.data_ptr(), k, partials.shape[1], POLICY_CODES[policy],
            int(normalize == "mean"), eta_g, s_min, poly_a, hinge_a, hinge_b,
            eps, _stream(bases)), "fused_weights")
        upd = torch.empty((n,), dtype=torch.float32, device=dev)
        _weighted_sum_into(lib, deltas, w_scaled, upd)
    return upd, dists, w
