"""Load and launch the CUDA kernels of ``csrc/weighted_agg.cu``.

The source is built at first use into a plain-C shared library and loaded
with ``ctypes`` (``kernels/cuda_build.py``); ``-Xptxas -v`` keeps each
kernel's registers, shared memory and spills in ``LIBRARY.ptxas_info``.
Nothing here runs at import time: the CPU tests import this module on
machines without ``nvcc`` or a card. Every function that launches takes CUDA tensors that the ``ops``
wrappers have already checked, launches on PyTorch's current stream, and
raises if the launch was refused.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels.cuda_build import CudaLibrary
from repro_torch.kernels.cuda_build import stream as _stream

# policy name -> the Policy enum of weighted_agg.cu
POLICY_CODES = {"paper": 0, "multiplicative": 1, "fedbuff": 2,
                "fedasync_constant": 2, "fedasync_hinge": 3, "polynomial": 4,
                "fedasync": 4, "fedasync_poly": 4}

_p, _i64, _i32, _f32 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                        ctypes.c_float)
LIBRARY = CudaLibrary("weighted_agg", {
    "wa_dist_tiles": (_i64, [_i64]),
    "wa_error_string": (ctypes.c_char_p, [_i32]),
    "wa_sq_dist_partials": (_i32, [_p, _p, _p, _i64, _i64, _p]),
    "wa_reduce_partials": (_i32, [_p, _p, _i64, _i64, _p]),
    "wa_fused_weights": (_i32, [_p, _p, _p, _p, _p, _p, _p, _i32, _i64, _i32,
                                _i32, _f32, _f32, _f32, _f32, _f32, _f32, _p]),
    "wa_weighted_sum": (_i32, [_p, _p, _p, _i64, _i64, _p]),
}, error_fn="wa_error_string", extra_flags=("-Xptxas", "-v"))


def _dist_partials(lib, x: torch.Tensor, bases: torch.Tensor) -> torch.Tensor:
    k, n = bases.shape
    partials = torch.empty((k, lib.wa_dist_tiles(n)), dtype=torch.float32,
                           device=bases.device)
    LIBRARY.check(lib, lib.wa_sq_dist_partials(
        x.data_ptr(), bases.data_ptr(), partials.data_ptr(), k, n,
        _stream(bases)), "sq_dist_partials")
    return partials


def sq_dists(x: torch.Tensor, bases: torch.Tensor) -> torch.Tensor:
    """K2: (K,) ||x - b_k||^2. Two launches: tile partials, fixed-order sum."""
    lib = LIBRARY.load()
    with torch.cuda.device(bases.device):
        partials = _dist_partials(lib, x, bases)
        out = torch.empty((bases.shape[0],), dtype=torch.float32,
                          device=bases.device)
        LIBRARY.check(lib, lib.wa_reduce_partials(
            partials.data_ptr(), out.data_ptr(), partials.shape[0],
            partials.shape[1], _stream(bases)), "reduce_partials")
    return out


def _weighted_sum_into(lib, deltas: torch.Tensor, w: torch.Tensor,
                       out: torch.Tensor) -> None:
    k, n = deltas.shape
    LIBRARY.check(lib, lib.wa_weighted_sum(
        deltas.data_ptr(), w.data_ptr(), out.data_ptr(), k, n,
        _stream(deltas)), "weighted_sum")


def weighted_sum(deltas: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """K3: (N,) sum_k w_k * deltas[k], summed over k in order."""
    lib = LIBRARY.load()
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
    lib = LIBRARY.load()
    k, n = bases.shape
    dev = bases.device
    with torch.cuda.device(dev):
        partials = _dist_partials(lib, x, bases)
        vec = torch.empty((3, k), dtype=torch.float32, device=dev)
        dists, w, w_scaled = vec[0], vec[1], vec[2]
        LIBRARY.check(lib, lib.wa_fused_weights(
            partials.data_ptr(), p_stat.data_ptr(), taus.data_ptr(),
            mask.data_ptr(), dists.data_ptr(), w.data_ptr(),
            w_scaled.data_ptr(), k, partials.shape[1], POLICY_CODES[policy],
            int(normalize == "mean"), eta_g, s_min, poly_a, hinge_a, hinge_b,
            eps, _stream(bases)), "fused_weights")
        upd = torch.empty((n,), dtype=torch.float32, device=dev)
        _weighted_sum_into(lib, deltas, w_scaled, upd)
    return upd, dists, w
