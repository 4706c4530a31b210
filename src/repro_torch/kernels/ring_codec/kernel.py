"""Load and launch the K4 kernel of ``csrc/ring_codec.cu``.

The source is built at first use into a plain-C shared library and loaded
with ``ctypes`` (``kernels/cuda_build.py``); ``-Xptxas -v`` keeps the
kernel's registers, shared memory and spills in ``LIBRARY.ptxas_info``.
Nothing here runs at import time. The launch function takes CUDA tensors
that ``ops.int8_sq_dists`` has already checked, launches on PyTorch's
current stream, and raises if the cooperative launch was refused.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.cuda_build import CudaLibrary
from repro_torch.kernels.cuda_build import stream as _stream

_p, _i64, _i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
LIBRARY = CudaLibrary("ring_codec", {
    "rc_dist_tiles": (_i64, [_i64]),
    "rc_error_string": (ctypes.c_char_p, [_i32]),
    "rc_int8_sq_dists": (_i32, [_p, _p, _p, _p, _p, _p, _i64, _i64, _i64, _p]),
    "rc_int8_resident": (_i32, [_i32]),
}, error_fn="rc_error_string", extra_flags=("-Xptxas", "-v"))


def int8_sq_dists(x: torch.Tensor, codes: torch.Tensor, scales: torch.Tensor,
                  zeros: torch.Tensor, qblock: int) -> torch.Tensor:
    """K4: (K,) ||x - dequant(codes_k)||^2. One cooperative launch: tile
    partials against all K rows, a grid barrier, a fixed-order sum of each
    row of partials."""
    lib = LIBRARY.load()
    k, n = codes.shape
    dev = codes.device
    with torch.cuda.device(dev):
        partials = torch.empty((k, lib.rc_dist_tiles(n)), dtype=torch.float32,
                               device=dev)
        out = torch.empty((k,), dtype=torch.float32, device=dev)
        LIBRARY.check(lib, lib.rc_int8_sq_dists(
            x.data_ptr(), codes.data_ptr(), scales.data_ptr(),
            zeros.data_ptr(), partials.data_ptr(), out.data_ptr(), k, n,
            qblock, _stream(codes)), "int8_sq_dists")
    return out


def resident_blocks(vec: bool) -> int:
    """The most blocks K4's cooperative grid takes (occupancy x SMs of its
    16-byte or element-load instance) on the current device."""
    lib = LIBRARY.load()
    blocks = lib.rc_int8_resident(int(vec))
    LIBRARY.check(lib, 0 if blocks > 0 else -blocks, "int8_resident")
    return blocks
