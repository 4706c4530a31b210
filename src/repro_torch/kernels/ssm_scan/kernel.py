"""Load and launch the K6 kernel of ``csrc/ssm_scan.cu``.

The source is built at first use into a plain-C shared library and loaded
with ``ctypes`` (``kernels/cuda_build.py``); ``-Xptxas -v`` keeps each
instance's registers, shared memory and spills in ``LIBRARY.ptxas_info``.
Nothing here runs at import time. The launch function takes CUDA tensors
that ``ops.selective_scan`` has already checked, launches on PyTorch's
current stream, and raises if a launch was refused.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.cuda_build import CudaLibrary
from repro_torch.kernels.cuda_build import stream as _stream

_p, _i64, _i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
LIBRARY = CudaLibrary("ssm_scan", {
    "ss_error_string": (ctypes.c_char_p, [_i32]),
    "ss_forward": (_i32, [_p, _p, _p, _p, _p, _p, _i64, _i64, _i64, _i64, _p]),
}, error_fn="ss_error_string", extra_flags=("-Xptxas", "-v"))


def selective_scan(x: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
                   c: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """K6: one launch; y (B, S, di) f32."""
    lib = LIBRARY.load()
    bsz, s, di = x.shape
    with torch.cuda.device(x.device):
        y = torch.empty_like(x)
        LIBRARY.check(lib, lib.ss_forward(
            x.data_ptr(), dt.data_ptr(), b.data_ptr(), c.data_ptr(),
            a.data_ptr(), y.data_ptr(), bsz, s, di, a.shape[1], _stream(x)),
            "selective_scan")
    return y
