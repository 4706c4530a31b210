"""Load and launch the K5 kernel of ``csrc/flash_attn.cu``.

The source is built at first use into a plain-C shared library and loaded
with ``ctypes`` (``kernels/cuda_build.py``); ``-Xptxas -v`` keeps each
instance's registers, shared memory and spills in ``LIBRARY.ptxas_info``.
Nothing here runs at import time. The launch function takes CUDA tensors
that ``ops.flash_attention`` has already checked, launches on PyTorch's
current stream, and raises if a launch was refused. bf16 inputs run the
tensor-core instance, f32 inputs the CUDA-core one: the dtype alone picks
it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.cuda_build import CudaLibrary
from repro_torch.kernels.cuda_build import stream as _stream

_p, _i64, _i32, _f32 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                        ctypes.c_float)
LIBRARY = CudaLibrary("flash_attn", {
    "fa_error_string": (ctypes.c_char_p, [_i32]),
    "fa_forward": (_i32, [_p, _p, _p, _p, _i64, _i64, _i64, _i64, _i64, _i32,
                          _i32, _i64, _f32, _p]),
}, error_fn="fa_error_string", extra_flags=("-Xptxas", "-v"))

DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool, window: int) -> torch.Tensor:
    """K5: one launch; (B, S, H, D) out in q's dtype."""
    lib = LIBRARY.load()
    b, s, h, d = q.shape
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("the bf16 kernel reads q, k, v with TMA: each must "
                         "start on a 16-byte boundary")
    with torch.cuda.device(q.device):
        out = torch.empty_like(q)
        LIBRARY.check(lib, lib.fa_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, h,
            k.shape[2], d, DTYPES[q.dtype], int(causal), window, d ** -0.5,
            _stream(q)), "flash_attention")
    return out
