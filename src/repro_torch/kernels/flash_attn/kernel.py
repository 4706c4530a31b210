"""Load and launch the K5 kernel of ``csrc/flash_attn.cu`` and its backward
of ``csrc/flash_attn_bwd.cu``.

The source is built at first use into a plain-C shared library and loaded
with ``ctypes`` (``kernels/cuda_build.py``); ``-Xptxas -v`` keeps each
instance's registers, shared memory and spills in ``LIBRARY.ptxas_info``.
Nothing here runs at import time. The launch functions take CUDA tensors
that ``ops`` has already checked, launch on PyTorch's current stream, and
raise if a launch was refused. bf16 inputs run the tensor-core instances
(the forward's ``flash_fwd_sm90``, the backward's ``fa_bwd_dq_sm90`` and
``fa_bwd_dkdv_sm90``), f32 inputs the CUDA-core ones: the dtype alone picks
them. The forward writes each row's log-sum-exp (f32, (B, H, S)) beside
its output; the backward reads it, and its D = rowsum(dO * O) scratch, an
f32 (B, H, S), is allocated here.
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
    "fa_forward": (_i32, [_p, _p, _p, _p, _p, _i64, _i64, _i64, _i64, _i64,
                          _i32, _i32, _i64, _f32, _p]),
}, error_fn="fa_error_string", extra_flags=("-Xptxas", "-v"))
BWD_LIBRARY = CudaLibrary("flash_attn_bwd", {
    "fab_error_string": (ctypes.c_char_p, [_i32]),
    "fa_backward": (_i32, [_p, _p, _p, _p, _p, _p, _p, _p, _p, _p, _i64, _i64,
                           _i64, _i64, _i64, _i32, _i32, _i64, _f32, _p]),
    "fa_bwd_smem_bytes": (_i64, [_i64, _i32, _i32]),
}, error_fn="fab_error_string", extra_flags=("-Xptxas", "-v"))

DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def bwd_smem_bytes(d: int, dtype: torch.dtype):
    """(dQ kernel, dK/dV kernel) dynamic shared memory a block of the
    backward's ``dtype`` instance at head dim ``d``, as the built library
    states it."""
    lib = BWD_LIBRARY.load()
    return (lib.fa_bwd_smem_bytes(d, DTYPES[dtype], 0),
            lib.fa_bwd_smem_bytes(d, DTYPES[dtype], 1))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool, window: int):
    """K5: one launch; (B, S, H, D) out in q's dtype and the rows' lse,
    f32 (B, H, S)."""
    lib = LIBRARY.load()
    b, s, h, d = q.shape
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("the bf16 kernel reads q, k, v with TMA: each must "
                         "start on a 16-byte boundary")
    with torch.cuda.device(q.device):
        out = torch.empty_like(q)
        lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
        LIBRARY.check(lib, lib.fa_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, s, h, k.shape[2], d, DTYPES[q.dtype],
            int(causal), window, d ** -0.5, _stream(q)), "flash_attention")
    return out, lse


def flash_attention_bwd(q, k, v, o, do, lse, causal: bool, window: int):
    """K5's backward: one call (two kernels; three at bf16 D 160 / 256);
    dq, dk, dv in q's dtype. ``lse`` is the forward's."""
    lib = BWD_LIBRARY.load()
    b, s, h, d = q.shape
    if any(t.data_ptr() % 16 for t in (q, k, v, o, do)):
        raise ValueError("the backward reads rows as 16-byte vectors: q, k, v, "
                         "o, do must start on a 16-byte boundary")
    with torch.cuda.device(q.device):
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), \
            torch.empty_like(v)
        delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
        BWD_LIBRARY.check(lib, lib.fa_backward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), delta.data_ptr(), b, s, h, k.shape[2], d,
            DTYPES[q.dtype], int(causal), window, d ** -0.5, _stream(q)),
            "flash_attention_bwd")
    return dq, dk, dv
