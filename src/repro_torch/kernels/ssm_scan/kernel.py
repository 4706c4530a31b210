"""Load and launch the K6 kernel of ``csrc/ssm_scan.cu`` and its backward of
``csrc/ssm_scan_bwd.cu``.

The source is built at first use into a plain-C shared library and loaded
with ``ctypes`` (``kernels/cuda_build.py``); ``-Xptxas -v`` keeps each
instance's registers, shared memory and spills in ``LIBRARY.ptxas_info``.
Nothing here runs at import time. The launch functions take CUDA tensors
that ``ops`` has already checked, launch on PyTorch's current stream, and
raise if a launch was refused. ``a`` is one (di, N) matrix shared by every
batch row, or (G, di, N) with G dividing B: row r reads ``a[r // (B // G)]``
(``a_rows`` rows a matrix).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.cuda_build import CudaLibrary
from repro_torch.kernels.cuda_build import stream as _stream

_p, _i64, _i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
LIBRARY = CudaLibrary("ssm_scan", {
    "ss_error_string": (ctypes.c_char_p, [_i32]),
    "ss_forward": (_i32, [_p, _p, _p, _p, _p, _p, _i64, _i64, _i64, _i64, _i64,
                          _p]),
}, error_fn="ss_error_string", extra_flags=("-Xptxas", "-v"))
BWD_LIBRARY = CudaLibrary("ssm_scan_bwd", {
    "ssb_error_string": (ctypes.c_char_p, [_i32]),
    "ss_backward_workspace": (_i64, [_i64, _i64, _i64, _i64]),
    "ss_backward": (_i32, [_p] * 12 + [_i64] * 5 + [_p]),
    "ss_backward_resident_blocks": (_i32, [_i64]),
}, error_fn="ssb_error_string", extra_flags=("-Xptxas", "-v"))


def a_rows(x: torch.Tensor, a: torch.Tensor) -> int:
    """Batch rows that read one matrix of ``a``."""
    return x.shape[0] if a.dim() == 2 else x.shape[0] // a.shape[0]


def selective_scan(x: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
                   c: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """K6: one launch; y (B, S, di) f32."""
    lib = LIBRARY.load()
    bsz, s, di = x.shape
    with torch.cuda.device(x.device):
        y = torch.empty_like(x)
        LIBRARY.check(lib, lib.ss_forward(
            x.data_ptr(), dt.data_ptr(), b.data_ptr(), c.data_ptr(),
            a.data_ptr(), y.data_ptr(), bsz, s, di, a.shape[-1], a_rows(x, a),
            _stream(x)), "selective_scan")
    return y


def backward_resident_blocks(n: int) -> int:
    """Blocks of the backward's walk kernel at N = ``n`` that one SM holds
    at once on the current device (registers and shared memory)."""
    lib = BWD_LIBRARY.load()
    blocks = lib.ss_backward_resident_blocks(n)
    BWD_LIBRARY.check(lib, 0 if blocks > 0 else -blocks,
                      "selective_scan_bwd resident")
    return blocks


def selective_scan_bwd(x, dt, b, c, a, dy):
    """K6's backward: one call (two kernels); dx, ddt, db, dc f32 and da
    shaped like ``a``."""
    lib = BWD_LIBRARY.load()
    bsz, s, di = x.shape
    n = a.shape[-1]
    with torch.cuda.device(x.device):
        dx, ddt = torch.empty_like(x), torch.empty_like(x)
        db, dc, da = torch.empty_like(b), torch.empty_like(c), \
            torch.empty_like(a)
        work = torch.empty((lib.ss_backward_workspace(bsz, s, di, n),),
                           dtype=torch.float32, device=x.device)
        BWD_LIBRARY.check(lib, lib.ss_backward(
            x.data_ptr(), dt.data_ptr(), b.data_ptr(), c.data_ptr(),
            a.data_ptr(), dy.data_ptr(), dx.data_ptr(), ddt.data_ptr(),
            db.data_ptr(), dc.data_ptr(), da.data_ptr(), work.data_ptr(), bsz,
            s, di, n, a_rows(x, a), _stream(x)), "selective_scan_bwd")
    return dx, ddt, db, dc, da
