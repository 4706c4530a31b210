"""Load and launch the RMSNorm kernels of ``csrc/rms_norm.cu``.

The source is built at first use into a plain-C shared library and loaded
with ``ctypes`` (``kernels/cuda_build.py``); ``-Xptxas -v`` keeps each
instance's registers, shared memory and spills in ``LIBRARY.ptxas_info``.
Nothing here runs at import time. The launch functions take CUDA tensors
that ``ops`` has already checked, launch on PyTorch's current stream, and
raise if a launch was refused. x is read as (rows, d) rows at one stride
(``row_stride``), with no copy where its leading dims allow that; ``w`` is
(d,) or (G, d) f32 at any row stride (a layer's slice of stacked params, a
weight expanded over the calls): row r reads ``w[r // (rows // G)]``. The wrappers make
no tensor views: the card's host runs each Python tensor call in a few
microseconds, and a training round makes ~450 of these calls.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels.cuda_build import CudaLibrary

_p, _i64, _i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
LIBRARY = CudaLibrary("rms_norm", {
    "rn_error_string": (ctypes.c_char_p, [_i32]),
    "rn_forward": (_i32, [_p, _i64, _p, _i64, _i64, _p, _p, _i64, _i64, _i32,
                          ctypes.c_float, _p]),
    "rn_backward_workspace": (_i64, [_i64, _i64, _i64]),
    "rn_backward": (_i32, [_p, _i64, _p, _i64, _i64, _p, _p, _i64, _p, _p, _p,
                           _i64, _i64, _i64, _i32, _p]),
}, error_fn="rn_error_string", extra_flags=("-Xptxas", "-v"))


def row_stride(t: torch.Tensor) -> Optional[int]:
    """The stride between consecutive rows of ``t.reshape(-1, d)`` where its
    leading dims collapse into one stride and its last dim is contiguous
    (a view would do: no copy), else None."""
    d = t.shape[-1]
    if d > 1 and t.stride(-1) != 1:
        return None
    ld = expect = None
    for size, stride in zip(reversed(t.shape[:-1]), reversed(t.stride()[:-1])):
        if size == 1:
            continue
        if expect is not None and stride != expect:
            return None
        ld = stride if ld is None else ld
        expect = stride * size
    if ld is None:  # one row
        return d
    return ld if ld >= d else None


def _weight(w: torch.Tensor):
    """(w, or a contiguous copy where its last dim is strided; the stride
    between its rows, 0 for one row or an expanded one)."""
    if w.shape[-1] > 1 and w.stride(-1) != 1:
        w = w.contiguous()
    return w, (w.stride(0) if w.dim() == 2 else 0)


def _rows(t: torch.Tensor):
    """(t, or a contiguous copy where its rows lie at no single stride; the
    row stride)."""
    ld = row_stride(t)
    if ld is None:
        t = t.contiguous()
        ld = t.shape[-1]
    return t, ld


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float):
    """The forward: one launch; (y in x's shape and dtype, rstd f32 of
    shape ``x.shape[:-1]``)."""
    lib = LIBRARY.load()
    x, ldx = _rows(x)
    w, ldw = _weight(w)
    d = x.shape[-1]
    rows = x.numel() // d
    dev = x.get_device()
    with torch.cuda.device(dev):
        y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
        rstd = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
        LIBRARY.check(lib, lib.rn_forward(
            x.data_ptr(), ldx, w.data_ptr(), ldw, rows // groups(w), y.data_ptr(),
            rstd.data_ptr(), rows, d, int(x.dtype == torch.bfloat16), eps,
            torch.cuda.current_stream(dev).cuda_stream), "rms_norm")
    return y, rstd


def rms_norm_bwd(x, w, rstd, dy, dw_groups: int):
    """The backward: two launches (dx and the tiles' dw partials, then their
    sums); dx in x's shape and dtype, dw (dw_groups, d) f32."""
    lib = LIBRARY.load()
    x, ldx = _rows(x)
    dy, lddy = _rows(dy)
    w, ldw = _weight(w)
    rstd = rstd.contiguous()
    d = x.shape[-1]
    rows = x.numel() // d
    dev = x.get_device()
    with torch.cuda.device(dev):
        dx = torch.empty(x.shape, dtype=x.dtype, device=x.device)
        dw = torch.empty((dw_groups, d), dtype=torch.float32, device=x.device)
        floats = lib.rn_backward_workspace(rows, d, rows // dw_groups)
        LIBRARY.check(lib, 0 if floats >= 0 else -floats, "rms_norm_bwd")
        stream = torch.cuda.current_stream(dev).cuda_stream
        work = _workspace(floats, dev, stream)
        LIBRARY.check(lib, lib.rn_backward(
            x.data_ptr(), ldx, w.data_ptr(), ldw, rows // groups(w),
            rstd.data_ptr(), dy.data_ptr(), lddy, dx.data_ptr(), dw.data_ptr(),
            work.data_ptr(), rows, d, rows // dw_groups,
            int(x.dtype == torch.bfloat16), stream), "rms_norm_bwd")
    return dx, dw


# The backward's dw partials: one f32 buffer per (device, stream), grown to
# the largest call's need and reused, since the calls on a stream run in
# order: no allocation a call (130 calls a Hymba training round).
_WORKSPACES = {}


def _workspace(floats: int, dev: int, stream: int) -> torch.Tensor:
    buf = _WORKSPACES.get((dev, stream))
    if buf is None or buf.numel() < floats:
        buf = torch.empty((max(floats, 1),), dtype=torch.float32,
                          device=torch.device("cuda", dev))
        _WORKSPACES[(dev, stream)] = buf
    return buf


def groups(w: torch.Tensor) -> int:
    """Weight rows: G of a (G, d) weight, 1 of a shared (d,) one."""
    return w.shape[0] if w.dim() == 2 else 1
