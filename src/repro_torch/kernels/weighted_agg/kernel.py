"""Load and launch the CUDA kernels of ``csrc/weighted_agg.cu``.

The source is built at first use into a plain-C shared library and loaded
with ``ctypes`` (``kernels/cuda_build.py``); ``-Xptxas -v`` keeps each
kernel's registers, shared memory and spills in ``LIBRARY.ptxas_info``.
Nothing here runs at import time: the CPU tests import this module on
machines without ``nvcc`` or a card. Every function that launches takes
CUDA tensors that the ``ops`` wrappers have already checked, launches on
PyTorch's current stream, and raises if the launch was refused: K1's
cooperative launch, too, has no other form to fall back to. K2 keeps its
arrival tickets in a small zeroed buffer per (device, stream).
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import Dict, Optional, Tuple

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
    "wa_sq_dists": (_i32, [_p, _p, _p, _p, _p, _i64, _i64, _i32, _p]),
    "wa_weighted_sum": (_i32, [_p, _p, _p, _i64, _i64, _p]),
    "wa_fused_server": (_i32, [_p, _p, _p, _p, _p, _p, _p, _p, _p, _p, _i64,
                               _i64, _i32, _i32, _f32, _f32, _f32, _f32, _f32,
                               _f32, _p]),
    "wa_fused_resident": (_i32, [_i64, _i32]),
}, error_fn="wa_error_string", extra_flags=("-Xptxas", "-v"))


# K2's arrival tickets: one uint32 per row group, a buffer per (device,
# stream), zeroed once when it is made; every call leaves them zero again,
# so a call is one device operation. Two streams never share a buffer.
_TICKETS: Dict[Tuple[int, int], torch.Tensor] = {}
_TICKETS_LOCK = threading.Lock()


def _tickets(device: torch.device, stream: int, groups: int) -> torch.Tensor:
    key = (device.index, stream)
    with _TICKETS_LOCK:
        buf = _TICKETS.get(key)
        if buf is None or buf.numel() < groups:
            buf = torch.zeros((max(groups, 64),), dtype=torch.int32, device=device)
            _TICKETS[key] = buf
    return buf


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _dist_group(k: int, tiles: int, device: torch.device) -> int:
    """Rows per K2 task: 4 (x read once per 4 rows) where the (tile, group)
    tasks of 4 still give every SM a block, else 1, so that every SM
    carries loads (PERF.md §6, PR 17)."""
    return 4 if tiles * -(-k // 4) >= _sm_count(device) else 1


def _partials(lib, k: int, n: int, device: torch.device) -> torch.Tensor:
    return torch.empty((k, lib.wa_dist_tiles(n)), dtype=torch.float32,
                       device=device)


def sq_dists(x: torch.Tensor, bases: torch.Tensor) -> torch.Tensor:
    """K2: (K,) ||x - b_k||^2 in one launch: tasks of ``_dist_group``'s
    rows, each row summed by the block that draws its group's last arrival
    ticket.

    The tickets are right only if they are zero when a call starts, which
    every completed call leaves them. So a call is refused while the stream
    is being captured into a CUDA graph: a replay on another stream would
    draw from the capture stream's counters. A launch that faults part-way
    leaves the CUDA context unusable, and with it these counters.
    """
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError("sq_dists: K2's arrival tickets are per stream; "
                           "it cannot be captured in a CUDA graph")
    lib = LIBRARY.load()
    k, n = bases.shape
    dev = bases.device
    with torch.cuda.device(dev):
        partials = _partials(lib, k, n, dev)
        group = _dist_group(k, partials.shape[1], dev)
        s = _stream(bases)
        tickets = _tickets(dev, s, -(-k // group))
        out = torch.empty((k,), dtype=torch.float32, device=dev)
        LIBRARY.check(lib, lib.wa_sq_dists(
            x.data_ptr(), bases.data_ptr(), partials.data_ptr(),
            tickets.data_ptr(), out.data_ptr(), k, n, group, s), "sq_dists")
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
                 p_stat: torch.Tensor, taus: torch.Tensor,
                 mask: Optional[torch.Tensor], *, policy: str, eta_g: float,
                 s_min: float, poly_a: float, hinge_a: float, hinge_b: float,
                 normalize: str, eps: float = 1e-12
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1: eq. 3 + weighting + eq. 5 in one cooperative launch, no sync.

    ``mask=None`` means every slot arrived. Returns ``(upd (N,), sq_dists
    (K,), weights (K,))`` with ``upd`` carrying eq. 5's ``eta_g / k_eff``
    scale.
    """
    lib = LIBRARY.load()
    k, n = bases.shape
    dev = bases.device
    with torch.cuda.device(dev):
        partials = _partials(lib, k, n, dev)
        vec = torch.empty((2, k), dtype=torch.float32, device=dev)
        dists, w = vec[0], vec[1]
        upd = torch.empty((n,), dtype=torch.float32, device=dev)
        LIBRARY.check(lib, lib.wa_fused_server(
            x.data_ptr(), bases.data_ptr(), deltas.data_ptr(),
            p_stat.data_ptr(), taus.data_ptr(),
            None if mask is None else mask.data_ptr(), partials.data_ptr(),
            dists.data_ptr(), w.data_ptr(), upd.data_ptr(), k, n,
            POLICY_CODES[policy], int(normalize == "mean"), eta_g, s_min,
            poly_a, hinge_a, hinge_b, eps, _stream(bases)), "fused_server")
    return upd, dists, w


def fused_resident_blocks(k: int, vec: bool) -> int:
    """The most blocks K1's cooperative grid takes at K rows (occupancy x
    SMs of its float4 or scalar instance) on the current device."""
    lib = LIBRARY.load()
    blocks = lib.wa_fused_resident(k, int(vec))
    LIBRARY.check(lib, 0 if blocks > 0 else -blocks, "fused_resident")
    return blocks
