"""Operations and bytes a launch of K1, K5 (forward and backward) and K6
(forward and backward) needs (PERF.md §6, table of the TPU kernels and the
lines under it):

* K1 ``fused_server_kernel``: eq. 3 distances of x against every base row,
  the weights, and eq. 5 over the arrived rows' deltas: reads x and the
  rows it is given once (f32), writes the update once.
* K5 forward ``flash_fwd_sm90``: 4 D operations a visible (query, key)
  pair and head; reads q, k, v, writes o.
* K5 backward ``fa_bwd_dq_sm90`` + ``fa_bwd_dkdv_sm90``: 10 D operations a
  visible pair and head; reads q, k, v, o, dO, writes dq, dk, dv.
* K6 forward ``selective_scan_kernel``: reads x, dt (B S di f32), B, C
  (B S N f32) and A, writes y (B S di f32); its operations are far below
  the bytes.
* K6 backward ``ss_bwd_kernel``: reads x, dt, dy, writes dx, ddt (5 B S di
  f32), reads B, C, writes dB, dC (4 B S N f32), reads A, writes dA.
"""
from __future__ import annotations

from typing import Tuple


def visible_pairs(s: int, window: int) -> int:
    """(query, key) pairs with key <= query and query - key < window."""
    if not window or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def k1(n: int, rows: int, arrived: int) -> Tuple[float, float]:
    """n f32 parameters, ``rows`` base rows read for eq. 3, ``arrived``
    delta rows read for eq. 5."""
    return 0.0, 4.0 * n * (rows + arrived + 2)


def k5_fwd(b: int, s: int, h: int, hkv: int, d: int, window: int,
           elem: int = 2) -> Tuple[float, float]:
    ops = 4.0 * d * visible_pairs(s, window) * h * b
    nbytes = elem * b * s * d * (2 * h + 2 * hkv)
    return ops, float(nbytes)


def k5_bwd(b: int, s: int, h: int, hkv: int, d: int, window: int,
           elem: int = 2) -> Tuple[float, float]:
    ops = 10.0 * d * visible_pairs(s, window) * h * b
    nbytes = elem * b * s * d * (4 * h + 4 * hkv)  # q o dO dq; k v dk dv
    return ops, float(nbytes)


def k6_fwd(b: int, s: int, di: int, n: int, a_rows: int = 1
           ) -> Tuple[float, float]:
    nbytes = 3 * b * s * di * 4 + 2 * b * s * n * 4 + a_rows * di * n * 4
    return 0.0, float(nbytes)


def k6_bwd(b: int, s: int, di: int, n: int, a_rows: int = 1
           ) -> Tuple[float, float]:
    nbytes = 5 * b * s * di * 4 + 4 * b * s * n * 4 + 2 * a_rows * di * n * 4
    return 0.0, float(nbytes)
