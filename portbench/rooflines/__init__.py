"""Operations and bytes of the port's kernels, from their shapes.

Each function returns ``(operations, bytes)`` for one launch; ``bound_s``
turns them into the least time the card could take. The formulas are
PERF.md §6's: bytes count each input once and each output once, whatever
the kernel reads again; operations count what the inputs need (attention's
visible pairs under causality and the window).
"""
from __future__ import annotations

from typing import Tuple

from portbench.harness.peaks import flops_peak, hbm_rate


def bound_s(work: Tuple[float, float], card: str,
            dtype: str = "bfloat16") -> float:
    ops, nbytes = work
    return max(ops / flops_peak(card, dtype), nbytes / hbm_rate(card))
