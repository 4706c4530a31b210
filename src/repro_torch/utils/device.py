"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU. There is
no quiet fallback: asking for CUDA where no card is present raises. The
dry run (``launch/dryrun.py``) asks for ``meta``: tensors with shapes and
dtypes and no data, so nothing is computed.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """``torch.device`` for ``device``; raises if CUDA is asked for but absent.

    ``meta`` is accepted for shape-only runs (the dry run)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {str(dev)!r}: use 'cuda', "
                         "'cpu' or 'meta'")
    return dev


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True for CUDA inputs, False for CPU and ``meta`` inputs; raises on
    anything else.

    The kernel wrappers' dispatch rule: the plain version for CPU tensors,
    the kernel for CUDA tensors. A ``meta`` tensor holds no data, so no
    kernel can run on it: the wrappers whose plain versions are costly to
    trace (K5, K6) return empty outputs for it first (``on_meta``), the
    others run their plain versions on it, which compute nothing.
    """
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on several devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type == "cuda"


def on_meta(*tensors: torch.Tensor) -> bool:
    """True when every input is a ``meta`` tensor (shapes only)."""
    return all(t.device.type == "meta" for t in tensors)
