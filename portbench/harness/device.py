"""Device helpers the drivers share: waiting for the card, and the caching
allocator's counts after a window (printed to standard error)."""
from __future__ import annotations

import sys

import torch


def sync(device: str) -> None:
    if device != "cpu":
        torch.cuda.synchronize()


def allocator_note(n: int, unit: str, window_s: float) -> None:
    """The window's units and the caching allocator's counts, on stderr."""
    st = torch.cuda.memory_stats()
    print("portbench: %d %s in %.3f s; allocator: reserved peak %.2f GiB, "
          "retries %d, device allocs %d, frees %d" % (
              n, unit, window_s,
              st.get("reserved_bytes.all.peak", 0) / 2**30,
              st.get("num_alloc_retries", 0), st.get("num_device_alloc", 0),
              st.get("num_device_free", 0)), file=sys.stderr)
