"""Server-side K-buffer with model-version history (FedBuff structure).

A copy of the JAX package's ``core/buffer.py`` (framework-free host code);
``tests/test_torch_async_server.py`` pins it to the original.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional


@dataclasses.dataclass
class BufferEntry:
    client_id: int
    delta: Any  # pytree: cumulative local update Delta_i
    base_version: int  # global version the client trained from
    data_size: int  # N_i


class UpdateBuffer:
    """Accumulates client uploads; ready when K updates are buffered."""

    def __init__(self, k: int):
        self.k = int(k)
        self._entries: List[BufferEntry] = []

    def add(self, entry: BufferEntry) -> None:
        self._entries.append(entry)

    def ready(self) -> bool:
        return len(self._entries) >= self.k

    def drain(self) -> List[BufferEntry]:
        """Pop the first K entries (FIFO), keep any overflow buffered."""
        out, self._entries = self._entries[: self.k], self._entries[self.k:]
        return out

    def __len__(self) -> int:
        return len(self._entries)


class VersionHistory:
    """Ring of recent global-model snapshots for exact eq.-3 distances.

    Holds AT MOST ``max_versions`` snapshots: after ``put(version)`` the
    ring spans ``[version - max_versions + 1, version]``. Callers that
    need bases up to ``max_staleness`` rounds old must size the ring
    ``max_staleness + 1`` (current + that many predecessors).
    """

    def __init__(self, max_versions: int):
        if max_versions < 1:
            raise ValueError("max_versions must be >= 1")
        self.max_versions = int(max_versions)
        self._snaps: Dict[int, Any] = {}

    def put(self, version: int, params: Any) -> None:
        self._snaps[version] = params
        # keep the newest max_versions entries: floor at
        # version - max_versions + 1 (the old "- max_versions" floor
        # silently retained max_versions + 1 snapshots)
        floor = version - self.max_versions + 1
        for v in [v for v in self._snaps if v < floor]:
            del self._snaps[v]

    def get(self, version: int) -> Optional[Any]:
        return self._snaps.get(version)

    def oldest(self) -> int:
        """Oldest version still in the ring (fallback base for updates
        whose true snapshot was pruned: treated as max-stale)."""
        return min(self._snaps)

    def __contains__(self, version: int) -> bool:
        return version in self._snaps
