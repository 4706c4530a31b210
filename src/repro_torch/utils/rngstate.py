"""NumPy PCG64 generator state <-> plain uint64 arrays.

An engine checkpoint must freeze every
host-side RNG stream — per-client behavior draws AND per-client dataset
batch sampling — into npz-storable arrays. One PCG64 generator packs to
a (6,) uint64 row: [state_hi, state_lo, inc_hi, inc_lo, has_uint32,
uinteger]; a list of generators packs to (n, 6).

A numpy-only copy of the JAX package's ``utils/rngstate.py``; the port
keeps its own so it imports nothing of that package.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

_U64 = (1 << 64) - 1


def pack_pcg64(rngs: Sequence[np.random.Generator]) -> np.ndarray:
    """(n, 6) uint64 rows capturing each generator's exact state."""
    rows = []
    for g in rngs:
        st = g.bit_generator.state
        if st["bit_generator"] != "PCG64":
            raise ValueError(f"unsupported generator {st['bit_generator']!r}")
        s, inc = st["state"]["state"], st["state"]["inc"]
        rows.append([s >> 64, s & _U64, inc >> 64, inc & _U64,
                     st["has_uint32"], st["uinteger"]])
    return np.asarray(rows, np.uint64).reshape(len(rows), 6)


def unpack_pcg64(rows: np.ndarray) -> List[np.random.Generator]:
    """Inverse of ``pack_pcg64``: fresh generators at the packed states."""
    out = []
    for r in np.asarray(rows, np.uint64).reshape(-1, 6):
        g = np.random.default_rng(0)
        g.bit_generator.state = {
            "bit_generator": "PCG64",
            "state": {"state": (int(r[0]) << 64) | int(r[1]),
                      "inc": (int(r[2]) << 64) | int(r[3])},
            "has_uint32": int(r[4]), "uinteger": int(r[5]),
        }
        out.append(g)
    return out
